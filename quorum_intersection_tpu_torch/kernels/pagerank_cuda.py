"""Wrapper of the PageRank power-loop kernel (``csrc/pagerank.cu``, K12).

:func:`pagerank_power` takes the in-edge CSR of
``analytics.pagerank.in_edge_csr`` as tensors and returns ``(rank float32
(n,), iterations int32, last_diff float32)`` — the contract of the plain
version :func:`.pagerank_ref.power_loop` and of the JAX package's
``_jitted_power_loops``.

On a CUDA device it launches the kernel once on the current stream (the
whole loop, one cooperative launch) and counts the launch, or raises; it
never falls back, and it does not synchronise: reading the result back is
the caller's one host sync.  On the CPU it runs the plain version's
sparse form — only because the tensors lie on the CPU.

Kernel limits, checked before any launch (:class:`KernelLimitError`):
vertex and CSR entry counts below 2^31 (int32 indices, with one segment of
headroom), and a device that can launch cooperatively (the grid barriers).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.kernels.pagerank_ref import power_loop
from quorum_intersection_tpu_torch.kernels.sweep_cuda import KernelLimitError

INDEX_CEILING = 1 << 31
# CSR entries a segment, at most: a row past it is summed by several warps.
SEGMENT_ENTRIES = 1024


def check_limits(n: int, n_edges: int) -> None:
    """Raise :class:`KernelLimitError` where the kernel's int32 indices
    cannot address the CSR."""
    if n + 1 >= INDEX_CEILING:
        raise KernelLimitError(f"PageRank kernel: {n} vertices; int32 indices take fewer than 2^31 - 1")
    if n_edges + SEGMENT_ENTRIES >= INDEX_CEILING:
        raise KernelLimitError(
            f"PageRank kernel: {n_edges} CSR entries; int32 indices take fewer than 2^31 - {SEGMENT_ENTRIES}"
        )
    if n + -(-n_edges // SEGMENT_ENTRIES) >= INDEX_CEILING:
        raise KernelLimitError("PageRank kernel: more than 2^31 edge segments")


def pagerank_power(
    row_ptr: torch.Tensor,
    src: torch.Tensor,
    outdeg: torch.Tensor,
    m: float,
    conv: float,
    max_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The power loop over ``row_ptr`` int32 ``(n+1,)``, ``src`` int32
    ``(E,)`` and ``outdeg`` float32 ``(n,)``, all on one device."""
    n = outdeg.numel()
    if row_ptr.dtype != torch.int32 or src.dtype != torch.int32 or outdeg.dtype != torch.float32:
        raise ValueError(
            f"PageRank CSR must be int32 row_ptr, int32 src and float32 outdeg, got "
            f"{row_ptr.dtype}, {src.dtype}, {outdeg.dtype}"
        )
    if row_ptr.ndim != 1 or src.ndim != 1 or outdeg.ndim != 1 or row_ptr.numel() != n + 1:
        raise ValueError(
            f"PageRank CSR shapes {tuple(row_ptr.shape)}, {tuple(src.shape)}, {tuple(outdeg.shape)} "
            f"do not form an (n+1,), (E,), (n,) CSR"
        )
    if len({row_ptr.device, src.device, outdeg.device}) != 1:
        raise ValueError("PageRank CSR tensors lie on different devices")
    if n == 0:
        empty = torch.zeros(0, dtype=torch.float32, device=outdeg.device)
        return empty, torch.tensor(0, dtype=torch.int32), torch.tensor(float(conv) + 1.0)
    if outdeg.device.type == "cpu":
        return power_loop(row_ptr, src, outdeg, m, conv, max_iterations)
    if outdeg.device.type != "cuda":
        raise ValueError(f"the PageRank kernel launches on CUDA only, got {outdeg.device}")
    check_limits(n, src.numel())
    if not (row_ptr.is_contiguous() and src.is_contiguous() and outdeg.is_contiguous()):
        raise ValueError("PageRank CSR tensors must be contiguous")
    lib = _library()
    device = outdeg.device
    segments_bound = n + -(-src.numel() // SEGMENT_ENTRIES)
    grid, coop = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.qi_pagerank_grid(max(n, 32 * segments_bound), ctypes.byref(grid), ctypes.byref(coop))
        if err != 0:
            raise RuntimeError(f"pagerank_cuda grid query failed: {lib.qi_cuda_error_string(err).decode()}")
        if not coop.value:
            raise KernelLimitError("PageRank kernel: the device cannot launch cooperatively (grid barriers)")
        # Segment counts per row on the device (no host sync): a row of d
        # entries is cut into ceil(d / SEGMENT_ENTRIES) segments.
        seg_ptr = torch.zeros(n + 1, dtype=torch.int32, device=device)
        degree = row_ptr[1:] - row_ptr[:-1]
        seg_ptr[1:] = torch.cumsum((degree + SEGMENT_ENTRIES - 1) // SEGMENT_ENTRIES, dim=0,
                                   dtype=torch.int32)
        rank = torch.empty(n, dtype=torch.float32, device=device)
        tmp = torch.empty_like(rank)
        send = torch.empty_like(rank)
        seg_sum = torch.empty(segments_bound, dtype=torch.float32, device=device)
        seg_row = torch.empty(segments_bound, dtype=torch.int32, device=device)
        part = torch.empty(3 * grid.value, dtype=torch.float32, device=device)
        iterations = torch.empty(1, dtype=torch.int32, device=device)
        diff = torch.empty(1, dtype=torch.float32, device=device)
        err = lib.qi_pagerank(
            n, row_ptr.data_ptr(), src.data_ptr(), outdeg.data_ptr(), seg_ptr.data_ptr(), SEGMENT_ENTRIES,
            float(m), float(conv), int(max_iterations), rank.data_ptr(), tmp.data_ptr(),
            send.data_ptr(), seg_sum.data_ptr(), seg_row.data_ptr(), part.data_ptr(), grid.value,
            iterations.data_ptr(), diff.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pagerank_cuda launch failed: {lib.qi_cuda_error_string(err).decode()}")
    pagerank_power.launches += 1
    return rank, iterations[0], diff[0]


pagerank_power.launches = 0  # type: ignore[attr-defined]


def _library() -> ctypes.CDLL:
    lib = build.load("pagerank")
    if not getattr(lib, "_qi_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.qi_pagerank_grid.argtypes = [ctypes.c_longlong, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.qi_pagerank_grid.restype = i
        lib.qi_pagerank.argtypes = [i, p, p, p, p, i, f, f, i, p, p, p, p, p, p, i, p, p, p]
        lib.qi_pagerank.restype = i
        lib.qi_cuda_error_string.argtypes = [i]
        lib.qi_cuda_error_string.restype = ctypes.c_char_p
        lib._qi_typed = True
    return lib
