"""Wrapper of the PageRank power-loop kernel (``csrc/pagerank.cu``, K12).

:func:`pagerank_power` takes the in-edge CSR of
``analytics.pagerank.in_edge_csr`` as tensors and returns ``(rank float32
(n,), iterations int32, last_diff float32)`` — the contract of the plain
version :func:`.pagerank_ref.power_loop` and of the JAX package's
``_jitted_power_loops``.

On a CUDA device it launches the kernel once on the current stream (the
whole loop, one cooperative launch with one grid barrier an iteration) and
counts the launch, or raises; it never falls back, and it does not
synchronise: reading the result back is the caller's one host sync.  A call
allocates one workspace tensor and launches nothing else: the kernel builds
its segment table in its prologue, and the device's SM count and occupancy
are asked once per device.  The rank and the two scalars are views of the
workspace.  On the CPU it runs the plain version's sparse form — only
because the tensors lie on the CPU.

The launch shape (:func:`launch_shape`): ``THREADS`` threads a block, a
grid sized from the work and capped at the co-resident blocks (one an SM:
the kernel takes 255 registers a thread), and heavy rows cut into segments of a power of two between ``SEGMENT_MIN`` and
``SEGMENT_MAX`` entries, about one a warp.  ``tests/_torch_pagerank_schedule``
models the kernel bit for bit from this shape.

Kernel limits, checked before any launch (:class:`KernelLimitError`):
vertex and CSR entry counts below 2^31 (int32 indices, with one segment of
headroom), and a device that can launch cooperatively (the grid barriers).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.kernels.pagerank_ref import power_loop
from quorum_intersection_tpu_torch.kernels.sweep_cuda import KernelLimitError

INDEX_CEILING = 1 << 31
THREADS = 256  # threads a block (csrc/pagerank.cu kThreads)
VERTICES_PER_THREAD = 1  # the grid's work rule: a block per THREADS vertices ...
EDGES_PER_BLOCK = 8192  # ... or per 8192 CSR entries, whichever asks more
LIGHT_ENTRIES = 16  # csrc/pagerank.cu kLight: rows of at most 16 entries are a thread's
SEGMENT_MIN = 128  # a heavy row's segments: a power of two of 128 ...
SEGMENT_MAX = 4096  # ... to 4096 entries
# The parts of an iteration the timed instance (:func:`pagerank_timed`)
# clocks, in csrc/pagerank.cu's order; its timing tensor holds their cycles,
# then the iterations, the grid barriers passed in the loop and those passed
# in the prologue.
TIMED_PHASES = ("segment gather", "heavy-row finish", "vertex pass", "partials", "grid barrier", "stop test")


@dataclass(frozen=True)
class LaunchShape:
    grid: int  # blocks of THREADS threads
    seg: int  # CSR entries a heavy row's segment, at most

    @property
    def warps(self) -> int:
        return self.grid * THREADS // 32


def check_limits(n: int, n_edges: int) -> None:
    """Raise :class:`KernelLimitError` where the kernel's int32 indices
    cannot address the CSR."""
    if n + 1 >= INDEX_CEILING:
        raise KernelLimitError(f"PageRank kernel: {n} vertices; int32 indices take fewer than 2^31 - 1")
    if n_edges + SEGMENT_MAX >= INDEX_CEILING:
        raise KernelLimitError(
            f"PageRank kernel: {n_edges} CSR entries; int32 indices take fewer than 2^31 - {SEGMENT_MAX}"
        )


def launch_shape(n: int, n_edges: int, sms: int, per_sm: int) -> LaunchShape:
    """The grid and segment length for ``n`` vertices and ``n_edges`` CSR
    entries on a card of ``sms`` SMs that holds ``per_sm`` blocks an SM:
    a block per ``THREADS * VERTICES_PER_THREAD`` vertices or per
    ``EDGES_PER_BLOCK`` entries, at most ``per_sm`` an SM; segments of
    about ``n_edges`` over the grid's warps."""
    want = max(-(-n // (THREADS * VERTICES_PER_THREAD)), -(-n_edges // EDGES_PER_BLOCK), 1)
    grid = min(want, sms * per_sm)
    per_warp = -(-n_edges // (grid * THREADS // 32))
    seg = min(max(1 << max(per_warp - 1, 0).bit_length(), SEGMENT_MIN), SEGMENT_MAX)
    return LaunchShape(grid, seg)


_DEVICES: Dict[int, Tuple[int, int]] = {}


def device_limits(device: torch.device) -> Tuple[int, int]:
    """``(SMs, co-resident blocks an SM)`` of the kernel on ``device``,
    asked once per device."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    got = _DEVICES.get(key)
    if got is None:
        sms, per_sm, coop = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(key):
            err = _library().qi_pagerank_device(THREADS, ctypes.byref(sms), ctypes.byref(per_sm), ctypes.byref(coop))
        if err != 0:
            raise RuntimeError(f"pagerank_cuda device query failed: {_library().qi_cuda_error_string(err).decode()}")
        if not coop.value:
            raise KernelLimitError("PageRank kernel: the device cannot launch cooperatively (grid barriers)")
        if per_sm.value < 1:
            raise KernelLimitError("PageRank kernel: not one block of it fits an SM")
        got = _DEVICES[key] = (sms.value, per_sm.value)
    return got


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
    n = _check(row_ptr, src, outdeg)
    if n == 0:
        empty = torch.zeros(0, dtype=torch.float32, device=outdeg.device)
        return empty, torch.tensor(0, dtype=torch.int32), torch.tensor(float(conv) + 1.0)
    if outdeg.device.type == "cpu":
        return power_loop(row_ptr, src, outdeg, m, conv, max_iterations)
    out = _launch(row_ptr, src, outdeg, m, conv, max_iterations, None)
    pagerank_power.launches += 1
    return out


pagerank_power.launches = 0  # type: ignore[attr-defined]


def pagerank_timed(
    row_ptr: torch.Tensor,
    src: torch.Tensor,
    outdeg: torch.Tensor,
    m: float,
    conv: float,
    max_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """A measurement, never launched by the library and not counted in
    ``pagerank_power.launches``: the same loop through the timed instance,
    with ``(len(TIMED_PHASES) + 3,)`` int64 after the result: the
    ``clock64()`` cycles warp 0 of block 0 spent in each part of the
    iterations, then the iterations, the grid barriers it passed in the
    loop and those it passed in the prologue."""
    if _check(row_ptr, src, outdeg) == 0 or outdeg.device.type != "cuda":
        raise ValueError(f"K12's timed instance runs on a CUDA CSR of at least one vertex, got {outdeg.device}")
    timing = torch.empty(len(TIMED_PHASES) + 3, dtype=torch.int64, device=outdeg.device)
    return (*_launch(row_ptr, src, outdeg, m, conv, max_iterations, timing), timing)


def _check(row_ptr: torch.Tensor, src: torch.Tensor, outdeg: torch.Tensor) -> int:
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
    if not (row_ptr.device == src.device == outdeg.device):
        raise ValueError("PageRank CSR tensors lie on different devices")
    if outdeg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the PageRank kernel launches on CUDA only, got {outdeg.device}")
    return n


def _launch(row_ptr, src, outdeg, m, conv, max_iterations, timing: Optional[torch.Tensor]):
    n, n_edges = outdeg.numel(), src.numel()
    check_limits(n, n_edges)
    if not (row_ptr.is_contiguous() and src.is_contiguous() and outdeg.is_contiguous()):
        raise ValueError("PageRank CSR tensors must be contiguous")
    lib = _library()
    device = outdeg.device
    shape = launch_shape(n, n_edges, *device_limits(device))
    nbytes = lib.qi_pagerank_bytes(n, n_edges, shape.seg, shape.grid)
    ws = torch.empty(-(-nbytes // 4), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.qi_pagerank(
            n, n_edges, row_ptr.data_ptr(), src.data_ptr(), outdeg.data_ptr(), float(m), float(conv),
            min(int(max_iterations), INDEX_CEILING - 1), shape.seg, THREADS, shape.grid, ws.data_ptr(),
            None if timing is None else timing.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pagerank_cuda launch failed: {lib.qi_cuda_error_string(err).decode()}")
    # The rank at the workspace's start, the iteration count and the last
    # diff at the next 16-byte boundary.
    k = -(-n // 4) * 4
    return ws[:n], ws[k:k + 1].view(torch.int32)[0], ws[k + 1]


def _library() -> ctypes.CDLL:
    if not build.loaded("pagerank"):
        # The process's first launch builds (or finds) the library first: the
        # gauge pagerank.kernel_build_seconds.
        from quorum_intersection_tpu_torch.utils.telemetry import get_run_record

        get_run_record().gauge("pagerank.kernel_build_seconds", round(build.timed_build(("pagerank",)), 4))
    lib = build.load("pagerank")
    if not getattr(lib, "_qi_typed", False):
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.qi_pagerank_device.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.qi_pagerank_device.restype = i
        lib.qi_pagerank_bytes.argtypes = [ll, ll, i, i]
        lib.qi_pagerank_bytes.restype = ll
        lib.qi_pagerank.argtypes = [i, i, p, p, p, f, f, i, i, i, i, p, p, p]
        lib.qi_pagerank.restype = i
        lib.qi_cuda_error_string.argtypes = [i]
        lib.qi_cuda_error_string.restype = ctypes.c_char_p
        lib._qi_typed = True
    return lib
