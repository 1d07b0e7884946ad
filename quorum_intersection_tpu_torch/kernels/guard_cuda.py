"""Wrapper of the CUDA block guard (``csrc/guard.cu``).

:class:`BlockGuard` holds one circuit's tables on its device and
:meth:`BlockGuard.counts` takes the ``(B, n)`` 0/1 maximal-candidate rows of
a prune plan and returns their ``(B,)`` int32 survivor counts — exactly B,
whatever the launch shape (the contract of :func:`.guard_ref.guard_counts`
and of the JAX package's guards).

On a CUDA device it packs each row into two uint32 words on the host,
uploads them and launches the kernel once on the current stream through the
wrapper of its encoding — :func:`guard_dense` (bit-plane votes, any
multiplicity) or :func:`guard_bitset` (0/1 votes, the one-plane case) —
each counting its own launches, or raises; it never falls back.  Both run
one evaluator, the fused sweep's warp tile (``csrc/warp_mma.cuh``), over the
tables :func:`.sweep_cuda.plane_tables` builds.  On the CPU it runs the
plain version — only because the caller asked for the CPU.

Kernel limits, checked in the constructor before any launch
(:class:`KernelLimitError`): ``n <= 64`` nodes, vote counts below 2^8
(dense) or of 0/1 (bitset, ``ValueError`` as ``bitset_encode`` raises it),
and the per-warp state of :func:`.sweep_cuda.plane_tables`.  The drive plans
pruning only on narrow enumerations, so a restricted circuit there has at
most 31 nodes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.encode.circuit import Circuit, bitset_encode, pack_mask_words
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.kernels.guard_ref import ENCODINGS, guard_counts
from quorum_intersection_tpu_torch.kernels.sweep_cuda import plane_tables, upload_words


class BlockGuard:
    """One circuit's guard on one device, in the ``"dense"`` or
    ``"bitset"`` encoding; ``stream`` as :func:`.sweep_cuda.plane_tables`
    takes it."""

    def __init__(self, circuit: Circuit, encoding: str = "dense", device: DeviceLike = None,
                 stream: Optional[bool] = None):
        if encoding not in ENCODINGS:
            raise ValueError(f"unknown guard encoding {encoding!r}")
        self.device = resolve_device(device)
        self.encoding = encoding
        self.circuit = circuit
        self.n = circuit.n
        if self.device.type == "cpu":
            return
        if encoding == "bitset":
            bitset_encode(circuit)  # ValueError on vote counts above 1
        self.tables = plane_tables(circuit, self.device, sweep=False, stream=stream)

    def upload(self, masks: np.ndarray) -> torch.Tensor:
        """``(B, n)`` 0/1 rows → the kernel's ``(B, 2)`` int32 row words
        (bit v of the row is node v) on the device."""
        masks = np.asarray(masks)
        if masks.ndim != 2 or masks.shape[1] != self.n:
            raise ValueError(f"guard masks have shape {masks.shape}; the circuit has {self.n} nodes")
        return upload_words(pack_mask_words(masks, 2), self.device)

    def counts(self, masks: np.ndarray) -> np.ndarray:
        """``(B,)`` int32 survivor counts of the rows of ``masks``."""
        if self.device.type == "cpu":
            return guard_counts(self.circuit, masks, self.encoding, self.device).numpy()
        launch = guard_dense if self.encoding == "dense" else guard_bitset
        return launch(self, self.upload(masks)).cpu().numpy()


def _launch(guard: BlockGuard, words: torch.Tensor, name: str) -> torch.Tensor:
    if guard.device.type != "cuda" or not words.is_cuda:
        raise ValueError(f"the guard kernels launch on CUDA only, got {words.device}")
    if words.dtype != torch.int32 or words.ndim != 2 or words.shape[1] != 2 or not words.is_contiguous():
        raise ValueError(
            f"guard row words must be contiguous int32 of shape (B, 2), "
            f"got {words.dtype} {tuple(words.shape)}"
        )
    out = torch.empty(words.shape[0], dtype=torch.int32, device=guard.device)
    if not words.shape[0]:
        return out  # nothing to launch
    t = guard.tables
    lib = _library()
    err = lib.qi_guard(
        t.blocks.data_ptr(), t.chunks.data_ptr(), t.neg_thresholds.data_ptr(), t.n, t.n_units, t.units,
        t.depth, t.c0, t.slabs, t.pc, t.nblocks, int(t.stream), words.data_ptr(), words.shape[0],
        out.data_ptr(), torch.cuda.current_stream(guard.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.qi_cuda_error_string(err).decode()}")
    return out


def guard_dense(guard: BlockGuard, words: torch.Tensor) -> torch.Tensor:
    """Launch the guard over ``(B, 2)`` int32 row words of a dense-encoded
    guard on the current stream; returns the ``(B,)`` int32 counts without
    synchronising."""
    out = _launch(guard, words, "guard_dense")
    guard_dense.launches += 1
    return out


def guard_bitset(guard: BlockGuard, words: torch.Tensor) -> torch.Tensor:
    """The same for a bitset-encoded guard (0/1 votes)."""
    out = _launch(guard, words, "guard_bitset")
    guard_bitset.launches += 1
    return out


guard_dense.launches = 0  # type: ignore[attr-defined]
guard_bitset.launches = 0  # type: ignore[attr-defined]


def _library() -> ctypes.CDLL:
    lib = build.load("guard")
    if not getattr(lib, "_qi_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qi_guard.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p, i64, p, p]
        lib.qi_guard.restype = i
        lib.qi_cuda_error_string.argtypes = [i]
        lib.qi_cuda_error_string.restype = ctypes.c_char_p
        lib._qi_typed = True
    return lib
