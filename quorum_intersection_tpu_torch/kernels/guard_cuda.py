"""Wrapper of the CUDA block guard (``csrc/guard.cu``).

:class:`BlockGuard` holds one circuit's tables on its device and
:meth:`BlockGuard.counts` takes the ``(B, n)`` 0/1 maximal-candidate rows of
a prune plan and returns their ``(B,)`` int32 survivor counts — exactly B,
whatever the launch shape (the contract of :func:`.guard_ref.guard_counts`
and of the JAX package's guards).

On a CUDA device it packs each row into words on the host, uploads them and
launches the kernel of its encoding once on the current stream —
:func:`guard_dense` (bit-plane votes, any multiplicity) or
:func:`guard_bitset` (0/1 votes as uint32 words) — each counting its own
launches, or raises; it never falls back.  On the CPU it runs the plain
version — only because the caller asked for the CPU.

Kernel limits, checked in the constructor before any launch
(:class:`KernelLimitError`): ``n <= 64`` nodes (one uint64 row, or two
uint32 words), ``U <= 1024`` units, vote counts below 2^8 (dense) or of 0/1
(bitset, ``ValueError`` as ``bitset_encode`` raises it), and tables that fit
the shared memory one block may take.  The drive plans pruning only on
narrow enumerations, so a restricted circuit there has at most 31 nodes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.encode.circuit import Circuit, bitset_encode, pack_mask_words
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.kernels.guard_ref import ENCODINGS, guard_counts
from quorum_intersection_tpu_torch.kernels.sweep_cuda import (
    CHILD_WORDS,
    KernelLimitError,
    _bit_planes,
    check_smem,
    check_units,
    child_layout,
    upload_words,
)

MAX_NODES = 64
BITSET_CHILD_WORDS = (1, 2, 4, 8, 16, 32)


def dense_tables(circuit: Circuit, nw: int):
    """The bit-plane tables ``(c0, words, member, child)``: member planes
    ``(pm, U, nw)`` uint64 over the nodes, child planes ``(pc, U, words)``
    uint64 over units ``[c0, U)`` (:func:`.sweep_cuda.child_layout`)."""
    c0, words = child_layout(circuit, 64, CHILD_WORDS)
    return c0, words, _bit_planes(circuit.members, nw), _bit_planes(circuit.child[:, c0:], words)


def bitset_tables(circuit: Circuit, nw: int):
    """The bitset tables ``(c0, words, member, child)`` as ``bitset_encode``'s
    uint32 words: member ``(U, nw)`` over the nodes (``n <= 32 * nw``), child
    ``(U, words)`` over units ``[c0, U)``.  ValueError on vote counts above 1."""
    bits = bitset_encode(circuit)
    c0, words = child_layout(circuit, 32, BITSET_CHILD_WORDS)
    member = np.zeros((circuit.n_units, nw), dtype=np.uint32)
    member[:, : bits.words] = bits.member_words
    child = np.zeros((circuit.n_units, words), dtype=np.uint32)
    if bits.child_words is not None:
        cols = bits.child_words[:, c0 // 32 :]
        child[:, : cols.shape[1]] = cols
    return c0, words, member, child


def u64_words(mask: np.ndarray, words: int) -> np.ndarray:
    """0/1 rows ``(r, m)`` → ``(r, words)`` uint64, bit j of word j // 64."""
    w32 = pack_mask_words(mask, 2 * words).astype(np.uint64)
    return w32[:, 0::2] | (w32[:, 1::2] << np.uint64(32))


class BlockGuard:
    """One circuit's guard on one device, in the ``"dense"`` or
    ``"bitset"`` encoding."""

    def __init__(self, circuit: Circuit, encoding: str = "dense", device: DeviceLike = None):
        if encoding not in ENCODINGS:
            raise ValueError(f"unknown guard encoding {encoding!r}")
        self.device = resolve_device(device)
        self.encoding = encoding
        self.circuit = circuit
        self.n = circuit.n
        if self.device.type == "cpu":
            return
        if circuit.n > MAX_NODES:
            raise KernelLimitError(
                f"circuit has {circuit.n} nodes; the {encoding} guard takes at most {MAX_NODES}"
            )
        check_units(circuit, f"{encoding} guard")
        self.n_units = circuit.n_units
        self.depth = circuit.depth if circuit.n_units > circuit.n else 0
        if encoding == "dense":
            self.c0, self.words, member, child = dense_tables(circuit, 1)
            self.pm, self.pc = member.shape[0], child.shape[0]
        else:
            self.c0, self.words, member, child = bitset_tables(circuit, 2)
        check_smem(member.nbytes + child.nbytes + 8 * circuit.n_units, f"{encoding} guard")
        self.member = upload_words(member, self.device)
        self.child = upload_words(child, self.device)
        self.thr = torch.from_numpy(np.asarray(circuit.thresholds, dtype=np.int32)).to(self.device)

    def upload(self, masks: np.ndarray) -> torch.Tensor:
        """``(B, n)`` 0/1 rows → the kernel's row words on the device:
        ``(B,)`` int64 (dense) or ``(B, 2)`` int32 (bitset) bit patterns."""
        masks = np.asarray(masks)
        if masks.ndim != 2 or masks.shape[1] != self.n:
            raise ValueError(f"guard masks have shape {masks.shape}; the circuit has {self.n} nodes")
        if self.encoding == "dense":
            return upload_words(u64_words(masks, 1)[:, 0], self.device)
        return upload_words(pack_mask_words(masks, 2), self.device)

    def counts(self, masks: np.ndarray) -> np.ndarray:
        """``(B,)`` int32 survivor counts of the rows of ``masks``."""
        if self.device.type == "cpu":
            return guard_counts(self.circuit, masks, self.encoding, self.device).numpy()
        launch = guard_dense if self.encoding == "dense" else guard_bitset
        return launch(self, self.upload(masks)).cpu().numpy()


def _checked(guard: BlockGuard, words: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if guard.device.type != "cuda" or not words.is_cuda:
        raise ValueError(f"the guard kernels launch on CUDA only, got {words.device}")
    if words.dtype != dtype or tuple(words.shape[1:]) != shape or not words.is_contiguous():
        raise ValueError(
            f"guard row words must be contiguous {dtype} of shape (B, *{shape}), "
            f"got {words.dtype} {tuple(words.shape)}"
        )


def guard_dense(guard: BlockGuard, words: torch.Tensor) -> torch.Tensor:
    """Launch the dense guard over ``(B,)`` int64 row words on the current
    stream; returns the ``(B,)`` int32 counts without synchronising."""
    _checked(guard, words, torch.int64, ())
    lib = _library()
    out = torch.empty(words.shape[0], dtype=torch.int32, device=guard.device)
    if not words.shape[0]:
        return out  # nothing to launch
    err = lib.qi_guard_dense(
        guard.member.data_ptr(), guard.child.data_ptr(), guard.thr.data_ptr(), guard.n,
        guard.n_units, guard.pm, guard.pc, guard.depth, guard.c0, guard.words,
        words.data_ptr(), words.shape[0], out.data_ptr(),
        torch.cuda.current_stream(guard.device).cuda_stream,
    )
    _raise_on(lib, "qi_guard_dense", err)
    guard_dense.launches += 1
    return out


def guard_bitset(guard: BlockGuard, words: torch.Tensor) -> torch.Tensor:
    """Launch the bitset guard over ``(B, 2)`` int32 row words on the
    current stream; returns the ``(B,)`` int32 counts without synchronising."""
    _checked(guard, words, torch.int32, (2,))
    lib = _library()
    out = torch.empty(words.shape[0], dtype=torch.int32, device=guard.device)
    if not words.shape[0]:
        return out  # nothing to launch
    err = lib.qi_guard_bitset(
        guard.member.data_ptr(), guard.child.data_ptr(), guard.thr.data_ptr(), guard.n,
        guard.n_units, guard.depth, guard.c0, guard.words, words.data_ptr(), words.shape[0],
        out.data_ptr(), torch.cuda.current_stream(guard.device).cuda_stream,
    )
    _raise_on(lib, "qi_guard_bitset", err)
    guard_bitset.launches += 1
    return out


guard_dense.launches = 0  # type: ignore[attr-defined]
guard_bitset.launches = 0  # type: ignore[attr-defined]


def _raise_on(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.qi_cuda_error_string(err).decode()}")


def _library() -> ctypes.CDLL:
    lib = build.load("guard")
    if not getattr(lib, "_qi_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qi_guard_dense.argtypes = [p, p, p, i, i, i, i, i, i, i, p, i64, p, p]
        lib.qi_guard_dense.restype = i
        lib.qi_guard_bitset.argtypes = [p, p, p, i, i, i, i, i, p, i64, p, p]
        lib.qi_guard_bitset.restype = i
        lib.qi_cuda_error_string.argtypes = [i]
        lib.qi_cuda_error_string.restype = ctypes.c_char_p
        lib._qi_typed = True
    return lib
