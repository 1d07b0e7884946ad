"""Wrapper of the lane-packed CUDA sweeps (``csrc/packed_sweep.cu``).

:class:`PackedSweep` holds one pack's tables on its device and
:meth:`PackedSweep.program` evaluates ``steps × batch`` rows from the ``(K,)``
per-group starts, returning the ``(K,)`` per-group smallest hit index as an
int32 tensor (``INT32_MAX`` for a group's clean miss) — the contract of the
JAX package's packed program factories.

On a CUDA device it launches the kernel of its engine —
:func:`packed_sweep_dense` (bit-plane votes, any multiplicity) or
:func:`packed_sweep_bitset` (0/1 votes as uint32 words) — each counting its
own launches, or raises; it never falls back.  On the CPU it runs the plain
version (:mod:`.packed_ref`) — only because the tables lie on the CPU.

Kernel limits, checked before any launch (:class:`KernelLimitError`): at most
16 lane groups and 128 lanes (one uint64 pair / four uint32 words per row),
``U <= 1024`` units, tables that fit the shared memory one block may take,
decode tables in the per-group shift layout ``decode_tables`` builds, and
candidate indices below 2^31.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from quorum_intersection_tpu_torch.backends.base import INT32_MAX
from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.encode.circuit import Circuit, bitset_encode, pack_mask_words
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.kernels.packed_ref import ENGINES, PackedRef
from quorum_intersection_tpu_torch.kernels.sweep_cuda import (
    CHILD_WORDS,
    INDEX_CEILING,
    KernelLimitError,
    _bit_planes,
    check_smem,
    check_units,
    child_layout,
    upload_words,
)

MAX_GROUPS = 16
MAX_LANES = 128
MAX_GROUP_BITS = 30
BITSET_CHILD_WORDS = (1, 2, 4, 8, 16, 32)


def group_decode(pos: np.ndarray, lane_group: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(base, bits)`` per group: group g's enumeration bit j decodes onto
    lane ``base[g] + j`` for j < ``bits[g]``.  Raises unless ``pos`` is
    exactly that layout (every other lane 31), so the kernel's per-group
    shift decodes what a per-lane ``(idx >> pos) & 1`` would."""
    pos = np.asarray(pos, dtype=np.int64)
    lane_group = np.asarray(lane_group, dtype=np.int64)
    base = np.zeros(k, dtype=np.int32)
    bits = np.zeros(k, dtype=np.int32)
    want = np.full_like(pos, 31)
    for g in range(k):
        lanes = np.nonzero((lane_group == g) & (pos != 31))[0]
        bits[g] = lanes.size
        if lanes.size:
            base[g] = lanes[0]
            want[lanes[0] : lanes[0] + lanes.size] = np.arange(lanes.size)
    if not np.array_equal(want, pos) or bits.max(initial=0) > MAX_GROUP_BITS:
        raise KernelLimitError(
            "decode tables are not in the per-group shift layout the packed kernels take"
        )
    return base, bits


class PackedSweep:
    """One pack on one device.

    ``(pos, scc_mask, lane_group, group_ind)`` are
    ``PackedCircuit.decode_tables()``; ``circuit_d`` is the packed Q6 twin
    (same members, child and units, other thresholds) or None.
    """

    def __init__(
        self,
        circuit: Circuit,
        circuit_d: Optional[Circuit],
        pos: np.ndarray,
        scc_mask: np.ndarray,
        lane_group: np.ndarray,
        group_ind: np.ndarray,
        batch: int,
        engine: str = "dense",
        device: DeviceLike = None,
    ):
        if engine not in ENGINES:
            raise ValueError(f"unknown packed engine {engine!r}")
        self.device = resolve_device(device)
        self.engine = engine
        self.batch = int(batch)
        self.k = int(group_ind.shape[1])
        if circuit_d is not None and (
            circuit_d.n_units != circuit.n_units
            or not np.array_equal(circuit_d.members, circuit.members)
            or not np.array_equal(circuit_d.child, circuit.child)
        ):
            raise ValueError("circuit_d must share members, child and units with circuit")
        if self.device.type == "cpu":
            self.ref: Optional[PackedRef] = PackedRef(
                circuit, circuit_d, pos, scc_mask, lane_group, group_ind, batch, engine, self.device
            )
            return
        self.ref = None
        if self.k > MAX_GROUPS or circuit.n > MAX_LANES:
            raise KernelLimitError(
                f"pack has {self.k} groups over {circuit.n} lanes; the packed kernels take at "
                f"most {MAX_GROUPS} groups and {MAX_LANES} lanes"
            )
        check_units(circuit, f"packed {engine}")
        self.n, self.n_units = circuit.n, circuit.n_units
        self.depth = circuit.depth if circuit.n_units > circuit.n else 0
        self.base, self.bits = group_decode(pos, lane_group, self.k)
        thr_d = circuit.thresholds if circuit_d is None else circuit_d.thresholds
        self.thr_q = torch.from_numpy(np.asarray(circuit.thresholds, dtype=np.int32)).to(self.device)
        self.thr_d = torch.from_numpy(np.asarray(thr_d, dtype=np.int32)).to(self.device)
        lanes = np.asarray(group_ind).T != 0  # (K, n)
        if engine == "dense":
            self.c0, self.words, member, child = dense_tables(circuit, 2)
            self.pm, self.pc = member.shape[0], child.shape[0]
            self.masks = u64_words(lanes, 2)
            self.scc = u64_words(np.asarray(scc_mask)[None, :] != 0, 2)[0]
        else:
            self.c0, self.words, member, child = bitset_tables(circuit, 4)
            self.masks = pack_mask_words(lanes, 4)
            self.scc = pack_mask_words(np.asarray(scc_mask) != 0, 4)
        check_smem(member.nbytes + child.nbytes + 8 * circuit.n_units, f"packed {engine}")
        self.member = upload_words(member, self.device)
        self.child = upload_words(child, self.device)

    def program(self, starts, steps: int) -> torch.Tensor:
        """Per-group min hit index over ``steps × batch`` rows from
        ``starts`` ((K,) int32 tensor; INT32_MAX for a clean miss)."""
        if self.ref is not None:
            return self.ref.program(starts, steps)
        launch = packed_sweep_dense if self.engine == "dense" else packed_sweep_bitset
        return launch(self, starts, steps * self.batch)


def dense_tables(circuit: Circuit, nw: int) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """The bit-plane kernels' tables ``(c0, words, member, child)``: member
    planes ``(pm, U, nw)`` uint64 over the nodes, child planes ``(pc, U,
    words)`` uint64 over units ``[c0, U)`` (:func:`.sweep_cuda.child_layout`)."""
    c0, words = child_layout(circuit, 64, CHILD_WORDS)
    return c0, words, _bit_planes(circuit.members, nw), _bit_planes(circuit.child[:, c0:], words)


def bitset_tables(circuit: Circuit, nw: int) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """The bitset kernels' tables ``(c0, words, member, child)`` as
    ``bitset_encode``'s uint32 words: member ``(U, nw)`` over the nodes
    (``n <= 32 * nw``), child ``(U, words)`` over units ``[c0, U)``.
    ValueError on vote counts above 1."""
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


def _checked_starts(sweep: PackedSweep, starts, rows: int) -> np.ndarray:
    if sweep.device.type != "cuda":
        raise ValueError(f"the packed kernels launch on CUDA only, got {sweep.device}")
    s = np.ascontiguousarray(np.asarray(starts, dtype=np.int64))
    if s.shape != (sweep.k,):
        raise ValueError(f"starts has shape {s.shape}; the pack has {sweep.k} groups")
    if s.min() < 0 or int(s.max()) + rows > INDEX_CEILING:
        raise KernelLimitError(
            f"candidates [{int(s.min())}, {int(s.max()) + rows}) cross the 2^31 index ceiling"
        )
    return s.astype(np.int32)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def packed_sweep_dense(sweep: PackedSweep, starts, rows: int) -> torch.Tensor:
    """Launch the dense packed kernel over ``rows`` rows on the current
    stream; returns the (K,) int32 result without synchronising."""
    s = _checked_starts(sweep, starts, rows)
    lib = _library()
    out = torch.full((sweep.k,), INT32_MAX, dtype=torch.int32, device=sweep.device)
    err = lib.qi_packed_dense(
        sweep.member.data_ptr(), sweep.child.data_ptr(), sweep.thr_q.data_ptr(),
        sweep.thr_d.data_ptr(), sweep.n, sweep.n_units, sweep.pm, sweep.pc, sweep.depth,
        sweep.c0, sweep.words, sweep.k, _ptr(s), _ptr(sweep.base), _ptr(sweep.bits),
        _ptr(sweep.masks), _ptr(sweep.scc), rows, out.data_ptr(),
        torch.cuda.current_stream(sweep.device).cuda_stream,
    )
    _raise_on(lib, "qi_packed_dense", err)
    packed_sweep_dense.launches += 1
    return out


def packed_sweep_bitset(sweep: PackedSweep, starts, rows: int) -> torch.Tensor:
    """Launch the bitset packed kernel over ``rows`` rows on the current
    stream; returns the (K,) int32 result without synchronising."""
    s = _checked_starts(sweep, starts, rows)
    lib = _library()
    out = torch.full((sweep.k,), INT32_MAX, dtype=torch.int32, device=sweep.device)
    err = lib.qi_packed_bitset(
        sweep.member.data_ptr(), sweep.child.data_ptr(), sweep.thr_q.data_ptr(),
        sweep.thr_d.data_ptr(), sweep.n, sweep.n_units, sweep.depth, sweep.c0, sweep.words,
        sweep.k, _ptr(s), _ptr(sweep.base), _ptr(sweep.bits), _ptr(sweep.masks),
        _ptr(sweep.scc), rows, out.data_ptr(),
        torch.cuda.current_stream(sweep.device).cuda_stream,
    )
    _raise_on(lib, "qi_packed_bitset", err)
    packed_sweep_bitset.launches += 1
    return out


packed_sweep_dense.launches = 0  # type: ignore[attr-defined]
packed_sweep_bitset.launches = 0  # type: ignore[attr-defined]


def _raise_on(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.qi_cuda_error_string(err).decode()}")


def _library() -> ctypes.CDLL:
    lib = build.load("packed_sweep")
    if not getattr(lib, "_qi_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qi_packed_dense.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p, p, i64, p, p]
        lib.qi_packed_dense.restype = i
        lib.qi_packed_bitset.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p, p, p, p, i64, p, p]
        lib.qi_packed_bitset.restype = i
        lib.qi_cuda_error_string.argtypes = [i]
        lib.qi_cuda_error_string.restype = ctypes.c_char_p
        lib._qi_typed = True
    return lib
