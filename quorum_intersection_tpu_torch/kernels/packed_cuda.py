"""Wrapper of the lane-packed CUDA sweeps (``csrc/packed_sweep.cu``).

:class:`PackedSweep` holds one pack's tables on its device and
:meth:`PackedSweep.program` evaluates ``steps × batch`` rows from the ``(K,)``
per-group starts, returning the ``(K,)`` per-group smallest hit index as an
int32 tensor (``INT32_MAX`` for a group's clean miss) — the contract of the
JAX package's packed program factories.

On a CUDA device it launches the kernel of its engine —
:func:`packed_sweep_dense` (tensor-core ``wgmma`` u8 votes, any
multiplicity) or :func:`packed_sweep_bitset` (0/1 votes as ``mma.sync`` b1
and-popc products) — each counting its own launches, or raises; it never
falls back.  On the CPU it runs the plain version (:mod:`.packed_ref`)
— only because the tables lie on the CPU.

The kernels evaluate 64 rows at a time with the vote counts as matrix
products over the units, 32 units (one N-chunk) at a time.  The host builds
the tables in the layout the tensor cores read (:func:`mma_tables`):

- route ``"u8"`` (dense): members ``(U, lanes)`` and children ``(U, U - c0)``
  as bytes, in 32 × 32 K-major blocks (:func:`u8_blocks`), only the blocks
  a chunk multiplies (:func:`named_blocks`), resident in shared memory or,
  where they do not fit one block's, streamed through it;
- route ``"b1"`` (bitset): the 0/1 votes as uint32 words (``bitset_encode``'s,
  padded), members ``(U, 4)`` and children ``(U, kcols / 32)``, always
  resident;

and, per chunk, the k-slabs (32 lanes for u8, 128 for b1) where its member
and child columns are nonzero: the kernel multiplies only those.

Kernel limits, checked before any launch (:class:`KernelLimitError`): at most
16 lane groups and 128 lanes, ``U <= 1024`` units, vote counts up to 255
(the circuit's uint8), decode tables in the per-group shift layout
``decode_tables`` builds, and candidate indices below 2^31.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from quorum_intersection_tpu_torch.backends.base import INT32_MAX
from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.encode.circuit import Circuit, bitset_encode, pack_mask_words
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.kernels.packed_ref import ENGINES, PackedRef
from quorum_intersection_tpu_torch.kernels.sweep_cuda import (
    INDEX_CEILING,
    SMEM_LIMIT,
    KernelLimitError,
    upload_words,
)

MAX_GROUPS = 16
MAX_LANES = 128
# Units of a pack: 32 chunks of 32 (the drive plans packs within it).
MAX_UNITS = 1024
MAX_GROUP_BITS = 30
CHUNK = 32  # units per N-chunk
ROWS = 64  # rows per tile
SLAB = {"u8": 32, "b1": 128}  # lanes (or child units) per k-slab
# Dynamic shared memory one launch may take: the block's 227 KB less the
# kernel's static arrays (per-row group masks and the per-group minima).
SMEM_BUDGET = SMEM_LIMIT - 2048
# Kernel instances of csrc/packed_sweep.cu.
_INSTANCE = {("u8", False): 0, ("u8", True): 1, ("b1", False): 2}


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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def u8_blocks(mat: np.ndarray) -> np.ndarray:
    """``(R, K)`` bytes (both multiples of 32) → the flat K-major block
    layout the ``wgmma`` descriptors read: block ``(c, s)`` (rows
    ``[32c, 32c + 32)``, columns ``[32s, 32s + 32)``) at byte ``(c * K/32 +
    s) * 1024``; inside it, core matrices of 8 rows × 16 bytes, the two of a
    row group 128 bytes apart, row groups 256 bytes apart (``blk_off`` of
    ``csrc/circuit_mma.cuh``)."""
    r, k = mat.shape
    blocks = np.asarray(mat, dtype=np.uint8).reshape(r // 32, 4, 8, k // 32, 2, 16)
    return np.ascontiguousarray(blocks.transpose(0, 3, 1, 4, 2, 5)).reshape(-1)


def slab_ranges(table: np.ndarray, slab: int) -> np.ndarray:
    """Per 32-row chunk of ``table`` ``(U, cols)``, the k-slabs ``[lo, hi)``
    of width ``slab`` that hold its nonzero columns (``(0, 0)`` for none)."""
    chunks = table.shape[0] // CHUNK
    out = np.zeros((chunks, 2), dtype=np.uint8)
    for c in range(chunks):
        cols = np.nonzero(table[CHUNK * c : CHUNK * (c + 1)].any(axis=0))[0]
        if cols.size:
            out[c] = (cols[0] // slab, cols[-1] // slab + 1)
    return out


def named_blocks(mat: np.ndarray, ranges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The :func:`u8_blocks` of ``mat`` that the kernel multiplies: for
    chunk c, its blocks of slabs ``ranges[c]`` (``[lo, hi)``), chunk after
    chunk.  Returns ``(flat bytes, first block of each chunk)``."""
    chunks = mat.shape[0] // CHUNK
    blocks = u8_blocks(mat).reshape(chunks, -1, 1024)
    first = np.zeros(chunks, dtype=np.uint16)
    kept, at = [], 0
    for c, (lo, hi) in enumerate(np.asarray(ranges, dtype=np.int64)):
        first[c] = at
        kept.append(blocks[c, lo:hi])
        at += hi - lo
    return np.concatenate(kept).reshape(-1), first


def smem_bytes(route: str, stream: bool, table_bytes: Tuple[int, int], lanes: int, kcols: int,
               units: int) -> int:
    """Dynamic shared memory of one launch (``make_layout`` of
    ``csrc/circuit_mma.cuh``: each part rounded up to 1 KB)."""
    b1 = route == "b1"
    parts = [
        0 if stream else table_bytes[0],
        0 if stream else table_bytes[1],
        ROWS * 16 if b1 else ROWS * lanes,
        ROWS * 16 if b1 else ROWS * lanes,
        ROWS * kcols // 8 if b1 else ROWS * kcols,
        2048 if stream else 0,
        4 * units,
        4 * units,
    ]
    return sum(_round_up(p, 1024) for p in parts)


@dataclass
class MmaTables:
    """One circuit as the tensor-core kernels read it (host arrays).

    ``lanes`` and ``units`` are ``n`` and ``U`` rounded up to 32; child
    columns cover units ``[c0, c0 + kcols)``, ``c0`` the first child unit
    rounded down to 32.  ``ranges`` ``(units / 32, 4)`` uint8 holds each
    chunk's member slabs ``[0, 1)`` and child slabs ``[2, 3)``.
    ``member``/``child`` are the named blocks as flat bytes
    (:func:`named_blocks`; u8, ``first`` ``(units / 32, 2)`` the first block
    of each chunk in each) or uint32 word rows (b1).  Padded units carry no
    votes and threshold 1, so they never hold."""

    route: str
    lanes: int
    units: int
    c0: int
    kcols: int
    depth: int
    first: np.ndarray
    stream: bool
    member: np.ndarray
    child: np.ndarray
    ranges: np.ndarray
    thr_q: np.ndarray
    thr_d: np.ndarray


def mma_tables(circuit: Circuit, circuit_d: Optional[Circuit], route: str) -> MmaTables:
    """The tables of ``circuit`` (and the D thresholds of ``circuit_d``, or
    its own) for ``route`` ``"u8"`` or ``"b1"``; KernelLimitError beyond the
    kernels' limits, ValueError for b1 on vote counts above 1."""
    n, u = circuit.n, circuit.n_units
    if n > MAX_LANES or u > MAX_UNITS:
        raise KernelLimitError(
            f"circuit has {n} lanes and {u} units; the packed kernels take at most {MAX_LANES} "
            f"lanes and {MAX_UNITS} units"
        )
    slab = SLAB[route]
    lanes = _round_up(max(n, 1), CHUNK)
    units = _round_up(max(u, lanes), CHUNK)
    kids = np.nonzero(circuit.child.any(axis=0))[0]
    first_kid = int(kids[0]) if kids.size else u
    c0 = first_kid - first_kid % CHUNK
    kcols = _round_up(units - c0, slab)
    members = np.zeros((units, lanes), dtype=np.uint8)
    members[:u, :n] = circuit.members
    child = np.zeros((units, kcols), dtype=np.uint8)
    child[:u, : u - c0] = circuit.child[:, c0:]
    ranges = np.concatenate([slab_ranges(members, slab), slab_ranges(child, slab)], axis=1)
    thr_q = np.ones(units, dtype=np.int32)
    thr_q[:u] = circuit.thresholds
    thr_d = thr_q.copy()
    if circuit_d is not None:
        thr_d[:u] = circuit_d.thresholds
    depth = circuit.depth if u > n else 0
    if route == "b1":
        bitset_encode(circuit)  # ValueError on multiplicities
        # Four words a row: one k128 step of the and-popc product.
        member_t = pack_mask_words(members, MAX_LANES // 32)
        child_t = pack_mask_words(child, kcols // 32) if kcols else np.zeros((units, 0), np.uint32)
        first = np.zeros((units // CHUNK, 2), dtype=np.uint16)
    else:
        (member_t, mfirst), (child_t, cfirst) = (named_blocks(members, ranges[:, :2]),
                                                 named_blocks(child, ranges[:, 2:]))
        first = np.stack([mfirst, cfirst], axis=1)
    nbytes = (member_t.nbytes, child_t.nbytes)
    stream = route == "u8" and smem_bytes(route, False, nbytes, lanes, kcols, units) > SMEM_BUDGET
    if smem_bytes(route, stream, nbytes, lanes, kcols, units) > SMEM_BUDGET:
        raise KernelLimitError(f"the packed {route} kernel's tiles do not fit one block")
    return MmaTables(route, lanes, units, c0, kcols, depth, first, stream, member_t, child_t,
                     ranges, thr_q, thr_d)


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
        self.base, self.bits = group_decode(pos, lane_group, self.k)
        route = "u8" if engine == "dense" else "b1"
        t = self.tables = mma_tables(circuit, circuit_d, route)
        self.instance = _INSTANCE[(route, t.stream)]
        lanes = np.asarray(group_ind).T != 0  # (K, n)
        self.gmask = np.ascontiguousarray(pack_mask_words(lanes, MAX_LANES // 32))
        self.scc = np.ascontiguousarray(pack_mask_words(np.asarray(scc_mask) != 0, MAX_LANES // 32))
        self.ranges = np.ascontiguousarray(t.ranges)
        self.first = np.ascontiguousarray(t.first)
        self.member = upload_words(t.member, self.device) if route == "b1" else _upload_bytes(
            t.member, self.device)
        self.child = upload_words(t.child, self.device) if route == "b1" else _upload_bytes(
            t.child, self.device)
        self.thr_q = torch.from_numpy(t.thr_q).to(self.device)
        self.thr_d = torch.from_numpy(t.thr_d).to(self.device)

    def program(self, starts, steps: int) -> torch.Tensor:
        """Per-group min hit index over ``steps × batch`` rows from
        ``starts`` ((K,) int32 tensor; INT32_MAX for a clean miss)."""
        if self.ref is not None:
            return self.ref.program(starts, steps)
        launch = packed_sweep_dense if self.engine == "dense" else packed_sweep_bitset
        return launch(self, starts, steps * self.batch)


def _upload_bytes(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # At least one 16-byte vector, so the kernel's pointer is never null.
    flat = np.zeros(max(a.size, 16), dtype=np.uint8)
    flat[: a.size] = a.reshape(-1)
    return torch.from_numpy(flat).to(device)


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


def _launch(sweep: PackedSweep, starts, rows: int, name: str) -> torch.Tensor:
    s = _checked_starts(sweep, starts, rows)
    lib = _library()
    t = sweep.tables
    out = torch.full((sweep.k,), INT32_MAX, dtype=torch.int32, device=sweep.device)
    err = lib.qi_packed_sweep(
        sweep.instance, sweep.member.data_ptr(), sweep.child.data_ptr(), sweep.thr_q.data_ptr(),
        sweep.thr_d.data_ptr(), sweep.k, _ptr(s), _ptr(sweep.base), _ptr(sweep.bits),
        _ptr(sweep.gmask), _ptr(sweep.scc), t.lanes, t.units, t.c0, t.kcols, t.depth,
        t.member.nbytes, t.child.nbytes, _ptr(sweep.ranges), _ptr(sweep.first), rows, out.data_ptr(),
        torch.cuda.current_stream(sweep.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.qi_cuda_error_string(err).decode()}")
    return out


def packed_sweep_dense(sweep: PackedSweep, starts, rows: int) -> torch.Tensor:
    """Launch the dense packed kernel over ``rows`` rows on the current
    stream; returns the (K,) int32 result without synchronising."""
    out = _launch(sweep, starts, rows, "packed_sweep_dense")
    packed_sweep_dense.launches += 1
    return out


def packed_sweep_bitset(sweep: PackedSweep, starts, rows: int) -> torch.Tensor:
    """Launch the bitset packed kernel over ``rows`` rows on the current
    stream; returns the (K,) int32 result without synchronising."""
    out = _launch(sweep, starts, rows, "packed_sweep_bitset")
    packed_sweep_bitset.launches += 1
    return out


packed_sweep_dense.launches = 0  # type: ignore[attr-defined]
packed_sweep_bitset.launches = 0  # type: ignore[attr-defined]


def _library() -> ctypes.CDLL:
    lib = build.load("packed_sweep")
    if not getattr(lib, "_qi_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qi_packed_sweep.argtypes = [
            i, p, p, p, p, i, p, p, p, p, p, i, i, i, i, i, i, i, p, p, i64, p, p,
        ]
        lib.qi_packed_sweep.restype = i
        lib.qi_cuda_error_string.argtypes = [i]
        lib.qi_cuda_error_string.restype = ctypes.c_char_p
        lib._qi_typed = True
    return lib
