"""Wrapper of the unpacked bitset sweep kernel (``csrc/bitset_sweep.cu``).

:class:`BitsetSweep` holds one sweep problem's ``bitset_encode`` words on
its device and :meth:`BitsetSweep.program` evaluates ``steps × batch``
candidates from a start index, returning the smallest hit index as a 0-dim
int32 tensor (``INT32_MAX`` on a clean miss) — the contract of the JAX
package's ``bitset_sweep_program_factory`` programs and of
:class:`.sweep_cuda.FusedSweep`, whose arguments it takes, so the sweep
drive swaps one for the other by the resolved engine.

On a CUDA device it launches the kernel (:func:`bitset_sweep`, which counts
its launches) or raises; it never falls back.  On the CPU it runs the plain
version (:mod:`.bitset_sweep_ref`) — only because the tables lie on the CPU.

The kernel has three instances; :func:`bitset_tables` picks one from the
circuit's shape before any launch (``instance=`` forces one):

- ``"lanes"`` (:func:`lane_tables`): one candidate row a lane, for circuits
  of at most :data:`LANE_UNITS` units whose inner units all lie below the
  node units (the bitset workloads, full width, the snapshot).  Per unit
  position one 16-byte record ``{m0, m1, thr - 1, nonzero child words}``
  for each side (Q, D), the inner units renumbered by height so that one
  pass meets every child before its parent, and a dense child row of
  ``cw`` words a unit (``cw`` in 1, 2, 4; 0 where no unit has children);
- ``"resident"`` / ``"streamed"`` (the warp instance, wider circuits): per
  unit (padded to a multiple of 32) one 16-byte record ``{m0, m1, thr_q,
  thr_d}`` (its member words and both thresholds; a padded unit votes
  nothing against a threshold of 1), one ``{base, k0 | k1 << 16}`` pair
  naming its nonzero child words ``[k0, k1)`` of the ``bitset_encode``
  child row, and those words, concatenated: resident in shared memory where
  one block holds them beside the warps' satisfaction slots, streamed
  through L1/L2 otherwise.  These tables are built for every circuit, so
  a caller may force either instance on the same problem.

Kernel limits, checked before any launch (:class:`KernelLimitError`):
``n <= 64`` nodes (two availability words), 0/1 votes (``bitset_encode``'s
own limit), candidate indices below 2^31, and a block's satisfaction slots
within one block's shared memory: eight warps up to 3632 words of units
(116 224 units), fewer warps a block above that, one warp up to 929 792
units.  The JAX program takes any width; so does this kernel up to that.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from quorum_intersection_tpu_torch.backends.base import INT32_MAX
from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.encode.circuit import Circuit, bitset_encode, bitset_supported
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.kernels.bitset_sweep_ref import BitsetSweepRef
from quorum_intersection_tpu_torch.kernels.sweep_cuda import (
    INDEX_CEILING,
    MAX_NODES,
    SMEM_LIMIT,
    KernelLimitError,
    _bits_row,
    mask_bits,
    upload_words,
)

WARPS = 8  # warps a block, fewer where the satisfaction slots would not fit
UNIT_RECORD_BYTES = 16
RANGE_BYTES = 8
INSTANCES = ("lanes", "resident", "streamed")
LANE_UNITS = 128  # the lane instance holds at most four unit words in registers
LANE_DECODE_BYTES = 8 * 4 * 256  # four byte-indexed decode tables of uint2


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(units_pad: int, n_words: int, resident: bool, warps: int) -> int:
    """Shared memory of one block: ``csrc/bitset_sweep.cu`` ``smem_bytes``,
    term for term."""
    tables = (UNIT_RECORD_BYTES + RANGE_BYTES) * units_pad + _round_up(4 * n_words, 16)
    return (tables if resident else 0) + 8 * (units_pad // 32) * warps


def lane_smem_bytes(n_units: int, cw: int) -> int:
    """Shared memory of one lane-instance block: ``csrc/bitset_sweep.cu``
    ``lane_smem_bytes``, term for term."""
    return LANE_DECODE_BYTES + 2 * UNIT_RECORD_BYTES * n_units + _round_up(4 * cw * n_units, 16)


@dataclass
class LaneTables:
    """The circuit as the lane instance reads it: unit positions ``[0, n)``
    are the node units, ``[n, inner_end)`` the inner units by height
    (``order[p]`` is position p's unit); ``rec_q`` / ``rec_d`` one record a
    position, ``child`` its dense child row of ``cw`` words over positions
    (None, ``cw`` 0, where no unit has children)."""

    n: int
    n_units: int
    cw: int
    nw: int
    inner_end: int
    order: np.ndarray
    rec_q: torch.Tensor            # (n_units, 4) int32 bit patterns {m0, m1, thr - 1, child word mask}
    rec_d: torch.Tensor
    child: Optional[torch.Tensor]  # (n_units, cw) int32 bit patterns

    @property
    def smem(self) -> int:
        return lane_smem_bytes(self.n_units, self.cw)


def lane_tables(circuit: Circuit, circuit_d: Optional[Circuit], device: torch.device) -> Optional[LaneTables]:
    """The lane instance's tables, or None where it does not take the
    circuit: more than :data:`LANE_UNITS` units, a node unit that is some
    unit's child, a child whose ``unit_depth`` (its height) is not below
    its parent's, or a node unit higher than the inner rounds the plain
    version runs.  Otherwise one pass in height order equals those rounds."""
    n, u = circuit.n, circuit.n_units
    if u > LANE_UNITS or n > MAX_NODES:
        return None
    bits = bitset_encode(circuit)
    rounds = circuit.depth if u > n and bits.child_words is not None else 0
    child = np.asarray(circuit.child[:u, :u], dtype=bool) if rounds else np.zeros((u, u), dtype=bool)
    nw = bits.words
    if child.any():
        height = np.asarray(circuit.unit_depth[:u], dtype=np.int64)
        parents, kids = np.nonzero(child)
        if kids.min() < n or (height[kids] >= height[parents]).any() or int(height[:n].max()) > rounds:
            return None
        inner = sorted(range(n, u), key=lambda x: (int(height[x]), x))
        order = np.asarray(list(range(n)) + inner, dtype=np.int64)
        cw = max(1 << (-(-u // 32) - 1).bit_length(), nw)
        inner_end = u
    else:
        order = np.arange(u, dtype=np.int64)
        cw, inner_end = 0, n
    pos = np.empty(u, dtype=np.int64)
    pos[order] = np.arange(u)
    rows = np.zeros((u, cw), dtype=np.uint32)
    if cw:
        kid = child[order]  # rows by position, columns by unit
        for p in range(u):
            for k in pos[np.nonzero(kid[p])[0]]:
                rows[p, k >> 5] |= np.uint32(1 << (int(k) & 31))
    mask = ((rows != 0).astype(np.uint32) << np.arange(cw, dtype=np.uint32)).sum(axis=1).astype(np.uint32)

    def records(thresholds) -> torch.Tensor:
        rec = np.zeros((u, 4), dtype=np.uint32)
        rec[:, :nw] = bits.member_words[order]
        rec[:, 2] = (np.asarray(thresholds, dtype=np.int32)[order] - 1).view(np.uint32)
        rec[:, 3] = mask
        return upload_words(rec, device)

    rec_q = records(circuit.thresholds)
    rec_d = rec_q if circuit_d is None else records(circuit_d.thresholds)
    return LaneTables(n=n, n_units=u, cw=cw, nw=nw, inner_end=inner_end, order=order, rec_q=rec_q, rec_d=rec_d,
                      child=upload_words(rows, device) if cw else None)


@dataclass
class BitsetTables:
    """The circuit as the kernel reads it (see the module docstring):
    the warp instance's tables always, the lane instance's where it takes
    the circuit; ``instance`` is the one launched."""

    n: int
    n_units: int
    units_pad: int
    nw: int
    rounds: int
    n_words: int
    instance: str
    warps: int
    units: torch.Tensor   # (units_pad, 4) int32 bit patterns
    ranges: torch.Tensor  # (units_pad, 2) int32
    words: torch.Tensor   # (max(n_words, 1),) int32 bit patterns
    lanes: Optional[LaneTables]

    @property
    def resident(self) -> bool:
        """The warp instance with its tables in shared memory."""
        return self.instance == "resident"

    @property
    def nbytes(self) -> int:
        if self.instance == "lanes":
            return self.lanes.smem - LANE_DECODE_BYTES
        return (UNIT_RECORD_BYTES + RANGE_BYTES) * self.units_pad + 4 * self.n_words


def bitset_tables(circuit: Circuit, circuit_d: Optional[Circuit], device: torch.device,
                  instance: Optional[str] = None) -> BitsetTables:
    """The kernel's tables of ``circuit`` (Q thresholds) and ``circuit_d``
    (D thresholds; None: the same).  ``instance`` None picks from the
    shape: the lane instance where it takes the circuit, else the warp
    instance, resident where one block of eight warps holds its tables."""
    if instance not in (None, *INSTANCES):
        raise ValueError(f"instance {instance!r}: one of {INSTANCES} or None")
    n, u = circuit.n, circuit.n_units
    if n > MAX_NODES:
        raise KernelLimitError(f"circuit has {n} nodes; the kernel takes at most {MAX_NODES}")
    if not bitset_supported(circuit):
        raise KernelLimitError("vote multiplicities above 1: the bitset kernel holds one bit per member")
    bits = bitset_encode(circuit)
    units_pad = _round_up(max(u, 1), 32)
    rec = np.zeros((units_pad, 4), dtype=np.uint32)
    rec[:, 2:] = 1  # padded units: no votes against a threshold of 1
    rec[:u, : bits.words] = bits.member_words
    thr_d = circuit.thresholds if circuit_d is None else circuit_d.thresholds
    rec[:u, 2] = np.asarray(circuit.thresholds, dtype=np.int32).view(np.uint32)
    rec[:u, 3] = np.asarray(thr_d, dtype=np.int32).view(np.uint32)
    ranges = np.zeros((units_pad, 2), dtype=np.int32)
    words = []
    n_words = 0
    if bits.child_words is not None:
        for x in range(u):
            nz = np.nonzero(bits.child_words[x])[0]
            if not nz.size:
                continue
            k0, k1 = int(nz[0]), int(nz[-1]) + 1
            packed = k0 | (k1 << 16)  # read as uint32 by the kernel
            ranges[x] = (n_words - k0, packed - (1 << 32) if packed >= 1 << 31 else packed)
            words.append(bits.child_words[x, k0:k1])
            n_words += k1 - k0
    rounds = circuit.depth if u > n and bits.child_words is not None else 0
    warps = WARPS
    while warps > 1 and smem_bytes(units_pad, 0, False, warps) > SMEM_LIMIT:
        warps -= 1
    if smem_bytes(units_pad, 0, False, warps) > SMEM_LIMIT:
        raise KernelLimitError(
            f"{u} units: one warp's two satisfaction slots pass one block's {SMEM_LIMIT} bytes of shared memory"
        )
    lanes = lane_tables(circuit, circuit_d, device) if instance in (None, "lanes") else None
    fits = smem_bytes(units_pad, n_words, True, warps) <= SMEM_LIMIT
    if instance is None:
        instance = "lanes" if lanes is not None else "resident" if fits else "streamed"
    elif instance == "lanes" and lanes is None:
        raise KernelLimitError(
            f"the lane instance takes at most {LANE_UNITS} units with every inner unit below the node units"
        )
    elif instance == "resident" and not fits:
        raise KernelLimitError(
            f"the resident instance needs {smem_bytes(units_pad, n_words, True, warps)} bytes of shared "
            f"memory; one block may take at most {SMEM_LIMIT}"
        )
    word_array = np.concatenate(words) if words else np.zeros(1, dtype=np.uint32)
    return BitsetTables(
        n=n, n_units=u, units_pad=units_pad, nw=bits.words, rounds=rounds, n_words=n_words,
        instance=instance, warps=warps,
        units=upload_words(rec, device), ranges=torch.from_numpy(ranges).to(device),
        words=upload_words(word_array.astype(np.uint32), device), lanes=lanes,
    )


class BitsetSweep:
    """One bitset sweep problem on one device, with :class:`FusedSweep`'s
    arguments: ``circuit`` the Q side, ``circuit_d`` (same members, child
    and units, other thresholds) the D probe of an SCC-restricted sweep or
    None, ``lo_nodes[j]`` the node index bit ``j`` toggles.  ``instance``
    None picks the kernel's instance from the circuit's shape (the tests
    force each: ``"lanes"``, ``"resident"``, ``"streamed"``)."""

    def __init__(
        self,
        circuit: Circuit,
        lo_nodes: np.ndarray,
        scc_mask: np.ndarray,
        frozen: Optional[np.ndarray],
        batch: int,
        circuit_d: Optional[Circuit] = None,
        device: DeviceLike = None,
        instance: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.batch = int(batch)
        self.n = circuit.n
        lo_nodes = np.asarray(lo_nodes, dtype=np.int32)
        self.lo_bits = int(lo_nodes.shape[0])
        if circuit_d is not None and (
            circuit_d.n_units != circuit.n_units
            or not np.array_equal(circuit_d.members, circuit.members)
            or not np.array_equal(circuit_d.child, circuit.child)
        ):
            raise ValueError("circuit_d must share members, child and units with circuit")
        if self.device.type == "cpu":
            self.ref: Optional[BitsetSweepRef] = BitsetSweepRef(
                circuit, lo_nodes, scc_mask, frozen, batch, circuit_d, self.device
            )
            return
        self.ref = None
        if self.lo_bits >= 31:
            raise KernelLimitError(f"lo_bits={self.lo_bits}: indices must stay below 2^31")
        self.tables = bitset_tables(circuit, circuit_d, self.device, instance)
        self.lo_nodes = torch.from_numpy(lo_nodes if lo_nodes.size else np.zeros(1, np.int32)).to(self.device)
        self.scc_bits = mask_bits(scc_mask)
        self.frozen_bits = mask_bits(frozen)

    def program(self, start: int, steps: int, hi_mask: int = 0) -> torch.Tensor:
        """Min hit index over ``steps × batch`` candidates from ``start``;
        ``hi_mask`` is the wide decode's constant row as node bits."""
        if self.ref is not None:
            hi = None if not hi_mask else _bits_row(hi_mask, self.n)
            return self.ref.program(start, steps, hi)
        return bitset_sweep(self, start, steps * self.batch, hi_mask)


def bitset_sweep(sweep: BitsetSweep, start: int, rows: int, hi_mask: int = 0) -> torch.Tensor:
    """Launch the bitset kernel over ``rows`` candidates on the current
    stream; returns the 0-dim int32 result without synchronising."""
    if sweep.device.type != "cuda":
        raise ValueError(f"bitset_sweep launches on CUDA only, got {sweep.device}")
    if start < 0 or start + rows > INDEX_CEILING:
        raise KernelLimitError(f"candidates [{start}, {start + rows}) cross the 2^31 index ceiling")
    t = sweep.tables
    lib = _library()
    out = torch.empty((), dtype=torch.int32, device=sweep.device)
    out.fill_(INT32_MAX)  # on the launch's stream, ahead of the kernel
    stream = torch.cuda.current_stream(sweep.device).cuda_stream
    if t.instance == "lanes":
        lt = t.lanes
        err = lib.qi_bitset_sweep_lanes(
            lt.rec_q.data_ptr(), lt.rec_d.data_ptr(), None if lt.child is None else lt.child.data_ptr(), lt.n,
            lt.inner_end, lt.n_units, lt.cw, lt.nw, sweep.lo_nodes.data_ptr(), sweep.lo_bits, hi_mask,
            sweep.scc_bits, sweep.frozen_bits, start, rows, out.data_ptr(), stream,
        )
    else:
        err = lib.qi_bitset_sweep(
            t.units.data_ptr(), t.ranges.data_ptr(), t.words.data_ptr(), t.n_words, t.units_pad, t.nw,
            t.rounds, int(t.resident), t.warps, sweep.lo_nodes.data_ptr(), sweep.lo_bits, hi_mask,
            sweep.scc_bits, sweep.frozen_bits, start, rows, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"qi_bitset_sweep launch failed: {lib.qi_cuda_error_string(err).decode()}")
    bitset_sweep.launches += 1
    return out


bitset_sweep.launches = 0  # type: ignore[attr-defined]


def _library() -> ctypes.CDLL:
    lib = build.load("bitset_sweep")
    if not getattr(lib, "_qi_typed", False):
        p, i, u64, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_longlong
        lib.qi_bitset_sweep.argtypes = [p, p, p, i, i, i, i, i, i, p, i, u64, u64, u64, i64, i64, p, p]
        lib.qi_bitset_sweep.restype = i
        lib.qi_bitset_sweep_smem.argtypes = [i, i, i, i]
        lib.qi_bitset_sweep_smem.restype = i64
        lib.qi_bitset_sweep_lanes.argtypes = [p, p, p, i, i, i, i, i, p, i, u64, u64, u64, i64, i64, p, p]
        lib.qi_bitset_sweep_lanes.restype = i
        lib.qi_bitset_lanes_smem.argtypes = [i, i]
        lib.qi_bitset_lanes_smem.restype = i64
        lib.qi_cuda_error_string.argtypes = [i]
        lib.qi_cuda_error_string.restype = ctypes.c_char_p
        lib._qi_typed = True
    return lib
