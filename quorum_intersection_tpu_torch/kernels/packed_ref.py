"""Plain PyTorch version of the lane-packed sweeps — the CPU path and the
yardstick the CUDA kernels (:mod:`.packed_cuda`) are held against on the card.

Counterpart of the JAX package's packed programs, dense and bitset:

- ``decode_masks_packed``, ``packed_sweep_step`` and
  ``packed_sweep_program_factory`` (``backends/tpu/kernels.py:397-497``),
  which compute what the Pallas kernel ``pallas_packed_program_factory``
  (``pallas_sweep.py:343``) computes;
- ``popcount_votes``, ``pack_bits`` and ``bitset_fixpoint``
  (``kernels.py:561-632``) over the ``BitsetCircuit`` words, driven the way
  ``pallas_bitset_program_factory`` (``pallas_sweep.py:556``) drives them.

A program takes the ``(K,)`` per-group starts and returns the ``(K,)``
per-group smallest hit index, ``INT32_MAX`` for a group's clean miss.  All
groups advance in lockstep (``starts + i*batch``); the packed drive owns the
per-group ranges and masks overshoot on the host.

Dense vote counts reuse :class:`.sweep_ref.CircuitTables` (int32 on the CPU,
``torch._int_mm`` int8/int32 on the card).  Bitset words are held as int64
tensors of 32-bit patterns (PyTorch has no popcount and little uint32
arithmetic), counted with the shift-and-mask identity — exact.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quorum_intersection_tpu_torch.backends.base import INT32_MAX
from quorum_intersection_tpu_torch.encode.circuit import Circuit, bitset_encode, pack_mask_words
from quorum_intersection_tpu_torch.kernels.sweep_ref import CircuitTables, _round_up, fixpoint

ENGINES = ("dense", "bitset")


def decode_masks_packed(
    starts_lane: torch.Tensor, batch: int, pos: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """Each lane decodes its OWN group's candidate: row r, lane l is bit
    ``pos[l]`` of ``starts_lane[l] + r`` ((n,) int32 starts broadcast per
    lane; padded lanes carry ``pos`` 31 and decode to 0)."""
    rows = torch.arange(batch, dtype=torch.int32, device=pos.device)[:, None]
    return (((starts_lane[None, :] + rows) >> pos[None, :]) & 1).to(dtype)


class GroupCounts:
    """Per-group survivor counts ``(B, n) → (B, K)``: the lane-to-group
    indicator product, exact in the tables' integer regime."""

    def __init__(self, tables: CircuitTables, group_ind: np.ndarray):
        self.tables = tables
        self.k = int(group_ind.shape[1])
        gi = (np.asarray(group_ind) != 0).astype(np.int32)
        if tables.device.type == "cpu":
            self.ind = torch.from_numpy(gi).to(tables.device)
        else:
            # _int_mm's layout: column-major right operand, padded to 8.
            padded = np.zeros((_round_up(gi.shape[0], 8), _round_up(self.k, 8)), dtype=np.int8)
            padded[: gi.shape[0], : self.k] = gi
            self.ind = torch.from_numpy(padded.T.copy()).t().to(tables.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.tables.dot(x.to(self.tables.dtype), self.ind, self.k)


def packed_sweep_step(
    tables: CircuitTables,
    starts_lane: torch.Tensor,
    batch: int,
    pos: torch.Tensor,
    scc_mask: torch.Tensor,
    counts: GroupCounts,
    tables_d: Optional[CircuitTables] = None,
) -> torch.Tensor:
    """One block over a packed circuit: ``(B, K)`` bool, group g's row r
    exposing a disjoint quorum pair for candidate ``starts[g] + r``."""
    td = tables if tables_d is None else tables_d
    avail = decode_masks_packed(starts_lane, batch, pos, tables.dtype)
    q = fixpoint(tables, avail)
    complement = torch.clamp(scc_mask.to(torch.int32) - q.to(torch.int32), 0, 1)
    d = fixpoint(td, complement)
    return (counts(q) > 0) & (counts(d) > 0)


# -- bitset ------------------------------------------------------------------


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element population count of 32-bit patterns held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def popcount_votes(avail_words: torch.Tensor, table_w: torch.Tensor) -> torch.Tensor:
    """``(B, W) × (W, U) → (B, U)`` int32: ``Σ_w popcount(avail[:, w] &
    table[w, :])`` — the bitset twin of the dense ``avail @ membersᵀ``."""
    votes = None
    for w in range(int(table_w.shape[0])):
        hits = popcount32(avail_words[:, w : w + 1] & table_w[w][None, :])
        votes = hits if votes is None else votes + hits
    return votes


def pack_bits(bits: torch.Tensor, words: int) -> torch.Tensor:
    """0/1 lanes ``(B, m)`` → int64 words ``(B, words)``, LSB-first (the
    ``pack_mask_words`` convention)."""
    b = bits.to(torch.int64)
    pad = words * 32 - b.shape[-1]
    if pad > 0:
        b = torch.nn.functional.pad(b, (0, pad))
    shifts = torch.arange(32, dtype=torch.int64, device=b.device)
    return (b.reshape(b.shape[0], words, 32) << shifts).sum(dim=-1)


class BitsetTables:
    """Device-resident ``BitsetCircuit`` words, transposed as the JAX
    ``BitsetArrays`` holds them: ``member_w`` (words, U), ``child_w``
    (unit_words, U) or None, ``thresholds`` (U,) int32."""

    def __init__(self, circuit: Circuit, device: torch.device):
        bits = bitset_encode(circuit)
        self.device = torch.device(device)
        self.n, self.n_units, self.depth = bits.n, bits.n_units, bits.depth
        self.words, self.unit_words = bits.words, bits.unit_words
        self.has_inner = bits.n_units > bits.n and bits.child_words is not None

        def words_t(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a.T).astype(np.int64)).to(self.device)

        self.member_w = words_t(bits.member_words)
        self.child_w = words_t(bits.child_words) if self.has_inner else None
        self.thresholds = torch.from_numpy(bits.thresholds).to(self.device)


def bitset_node_sat(bt: BitsetTables, avail_words: torch.Tensor) -> torch.Tensor:
    """Satisfied-node words ``(B, words)``, Q4 self-availability included."""
    base = popcount_votes(avail_words, bt.member_w)
    sat = (base >= bt.thresholds).to(torch.int32)
    for _ in range(bt.depth if bt.has_inner else 0):
        inner = popcount_votes(pack_bits(sat, bt.unit_words), bt.child_w)
        sat = ((base + inner) >= bt.thresholds).to(torch.int32)
    return pack_bits(sat[:, : bt.n], bt.words) & avail_words


def bitset_fixpoint(bt: BitsetTables, avail_words: torch.Tensor) -> torch.Tensor:
    """Greatest-fixpoint quorum per row over packed words.  Rows drop out
    once stable (converged rows are idempotent under the update)."""
    out = avail_words.clone()
    rows = torch.arange(out.shape[0], device=out.device)
    a = out
    while rows.numel():
        nxt = bitset_node_sat(bt, a) & a
        live = (nxt != a).any(dim=1)
        out[rows] = nxt
        rows, a = rows[live], nxt[live]
    return out


class PackedRef:
    """One pack's constants for the plain version, uploaded once.

    ``(pos, scc_mask, lane_group, group_ind)`` are
    ``PackedCircuit.decode_tables()``; ``circuit_d`` is the Q6 twin or None.
    ``engine`` is ``"dense"`` (bit-exact vote counts of any multiplicity)
    or ``"bitset"`` (0/1 votes as words).
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
        device: torch.device = torch.device("cpu"),
    ):
        if engine not in ENGINES:
            raise ValueError(f"unknown packed engine {engine!r}")
        self.engine = engine
        self.batch = int(batch)
        self.device = torch.device(device)
        self.k = int(group_ind.shape[1])
        self.lane_group = torch.from_numpy(np.asarray(lane_group, dtype=np.int64)).to(self.device)
        self.pos = torch.from_numpy(np.asarray(pos, dtype=np.int32)).to(self.device)
        if engine == "dense":
            self.tables = CircuitTables(circuit, self.device)
            self.tables_d = None if circuit_d is None else CircuitTables(circuit_d, self.device)
            self.scc = self.tables.cast(np.asarray(scc_mask) != 0)
            self.counts = GroupCounts(self.tables, group_ind)
            return
        self.bits = BitsetTables(circuit, self.device)
        self.bits_d = self.bits if circuit_d is None else BitsetTables(circuit_d, self.device)
        words = self.bits.words

        def words_of(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(pack_mask_words(a, words).astype(np.int64)).to(self.device)

        self.scc_w = words_of(np.asarray(scc_mask))
        self.gmask_w = words_of(np.asarray(group_ind).T).T.contiguous()  # (words, K)

    def hits(self, starts: torch.Tensor) -> torch.Tensor:
        """``(batch, K)`` bool hit table of the block at ``starts``."""
        starts_lane = starts[self.lane_group]
        if self.engine == "dense":
            return packed_sweep_step(
                self.tables, starts_lane, self.batch, self.pos, self.scc, self.counts,
                tables_d=self.tables_d,
            )
        bt, bd = self.bits, self.bits_d
        avail = pack_bits(decode_masks_packed(starts_lane, self.batch, self.pos, torch.int64), bt.words)
        q = bitset_fixpoint(bt, avail)
        d = bitset_fixpoint(bd, self.scc_w & ~q)
        return (popcount_votes(q, self.gmask_w) > 0) & (popcount_votes(d, self.gmask_w) > 0)

    def block_min_hit(self, starts: torch.Tensor) -> torch.Tensor:
        idx = starts[None, :] + torch.arange(self.batch, dtype=torch.int32, device=self.device)[:, None]
        miss = torch.full_like(idx, INT32_MAX)
        return torch.where(self.hits(starts), idx, miss).min(dim=0).values

    def program(self, starts, steps: int) -> torch.Tensor:
        """Per-group min hit index over ``steps`` blocks from ``starts``
        ((K,) int32 tensor, INT32_MAX for a clean miss)."""
        s = torch.as_tensor(np.asarray(starts, dtype=np.int32)).to(self.device)
        best = self.block_min_hit(s)
        for i in range(1, steps):
            best = torch.minimum(best, self.block_min_hit(s + i * self.batch))
        return best
