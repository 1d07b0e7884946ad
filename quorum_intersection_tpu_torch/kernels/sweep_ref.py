"""Plain PyTorch version of the fused sweep — the CPU path and the yardstick
the CUDA kernel (:mod:`.sweep_cuda`) is held against on the card.

Counterpart of the JAX package's ``backends/tpu/kernels.py:61-356``
(``CircuitArrays``, ``node_sat``, ``fixpoint``, ``decode_masks``,
``sweep_step``, ``sweep_program_factory``), written as plain functions on
tensors with an explicit device.

Vote counts stay exact integers (``kernels.py:21-30``):

- on the CPU, int32 operands and int32 matmuls;
- on the card, int8 operands with int32 accumulation through
  ``torch._int_mm`` (PyTorch has no int32 matmul on CUDA).  That call wants
  a contraction and a width that are multiples of 8 and more than 16 rows,
  so :meth:`CircuitTables.dot` pads with zero rows/columns, which add
  nothing to any vote.  A circuit whose counts exceed int8 raises there.

Never bf16 or fp16: a rounded vote count would flip a threshold compare.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from quorum_intersection_tpu_torch.backends.base import INT32_MAX
from quorum_intersection_tpu_torch.encode.circuit import Circuit

_INT8_MAX_COUNT = 127


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class CircuitTables:
    """Device-resident circuit constants for the plain version.

    ``members_t`` is (n, U); ``child_t`` holds the rows of ``child.T`` from
    ``child_from`` on — the first unit that is anyone's child (inner units
    follow the node roots, so the rows before it are zero and add no vote)
    — or None without inner units; ``thresholds`` (U,) int32.
    """

    def __init__(self, circuit: Circuit, device: torch.device):
        self.device = torch.device(device)
        self.n = circuit.n
        self.n_units = circuit.n_units
        self.depth = circuit.depth
        self.has_inner = circuit.n_units > circuit.n
        kids = np.nonzero(circuit.child.any(axis=0))[0]
        self.child_from = int(kids[0]) if kids.size else self.n_units
        if self.device.type == "cpu":
            self.dtype = torch.int32
            members_t = torch.from_numpy(circuit.members.T.astype(np.int32))
            child_t = torch.from_numpy(circuit.child.T[self.child_from:].astype(np.int32))
        else:
            biggest = max(
                int(circuit.members.max(initial=0)), int(circuit.child.max(initial=0))
            )
            if biggest > _INT8_MAX_COUNT:
                raise ValueError(
                    f"vote count {biggest} exceeds int8 ({_INT8_MAX_COUNT}): the "
                    "plain version's int8 matmul on the card cannot hold it"
                )
            self.dtype = torch.int8
            # _int_mm's preferred layout: row-major left operand, column-major
            # right operand, both padded to multiples of 8, the unit columns
            # to 16: on the H100 cuBLASLt refuses 2^17 rows against 40
            # columns (8 mod 16) at an inner size of 16, 32, 48 or 64.
            n8 = _round_up(max(self.n, 1), 8)
            u8 = _round_up(max(self.n_units, 1), 16)
            m = np.zeros((u8, n8), dtype=np.int8)
            m[: self.n_units, : self.n] = circuit.members
            k8 = _round_up(max(self.n_units - self.child_from, 1), 8)
            c = np.zeros((u8, k8), dtype=np.int8)
            c[: self.n_units, : self.n_units - self.child_from] = circuit.child[:, self.child_from:]
            members_t = torch.from_numpy(m).t()
            child_t = torch.from_numpy(c).t()
        self.members_t = members_t.to(self.device)
        self.child_t = child_t.to(self.device) if self.has_inner else None
        self.thresholds = torch.from_numpy(
            np.asarray(circuit.thresholds, dtype=np.int32)
        ).to(self.device)

    def dot(self, a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
        """Exact integer ``a @ b`` → (rows, width) int32."""
        if self.device.type == "cpu":
            return a @ b
        rows, k = a.shape
        pad_rows = max(17 - rows, 0)
        if pad_rows or k != b.shape[0]:
            a = torch.nn.functional.pad(a, (0, b.shape[0] - k, 0, pad_rows))
        return torch._int_mm(a.contiguous(), b)[:rows, :width]

    def cast(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=self.dtype)


def node_sat(tables: CircuitTables, avail: torch.Tensor) -> torch.Tensor:
    """Which nodes have a satisfied slice under ``avail`` (B, n) 0/1?

    Returns (B, n) 0/1 in ``tables.dtype``; Q4 self-availability is the
    trailing product."""
    u = tables.n_units
    base = tables.dot(avail, tables.members_t, u)  # (B, U) direct votes
    sat = (base >= tables.thresholds).to(tables.dtype)
    for _ in range(tables.depth if tables.has_inner else 0):
        child = tables.dot(sat[:, tables.child_from:], tables.child_t, u)
        sat = ((base + child) >= tables.thresholds).to(tables.dtype)
    return sat[:, : tables.n] * avail


def fixpoint(
    tables: CircuitTables,
    avail: torch.Tensor,
    frozen: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greatest-fixpoint quorum per row of ``avail`` (B, n).

    ``frozen`` (n,) marks nodes that satisfy slices but are never filtered
    (the Q6 whole-graph availability); ``None`` scopes to the candidates.
    """
    return fixpoint_passes(tables, avail, frozen)[0]


def fixpoint_passes(
    tables: CircuitTables,
    avail: torch.Tensor,
    frozen: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fixpoint` plus, per row, the node_sat passes it took (the
    confirming pass included) — the data-dependent work a roofline bound for
    this input counts.

    The JAX ``while_loop`` re-evaluates the whole batch until every row is
    stable; converged rows are idempotent under the update, so this loop
    drops each row once it is stable (as the CUDA kernel's per-row loop
    does) and returns the same rows.
    """
    out = tables.cast(avail).clone()
    if frozen is None:
        frozen_row = torch.zeros(tables.n, dtype=tables.dtype, device=tables.device)
    else:
        frozen_row = tables.cast(frozen)
    passes = torch.zeros(out.shape[0], dtype=torch.int64, device=tables.device)
    rows = torch.arange(out.shape[0], device=tables.device)
    a = out
    while rows.numel():
        passes[rows] += 1
        nxt = node_sat(tables, torch.maximum(a, frozen_row)) * a
        live = (nxt != a).any(dim=1)
        out[rows] = nxt
        rows, a = rows[live], nxt[live]
    return out, passes


def bit_positions(bit_nodes: np.ndarray, n: int) -> np.ndarray:
    """Per-node bit index for the subset decode: ``pos[bit_nodes[j]] = j``,
    every other node 31 (a non-negative int32 index shifted right by 31 is
    0, so non-enumerated nodes decode as absent)."""
    pos = np.full((n,), 31, dtype=np.int32)
    for j, v in enumerate(np.asarray(bit_nodes, dtype=np.int64)):
        pos[int(v)] = j
    return pos


def decode_masks(
    start: int, batch: int, pos: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """Candidate indices ``start + [0, batch)`` → (batch, n) 0/1 rows.
    Indices stay below 2^31 (the sweep backend's index ceiling)."""
    return decode_indices(start + torch.arange(batch, dtype=torch.int32, device=pos.device), pos, dtype)


def decode_indices(idx: torch.Tensor, pos: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 candidate indices (B,) → (B, n) 0/1 rows."""
    return ((idx[:, None] >> pos[None, :]) & 1).to(dtype)


def sweep_step(
    tables: CircuitTables,
    start: int,
    batch: int,
    pos: torch.Tensor,
    scc_mask: torch.Tensor,
    frozen: torch.Tensor,
    hi_mask: Optional[torch.Tensor] = None,
    tables_d: Optional[CircuitTables] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of candidates: Q = fixpoint(S); hit ⇔ Q ≠ ∅ ∧
    fixpoint(scc ∖ Q) ≠ ∅, the probe under ``tables_d``'s thresholds (the
    SCC-restricted Q6 fold) or ``frozen``.  Returns ``(hit, q_size)``."""
    idx = start + torch.arange(batch, dtype=torch.int32, device=pos.device)
    return sweep_rows(tables, idx, pos, scc_mask, frozen, hi_mask, tables_d)


def sweep_rows(
    tables: CircuitTables,
    idx: torch.Tensor,
    pos: torch.Tensor,
    scc_mask: torch.Tensor,
    frozen: torch.Tensor,
    hi_mask: Optional[torch.Tensor] = None,
    tables_d: Optional[CircuitTables] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sweep_step` on explicit int32 candidate indices ``idx``."""
    td = tables if tables_d is None else tables_d
    avail = decode_indices(idx, pos, tables.dtype)
    if hi_mask is not None:
        avail = torch.maximum(avail, tables.cast(hi_mask))
    q = fixpoint(tables, avail)
    q_size = q.sum(dim=-1, dtype=torch.int32)
    has_q = q_size > 0
    # Rows with an empty Q cannot hit: probe only the others.
    complement = torch.clamp(scc_mask.to(torch.int32) - q[has_q].to(torch.int32), 0, 1)
    d = fixpoint(td, complement, frozen)
    hit = torch.zeros_like(has_q)
    hit[has_q] = d.sum(dim=-1, dtype=torch.int32) > 0
    return hit, q_size


class SweepRef:
    """One sweep problem's constants for the plain version, uploaded once:
    the Q-side and (optional) D-side tables, the decode positions, the SCC
    and frozen rows."""

    def __init__(
        self,
        circuit: Circuit,
        bit_nodes: np.ndarray,
        scc_mask: np.ndarray,
        frozen: Optional[np.ndarray],
        batch: int,
        circuit_d: Optional[Circuit] = None,
        device: torch.device = torch.device("cpu"),
    ):
        self.batch = int(batch)
        self.tables = CircuitTables(circuit, device)
        self.tables_d = None if circuit_d is None else CircuitTables(circuit_d, device)
        self.pos = torch.from_numpy(bit_positions(bit_nodes, circuit.n)).to(device)
        self.scc_mask = self.tables.cast(np.asarray(scc_mask))
        self.frozen = (
            torch.zeros(circuit.n, dtype=self.tables.dtype, device=self.tables.device)
            if frozen is None
            else self.tables.cast(np.asarray(frozen))
        )

    def block_min_hit(self, start: int, hi_mask: Optional[torch.Tensor]) -> torch.Tensor:
        idx = start + torch.arange(self.batch, dtype=torch.int32, device=self.pos.device)
        return self.rows_min_hit(idx, hi_mask)

    def rows_min_hit(self, idx: torch.Tensor, hi_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Min hit index among the int32 candidate indices ``idx``."""
        hit, _ = sweep_rows(
            self.tables, idx, self.pos, self.scc_mask, self.frozen, hi_mask, tables_d=self.tables_d,
        )
        miss = torch.full_like(idx, INT32_MAX)
        return torch.where(hit, idx, miss).min()

    def program(self, start: int, steps: int, hi_mask=None) -> torch.Tensor:
        """Min hit index over ``steps`` blocks from ``start`` as a 0-dim
        int32 tensor (INT32_MAX on a clean miss)."""
        hi = None if hi_mask is None else self.tables.cast(np.asarray(hi_mask))
        best = self.block_min_hit(start, hi)
        for i in range(1, steps):
            best = torch.minimum(best, self.block_min_hit(start + i * self.batch, hi))
        return best


def sweep_program_factory(
    circuit: Circuit,
    bit_nodes: np.ndarray,
    scc_mask: np.ndarray,
    frozen: Optional[np.ndarray],
    batch: int,
    circuit_d: Optional[Circuit] = None,
    device: torch.device = torch.device("cpu"),
) -> Callable[[int], Callable[..., torch.Tensor]]:
    """Same contract as the JAX ``sweep_program_factory``: ``factory(steps)``
    returns ``program(start, hi_mask=None)`` covering ``batch × steps``
    candidates and returning the min hit index (0-dim int32)."""
    ref = SweepRef(circuit, bit_nodes, scc_mask, frozen, batch, circuit_d, device)

    def factory(steps: int) -> Callable[..., torch.Tensor]:
        return lambda start, hi_mask=None: ref.program(start, steps, hi_mask)

    return factory
