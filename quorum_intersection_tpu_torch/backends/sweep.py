"""Exhaustive batched candidate sweep over the quorum-bearing SCC, on the card.

A lean port of the JAX package's ``TpuSweepBackend``: the unpacked drive
``check_scc`` (``backends/tpu/sweep.py:705-1453``) through the fused kernel,
and the lane-packed batch drive ``check_sccs``/``_run_pack``
(``sweep.py:1492-2154``) through the packed kernels.

**Verdict equivalence**: two disjoint quorums exist inside the SCC iff some
subset ``S ⊆ scc ∖ {scc[0]}`` has ``Q := maxQuorum(S) ≠ ∅`` and
``maxQuorum(scc ∖ Q) ≠ ∅`` (proof in the JAX module's docstring), so the
sweep enumerates the 2^(|scc|-1) subsets.

What the unpacked drive keeps: SCC restriction with the Q6 fold for the D
probe, the narrow decode and the two-level wide decode (low ``lo_bits``
index bits decode in the kernel, the rest ride a per-program hi row), the
``STEPS_RAMP`` program sizes, a FIFO of up to ``MAX_INFLIGHT`` asynchronous
programs drained oldest-first, the cancel check, and the host witness
recheck.  The witness is the globally smallest hit index, exactly as in the
JAX package: programs drain in index order and each reports its own minimum.
The packed drive keeps the JAX drive's packing, window splitting, program
ramp, queue depth and first-hit order, so both packages cut the same
programs and report the same hit per job.

Both drives take the JAX drive's block-guard pruning (``prune=True`` or
``QI_SWEEP_PRUNE``; ``sweep.py:118-220``, ``:549-613``): the enumeration
splits into blocks of 2^k windows sharing a high-bit prefix, one Q-side
greatest fixpoint per block on its maximal candidate (the guard,
:mod:`..kernels.guard_cuda`) proves the empty ones hit-free, and the drives
sweep only the surviving ranges.  Pruned blocks hold no hit, so the verdict,
witness and hit index are those of the unpruned sweep.  Unlike the JAX
drives, a guard that fails to build, launch or plan fails the solve: there
is no in-place degrade to the unpruned sweep (``sweep.py:615-647``,
``:1647-1656``).
"""

from __future__ import annotations

import bisect
import logging
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from quorum_intersection_tpu_torch.backends.base import (
    INT32_MAX,
    CancelToken,
    SccCheckResult,
    SearchCancelled,
)
from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.encode.circuit import (
    LANE_TILE,
    Circuit,
    PackedCircuit,
    bitset_supported,
    ladder_up,
    pack_circuits,
    pad_targets,
    plan_packs,
    restrict_circuit_pair,
)
from quorum_intersection_tpu_torch.fbas.graph import TrustGraph
from quorum_intersection_tpu_torch.fbas.semantics import max_quorum
from quorum_intersection_tpu_torch.kernels.guard_cuda import BlockGuard
from quorum_intersection_tpu_torch.kernels.packed_cuda import MAX_UNITS, PackedSweep
from quorum_intersection_tpu_torch.kernels.sweep_cuda import FusedSweep
from quorum_intersection_tpu_torch.kernels.sweep_ref import _round_up

log = logging.getLogger("quorum_intersection_tpu_torch.backends.sweep")

# Two-level enumeration: the low LO_BITS index bits decode on the device, the
# remaining high bits are a per-program constant availability row.
LO_BITS = 30
MAX_BITS = 44
# Programs in flight: the sweep waits only on the oldest one's result.
MAX_INFLIGHT = 32
# Sweep blocks per program, ramped up as the enumeration proves large: the
# first program stays small so a broken network's early hit comes back fast.
STEPS_RAMP = (1, 8, 64, 256, 1024)
RAMP_DISPATCHES = 1
# Prefer the largest level that still fills this many programs.
JUMP_PIPE_FILL = 8


# Packed drive: program sizes, in blocks.
PACK_RAMP = (1, 8, 64)
# The JAX drive's Pallas grid block: its bitset and pallas engines round the
# packed batch to whole blocks (plan_batch), so the port does too, engine
# for engine, and both packages cut the same programs.
PALLAS_BLOCK = 1024
# The JAX package's engine names → (packed kernel, whether the drive rounds
# the batch with plan_batch).  The card has two kernels; the names survive
# only so that programs and stats match the JAX drive's engine for engine.
ENGINES = {"xla": ("dense", False), "pallas": ("dense", True), "bitset": ("bitset", True)}


# Block-guard pruning (the JAX drive's constants, sweep.py:133-145).
# The single guard rule; a certificate checker rejects unknown ids.
PRUNE_RULE_ID = "empty-max-quorum"
# Below this enumeration width guard set-up costs more than sweeping.
PRUNE_MIN_BITS = 6
# At most 2^14 guard rows per enumeration, one per block.
PRUNE_MAX_PREFIX_BITS = 14
# Never shrink blocks below 2^2 windows.
PRUNE_MIN_BLOCK_BITS = 2


def fused_units(slot: int, groups: int, inner: int) -> int:
    """Units of the fused circuit ``pack_circuits`` builds from ``groups``
    lane groups of ``slot`` lanes holding ``inner`` inner units in all."""
    lanes = groups * slot
    return pad_targets(lanes, lanes + inner)[1]


def fit_units(jobs: Sequence[int], circuit_of: Callable[[int], Circuit]) -> List[List[int]]:
    """Split one planned pack, in its order, into packs whose fused circuit
    (one window per job) stays within the packed kernels' ``MAX_UNITS``.  A
    job whose circuit alone passes it is left out: it takes the unpacked
    sweep, whose kernel has no unit limit."""

    def fits(ixs: List[int]) -> bool:
        circuits = [circuit_of(x) for x in ixs]
        slot = ladder_up(max(max(c.n for c in circuits), 1))
        return fused_units(slot, len(ixs), sum(c.n_units - c.n for c in circuits)) <= MAX_UNITS

    packs: List[List[int]] = []
    for i in jobs:
        if packs and fits(packs[-1] + [i]):
            packs[-1].append(i)
        elif fits([i]):
            packs.append([i])
    return packs


class SccTooLargeError(ValueError):
    """Raised when the SCC exceeds the sweep's enumeration width."""


@dataclass
class _PrunePlan:
    """One enumeration's block-guard prune plan (the JAX ``_PrunePlan``):
    the pruned blocks as prefixes and as merged window runs, and the
    surviving ranges the drive sweeps.  The port also keeps the guard's
    encoding and the planning wall time; the guard's rows are
    ``guard_masks(n, bit_nodes, block_bits, log2(guard_rows))``."""

    block_bits: int                 # k: windows per block = 2^k
    prefixes: List[int]             # pruned block ids (>= the resume cut)
    windows: int                    # pruned window count = len(prefixes) << k
    ranges: List[Tuple[int, int]]   # surviving [lo, hi) over [start0, total)
    runs: List[Tuple[int, int]]     # merged pruned [lo, hi) window runs
    cum: List[int]                  # pruned windows before runs[i]
    run_los: List[int] = field(default_factory=list)
    guard_rows: int = 0
    encoding: str = "dense"
    seconds: float = 0.0

    @classmethod
    def build(
        cls,
        block_bits: int,
        prefixes: List[int],
        total: int,
        start0: int,
        guard_rows: int,
    ) -> "_PrunePlan":
        runs: List[Tuple[int, int]] = []
        for p in prefixes:  # ascending
            lo, hi = p << block_bits, (p + 1) << block_bits
            if runs and runs[-1][1] == lo:
                runs[-1] = (runs[-1][0], hi)
            else:
                runs.append((lo, hi))
        cum = [0]
        for lo, hi in runs:
            cum.append(cum[-1] + (hi - lo))
        ranges: List[Tuple[int, int]] = []
        pos = start0
        for lo, hi in runs:
            if lo > pos:
                ranges.append((pos, lo))
            pos = max(pos, hi)
        if pos < total:
            ranges.append((pos, total))
        return cls(
            block_bits=block_bits,
            prefixes=list(prefixes),
            windows=len(prefixes) << block_bits,
            ranges=ranges,
            runs=runs,
            cum=cum,
            run_los=[lo for lo, _ in runs],
            guard_rows=guard_rows,
        )

    def pruned_before(self, x: int) -> int:
        """Pruned windows with index < ``x``."""
        ix = bisect.bisect_right(self.run_los, x) - 1
        if ix < 0:
            return 0
        lo, hi = self.runs[ix]
        return self.cum[ix] + min(max(x - lo, 0), hi - lo)

    def overlap(self, lo: int, hi: int) -> int:
        """Pruned windows inside ``[lo, hi)``."""
        if hi <= lo:
            return 0
        return self.pruned_before(hi) - self.pruned_before(lo)

    def skip(self, pos: int) -> int:
        """Smallest surviving window index >= ``pos``."""
        ix = bisect.bisect_right(self.run_los, pos) - 1
        if ix >= 0 and pos < self.runs[ix][1]:
            return self.runs[ix][1]
        return pos


def guard_masks(n: int, bit_nodes: Sequence[int], block_bits: int, prefix_bits: int) -> np.ndarray:
    """``(2^prefix_bits, n)`` int8 maximal candidates, one per block: every
    free low-bit node (``bit_nodes[:block_bits]``) plus the prefix's
    fixed-one nodes (bit j of block b toggles ``bit_nodes[block_bits + j]``).
    The fixed node ``scc[0]`` is in no ``bit_nodes`` and so in no mask."""
    cols = np.asarray(bit_nodes, dtype=np.int64)
    n_blocks = 1 << prefix_bits
    masks = np.zeros((n_blocks, n), dtype=np.int8)
    masks[:, cols[:block_bits]] = 1
    pref = np.arange(n_blocks, dtype=np.int64)
    masks[:, cols[block_bits:]] = (
        (pref[:, None] >> np.arange(prefix_bits, dtype=np.int64)[None, :]) & 1
    ).astype(np.int8)
    return masks


def plan_batch(batch: int) -> int:
    """The batch the JAX ``pallas_sweep.plan_batch`` makes of ``batch``: a
    whole number of grid blocks of :data:`PALLAS_BLOCK` rows, or of one
    block rounded up to 32 rows below that."""
    block = PALLAS_BLOCK if batch >= PALLAS_BLOCK else _round_up(max(batch, 1), 32)
    return _round_up(batch, block)


@dataclass(frozen=True)
class EngineResolution:
    """Which engine a packed sweep runs, and why, by the JAX package's
    names (:data:`ENGINES` maps them to the kernel)."""

    requested: str
    resolved: str
    reason: str

    @property
    def kernel(self) -> str:
        return ENGINES[self.resolved][0]


def resolve_engine(requested: str, circuit: Circuit) -> EngineResolution:
    """``xla`` and ``pallas`` always run as requested (the dense kernel
    takes any vote multiplicity); ``bitset`` runs where the votes are 0/1,
    else ``xla`` with the JAX ``resolve_engine``'s reason."""
    if requested == "bitset" and not bitset_supported(circuit):
        return EngineResolution(
            requested, "xla",
            "qset multiplicities exceed 1: the bitset encoding holds one bit per member",
        )
    return EngineResolution(requested, requested, "as requested")


def _jump_target_ix(ramp, ix: int, base_block: int, remaining: int) -> int:
    """Largest ramp index above ``ix`` the remaining work can fill (the JAX
    backend's rule: PIPE-many programs, or twice one program off level 0)."""
    best = ix
    for j in range(ix + 1, len(ramp)):
        if remaining >= ramp[j] * base_block * JUMP_PIPE_FILL:
            best = j
    if best == ix and ix == 0:
        for j in range(ix + 1, len(ramp)):
            if remaining >= ramp[j] * base_block * 2:
                best = j
    return best


def clamp_batch_to_index_ceiling(batch: int, lo_total: int) -> int:
    """Index ceiling: the largest index a program touches is ``lo_total +
    STEPS_RAMP[-1]·base_block`` (chunk-tail overshoot decodes as in-chunk
    aliases, but only while it stays below 2^31).  Clamp batches that would
    cross it."""
    max_block = max(1, ((1 << 31) - lo_total) // STEPS_RAMP[-1])
    if batch > max_block:
        log.warning(
            "batch %d would cross the 2^31 index ceiling; clamping to %d", batch, max_block
        )
        return max_block
    return batch


def _auto_batch(n: int) -> int:
    """Candidates per sweep block: 2^19 for circuits up to 128 nodes, fewer
    for wider ones (the JAX backend's sizing, kept so both packages cut the
    enumeration into the same programs)."""
    lanes = 128 * ((max(n, 1) + 127) // 128)
    return min(1 << 19, max(1 << 15, (1 << 26) // lanes))


class _Pending:
    """One program's result.  On the card: the kernel's output copied to
    pinned host memory behind an event, so draining the oldest program waits
    for that program alone.  On the CPU: a deferred call, so programs behind
    a hit are never computed."""

    __slots__ = ("_event", "_host", "_thunk")

    def __init__(self, event=None, host=None, thunk: Optional[Callable[[], torch.Tensor]] = None):
        self._event, self._host, self._thunk = event, host, thunk

    @classmethod
    def launch(cls, device: torch.device, program: Callable[[], torch.Tensor]) -> "_Pending":
        if device.type == "cpu":
            return cls(thunk=program)
        out = program()
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return cls(event=event, host=host)

    def result(self) -> torch.Tensor:
        if self._thunk is not None:
            return self._thunk()
        self._event.synchronize()
        return self._host


@dataclass
class _SweepJob:
    """One sweep problem prepared for lane packing: SCC-restricted circuit
    pair plus the graph-space decode data for the witness recheck."""

    graph: TrustGraph
    nodes: List[int]  # graph-space scc ids (enumeration order)
    scope_to_scc: bool
    circuit: Circuit  # scoped (Q-side) restriction
    circuit_d: Optional[Circuit]  # Q6 fold for the D probe (None: scoped)
    bits: int
    total: int
    candidates: int = 0
    # Windows of later windows a lower window's hit retired (pack fill).
    skipped: int = 0
    first_hit: Optional[int] = None
    result: Optional[SccCheckResult] = None
    # A per-job cancel retired the job's lane groups mid-pack.
    cancelled: bool = False


@dataclass
class _PackGroup:
    """One lane group: a contiguous candidate window ``[lo, hi)`` of one
    job.  Extra groups (spare pack lanes) split a job into ascending
    windows, and the job's first hit is the first hit of the LOWEST window
    whose every predecessor swept clean — the unpacked FIFO order."""

    job: int
    lo: int
    hi: int
    hit: Optional[int] = None
    done: bool = False


@dataclass
class PackPlan:
    """One pack as the drive runs it: its lane groups with each group's own
    ``(scoped, Q6)`` circuit pair, the fused circuit, the decode tables, the
    base batch, the engine and each job's prune plan (None: unpruned)."""

    groups: List[_PackGroup]
    group_circuits: List[Tuple[Circuit, Optional[Circuit]]]
    packed: PackedCircuit
    tables: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
    batch: int
    resolution: EngineResolution
    prune_plans: List[Optional[_PrunePlan]]


class GpuSweepBackend:
    """Exhaustive subset sweep over the quorum-bearing SCC, through the
    fused CUDA kernel (or its plain version on ``device="cpu"``).

    ``prune`` switches block-guard pruning on both drives; None reads
    ``QI_SWEEP_PRUNE`` as the JAX backend does (empty or ``"0"``: off,
    anything else: on).  Where a prune plan ran, the result's stats carry
    the JAX ledger term ``windows_pruned_guard``, and where it pruned
    something also ``pruned_blocks`` (``{"k", "rule", "prefixes"}``), at the
    top level: the JAX backend keeps both under ``stats["cert"]``, a ledger
    the port has not yet.  ``guard_rows`` and ``guard_seconds`` (planning
    wall time) ride beside them.  Every packed job's stats carry
    ``windows_skipped_pack_fill``.  On a ``true`` verdict
    ``candidates_checked + windows_pruned_guard (+ windows_skipped_pack_fill)
    == enumeration_total``.
    """

    name = "gpu-sweep"
    needs_circuit = True

    # The JAX package's capability flag: check_sccs takes per-job cancel
    # tokens, and a pack retires one job's lane groups on its own token while
    # the co-packed jobs keep sweeping.
    supports_job_cancels = True

    def __init__(
        self,
        batch: Optional[int] = None,
        lo_bits: int = LO_BITS,
        cancel: Optional[CancelToken] = None,
        device: DeviceLike = None,
        engine: Optional[str] = None,
        prune: Optional[bool] = None,
    ) -> None:
        if lo_bits > LO_BITS:
            raise ValueError(f"lo_bits={lo_bits} exceeds the index ceiling {LO_BITS}")
        # The packed drive's engine, by the JAX package's names (ENGINES;
        # None is "xla").  The unpacked drive always runs the fused kernel.
        if engine is not None and engine not in ENGINES:
            raise ValueError(f"unknown sweep engine {engine!r}")
        self.batch = batch  # None ⇒ _auto_batch(circuit.n) at check time
        self.lo_bits = lo_bits
        self.cancel = cancel
        self.device = resolve_device(device)
        self.engine = engine or "xla"
        self.prune = prune
        # The packs the last check_sccs call ran, in order (stats carry
        # each job's ``pack_index`` into this list).
        self.pack_plans: List[PackPlan] = []

    def _prune_enabled(self) -> bool:
        if self.prune is not None:
            return self.prune
        return os.environ.get("QI_SWEEP_PRUNE", "").strip() not in ("", "0")

    def _plan_pruning(
        self,
        circuit: Circuit,
        bit_nodes: np.ndarray,
        bits: int,
        total: int,
        start0: int,
        engine: str,
    ) -> Optional[_PrunePlan]:
        """Run the block guards of one enumeration (the JAX
        ``_plan_pruning``); None below the pruning width.

        ``bit_nodes[j]`` is the circuit node enumeration bit j toggles;
        ``engine`` names the guard by the JAX engine names (``bitset``: the
        bitset guard, else the dense one).  ``start0`` is a resume cut:
        blocks not wholly at or above it stay unpruned.  Any failure of the
        guard propagates: the solve fails, it does not sweep unpruned."""
        if bits < PRUNE_MIN_BITS:
            return None
        prefix_bits = min(PRUNE_MAX_PREFIX_BITS, bits - PRUNE_MIN_BLOCK_BITS)
        if prefix_bits <= 0:
            return None
        t0 = time.perf_counter()
        k = bits - prefix_bits
        masks = guard_masks(circuit.n, bit_nodes, k, prefix_bits)
        encoding = ENGINES[engine][0]
        prunable = BlockGuard(circuit, encoding, self.device).counts(masks) == 0
        prunable[: (start0 + (1 << k) - 1) >> k] = False
        plan = _PrunePlan.build(k, np.nonzero(prunable)[0].tolist(), total, start0, len(masks))
        plan.encoding = encoding
        plan.seconds = time.perf_counter() - t0
        return plan

    @staticmethod
    def _prune_stats(plan: Optional[_PrunePlan]) -> Dict[str, object]:
        """The plan's stats terms (none without a plan)."""
        if plan is None:
            return {}
        stats: Dict[str, object] = {
            "windows_pruned_guard": plan.windows,
            "guard_rows": plan.guard_rows,
            "guard_seconds": plan.seconds,
        }
        if plan.windows:
            stats["pruned_blocks"] = {
                "k": plan.block_bits, "rule": PRUNE_RULE_ID, "prefixes": list(plan.prefixes),
            }
        return stats

    @staticmethod
    def _witness(
        graph: TrustGraph, scc: List[int], subset: List[int], scope_to_scc: bool
    ) -> Tuple[List[int], List[int]]:
        """Recompute (Q, disjoint) for one hit candidate with the exact host
        semantics (two fixpoints on one candidate)."""
        avail = [False] * graph.n
        for v in subset:
            avail[v] = True
        q = max_quorum(graph, subset, avail)
        if scope_to_scc:
            avail = [False] * graph.n
            for v in scc:
                avail[v] = True
        else:
            avail = [True] * graph.n  # Q6 whole-graph availability
        for v in q:
            avail[v] = False
        disjoint = max_quorum(graph, scc, avail)
        return q, disjoint

    def _check_cancel(self, where: str) -> None:
        if self.cancel is not None and self.cancel.cancelled:
            raise SearchCancelled(f"sweep cancelled {where}")

    def check_scc(
        self,
        graph: TrustGraph,
        circuit: Optional[Circuit],
        scc: List[int],
        *,
        scope_to_scc: bool = False,
    ) -> SccCheckResult:
        if circuit is None:
            raise ValueError("sweep backend requires the encoded circuit")
        scc = list(scc)
        s = len(scc)
        bits = s - 1
        if bits > MAX_BITS:
            raise SccTooLargeError(f"|scc|={s} exceeds sweep width {MAX_BITS}+1")
        self._check_cancel(f"before setup (|scc|={s})")
        t0 = time.perf_counter()

        # SCC restriction: project onto the SCC's columns and fold the
        # constant outside availability into thresholds — the scoped fold
        # drives the Q side, the Q6 fold the D probe.  `nodes` keeps the
        # graph-space ids for the witness.
        nodes = list(scc)
        circuit_d = None
        restricted = circuit.n > s
        if restricted:
            scoped_c, q6_c = restrict_circuit_pair(circuit, scc)
            circuit = scoped_c
            if not scope_to_scc:
                circuit_d = q6_c
            scc = list(range(s))
        n = circuit.n
        scc_mask = np.zeros(n, dtype=np.int32)
        scc_mask[scc] = 1
        frozen = None
        if not scope_to_scc and not restricted:
            frozen = 1 - scc_mask

        # Two-level decode: bit j < lo_bits toggles lo_nodes[j] in the
        # kernel; bit j >= lo_bits toggles hi_nodes[j - lo_bits] through the
        # program's constant hi row.
        lo_bits = min(bits, self.lo_bits)
        lo_total = 1 << lo_bits if lo_bits > 0 else 1
        hi_nodes = scc[1 + lo_bits:]
        lo_nodes = np.asarray(scc[1:1 + lo_bits], dtype=np.int32)
        total = 1 << bits if bits > 0 else 1

        # Block-guard pruning: narrow enumerations only (the wide decode's
        # hi row speaks no non-contiguous work), on the scoped circuit.
        # Planned before the batch: when blocks pruned, the base program
        # shrinks toward the block size so a surviving fragment never burns
        # a full-size program.
        plan = None
        if self._prune_enabled() and not hi_nodes:
            plan = self._plan_pruning(circuit, np.asarray(scc[1:]), bits, total, 0, "xla")
        ranges = plan.ranges if plan is not None else [(0, total)]
        # Surviving work at and after each range: every ramp decision reads
        # the remaining surviving work, not the raw index distance.
        range_suffix = [0] * (len(ranges) + 1)
        for rix in range(len(ranges) - 1, -1, -1):
            range_suffix[rix] = range_suffix[rix + 1] + ranges[rix][1] - ranges[rix][0]

        batch = self.batch if self.batch is not None else _auto_batch(n)
        batch = clamp_batch_to_index_ceiling(batch, lo_total)
        if plan is not None and plan.windows:
            # The JAX drive's alignment with the prune granularity (floor
            # 512 rows): a fragment costs at most one base-size program.
            batch = min(batch, max(1 << plan.block_bits, 512))
        if hi_nodes:
            # Power-of-two blocks make chunk tails exact.
            batch = 1 << (min(batch, lo_total).bit_length() - 1)
        base_block = min(batch, max(lo_total, 1))
        sweep = FusedSweep(
            circuit, lo_nodes, scc_mask, frozen, base_block,
            circuit_d=circuit_d, device=self.device,
        )

        def hi_row(hi: int) -> int:
            return sum(1 << v for j, v in enumerate(hi_nodes) if (hi >> j) & 1)

        steps = candidates = 0
        found = False
        first_hit = 0
        inflight: deque = deque()

        def drain_one() -> bool:
            """Wait for the oldest program; True iff it hit."""
            nonlocal steps, candidates, first_hit, found
            start, coverage, hi_base, pending = inflight.popleft()
            hit = int(pending.result())
            steps += 1
            candidates += min(coverage, total - start)
            if hit < INT32_MAX:
                found = True
                # A chunk-tail program may report an aliased index; decode is
                # periodic in 2^lo_bits, so masking recovers the position.
                first_hit = (hi_base << lo_bits) | (hit & (lo_total - 1))
                return True
            return False

        seg_ix = 0
        start = ranges[0][0] if ranges else total
        ramp_ix = 0
        since_ramp = 0

        def remaining_work() -> int:
            """Surviving windows not yet dispatched."""
            return range_suffix[seg_ix] - (start - ranges[seg_ix][0])

        while seg_ix < len(ranges):
            cur_hi = ranges[seg_ix][1]
            if start >= cur_hi:
                # Range exhausted: hop over the pruned gap to the next one.
                seg_ix += 1
                if seg_ix < len(ranges):
                    start = ranges[seg_ix][0]
                continue
            self._check_cancel(f"at candidate {start}/{total}")
            if since_ramp >= RAMP_DISPATCHES:
                target = _jump_target_ix(STEPS_RAMP, ramp_ix, base_block, remaining_work())
                if target != ramp_ix:
                    ramp_ix, since_ramp = target, 0
            hi, lo = start >> lo_bits, start & (lo_total - 1)
            spc = STEPS_RAMP[ramp_ix]
            coverage = spc * base_block
            boundary = min(lo_total - lo, cur_hi - start)
            if coverage > boundary:
                # Segment tail (the decode chunk or the surviving range): the
                # smallest program that covers the remainder, advancing only
                # to the boundary.  Overshoot rows are chunk aliases or lie in
                # a guard-pruned gap, which holds no hit.
                spc = next(r for r in STEPS_RAMP if r * base_block >= boundary)
                coverage = boundary
            program = lambda lo=lo, spc=spc, row=hi_row(hi): sweep.program(lo, spc, row)  # noqa: E731
            inflight.append((start, coverage, hi, _Pending.launch(self.device, program)))
            since_ramp += 1
            start += coverage
            if len(inflight) >= MAX_INFLIGHT and drain_one():
                break
        while not found and inflight:
            self._check_cancel(f"while draining at {candidates}/{total}")
            if drain_one():
                break

        seconds = time.perf_counter() - t0
        stats = {
            "backend": self.name,
            "device": str(self.device),
            "candidates_checked": candidates,
            "device_steps": steps,
            "enumeration_total": total,
            "seconds": seconds,
            "candidates_per_sec": candidates / seconds if seconds > 0 else 0.0,
            **self._prune_stats(plan),
        }
        if not found:
            return SccCheckResult(intersects=True, stats=stats)

        subset = [nodes[1 + j] for j in range(bits) if (first_hit >> j) & 1]
        q, disjoint = self._witness(graph, nodes, subset, scope_to_scc)
        if not q or not disjoint:
            # The host recheck uses the exact reference semantics: an empty
            # member here means the device decode lied — fail loudly, never
            # flip the verdict.
            raise RuntimeError(
                f"sweep decode error: device hit index {first_hit} failed the "
                f"host witness recheck (|q|={len(q)}, |disjoint|={len(disjoint)})"
            )
        stats["hit_index"] = first_hit
        # Reference witness convention (cpp:372-373): q1 = the probe result,
        # q2 = the enumerated quorum.
        return SccCheckResult(intersects=False, q1=disjoint, q2=q, stats=stats)

    # ---- lane-packed multi-problem sweep ---------------------------------

    def _prepare_job(
        self,
        graph: TrustGraph,
        circuit: Optional[Circuit],
        scc: List[int],
        scope_to_scc: bool,
    ) -> _SweepJob:
        """Restrict one problem onto its SCC for packing.  Restriction runs
        unconditionally (even at circuit.n == |scc|): it guarantees the
        root-unit layout and scc-order lanes pack_circuits requires, and
        folds all outside availability into thresholds."""
        if circuit is None:
            raise ValueError("sweep backend requires the encoded circuit")
        scc = list(scc)
        bits = len(scc) - 1
        if bits > MAX_BITS:
            raise SccTooLargeError(f"|scc|={len(scc)} exceeds sweep width {MAX_BITS}+1")
        scoped_c, q6_c = restrict_circuit_pair(circuit, scc)
        return _SweepJob(
            graph=graph,
            nodes=scc,
            scope_to_scc=scope_to_scc,
            circuit=scoped_c,
            circuit_d=None if scope_to_scc else q6_c,
            bits=bits,
            total=1 << bits if bits > 0 else 1,
        )

    def check_sccs(
        self,
        jobs: Sequence[Tuple[TrustGraph, Optional[Circuit], List[int]]],
        *,
        scope_to_scc: bool = False,
        cancels: Optional[Sequence[Optional[CancelToken]]] = None,
    ) -> List[SccCheckResult]:
        """Batched multi-problem sweep with LANE PACKING: up to 16
        independent problems fuse into one block-diagonal circuit of at most
        128 lanes (encode.pack_circuits), so one program resolves them all.
        Spare lanes take extra ascending windows of the packed jobs' own
        enumerations.  Verdict, witness and first-hit index are those of
        :meth:`check_scc` per job.

        Wide (> 2^lo_bits) enumerations stay on the unpacked sweep, and so
        does a job whose restricted circuit alone passes the packed kernels'
        ``MAX_UNITS``; a pack whose jobs' units add up past it splits in
        order (:func:`fit_units`).  Unlike the JAX drive, which counts lanes
        only, the port's packs and window splits keep the fused circuit
        within ``MAX_UNITS``, so its pack statistics may differ there.
        ``cancels`` is job-aligned: a tripped token retires that job alone
        (a ``cancelled`` result, no verdict); a job already cancelled never
        takes lanes.
        """
        jobs = list(jobs)
        results: List[Optional[SccCheckResult]] = [None] * len(jobs)
        if self.cancel is not None and self.cancel.cancelled:
            raise SearchCancelled(f"packed sweep cancelled before setup ({len(jobs)} jobs)")

        def token(i: int) -> Optional[CancelToken]:
            return cancels[i] if cancels is not None else None

        self.pack_plans = []
        prepared: Dict[int, _SweepJob] = {}
        for i, (graph, circuit, scc) in enumerate(jobs):
            if len(scc) - 1 > min(self.lo_bits, LO_BITS):
                continue  # wide two-level enumerations stay unpacked
            tok = token(i)
            if tok is not None and tok.cancelled:
                continue  # already dead: never let it occupy lanes
            prepared[i] = self._prepare_job(graph, circuit, scc, scope_to_scc)
        for members in self.pack_members(prepared):
            self._run_pack([prepared[i] for i in members], [token(i) for i in members])
            for i in members:
                results[i] = prepared[i].result
        for i, (graph, circuit, scc) in enumerate(jobs):
            if results[i] is not None:
                continue
            tok = token(i)
            if tok is not None and tok.cancelled:
                results[i] = self._cancelled_result(scc)
            else:
                results[i] = self.check_scc(graph, circuit, scc, scope_to_scc=scope_to_scc)
        return [res for res in results if res is not None]

    @staticmethod
    def pack_members(prepared: Dict[int, _SweepJob]) -> List[List[int]]:
        """The packs :meth:`check_sccs` runs, as job indices: the JAX lane
        plan (``plan_packs``), each pack split by :func:`fit_units`."""
        packable = list(prepared)
        return [members for pack_ixs in plan_packs([prepared[i].circuit.n for i in packable])
                for members in fit_units([packable[ix] for ix in pack_ixs], lambda i: prepared[i].circuit)]

    def _cancelled_result(self, scc: Sequence[int]) -> SccCheckResult:
        """A per-job-cancelled job's result: no verdict claim."""
        return SccCheckResult(intersects=False, stats={
            "backend": self.name,
            "cancelled": True,
            "candidates_checked": 0,
            "enumeration_total": 1 << max(len(scc) - 1, 0),
        })

    def plan_pack(self, jobs: List[_SweepJob]) -> PackPlan:
        """Lay one pack out: each job's prune plan on its own restricted
        circuit, then spare lanes become extra windows of the jobs with the
        largest per-window enumerations (never split below about two blocks
        per window), then the fused circuit, the base batch and the engine
        — the JAX ``_run_pack`` set-up (``sweep.py:1622-1758``)."""
        n_jobs = len(jobs)
        prune_plans: List[Optional[_PrunePlan]] = [None] * n_jobs
        if self._prune_enabled():
            for jix, job in enumerate(jobs):
                # The guard speaks the pack's encoding, resolved per member
                # circuit (a multi-edge member takes the dense guard).
                guard_engine = "xla"
                if self.engine == "bitset":
                    guard_engine = resolve_engine("bitset", job.circuit).resolved
                prune_plans[jix] = self._plan_pruning(
                    job.circuit, np.arange(1, job.circuit.n), job.bits, job.total, 0, guard_engine
                )
        slot = ladder_up(max(j.circuit.n for j in jobs))
        capacity = max(1, LANE_TILE // slot)
        est_batch = self.batch if self.batch is not None else _auto_batch(capacity * slot)
        windows = [1] * n_jobs
        spare = capacity - n_jobs
        inner = [j.circuit.n_units - j.circuit.n for j in jobs]
        while spare > 0:
            j = max(range(n_jobs), key=lambda x: jobs[x].total / windows[x])
            if jobs[j].total / windows[j] < 2 * est_batch:
                break
            # Every window copies the job's circuit: stop before the fused
            # circuit passes the packed kernels' unit limit.
            grown = sum(w * i for w, i in zip(windows, inner)) + inner[j]
            if fused_units(slot, sum(windows) + 1, grown) > MAX_UNITS:
                break
            windows[j] += 1
            spare -= 1

        groups: List[_PackGroup] = []
        members: List[Tuple[Circuit, Optional[Circuit]]] = []
        for j, job in enumerate(jobs):
            w = windows[j]
            bounds = [job.total * t // w for t in range(w + 1)]
            for t in range(w):
                groups.append(_PackGroup(job=j, lo=bounds[t], hi=bounds[t + 1]))
                members.append((job.circuit, job.circuit_d))
        packed = pack_circuits(members)

        batch = self.batch if self.batch is not None else _auto_batch(packed.circuit.n)
        # Never dispatch blocks beyond the largest window's work.
        batch = max(1, min(batch, max(g.hi - g.lo for g in groups)))
        batch = clamp_batch_to_index_ceiling(batch, max(j.total for j in jobs))
        live = [p for p in prune_plans if p is not None and p.windows]
        if live:
            # The unpacked drive's alignment, at the smallest live block.
            batch = min(batch, max(1 << min(p.block_bits for p in live), 512))
        resolution = resolve_engine(self.engine, packed.circuit)
        if resolution.resolved != resolution.requested:
            log.info(
                "sweep engine %r resolved to %r: %s",
                resolution.requested, resolution.resolved, resolution.reason,
            )
        if ENGINES[resolution.resolved][1]:
            batch = plan_batch(batch)
        return PackPlan(groups, members, packed, packed.decode_tables(), batch, resolution, prune_plans)

    def _run_pack(
        self,
        jobs: List[_SweepJob],
        cancels: Sequence[Optional[CancelToken]],
    ) -> None:
        """Sweep one pack of jobs to verdicts (stored on each job).

        All groups advance in lockstep by each program's coverage; a group
        that is done keeps its stale start in the snapshot and the drain
        ignores it.  Hits at or above a group's ``hi`` are overshoot aliases
        (the next ascending window sweeps those candidates itself) and are
        masked here on the host.  Under pruning a group's next start hops
        over pruned runs; pruned windows inside a lockstep program are still
        evaluated (they cannot hit) but never counted as checked."""
        t0 = time.perf_counter()
        n_jobs = len(jobs)
        plan = self.plan_pack(jobs)
        self.pack_plans.append(plan)
        groups, packed, batch = plan.groups, plan.packed, plan.batch
        sweep = PackedSweep(
            packed.circuit, packed.circuit_d, *plan.tables, batch,
            engine=plan.resolution.kernel, device=self.device,
        )
        log.debug(
            "packed sweep: %d jobs in %d lane groups (slot %d, %d lanes, %.1f%% fill, engine %s)",
            n_jobs, packed.groups, packed.slot, packed.circuit.n, packed.fill_pct,
            plan.resolution.resolved,
        )

        prune_plans = plan.prune_plans
        unresolved = set(range(n_jobs))
        nxt = [g.lo for g in groups]
        # Per-group drained high-water mark, for the pack-fill skip count.
        drained_to = [g.lo for g in groups]

        def pruned_in(job_ix: int, lo: int, hi: int) -> int:
            p = prune_plans[job_ix]
            return p.overlap(lo, hi) if p is not None else 0

        for gix, g in enumerate(groups):
            p = prune_plans[g.job]
            if p is not None:
                nxt[gix] = p.skip(nxt[gix])
                if nxt[gix] >= g.hi:
                    g.done = True  # the whole window is guard-pruned
        inflight: deque = deque()
        pack_rows = 0
        spc_ix = 0
        used_spc: set = set()
        depth_cap = max(1, min(MAX_INFLIGHT, 8))

        def check_cancel() -> None:
            if self.cancel is not None and self.cancel.cancelled:
                raise SearchCancelled(
                    f"packed sweep cancelled ({len(unresolved)} of {n_jobs} jobs unresolved)"
                )

        def retire_job(j: int) -> None:
            """THIS job's request died: freeze its lane groups (in-flight
            programs still carry them, the drain ignores them); co-packed
            jobs keep sweeping."""
            for g in groups:
                if g.job == j:
                    g.done = True
            jobs[j].cancelled = True
            unresolved.discard(j)

        def check_job_cancels() -> None:
            for j in list(unresolved):
                tok = cancels[j]
                if tok is not None and tok.cancelled:
                    retire_job(j)

        def all_dispatched() -> bool:
            return all(g.done or nxt[i] >= g.hi for i, g in enumerate(groups))

        def resolve_jobs() -> None:
            """A job's first hit is the hit of its lowest window whose every
            predecessor swept clean — the unpacked FIFO order, group-wise."""
            for j in list(unresolved):
                wins = [g for g in groups if g.job == j]
                decided = True  # every window swept clean: intersects
                for g in wins:
                    if g.hit is not None:
                        jobs[j].first_hit = g.hit
                        break
                    if not g.done:
                        decided = False
                        break
                if not decided:
                    continue
                unresolved.discard(j)
                for g in wins:
                    g.done = True

        def drain_one() -> None:
            starts_snap, coverage, pending = inflight.popleft()
            hits = pending.result().numpy()
            for gix, g in enumerate(groups):
                if g.done:
                    continue
                s0 = int(starts_snap[gix])
                if s0 >= g.hi:
                    continue  # frozen lane: nothing new covered
                top = min(s0 + coverage, g.hi)
                jobs[g.job].candidates += (top - s0) - pruned_in(g.job, s0, top)
                drained_to[gix] = max(drained_to[gix], top)
                h = int(hits[gix])
                if h < g.hi:
                    g.hit = h
                    g.done = True
                    # Later windows of the same job can only yield larger
                    # indices: stop burning lanes on them, and count their
                    # unswept surviving windows as skipped.
                    for g2ix, g2 in enumerate(groups):
                        if g2.job == g.job and g2.lo > g.lo and not g2.done:
                            left = max(g2.hi - drained_to[g2ix], 0)
                            jobs[g.job].skipped += max(
                                left - pruned_in(g.job, drained_to[g2ix], g2.hi), 0
                            )
                            g2.done = True
                elif top >= g.hi or pruned_in(g.job, top, g.hi) == g.hi - top:
                    # Fully drained, or only guard-pruned tail is left.
                    g.done = True
            resolve_jobs()

        # A job whose every window was guard-pruned resolves before any
        # dispatch: pruned blocks hold no hit.
        resolve_jobs()

        while unresolved:
            check_cancel()
            check_job_cancels()
            if not unresolved:
                break
            if not all_dispatched():
                rem = max((g.hi - nxt[i] for i, g in enumerate(groups) if not g.done), default=0)
                while spc_ix + 1 < len(PACK_RAMP) and rem >= PACK_RAMP[spc_ix + 1] * batch * 2:
                    spc_ix += 1
                spc = PACK_RAMP[spc_ix]
                if rem < spc * batch:
                    # Tail: the smallest program covering the remainder,
                    # preferring a size already dispatched (the JAX drive's
                    # compiled-shape rule, kept so both cut the same programs).
                    fits = [r for r in PACK_RAMP if r * batch >= rem]
                    seen = [r for r in fits if r in used_spc]
                    spc = min(seen) if seen else min(fits)
                used_spc.add(spc)
                coverage = spc * batch
                snap = np.asarray(nxt, dtype=np.int32)
                program = lambda snap=snap, spc=spc: sweep.program(snap, spc)  # noqa: E731
                inflight.append((snap, coverage, _Pending.launch(self.device, program)))
                pack_rows += coverage
                for i, g in enumerate(groups):
                    if not g.done and nxt[i] < g.hi:
                        nxt[i] += coverage
                        p = prune_plans[g.job]
                        if p is not None and nxt[i] < g.hi:
                            nxt[i] = p.skip(nxt[i])  # hop over a pruned run
                if len(inflight) >= depth_cap:
                    drain_one()
            elif inflight:
                drain_one()
            else:
                # Every group drained yet a job is unresolved would mean the
                # accounting above lied: fail loudly, never spin.
                raise RuntimeError(
                    f"packed sweep drained all lane groups with {len(unresolved)} job(s) unresolved"
                )

        seconds = time.perf_counter() - t0
        pack_stats = {
            "packed": True,
            "pack_index": len(self.pack_plans) - 1,
            "pack_jobs": n_jobs,
            "pack_groups": packed.groups,
            "pack_slot": packed.slot,
            "pack_shape": [packed.circuit.n, packed.circuit.n_units],
            "pack_fill_pct": round(packed.fill_pct, 2),
            "pack_rows_dispatched": pack_rows,
            "pack_engine": plan.resolution.resolved,
            "pack_seconds": round(seconds, 4),
        }
        for jix, job in enumerate(jobs):
            stats = {
                "backend": self.name,
                "device": str(self.device),
                "candidates_checked": job.candidates,
                "enumeration_total": job.total,
                "seconds": seconds,
                "windows_skipped_pack_fill": job.skipped,
                **pack_stats,
                **self._prune_stats(prune_plans[jix]),
            }
            if job.cancelled:
                stats["cancelled"] = True
                job.result = SccCheckResult(intersects=False, stats=stats)
                continue
            if job.first_hit is None:
                job.result = SccCheckResult(intersects=True, stats=stats)
                continue
            subset = [job.nodes[1 + b] for b in range(job.bits) if (job.first_hit >> b) & 1]
            q, disjoint = self._witness(job.graph, job.nodes, subset, job.scope_to_scc)
            if not q or not disjoint:
                # The host recheck uses the exact reference semantics: an
                # empty member means the packed decode lied — fail loudly.
                raise RuntimeError(
                    f"packed sweep decode error: hit index {job.first_hit} failed the "
                    f"host witness recheck (|q|={len(q)}, |disjoint|={len(disjoint)})"
                )
            stats["hit_index"] = job.first_hit
            job.result = SccCheckResult(intersects=False, q1=disjoint, q2=q, stats=stats)
