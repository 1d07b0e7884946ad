"""Exhaustive batched candidate sweep over the quorum-bearing SCC, on the card.

A lean port of the JAX package's ``TpuSweepBackend.check_scc``
(``backends/tpu/sweep.py:705-1453``).  **Verdict equivalence**: two disjoint
quorums exist inside the SCC iff some subset ``S ⊆ scc ∖ {scc[0]}`` has
``Q := maxQuorum(S) ≠ ∅`` and ``maxQuorum(scc ∖ Q) ≠ ∅`` (proof in the JAX
module's docstring), so the sweep enumerates the 2^(|scc|-1) subsets.

What it keeps: SCC restriction with the Q6 fold for the D probe, the narrow
decode and the two-level wide decode (low ``lo_bits`` index bits decode in
the kernel, the rest ride a per-program hi row), the ``STEPS_RAMP`` program
sizes, a FIFO of up to ``MAX_INFLIGHT`` asynchronous programs drained
oldest-first, the cancel check, and the host witness recheck.  The witness
is the globally smallest hit index, exactly as in the JAX package: programs
drain in index order and each reports its own minimum.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from quorum_intersection_tpu_torch.backends.base import (
    INT32_MAX,
    CancelToken,
    SccCheckResult,
    SearchCancelled,
)
from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.encode.circuit import Circuit, restrict_circuit_pair
from quorum_intersection_tpu_torch.fbas.graph import TrustGraph
from quorum_intersection_tpu_torch.fbas.semantics import max_quorum
from quorum_intersection_tpu_torch.kernels.sweep_cuda import FusedSweep

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


class SccTooLargeError(ValueError):
    """Raised when the SCC exceeds the sweep's enumeration width."""


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
    def launch(cls, sweep: FusedSweep, start: int, steps: int, hi_mask: int) -> "_Pending":
        if sweep.device.type == "cpu":
            return cls(thunk=lambda: sweep.program(start, steps, hi_mask))
        out = sweep.program(start, steps, hi_mask)
        host = torch.empty((), dtype=torch.int32, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return cls(event=event, host=host)

    def result(self) -> int:
        if self._thunk is not None:
            return int(self._thunk())
        self._event.synchronize()
        return int(self._host)


class GpuSweepBackend:
    """Exhaustive subset sweep over the quorum-bearing SCC, through the
    fused CUDA kernel (or its plain version on ``device="cpu"``)."""

    name = "gpu-sweep"
    needs_circuit = True

    def __init__(
        self,
        batch: Optional[int] = None,
        lo_bits: int = LO_BITS,
        cancel: Optional[CancelToken] = None,
        device: DeviceLike = None,
    ) -> None:
        if lo_bits > LO_BITS:
            raise ValueError(f"lo_bits={lo_bits} exceeds the index ceiling {LO_BITS}")
        self.batch = batch  # None ⇒ _auto_batch(circuit.n) at check time
        self.lo_bits = lo_bits
        self.cancel = cancel
        self.device = resolve_device(device)

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

        batch = self.batch if self.batch is not None else _auto_batch(n)
        batch = clamp_batch_to_index_ceiling(batch, lo_total)
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
            hit = pending.result()
            steps += 1
            candidates += min(coverage, total - start)
            if hit < INT32_MAX:
                found = True
                # A chunk-tail program may report an aliased index; decode is
                # periodic in 2^lo_bits, so masking recovers the position.
                first_hit = (hi_base << lo_bits) | (hit & (lo_total - 1))
                return True
            return False

        start = 0
        ramp_ix = 0
        since_ramp = 0
        while start < total:
            self._check_cancel(f"at candidate {start}/{total}")
            if since_ramp >= RAMP_DISPATCHES:
                target = _jump_target_ix(STEPS_RAMP, ramp_ix, base_block, total - start)
                if target != ramp_ix:
                    ramp_ix, since_ramp = target, 0
            hi, lo = start >> lo_bits, start & (lo_total - 1)
            spc = STEPS_RAMP[ramp_ix]
            coverage = spc * base_block
            boundary = min(lo_total - lo, total - start)
            if coverage > boundary:
                # Chunk tail: the smallest program that covers the remainder;
                # advance only to the boundary (overshoot rows are aliases).
                spc = next(r for r in STEPS_RAMP if r * base_block >= boundary)
                coverage = boundary
            inflight.append((start, coverage, hi, _Pending.launch(sweep, lo, spc, hi_row(hi))))
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
