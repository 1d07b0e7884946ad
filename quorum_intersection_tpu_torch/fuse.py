"""qi-fuse: cross-request pack fusion at the serve drain.

The port of the JAX package's ``fuse.py``.  The sweep's cost is the
enumeration of an NP-hard window space, so the serving layer gets faster per
verdict only by filling every lane pack.  The packed sweep (K3/K4) already
fuses the SCC circuits of one ``check_many`` call into one block-diagonal
lane tile; :class:`BatchFormer` widens that to different requests.  Drain
workers of different requests submit their sources and block; the former
accumulates them until the estimated lane tile fills, every registered
producer is waiting (no more work can arrive), or a deadline-aware timer
fires, and one elected producer flushes the whole accumulation as a single
``check_many`` call whose lane packer sees every request's circuits at once.
Results split back per submission in order; each request keeps its own
:class:`~.backends.base.CancelToken`, so a lane whose request died retires
through the sweep's per-group dead-lane machinery without touching co-packed
work.

The former never inspects verdicts and never reorders a request's own
sources, so the fused path answers each request as the unfused one does
(modulo shared-batch provenance).  Fusion is an optimization, never a
precondition for a verdict: the ``serve.fuse`` fault point degrades the drain
in place to the unfused per-batch path, on the same backend and device.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from quorum_intersection_tpu_torch.backends.base import CancelToken
from quorum_intersection_tpu_torch.encode.circuit import LANE_TILE, ladder_up
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record

# Deterministic-interleaving hook: a test swaps in a callable that blocks at
# named points to force orderings like a flush taking off while a late
# submit is still queueing.  Production: no-op.
_fuse_sync: Callable[[str], None] = lambda point: None  # noqa: E731

# Hook points, in call order: a producer entering submit
# ("fuse.submit"), the elected flusher the moment it owns a formed batch
# ("fuse.flush.formed"), and the flusher after results are distributed
# ("fuse.flush.done").  All fire OUTSIDE the former's lock.
_POINT_SUBMIT = "fuse.submit"
_POINT_FORMED = "fuse.flush.formed"
_POINT_DONE = "fuse.flush.done"


@dataclass
class FuseUnit:
    """One producer's submission: a request's sources awaiting a flush."""

    sources: List[object]
    origin: str
    cancel: Optional[CancelToken] = None
    # Latest monotonic time this unit may still be HELD in the former —
    # the deadline-aware half of the flush timer.  None: no deadline.
    deadline_t: Optional[float] = None
    lanes: int = 0
    ready: threading.Event = field(default_factory=threading.Event)
    results: Optional[List[object]] = None
    error: Optional[BaseException] = None


def estimate_lanes(source: object, lane_tile: int = LANE_TILE) -> int:
    """Upper-bound lane estimate for one source: the pad-ladder rung of
    its node count (the pack planner can never use more lanes for it than
    it has nodes, rounded up to a compiled shape), capped at one tile.
    Opaque sources (raw JSON text) estimate a full tile — conservative:
    they flush immediately rather than holding a tile they might not
    fill."""
    nodes = getattr(source, "nodes", None)
    if nodes is None:
        return lane_tile
    return min(ladder_up(max(len(nodes), 1)), lane_tile)


class BatchFormer:
    """Accumulate window work from different requests into shared packs.

    ``check_many_fn(sources, cancels, origins)`` is the underlying batch
    solve — in the serve drain it closes over the engine's backend and
    threads per-source cancel tokens and request-id origins down to the
    lane packer (``pipeline.check_many`` → ``check_sccs``).

    Producer protocol::

        former.register()
        try:
            results = former.submit(sources, origin=req_id, cancel=tok)
        finally:
            former.done()

    ``submit`` blocks until the unit's flush lands and returns this
    unit's results, in submission order.  Flush fires on the FIRST of:

    - **full** — pending lane estimates fill the tile;
    - **drain** — every registered producer is blocked in ``submit`` (no
      more work can arrive this round, waiting is pure latency);
    - **timer** — the oldest pending unit has waited ``window_ms``;
    - **deadline** — a pending unit's ``deadline_t`` is earlier than the
      timer would fire.

    Exactly one blocked producer is elected flusher; the rest keep
    waiting on their unit.  A flush failure fans the exception out to
    every unit it carried (each producer re-raises in its own frame).
    """

    def __init__(
        self,
        check_many_fn: Callable[
            [List[object], List[Optional[CancelToken]], List[str]],
            List[object],
        ],
        *,
        window_ms: float,
        lane_tile: int = LANE_TILE,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._fn = check_many_fn
        self.window_s = max(float(window_ms), 0.0) / 1000.0
        self.lane_tile = lane_tile
        self._clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[FuseUnit] = []
        self._first_pending_t: Optional[float] = None
        self._producers = 0
        self._waiting = 0
        self._flushing = False
        # Flush reasons in order, for tests and the drain's span attrs.
        self.flush_log: List[str] = []

    # ---- producer lifecycle ----------------------------------------------

    def register(self) -> None:
        """Announce a producer that WILL submit (or call :meth:`done`):
        the drain counts its per-entry workers in, so the former knows
        when everyone is already waiting and holding longer is pointless."""
        with self._cond:
            self._producers += 1

    def done(self) -> None:
        """Producer finished (its submits all returned, or it had no
        work).  May unblock a drain flush."""
        with self._cond:
            self._producers = max(self._producers - 1, 0)
            self._cond.notify_all()

    # ---- submission -------------------------------------------------------

    def submit(
        self,
        sources: Sequence[object],
        *,
        origin: str,
        cancel: Optional[CancelToken] = None,
        deadline_t: Optional[float] = None,
    ) -> List[object]:
        """Queue this request's sources and block until their flush lands.

        Returns this unit's results (aligned with ``sources``).  Raises
        whatever the underlying batch solve raised, in every contributing
        producer's frame."""
        _fuse_sync(_POINT_SUBMIT)
        unit = FuseUnit(
            sources=list(sources), origin=origin, cancel=cancel,
            deadline_t=deadline_t,
            lanes=sum(estimate_lanes(s, self.lane_tile) for s in sources),
        )
        batch: Optional[List[FuseUnit]] = None
        reason = ""
        with self._cond:
            self._pending.append(unit)
            if self._first_pending_t is None:
                self._first_pending_t = self._clock()
            self._cond.notify_all()
            self._waiting += 1
            try:
                while not unit.ready.is_set():
                    reason = self._flush_reason_locked()
                    if reason and not self._flushing:
                        self._flushing = True
                        batch = self._pending
                        self._pending = []
                        self._first_pending_t = None
                        break
                    self._cond.wait(self._wait_timeout_locked())
            finally:
                self._waiting -= 1
        if batch is not None:
            self._flush(batch, reason)
        unit.ready.wait()
        if unit.error is not None:
            raise unit.error
        assert unit.results is not None
        return unit.results

    # ---- flush machinery --------------------------------------------------

    def _flush_reason_locked(self) -> str:
        if not self._pending:
            return ""
        if sum(u.lanes for u in self._pending) >= self.lane_tile:
            return "full"
        if self._producers > 0 and self._waiting >= self._producers:
            return "drain"
        now = self._clock()
        timer_t = (
            self._first_pending_t + self.window_s
            if self._first_pending_t is not None else None
        )
        deadline_t = min(
            (u.deadline_t for u in self._pending if u.deadline_t is not None),
            default=None,
        )
        if deadline_t is not None and (timer_t is None or deadline_t < timer_t):
            if now >= deadline_t:
                return "deadline"
        elif timer_t is not None and now >= timer_t:
            return "timer"
        return ""

    def _wait_timeout_locked(self) -> Optional[float]:
        """Seconds until the earliest timed flush trigger, or None (wait
        for a notify) when nothing is pending."""
        if not self._pending or self._first_pending_t is None:
            return None
        fire_t = self._first_pending_t + self.window_s
        for u in self._pending:
            if u.deadline_t is not None:
                fire_t = min(fire_t, u.deadline_t)
        return max(fire_t - self._clock(), 0.0)

    def _flush(self, batch: List[FuseUnit], reason: str) -> None:
        _fuse_sync(_POINT_FORMED)
        rec = get_run_record()
        sources: List[object] = []
        cancels: List[Optional[CancelToken]] = []
        origins: List[str] = []
        for u in batch:
            sources.extend(u.sources)
            cancels.extend([u.cancel] * len(u.sources))
            origins.extend([u.origin] * len(u.sources))
        rec.event(
            "fuse.flush", reason=reason, units=len(batch),
            requests=len(set(origins)), lanes=sum(u.lanes for u in batch),
        )
        try:
            results = self._fn(sources, cancels, origins)
            if len(results) != len(sources):
                raise RuntimeError(
                    f"fused solve returned {len(results)} results for "
                    f"{len(sources)} sources"
                )
            at = 0
            for u in batch:
                u.results = list(results[at:at + len(u.sources)])
                at += len(u.sources)
        except BaseException as exc:  # noqa: BLE001 — fan out to every unit
            for u in batch:
                if u.results is None:
                    u.error = exc
        finally:
            with self._cond:
                self._flushing = False
                self.flush_log.append(reason)
                for u in batch:
                    u.ready.set()
                self._cond.notify_all()
            _fuse_sync(_POINT_DONE)
