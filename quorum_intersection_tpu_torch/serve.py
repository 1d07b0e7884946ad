"""qi-serve/1: the crash-only snapshot-stream serving layer.

The port of the JAX package's ``serve.py``.  A long-lived service ingests a
stream of FBAS snapshots and answers verdict queries for many clients; the
NP-hard solve means any one request can blow any latency budget, so
deadlines, backpressure and shedding are first-class semantics.
:class:`ServeEngine` is that layer:

- **Admission queue, bounded** (``QI_SERVE_QUEUE_DEPTH``): compatible requests
  drain in batches through :func:`pipeline.check_many`, which lane-packs
  sweep-sized problems on the card; a request arriving over depth is shed
  with a typed :class:`Overloaded`.
- **Per-request deadlines** (``QI_SERVE_DEADLINE_S``): a deadline supervisor
  trips the batch's CancelToken mid-window and the expired request returns a
  typed :class:`DeadlineExceeded` carrying its partial-coverage record.
- **Verdict cache** keyed by :func:`snapshot_fingerprint` (the canonical
  sanitized graph, the SCC partition and the front-end options), bounded
  (``QI_SERVE_CACHE_MAX``), single-flight (concurrent identical queries share
  one solve).
- **Crash-only request journal** (:class:`RequestJournal`,
  ``QI_SERVE_JOURNAL``): accepted requests are journaled, fsync per entry,
  before solving and marked ``done`` after, so ``kill -9`` and a restart
  replay in-flight work with no lost and no duplicated verdict; corrupt or
  foreign-fingerprint entries go to ``<journal>.corrupt``.  The fingerprint
  and the journal lines are the JAX package's byte for byte, so one journal
  replays in either package.  ``/readyz`` answers 503 until replay completes.
- **Incremental re-analysis** through the port's :class:`~.delta.DeltaEngine`
  and, with ``QI_SERVE_FUSE_WINDOW_MS`` positive (or ``auto``), cross-request
  lane fusion through :class:`~.fuse.BatchFormer`, with each request's device
  cost booked to its tenant (``cost.py``).

Every boundary declares a fault point (``serve.admit``, ``serve.cache``,
``serve.journal``, ``serve.drain``, ``serve.respond``, ``serve.fuse``) and
degrades instead of dying: a cache fault bypasses the cache, a journal fault
serves un-journaled (loudly), a drain fault falls back to per-request solves
on the same backend and device, a respond fault becomes a typed error
response.  A solve on the card that fails (a kernel limit, a build failure, a
CUDA error, a fired ``sweep.*`` fault) fails its request with a typed error;
no host oracle or plain kernel version answers in its place.

The engine solves on the card unless built with ``device="cpu"``.  CLI:
``python -m quorum_intersection_tpu_torch serve`` (one JSON request a stdin
line, one JSON response a stdout line; ``serve_transport.py``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Deque, Dict, List, Optional, Tuple, Union

from quorum_intersection_tpu_torch.backends.base import (
    CancelToken,
    SearchBackend,
    SearchCancelled,
    get_backend,
)
from quorum_intersection_tpu_torch.cert import CERT_SCHEMA
from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.delta import (
    DeltaEngine,
    SccVerdictStore,
    SharedSccStore,
)
from quorum_intersection_tpu_torch.fbas.graph import IndexedQSet, TrustGraph, build_graph
from quorum_intersection_tpu_torch.fbas.schema import Fbas, QSet, parse_fbas
from quorum_intersection_tpu_torch.fuse import BatchFormer
from quorum_intersection_tpu_torch.pipeline import SolveResult, check_many
from quorum_intersection_tpu_torch.query import (
    Query,
    QueryEngine,
    QueryError,
    QueryResult,
)
from quorum_intersection_tpu_torch.utils.env import (
    qi_env,
    qi_env_float,
    qi_env_int,
)
from quorum_intersection_tpu_torch.utils.faults import FaultInjected, fault_point
from quorum_intersection_tpu_torch.utils.logging import get_logger
from quorum_intersection_tpu_torch.utils.telemetry import (
    TraceContext,
    dump_exemplar,
    get_run_record,
    percentile,
)

log = get_logger("serve")

# Deterministic-interleaving hook: a no-op in production; a test swaps in a
# callable that blocks at named points to force the admission/drain orderings
# the wall clock almost never produces (coalesce-during-solve,
# deadline-between-pop-and-solve, submit-racing-stop).
_serve_sync: Callable[[str], None] = lambda point: None

SERVE_SCHEMA = "qi-serve/1"
JOURNAL_SCHEMA = "qi-serve-journal/1"

# The p50/p99 gauge window (LATENCY_WINDOW) and the nearest-rank estimator
# live in utils/telemetry.py beside the Histogram they feed; re-exported
# here under the JAX package's name.
_percentile = percentile

# One deadline-cancelled batch requeues its surviving (un-expired)
# requests for a fresh solve; past this many attempts a request returns a
# typed error instead of cycling the queue forever.
MAX_SOLVE_ATTEMPTS = 2


# ---- typed request outcomes -------------------------------------------------


class ServeError(RuntimeError):
    """Base of the serving layer's typed request failures.

    Typed (mirroring the ``FaultInjected`` family): the
    chaos contract is "a served verdict equals the fault-free chain or the
    request fails LOUDLY with a typed error" — these classes are the typed
    errors, and ``code`` is the machine-readable discriminator the CLI
    emits in its JSONL error responses."""

    code = "serve_error"


class Overloaded(ServeError):
    """Admission queue at its depth bound: the request was shed.

    Load shedding is a *feature*: a bounded queue with typed rejections
    keeps p99 latency honest under overload, where an unbounded queue
    converts overload into unbounded latency for every client."""

    code = "overloaded"

    def __init__(self, depth: int, bound: int) -> None:
        self.depth = depth
        self.bound = bound
        super().__init__(
            f"admission queue full ({depth} >= bound {bound}); request shed"
        )


class DeadlineExceeded(ServeError):
    """The request's deadline budget expired before a verdict.

    Carries the partial-coverage certificate (``cert``): a ``qi-cert/1``-
    shaped block with ``verdict: null, partial: true`` and the window
    coverage the cancelled search completed before the deadline supervisor
    tripped the CancelToken — evidence of work done, never mistakable for
    a verdict."""

    code = "deadline_exceeded"

    def __init__(self, request_id: str, deadline_s: float,
                 cert: Optional[Dict[str, object]] = None) -> None:
        self.request_id = request_id
        self.deadline_s = deadline_s
        self.cert = cert
        super().__init__(
            f"request {request_id} exceeded its {deadline_s:g}s deadline"
        )


class ServeClosed(ServeError):
    """The engine is stopping and no longer admits requests."""

    code = "closed"


# ---- fingerprinting ---------------------------------------------------------


def _qset_canonical(q: IndexedQSet) -> List[object]:
    """Canonical nested form of one resolved quorum set (threshold, member
    vertex indices, inner sets, dropped-dangling count) — exactly the
    inputs the verdict and its certificate depend on."""
    return [
        q.threshold,
        list(q.members),
        [_qset_canonical(iq) for iq in q.inner],
        q.n_dangling,
    ]


def snapshot_fingerprint(
    graph: TrustGraph,
    *,
    scc_select: str = "quorum-bearing",
    scope_to_scc: bool = False,
) -> str:
    """Sanitized-SCC fingerprint of one snapshot's verdict problem.

    Hashes the canonical *sanitized* graph structure — per-vertex node id
    + resolved quorum set in vertex order, the dangling policy the graph
    was built under, the SCC partition, and the solve options — i.e.
    everything the verdict AND its certificate depend on, and nothing
    else: node *names*, JSON key order and formatting churn all hash
    identically, so the overwhelmingly common unchanged-topology query is
    a cache hit.  Vertex order is deliberately included: certificates
    carry vertex indices (``q1_index``/``q2_index``), and two snapshots
    must fingerprint equal only when their certs are interchangeable.
    """
    from quorum_intersection_tpu_torch.fbas.graph import group_sccs, tarjan_scc

    count, comp = tarjan_scc(graph.n, graph.succ)
    payload = {
        "v": 1,
        "dangling": graph.dangling,
        "scc_select": scc_select,
        "scope_to_scc": bool(scope_to_scc),
        "nodes": [
            [graph.node_ids[v], _qset_canonical(graph.qsets[v])]
            for v in range(graph.n)
        ],
        "sccs": group_sccs(graph.n, comp, count),
    }
    return hashlib.sha256(
        json.dumps(payload, separators=(",", ":")).encode()
    ).hexdigest()[:32]


# ---- responses and tickets --------------------------------------------------


@dataclass
class ServeResponse:
    """One served verdict: the solve result plus serve-side provenance.

    ``result`` carries a typed query's structured payload (qi-query/1,
    ) — None for the legacy boolean intersection path, so the
    pre-query response shape is untouched."""

    request_id: str
    intersects: bool
    cert: Optional[Dict[str, object]]
    stats: Dict[str, object]
    cached: bool
    seconds: float  # admission → delivery latency
    result: Optional[Dict[str, object]] = None
    # Wire trace echo (qi-pulse): the request's carried
    # ``trace_id:span_id[:pid]`` context, echoed back so the client (and
    # the fleet front door relaying worker responses) can join the
    # response to its distributed trace.  None on trace-less requests.
    trace: Optional[str] = None
    # Per-request device cost (qi-cost/1): what this verdict
    # paid for on the device — lane·windows, MACs, pro-rated dispatch
    # wall, delta reuse credits.  None when attribution degraded, on
    # cache hits (zero new device work) and on cost-less backends.
    cost: Optional[Dict[str, object]] = None


_Outcome = Tuple[str, object]  # ("ok", ServeResponse) | ("err", Exception)


class Ticket:
    """A client's handle on one submitted request (thread-safe)."""

    def __init__(self, request_id: str, submitted_t: float,
                 deadline_t: Optional[float]) -> None:
        self.request_id = request_id
        self.submitted_t = submitted_t
        self.deadline_t = deadline_t  # absolute monotonic, None = no deadline
        # qi-pulse: THIS submission's wire trace — a coalesced waiter's
        # response must echo its OWN context, not the leader entry's.
        self.trace: Optional[str] = None
        # qi-cost: THIS submission's client id — it rides the ticket (not
        # the solve entry) so coalesced waiters and cache hits each book
        # to their OWN tenant.  None books as "anon".
        self.client: Optional[str] = None
        self._event = threading.Event()
        self._outcome: Optional[_Outcome] = None
        self._callbacks: List[Callable[["Ticket"], None]] = []
        self._cb_lock = threading.Lock()

    def _resolve(self, outcome: _Outcome) -> None:
        """Deliver exactly once; later resolutions are ignored (a requeued
        request that also expired must not flip its recorded outcome)."""
        with self._cb_lock:
            if self._outcome is not None:
                return
            self._outcome = outcome
            # Set INSIDE the lock: add_done_callback's immediate-invoke
            # path observes _outcome under this lock and may call
            # result(timeout=0) from the callback — the event must already
            # be set by then or a resolved ticket reads as timed out.
            self._event.set()
            callbacks = list(self._callbacks)
        for cb in callbacks:
            try:
                cb(self)
            except Exception as exc:  # noqa: BLE001 — a client callback must not kill the drain
                log.warning("ticket callback failed: %s", exc)

    def add_done_callback(self, cb: Callable[["Ticket"], None]) -> None:
        """Run ``cb(ticket)`` on delivery (immediately if already done) —
        the CLI's streaming-output hook."""
        with self._cb_lock:
            if self._outcome is None:
                self._callbacks.append(cb)
                return
        cb(self)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResponse:
        """Block for the outcome; raises the typed error on failure."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished after {timeout}s"
            )
        assert self._outcome is not None
        kind, value = self._outcome
        if kind == "ok":
            return value  # type: ignore[return-value]
        raise value  # type: ignore[misc]


@dataclass
class _Entry:
    """One solve unit: a fingerprint-distinct admitted request plus every
    coalesced waiter sharing its verdict (single-flight).  ``query`` is
    the typed qi-query/1 request (the default is the degenerate
    intersection query — the legacy path)."""

    request_id: str
    fingerprint: str
    fbas: Fbas
    nodes: List[Dict[str, object]]
    query: Query = field(default_factory=Query)
    waiters: List[Ticket] = field(default_factory=list)
    journaled: bool = False
    replayed: bool = False
    cache_bypass: bool = False
    attempts: int = 0
    done: bool = False
    admitted_t: float = 0.0
    # qi-pulse: the wire-carried trace context this request
    # arrived with (the drain adopts it around the solve) and the
    # per-stage latency breakdown the exemplar dump reports.
    trace: Optional[str] = None
    stages: Dict[str, float] = field(default_factory=dict)

    def trace_ctx(self) -> Optional[TraceContext]:
        return TraceContext.from_env(self.trace) if self.trace else None


# ---- crash-only request journal --------------------------------------------


class RequestJournal:
    """Append-only JSONL request journal with the crash-only discipline.

    Every append is flushed **and fsynced** before :meth:`append` returns
    — the same durability bar as ``utils/checkpoint.py``'s
    fsync-before-rename, adapted to an append-only log (there is no
    rename per entry; the fsync is what makes "accepted" mean "survives a
    power cut").  A ``kill -9`` can tear at most the final line, which
    replay tolerates; any OSError on the write path downgrades to the
    ``serve.journal_errors`` counter (the request proceeds un-journaled,
    loudly) — a journal exists to rescue requests, never to reject them.
    """

    def __init__(self, path: Union[str, Path]) -> None:
        self.path = Path(path)
        self._lock = threading.Lock()
        self._fh: Optional[object] = None

    def _append_line(self, payload: Dict[str, object]) -> bool:
        """One durable append; False (never an exception) on failure."""
        rec = get_run_record()
        try:
            fault_point("serve.journal")
            with self._lock:
                if self._fh is None:
                    fresh = not self.path.exists()
                    self._fh = open(self.path, "a", encoding="utf-8")
                    if fresh:
                        self._fh.write(json.dumps({
                            "kind": "meta", "schema": JOURNAL_SCHEMA,
                            "pid": os.getpid(),
                        }) + "\n")
                self._fh.write(json.dumps(payload, default=str) + "\n")
                self._fh.flush()
                os.fsync(self._fh.fileno())
        except (OSError, FaultInjected) as exc:
            rec.add("serve.journal_errors")
            rec.event("serve.journal_error", error=str(exc))
            log.warning(
                "request journal append failed (%s); request proceeds "
                "UN-journaled — replay protection lost for it", exc,
            )
            return False
        return True

    def append_request(self, request_id: str, fingerprint: str,
                       nodes: List[Dict[str, object]],
                       deadline_s: Optional[float],
                       query: Optional[Dict[str, object]] = None,
                       trace: Optional[str] = None) -> bool:
        payload: Dict[str, object] = {
            "kind": "req", "request_id": request_id,
            "fingerprint": fingerprint, "deadline_s": deadline_s,
            "nodes": nodes, "t_wall": round(time.time(), 3),
        }
        if trace is not None:
            # Wire trace context (qi-pulse): journaled so a replay
            # re-adopts the ORIGINAL request's trace — the recovered
            # solve's spans join the trace the front door started.
            payload["trace"] = trace
        if query is not None:
            # Typed queries (qi-query/1) journal their wire form so a
            # replay re-resolves the SAME question — the fingerprint
            # already carries the query kind, so a replayed relaxed query
            # can never serve from an intersection cache line.
            payload["query"] = query
        ok = self._append_line(payload)
        if ok:
            get_run_record().add("serve.journal_entries")
        return ok

    def append_done(self, request_id: str, fingerprint: str,
                    outcome: str, verdict: Optional[bool]) -> bool:
        ok = self._append_line({
            "kind": "done", "request_id": request_id,
            "fingerprint": fingerprint, "outcome": outcome,
            "verdict": verdict, "t_wall": round(time.time(), 3),
        })
        if ok:
            get_run_record().add("serve.journal_done")
        return ok

    def scan(self) -> Tuple[List[Dict[str, object]], List[str], bool]:
        """Read the journal: ``(entries, corrupt_lines, torn_tail)``.

        A non-JSON **final** line is the expected ``kill -9`` artifact
        (torn mid-append) and is reported separately; corrupt lines
        anywhere else are returned for quarantine.  Never raises on
        content — a journal must not block the startup it exists for.
        """
        try:
            raw = self.path.read_text(encoding="utf-8", errors="replace")
        except OSError:
            return [], [], False
        lines = [ln for ln in raw.splitlines() if ln.strip()]
        entries: List[Dict[str, object]] = []
        corrupt: List[str] = []
        torn_tail = False
        for i, line in enumerate(lines):
            try:
                obj = json.loads(line)
                if not isinstance(obj, dict) or "kind" not in obj:
                    raise ValueError("not a journal entry object")
            except (ValueError, json.JSONDecodeError):
                if i == len(lines) - 1:
                    torn_tail = True  # the one corruption a hard kill writes
                else:
                    corrupt.append(line)
                continue
            if obj.get("kind") != "meta":
                entries.append(obj)
        return entries, corrupt, torn_tail

    def quarantine(self, lines: List[str], why: str) -> None:
        """Append unusable journal lines to ``<journal>.corrupt`` —
        evidence preserved for postmortems, startup never blocked."""
        if not lines:
            return
        rec = get_run_record()
        corrupt = self.path.with_name(self.path.name + ".corrupt")
        try:
            with open(corrupt, "a", encoding="utf-8") as fh:
                for line in lines:
                    fh.write(line.rstrip("\n") + "\n")
        except OSError as exc:
            log.warning("journal quarantine write failed (%s)", exc)
        rec.add("serve.journal_quarantined", len(lines))
        rec.event(
            "serve.journal_quarantined", lines=len(lines), why=why,
            quarantined_to=str(corrupt),
        )
        log.warning(
            "%d corrupt journal line(s) quarantined to %s (%s)",
            len(lines), corrupt, why,
        )

    def compact(self, keep: List[Dict[str, object]]) -> None:
        """Rewrite the journal to ``meta + keep`` atomically (tmp + fsync +
        rename + best-effort dir fsync): replayed/done pairs drop out so
        the file stays bounded across restarts; still-pending entries
        survive for the next replay.  Failure downgrades (the un-compacted
        journal is larger, not wrong)."""
        tmp = self.path.with_suffix(".tmp")
        try:
            with self._lock:
                if self._fh is not None:
                    try:
                        self._fh.close()  # type: ignore[attr-defined]
                    except OSError:
                        pass
                    self._fh = None
                with open(tmp, "w", encoding="utf-8") as fh:
                    fh.write(json.dumps({
                        "kind": "meta", "schema": JOURNAL_SCHEMA,
                        "pid": os.getpid(), "compacted": True,
                    }) + "\n")
                    for entry in keep:
                        fh.write(json.dumps(entry, default=str) + "\n")
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, self.path)
            try:
                dir_fd = os.open(str(self.path.parent), os.O_RDONLY)
                try:
                    os.fsync(dir_fd)
                finally:
                    os.close(dir_fd)
            except OSError:
                pass  # best-effort, as in utils/checkpoint.py
        except OSError as exc:
            log.warning("journal compaction failed (%s); journal kept as-is", exc)
            try:
                tmp.unlink()
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()  # type: ignore[attr-defined]
                except OSError:
                    pass
                self._fh = None


# ---- the engine -------------------------------------------------------------


class ServeEngine:
    """Long-lived snapshot-verdict service (see module docstring).

    All requests of one engine share its front-end options (dangling
    policy, SCC selection, scoping, backend), which is what makes queued
    requests *compatible*: any subset of the queue can fuse into one
    ``check_many`` batch.
    """

    def __init__(
        self,
        backend: Union[str, SearchBackend] = "auto",
        *,
        queue_depth: Optional[int] = None,
        batch_max: Optional[int] = None,
        deadline_s: Optional[float] = None,
        cache_max: Optional[int] = None,
        journal: Optional[Union[str, Path]] = None,
        dangling: str = "strict",
        scc_select: str = "quorum-bearing",
        scope_to_scc: bool = False,
        pack: Optional[bool] = None,
        delta: Optional[bool] = None,
        shared_store: Optional[SharedSccStore] = None,
        fuse_window_ms: Optional[Union[float, str]] = None,
        device: DeviceLike = None,
    ) -> None:
        # The card unless the caller asks for the host; resolved now, so a
        # server started without a card fails before it admits anything.
        self.device = resolve_device(device)
        self.backend = backend
        self.queue_depth = (
            queue_depth if queue_depth is not None
            else max(qi_env_int("QI_SERVE_QUEUE_DEPTH", 64), 1)
        )
        self.batch_max = (
            batch_max if batch_max is not None
            else max(qi_env_int("QI_SERVE_BATCH_MAX", 8), 1)
        )
        self.deadline_s = (
            deadline_s if deadline_s is not None
            else qi_env_float("QI_SERVE_DEADLINE_S", 0.0)
        )
        self.cache_max = (
            cache_max if cache_max is not None
            else max(qi_env_int("QI_SERVE_CACHE_MAX", 1024), 1)
        )
        journal_path = journal if journal is not None else (
            qi_env("QI_SERVE_JOURNAL") or None
        )
        self._journal = (
            RequestJournal(journal_path) if journal_path else None
        )
        self.dangling = dangling
        self.scc_select = scc_select
        self.scope_to_scc = scope_to_scc
        self.pack = pack
        # Cross-request pack fusion (qi-fuse): while positive,
        # the drain runs each popped entry in its own worker and a shared
        # BatchFormer merges their window work into one lane-packed solve;
        # 0 (the default) keeps the byte-compatible legacy drain.
        # 'auto' (qi-cost): the window is chosen per flush cycle
        # by cost.choose_fuse_window from the pulse queue-wait p99 and the
        # SLO burn state — the raw env string is checked FIRST because
        # qi_env_float would silently fall 'auto' back to the registered
        # default.
        fuse_raw: Union[float, str] = (
            fuse_window_ms if fuse_window_ms is not None
            else qi_env("QI_SERVE_FUSE_WINDOW_MS")
        )
        self.fuse_window_auto = (
            isinstance(fuse_raw, str) and fuse_raw.strip().lower() == "auto"
        )
        if self.fuse_window_auto:
            self.fuse_window_ms = 0.0
        elif fuse_window_ms is not None:
            self.fuse_window_ms = float(fuse_window_ms)
        else:
            self.fuse_window_ms = qi_env_float("QI_SERVE_FUSE_WINDOW_MS", 0.0)
        # Incremental re-analysis (qi-delta): the drain consults
        # the per-SCC verdict store BEFORE check_many, so a churn step that
        # leaves the quorum-bearing SCC structurally unchanged composes its
        # verdict from cached fragments and never reaches a backend.  On by
        # default; delta=False (CLI --no-delta) or QI_DELTA_CACHE_MAX=0
        # restores the all-or-nothing pre-delta behavior.
        delta_cache = qi_env_int("QI_DELTA_CACHE_MAX", 4096)
        delta_on = delta if delta is not None else delta_cache > 0
        # Two-level store tier (qi-fleet): with a shared fragment
        # store attached — explicitly, or via QI_FLEET_STORE_DIR in a fleet
        # worker's environment — the per-process LRU reads through to the
        # fingerprint-keyed shared tier, so an SCC fragment solved by any
        # worker composes into every worker's certs.  A dead shared tier
        # degrades to local-LRU-only (fleet.store fault point), loudly.
        if shared_store is None:
            store_dir = qi_env("QI_FLEET_STORE_DIR")
            shared_store = SharedSccStore(store_dir) if store_dir else None
        self._delta: Optional[DeltaEngine] = (
            DeltaEngine(
                SccVerdictStore(
                    delta_cache if delta_cache > 0 else None,
                    shared=shared_store,
                ),
                dangling=dangling, scc_select=scc_select,
                scope_to_scc=scope_to_scc, device=self.device,
            )
            if delta_on else None
        )
        # Typed query resolver (qi-query): shares this engine's
        # front-end options, so every query kind answers the same FBAS
        # under the same flags as the boolean verdict; the drain injects
        # its delta-aware, deadline-cancellable batch solver per batch.
        self._query_engine = QueryEngine(
            dangling=dangling, scc_select=scc_select,
            scope_to_scc=scope_to_scc, pack=pack, device=self.device,
        )
        # Slow-request exemplars (qi-pulse): a served request
        # slower end-to-end than this many ms dumps a qi-exemplar/1
        # record through the crash-only dump path.  0: off.
        self._slow_ms = qi_env_float("QI_PULSE_SLOW_MS", 0.0)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: Deque[_Entry] = deque()
        self._reserved = 0  # admission slots between depth check and enqueue
        self._inflight: Dict[str, _Entry] = {}  # fingerprint → live entry
        self._cache: "OrderedDict[str, Union[SolveResult, QueryResult]]" = OrderedDict()
        self._closed = False
        self._stopping = False
        self._started = False
        self._drain_thread: Optional[threading.Thread] = None
        self._replay_report: Optional[Dict[str, object]] = None

    # ---- lifecycle -------------------------------------------------------

    @property
    def journal_path(self) -> Optional[Path]:
        """This engine's crash-only journal file (``None`` without one); the
        mesh ship protocol streams this file to an inheriting peer."""
        return self._journal.path if self._journal is not None else None

    @property
    def replay_report(self) -> Optional[Dict[str, object]]:
        """The start-time journal replay report (``None`` before start or
        without a journal); the mesh ``hello_ok`` carries it."""
        return self._replay_report

    def attach_remote_store(self, remote: object) -> bool:
        """Attach a remote fragment tier (the fleet mesh): the shared SCC
        store reads through to the front door's store gateway on every local
        miss and publishes every banked fragment back.  A fetched fragment
        passes the same strict shape validation as a local file, and composed
        certificates still re-verify through the checker.  Returns ``False``
        (the caller degrades, loudly) when the delta tier is off: there is no
        fragment store to extend."""
        if self._delta is None:
            return False
        store = self._delta.store
        if store.shared is None:
            # A worker joined with no shared directory of its own still
            # takes part: fetched fragments bank into a private spill
            # directory so a re-fetch is a local hit.
            store.shared = SharedSccStore(Path(tempfile.mkdtemp(prefix="qi-mesh-store-")))
        store.shared.remote = remote
        return True

    def start(self) -> Optional[Dict[str, object]]:
        """Replay the journal (if any), then start the drain loop.

        Returns the replay report (``None`` without a journal).  Until
        replay completes the ``serve.replay_complete`` gauge is 0 and
        ``/readyz`` answers 503 — a restarted instance must not take
        traffic while its crashed predecessor's work is outstanding.
        """
        if self._started:
            return self._replay_report
        self._started = True
        rec = get_run_record()
        rec.gauge("serve.queue_depth", 0)
        rec.gauge("serve.shed_state", 0)
        if self._journal is not None:
            rec.gauge("serve.replay_complete", 0)
            self._replay_report = self._replay_journal()
        rec.gauge("serve.replay_complete", 1)
        # The drain loop arms a per-batch deadline CancelToken itself
        # (_drain_batch) and stop() shuts the thread down; there is no
        # outer token to forward.
        self._drain_thread = threading.Thread(
            target=self._drain_loop, name="qi-serve-drain", daemon=True,
        )
        self._drain_thread.start()
        log.info(
            "serve engine started (queue_depth=%d batch_max=%d "
            "deadline_s=%g cache_max=%d journal=%s)",
            self.queue_depth, self.batch_max, self.deadline_s,
            self.cache_max,
            self._journal.path if self._journal else "off",
        )
        return self._replay_report

    def stop(self, drain: bool = True,
             timeout: Optional[float] = 30.0) -> None:
        """Close admission; optionally wait for the queue to drain.

        ``timeout=None`` waits indefinitely for the drain thread — the
        CLI's EOF path uses it, because "EOF drains and exits 0" must hold
        even when the final solve is an NP-hard blowup that outlives any
        fixed bound.  ``drain=False`` discards the queue, but every
        discarded entry's waiters are resolved with a typed
        :class:`ServeClosed` — a stop is never a silent drop (the soak's
        "a ticket that never resolves" failure class)."""
        dropped: List[_Entry] = []
        with self._cond:
            self._closed = True
            if not drain:
                dropped = list(self._queue)
                self._queue.clear()
            self._stopping = True
            self._cond.notify_all()
        for entry in dropped:
            self._resolve_err(
                entry,
                ServeClosed("serve engine stopped before this request "
                            "drained"),
                outcome="error",
            )
        if self._drain_thread is not None:
            self._drain_thread.join(timeout=timeout)
        if self._journal is not None:
            self._journal.close()

    # ---- admission -------------------------------------------------------

    def submit(
        self,
        source: Union[str, bytes, List[Dict[str, object]], Fbas],
        *,
        request_id: Optional[str] = None,
        deadline_s: Optional[float] = None,
        query: Optional[object] = None,
        trace: Optional[str] = None,
        client: Optional[str] = None,
    ) -> Ticket:
        """Admit one snapshot-verdict request.

        Raises typed :class:`ServeClosed` / :class:`Overloaded` (and
        propagates an injected ``serve.admit`` fault) — admission is
        synchronous backpressure, so a shed request costs its client one
        exception, not a timeout.  Returns a :class:`Ticket` immediately;
        a cache hit resolves it before this call returns.

        ``query`` (qi-query/1) is the raw wire query — a kind
        string, a params object, or an already-parsed :class:`Query`;
        ``None`` means the degenerate intersection query and the whole
        path stays byte-identical to the pre-query engine.  A malformed
        query raises typed :class:`QueryError` at admission.  The
        fingerprint is extended with the query kind + params, so the
        verdict cache, single-flight coalescing and journal replay never
        cross query types.

        ``trace`` (qi-pulse) is the wire-carried trace context
        ``trace_id:span_id[:pid]`` — the ``QI_TRACE_CONTEXT`` format the
        fleet front door stamps on dispatch: admission and the eventual
        solve adopt it, so this request's spans (admit, solve, ladder
        rung, native call) parent under the remote request span and the
        response/journal echo it.  ``None``: the engine's own trace.
        """
        rec = get_run_record()
        fault_point("serve.admit")
        request_id = request_id or f"req-{os.getpid()}-{id(object()):x}-{time.monotonic_ns():x}"
        budget = deadline_s if deadline_s is not None else self.deadline_s
        now = time.monotonic()
        ticket = Ticket(
            request_id, now,
            deadline_t=(now + budget) if budget and budget > 0 else None,
        )
        ticket.trace = trace
        # qi-cost: the tenant this request books to (None → "anon").
        ticket.client = client
        ctx = TraceContext.from_env(trace) if trace else None
        with rec.adopted(ctx), rec.span(
            "serve.admit", request_id=request_id,
        ) as admit_span:
            outcome = self._admit(
                source, ticket, request_id, budget, now, query, trace,
            )
            admit_span.set(outcome=outcome)
        return ticket

    def _admit(
        self,
        source: Union[str, bytes, List[Dict[str, object]], Fbas],
        ticket: Ticket,
        request_id: str,
        budget: float,
        now: float,
        query: Optional[object],
        trace: Optional[str],
    ) -> str:
        """The admission body (under :meth:`submit`'s adopted trace +
        ``serve.admit`` span).  Returns the admission outcome for the
        span; typed rejections raise through."""
        rec = get_run_record()
        parsed_query = (
            query if isinstance(query, Query) else Query.parse(query)
        )
        fbas = source if isinstance(source, Fbas) else parse_fbas(source)
        nodes = _raw_nodes(source, fbas)
        graph = build_graph(fbas, dangling=self.dangling)
        fp = snapshot_fingerprint(
            graph, scc_select=self.scc_select, scope_to_scc=self.scope_to_scc,
        )
        qfp = parsed_query.fingerprint()
        if qfp:
            fp = f"{fp}:q:{qfp}"
        rec.add("serve.requests")

        # Cache probe (its own fault point: an injected cache failure
        # bypasses the cache for this request and solves from scratch —
        # never costs the verdict).  Timed into the pulse.cache_ms stage
        # histogram (qi-pulse).
        cache_bypass = False
        hit: Optional[SolveResult] = None
        cache_t0 = time.perf_counter()
        try:
            fault_point("serve.cache")
        except (FaultInjected, OSError) as exc:
            cache_bypass = True
            rec.add("serve.cache_errors")
            rec.event("serve.cache_error", error=str(exc), phase="lookup")
        shed: Optional[Tuple[int, int]] = None
        coalesced = False
        closed = False
        with self._lock:
            if self._closed:
                closed = True
            elif not cache_bypass and fp in self._cache:
                self._cache.move_to_end(fp)
                hit = self._cache[fp]
            elif fp in self._inflight and not self._inflight[fp].done:
                self._inflight[fp].waiters.append(ticket)
                coalesced = True
            else:
                depth = len(self._queue) + self._reserved
                if depth >= self.queue_depth:
                    shed = (depth, self.queue_depth)
                else:
                    self._reserved += 1
        rec.histogram("pulse.cache_ms").observe(
            (time.perf_counter() - cache_t0) * 1000.0
        )
        if closed:
            rec.add("serve.errors")
            raise ServeClosed("serve engine is closed to new requests")
        if hit is not None:
            rec.add("serve.cache_hits")
            _serve_sync("admit.cache_hit")
            # Deliberately NOT journaled: the journal protects requests
            # that are accepted-but-unanswered (a ticket returned pending),
            # where a kill strands a client mid-wait.  A cache hit resolves
            # before submit() returns — the client holds the verdict the
            # moment it holds the ticket — and an fsync per hit would put
            # the durability tax on exactly the path the cache exists to
            # make cheap.
            self._resolve_ok(ticket, hit, fp, cached=True, trace=trace)
            return "cache_hit"
        if coalesced:
            rec.add("serve.coalesced")
            # A coalesced request is ACCEPTED: it must survive a hard kill
            # like any queued request (the zero-lost contract), so it
            # journals its own req entry and marks its own done on
            # delivery.  The done-mark callback registers BEFORE the
            # caller can attach response emission (add_done_callback runs
            # callbacks in registration order, immediately if already
            # resolved), preserving done-before-response durability.
            if self._journal is not None and self._journal.append_request(
                request_id, fp, nodes,
                budget if budget and budget > 0 else None,
                query=parsed_query.to_wire(), trace=trace,
            ):
                journal = self._journal

                def _mark_done(t: Ticket, _fp: str = fp) -> None:
                    try:
                        resp = t.result(timeout=0)
                    except Exception:  # noqa: BLE001 — any failure outcome journals as error
                        journal.append_done(t.request_id, _fp, "error", None)
                        return
                    journal.append_done(
                        t.request_id, _fp, "verdict", bool(resp.intersects),
                    )

                ticket.add_done_callback(_mark_done)
            _serve_sync("admit.coalesced")
            return "coalesced"
        rec.add("serve.cache_misses")
        if shed is not None:
            rec.add("serve.shed")
            # A shed is a DELIVERED typed failure: it counts toward the
            # requests == verdicts + errors invariant like every other
            # terminal outcome.
            rec.add("serve.errors")
            rec.gauge("serve.shed_state", 1)
            rec.event("serve.shed", request_id=request_id,
                      depth=shed[0], bound=shed[1])
            raise Overloaded(*shed)

        # Journal BEFORE the queue: an accepted request must survive a hard
        # kill from this point on (the crash-only contract).
        entry = _Entry(
            request_id=request_id, fingerprint=fp, fbas=fbas, nodes=nodes,
            query=parsed_query,
            waiters=[ticket], cache_bypass=cache_bypass, admitted_t=now,
            trace=trace,
        )
        if self._journal is not None:
            entry.journaled = self._journal.append_request(
                request_id, fp, nodes,
                budget if budget and budget > 0 else None,
                query=parsed_query.to_wire(), trace=trace,
            )
        with self._cond:
            self._reserved -= 1
            if self._closed:
                # stop() won the race between the depth check and this
                # enqueue: the drain thread may already be gone, so an
                # enqueue here would wedge the ticket forever.  Deliver the
                # typed rejection instead (the journaled entry is balanced
                # below so a restart does not replay a request its client
                # already saw rejected).
                closed = True
            else:
                self._queue.append(entry)
                self._inflight[fp] = entry
                depth = len(self._queue)
                self._cond.notify()
        if closed:
            if self._journal is not None and entry.journaled:
                self._journal.append_done(request_id, fp, "error", None)
            rec.add("serve.errors")
            raise ServeClosed("serve engine closed while admitting")
        rec.gauge("serve.queue_depth", depth)
        if depth < self.queue_depth:
            rec.gauge("serve.shed_state", 0)
        _serve_sync("admit.queued")
        return "queued"

    # ---- drain loop ------------------------------------------------------

    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait(timeout=0.1)
                if self._stopping and not self._queue:
                    return
                batch = [
                    self._queue.popleft()
                    for _ in range(min(len(self._queue), self.batch_max))
                ]
                depth = len(self._queue)
            rec = get_run_record()
            rec.gauge("serve.queue_depth", depth)
            if depth < self.queue_depth:
                rec.gauge("serve.shed_state", 0)
            # Held by the schedule harness to force coalesce-during-solve
            # and deadline-between-pop-and-solve orderings; outside the
            # engine lock, so a parked drain never blocks admission.
            _serve_sync("drain.popped")
            try:
                self._drain_batch(batch)
            except Exception as exc:  # noqa: BLE001 — the drain loop must survive anything
                # Whatever escaped _drain_batch's own handling becomes each
                # waiter's (typed or not) outcome — never a dead loop with
                # wedged clients.
                log.warning("drain batch failed (%s); delivering error", exc)
                for entry in batch:
                    self._resolve_err(entry, exc, outcome="error")

    def _auto_fuse_window(self) -> float:
        """One adaptive fuse-window decision (qi-cost).

        Inputs: the live queue depth beyond this batch, the pulse
        queue-wait p99 (the bounded raw window — the same estimator
        behind the p50/p99 gauges) and the SLO burn state (one lazy
        evaluation — this is one of the plane's three trigger sites).
        Every decision is a ``serve.fuse_window`` event carrying its
        inputs; the active window rides the ``serve.fuse_window_ms``
        gauge.  A broken controller degrades to 0.0 — no fusion wait,
        never a lost verdict."""
        rec = get_run_record()
        try:
            fault_point("cost.attribute")
            from quorum_intersection_tpu_torch.cost import (
                choose_fuse_window, slo_plane,
            )
            with self._lock:
                queue_depth = len(self._queue)
            wait_p99 = rec.histogram(
                "pulse.queue_wait_ms").window_percentile(99.0)
            burning = False
            slo = slo_plane()
            if slo.enabled:
                burning = bool(slo.evaluate().get("burning"))
            window = choose_fuse_window(queue_depth, wait_p99, burning)
            rec.gauge("serve.fuse_window_ms", round(window, 3))
            rec.event(
                "serve.fuse_window", window_ms=round(window, 3),
                queue_depth=queue_depth, wait_p99_ms=round(wait_p99, 3),
                burning=burning,
            )
            return window
        except (FaultInjected, OSError) as exc:
            rec.add("cost.attribute_errors")
            rec.event("cost.degraded", site="serve.fuse_window",
                      error=repr(exc))
            return 0.0

    def _make_backend(self, cancel: Optional[CancelToken]) -> SearchBackend:
        """One backend per batch.  A string spec is constructed fresh with
        the deadline token threaded in where the engine supports it; a
        caller-supplied instance is used as-is (deadlines then enforce
        only at queue boundaries)."""
        if not isinstance(self.backend, str):
            return self.backend
        options: Dict[str, object] = {}
        if cancel is not None and self.backend in (
            "auto", "python", "cpp", "gpu-sweep",
        ):
            options["cancel"] = cancel
        if self.pack is not None and self.backend == "auto":
            options["pack"] = self.pack
        if self.backend in ("auto", "gpu-sweep", "gpu-frontier"):
            options["device"] = self.device
        return get_backend(self.backend, **options)

    def _check_many(
        self, sources: List[Fbas], backend: SearchBackend
    ) -> List[SolveResult]:
        """One batched solve, delta-aware when qi-delta is enabled: the
        incremental engine serves structurally unchanged SCCs from its
        per-SCC store and sends only dirty/new ones to ``backend`` (its
        ``delta.diff`` fault point degrades back to the full chain)."""
        if self._delta is not None:
            return self._delta.check_many(
                sources, backend=backend, pack=self.pack,
            )
        return check_many(
            sources, backend=backend, device=self.device,
            dangling=self.dangling, scc_select=self.scc_select,
            scope_to_scc=self.scope_to_scc, pack=self.pack,
        )

    def _split_expired(
        self, entry: _Entry, now: float
    ) -> Tuple[List[Ticket], List[Ticket]]:
        """Partition ``entry``'s waiters into (expired, alive) and retire
        the entry when nothing stays alive — in ONE lock acquisition:
        coalescers append to ``entry.waiters`` under the same lock, so
        each waiter lands on exactly one side of the split and an emptied
        entry can't absorb a waiter between the split and the retire (the
        invariant documented at :meth:`_finish_entry_locked`)."""
        with self._lock:
            expired = [
                t for t in entry.waiters
                if t.deadline_t is not None and now >= t.deadline_t
            ]
            alive = [t for t in entry.waiters if t not in expired]
            entry.waiters = alive
            if not alive:
                self._finish_entry_locked(entry)
        return expired, alive

    def _partition_expired(
        self, entries: List[_Entry], now: float
    ) -> List[_Entry]:
        """Resolve every already-expired waiter with DeadlineExceeded;
        return the entries that still have live waiters."""
        live: List[_Entry] = []
        for entry in entries:
            expired, alive = self._split_expired(entry, now)
            for t in expired:
                self._resolve_deadline(entry, t, partial=None)
            if alive:
                live.append(entry)
            elif self._journal is not None and entry.journaled:
                self._journal.append_done(
                    entry.request_id, entry.fingerprint,
                    "error", None,
                )
        return live

    def _drain_batch(self, batch: List[_Entry]) -> None:
        rec = get_run_record()
        per_request = False
        try:
            fault_point("serve.drain")
        except (FaultInjected, OSError) as exc:
            # Degrade, don't die: the batched path is an optimization; the
            # per-request path answers the same questions one at a time.
            per_request = True
            rec.add("serve.drain_faults")
            rec.event("serve.drain_degraded", error=str(exc))
        live = self._partition_expired(batch, time.monotonic())
        if not live:
            return
        # Stage histogram (qi-pulse): admission→pop queue wait, per solve
        # unit (a requeued entry's wait accumulates from its original
        # admission — the client-visible number).  Observed BEFORE the
        # adaptive fuse-window decision below, so the controller reads a
        # queue-wait p99 that includes THIS batch's waits — the freshest
        # possible picture of the queue it is sizing the window for.
        queue_h = rec.histogram("pulse.queue_wait_ms")
        pop_t = time.monotonic()
        for entry in live:
            wait_ms = max((pop_t - entry.admitted_t) * 1000.0, 0.0)
            queue_h.observe(wait_ms)
            entry.stages["queue_wait_ms"] = round(wait_ms, 3)
        fuse_window = self.fuse_window_ms if not per_request else 0.0
        if self.fuse_window_auto and not per_request:
            # qi-cost closed loop: the window is chosen per
            # flush cycle from the observed queue state and the SLO burn
            # plane — 0.0 (sparse traffic / degraded controller) falls
            # through to the byte-compatible unfused batch below.
            fuse_window = self._auto_fuse_window()
        if fuse_window > 0:
            try:
                fault_point("serve.fuse")
            except (FaultInjected, OSError) as exc:
                # Same discipline one layer up: fusion is an optimization,
                # never a precondition for a verdict — a broken batch
                # former degrades THIS batch in place to the unfused path.
                fuse_window = 0.0
                rec.add("serve.fuse_faults")
                rec.event("serve.fuse_degraded", error=str(exc))
        # Typed queries (qi-query) split out of the batched
        # intersection path: each kind resolves through its own engine
        # chain (whatif expands into its OWN lane-packed check_many batch;
        # relaxed/analytics never batch), under the same deadline
        # supervisor as the intersection batch they drained with.
        q_live = [e for e in live if e.query.kind != "intersection"]
        live = [e for e in live if e.query.kind == "intersection"]
        if fuse_window > 0:
            self._drain_batch_fused(live, q_live, fuse_window)
            return
        deadlines = [
            t.deadline_t for e in (live + q_live) for t in e.waiters
            if t.deadline_t is not None
        ]
        deadline_cancel = CancelToken() if deadlines else None
        timer: Optional[threading.Timer] = None
        counters0, _ = rec.snapshot()
        with rec.span(
            "serve.batch", requests=len(live) + len(q_live),
            waiters=sum(len(e.waiters) for e in live + q_live),
            per_request=per_request, queries=len(q_live),
        ):
            try:
                if deadline_cancel is not None:
                    timer = threading.Timer(
                        max(min(deadlines) - time.monotonic(), 0.001),
                        deadline_cancel.cancel,
                    )
                    timer.daemon = True
                    timer.start()
                if live:
                    if per_request:
                        self._solve_per_request(
                            live, deadline_cancel, counters0
                        )
                    else:
                        self._solve_batch(live, deadline_cancel, counters0)
                if q_live:
                    self._solve_queries(q_live, deadline_cancel, counters0)
            finally:
                if timer is not None:
                    timer.cancel()

    # ---- fused drain (qi-fuse) ---------------------------------

    def _drain_batch_fused(
        self, live: List[_Entry], q_live: List[_Entry], window_ms: float
    ) -> None:
        """Fleet-aware drain: one worker per entry, one shared
        :class:`~.fuse.BatchFormer` merging every worker's window work —
        plain intersection SCCs and what-if variants alike — into shared
        lane packs (dispatching on tile-full, all-waiting, or the
        deadline-aware ``window_ms`` timer).

        Each entry keeps its OWN CancelToken + deadline supervisor: a
        tripped token retires that request's lane groups mid-pack via the
        sweep's dead-lane machinery while co-packed entries keep their
        full-coverage certs; verdicts and certs stay byte-identical per
        request to the unfused path."""
        rec = get_run_record()
        entries = live + q_live
        counters0, _ = rec.snapshot()
        former = BatchFormer(self._fused_check_many, window_ms=window_ms)
        with rec.span(
            "serve.batch", requests=len(entries),
            waiters=sum(len(e.waiters) for e in entries),
            per_request=False, queries=len(q_live), fused=True,
        ):
            timers: List[threading.Timer] = []
            threads: List[threading.Thread] = []
            try:
                for entry in entries:
                    cancel = CancelToken()
                    deadline_t = min(
                        (
                            t.deadline_t for t in entry.waiters
                            if t.deadline_t is not None
                        ),
                        default=None,
                    )
                    if deadline_t is not None:
                        timer = threading.Timer(
                            max(deadline_t - time.monotonic(), 0.001),
                            cancel.cancel,
                        )
                        timer.daemon = True
                        timer.start()
                        timers.append(timer)
                    former.register()
                    worker = threading.Thread(
                        target=self._fuse_worker,
                        args=(entry, former, cancel, deadline_t, counters0),
                        name=f"qi-fuse-{entry.request_id}",
                        daemon=True,
                    )
                    threads.append(worker)
                for worker in threads:
                    worker.start()
            finally:
                for worker in threads:
                    worker.join()
                for timer in timers:
                    timer.cancel()

    def _fuse_worker(
        self,
        entry: _Entry,
        former: BatchFormer,
        cancel: CancelToken,
        deadline_t: Optional[float],
        counters0: Dict[str, float],
    ) -> None:
        """Solve ONE drained entry through the shared batch former; every
        outcome is delivered exactly as the legacy drain would — typed
        errors, deadline partials with requeue, or the verdict."""
        rec = get_run_record()
        run = self._run_check_many(
            former=former, origin=entry.request_id, cancel=cancel,
            deadline_t=deadline_t,
        )
        t0 = time.perf_counter()
        try:
            try:
                with rec.adopted(entry.trace_ctx()), rec.span(
                    "serve.solve", requests=1, fused=True,
                    delta=self._delta is not None,
                    query=entry.query.kind,
                ):
                    if entry.query.kind == "intersection":
                        # Direct submit (not ``run``): a lane-retired
                        # result must come back AS a result here so its
                        # exact per-request ledger rides the deadline
                        # outcome below, not the raising wrapper the query
                        # resolver needs.
                        res: Union[SolveResult, QueryResult] = former.submit(
                            [entry.fbas], origin=entry.request_id,
                            cancel=cancel, deadline_t=deadline_t,
                        )[0]
                    else:
                        res = self._query_engine.resolve(
                            entry.nodes, entry.query, check_many_fn=run,
                            cancel=cancel,
                        )
            finally:
                former.done()
        except SearchCancelled:
            self._after_deadline_cancel([entry], counters0)
            return
        except QueryError as exc:
            self._resolve_err(entry, exc, outcome="error")
            return
        except Exception as exc:  # noqa: BLE001 — one bad request must not starve the rest
            rec.add("serve.drain_errors")
            self._resolve_err(entry, exc, outcome="error")
            return
        if res.stats.get("cancelled"):
            # The entry's own deadline retired its lanes mid-pack: its
            # PARTIAL coverage cert (the exact per-request ledger, not the
            # legacy batch-level counter diff) rides the deadline outcome;
            # survivors requeue exactly as the legacy path.
            self._after_deadline_cancel(
                [entry], counters0,
                partial_override=getattr(res, "cert", None),
            )
            return
        self._note_solve([entry], (time.perf_counter() - t0) * 1000.0)
        self._deliver_ok(entry, res)

    def _fused_check_many(
        self,
        sources: List[Fbas],
        cancels: List[Optional[CancelToken]],
        origins: List[str],
    ) -> List[SolveResult]:
        """The batch former's flush target: the drain's usual delta-aware
        chain with per-source cancels/origins riding down to the lane
        packer (pipeline → check_sccs → the sweep's per-group ownership)."""
        backend = self._make_backend(None)
        if self._delta is not None:
            return self._delta.check_many(
                sources, backend=backend, pack=self.pack,
                cancels=cancels, origins=origins,
            )
        return check_many(
            sources, backend=backend, device=self.device,
            dangling=self.dangling, scc_select=self.scc_select,
            scope_to_scc=self.scope_to_scc, pack=self.pack,
            cancels=cancels, origins=origins,
        )

    def _run_check_many(
        self,
        backend: Optional[SearchBackend] = None,
        *,
        former: Optional[BatchFormer] = None,
        origin: str = "",
        cancel: Optional[CancelToken] = None,
        deadline_t: Optional[float] = None,
    ) -> Callable[[List[Fbas]], List[SolveResult]]:
        """The ONE place every serve-side ``check_many`` closure is built
        (drain queries, fused workers, journal replay): unfused callers
        pass a ``backend`` and get the delta-aware chain; fused callers
        pass the shared ``former`` and their work joins cross-request
        packs.  A fused result that came back lane-retired raises
        ``SearchCancelled`` — the uniform deadline outcome — so no caller
        can mistake partial coverage for a verdict."""
        if former is not None:
            def run(sources: List[Fbas]) -> List[SolveResult]:
                results = former.submit(
                    sources, origin=origin, cancel=cancel,
                    deadline_t=deadline_t,
                )
                for res in results:
                    if res.stats.get("cancelled"):
                        raise SearchCancelled(
                            f"fused lanes retired by request {origin}'s "
                            f"deadline"
                        )
                return results
            return run

        def run_backend(
            sources: List[Fbas], _backend: Optional[SearchBackend] = backend,
        ) -> List[SolveResult]:
            return self._check_many(sources, _backend)
        return run_backend

    def _solve_batch(
        self,
        live: List[_Entry],
        cancel: Optional[CancelToken],
        counters0: Dict[str, float],
    ) -> None:
        rec = get_run_record()
        backend = self._make_backend(cancel)
        # Wire-trace adoption (qi-pulse): a single-entry batch solves
        # entirely under the request's carried trace, so the ladder-rung /
        # native-call spans the backends open on this thread graft under
        # the front door's request span.  A fused multi-trace batch keeps
        # the engine's own trace (batch-level attribution, like batched
        # certs) — the per-request e2e histogram still covers every entry.
        ctx = live[0].trace_ctx() if len(live) == 1 else None
        t0 = time.perf_counter()
        try:
            with rec.adopted(ctx), rec.span(
                "serve.solve", requests=len(live),
                delta=self._delta is not None,
            ):
                results = self._check_many([e.fbas for e in live], backend)
        except SearchCancelled:
            self._after_deadline_cancel(live, counters0)
            return
        except Exception as exc:  # noqa: BLE001 — degrade to per-request, never wedge the batch
            rec.add("serve.drain_errors")
            log.info(
                "batched drain failed (%s: %s); degrading to per-request "
                "solves", type(exc).__name__, exc,
            )
            self._solve_per_request(live, cancel, counters0)
            return
        self._note_solve(live, (time.perf_counter() - t0) * 1000.0)
        for entry, res in zip(live, results):
            self._deliver_ok(entry, res)

    def _note_solve(self, live: List[_Entry], solve_ms: float) -> None:
        """Book one solve call into the qi-pulse stage histograms and the
        entries' exemplar breakdowns (a fused batch's wall is shared —
        batch-level attribution, the cancelled-batch cert discipline)."""
        rec = get_run_record()
        rec.histogram("pulse.solve_ms").observe(solve_ms)
        if self._delta is not None:
            # The delta-aware chain answered this solve: the same wall,
            # bucketed separately so a reuse regression (delta_ms growing
            # toward solve-from-scratch) is visible in one scrape.
            rec.histogram("pulse.delta_ms").observe(solve_ms)
        for entry in live:
            entry.stages["solve_ms"] = round(solve_ms, 3)

    def _solve_per_request(
        self,
        live: List[_Entry],
        cancel: Optional[CancelToken],
        counters0: Dict[str, float],
    ) -> None:
        rec = get_run_record()
        for ix, entry in enumerate(live):
            if cancel is not None and cancel.cancelled:
                self._after_deadline_cancel(live[ix:], counters0)
                return
            backend = self._make_backend(cancel)
            t0 = time.perf_counter()
            try:
                with rec.adopted(entry.trace_ctx()), rec.span(
                    "serve.solve", requests=1,
                    delta=self._delta is not None,
                ):
                    results = self._check_many([entry.fbas], backend)
            except SearchCancelled:
                self._after_deadline_cancel(live[ix:], counters0)
                return
            except Exception as exc:  # noqa: BLE001 — one bad request must not starve the rest
                rec.add("serve.drain_errors")
                self._resolve_err(entry, exc, outcome="error")
                continue
            self._note_solve([entry], (time.perf_counter() - t0) * 1000.0)
            self._deliver_ok(entry, results[0])

    def _solve_queries(
        self,
        entries: List[_Entry],
        cancel: Optional[CancelToken],
        counters0: Dict[str, float],
    ) -> None:
        """Resolve the drained typed-query entries one by one (qi-query).

        Every failure is a typed outcome: a ``query.dispatch`` degrade or
        resolver error lands as :class:`QueryError`, a deadline cancel
        follows the same partial-coverage path as the intersection batch
        — never a wedged ticket, never a wrong verdict."""
        rec = get_run_record()
        for ix, entry in enumerate(entries):
            if cancel is not None and cancel.cancelled:
                self._after_deadline_cancel(entries[ix:], counters0)
                return
            backend = self._make_backend(cancel)
            run = self._run_check_many(backend)
            t0 = time.perf_counter()
            try:
                with rec.adopted(entry.trace_ctx()), rec.span(
                    "serve.solve", requests=1, query=entry.query.kind,
                ):
                    qres = self._query_engine.resolve(
                        entry.nodes, entry.query, check_many_fn=run,
                        cancel=cancel,
                    )
            except SearchCancelled:
                self._after_deadline_cancel(entries[ix:], counters0)
                return
            except QueryError as exc:
                self._resolve_err(entry, exc, outcome="error")
                continue
            except Exception as exc:  # noqa: BLE001 — one bad query must not starve the rest
                rec.add("serve.drain_errors")
                self._resolve_err(entry, exc, outcome="error")
                continue
            self._note_solve([entry], (time.perf_counter() - t0) * 1000.0)
            self._deliver_ok(entry, qres)

    def _after_deadline_cancel(
        self,
        entries: List[_Entry],
        counters0: Dict[str, float],
        partial_override: Optional[Dict[str, object]] = None,
    ) -> None:
        """The deadline supervisor tripped the CancelToken mid-solve:
        expired waiters get DeadlineExceeded with the partial-coverage
        certificate; survivors requeue for a fresh solve (bounded by
        MAX_SOLVE_ATTEMPTS).

        ``partial_override`` (qi-fuse): the fused drain already holds the
        cancelled request's OWN exact coverage ledger — it replaces the
        legacy batch-level counter diff below."""
        rec = get_run_record()
        counters1, _ = rec.snapshot()
        partial = partial_override if partial_override is not None else {
            "schema": CERT_SCHEMA,
            "verdict": None,
            "partial": True,
            "coverage": {
                # Batch-level attribution, like batched certs' shared event
                # slice: the cancelled solve's window accounting cannot be
                # split per fused lane.
                "batch_level": True,
                "windows_enumerated": int(
                    counters1.get("cert.windows_enumerated", 0)
                    - counters0.get("cert.windows_enumerated", 0)
                ),
                "windows_cancelled": int(
                    counters1.get("cert.windows_cancelled", 0)
                    - counters0.get("cert.windows_cancelled", 0)
                ),
            },
            "provenance": {"trace_id": rec.trace_id},
        }
        now = time.monotonic()
        requeue: List[_Entry] = []
        for entry in entries:
            expired, alive = self._split_expired(entry, now)
            for t in expired:
                self._resolve_deadline(entry, t, partial=partial)
            if not alive:
                if self._journal is not None and entry.journaled:
                    self._journal.append_done(
                        entry.request_id, entry.fingerprint, "error", None,
                    )
                continue
            entry.attempts += 1
            if entry.attempts >= MAX_SOLVE_ATTEMPTS:
                self._resolve_err(
                    entry,
                    ServeError(
                        f"request {entry.request_id} cancelled "
                        f"{entry.attempts} times by co-batched deadlines"
                    ),
                    outcome="error",
                )
                continue
            requeue.append(entry)
        if requeue:
            rec.add("serve.requeues", len(requeue))
            with self._cond:
                for entry in reversed(requeue):
                    self._queue.appendleft(entry)
                self._cond.notify()

    # ---- delivery --------------------------------------------------------

    def _finish_entry_locked(self, entry: _Entry) -> None:
        """Retire ``entry`` from single-flight.  Caller holds ``_lock`` —
        and MUST snapshot ``entry.waiters`` in the SAME lock acquisition:
        a submit that coalesces between a waiter snapshot and this retire
        would be appended to a list nobody will ever resolve (a silent
        drop — the exact bug the serve chaos soak caught under a
        ``serve.cache`` fault, where the cache can't mask the window)."""
        entry.done = True
        if self._inflight.get(entry.fingerprint) is entry:
            del self._inflight[entry.fingerprint]

    def _deliver_ok(
        self, entry: _Entry, res: Union[SolveResult, QueryResult]
    ) -> None:
        """One solved entry: cache, journal-done, respond to every waiter."""
        rec = get_run_record()
        evicted = 0
        if not entry.cache_bypass:
            try:
                fault_point("serve.cache")
                with self._lock:
                    self._cache[entry.fingerprint] = res
                    self._cache.move_to_end(entry.fingerprint)
                    while len(self._cache) > self.cache_max:
                        self._cache.popitem(last=False)
                        evicted += 1
            except (FaultInjected, OSError) as exc:
                rec.add("serve.cache_errors")
                rec.event("serve.cache_error", error=str(exc), phase="insert")
        if evicted:
            rec.add("serve.cache_evictions", evicted)
        with self._lock:
            cache_size = len(self._cache)
            # Atomic with the retire: a coalescer lands either in this
            # snapshot (resolved below) or after the retire (fresh entry /
            # cache hit) — never in a gap between the two.
            waiters = list(entry.waiters)
            self._finish_entry_locked(entry)
        rec.gauge("serve.cache_size", cache_size)
        if self._journal is not None and entry.journaled:
            self._journal.append_done(
                entry.request_id, entry.fingerprint, "verdict",
                bool(res.intersects),
            )
        # Deadline enforcement at delivery: a waiter that coalesced onto
        # this entry AFTER the batch's deadline supervisor was armed was
        # never supervised — its expiry must still be honored here, or a
        # late coalescer silently outlives its budget.  (The verdict is
        # cached above, so the typed error costs one retry, not a solve.)
        now = time.monotonic()
        respond_t0 = time.perf_counter()
        delivered: List[Ticket] = []
        for ticket in waiters:
            if ticket.deadline_t is not None and now >= ticket.deadline_t:
                self._resolve_deadline(entry, ticket, partial=None)
            else:
                self._resolve_ok(ticket, res, entry.fingerprint,
                                 cached=False, replayed=entry.replayed,
                                 trace=ticket.trace)
                delivered.append(ticket)
        rec.histogram("pulse.respond_ms").observe(
            (time.perf_counter() - respond_t0) * 1000.0
        )
        self._maybe_exemplar(entry, delivered)
        _serve_sync("drain.delivered")

    def _maybe_exemplar(self, entry: _Entry,
                        delivered: List[Ticket]) -> None:
        """Slow-request exemplar (qi-pulse), ONE per solve entry however
        many waiters coalesced onto it (a per-waiter dump would fsync the
        same file K times inside the delivery loop).  Fired after every
        waiter already holds its verdict, so neither the dump nor an
        injected dump failure can touch an outcome."""
        if self._slow_ms <= 0 or not delivered:
            return
        now = time.monotonic()
        slowest = max(delivered, key=lambda t: now - t.submitted_t)
        e2e_ms = (now - slowest.submitted_t) * 1000.0
        if e2e_ms <= self._slow_ms:
            return
        ctx = entry.trace_ctx()
        rec = get_run_record()
        breakdown = dict(entry.stages)
        breakdown["e2e_ms"] = round(e2e_ms, 3)
        dump_exemplar({
            "reason": "slow-request",
            "request_id": slowest.request_id,
            "fingerprint": entry.fingerprint,
            "trace_id": ctx.trace_id if ctx is not None else rec.trace_id,
            "trace": entry.trace,
            "e2e_ms": round(e2e_ms, 3),
            "slow_ms": self._slow_ms,
            "waiters": len(delivered),
            "stages": breakdown,
        })

    def _resolve_ok(
        self,
        ticket: Ticket,
        res: Union[SolveResult, QueryResult],
        fingerprint: str,
        *,
        cached: bool,
        replayed: bool = False,
        trace: Optional[str] = None,
    ) -> None:
        rec = get_run_record()
        seconds = time.monotonic() - ticket.submitted_t
        cert = res.cert
        if cert is not None:
            # Per-delivery copy: two waiters (or a later cache hit) each
            # get their own serve stamp without mutating the shared cert.
            cert = dict(cert)
            prov = dict(cert.get("provenance") or {})
            prov["serve"] = {
                "schema": SERVE_SCHEMA,
                "request_id": ticket.request_id,
                "fingerprint": fingerprint,
                "cached": cached,
                "replayed": replayed,
                "journaled": self._journal is not None,
                "latency_s": round(seconds, 6),
            }
            if ticket.client is not None:
                prov["serve"]["client"] = ticket.client
            cert["provenance"] = prov
        # qi-cost: book this delivery to its tenant and attach
        # the cost to the response.  A cache hit books the request but no
        # cost (zero new device work — re-billing the original solve would
        # double-count it); a degraded attribution drops the cost, touches
        # nothing else (verdict, cert and latency stay byte-identical).
        cost: Optional[Dict[str, object]] = None
        try:
            fault_point("cost.attribute")
            raw_cost = res.stats.get("cost")
            if not cached and isinstance(raw_cost, dict):
                cost = dict(raw_cost)
            from quorum_intersection_tpu_torch.cost import tenant_table
            tenant_table().book(ticket.client or "anon", cost)
        except (FaultInjected, OSError) as exc:
            cost = None
            rec.add("cost.attribute_errors")
            rec.event("cost.degraded", site="serve.respond",
                      error=repr(exc))
        response = ServeResponse(
            request_id=ticket.request_id,
            intersects=bool(res.intersects),
            cert=cert,
            stats=dict(res.stats),
            cached=cached,
            seconds=seconds,
            # Typed-query payload (qi-query): None on the legacy boolean
            # path, the structured result table/witness/report otherwise.
            result=getattr(res, "result", None),
            # Wire trace echo (qi-pulse): the request's carried context
            # rides the response line so the caller can join the trace.
            trace=trace,
            cost=cost,
        )
        outcome_err: Optional[BaseException] = None
        try:
            fault_point("serve.respond")
        except (FaultInjected, OSError) as exc:
            # The verdict exists (cached + journaled); this CLIENT's copy
            # failed to deliver — a typed error, never a silent drop, and a
            # retry of the same snapshot is a cache hit.
            rec.add("serve.respond_errors")
            rec.event(
                "serve.respond_error", request_id=ticket.request_id,
                error=str(exc),
            )
            outcome_err = exc
        if outcome_err is not None:
            rec.add("serve.errors")
            ticket._resolve(("err", outcome_err))
            return
        rec.add("serve.verdicts")
        self._note_latency(seconds)
        ticket._resolve(("ok", response))

    def _resolve_deadline(
        self, entry: _Entry, ticket: Ticket,
        partial: Optional[Dict[str, object]],
    ) -> None:
        rec = get_run_record()
        budget = (
            (ticket.deadline_t - ticket.submitted_t)
            if ticket.deadline_t is not None else 0.0
        )
        cert = None
        if partial is not None:
            cert = dict(partial)
            prov = dict(cert.get("provenance") or {})
            prov["serve"] = {
                "schema": SERVE_SCHEMA,
                "request_id": ticket.request_id,
                "fingerprint": entry.fingerprint,
                "deadline_s": round(budget, 6),
            }
            cert["provenance"] = prov
        rec.add("serve.deadline_expired")
        rec.add("serve.errors")
        rec.event(
            "serve.deadline", request_id=ticket.request_id,
            deadline_s=round(budget, 6),
            mid_solve=partial is not None,
        )
        ticket._resolve(("err", DeadlineExceeded(
            ticket.request_id, budget, cert=cert,
        )))

    def _resolve_err(
        self, entry: _Entry, exc: BaseException, *, outcome: str
    ) -> None:
        rec = get_run_record()
        with self._lock:
            waiters = list(entry.waiters)
            self._finish_entry_locked(entry)
        if self._journal is not None and entry.journaled:
            self._journal.append_done(
                entry.request_id, entry.fingerprint, outcome, None,
            )
        rec.add("serve.errors", len(waiters))
        for ticket in waiters:
            ticket._resolve(("err", exc))

    def _note_latency(self, seconds: float) -> None:
        # End-to-end stage histogram (qi-pulse): the buckets are what the
        # fleet aggregation plane merges; the histogram's bounded raw
        # window keeps the serve.p50_ms/p99_ms gauges byte-compatible
        # (same nearest-rank estimator over the same 512-sample window
        # the pre-pulse deque carried, sorted outside any engine lock).
        rec = get_run_record()
        h = rec.histogram("pulse.e2e_ms")
        h.observe(seconds * 1000.0)
        rec.gauge("serve.p50_ms", round(h.window_percentile(50.0), 3))
        rec.gauge("serve.p99_ms", round(h.window_percentile(99.0), 3))

    # ---- journal replay --------------------------------------------------

    def _replay_journal(self) -> Dict[str, object]:
        """Crash-only restart: re-solve every journaled request that never
        reached ``done`` — zero lost (every ``req`` reaches an outcome),
        zero duplicated (a ``done`` entry is final; replay skips it)."""
        assert self._journal is not None
        rec = get_run_record()
        entries, corrupt, torn_tail = self._journal.scan()
        if corrupt:
            self._journal.quarantine(corrupt, "unparseable journal line")
        if torn_tail:
            rec.add("serve.journal_torn_tail")
            log.info(
                "journal tail torn (expected after a hard kill mid-append); "
                "final partial line ignored"
            )
        done_ids = {
            e.get("request_id") for e in entries if e.get("kind") == "done"
        }
        pending: List[Dict[str, object]] = []
        foreign: List[str] = []
        for e in entries:
            if e.get("kind") != "req" or e.get("request_id") in done_ids:
                continue
            nodes = e.get("nodes")
            try:
                if not isinstance(nodes, list):
                    raise ValueError(
                        "journaled nodes payload is not a node array"
                    )
                # Typed queries (qi-query) journal their wire form; an
                # unparseable query quarantines exactly like unparseable
                # nodes — a replayed request must re-ask the SAME question.
                query = Query.parse(e.get("query"))
                fbas = parse_fbas(nodes)
                graph = build_graph(fbas, dangling=self.dangling)
                fp = snapshot_fingerprint(
                    graph, scc_select=self.scc_select,
                    scope_to_scc=self.scope_to_scc,
                )
                qfp = query.fingerprint()
                if qfp:
                    fp = f"{fp}:q:{qfp}"
            except (ValueError, TypeError, KeyError, AttributeError) as exc:
                foreign.append(json.dumps(e, default=str))
                log.warning(
                    "journaled request %s unparseable on replay (%s); "
                    "quarantined", e.get("request_id"), exc,
                )
                continue
            if fp != e.get("fingerprint"):
                # Foreign fingerprint: the entry's recorded identity does
                # not match its own payload (bit rot, a hand-edited file, a
                # journal from a different engine configuration) — replaying
                # it could serve a verdict under the wrong cache key.
                foreign.append(json.dumps(e, default=str))
                log.warning(
                    "journaled request %s has a foreign fingerprint "
                    "(recorded %s != recomputed %s); quarantined",
                    e.get("request_id"), e.get("fingerprint"), fp,
                )
                continue
            raw_trace = e.get("trace")
            pending.append({
                "entry": e, "fbas": fbas, "nodes": nodes,
                "fingerprint": fp, "query": query,
                # qi-pulse: the journaled wire trace — replay re-adopts
                # it so the recovered solve joins the ORIGINAL request's
                # distributed trace instead of minting a disconnected one.
                "trace": raw_trace if isinstance(raw_trace, str) else None,
            })
        if foreign:
            self._journal.quarantine(foreign, "foreign fingerprint / payload")
        report: Dict[str, object] = {
            "schema": SERVE_SCHEMA,
            "journal": str(self._journal.path),
            "entries": len(entries),
            "already_done": len([
                e for e in entries
                if e.get("kind") == "req" and e.get("request_id") in done_ids
            ]),
            "pending": len(pending),
            "quarantined": len(corrupt) + len(foreign),
            "torn_tail": torn_tail,
            "verdicts": {},
            "errors": {},
        }
        rec.event(
            "serve.replay_started", pending=len(pending),
            already_done=report["already_done"],
            quarantined=report["quarantined"],
        )
        still_pending: List[Dict[str, object]] = []
        # Typed-query entries replay one at a time through the query
        # resolver (their batches, if any, are their own — a whatif
        # expands its own lane-packed frontier); intersection entries keep
        # the batched replay below.
        q_pending = [
            p for p in pending if p["query"].kind != "intersection"  # type: ignore[attr-defined]
        ]
        pending = [
            p for p in pending if p["query"].kind == "intersection"  # type: ignore[attr-defined]
        ]
        with rec.span("serve.replay",
                      pending=len(pending) + len(q_pending)):
            for p in q_pending:
                rid = str(p["entry"].get("request_id"))
                fp = str(p["fingerprint"])
                run = self._run_check_many(self._make_backend(None))
                replay_ctx = (
                    TraceContext.from_env(p["trace"])  # type: ignore[arg-type]
                    if p["trace"] else None
                )
                try:
                    with rec.adopted(replay_ctx):
                        res = self._query_engine.resolve(
                            p["nodes"], p["query"],  # type: ignore[arg-type]
                            check_many_fn=run,
                        )
                except Exception as exc:  # noqa: BLE001 — replay must not block startup
                    report["errors"][rid] = (  # type: ignore[index]
                        f"{type(exc).__name__}: {exc}"
                    )
                    still_pending.append(p["entry"])  # type: ignore[arg-type]
                    rec.add("serve.replay_errors")
                    continue
                with self._lock:
                    self._cache[fp] = res
                    self._cache.move_to_end(fp)
                    while len(self._cache) > self.cache_max:
                        self._cache.popitem(last=False)
                self._journal.append_done(
                    rid, fp, "verdict", bool(res.intersects),
                )
                rec.add("serve.journal_replayed")
                report["verdicts"][rid] = bool(  # type: ignore[index]
                    res.intersects
                )
            for i in range(0, len(pending), self.batch_max):
                chunk = pending[i:i + self.batch_max]
                # Trace re-adoption follows the drain's batching rule: a
                # single-entry chunk re-solves entirely under its journaled
                # trace; a fused chunk keeps batch-level attribution.
                replay_ctx = (
                    TraceContext.from_env(chunk[0]["trace"])  # type: ignore[arg-type]
                    if len(chunk) == 1 and chunk[0]["trace"] else None
                )
                try:
                    with rec.adopted(replay_ctx):
                        results = self._check_many(
                            [p["fbas"] for p in chunk],
                            self._make_backend(None),
                        )
                except Exception as exc:  # noqa: BLE001 — replay must not block startup
                    for p in chunk:
                        rid = str(p["entry"].get("request_id"))
                        report["errors"][rid] = (  # type: ignore[index]
                            f"{type(exc).__name__}: {exc}"
                        )
                        still_pending.append(p["entry"])  # type: ignore[arg-type]
                    rec.add("serve.replay_errors")
                    continue
                for p, res in zip(chunk, results):
                    rid = str(p["entry"].get("request_id"))
                    fp = str(p["fingerprint"])
                    with self._lock:
                        self._cache[fp] = res
                        self._cache.move_to_end(fp)
                        while len(self._cache) > self.cache_max:
                            self._cache.popitem(last=False)
                    self._journal.append_done(
                        rid, fp, "verdict", bool(res.intersects),
                    )
                    rec.add("serve.journal_replayed")
                    report["verdicts"][rid] = bool(  # type: ignore[index]
                        res.intersects
                    )
        # Compact: resolved pairs drop out, unresolved req entries survive
        # for the next restart's replay.
        self._journal.compact(still_pending)
        rec.event(
            "serve.replay_done", replayed=len(report["verdicts"]),  # type: ignore[arg-type]
            errors=len(report["errors"]),  # type: ignore[arg-type]
        )
        log.info(
            "journal replay complete: %d replayed, %d already done, %d "
            "quarantined", len(report["verdicts"]),  # type: ignore[arg-type]
            report["already_done"], report["quarantined"],
        )
        return report


def _qset_raw(q: Optional[QSet]) -> Optional[Dict[str, object]]:
    """Stellarbeat-shaped dict of one parsed QSet (``None`` for the
    never-satisfiable null qset) — the inverse of ``schema._parse_qset``."""
    if q is None or q.threshold is None:
        return None
    return {
        "threshold": q.threshold,
        "validators": list(q.validators),
        "innerQuorumSets": [_qset_raw(iq) for iq in q.inner],
    }


def _raw_nodes(
    source: Union[str, bytes, List[Dict[str, object]], Fbas],
    fbas: Fbas,
) -> List[Dict[str, object]]:
    """The raw node list to journal for ``source`` (re-parsed on replay)."""
    if isinstance(source, list):
        return source
    if isinstance(source, (str, bytes)):
        # parse_fbas already accepted this source, so its top level is a
        # JSON array (anything else raised before we got here).
        data = json.loads(source)
        if isinstance(data, list):
            return data
    # A pre-parsed Fbas: rebuild raw dicts from the parsed nodes —
    # ``parse_fbas(_raw_nodes(...))`` round-trips to the same graph, which
    # is all replay needs.
    return [
        {
            "publicKey": node.public_key,
            "name": node.name,
            "quorumSet": _qset_raw(node.qset),
        }
        for node in fbas
    ]


# ---- CLI subcommand ---------------------------------------------------------
#
# The transports (the stdio loop, the socket server) live in
# serve_transport.py; these wrappers keep the JAX package's import surface
# (`serve.serve_main`) and the cli.py dispatch.


def build_serve_parser() -> argparse.ArgumentParser:
    from quorum_intersection_tpu_torch.serve_transport import build_serve_parser as _build

    return _build()


def serve_main(argv: Optional[List[str]] = None) -> int:
    """The ``serve`` subcommand body (dispatched from cli.py)."""
    from quorum_intersection_tpu_torch.serve_transport import serve_main as _main

    return _main(argv)
