"""One registry for every named fault point the port can inject at.

The port's copy of the JAX package's ``utils/faults.py``: the same typed
failures, rules, plans and ``QI_FAULTS`` grammar, with the catalog trimmed to
the points the port fires.  Every injectable boundary calls
:func:`fault_point` with a declared name; an undeclared name raises
``KeyError`` even with no plan installed, so a typo fails the first test that
reaches it.  With no plan and ``QI_FAULTS`` unset a point is a dict lookup
and a ``None`` check.

Activation:

- ``QI_FAULTS``: ``point=mode[:seconds][@hit[+]]`` rules, comma-separated —
  ``QI_FAULTS="checkpoint.write=oserror@3"`` fires a disk-full ``OSError`` on
  the third checkpoint write, ``@N+`` fires from the Nth hit on, no ``@``
  fires on every hit;
- :func:`install_plan` — tests install a :class:`FaultPlan` directly.

Modes: ``error`` raises :class:`FaultInjected`, ``oom``
:class:`TransientDeviceFault`, ``oserror`` ``OSError(ENOSPC)``, ``preempt``
:class:`FaultPreempted`, ``hang`` sleeps ``seconds`` (at most
:data:`HANG_CAP_S`).  Every firing lands in the run record (``fault.injected``
event, ``faults.injected`` counter), in the plan's ``fired`` log and, with
``QI_FLIGHT_RECORDER`` set, in a flight-recorder dump.

What a fired point does on the port differs from the JAX package on the
card's paths: a ``sweep.*`` or ``frontier.chunk`` fault fails the solve with
the injected exception; there is no in-place degrade to the unpruned or the
dense encoding and no degrade from the card's rung to the host oracle.  The
host-only points keep the JAX handling (each point's description says it).
"""

from __future__ import annotations

import errno
import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from quorum_intersection_tpu_torch.utils.env import qi_env

log = logging.getLogger("quorum_intersection_tpu_torch.utils.faults")

# Upper bound on an injected hang: a typo'd QI_FAULTS must not wedge a run.
HANG_CAP_S = 30.0


class FaultInjected(RuntimeError):
    """An injected fault fired at a declared point."""

    def __init__(self, point: str, mode: str, hit: int, detail: str = "") -> None:
        self.point = point
        self.mode = mode
        self.hit = hit
        msg = f"injected fault at {point} (mode={mode}, hit {hit})"
        if detail:
            msg = f"{msg}: {detail}"
        super().__init__(msg)


class TransientDeviceFault(FaultInjected):
    """Simulated transient device failure (out of memory); the message
    carries ``RESOURCE_EXHAUSTED`` as the JAX package's does."""

    def __init__(self, point: str, hit: int) -> None:
        super().__init__(point, "oom", hit, "RESOURCE_EXHAUSTED: simulated device out-of-memory")


class FaultPreempted(FaultInjected):
    """Simulated sweep-window preemption (the card was taken away)."""

    def __init__(self, point: str, hit: int) -> None:
        super().__init__(point, "preempt", hit, "window preempted")


# ---- the catalog -----------------------------------------------------------

_POINTS: Dict[str, str] = {}


def _declare(name: str, description: str) -> str:
    _POINTS[name] = description
    return name


CHECKPOINT_WRITE = _declare(
    "checkpoint.write",
    "Checkpoint save (utils/checkpoint.py atomic write): oserror simulates a full disk; the "
    "writer counts it on checkpoint.save_errors and the run goes on.",
)
NATIVE_CALL = _declare(
    "native.call",
    "Entry into the native C++ search (backends/cpp check_scc): error simulates a crashed call "
    "(the auto router degrades to the Python oracle), hang a wedged one (under "
    "QI_NATIVE_WATCHDOG_S the watchdog trips and quarantines the native rung).",
)
NATIVE_BUILD = _declare(
    "native.build",
    "g++ compile of the native oracle (backends/cpp build_library): error simulates a broken "
    "toolchain; the auto router degrades to the Python oracle.",
)
SWEEP_COMPILE = _declare(
    "sweep.compile",
    "First build or load of a sweep kernel library by a backend (backends/sweep.py _bring_up): "
    "error simulates a failed build; the solve fails.",
)
SWEEP_DISPATCH = _declare(
    "sweep.dispatch",
    "Launch of one sweep program (backends/sweep.py, both drives): oom simulates "
    "RESOURCE_EXHAUSTED; the solve fails.",
)
SWEEP_WINDOW = _declare(
    "sweep.window",
    "Sweep window loop (backends/sweep.py, once per dispatched program, both drives): preempt "
    "simulates losing the card mid-enumeration; the solve fails and a recorded checkpoint stays "
    "on disk, so a rerun resumes from it.",
)
SWEEP_PACK = _declare(
    "sweep.pack",
    "Lane-pack assembly of the batched sweep (backends/sweep.py check_sccs, before any pack is "
    "built): error simulates a packing failure; the batch fails.",
)
SWEEP_PRUNE = _declare(
    "sweep.prune",
    "Block-guard prune planning (backends/sweep.py _plan_pruning, once per drive or pack before "
    "any guard runs): error simulates a broken guard path; the solve fails (no in-place degrade "
    "to the unpruned enumeration).",
)
SWEEP_BITSET = _declare(
    "sweep.bitset",
    "Bitset kernel set-up of the sweep (backends/sweep.py, before the bitset kernel's tables are "
    "built, unpacked and packed drives alike): error simulates a broken sparse encoding; the "
    "solve fails (no in-place degrade to the dense encoding).",
)
DISTRIBUTED_INIT = _declare(
    "distributed.init",
    "Coordinator join (parallel/distributed.py initialize): error simulates a dead or unreachable "
    "coordinator; bounded retry under QI_DIST_INIT_TIMEOUT_S, then a loud single-process degrade.",
)
FRONTIER_CHUNK = _declare(
    "frontier.chunk",
    "Frontier chunk dispatch (backends/frontier.py, once per chunk): oom/error simulate a device "
    "failure mid-search; the solve fails.",
)
CERT_WRITE = _declare(
    "cert.write",
    "Verdict-certificate write (cert.py write_certificate, CLI --cert-out): oserror simulates a "
    "full disk; the write is counted on cert.write_errors and the run keeps its verdict.",
)
QUERY_DISPATCH = _declare(
    "query.dispatch",
    "Typed-query dispatch (query.py QueryEngine.resolve, once per non-intersection query before "
    "any resolver runs): error degrades the request to a typed QueryError (query.errors counter, "
    "query.degraded event), never a wrong or absent verdict; the intersection path does not pass "
    "through it.",
)
DELTA_DIFF = _declare(
    "delta.diff",
    "Snapshot diff / SCC-fingerprint path of the incremental re-analysis engine (delta.py "
    "DeltaEngine.check_many): error simulates a broken differ; the engine degrades to the full "
    "re-solve (pipeline.check_many on the same device), verdicts unchanged.  A backend's own "
    "failure inside the incremental solve is not degraded: it fails the call.",
)
FLEET_STORE = _declare(
    "fleet.store",
    "Shared SCC-fragment store tier (delta.py SharedSccStore get/put): error/oserror simulate a "
    "dead shared tier; the store degrades to local-LRU-only (fleet.store_errors counter, loud; "
    "reuse across processes is lost, the verdict is not), and an unparseable or forged fragment "
    "is a miss, never trusted.",
)
FLEET_ROUTE = _declare(
    "fleet.route",
    "Consistent-hash routing decision of the fleet front door (fleet.py FleetEngine._route): error "
    "simulates a broken ring lookup; the request degrades to the first live worker "
    "(fleet.route_errors counter, loud; only fleet-wide coalescing locality is lost), never a "
    "dropped request.",
)
FLEET_PROBE = _declare(
    "fleet.probe",
    "Worker health probe of the fleet supervisor (fleet.py probe loop): error simulates a broken "
    "probe path; the cycle is inconclusive (fleet.probe_errors counter) and no eviction happens on "
    "an injected failure: eviction needs a dead process or consecutive real probe timeouts.",
)
FLEET_REPLAY = _declare(
    "fleet.replay",
    "Dead-worker journal inheritance (fleet.py FleetEngine._failover): error/oserror simulate an "
    "unreadable journal; failover degrades to re-routing the front door's own in-flight tickets "
    "only (fleet.replay_errors counter, loud), never a wrong or duplicated verdict.",
)
FLEET_JOIN = _declare(
    "fleet.join",
    "Socket-worker join handshake of the multi-host fleet (fleet.py FleetEngine._join_worker): "
    "error simulates an unreachable or rejecting peer; the join degrades to bounded backoff and "
    "jitter retries and then to a fleet without that peer (fleet.join_errors counter, "
    "fleet.join_degraded event); a protocol, fingerprint or token mismatch is always a typed "
    "reject, never a silently skewed mesh.",
)
FLEET_LEASE = _declare(
    "fleet.lease",
    "Heartbeat-lease evaluation of the fleet probe loop (fleet.py FleetEngine._expire_leases): "
    "error simulates a broken lease clock; the cycle degrades to suspect-only (fleet.lease_errors "
    "counter, fleet.lease_degraded event): a worker may be hedged around, but an injected lease "
    "failure never evicts it; a dead process is still evicted immediately.",
)
FLEET_HEDGE = _declare(
    "fleet.hedge",
    "Hedged dispatch to a suspected worker's next arc owner (fleet.py FleetEngine._hedge_dispatch): "
    "error simulates a broken hedging path; the request degrades to a single dispatch to the next "
    "live arc owner (fleet.hedge_errors counter, fleet.hedge_degraded event).",
)
FLEET_SHIP = _declare(
    "fleet.ship",
    "Cross-host journal shipping at failover or drain (fleet.py FleetEngine._ship_journal, "
    "serve_transport.py ship_journal): error/oserror simulate a dead wire or a torn stream; "
    "shipping degrades to local-journal-only failover (fleet.ship_errors counter, "
    "fleet.ship_degraded event) while the front door's own in-flight tickets still re-route.",
)
FLEET_SCALE = _declare(
    "fleet.scale",
    "Elasticity decision of the fleet supervisor (fleet.py FleetEngine._apply_scale): error "
    "simulates a broken autoscaler; the fleet stays at its current size (fleet.scale_errors "
    "counter, fleet.scale_degraded event), no verdict and no in-flight request touched.",
)
STORE_FETCH = _declare(
    "store.fetch",
    "Remote SCC-fragment fetch/publish over the store-gateway wire (delta.py RemoteStoreClient): "
    "error/oserror simulate a partitioned or lying store peer; the lookup degrades to a local "
    "solve (store.fetch_errors counter, store.fetch_degraded event), and a torn, corrupt or forged "
    "fragment fails shape validation and is just a miss.",
)
PULSE_AGGREGATE = _declare(
    "pulse.aggregate",
    "Fleet metrics aggregation cycle (fleet.py FleetEngine._aggregate_pulse, once a probe cycle "
    "before the workers' pong-carried pulse histograms merge): error degrades the cycle to "
    "per-worker metrics only (pulse.agg_errors counter, pulse.agg_degraded event); no verdict is "
    "touched.",
)
COST_ATTRIBUTE = _declare(
    "cost.attribute",
    "Per-request device-cost attribution (cost.py: the sweep drive's solo booking and the pack "
    "drain's per-origin booking, the reuse credit of a composed verdict, the serve tenant-table "
    "booking and the SLO burn evaluation): error simulates a broken accounting plane; the step "
    "degrades to no cost (cost.attribute_errors counter, cost.degraded event), never a wrong "
    "verdict.",
)
SERVE_ADMIT = _declare(
    "serve.admit",
    "Request admission into the serving layer (serve.py ServeEngine.submit): error rejects the "
    "request with a typed error, never a silent drop; the queue and every admitted request are "
    "unaffected.",
)
SERVE_CACHE = _declare(
    "serve.cache",
    "Verdict-cache lookup/insert (serve.py): error bypasses the cache for that request "
    "(serve.cache_errors counter) and solves it from scratch.",
)
SERVE_JOURNAL = _declare(
    "serve.journal",
    "Request-journal append (serve.py RequestJournal): oserror simulates a full disk; the write "
    "is counted on serve.journal_errors and the request proceeds un-journaled.",
)
SERVE_DRAIN = _declare(
    "serve.drain",
    "Admission-queue drain into pipeline.check_many (serve.py drain loop): error degrades the "
    "batch to per-request solves on the same backend and device; hang simulates a wedged drain.",
)
SERVE_RESPOND = _declare(
    "serve.respond",
    "Verdict delivery to a waiting client (serve.py): error gives the client a typed error while "
    "the verdict is already cached and journal-marked done, so a retry is a cache hit.",
)
SERVE_FUSE = _declare(
    "serve.fuse",
    "Cross-request batch-former setup in the drain (serve.py _drain_batch, once a drained batch "
    "while QI_SERVE_FUSE_WINDOW_MS is positive): error degrades the batch in place to the "
    "unfused per-batch path (serve.fuse_faults counter, serve.fuse_degraded event).",
)
TELEMETRY_DUMP = _declare(
    "telemetry.dump",
    "Flight-recorder dump write (utils/telemetry.py dump_flight_recorder): oserror simulates a "
    "full disk mid-crash; the dump is counted on telemetry.dump_errors, never a second crash.",
)


def registry() -> Dict[str, str]:
    """The declared catalog, name → description."""
    return dict(_POINTS)


# ---- rules and plans -------------------------------------------------------


@dataclass(frozen=True)
class FaultRule:
    """One activation rule: fire ``mode`` at ``point`` on selected hits."""

    point: str
    mode: str  # error | oom | oserror | hang | preempt
    first: int = 1  # first hit (1-based) the rule fires on
    every: bool = True  # True: every hit >= first; False: exactly `first`
    seconds: float = 0.5  # hang duration (hang mode only)

    def __post_init__(self) -> None:
        if self.point not in _POINTS:
            raise KeyError(f"{self.point!r} is not a declared fault point; add it to "
                           f"quorum_intersection_tpu_torch/utils/faults.py")
        if self.mode not in ("error", "oom", "oserror", "hang", "preempt"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if self.first < 1:
            raise ValueError(f"fault hit index must be >= 1, got {self.first}")

    def applies(self, hit: int) -> bool:
        return hit >= self.first if self.every else hit == self.first

    def spec(self) -> str:
        """Round-trippable ``point=mode[:seconds][@hit[+]]`` form."""
        mode = self.mode if self.mode != "hang" else f"hang:{self.seconds:g}"
        return f"{self.point}={mode}@{self.first}" + ("+" if self.every else "")


class FaultPlan:
    """Installed rules plus per-point hit counters and a firing log;
    thread-safe (the race's worker thread hits points too)."""

    def __init__(self, rules: Sequence[FaultRule], label: str = "") -> None:
        self.rules: Tuple[FaultRule, ...] = tuple(rules)
        self.label = label or ",".join(r.spec() for r in self.rules)
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {}
        self.fired: List[Tuple[str, str, int]] = []

    def hit(self, point: str) -> None:
        """Count a hit at ``point``; fire the first rule that applies."""
        with self._lock:
            n = self.counts.get(point, 0) + 1
            self.counts[point] = n
            rule = next((r for r in self.rules if r.point == point and r.applies(n)), None)
            if rule is not None:
                self.fired.append((point, rule.mode, n))
        if rule is not None:
            self._fire(rule, n)

    def _fire(self, rule: FaultRule, n: int) -> None:
        from quorum_intersection_tpu_torch.utils.telemetry import dump_flight_recorder, get_run_record

        rec = get_run_record()
        rec.add("faults.injected")
        rec.event("fault.injected", point=rule.point, mode=rule.mode, hit=n)
        log.info("fault injected: %s (mode=%s, hit %d)", rule.point, rule.mode, n)
        # The flight recorder goes to disk before the failure is raised; a
        # rule on telemetry.dump fires inside the guarded dump, not here.
        dump_flight_recorder(f"fault:{rule.point}:{rule.mode}")
        if rule.mode == "hang":
            time.sleep(min(max(rule.seconds, 0.0), HANG_CAP_S))
            return
        if rule.mode == "oom":
            raise TransientDeviceFault(rule.point, n)
        if rule.mode == "preempt":
            raise FaultPreempted(rule.point, n)
        if rule.mode == "oserror":
            raise OSError(errno.ENOSPC, f"injected disk full at {rule.point} (hit {n})")
        raise FaultInjected(rule.point, rule.mode, n)


# ---- the active plan -------------------------------------------------------

_PLAN: Optional[FaultPlan] = None
# The parsed QI_FAULTS, keyed by its text: parsed once, yet a changed
# environment takes effect at the next hit.
_env_cache: Tuple[str, Optional[FaultPlan]] = ("", None)


def install_plan(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` process-wide (tests); returns it."""
    global _PLAN
    _PLAN = plan
    log.info("fault plan installed: %s", plan.label)
    return plan


def clear_plan() -> None:
    """Remove an installed plan (``QI_FAULTS`` stays live)."""
    global _PLAN
    _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    """The plan :func:`fault_point` consults, if any: an installed one, else
    the one ``QI_FAULTS`` spells."""
    global _env_cache
    if _PLAN is not None:
        return _PLAN
    raw = qi_env("QI_FAULTS").strip()
    if not raw:
        return None
    if _env_cache[0] != raw:
        _env_cache = (raw, parse_faults(raw))
    return _env_cache[1]


def fault_point(name: str) -> None:
    """Called at every injectable boundary: raises ``KeyError`` for an
    undeclared name even with no plan, else counts the hit and fires the
    rule that applies."""
    if name not in _POINTS:
        raise KeyError(f"{name!r} is not a declared fault point; add it to "
                       f"quorum_intersection_tpu_torch/utils/faults.py")
    plan = active_plan()
    if plan is not None:
        plan.hit(name)


def parse_faults(spec: str) -> FaultPlan:
    """Parse a ``QI_FAULTS`` spec (rules comma- or semicolon-separated)::

        rule := point "=" mode [":" seconds] ["@" hit ["+"]]
        mode := "error" | "oom" | "oserror" | "hang" | "preempt"
    """
    rules: List[FaultRule] = []
    for chunk in spec.replace(";", ",").split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        if "=" not in chunk:
            raise ValueError(f"malformed QI_FAULTS rule {chunk!r} (expected point=mode[:seconds][@hit[+]])")
        point, _, rhs = chunk.partition("=")
        first, every = 1, True
        if "@" in rhs:
            rhs, _, hits = rhs.partition("@")
            hits = hits.strip()
            if hits.endswith("+"):
                hits = hits[:-1]
            else:
                every = False
            first = int(hits)
        seconds = 0.5
        if ":" in rhs:
            rhs, _, secs = rhs.partition(":")
            seconds = float(secs)
        rules.append(FaultRule(point=point.strip(), mode=rhs.strip(), first=first, every=every, seconds=seconds))
    return FaultPlan(rules, label=spec)


# What the chaos schedule draws from: failures on paths the auto router's
# degradation ladder (or the crash-only checkpoint writer) must absorb
# without flipping the verdict (the JAX package's list, in its order).  The
# hang stays sub-second: a soak bounds it by a short native watchdog.
_CHAOS_CHOICES: Tuple[Tuple[str, str, float], ...] = (
    (SWEEP_DISPATCH, "oom", 0.0),
    (SWEEP_WINDOW, "preempt", 0.0),
    (SWEEP_COMPILE, "error", 0.0),
    (NATIVE_CALL, "error", 0.0),
    (NATIVE_CALL, "hang", 0.8),
    (NATIVE_BUILD, "error", 0.0),
    (CHECKPOINT_WRITE, "oserror", 0.0),
    (FRONTIER_CHUNK, "oom", 0.0),
)


def sample_plan(seed: int) -> FaultPlan:
    """A deterministic fault schedule drawn from ``seed`` (the JAX package's
    draw: same seed, same rules in the same order with the same hit
    selectors, so a chaos run with the same seed replays the schedule)."""
    rng = random.Random(seed)
    n_rules = 1 if rng.random() < 0.7 else 2
    picks = rng.sample(range(len(_CHAOS_CHOICES)), n_rules)
    rules = []
    for ix in picks:
        point, mode, seconds = _CHAOS_CHOICES[ix]
        # Biased toward the first hit and toward every-hit rules: a small run
        # reaches most points once or twice, and a rule that never fires
        # tests nothing.
        first = 1 if rng.random() < 0.6 else rng.randint(2, 3)
        every = rng.random() < 0.7
        rules.append(FaultRule(point=point, mode=mode, first=first, every=every, seconds=seconds))
    return FaultPlan(rules, label=f"chaos(seed={seed})")


# What the serving chaos schedule draws from: the serve.* boundaries plus the
# delta and card points a served request crosses.
_SERVE_CHAOS_CHOICES: Tuple[Tuple[str, str, float], ...] = (
    (SERVE_ADMIT, "error", 0.0),
    (SERVE_CACHE, "error", 0.0),
    (SERVE_JOURNAL, "oserror", 0.0),
    (SERVE_DRAIN, "error", 0.0),
    (SERVE_DRAIN, "hang", 0.2),
    (SERVE_RESPOND, "error", 0.0),
    (DELTA_DIFF, "error", 0.0),
    (NATIVE_CALL, "error", 0.0),
    (SWEEP_DISPATCH, "oom", 0.0),
)


def sample_serve_plan(seed: int) -> FaultPlan:
    """A deterministic serving-layer fault schedule drawn from ``seed`` (the
    JAX package's draw: same seed, same rules, same firing sequence)."""
    rng = random.Random(seed)
    n_rules = 1 if rng.random() < 0.6 else 2
    picks = rng.sample(range(len(_SERVE_CHAOS_CHOICES)), n_rules)
    rules = []
    for ix in picks:
        point, mode, seconds = _SERVE_CHAOS_CHOICES[ix]
        first = 1 if rng.random() < 0.6 else rng.randint(2, 3)
        every = rng.random() < 0.5
        rules.append(FaultRule(point=point, mode=mode, first=first, every=every, seconds=seconds))
    return FaultPlan(rules, label=f"serve-chaos(seed={seed})")


# What the fleet chaos schedule draws from: the fleet.* boundaries plus the
# serve and delta points a routed request crosses inside its worker (the JAX
# package's list, in its order).
_FLEET_CHAOS_CHOICES: Tuple[Tuple[str, str, float], ...] = (
    (FLEET_ROUTE, "error", 0.0),
    (FLEET_PROBE, "error", 0.0),
    (FLEET_REPLAY, "error", 0.0),
    (FLEET_STORE, "error", 0.0),
    (FLEET_STORE, "oserror", 0.0),
    (FLEET_JOIN, "error", 0.0),
    (FLEET_LEASE, "error", 0.0),
    (FLEET_HEDGE, "error", 0.0),
    (FLEET_SHIP, "error", 0.0),
    (FLEET_SCALE, "error", 0.0),
    (STORE_FETCH, "error", 0.0),
    (STORE_FETCH, "oserror", 0.0),
    (SERVE_CACHE, "error", 0.0),
    (SERVE_JOURNAL, "oserror", 0.0),
    (DELTA_DIFF, "error", 0.0),
)

# What the socket-mesh schedule draws from: the wire-tier boundaries only.
_MESH_CHAOS_CHOICES: Tuple[Tuple[str, str, float], ...] = (
    (FLEET_JOIN, "error", 0.0),
    (FLEET_LEASE, "error", 0.0),
    (FLEET_SHIP, "error", 0.0),
)


def sample_mesh_plan(seed: int) -> FaultPlan:
    """A deterministic socket-mesh fault schedule drawn from ``seed``
    (``fleet.join``, ``fleet.lease``, ``fleet.ship``; the JAX package's draw)."""
    rng = random.Random(seed * 53 + 11)
    n_rules = 1 if rng.random() < 0.5 else 2
    picks = rng.sample(range(len(_MESH_CHAOS_CHOICES)), n_rules)
    rules = []
    for ix in picks:
        point, mode, seconds = _MESH_CHAOS_CHOICES[ix]
        first = 1 if rng.random() < 0.6 else rng.randint(2, 3)
        every = rng.random() < 0.6
        rules.append(FaultRule(point=point, mode=mode, first=first, every=every, seconds=seconds))
    return FaultPlan(rules, label=f"mesh-chaos(seed={seed})")


def sample_fleet_plan(seed: int) -> FaultPlan:
    """A deterministic fleet-tier fault schedule drawn from ``seed`` (the JAX
    package's draw: same seed, same rules, same firing sequence)."""
    rng = random.Random(seed * 31 + 7)
    n_rules = 1 if rng.random() < 0.5 else 2
    picks = rng.sample(range(len(_FLEET_CHAOS_CHOICES)), n_rules)
    rules = []
    for ix in picks:
        point, mode, seconds = _FLEET_CHAOS_CHOICES[ix]
        first = 1 if rng.random() < 0.6 else rng.randint(2, 3)
        every = rng.random() < 0.6
        rules.append(FaultRule(point=point, mode=mode, first=first, every=every, seconds=seconds))
    return FaultPlan(rules, label=f"fleet-chaos(seed={seed})")
