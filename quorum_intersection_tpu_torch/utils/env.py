"""One registry for every ``QI_*`` environment variable the port reads.

Every read goes through :func:`qi_env` against a declared :class:`EnvVar`,
so the catalog below is the documentation, defaults live in one place, and
an undeclared name raises instead of silently reading nothing.  Names,
defaults and descriptions are the JAX package's (its ``utils/env.py``), for
the knobs the port reads; ``tests/test_torch_isolation.py`` scans the port
for any other ``os.environ`` read of a ``QI_*`` key.

Standard library only and below everything else in the import graph
(:mod:`.logging` reads ``QI_LOG_LEVEL`` here while it sets itself up).
Reads are not cached: a test that patches ``os.environ`` sees the next read
change.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class EnvVar:
    """One declared environment knob: its name, default, and contract."""

    name: str
    default: Optional[str]
    description: str


_REGISTRY: Dict[str, EnvVar] = {}


def _declare(name: str, default: Optional[str], description: str) -> EnvVar:
    var = EnvVar(name=name, default=default, description=description)
    _REGISTRY[name] = var
    return var


# ---- the catalog -----------------------------------------------------------

QI_LOG_LEVEL = _declare(
    "QI_LOG_LEVEL", "",
    "Initial log level by name (DEBUG/INFO/WARNING/ERROR/CRITICAL) or "
    "numeric value; the CLI's -t still overrides it (utils/logging.py).",
)
QI_LOG_JSON = _declare(
    "QI_LOG_JSON", "",
    "Truthy: one JSON object per log line, interleavable with the "
    "qi-telemetry/1 stream (utils/logging.py).",
)
QI_METRICS_JSON = _declare(
    "QI_METRICS_JSON", "",
    "Path of a qi-telemetry/1 JSONL stream every process appends to "
    "(utils/telemetry.py env sink; the CLI flag --metrics-json plumbs the "
    "same sink explicitly).",
)
QI_METRICS_PROM = _declare(
    "QI_METRICS_PROM", "",
    "Path of a Prometheus textfile rewritten at process finish "
    "(utils/telemetry.py env sink; CLI flag --metrics-prom).",
)
QI_FRONTIER_CKPT_INTERVAL_S = _declare(
    "QI_FRONTIER_CKPT_INTERVAL_S", "5.0",
    "Frontier checkpoint write cadence in seconds — exists so process-death "
    "tests can shrink the cadence of a CLI child they cannot construct "
    "in-process (backends/frontier.py).",
)
QI_FAULTS = _declare(
    "QI_FAULTS", "",
    "Deterministic fault-injection rules, comma-separated "
    "point=mode[:seconds][@hit[+]] (utils/faults.py — the declared "
    "fault-point catalog and grammar live there).  Empty: no injection, "
    "fault points are near-free.",
)
QI_NATIVE_WATCHDOG_S = _declare(
    "QI_NATIVE_WATCHDOG_S", "0",
    "Deadline in seconds for one in-process native oracle call under the "
    "auto router: past it a monitor trips the CancelToken, and a call "
    "that STILL does not return quarantines the native rung for the run "
    "(backends/auto.py).  0 (default): watchdog off, calls run on the "
    "caller's thread exactly as before.",
)
QI_TRACE_OUT = _declare(
    "QI_TRACE_OUT", "",
    "Path of a Chrome/Perfetto trace-event JSON file the run appends its "
    "spans and events to (utils/telemetry.py ChromeTraceSink; CLI flag "
    "--trace-out).  Multi-process runs share one file — open it in "
    "ui.perfetto.dev to see the whole run as one timeline.",
)
QI_TRACE_CONTEXT = _declare(
    "QI_TRACE_CONTEXT", "",
    "Inherited trace context 'trace_id:span_id:pid' a parent process "
    "exports before spawning children: the child's RunRecord adopts the "
    "trace_id instead of minting its own, so every process of one run "
    "shares a single causal trace (utils/telemetry.py TraceContext).",
)
QI_FLIGHT_RECORDER = _declare(
    "QI_FLIGHT_RECORDER", "",
    "Path the crash flight recorder dumps to: a bounded ring buffer of the "
    "last spans/events is always on, and on fault firing, watchdog trip, "
    "ladder degrade/quarantine, or unhandled exception its tail plus a "
    "counter/gauge snapshot is written crash-only with fsync-before-rename "
    "(utils/telemetry.py dump_flight_recorder).  Empty: dumps disabled, "
    "the ring still records.",
)
QI_DIST_INIT_TIMEOUT_S = _declare(
    "QI_DIST_INIT_TIMEOUT_S", "20",
    "Total time budget for joining the multi-process runtime: "
    "coordinator-join failures retry with backoff under this deadline "
    "before degrading loudly to single-process "
    "(parallel/distributed.py initialize; event "
    "distributed.init_degraded).",
)
QI_SWEEP_ORDER = _declare(
    "QI_SWEEP_ORDER", "",
    "Enumeration-order mode of the exhaustive sweep (backends/sweep.py): "
    "'rank' applies the rank-order permutation (PageRank + top-tier "
    "scores, deterministic tie-break) so low-rank nodes occupy high window "
    "bits and the expected first-hit window of a false verdict shrinks; "
    "empty/'natural' (default) keeps the SCC's natural order.  Verdicts "
    "are order-independent; the permutation is stamped into cert "
    "provenance.",
)
QI_SWEEP_PRUNE = _declare(
    "QI_SWEEP_PRUNE", "",
    "Device-side block-guard pruning of the exhaustive sweep "
    "(backends/sweep.py): any value other than empty or '0' skips window "
    "blocks whose maximal candidate contains no quorum (one "
    "greatest-fixpoint guard per 2^k-window block), booking them as "
    "checkable (prefix, k, rule) entries under the certificate's "
    "windows_pruned_guard ledger term (tools/check_cert.py re-verifies "
    "every block).  Empty/'0' (default): unpruned brute force.",
)
QI_SWEEP_ENGINE = _declare(
    "QI_SWEEP_ENGINE", "",
    "Kernel-engine request of the exhaustive sweep (backends/sweep.py): "
    "'bitset' evaluates candidates by intersect-and-popcount over packed "
    "words, 'pallas' the fused single-kernel engine; empty or anything "
    "else (default) the default engine.  A constructor-supplied engine "
    "wins over the knob; every request still flows through "
    "resolve_engine's documented precedence (sweep.engine_resolved "
    "event).  Verdicts are engine-independent.",
)
QI_QUERY_WHATIF_LIMIT = _declare(
    "QI_QUERY_WHATIF_LIMIT", "512",
    "Most removal subsets one what-if query may expand (query.py): the "
    "k-subset frontier over the candidate validators is truncated at "
    "this bound with a loud result field (truncated: true) — a typed "
    "cap, never an unbounded batch from one request.",
)

QI_DELTA_CACHE_MAX = _declare(
    "QI_DELTA_CACHE_MAX", "4096",
    "Per-SCC verdict-store capacity of the incremental re-analysis "
    "subsystem (delta.py): SCC-local scan and verdict fragments retained "
    "before LRU eviction (delta.store_evictions counter).  0 disables "
    "qi-delta entirely — the serving layer then re-solves every snapshot "
    "from scratch, exactly the pre-delta behavior.",
)
QI_FLEET_STORE_MAX_MB = _declare(
    "QI_FLEET_STORE_MAX_MB", "0",
    "Size budget (megabytes) of the shared SCC-fragment store directory "
    "(delta.py SharedSccStore): past it a publish triggers an "
    "LRU-by-mtime sweep deleting the stalest fragments until the "
    "directory fits again (delta.store_evictions counter + "
    "delta.store_gc event — loud, the fragments re-solve on next miss).  "
    "0 (default): unbounded, the pre-GC behavior.",
)


# The serving layer (serve.py, serve_transport.py, fuse.py, cost.py,
# utils/metrics_server.py).

QI_SERVE_BATCH_MAX = _declare(
    "QI_SERVE_BATCH_MAX", "8",
    "Most solve units one serving drain cycle hands to "
    "pipeline.check_many at once (serve.py): queued compatible requests "
    "accumulate into one batched backend call (which lane-packs "
    "sweep-sized problems together).",
)

QI_SERVE_QUEUE_DEPTH = _declare(
    "QI_SERVE_QUEUE_DEPTH", "64",
    "Admission-queue depth bound of the serving layer (serve.py): a "
    "request arriving with this many solve units already queued is shed "
    "with a typed Overloaded rejection instead of growing the queue "
    "without bound.",
)

QI_SERVE_CACHE_MAX = _declare(
    "QI_SERVE_CACHE_MAX", "1024",
    "Verdict-cache capacity of the serving layer (serve.py): distinct "
    "snapshot fingerprints retained before LRU eviction "
    "(serve.cache_evictions counter).",
)

QI_SERVE_DEADLINE_S = _declare(
    "QI_SERVE_DEADLINE_S", "0",
    "Default per-request deadline budget in seconds for the serving layer "
    "(serve.py): past it an in-flight solve is cancelled through the "
    "CancelToken lattice and the request returns a typed DeadlineExceeded "
    "with its partial-coverage certificate.  0 (default): no deadline.",
)

QI_SERVE_JOURNAL = _declare(
    "QI_SERVE_JOURNAL", "",
    "Path of the serving layer's crash-only request journal (serve.py): "
    "accepted requests are journaled (fsync per entry) before solving and "
    "marked done after, so a hard kill + restart replays in-flight work "
    "with no lost or duplicated verdicts.  Empty (default): journaling "
    "off (the CLI serve subcommand's --journal flag sets it explicitly).",
)

QI_SERVE_FUSE_WINDOW_MS = _declare(
    "QI_SERVE_FUSE_WINDOW_MS", "0",
    "Cross-request pack-fusion window in milliseconds (serve.py qi-fuse): "
    "while positive, the drain accumulates window work from DIFFERENT "
    "requests — intersection SCCs, what-if variants — into one shared "
    "batch former (fuse.py BatchFormer) and dispatches when the estimated "
    "lane tile fills or this deadline-aware timer fires, so mixed traffic "
    "fills the packed kernels' lane tiles instead of dispatching partial packs per "
    "request.  'auto' (qi-cost): the window is chosen each flush cycle by "
    "cost.choose_fuse_window from the pulse queue-wait p99 and the SLO "
    "burn state — hot queue ⇒ short positive window, sparse traffic ⇒ 0 "
    "so latency never pays for an empty wait; every decision is a "
    "serve.fuse_window event and the active value a serve.fuse_window_ms "
    "gauge.  0 (default): fusion off, the byte-compatible legacy drain.",
)

QI_SERVE_BIND = _declare(
    "QI_SERVE_BIND", "127.0.0.1",
    "Bind address of the serve socket transport and the fleet's store "
    "gateway (serve_transport.py SocketServeServer; CLI twin: serve --bind).  Default loopback — binding "
    "a routable address is the explicit multi-host opt-in.",
)

QI_PULSE_SLOW_MS = _declare(
    "QI_PULSE_SLOW_MS", "0",
    "Slow-request exemplar threshold in milliseconds (serve.py, qi-pulse): "
    "a served request whose end-to-end latency exceeds it fires the "
    "pulse.exemplar event + pulse.exemplars counter and dumps a "
    "qi-exemplar/1 record (stage breakdown + flight-recorder tail + trace "
    "identity) to <QI_FLIGHT_RECORDER>.exemplar via the crash-only dump "
    "path (utils/telemetry.py dump_exemplar).  0 (default): exemplars off.",
)

QI_COST_TENANTS_MAX = _declare(
    "QI_COST_TENANTS_MAX", "256",
    "Per-tenant cost table capacity (cost.py qi-cost): the per-client-id "
    "device-cost aggregation tables (local and fleet-merged) keep at most "
    "this many tenants, evicting least-recently-booked beyond it (evictions "
    "are counted on cost.tenants_evicted, never silent).  Bounds serve-tier "
    "memory against client-id cardinality attacks.",
)

QI_SLO = _declare(
    "QI_SLO", "",
    "Declarative SLO targets (cost.py SloPlane): a comma-separated list of "
    "'metric<bound' / 'metric>bound' clauses, e.g. "
    "'serve_e2e_p99_ms<500,pack_fill_pct>60'.  Metric names resolve "
    "against the live gauge registry ('_' also matches '.'); each scrape "
    "of /healthz or /sloz and each adaptive fuse-window decision "
    "evaluates multi-window burn rates (QI_SLO_FAST_S / QI_SLO_SLOW_S) "
    "and emits slo.burn events + the slo.burning gauge.  Empty (default): "
    "SLO plane off.",
)

QI_SLO_FAST_S = _declare(
    "QI_SLO_FAST_S", "300",
    "Fast burn-rate window in seconds (cost.py SloPlane): a target is "
    "fast-burning when at least half the ring samples within this window "
    "violate its bound.  Default 300 (5 minutes).",
)

QI_SLO_SLOW_S = _declare(
    "QI_SLO_SLOW_S", "3600",
    "Slow burn-rate window in seconds (cost.py SloPlane): a target is "
    "slow-burning when at least a tenth of the ring samples within this "
    "window violate its bound; 'burning' requires BOTH windows, so a "
    "recovered metric stops firing as soon as the fast window clears.  "
    "Default 3600 (1 hour).",
)

QI_METRICS_PORT = _declare(
    "QI_METRICS_PORT", "0",
    "TCP port of the live observability endpoint (127.0.0.1): /healthz "
    "serves ladder rung, quarantine state and in-flight packs as JSON, "
    "/readyz serves the serving layer's admission picture (503 while "
    "journal replay is in progress), /metrics serves the Prometheus "
    "encoding of the run record (utils/metrics_server.py).  0 (default): "
    "no server.",
)

QI_FLEET_STORE_DIR = _declare(
    "QI_FLEET_STORE_DIR", "",
    "Directory of the shared SCC-fragment store tier (delta.py "
    "SharedSccStore): set in a serve worker's environment (the fleet "
    "supervisor exports it to every worker it spawns), the per-process "
    "SccVerdictStore reads through to it on every miss and writes every "
    "banked fragment back, so one worker's solve composes into every "
    "worker's certs.  Empty (default): local LRU only.",
)

QI_FLEET_WORKERS = _declare(
    "QI_FLEET_WORKERS", "2",
    "Worker count of the replicated serve tier (fleet.py; CLI twin: "
    "python -m quorum_intersection_tpu_torch fleet -n N): N ServeEngine "
    "workers behind the consistent-hash front door.",
)
QI_FLEET_VNODES = _declare(
    "QI_FLEET_VNODES", "32",
    "Virtual nodes per worker on the fleet's consistent-hash ring "
    "(fleet.py HashRing): more vnodes smooth the key distribution; "
    "join/leave still moves only ~1/N of the fingerprint space.",
)
QI_FLEET_PROBE_INTERVAL_S = _declare(
    "QI_FLEET_PROBE_INTERVAL_S", "0.5",
    "Seconds between fleet health-probe cycles (fleet.py probe loop): "
    "each cycle pings every live worker over its own JSONL pipe and "
    "aggregates the pong snapshots into the fleet /healthz gauges.",
)
QI_FLEET_PROBE_FAILS = _declare(
    "QI_FLEET_PROBE_FAILS", "2",
    "Consecutive failed health probes before the fleet front door evicts "
    "a worker from the ring and replays its unfinished journal on the "
    "peers inheriting its hash range (fleet.py); a dead process is "
    "evicted immediately regardless.",
)
QI_FLEET_RESPAWN_MAX = _declare(
    "QI_FLEET_RESPAWN_MAX", "2",
    "Replacement workers the fleet supervisor may spawn per worker SLOT "
    "after an eviction (fleet.py): each respawn re-inserts a fresh "
    "worker into the consistent-hash ring with bounded exponential "
    "backoff (fleet.respawns counter), so a long-lived fleet does not "
    "shrink until restart.  0: never respawn.",
)
QI_FLEET_TOKEN = _declare(
    "QI_FLEET_TOKEN", "",
    "Shared secret of the multi-host fleet mesh: every socket join "
    "handshake (fleet.py SocketWorker, serve_transport.py hello) and "
    "every store-gateway session carries a SHA-256 digest of it; a "
    "digest mismatch is a TYPED reject (hello_err code bad_token / "
    "store_err), never a silent skew.  Empty (default): unauthenticated "
    "loopback mode — both sides must agree on emptiness too.",
)
QI_FLEET_LEASE_S = _declare(
    "QI_FLEET_LEASE_S", "3.0",
    "Heartbeat lease duration in seconds (fleet.py probe loop): every "
    "answered ping renews a worker's lease; QI_FLEET_PROBE_FAILS "
    "consecutive misses only SUSPECT it (routed around, requests hedged "
    "to the next arc owner), and eviction + journal inheritance waits "
    "for the lease to lapse — a slow link is not a dead worker.  A dead "
    "process is still evicted immediately.",
)
QI_FLEET_SCALE_INTERVAL_S = _declare(
    "QI_FLEET_SCALE_INTERVAL_S", "0",
    "Seconds between elasticity-supervisor evaluations (fleet.py "
    "scale_tick): each evaluation turns the fleet-merged pulse "
    "queue-wait p99 and the SloPlane burn state into a spawn / retire / "
    "hold decision.  0 (default): elasticity off, a fixed-size fleet.",
)
QI_FLEET_SCALE_UP_MS = _declare(
    "QI_FLEET_SCALE_UP_MS", "250",
    "Scale-up threshold (fleet.py elasticity supervisor): when the "
    "fleet-merged pulse.queue_wait_ms p99 exceeds this many ms — or any "
    "declared SLO is burning — and the fleet is below "
    "QI_FLEET_SCALE_MAX, one replacement-machinery spawn is scheduled "
    "(fleet.scale_ups counter + fleet.scaled event).",
)
QI_FLEET_SCALE_DOWN_MS = _declare(
    "QI_FLEET_SCALE_DOWN_MS", "20",
    "Scale-down threshold (fleet.py elasticity supervisor): when the "
    "fleet-merged pulse.queue_wait_ms p99 is below this many ms, no SLO "
    "is burning, and the fleet is above QI_FLEET_SCALE_MIN, one worker "
    "is retired by DRAINING through the journal-inheritance path — "
    "routed around first, gracefully drained, its journal inherited — "
    "never a dropped request.",
)
QI_FLEET_SCALE_MIN = _declare(
    "QI_FLEET_SCALE_MIN", "1",
    "Fleet-size floor of the elasticity supervisor (fleet.py): scale-"
    "down decisions never retire below this many live workers.",
)
QI_FLEET_SCALE_MAX = _declare(
    "QI_FLEET_SCALE_MAX", "8",
    "Fleet-size ceiling of the elasticity supervisor (fleet.py): scale-"
    "up decisions never spawn past this many live workers — a burn "
    "spiral must not fork-bomb the host.",
)
QI_PULSE_AGG = _declare(
    "QI_PULSE_AGG", "1",
    "Fleet metrics aggregation plane (fleet.py): while truthy and not "
    "'0', each health-probe cycle merges the workers' pong-carried "
    "pulse.* histogram snapshots bucket-wise into the front door's "
    "fleet.pulse.* histograms (served on /metrics) and the fleet-wide "
    "fleet.e2e_p99_ms gauge.  '0': per-worker metrics only.",
)
QI_PULSE_BUCKETS = _declare(
    "QI_PULSE_BUCKETS", "",
    "Histogram bucket override (utils/telemetry.py hist_bounds): a "
    "comma-separated ASCENDING list of bucket upper edges in milliseconds "
    "replacing the default log-spaced ladder for every histogram the "
    "process creates.  Must be identical across a fleet — bucket-wise "
    "merging refuses mismatched ladders.  Empty (default): the built-in "
    "ladder; malformed values log and fall back.",
)
QI_NO_COMPILE_CACHE = _declare(
    "QI_NO_COMPILE_CACHE", "",
    "Truthy: reuse no built library across processes — the CUDA kernels "
    "(kernels/build.py) and the g++ oracle and CLI (backends/cpp) build "
    "into a private temporary directory of the process "
    "(utils/compile_cache.py).",
)
QI_SANITIZER = _declare(
    "QI_SANITIZER", "asan",
    "Which sanitizer the instrumented native build uses: 'asan' "
    "(address+undefined, the default), 'tsan' (thread), or 'none' "
    "(sanitized builds refused with a clear error) — "
    "backends/cpp/build_native_cli(sanitize=True).",
)


# ---- reads -----------------------------------------------------------------


def qi_env(name: str) -> str:
    """The declared variable's value (its registered default when unset).

    Raises ``KeyError`` for an undeclared name: a knob that is not in the
    catalog above does not exist.
    """
    var = _REGISTRY.get(name)
    if var is None:
        raise KeyError(
            f"{name!r} is not a declared QI_* environment variable; "
            f"add it to quorum_intersection_tpu_torch/utils/env.py"
        )
    value = os.environ.get(var.name)
    return (var.default or "") if value is None else value


def qi_env_flag(name: str) -> bool:
    """Boolean read: any non-empty value counts as set (``QI_LOG_JSON=0``
    is still truthy)."""
    return bool(qi_env(name))


def qi_env_float(name: str, fallback: Optional[float] = None) -> float:
    """Float read; malformed values fall back to the registered default
    (or ``fallback`` when the default itself is unparseable)."""
    raw = qi_env(name)
    try:
        return float(raw)
    except ValueError:
        default = _REGISTRY[name].default
        try:
            return float(default if default is not None else "")
        except ValueError:
            if fallback is None:
                raise
            return fallback


def qi_env_int(name: str, fallback: Optional[int] = None) -> int:
    """Integer read; malformed values fall back to the registered default
    (or ``fallback`` when the default itself is unparseable)."""
    raw = qi_env(name)
    try:
        return int(raw)
    except ValueError:
        default = _REGISTRY[name].default
        try:
            return int(default if default is not None else "")
        except ValueError:
            if fallback is None:
                raise
            return fallback


def registry() -> Tuple[EnvVar, ...]:
    """The full declared catalog, in declaration order."""
    return tuple(_REGISTRY.values())
