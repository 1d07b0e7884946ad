"""qi-cost/1: per-request device-cost attribution, tenants, and SLOs.

The port of the JAX package's ``cost.py``.  Quorum intersection is NP-hard,
so a request's device cost varies by orders of magnitude across a serve
stream, and since the serving layer fuses sweeps of different requests into
one lane pack (``fuse.py``), a dispatch no longer belongs to one request.
This module books it back:

- **Attribution** (:func:`pack_lane_shares`, :func:`attribute_pack`,
  :func:`solo_cost`, :func:`reuse_credit`): the sweep's pack drain books,
  per origin request, the lanes it occupied (with its integer share of the
  pack's padding), the windows swept, the MACs of the
  ``macs_per_candidate_row`` shape model, and the dispatch wall pro-rated by
  lane occupancy.  The conserved quantity is **lane-windows**: the attributed
  lane-windows of a pack's origins sum to the pack's total exactly (integer
  shares, asserted).  A delta-reused SCC books a reuse credit; a cancelled
  lane stays booked to the request that retired it.
- **Tenants** (:class:`TenantTable`): costs ride ``SolveResult.stats`` into
  ``cert.provenance.cost`` and the serve wire, and add up per client id in a
  bounded LRU table (``QI_COST_TENANTS_MAX``).
- **SLO plane** (:class:`SloPlane`): declarative targets
  (``QI_SLO="serve_e2e_p99_ms<500,..."``) evaluated lazily at each
  ``/healthz`` or ``/sloz`` scrape and each adaptive fuse-window decision,
  over a :class:`~quorum_intersection_tpu_torch.utils.telemetry.SnapshotRing`:
  a target burns when the violating share of samples is high in both the
  fast (``QI_SLO_FAST_S``) and the slow (``QI_SLO_SLOW_S``) window.
  Transitions emit ``slo.burn`` events; the ``slo.burning`` gauge counts the
  targets burning now.
- **Closed loop** (:func:`choose_fuse_window`): under
  ``QI_SERVE_FUSE_WINDOW_MS=auto`` the serving layer picks the batch
  former's window each flush cycle from the queue-wait p99 and the burn
  state.

Every step degrades through the ``cost.attribute`` fault point: a wrong cost
becomes a dropped cost (``cost.attribute_errors`` counter, ``cost.degraded``
event), never a wrong verdict.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from quorum_intersection_tpu_torch.utils.env import (
    qi_env, qi_env_float, qi_env_int,
)
from quorum_intersection_tpu_torch.utils.faults import FaultInjected, fault_point
from quorum_intersection_tpu_torch.utils.logging import get_logger
from quorum_intersection_tpu_torch.utils.telemetry import (
    SnapshotRing, get_run_record, register_final_lines,
)

log = get_logger("cost")

COST_SCHEMA = "qi-cost/1"
SLO_SCHEMA = "qi-slo/1"

# Burn-rate thresholds: the violating fraction of ring samples within the
# fast window must reach 1/2 AND within the slow window 1/10 for a target
# to burn — the classic multiwindow discipline (fast window for response
# time, slow window so a single spike cannot page).
FAST_BURN_FRACTION = 0.5
SLOW_BURN_FRACTION = 0.1

# Adaptive fuse-window bounds (milliseconds): the controller never waits
# longer than the cap even under a deep queue, never shorter than the
# floor once it decides to wait at all, and clamps to the burn cap while
# any SLO target is burning (a burning latency budget buys no batching).
AUTO_WINDOW_CAP_MS = 25.0
AUTO_WINDOW_FLOOR_MS = 1.0
AUTO_WINDOW_BURN_CAP_MS = 2.0

# Deterministic-schedule hook (the qi-fuse discipline): when set, called with a named sync point at every adaptive
# window decision so the harness can force queue states under it.
_cost_sync: Optional[Callable[[str], None]] = None


def _sync(point: str) -> None:
    hook = _cost_sync
    if hook is not None:
        hook(point)


# ---- attribution -----------------------------------------------------------


def pack_lane_shares(n_lanes: int, slot: int, k: int) -> List[int]:
    """Integer per-group lane shares summing to ``n_lanes`` exactly.

    A pack of ``k`` groups ladders each member up to ``slot`` lanes
    (``n_raw = k·slot``) and then pads the whole circuit up to the lane
    tile (``pad = n_lanes − k·slot ≥ 0``).  The pad belongs to nobody, so
    it is distributed in integer parts: ``pad // k`` to every group plus
    one extra lane to the first ``pad % k`` groups.  Conservation holds by
    construction — and is asserted anyway, because the invariant is the
    whole point."""
    if k <= 0:
        raise ValueError(f"pack_lane_shares: k must be positive, got {k}")
    pad = n_lanes - k * slot
    if pad < 0:
        raise ValueError(
            f"pack_lane_shares: n_lanes={n_lanes} < k*slot={k * slot}"
        )
    base, extra = divmod(pad, k)
    shares = [slot + base + (1 if gix < extra else 0) for gix in range(k)]
    assert sum(shares) == n_lanes, (shares, n_lanes, slot, k)
    return shares


def attribute_pack(group_origins: Sequence[object], n_lanes: int, slot: int,
                   pack_rows: int, macs_per_row: int,
                   seconds: float) -> Dict[object, Dict[str, object]]:
    """Book one fused pack's device work to its origin requests.

    ``group_origins`` is the origin key of each lane group in pack order
    (a retired/cancelled group keeps its origin — dead lanes book to the
    request that cancelled them).  Returns origin → cost dict; the sum of
    ``lane_windows`` across origins equals ``n_lanes · pack_rows``
    exactly (the qi-cost conservation invariant, asserted)."""
    k = len(group_origins)
    shares = pack_lane_shares(n_lanes, slot, k)
    per_origin: "OrderedDict[object, Dict[str, object]]" = OrderedDict()
    for gix, origin in enumerate(group_origins):
        row = per_origin.get(origin)
        if row is None:
            row = per_origin[origin] = {
                "schema": COST_SCHEMA,
                "fused": True,
                "lanes": 0,
                "groups": 0,
                "windows": int(pack_rows),
                "lane_windows": 0,
                "macs": 0,
                "device_s": 0.0,
            }
        row["lanes"] = int(row["lanes"]) + shares[gix]
        row["groups"] = int(row["groups"]) + 1
    total = 0
    for row in per_origin.values():
        lanes = int(row["lanes"])
        row["lane_windows"] = lanes * int(pack_rows)
        total += int(row["lane_windows"])
        if n_lanes > 0:
            frac = lanes / float(n_lanes)
            row["macs"] = int(round(macs_per_row * int(pack_rows) * frac))
            row["device_s"] = round(float(seconds) * frac, 9)
    assert total == n_lanes * int(pack_rows), (
        "qi-cost conservation violated: "
        f"attributed {total} != pack total {n_lanes * int(pack_rows)}"
    )
    return dict(per_origin)


def solo_cost(n_lanes: int, candidates: int, macs_per_row: int,
              seconds: float) -> Dict[str, object]:
    """The unfused (one request per dispatch) cost: the whole device."""
    return {
        "schema": COST_SCHEMA,
        "fused": False,
        "lanes": int(n_lanes),
        "groups": 1,
        "windows": int(candidates),
        "lane_windows": int(n_lanes) * int(candidates),
        "macs": int(macs_per_row) * int(candidates),
        "device_s": round(float(seconds), 9),
    }


def reuse_credit(cached_cost: Optional[Dict[str, object]]) -> Dict[str, object]:
    """The cost of a delta-reused SCC: zero new device work plus a
    *credit* — the lane·windows the reuse avoided re-sweeping (what the
    cached solve booked, when it carried a cost)."""
    credit = 0
    if isinstance(cached_cost, dict):
        try:
            credit = int(cached_cost.get("lane_windows") or 0)
        except (TypeError, ValueError):
            credit = 0
    return {
        "schema": COST_SCHEMA,
        "fused": False,
        "reused": True,
        "lanes": 0,
        "groups": 0,
        "windows": 0,
        "lane_windows": 0,
        "macs": 0,
        "device_s": 0.0,
        "credit_lane_windows": credit,
    }


def merge_costs(parts: Sequence[Dict[str, object]]) -> Dict[str, object]:
    """Sum cost dicts (a serve request solving several SCCs books one
    combined cost).  ``fused`` is true when any part was fused."""
    out: Dict[str, object] = {
        "schema": COST_SCHEMA, "fused": False, "lanes": 0, "groups": 0,
        "windows": 0, "lane_windows": 0, "macs": 0, "device_s": 0.0,
    }
    credit = 0
    reused = False
    for part in parts:
        if not isinstance(part, dict):
            continue
        out["fused"] = bool(out["fused"]) or bool(part.get("fused"))
        for key in ("lanes", "groups", "windows", "lane_windows", "macs"):
            try:
                out[key] = int(out[key]) + int(part.get(key) or 0)  # type: ignore[arg-type]
            except (TypeError, ValueError):
                pass
        try:
            out["device_s"] = round(
                float(out["device_s"]) + float(part.get("device_s") or 0.0), 9)  # type: ignore[arg-type]
        except (TypeError, ValueError):
            pass
        try:
            credit += int(part.get("credit_lane_windows") or 0)
        except (TypeError, ValueError):
            pass
        reused = reused or bool(part.get("reused"))
    if credit:
        out["credit_lane_windows"] = credit
    if reused:
        out["reused"] = True
    return out


# ---- per-tenant tables -----------------------------------------------------

_TENANT_INT_FIELDS = ("requests", "lane_windows", "macs",
                      "credit_lane_windows")


class TenantTable:
    """Bounded per-client-id cost aggregation (LRU on booking order).

    Capacity comes from ``QI_COST_TENANTS_MAX`` at construction/reset —
    bounded so client-id cardinality cannot grow serve-tier memory;
    evictions count on ``cost.tenants_evicted``, never silent."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._rows: "OrderedDict[str, Dict[str, object]]" = OrderedDict()
        self._capacity = (int(capacity) if capacity is not None
                          else max(1, qi_env_int("QI_COST_TENANTS_MAX")))

    def book(self, client: str, cost: Optional[Dict[str, object]]) -> None:
        """Accumulate one request's cost under ``client`` (LRU-touch)."""
        tenant = str(client or "anon")
        evicted = 0
        with self._lock:
            row = self._rows.pop(tenant, None)
            if row is None:
                row = {f: 0 for f in _TENANT_INT_FIELDS}
                row["device_s"] = 0.0
            self._rows[tenant] = row
            row["requests"] = int(row["requests"]) + 1  # type: ignore[arg-type]
            if isinstance(cost, dict):
                for key in ("lane_windows", "macs", "credit_lane_windows"):
                    try:
                        row[key] = int(row[key]) + int(cost.get(key) or 0)  # type: ignore[arg-type]
                    except (TypeError, ValueError):
                        pass
                try:
                    row["device_s"] = round(
                        float(row["device_s"])  # type: ignore[arg-type]
                        + float(cost.get("device_s") or 0.0), 9)
                except (TypeError, ValueError):
                    pass
            while len(self._rows) > self._capacity:
                self._rows.popitem(last=False)
                evicted += 1
        if evicted:
            get_run_record().add("cost.tenants_evicted", evicted)

    def replace(self, rows: Dict[str, Dict[str, object]]) -> None:
        """Overwrite with merged snapshots (the fleet front door's move —
        pong snapshots are cumulative, so the merge REPLACES each cycle;
        accumulating them would double-count every prior cycle)."""
        capped = list(rows.items())[-self._capacity:]
        fresh: "OrderedDict[str, Dict[str, object]]" = OrderedDict()
        for tenant, row in capped:
            fresh[str(tenant)] = dict(row)
        with self._lock:
            self._rows = fresh

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            return {t: dict(r) for t, r in self._rows.items()}

    def top(self, n: int) -> List[Tuple[str, Dict[str, object]]]:
        """The ``n`` costliest tenants by lane·windows (ties: requests)."""
        snap = self.snapshot()
        ranked = sorted(
            snap.items(),
            key=lambda kv: (int(kv[1].get("lane_windows") or 0),
                            int(kv[1].get("requests") or 0)),
            reverse=True,
        )
        return ranked[:max(0, int(n))]

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()
            self._capacity = max(1, qi_env_int("QI_COST_TENANTS_MAX"))

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)


def merge_tenant_snapshots(
        parts: Sequence[Dict[str, Dict[str, object]]],
) -> Dict[str, Dict[str, object]]:
    """Sum per-tenant rows across worker snapshots (one per distinct
    worker process — the caller pid-dedupes, this just adds)."""
    merged: Dict[str, Dict[str, object]] = {}
    for part in parts:
        if not isinstance(part, dict):
            continue
        for tenant, row in part.items():
            if not isinstance(row, dict):
                continue
            agg = merged.setdefault(
                str(tenant),
                {**{f: 0 for f in _TENANT_INT_FIELDS}, "device_s": 0.0},
            )
            for key in _TENANT_INT_FIELDS:
                try:
                    agg[key] = int(agg[key]) + int(row.get(key) or 0)  # type: ignore[arg-type]
                except (TypeError, ValueError):
                    pass
            try:
                agg["device_s"] = round(
                    float(agg["device_s"])  # type: ignore[arg-type]
                    + float(row.get("device_s") or 0.0), 9)
            except (TypeError, ValueError):
                pass
    return merged


_TENANTS = TenantTable()
_FLEET_TENANTS = TenantTable()


def tenant_table() -> TenantTable:
    """This process's per-tenant table (what pongs snapshot)."""
    return _TENANTS


def fleet_tenant_table() -> TenantTable:
    """The fleet-merged view (the fleet front door's; empty elsewhere)."""
    return _FLEET_TENANTS


# ---- SLO plane -------------------------------------------------------------

# Friendly SLO metric names → the live gauge names they mean.  Beyond the
# aliases, resolution also tries the name verbatim and with '_' read as
# '.' (gauges first, then counters).
_METRIC_ALIASES: Dict[str, str] = {
    "serve_e2e_p99_ms": "serve.p99_ms",
    "serve_e2e_p50_ms": "serve.p50_ms",
}


@dataclass(frozen=True)
class SloTarget:
    """One parsed ``QI_SLO`` clause: ``metric OP bound``."""
    metric: str
    op: str           # '<' (stay under) or '>' (stay over)
    bound: float

    def violated(self, value: float) -> bool:
        return value >= self.bound if self.op == "<" else value <= self.bound


def parse_slo(spec: str) -> List[SloTarget]:
    """Parse ``"serve_e2e_p99_ms<500,pack_fill_pct>60"``; malformed
    clauses log and are skipped (a broken SLO spec must not break
    serving)."""
    targets: List[SloTarget] = []
    for clause in (spec or "").split(","):
        clause = clause.strip()
        if not clause:
            continue
        for op in ("<", ">"):
            metric, sep, bound = clause.partition(op)
            if sep and metric.strip():
                try:
                    targets.append(SloTarget(metric.strip(), op,
                                             float(bound.strip())))
                except ValueError:
                    log.warning("QI_SLO: unparseable bound in %r; skipped",
                                clause)
                break
        else:
            log.warning("QI_SLO: clause %r has no '<'/'>' operator; skipped",
                        clause)
    return targets


def _resolve_metric(name: str, counters: Dict[str, float],
                    gauges: Dict[str, object]) -> Optional[float]:
    candidates = [name]
    alias = _METRIC_ALIASES.get(name)
    if alias:
        candidates.append(alias)
    dotted = name.replace("_", ".")
    if dotted != name:
        candidates.append(dotted)
    for cand in candidates:
        for table in (gauges, counters):
            if cand in table:
                try:
                    return float(table[cand])  # type: ignore[arg-type]
                except (TypeError, ValueError):
                    continue
    return None


class SloPlane:
    """Multiwindow burn-rate evaluation over a metric snapshot ring.

    Lazy: :meth:`evaluate` runs on each ``/healthz`` / ``/sloz`` scrape
    and each adaptive fuse-window decision — no background thread.  Each
    call samples the live gauges/counters for every target's metric,
    records the sample into the ring, and answers per-target fast/slow
    violating fractions.  The clock is injectable so tests replay hours
    in microseconds."""

    def __init__(self, spec: Optional[str] = None,
                 fast_s: Optional[float] = None,
                 slow_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 ring: Optional[SnapshotRing] = None) -> None:
        self.targets = parse_slo(qi_env("QI_SLO") if spec is None else spec)
        self.fast_s = (qi_env_float("QI_SLO_FAST_S")
                       if fast_s is None else float(fast_s))
        self.slow_s = (qi_env_float("QI_SLO_SLOW_S")
                       if slow_s is None else float(slow_s))
        self._clock = clock or time.monotonic
        self.ring = ring if ring is not None else SnapshotRing(
            clock=self._clock)
        self._burning: set = set()
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(self.targets)

    def _ratio(self, target: SloTarget,
               samples: List[Tuple[float, Dict[str, float]]]) -> Tuple[float, int]:
        seen = 0
        bad = 0
        for _, values in samples:
            value = values.get(target.metric)
            if value is None:
                continue
            seen += 1
            if target.violated(value):
                bad += 1
        return ((bad / seen) if seen else 0.0, seen)

    def evaluate(self, now: Optional[float] = None) -> Dict[str, object]:
        """One lazy evaluation cycle: sample → ring → burn rates →
        events/gauge.  Failures degrade through ``cost.attribute`` (a
        broken SLO evaluator must not break the scrape, let alone a
        verdict)."""
        rec = get_run_record()
        status: Dict[str, object] = {
            "schema": SLO_SCHEMA,
            "enabled": self.enabled,
            "fast_window_s": self.fast_s,
            "slow_window_s": self.slow_s,
            "targets": [],
            "burning": 0,
        }
        if not self.enabled:
            return status
        try:
            fault_point("cost.attribute")
            counters, gauges = rec.snapshot()
            sample: Dict[str, float] = {}
            for target in self.targets:
                value = _resolve_metric(target.metric, counters, gauges)
                if value is not None:
                    sample[target.metric] = value
            t = self.ring.record(sample, t=now)
            fast = self.ring.window(self.fast_s, now=t)
            slow = self.ring.window(self.slow_s, now=t)
            burning_now = 0
            rows: List[Dict[str, object]] = []
            with self._lock:
                for target in self.targets:
                    fast_ratio, fast_n = self._ratio(target, fast)
                    slow_ratio, slow_n = self._ratio(target, slow)
                    burning = (fast_n > 0
                               and fast_ratio >= FAST_BURN_FRACTION
                               and slow_ratio >= SLOW_BURN_FRACTION)
                    key = f"{target.metric}{target.op}{target.bound:g}"
                    if burning and key not in self._burning:
                        rec.event(
                            "slo.burn",
                            metric=target.metric, op=target.op,
                            bound=target.bound,
                            value=sample.get(target.metric),
                            fast_ratio=round(fast_ratio, 4),
                            slow_ratio=round(slow_ratio, 4),
                            fast_samples=fast_n, slow_samples=slow_n,
                        )
                        self._burning.add(key)
                    elif not burning:
                        self._burning.discard(key)
                    if burning:
                        burning_now += 1
                    rows.append({
                        "metric": target.metric,
                        "op": target.op,
                        "bound": target.bound,
                        "value": sample.get(target.metric),
                        "fast_ratio": round(fast_ratio, 4),
                        "slow_ratio": round(slow_ratio, 4),
                        "fast_samples": fast_n,
                        "slow_samples": slow_n,
                        "burning": burning,
                    })
            rec.gauge("slo.burning", burning_now)
            status["targets"] = rows
            status["burning"] = burning_now
        except (FaultInjected, OSError, ValueError) as exc:
            rec.add("cost.attribute_errors")
            rec.event("cost.degraded", site="slo.evaluate", error=repr(exc))
            status["degraded"] = True
        return status

    def burning_count(self) -> int:
        with self._lock:
            return len(self._burning)


_SLO_PLANE: Optional[SloPlane] = None
_SLO_LOCK = threading.Lock()


def slo_plane() -> SloPlane:
    """The process-wide lazily-built plane (spec read at first use)."""
    global _SLO_PLANE
    with _SLO_LOCK:
        if _SLO_PLANE is None:
            _SLO_PLANE = SloPlane()
        return _SLO_PLANE


def reset_cost_state() -> None:
    """Test hook: fresh tenant tables and a re-read SLO plane."""
    global _SLO_PLANE
    _TENANTS.reset()
    _FLEET_TENANTS.reset()
    with _SLO_LOCK:
        _SLO_PLANE = None


# ---- adaptive fuse window (the closed loop) --------------------------------


def choose_fuse_window(queue_depth: int, wait_p99_ms: float,
                       burning: bool) -> float:
    """Pick the BatchFormer window for one flush cycle.

    Sparse traffic (nothing queued beyond this batch) → 0.0: latency
    never pays for an empty wait.  Hot queue → a short positive window
    proportional to the observed queue-wait p99 (a quarter of it, so the
    wait the fusion *adds* stays small against the wait the queue already
    *has*), clamped to [floor, cap].  While any SLO target burns, clamp
    to the burn cap — batching throughput never buys back a burning
    latency budget."""
    _sync("cost.window.decide")
    if queue_depth <= 0:
        return 0.0
    window = min(AUTO_WINDOW_CAP_MS,
                 max(AUTO_WINDOW_FLOOR_MS, float(wait_p99_ms) / 4.0))
    if burning:
        window = min(window, AUTO_WINDOW_BURN_CAP_MS)
    return window


# ---- /sloz -----------------------------------------------------------------


def sloz_payload(top_n: int = 10) -> Dict[str, object]:
    """The ``/sloz`` endpoint body: one SLO evaluation plus the costliest
    tenants, local and fleet-merged."""
    status = slo_plane().evaluate()
    status["tenants"] = {
        "local": [{"client": c, **row} for c, row in tenant_table().top(top_n)],
        "fleet": [{"client": c, **row} for c, row in fleet_tenant_table().top(top_n)],
    }
    return status


# ---- stream export ---------------------------------------------------------


def _tenant_final_lines() -> List[Dict[str, object]]:
    """Finish-time JSONL line: this process's per-tenant cost table, so the
    qi-telemetry stream carries attribution next to the counters it
    conserves against (``tools/metrics_report.py --top N`` renders it).
    Silent when nothing was booked — a pre-cost stream stays
    byte-identical."""
    snap = tenant_table().snapshot()
    if not snap:
        return []
    return [{
        "kind": "tenants",
        "schema": COST_SCHEMA,
        "pid": get_run_record().pid,
        "tenants": snap,
    }]


register_final_lines(_tenant_final_lines)
