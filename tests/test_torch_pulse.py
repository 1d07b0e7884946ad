"""The fleet's pulse plane in the port against the JAX package's, on the CPU:
twins of ``tests/test_qi_pulse.py``'s histogram merge and fleet classes.

- ``Histogram.merge_wire``, ``set_from_wire`` and ``quantile_ms`` on seeded
  histograms equal the JAX package's exactly, and bounds that differ are
  refused by both;
- a fleet of two in-process workers (``device="cpu"``): one trace from the
  front door's request span to the worker's spans and back on the response,
  the merged ``fleet.pulse.e2e_ms`` equal to the bucket-wise sum of the
  workers' scrapes, a ``pulse.aggregate`` fault degrading only the merged
  view, and ``QI_PULSE_AGG=0`` turning it off.

Every wait has a bound.
"""

import random
import time

import pytest
import torch

from quorum_intersection_tpu.utils import faults as jax_faults
from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu.utils.telemetry import Histogram as JaxHistogram
from quorum_intersection_tpu_torch import cost
from quorum_intersection_tpu_torch.fbas.synth import majority_fbas
from quorum_intersection_tpu_torch.fleet import FleetEngine
from quorum_intersection_tpu_torch.utils import faults, telemetry
from quorum_intersection_tpu_torch.utils.faults import FaultPlan, FaultRule
from quorum_intersection_tpu_torch.utils.metrics_server import healthz_payload
from quorum_intersection_tpu_torch.utils.telemetry import Histogram, TraceContext

torch.set_num_threads(1)


@pytest.fixture
def rec():
    for mod in (faults, jax_faults):
        mod.clear_plan()
    cost.reset_cost_state()
    jax_telemetry.reset_run_record()
    record = telemetry.reset_run_record()
    yield record
    for mod in (faults, jax_faults):
        mod.clear_plan()
    jax_telemetry.reset_run_record()
    telemetry.reset_run_record()


def seeded_pair(seed, bounds=None):
    """The same seeded samples observed into a port and a JAX histogram."""
    rng = random.Random(seed)
    samples = [rng.uniform(0.01, 90000.0) for _ in range(300)] + [rng.expovariate(1 / 50.0) for _ in range(200)]
    port, jax = Histogram("h", bounds=bounds), JaxHistogram("h", bounds=bounds)
    for v in samples:
        port.observe(v)
        jax.observe(v)
    return port, jax


class TestHistogramWire:
    @pytest.mark.parametrize("seed", range(4))
    def test_merge_wire_equals_the_jax_merge(self, seed):
        parts = [seeded_pair(seed * 10 + k) for k in range(3)]
        port_wires = [p.snapshot() for p, _ in parts]
        jax_wires = [j.snapshot() for _, j in parts]
        assert port_wires == jax_wires
        assert Histogram.merge_wire(port_wires) == JaxHistogram.merge_wire(jax_wires)
        assert Histogram.merge_wire([]) == JaxHistogram.merge_wire([])

    @pytest.mark.parametrize("seed", range(3))
    def test_set_from_wire_and_quantiles_equal_the_jax_histogram(self, seed):
        merged = Histogram.merge_wire([seeded_pair(seed + k)[0].snapshot() for k in range(2)])
        port, jax = Histogram("m"), JaxHistogram("m")
        port.set_from_wire(merged)
        jax.set_from_wire(merged)
        assert port.snapshot() == jax.snapshot() == {**merged}
        for pct in (0.0, 1.0, 50.0, 90.0, 99.0, 99.9, 100.0):
            assert port.quantile_ms(pct) == jax.quantile_ms(pct)
        assert port.window_percentile(99.0) == jax.window_percentile(99.0) == 0.0  # the window does not cross
        assert Histogram("e").quantile_ms(99.0) == JaxHistogram("e").quantile_ms(99.0) == 0.0

    def test_mismatched_bounds_are_refused_as_by_jax(self):
        a = Histogram("a", bounds=(1.0, 2.0)).snapshot()
        b = Histogram("b", bounds=(1.0, 3.0)).snapshot()
        for merge in (Histogram.merge_wire, JaxHistogram.merge_wire):
            with pytest.raises(ValueError):
                merge([a, b])
        short = dict(a, counts=[0, 0])
        for merge in (Histogram.merge_wire, JaxHistogram.merge_wire):
            with pytest.raises(ValueError):
                merge([a, short])
        for cls in (Histogram, JaxHistogram):
            with pytest.raises(ValueError):
                cls("t", bounds=(1.0, 2.0)).set_from_wire(b)


class _Fleet:
    def __init__(self, n=2, **kw):
        kw.setdefault("worker_mode", "local")
        kw.setdefault("backend", "python")
        kw.setdefault("probe_interval_s", 0.05)
        kw.setdefault("device", "cpu")
        self.engine = FleetEngine(n, **kw)

    def __enter__(self):
        self.engine.start()
        return self.engine

    def __exit__(self, *exc):
        self.engine.stop(drain=True, timeout=30.0)
        return False


def _wait_for_merge(rec, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snap = rec.histograms_snapshot().get("fleet.pulse.e2e_ms")
        if snap and snap["count"] > 0:
            return snap
        time.sleep(0.05)
    raise AssertionError("the aggregation plane never merged the workers' pulses")


class TestFleetPulse:
    def test_end_to_end_trace_identity(self, rec):
        with _Fleet(2) as fleet:
            resp = fleet.submit(majority_fbas(3), request_id="q1").result(timeout=30.0)
        assert resp.intersects is True
        ctx = TraceContext.from_env(resp.trace)
        assert ctx is not None and ctx.trace_id == rec.trace_id
        req_spans = [sp for sp in rec.spans if sp.name == "fleet.request"]
        assert req_spans and ctx.span_id in {sp.span_id for sp in req_spans}
        admits = [sp for sp in rec.spans if sp.name == "serve.admit" and sp.remote_parent_span == ctx.span_id]
        assert admits and admits[0].trace_id == rec.trace_id
        hists = rec.histograms_snapshot()
        assert hists["pulse.route_ms"]["count"] >= 1 and hists["pulse.fleet_e2e_ms"]["count"] >= 1

    def test_merged_metrics_equal_the_sum_of_worker_scrapes(self, rec):
        with _Fleet(2) as fleet:
            for n in (3, 4, 5, 3):
                fleet.submit(majority_fbas(n)).result(timeout=30.0)
            merged = _wait_for_merge(rec)
            health = fleet.healthz()
        by_pid = {w.get("pid"): w["pulse"]["pulse.e2e_ms"] for w in health["workers"].values()
                  if isinstance(w.get("pulse"), dict) and "pulse.e2e_ms" in w["pulse"]}
        assert by_pid, health
        expected = Histogram.merge_wire(list(by_pid.values()))
        assert (merged["counts"], merged["count"]) == (expected["counts"], expected["count"])
        assert abs(merged["sum"] - expected["sum"]) < 1e-6
        assert JaxHistogram.merge_wire(list(by_pid.values())) == expected
        gauges = rec.snapshot()[1]
        assert gauges["fleet.e2e_p99_ms"] > 0
        assert healthz_payload()["fleet_e2e_p99_ms"] == gauges["fleet.e2e_p99_ms"]

    def test_pulse_aggregate_fault_degrades_not_verdicts(self, rec):
        faults.install_plan(FaultPlan([FaultRule("pulse.aggregate", "error", first=1, every=True)]))
        with _Fleet(2) as fleet:
            verdicts = [fleet.submit(majority_fbas(n)).result(timeout=30.0).intersects for n in (3, 4)]
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not rec.snapshot()[0].get("pulse.agg_errors"):
                time.sleep(0.05)
        assert verdicts == [True, True]
        assert rec.snapshot()[0].get("pulse.agg_errors", 0) > 0
        hists = rec.histograms_snapshot()
        assert "fleet.pulse.e2e_ms" not in hists and hists["pulse.e2e_ms"]["count"] > 0

    def test_pulse_agg_off_switch(self, rec, monkeypatch):
        monkeypatch.setenv("QI_PULSE_AGG", "0")
        with _Fleet(2) as fleet:
            fleet.submit(majority_fbas(3)).result(timeout=30.0)
            time.sleep(0.3)  # several probe cycles
        assert "fleet.pulse.e2e_ms" not in rec.histograms_snapshot()
        assert rec.snapshot()[0].get("pulse.agg_errors", 0) == 0
