"""The port's serving layer on the CPU, admission side: twins of
``tests/test_serve.py``'s ``TestAdmissionAndDeadlines``,
``TestCacheAndCoalesce``, ``TestReadyz`` and ``TestPercentile``, each held to
the JAX engine on the same inputs where the outcome is deterministic
(fingerprints, counters, readiness payloads).  The drain is parked with the
port's own sync hook (``serve._serve_sync``); every wait has a bound.
"""

import json
import time

import pytest
import torch

from quorum_intersection_tpu import serve as jax_serve
from quorum_intersection_tpu.utils import metrics_server as jax_metrics_server
from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu_torch import cost, serve
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.fbas.synth import churn_trace, majority_fbas
from quorum_intersection_tpu_torch.utils import faults, telemetry
from quorum_intersection_tpu_torch.utils.metrics_server import MetricsServer, readyz_payload

from _torch_cases import fixture_data
from _torch_serve_cases import Engine, HeldDrain

torch.set_num_threads(1)


@pytest.fixture
def rec():
    faults.clear_plan()
    cost.reset_cost_state()
    jax_telemetry.reset_run_record()
    record = telemetry.reset_run_record()
    yield record
    faults.clear_plan()
    jax_telemetry.reset_run_record()
    telemetry.reset_run_record()


@pytest.fixture
def held_drain(monkeypatch):
    hold = HeldDrain()
    monkeypatch.setattr(serve, "_serve_sync", hold)
    yield hold
    hold.release.set()


def fingerprint_of(nodes, module=serve):
    if module is serve:
        return serve.snapshot_fingerprint(build_graph(parse_fbas(nodes)))
    from quorum_intersection_tpu.fbas.graph import build_graph as jax_build
    from quorum_intersection_tpu.fbas.schema import parse_fbas as jax_parse

    return jax_serve.snapshot_fingerprint(jax_build(jax_parse(nodes)))


class TestAdmissionAndDeadlines:
    def test_overflow_sheds_typed_and_admitted_still_serve(self, rec, held_drain):
        a, b, c = (majority_fbas(n, prefix=f"ADM{n}") for n in (5, 7, 9))
        with Engine(backend="python", queue_depth=1) as engine:
            t_a = engine.submit(a)
            assert held_drain.popped.wait(10.0)
            t_b = engine.submit(b)
            with pytest.raises(serve.Overloaded) as exc:
                engine.submit(c)
            assert exc.value.code == "overloaded" and exc.value.depth >= exc.value.bound == 1
            held_drain.release.set()
            assert t_a.result(timeout=30.0).intersects is t_b.result(timeout=30.0).intersects is True
        assert rec.counters["serve.shed"] == 1 and rec.counters["serve.requests"] == 3
        assert rec.counters.get("serve.verdicts", 0) + rec.counters.get("serve.errors", 0) == 3

    def test_deadline_expiry_is_typed_never_a_wedge(self, rec, held_drain):
        nodes = majority_fbas(5)
        with Engine(backend="python") as engine:
            ticket = engine.submit(nodes, deadline_s=0.05)
            assert held_drain.popped.wait(10.0)
            while time.monotonic() < ticket.deadline_t:
                time.sleep(0.005)
            held_drain.release.set()
            with pytest.raises(serve.DeadlineExceeded) as exc:
                ticket.result(timeout=30.0)
            assert exc.value.code == "deadline_exceeded" and exc.value.request_id == ticket.request_id
            assert engine.submit(nodes).result(timeout=30.0).intersects is True
        assert rec.counters["serve.deadline_expired"] == 1

    def test_late_coalescer_deadline_enforced_at_delivery(self, rec, held_drain):
        nodes = majority_fbas(9)
        with Engine(backend="python") as engine:
            t_a = engine.submit(nodes)
            assert held_drain.popped.wait(10.0)
            t_b = engine.submit(nodes, deadline_s=0.05)
            while time.monotonic() < t_b.deadline_t:
                time.sleep(0.005)
            held_drain.release.set()
            assert t_a.result(timeout=30.0).intersects is True
            with pytest.raises(serve.DeadlineExceeded):
                t_b.result(timeout=30.0)
            assert engine.submit(nodes).result(timeout=30.0).cached is True

    def test_no_drain_stop_resolves_queued_tickets_typed(self, rec, held_drain):
        engine = serve.ServeEngine(backend="python", device="cpu")
        engine.start()
        try:
            t_inflight = engine.submit(majority_fbas(5, prefix="STA"))
            assert held_drain.popped.wait(10.0)
            t_queued = engine.submit(majority_fbas(7, prefix="STB"))
            engine.stop(drain=False, timeout=0.1)
            with pytest.raises(serve.ServeClosed):
                t_queued.result(timeout=10.0)
        finally:
            held_drain.release.set()
            engine.stop(drain=False, timeout=30.0)
        assert t_inflight.result(timeout=30.0).intersects is True
        assert rec.counters["serve.errors"] == 1 and rec.counters["serve.verdicts"] == 1

    def test_no_card_is_refused_before_admission(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            serve.ServeEngine(backend="gpu-sweep")


class TestCacheAndCoalesce:
    def test_repeat_snapshot_is_a_cache_hit(self, rec):
        nodes = majority_fbas(7)
        with Engine(backend="python") as engine:
            first = engine.submit(nodes).result(timeout=30.0)
            second = engine.submit(nodes).result(timeout=30.0)
        assert first.cached is False and second.cached is True and second.intersects is first.intersects
        assert second.cert["provenance"]["serve"]["cached"] is True
        assert rec.counters["serve.cache_hits"] == 1

    @pytest.mark.parametrize("source", ["majority", "churn", "snapshot_broken", "nested_correct"])
    def test_fingerprint_is_the_jax_packages(self, source):
        """The cache key and the journal's identity: byte-equal to the JAX
        package's, so one journal replays in either package."""
        if source == "majority":
            snaps = [majority_fbas(n, broken=b) for n in (5, 9) for b in (False, True)]
        elif source == "churn":
            snaps = churn_trace(majority_fbas(9), 4, seed=5)
        else:
            snaps = [fixture_data(f"{source}.json")]
        for nodes in snaps:
            assert fingerprint_of(nodes) == fingerprint_of(nodes, jax_serve)

    def test_cosmetic_churn_hits_same_fingerprint(self):
        nodes = majority_fbas(7)
        renamed = json.loads(json.dumps(nodes))
        renamed[0]["name"] = "renamed-for-cosmetics"
        assert fingerprint_of(nodes) == fingerprint_of(renamed)
        rethreshed = json.loads(json.dumps(nodes))
        rethreshed[0]["quorumSet"]["threshold"] -= 1
        assert fingerprint_of(nodes) != fingerprint_of(rethreshed)

    def test_concurrent_identical_queries_coalesce(self, rec, held_drain):
        nodes = majority_fbas(9)
        with Engine(backend="python") as engine:
            t1 = engine.submit(nodes)
            assert held_drain.popped.wait(10.0)
            t2 = engine.submit(nodes)
            held_drain.release.set()
            assert t1.result(timeout=30.0).intersects is t2.result(timeout=30.0).intersects
        assert rec.counters["serve.coalesced"] == 1

    def test_bounded_cache_evicts_lru(self, rec):
        a, b = majority_fbas(5, prefix="EVA"), majority_fbas(5, prefix="EVB")
        with Engine(backend="python", cache_max=1) as engine:
            engine.submit(a).result(timeout=30.0)
            engine.submit(b).result(timeout=30.0)
            assert engine.submit(a).result(timeout=30.0).cached is False
        assert rec.counters["serve.cache_evictions"] >= 1


class TestReadyz:
    def test_one_shot_process_is_ready(self, rec):
        payload, status = readyz_payload()
        want, want_status = jax_metrics_server.readyz_payload()
        assert status == want_status == 200
        assert {k: v for k, v in payload.items() if k not in ("pid", "trace_id")} == {
            k: v for k, v in want.items() if k not in ("pid", "trace_id")}
        assert payload["serving"] is False and payload["replay_complete"] is None

    def test_503_while_replaying_200_after(self, rec):
        rec.gauge("serve.queue_depth", 0)
        rec.gauge("serve.replay_complete", 0)
        payload, status = readyz_payload()
        assert status == 503 and payload["status"] == "replaying"
        rec.gauge("serve.replay_complete", 1)
        payload, status = readyz_payload()
        assert status == 200 and payload["serving"] is True

    def test_started_engine_reports_ready(self, rec, tmp_path):
        with Engine(backend="python", journal=tmp_path / "j.jsonl"):
            payload, status = readyz_payload()
            assert status == 200 and payload["replay_complete"] is True and payload["serving"] is True

    def test_live_endpoints_answer(self, rec):
        import urllib.request

        server = MetricsServer(port=0)
        try:
            with Engine(backend="python") as engine:
                engine.submit(majority_fbas(5)).result(timeout=30.0)
                bodies = {}
                for path in ("/healthz", "/readyz", "/sloz", "/metrics"):
                    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}", timeout=10.0) as resp:
                        bodies[path] = (resp.status, resp.read().decode())
        finally:
            server.stop()
        assert all(status == 200 for status, _ in bodies.values())
        assert json.loads(bodies["/healthz"][1])["schema"] == "qi-health/1"
        assert json.loads(bodies["/readyz"][1])["serving"] is True
        assert json.loads(bodies["/sloz"][1])["schema"] == "qi-slo/1"
        assert "serve_verdicts" in bodies["/metrics"][1]


class TestPercentile:
    def test_nearest_rank_exact_integer_positions(self):
        hundred = [float(i) for i in range(1, 101)]
        for samples, pct in (([10.0, 20.0], 50.0), (hundred, 99.0), (hundred, 100.0), ([], 50.0), ([7.0], 99.0)):
            assert serve._percentile(samples, pct) == jax_serve._percentile(samples, pct)
        assert serve._percentile(hundred, 99.0) == 99.0

    def test_latency_gauges_track_the_window(self, rec):
        with Engine(backend="python") as engine:
            for n in (5, 7):
                engine.submit(majority_fbas(n)).result(timeout=30.0)
        assert rec.gauges["serve.p99_ms"] >= rec.gauges["serve.p50_ms"] > 0.0
        assert rec.histogram("pulse.e2e_ms").snapshot()["count"] == 2
