"""The port's serving layer (``serve.py``, ``serve_transport.py``) against the
JAX package's, on the CPU: twins of ``tests/test_serve.py``'s differential
parity and fault-point classes and of ``tests/test_qi_delta.py``'s
``TestServeIntegration``.

Both engines take the same request streams, made from a seed, on the backend
pairs of ``tests/test_torch_delta.py``; the port's response lines must equal
the JAX engine's once the fields in ``_torch_serve_cases.WALL_FIELDS`` (wall
times) are dropped, and every certificate passes the unmodified checker.
Every wait has a bound.
"""

import copy
import io
import json

import pytest
import torch

from quorum_intersection_tpu import cost as jax_cost
from quorum_intersection_tpu import delta as jax_delta
from quorum_intersection_tpu import serve_transport as jax_transport
from quorum_intersection_tpu.utils import faults as jax_faults
from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu_torch import cost, serve, serve_transport
from quorum_intersection_tpu_torch.delta import DeltaEngine, SccVerdictStore
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.fbas.synth import churn_trace, majority_fbas, stellar_like_fbas
from quorum_intersection_tpu_torch.pipeline import solve
from quorum_intersection_tpu_torch.utils import faults, telemetry
from quorum_intersection_tpu_torch.utils.faults import FaultInjected
from tools.check_cert import check_certificate

from _torch_cases import fixture_data
from _torch_serve_cases import BACKENDS, Engine, comparable, session_lines

torch.set_num_threads(1)

FIXTURES = [("trivial_correct", True), ("trivial_broken", False),
            ("nested_correct", True), ("nested_broken", False)]


@pytest.fixture
def rec():
    for mod in (faults, jax_faults):
        mod.clear_plan()
    cost.reset_cost_state()
    jax_cost.reset_cost_state()
    jax_telemetry.reset_run_record()
    record = telemetry.reset_run_record()
    yield record
    for mod in (faults, jax_faults):
        mod.clear_plan()
    jax_telemetry.reset_run_record()
    telemetry.reset_run_record()


def pair_of(witness):
    return {frozenset(witness["q1"]), frozenset(witness["q2"])}


def fingerprint_of(nodes):
    return serve.snapshot_fingerprint(build_graph(parse_fbas(nodes)))


def request_lines(sources, **extra):
    return [json.dumps({"request_id": f"r{i}", "nodes": s, **extra}) for i, s in enumerate(sources)]


class TestDifferentialParity:
    @pytest.mark.parametrize("backend", sorted(BACKENDS))
    @pytest.mark.parametrize("fixture,verdict", FIXTURES)
    def test_served_equals_one_shot_and_the_jax_server(self, rec, backend, fixture, verdict):
        nodes = fixture_data(f"{fixture}.json")
        make_port, make_jax = BACKENDS[backend]
        oracle = solve(nodes, backend=make_port(), device="cpu")
        got = session_lines(request_lines([nodes]), emit_certs=True, backend=make_port())["r0"]
        want = session_lines(request_lines([nodes]), jax=True, emit_certs=True, backend=make_jax())["r0"]
        assert got["verdict"] is oracle.intersects is verdict
        assert comparable(got) == comparable(want)
        cert = got["cert"]
        if not verdict:
            assert pair_of(cert["witness"]) == pair_of(oracle.cert["witness"])
        stamp = cert["provenance"]["serve"]
        assert stamp["schema"] == serve.SERVE_SCHEMA and stamp["request_id"] == "r0"
        assert stamp["cached"] is False and stamp["fingerprint"] == fingerprint_of(nodes)
        check_certificate(cert, nodes)

    def test_batched_stream_lines_equal_the_jax_server(self, rec):
        streams = [majority_fbas(n, broken=b) for n in (5, 7, 9) for b in (False, True)]
        lines = request_lines(streams) + request_lines(streams[:2], client="again")
        lines += [json.dumps({"ping": 7})]
        got = session_lines(lines, backend="python", batch_max=6)
        want = session_lines(lines, jax=True, backend="python", batch_max=6)
        assert set(got) == set(want)
        for key in got:
            assert comparable(got[key]) == comparable(want[key]), key
        assert [got[f"r{i}"]["verdict"] for i in range(6)] == [
            solve(s, backend="python", device="cpu").intersects for s in streams]

    def test_sweep_stream_costs_equal_the_jax_server(self, rec):
        streams = [majority_fbas(n, broken=n == 9) for n in (7, 9, 11)]
        make_port, make_jax = BACKENDS["gpu-sweep"]
        got = session_lines(request_lines(streams, client="c"), backend=make_port())
        want = session_lines(request_lines(streams, client="c"), jax=True, backend=make_jax())
        assert {k: comparable(v) for k, v in got.items()} == {k: comparable(v) for k, v in want.items()}
        assert all("cost" in line for line in got.values())

    def test_query_lines_equal_the_jax_server(self, rec):
        nodes = majority_fbas(7)
        ids = [n["publicKey"] for n in nodes]
        lines = [json.dumps({"request_id": "w", "nodes": nodes,
                             "query": {"kind": "whatif", "candidates": ids[:2], "max_k": 1}}),
                 json.dumps({"request_id": "bad", "nodes": nodes, "query": {"kind": "nope"}}),
                 "not json", json.dumps({"request_id": "x", "nodes": {"not": "a list"}})]
        got = session_lines(lines, backend="python")
        want = session_lines(lines, jax=True, backend="python")
        assert {k: comparable(v) for k, v in got.items()} == {k: comparable(v) for k, v in want.items()}
        assert got["bad"]["error"]["code"] == want["bad"]["error"]["code"]

    def test_mesh_lines_get_a_typed_error(self, rec):
        """A hello without the package fingerprint gets the typed
        ``hello_err``, a journal ship from a journal-less server the typed
        ``ship_err``, an acknowledgement nothing: the lines the JAX server
        answers, no request error and no verdict."""
        lines = [json.dumps({"hello": {"schema": "qi-serve/1", "protocol": 1}}),
                 json.dumps({"ship_journal": {}}), json.dumps({"ship_ack": {}})]

        def answers(jax):
            out = io.StringIO()
            with Engine(jax=jax, backend="python") as engine:
                session = (jax_transport if jax else serve_transport).JsonlSession(engine, out)
                for n, line in enumerate(lines):
                    session.handle_line(n, line)
            return [json.loads(ln) for ln in out.getvalue().splitlines()]

        got = answers(jax=False)
        assert got == answers(jax=True)
        assert [list(obj) for obj in got] == [["hello_err"], ["ship_err"]]
        assert (got[0]["hello_err"]["code"], got[1]["ship_err"]["code"]) == ("fingerprint_mismatch", "no_journal")
        assert rec.counters["serve.hello_rejects"] == 1 and "serve.ship_acked" in {e["name"] for e in rec.events}


class TestServeFaultPoints:
    def test_admit_fault_is_typed_and_isolated(self, rec):
        faults.install_plan(faults.parse_faults("serve.admit=error@1"))
        nodes = majority_fbas(5)
        with Engine(backend="python") as engine:
            with pytest.raises(FaultInjected):
                engine.submit(nodes)
            assert engine.submit(nodes).result(timeout=30.0).intersects is True

    def test_cache_fault_bypasses_never_flips(self, rec):
        faults.install_plan(faults.parse_faults("serve.cache=error@1+"))
        nodes = majority_fbas(7, broken=True)
        with Engine(backend="python") as engine:
            for _ in range(3):
                assert engine.submit(nodes).result(timeout=30.0).intersects is False
        assert rec.counters["serve.cache_errors"] >= 3 and rec.counters.get("serve.cache_hits", 0) == 0

    def test_journal_fault_serves_unjournaled(self, rec, tmp_path):
        faults.install_plan(faults.parse_faults("serve.journal=oserror@1+"))
        journal = tmp_path / "j.jsonl"
        with Engine(backend="python", journal=journal) as engine:
            assert engine.submit(majority_fbas(5)).result(timeout=30.0).intersects is True
        assert rec.counters["serve.journal_errors"] >= 1
        assert serve.RequestJournal(journal).scan()[0] == []

    @pytest.mark.parametrize("backend", ["python", "gpu-sweep"])
    def test_drain_fault_degrades_to_per_request_on_the_same_backend(self, rec, backend):
        faults.install_plan(faults.parse_faults("serve.drain=error@1"))
        nodes = majority_fbas(9, broken=True)
        with Engine(backend=BACKENDS[backend][0]()) as engine:
            resp = engine.submit(nodes).result(timeout=30.0)
        assert resp.intersects is False and rec.counters["serve.drain_faults"] == 1
        assert resp.stats["backend"] == backend

    def test_respond_fault_is_typed_then_cache_hit(self, rec):
        faults.install_plan(faults.parse_faults("serve.respond=error@1"))
        nodes = majority_fbas(5)
        with Engine(backend="python") as engine:
            with pytest.raises(FaultInjected):
                engine.submit(nodes).result(timeout=30.0)
            resp = engine.submit(nodes).result(timeout=30.0)
        assert resp.cached is True and resp.intersects is True
        assert rec.counters["serve.respond_errors"] == 1

    def test_card_fault_is_a_typed_error_never_a_host_verdict(self, rec):
        """A fired sweep fault fails its request (an error line); no host
        oracle answers in the card's place, and the stream goes on."""
        faults.install_plan(faults.parse_faults("sweep.dispatch=error"))
        lines = request_lines([majority_fbas(9)])
        got = session_lines(lines, backend=BACKENDS["gpu-sweep"][0]())
        assert "verdict" not in got["r0"] and got["r0"]["error"]["code"] == "internal"
        assert "sweep.dispatch" in got["r0"]["error"]["message"]
        faults.clear_plan()
        assert session_lines(lines, backend=BACKENDS["gpu-sweep"][0]())["r0"]["verdict"] is True

    def test_closed_engine_is_typed(self, rec):
        engine = serve.ServeEngine(backend="python", device="cpu")
        engine.start()
        engine.stop(drain=True, timeout=30.0)
        with pytest.raises(serve.ServeClosed):
            engine.submit(majority_fbas(5))

    def test_chaos_plan_is_the_jax_draw(self):
        for seed in range(8):
            got = faults.sample_serve_plan(seed)
            want = jax_faults.sample_serve_plan(seed)
            assert [(r.point, r.mode, r.first, r.every, r.seconds) for r in got.rules] == [
                (r.point, r.mode, r.first, r.every, r.seconds) for r in want.rules]


def multi_scc_base(seed=7, n_watchers=12):
    return stellar_like_fbas(n_core_orgs=3, per_org=2, n_watchers=n_watchers, seed=seed)


class TestServeIntegration:
    def test_serve_churn_reuses_and_matches(self, rec):
        trace = churn_trace(multi_scc_base(), 6, seed=3)
        oracle = [solve(s, backend="python", device="cpu").intersects for s in trace]
        engine = serve.ServeEngine(backend="python", device="cpu")
        assert engine._delta is not None
        try:
            engine.start()
            for snap, expected in zip(trace, oracle):
                assert engine.submit(snap).result(timeout=30.0).intersects is expected
        finally:
            engine.stop(drain=True, timeout=30.0)
        assert engine._delta.store.reuse_pct() > 0.0
        assert rec.counters["delta.compositions"] >= 1 and rec.gauges["delta.scc_reuse_pct"] > 0.0

    def test_serve_churn_lines_equal_the_jax_server(self, rec):
        trace = churn_trace(multi_scc_base(seed=11), 5, seed=2)
        make_port, make_jax = BACKENDS["gpu-sweep"]
        got = session_lines(request_lines(trace), emit_certs=True, backend=make_port())
        want = session_lines(request_lines(trace), jax=True, emit_certs=True, backend=make_jax())
        assert {k: comparable(v) for k, v in got.items()} == {k: comparable(v) for k, v in want.items()}
        reused = [v for v in got.values() if v["cert"]["provenance"].get("delta", {}).get("reused_sccs")]
        assert reused and all(int(v["cost"]["credit_lane_windows"]) > 0 for v in reused)
        for snap, key in zip(trace, sorted(got)):
            check_certificate(got[key]["cert"], snap)

    def test_serve_delta_off_switch(self, rec, monkeypatch):
        assert serve.ServeEngine(backend="python", delta=False, device="cpu")._delta is None
        monkeypatch.setenv("QI_DELTA_CACHE_MAX", "0")
        assert serve.ServeEngine(backend="python", device="cpu")._delta is None

    def test_shared_store_from_env_serves_both_packages(self, rec, tmp_path, monkeypatch):
        monkeypatch.setenv("QI_FLEET_STORE_DIR", str(tmp_path))
        base = multi_scc_base()
        with Engine(backend="python") as engine:
            first = engine.submit(base).result(timeout=30.0)
        jax_engine = jax_delta.DeltaEngine(jax_delta.SccVerdictStore(64, shared=jax_delta.SharedSccStore(tmp_path)))
        again = jax_engine.check_many([copy.deepcopy(base)], backend="python")[0]
        assert again.intersects is first.intersects
        assert again.cert["provenance"]["delta"]["reused_sccs"] == 1
        check_certificate(again.cert, base)

    def test_healthz_exposes_delta_gauges(self, rec):
        from quorum_intersection_tpu_torch.utils.metrics_server import healthz_payload

        engine = DeltaEngine(SccVerdictStore(64), device="cpu", track_diff=False)
        engine.check_many([multi_scc_base()], backend="python")
        engine.check_many([copy.deepcopy(multi_scc_base())], backend="python")
        payload = healthz_payload()
        assert payload["delta_scc_reuse_pct"] == 50.0 and payload["delta_store_size"] >= 1
