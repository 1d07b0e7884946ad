"""The port's qi-cost (``cost.py`` and the sweep's cost booking) against the
JAX package's, on the CPU: twins of ``tests/test_qi_cost.py``.

Every case runs both packages on the same inputs, made from a seed, and
compares the cost integers exactly (``lanes``, ``groups``, ``windows``,
``lane_windows``, ``macs``, ``credit_lane_windows``; ``device_s`` only for its
presence and sign, since it is a wall time).  The JAX side runs ``tpu-sweep``
and ``auto`` with ``pack=True`` under ``JAX_PLATFORMS=cpu``, as its own tests
do; the port runs ``GpuSweepBackend`` and ``AutoBackend`` with
``device="cpu"`` (the kernels' plain versions).
"""

import copy
import json

import pytest
import torch

from quorum_intersection_tpu import cost as jax_cost
from quorum_intersection_tpu import pipeline as jax_pipeline
from quorum_intersection_tpu import serve as jax_serve
from quorum_intersection_tpu.backends.tpu.sweep import TpuSweepBackend
from quorum_intersection_tpu.utils import faults as jax_faults
from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu_torch import cost
from quorum_intersection_tpu_torch.backends.auto import AutoBackend
from quorum_intersection_tpu_torch.backends.base import CancelToken
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
import quorum_intersection_tpu_torch.backends.sweep as sweep_mod
from quorum_intersection_tpu_torch.fbas.synth import churn_trace, majority_fbas, stellar_like_fbas
from quorum_intersection_tpu_torch.pipeline import check_many, solve
from quorum_intersection_tpu_torch.serve import ServeEngine
from quorum_intersection_tpu_torch.utils import faults, telemetry
from tools.check_cert import check_certificate

from _torch_cases import fixture_data

torch.set_num_threads(1)

COST_INTS = ("lanes", "groups", "windows", "lane_windows", "macs")
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
    cost.reset_cost_state()
    jax_cost.reset_cost_state()
    jax_telemetry.reset_run_record()
    telemetry.reset_run_record()


def same_cost(got, want):
    """The cost integers equal; device_s present and non-negative on both."""
    assert got is not None and want is not None
    for key in COST_INTS:
        assert int(got[key]) == int(want[key]), (key, got, want)
    assert int(got.get("credit_lane_windows", 0)) == int(want.get("credit_lane_windows", 0))
    assert bool(got["fused"]) is bool(want["fused"])
    assert got["schema"] == want["schema"] == "qi-cost/1"
    assert float(got["device_s"]) >= 0.0 and float(want["device_s"]) >= 0.0


def cost_counters(record):
    counters, _ = record.snapshot()
    return {k: v for k, v in counters.items() if k.startswith(("cost.", "fuse."))}


class TestConservation:
    SHAPES = [(n_lanes, slot, k) for n_lanes in (8, 16, 32, 64, 128) for slot in (1, 2, 4, 8, 16)
              for k in (1, 2, 3, 5, 7) if k * slot <= n_lanes]

    def test_lane_shares_equal_the_jax_shares(self):
        for n_lanes, slot, k in self.SHAPES:
            shares = cost.pack_lane_shares(n_lanes, slot, k)
            assert shares == jax_cost.pack_lane_shares(n_lanes, slot, k)
            assert sum(shares) == n_lanes and max(shares) - min(shares) <= 1

    @pytest.mark.parametrize("args", [(8, 4, 0), (8, 8, 2)])
    def test_lane_shares_reject_what_jax_rejects(self, args):
        with pytest.raises(ValueError):
            jax_cost.pack_lane_shares(*args)
        with pytest.raises(ValueError):
            cost.pack_lane_shares(*args)

    def test_attribute_pack_equals_the_jax_booking(self):
        for n_lanes, slot, k in self.SHAPES:
            for rows in (1, 7, 256):
                origins = [f"job-{g % max(1, k - 1)}" for g in range(k)]
                got = cost.attribute_pack(origins, n_lanes, slot, rows, macs_per_row=n_lanes * 64, seconds=0.25)
                want = jax_cost.attribute_pack(origins, n_lanes, slot, rows, macs_per_row=n_lanes * 64,
                                               seconds=0.25)
                assert got == want
                assert sum(int(c["lane_windows"]) for c in got.values()) == n_lanes * rows

    def test_solo_reuse_and_merge_equal_the_jax_ones(self):
        for args in ((16, 256, 4096, 0.5), (8, 32, 512, 0.2), (128, 1 << 20, 99, 1.0)):
            assert cost.solo_cost(*args) == jax_cost.solo_cost(*args)
            assert cost.reuse_credit(cost.solo_cost(*args)) == jax_cost.reuse_credit(jax_cost.solo_cost(*args))
        assert cost.reuse_credit(None) == jax_cost.reuse_credit(None)
        parts = [cost.solo_cost(16, 256, 4096, 0.5), cost.attribute_pack(["a"], 32, 16, 64, 2048, 0.1)["a"],
                 cost.reuse_credit(cost.solo_cost(8, 32, 512, 0.2))]
        assert cost.merge_costs(parts) == jax_cost.merge_costs(copy.deepcopy(parts))
        assert cost.merge_costs(parts)["credit_lane_windows"] == 8 * 32

    def test_pack_counters_conserve_end_to_end(self, rec):
        streams = [majority_fbas(9, prefix=f"P{i}") for i in range(3)]
        got = check_many(streams, backend=AutoBackend(pack=True, device="cpu"), pack=True, origins=["a", "b", "c"])
        want = jax_pipeline.check_many(streams, backend="auto", pack=True, origins=["a", "b", "c"])
        for g, w in zip(got, want):
            assert g.intersects is w.intersects is True
            same_cost(g.stats["cost"], w.stats["cost"])
            assert g.stats["pack_origin"] == w.stats["pack_origin"]
        port, jax = cost_counters(rec), cost_counters(jax_telemetry.get_run_record())
        assert port["cost.lane_windows_attributed"] == port["cost.lane_windows_total"] > 0
        for key in ("cost.lane_windows_attributed", "cost.lane_windows_total", "fuse.packs_formed",
                    "fuse.pack_lanes", "fuse.cross_request_lanes"):
            assert port[key] == jax[key], key

    def test_mid_pack_cancel_bills_the_canceller(self, rec, monkeypatch):
        tok = CancelToken()
        real = sweep_mod.fault_point
        hits = []

        def cancel_mid(point):
            if point == "sweep.window":
                hits.append(point)
                if len(hits) == 1:
                    tok.cancel()
            return real(point)

        monkeypatch.setattr(sweep_mod, "fault_point", cancel_mid)
        dead, live = check_many([majority_fbas(13), majority_fbas(11)], backend=AutoBackend(pack=True, device="cpu"),
                                pack=True, cancels=[tok, None], origins=["req-dead", "req-live"])
        assert dead.stats.get("cancelled") is True and live.intersects is True
        assert int(dead.stats["cost"]["lane_windows"]) > 0
        assert dead.stats["pack_origin"] == "req-dead" and live.stats["pack_origin"] == "req-live"
        counters = cost_counters(rec)
        assert counters["cost.lane_windows_attributed"] == counters["cost.lane_windows_total"]
        assert (int(dead.stats["cost"]["lane_windows"]) + int(live.stats["cost"]["lane_windows"])
                == counters["cost.lane_windows_total"])


class TestCostParity:
    @pytest.mark.parametrize("broken", [False, True])
    @pytest.mark.parametrize("batch", [None, 512])
    def test_solo_sweep_books_the_jax_cost(self, rec, broken, batch):
        data = majority_fbas(11, broken=broken)
        kw = {} if batch is None else {"batch": batch}
        got = solve(data, backend=GpuSweepBackend(device="cpu", **kw))
        want = jax_pipeline.solve(data, backend=TpuSweepBackend(**kw))
        assert got.intersects is want.intersects is (not broken)
        same_cost(got.stats["cost"], want.stats["cost"])
        assert got.stats["cost"]["fused"] is False
        assert got.cert["provenance"]["cost"]["lane_windows"] == want.cert["provenance"]["cost"]["lane_windows"]

    def test_identical_topologies_pad_free_parity(self, rec):
        streams = [majority_fbas(9, prefix=f"P{i}") for i in range(3)]
        solo = solve(streams[0], backend=GpuSweepBackend(device="cpu")).stats["cost"]
        fused = check_many(streams, backend=AutoBackend(pack=True, device="cpu"), pack=True, origins=["a", "b", "c"])
        for res in fused:
            assert res.stats["cost"]["fused"] is True
            assert res.stats["cost"]["windows"] == solo["windows"]
            assert res.stats["cost"]["lane_windows"] == solo["lane_windows"]

    def test_mixed_pack_books_the_jax_shares(self, rec):
        streams = [majority_fbas(n) for n in (7, 9, 11)]
        got = check_many(streams, backend=AutoBackend(pack=True, device="cpu"), pack=True, origins=list("abc"))
        want = jax_pipeline.check_many(streams, backend="auto", pack=True, origins=list("abc"))
        for g, w in zip(got, want):
            same_cost(g.stats["cost"], w.stats["cost"])
        lanes = [int(r.stats["cost"]["lanes"]) for r in got]
        windows = {int(r.stats["cost"]["windows"]) for r in got}
        assert len(windows) == 1
        assert sum(int(r.stats["cost"]["lane_windows"]) for r in got) == sum(lanes) * windows.pop()

    def test_unfused_batch_stamps_no_origin(self, rec):
        streams = [majority_fbas(9, prefix=f"P{i}") for i in range(2)]
        got = check_many(streams, backend=AutoBackend(pack=True, device="cpu"), pack=True)
        want = jax_pipeline.check_many(streams, backend="auto", pack=True)
        assert all("pack_origin" not in r.stats for r in got + want)
        assert "fuse.packs_formed" not in cost_counters(rec)


class TestTenantTable:
    def test_lru_bound_and_eviction_counter(self, rec):
        table, jax_table = cost.TenantTable(capacity=3), jax_cost.TenantTable(capacity=3)
        for i in range(5):
            table.book(f"client-{i}", cost.solo_cost(8, 4, 64, 0.01))
            jax_table.book(f"client-{i}", jax_cost.solo_cost(8, 4, 64, 0.01))
        assert table.snapshot() == jax_table.snapshot()
        assert set(table.snapshot()) == {"client-2", "client-3", "client-4"}
        assert rec.counters["cost.tenants_evicted"] == 2

    def test_top_and_lru_touch(self):
        table = cost.TenantTable(capacity=8)
        table.book("small", cost.solo_cost(1, 4, 1, 0.0))
        table.book("big", cost.solo_cost(64, 64, 1, 0.0))
        table.book("chatty", None)
        table.book("chatty", None)
        assert [c for c, _ in table.top(2)] == ["big", "small"]
        lru = cost.TenantTable(capacity=2)
        for client in ("a", "b", "a", "c"):
            lru.book(client, None)
        assert set(lru.snapshot()) == {"a", "c"}

    def test_merge_then_replace_never_double_counts(self):
        part = {"t": {"requests": 2, "lane_windows": 100, "macs": 5, "credit_lane_windows": 0, "device_s": 0.5}}
        merged = cost.merge_tenant_snapshots([part, part])
        assert merged == jax_cost.merge_tenant_snapshots([part, part])
        table = cost.TenantTable(capacity=8)
        table.replace(merged)
        table.replace(merged)
        assert table.snapshot()["t"]["lane_windows"] == 200

    def test_serve_books_clients_cache_hit_costless(self, rec):
        nodes = majority_fbas(9)
        engine = ServeEngine(backend="gpu-sweep", device="cpu")
        try:
            engine.start()
            first = engine.submit(nodes, client="alice").result(timeout=60.0)
            second = engine.submit(nodes, client="bob").result(timeout=60.0)
        finally:
            engine.stop(drain=True, timeout=30.0)
        jax_engine = jax_serve.ServeEngine(backend="tpu-sweep")
        try:
            jax_engine.start()
            want = jax_engine.submit(nodes, client="alice").result(timeout=60.0).cost
        finally:
            jax_engine.stop(drain=True, timeout=30.0)
        assert first.intersects is second.intersects is True
        assert second.cached is True and second.cost is None
        same_cost(first.cost, want)
        snap = cost.tenant_table().snapshot()
        assert snap["alice"]["requests"] == 1 and snap["alice"]["lane_windows"] == first.cost["lane_windows"]
        assert snap["bob"] == {"requests": 1, "lane_windows": 0, "macs": 0, "credit_lane_windows": 0,
                               "device_s": 0.0}
        assert first.cert["provenance"]["cost"] == first.cost

    def test_serve_churn_books_delta_credit(self, rec):
        """A composed verdict now carries the credit of the fragment the
        port's own sweep banked (it booked none before the sweep did)."""
        trace = churn_trace(stellar_like_fbas(n_core_orgs=3, per_org=2, n_watchers=12, seed=7), 4, seed=3)
        engine = ServeEngine(backend="gpu-sweep", device="cpu")
        try:
            engine.start()
            responses = [engine.submit(snap, client="churner").result(timeout=60.0) for snap in trace]
        finally:
            engine.stop(drain=True, timeout=30.0)
        assert all(r.intersects for r in responses)
        reused = [r.cost for r in responses if r.cost is not None and r.cost.get("reused")]
        assert reused and all(r["lane_windows"] == 0 and int(r["credit_lane_windows"]) > 0 for r in reused)
        row = cost.tenant_table().snapshot()["churner"]
        assert row["requests"] == len(trace) and int(row["credit_lane_windows"]) >= len(reused)

    def test_final_lines_carry_tenant_table(self, rec):
        assert "tenants" not in [line.get("kind") for line in rec.final_lines()]
        cost.tenant_table().book("alice", cost.solo_cost(8, 4, 64, 0.01))
        lines = [line for line in rec.final_lines() if line.get("kind") == "tenants"]
        assert len(lines) == 1 and lines[0]["schema"] == "qi-cost/1"
        assert lines[0]["tenants"]["alice"]["requests"] == 1


class TestSloPlane:
    SPEC = "serve_e2e_p99_ms<500"

    def test_parse_slo_equals_the_jax_parse(self):
        for spec in ("serve_e2e_p99_ms<500, pack_fill_pct>60", "nonsense,p99<abc,,", ""):
            got = [(t.metric, t.op, t.bound) for t in cost.parse_slo(spec)]
            assert got == [(t.metric, t.op, t.bound) for t in jax_cost.parse_slo(spec)]

    def test_burn_sequence_equals_the_jax_plane(self, rec):
        """The same gauge sequence through both planes: the same status at
        every step, one slo.burn on the sustained breach, none on the lone
        spike or the recovery."""
        jax_rec = jax_telemetry.get_run_record()
        plane = cost.SloPlane(spec=self.SPEC, fast_s=300.0, slow_s=3600.0)
        jax_plane = jax_cost.SloPlane(spec=self.SPEC, fast_s=300.0, slow_s=3600.0)
        t = 1000.0
        for value, n in ((120.0, 20), (900.0, 1), (120.0, 5), (900.0, 10), (120.0, 10)):
            rec.gauge("serve.p99_ms", value)
            jax_rec.gauge("serve.p99_ms", value)
            for _ in range(n):
                assert plane.evaluate(now=t) == jax_plane.evaluate(now=t)
                t += 60.0
        burns = [e for e in rec.events if e["name"] == "slo.burn"]
        assert len(burns) == 1 and burns[0]["attrs"]["metric"] == "serve_e2e_p99_ms"
        assert rec.gauges["slo.burning"] == 0 and plane.burning_count() == 0

    def test_evaluate_degrades_through_fault_point(self, rec):
        plane = cost.SloPlane(spec=self.SPEC, fast_s=300.0, slow_s=3600.0)
        faults.install_plan(faults.parse_faults("cost.attribute=error@1+"))
        assert plane.evaluate(now=1.0)["degraded"] is True
        assert rec.counters["cost.attribute_errors"] == 1
        assert [e["attrs"]["site"] for e in rec.events if e["name"] == "cost.degraded"] == ["slo.evaluate"]

    def test_sloz_and_healthz_payloads(self, rec, monkeypatch):
        from quorum_intersection_tpu.utils import metrics_server as jax_ms
        from quorum_intersection_tpu_torch.utils import metrics_server

        monkeypatch.setenv("QI_SLO", self.SPEC)
        cost.reset_cost_state()
        cost.tenant_table().book("alice", cost.solo_cost(8, 4, 64, 0.01))
        payload = metrics_server.sloz_payload()
        assert payload["schema"] == "qi-slo/1" and payload["enabled"] is True
        assert payload["tenants"]["local"][0]["client"] == "alice" and payload["tenants"]["fleet"] == []
        assert set(metrics_server.healthz_payload()) == set(jax_ms.healthz_payload())
        assert set(metrics_server.readyz_payload()[0]) == set(jax_ms.readyz_payload()[0])


class TestCostFaultPoint:
    @staticmethod
    def normalized(cert):
        out = copy.deepcopy(cert)
        out.pop("provenance", None)
        return out

    def test_degrade_leaves_verdict_and_cert_byte_identical(self, rec):
        clean = {name: solve(fixture_data(f"{name}.json"), backend=GpuSweepBackend(device="cpu"))
                 for name, _ in FIXTURES}
        swept = sum(1 for r in clean.values() if "cost" in r.cert.get("provenance", {}))
        assert swept >= 1
        faults.install_plan(faults.parse_faults("cost.attribute=error@1+"))
        for name, verdict in FIXTURES:
            res = solve(fixture_data(f"{name}.json"), backend=GpuSweepBackend(device="cpu"))
            assert res.intersects is verdict and res.stats.get("cost") is None
            assert "cost" not in res.cert.get("provenance", {})
            assert (json.dumps(self.normalized(res.cert), sort_keys=True)
                    == json.dumps(self.normalized(clean[name].cert), sort_keys=True))
            check_certificate(res.cert, fixture_data(f"{name}.json"))
        assert rec.counters["cost.attribute_errors"] >= swept
        assert rec.counters["cost.lane_windows_total"] > rec.counters["cost.lane_windows_attributed"]
        assert "sweep.solo" in {e["attrs"]["site"] for e in rec.events if e["name"] == "cost.degraded"}

    def test_pack_degrade_drops_the_pack_cost(self, rec):
        faults.install_plan(faults.parse_faults("cost.attribute=error@1+"))
        res = check_many([majority_fbas(7), majority_fbas(9)], backend=AutoBackend(pack=True, device="cpu"),
                         pack=True, origins=["a", "b"])
        assert all(r.intersects and "cost" not in r.stats for r in res)
        assert "sweep.pack" in {e["attrs"]["site"] for e in rec.events if e["name"] == "cost.degraded"}

    def test_serve_degrade_books_nothing_answers_everything(self, rec):
        faults.install_plan(faults.parse_faults("cost.attribute=error@1+"))
        engine = ServeEngine(backend="gpu-sweep", device="cpu")
        try:
            engine.start()
            resp = engine.submit(majority_fbas(9)).result(timeout=60.0)
        finally:
            engine.stop(drain=True, timeout=30.0)
        assert resp.intersects is True and resp.cost is None
        assert "cost" not in resp.cert.get("provenance", {})
        check_certificate(resp.cert, majority_fbas(9))
        assert len(cost.tenant_table()) == 0 and rec.counters["cost.attribute_errors"] >= 1


class TestAutoWindow:
    @pytest.mark.parametrize("depth,p99,burning", [
        (0, 100.0, False), (0, 100.0, True), (5, 100.0, False), (4, 60.0, False),
        (3, 2.0, False), (5, 100.0, True), (3, 2.0, True), (17, 10_000.0, True), (1, 0.0, False),
    ])
    def test_decision_table_equals_the_jax_one(self, depth, p99, burning):
        got = cost.choose_fuse_window(depth, p99, burning)
        assert got == jax_cost.choose_fuse_window(depth, p99, burning)
        assert 0.0 <= got <= cost.AUTO_WINDOW_CAP_MS and (depth > 0 or got == 0.0)

    def test_engine_accepts_auto_and_decides_per_flush(self, rec):
        engine = ServeEngine(backend="python", fuse_window_ms="auto", device="cpu")
        try:
            engine.start()
            resp = engine.submit(majority_fbas(9)).result(timeout=60.0)
        finally:
            engine.stop(drain=True, timeout=30.0)
        assert resp.intersects is True
        decisions = [e for e in rec.events if e["name"] == "serve.fuse_window"]
        assert decisions and all(0.0 <= d["attrs"]["window_ms"] <= cost.AUTO_WINDOW_CAP_MS for d in decisions)
        assert "serve.fuse_window_ms" in rec.gauges
