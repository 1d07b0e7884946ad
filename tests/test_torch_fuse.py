"""The port's qi-fuse (``fuse.py`` and the serve drain's fused path) against
the JAX package's, on the CPU: twins of ``tests/test_qi_fuse.py``.

Both packages serve the same requests, made from a seed: the JAX engine with
``auto, pack=True`` (or the Python oracle) under ``JAX_PLATFORMS=cpu``, the
port's with the same backend names on ``device="cpu"`` (the packed kernels'
plain versions).  Compared exactly: verdicts, witnesses, hit indices,
``pack_origin``, the per-request cost integers and the ``fuse.*`` and
``cost.*`` counters.  ``TestForcedFuseSchedules`` drives the port's own sync
hook (``fuse._fuse_sync``) to force the flush-versus-late-submit
interleaving the JAX package forces through ``tools/analyze/schedules.py``,
which imports the JAX package.  Every wait has a bound.
"""

import copy
import json
import threading
import time

import pytest
import torch

from quorum_intersection_tpu import pipeline as jax_pipeline
from quorum_intersection_tpu import serve as jax_serve
from quorum_intersection_tpu.utils import faults as jax_faults
from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu_torch import cost
import quorum_intersection_tpu_torch.backends.sweep as sweep_mod
import quorum_intersection_tpu_torch.fuse as fuse_mod
from quorum_intersection_tpu_torch.backends.base import CancelToken
from quorum_intersection_tpu_torch.backends.auto import AutoBackend
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.fbas.synth import majority_fbas
from quorum_intersection_tpu_torch.fuse import BatchFormer, estimate_lanes
from quorum_intersection_tpu_torch.pipeline import check_many, solve
from quorum_intersection_tpu_torch.serve import DeadlineExceeded, ServeEngine
from quorum_intersection_tpu_torch.utils import faults, telemetry
from tools.check_cert import check_certificate

from _torch_cases import fixture_data

torch.set_num_threads(1)

FIXTURES = [("trivial_correct", True), ("trivial_broken", False),
            ("nested_correct", True), ("nested_broken", False)]
FUSE_MS = 50.0
COST_INTS = ("lanes", "groups", "windows", "lane_windows", "macs")


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


def normalized(cert):
    out = copy.deepcopy(cert)
    out.pop("provenance", None)
    return out


def witness(res):
    """Verdict and the certificate's witness pair (None on a true verdict)."""
    w = res.cert.get("witness")
    return (res.intersects, None if w is None else (sorted(w["q1"]), sorted(w["q2"])))


def serve_batch(make_engine, sources, queries=None, deadlines=None):
    """Queue every request before start (one drained batch), then collect
    each outcome: the response, or the typed exception."""
    engine = make_engine()
    queries = queries or [None] * len(sources)
    deadlines = deadlines or [None] * len(sources)
    tickets = [engine.submit(s, query=q, deadline_s=d, request_id=f"r{i}")
               for i, (s, q, d) in enumerate(zip(sources, queries, deadlines))]
    engine.start()
    out = []
    try:
        for t in tickets:
            try:
                out.append(t.result(timeout=60.0))
            except Exception as exc:  # noqa: BLE001 - the typed outcome is the result here
                out.append(exc)
    finally:
        engine.stop(drain=True, timeout=30.0)
    return out


def port_engine(**kw):
    return lambda: ServeEngine(device="cpu", **kw)


def jax_engine(**kw):
    return lambda: jax_serve.ServeEngine(**kw)


def counters_of(record, prefixes=("fuse.", "cost.")):
    counters, _ = record.snapshot()
    return {k: v for k, v in counters.items() if k.startswith(prefixes)}


class TestFusedParity:
    @pytest.mark.parametrize("fixture,verdict", FIXTURES)
    def test_fixture_pairs_byte_identical(self, rec, fixture, verdict):
        nodes = fixture_data(f"{fixture}.json")
        plain = serve_batch(port_engine(backend="python", fuse_window_ms=0.0), [nodes])[0]
        fused = serve_batch(port_engine(backend="python", fuse_window_ms=FUSE_MS), [nodes])[0]
        want = serve_batch(jax_engine(backend="python", fuse_window_ms=FUSE_MS), [nodes])[0]
        assert plain.intersects is fused.intersects is want.intersects is verdict
        assert json.dumps(normalized(fused.cert), sort_keys=True) == json.dumps(normalized(plain.cert), sort_keys=True)
        assert witness(fused) == witness(want)
        check_certificate(fused.cert, nodes)

    def test_mixed_query_kinds_fused(self, rec):
        nodes = majority_fbas(9)
        ids = [n["publicKey"] for n in nodes]
        queries = [None, {"kind": "whatif", "candidates": ids[:3], "max_k": 2},
                   {"kind": "relaxed", "family_b": majority_fbas(9, broken=True)}]
        sources = [nodes] * 3
        plain = serve_batch(port_engine(backend="python", fuse_window_ms=0.0), sources, queries)
        fused = serve_batch(port_engine(backend="python", fuse_window_ms=FUSE_MS), sources, queries)
        want = serve_batch(jax_engine(backend="python", fuse_window_ms=FUSE_MS), sources, queries)
        for p, f, w in zip(plain, fused, want):
            assert f.intersects is p.intersects is w.intersects
            assert f.result == p.result == w.result
        assert [e for e in rec.events if e["name"] == "fuse.flush"]

    def test_cross_request_lanes_fill_one_tile(self, rec):
        streams = [majority_fbas(n) for n in (7, 9, 11)]
        got = serve_batch(port_engine(backend="auto", pack=True, fuse_window_ms=200.0), streams)
        want = serve_batch(jax_engine(backend="auto", pack=True, fuse_window_ms=200.0), streams)
        for stream, g, w in zip(streams, got, want):
            assert g.intersects is w.intersects is solve(stream, backend="python", device="cpu").intersects
            assert g.stats["pack_origin"] == w.stats["pack_origin"]
            assert {k: g.cost[k] for k in COST_INTS} == {k: w.cost[k] for k in COST_INTS}
        port, jax = counters_of(rec), counters_of(jax_telemetry.get_run_record())
        assert port["fuse.packs_formed"] > 0 and port["fuse.cross_request_lanes"] > 0
        for key in ("fuse.packs_formed", "fuse.pack_lanes", "fuse.cross_request_lanes",
                    "cost.lane_windows_attributed", "cost.lane_windows_total"):
            assert port[key] == jax[key], key
        assert rec.gauges["fuse.fill_pct"] == jax_telemetry.get_run_record().gauges["fuse.fill_pct"] > 0
        # Cost is conserved: the requests' lane-windows sum to the pack total.
        assert sum(int(g.cost["lane_windows"]) for g in got) == port["cost.lane_windows_total"]

    def test_hit_indices_equal_unfused(self, rec):
        streams = [majority_fbas(9, broken=True), majority_fbas(11), majority_fbas(10, broken=True)]
        got = serve_batch(port_engine(backend="gpu-sweep", fuse_window_ms=200.0), streams)
        plain = serve_batch(port_engine(backend="gpu-sweep", fuse_window_ms=0.0), streams)
        want = jax_pipeline.check_many(streams, backend="auto", pack=True)
        for g, p, w in zip(got, plain, want):
            assert witness(g) == witness(p)
            assert (g.intersects, g.stats.get("hit_index")) == (w.intersects, w.stats.get("hit_index"))

    def test_unset_window_is_the_unfused_drain(self, rec):
        resp = serve_batch(port_engine(backend="python", fuse_window_ms=0.0), [majority_fbas(7)])[0]
        assert resp.intersects is True
        assert not [k for k in rec.counters if k.startswith("fuse.")]
        assert not [k for k in rec.gauges if k.startswith("fuse.")]
        assert not [e for e in rec.events if e["name"].startswith("fuse.")]


def _trip_on_first_window(token, monkeypatch, sleep_s=0.0):
    """Cancel ``token`` (or sleep) at the first sweep window: the
    deterministic stand-in for a deadline firing mid-pack."""
    real = sweep_mod.fault_point
    hits = []

    def wrapper(point):
        if point == "sweep.window":
            hits.append(point)
            if len(hits) == 1:
                if token is not None:
                    token.cancel()
                if sleep_s:
                    time.sleep(sleep_s)
        return real(point)

    monkeypatch.setattr(sweep_mod, "fault_point", wrapper)


class TestMidPackCancel:
    def test_ledger_partition_exact(self, rec, monkeypatch):
        token = CancelToken()
        _trip_on_first_window(token, monkeypatch)
        dead, live = check_many([majority_fbas(13), majority_fbas(15)], backend=AutoBackend(pack=True, device="cpu"),
                                pack=True, cancels=[token, None], origins=["req-dead", "req-live"])
        assert dead.stats.get("cancelled") is True and dead.cert["partial"] is True and dead.cert["verdict"] is None
        cov = dead.cert["coverage"]
        assert cov["windows_cancelled"] > 0
        assert (cov["windows_enumerated"] + cov["windows_pruned_guard"] + cov["windows_skipped_pack_fill"]
                + cov["windows_cancelled"]) == cov["window_space"] == 2 ** 12
        assert live.intersects is True and not live.stats.get("cancelled")
        live_cov = live.stats["cert"]
        assert live_cov["windows_cancelled"] == 0
        assert (live_cov["windows_enumerated"] + live_cov["windows_pruned_guard"]
                + live_cov["windows_skipped_pack_fill"]) == live_cov["window_space"] == 2 ** 14
        assert (dead.stats["pack_origin"], live.stats["pack_origin"]) == ("req-dead", "req-live")

    def test_pretripped_token_never_occupies_lanes(self, rec):
        token = CancelToken()
        token.cancel()
        sources = [majority_fbas(9), majority_fbas(11)]
        dead, live = check_many(sources, backend=AutoBackend(pack=True, device="cpu"), pack=True,
                                cancels=[token, None], origins=["req-dead", "req-live"])
        from quorum_intersection_tpu.backends.base import CancelToken as JaxToken

        jax_token = JaxToken()
        jax_token.cancel()
        want_dead, want_live = jax_pipeline.check_many(sources, backend="auto", pack=True,
                                                       cancels=[jax_token, None], origins=["req-dead", "req-live"])
        assert dead.cert["coverage"] == want_dead.cert["coverage"]
        assert dead.cert["coverage"]["windows_cancelled"] == 2 ** 8
        assert live.intersects is want_live.intersects is True
        assert live.stats["pack_origin"] == want_live.stats["pack_origin"] == "req-live"
        assert {k: live.stats["cost"][k] for k in COST_INTS} == {k: want_live.stats["cost"][k] for k in COST_INTS}

    def test_serve_deadline_retires_lanes_copacked_cert_full(self, rec, monkeypatch):
        slow, fast = majority_fbas(13), majority_fbas(11)
        _trip_on_first_window(None, monkeypatch, sleep_s=1.2)  # outlive the 0.5 s deadline
        dead, live = serve_batch(port_engine(backend="auto", pack=True, fuse_window_ms=200.0), [slow, fast],
                                 deadlines=[0.5, None])
        assert live.intersects is True
        check_certificate(live.cert, fast)
        assert isinstance(dead, DeadlineExceeded)
        cov = dead.cert["coverage"]
        assert dead.cert["partial"] is True and cov["windows_cancelled"] > 0
        assert (cov["windows_enumerated"] + cov["windows_pruned_guard"] + cov["windows_skipped_pack_fill"]
                + cov["windows_cancelled"]) == cov["window_space"] == 2 ** 12


class TestFuseFaultPoint:
    def test_serve_fuse_fault_degrades_in_place(self, rec):
        faults.install_plan(faults.parse_faults("serve.fuse=error@1+"))
        for fixture, verdict in FIXTURES:
            nodes = fixture_data(f"{fixture}.json")
            resp = serve_batch(port_engine(backend="python", fuse_window_ms=FUSE_MS), [nodes])[0]
            assert resp.intersects is verdict
            check_certificate(resp.cert, nodes)
        assert rec.counters["serve.fuse_faults"] >= len(FIXTURES)
        assert rec.counters.get("fuse.packs_formed", 0) == 0
        assert [e for e in rec.events if e["name"] == "serve.fuse_degraded"]
        assert not [e for e in rec.events if e["name"] == "fuse.flush"]


class TestBatchFormerAccounting:
    @staticmethod
    def _fn(sources, cancels, origins):
        return check_many(sources, backend="python", device="cpu")

    def test_fill_flush_before_timer(self, rec):
        former = BatchFormer(self._fn, window_ms=60_000.0, lane_tile=32)
        fbas = parse_fbas(majority_fbas(9))
        assert estimate_lanes(fbas) == 16
        former.register()
        former.register()
        outs = [None, None]

        def worker(ix):
            try:
                outs[ix] = former.submit([fbas], origin=f"req-{ix}")
            finally:
                former.done()

        t0 = time.monotonic()
        threads = [threading.Thread(target=worker, args=(ix,), daemon=True) for ix in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert time.monotonic() - t0 < 20.0
        assert all(o is not None and o[0].intersects for o in outs)
        assert former.flush_log and former.flush_log[0] in ("full", "drain")
        assert sum(1 for e in rec.events if e["name"] == "fuse.flush") == len(former.flush_log)

    def test_timer_flush_then_drain_flush(self, rec):
        former = BatchFormer(self._fn, window_ms=120.0)
        fbas = parse_fbas(majority_fbas(5))
        former.register()
        former.register()  # a producer not submitting yet blocks "drain"
        res1 = former.submit([fbas], origin="req-1")
        former.done()
        assert former.flush_log == ["timer"]
        res2 = former.submit([fbas], origin="req-2")
        former.done()
        assert former.flush_log == ["timer", "drain"]
        assert res1[0].intersects is res2[0].intersects is True
        flushes = [e for e in rec.events if e["name"] == "fuse.flush"]
        assert [e["attrs"]["reason"] for e in flushes] == ["timer", "drain"]
        assert all(e["attrs"]["units"] == 1 for e in flushes)

    def test_deadline_beats_timer(self, rec):
        former = BatchFormer(self._fn, window_ms=60_000.0)
        former.register()
        former.register()
        res = former.submit([parse_fbas(majority_fbas(5))], origin="req-1", deadline_t=time.monotonic() + 0.1)
        former.done()
        assert former.flush_log == ["deadline"] and res[0].intersects is True

    def test_flush_failure_fans_out(self, rec):
        def boom(sources, cancels, origins):
            raise RuntimeError("flush exploded")

        former = BatchFormer(boom, window_ms=10.0)
        former.register()
        with pytest.raises(RuntimeError, match="flush exploded"):
            former.submit([parse_fbas(majority_fbas(5))], origin="req-1")
        former.done()


class TestForcedFuseSchedules:
    """A submit that arrives while the first flush is in the air lands in a
    second flush of its own, forced through the port's sync hook."""

    def test_flush_races_late_submit(self, rec, monkeypatch):
        former = BatchFormer(TestBatchFormerAccounting._fn, window_ms=60_000.0)
        fbas = parse_fbas(majority_fbas(5))
        trace, late_in, outs = [], threading.Event(), {}
        lock = threading.Lock()

        def late():
            former.register()
            try:
                outs["late"] = former.submit([fbas], origin="req-late")
            finally:
                former.done()

        late_thread = threading.Thread(target=late, daemon=True)

        def hook(point):
            with lock:
                trace.append(point)
                first_formed = point == fuse_mod._POINT_FORMED and trace.count(point) == 1
            if point == fuse_mod._POINT_SUBMIT and threading.current_thread() is late_thread:
                late_in.set()
            if first_formed:
                late_thread.start()
                assert late_in.wait(10.0)

        monkeypatch.setattr(fuse_mod, "_fuse_sync", hook)
        former.register()
        try:
            outs["first"] = former.submit([fbas], origin="req-first")
        finally:
            former.done()
        late_thread.join(30.0)
        assert not late_thread.is_alive()
        assert outs["first"][0].intersects is outs["late"][0].intersects is True
        assert former.flush_log == ["drain", "drain"]
        assert trace.index(fuse_mod._POINT_FORMED) < trace.index(fuse_mod._POINT_DONE)
        assert trace.count(fuse_mod._POINT_SUBMIT) == 2 and trace.count(fuse_mod._POINT_FORMED) == 2

    def test_hook_is_a_no_op_by_default(self):
        assert fuse_mod._fuse_sync.__name__ == "<lambda>"
        assert fuse_mod._fuse_sync("no-op") is None
        assert not [t for t in threading.enumerate() if t.name.startswith("qi-fuse-")]
