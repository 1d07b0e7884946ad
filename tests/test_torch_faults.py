"""The port's fault points on the CPU, against the JAX package's harness:

- the registry, the ``QI_FAULTS`` grammar and ``fault_point``'s refusal of an
  undeclared name, against the JAX ``utils/faults.py``;
- every declared point reached by a test (``SCENARIOS``, one a point, each
  run with a rule installed that fires there), and what a fired point does:
  a ``sweep.*`` or ``frontier.chunk`` fault fails the solve with the injected
  exception (no degrade to the unpruned or dense encoding, nor from the
  card's rung to the host oracle); ``checkpoint.write``, ``cert.write`` and
  ``telemetry.dump`` become counters; ``native.build`` and ``native.call``
  degrade the auto router to the Python oracle; ``query.dispatch`` becomes a
  typed ``QueryError``; ``delta.diff`` degrades the incremental engine to
  the full re-solve, ``fleet.store`` its shared tier to the local store and
  ``cost.attribute`` a composed verdict to no cost; the ``serve.*`` points
  reject, bypass, un-journal, degrade to per-request or unfused solves, or
  answer with a typed error, each on the same device; the ``fleet.*``,
  ``store.fetch`` and ``pulse.aggregate`` points degrade the fleet one rung
  (first live worker, inconclusive probe, in-flight re-route only, no peer,
  suspect-only, single dispatch, local-journal-only, frozen size, local
  solve, per-worker metrics), never to a wrong verdict; ``distributed.init``
  retries under ``QI_DIST_INIT_TIMEOUT_S``, then degrades loudly to one
  process;
- the disk-full cases of ``tests/test_checkpoint_faults.py`` (``:113-186``);
- a ``FaultPreempted`` at ``sweep.window`` under a checkpoint resumes past
  zero to the uninterrupted verdict and hit index;
- a ``sweep.*`` fault under the auto router's packed rung fails the solve
  (the card's twin is ``tests/test_torch_cuda.py``, which imports no JAX).
"""

import io
import json
import os
import time

import pytest
import torch

from quorum_intersection_tpu.utils import faults as jax_faults
from quorum_intersection_tpu_torch import cli
from quorum_intersection_tpu_torch.backends import cpp
from quorum_intersection_tpu_torch.backends.auto import AutoBackend
from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
from quorum_intersection_tpu_torch.cert import write_certificate
from quorum_intersection_tpu_torch.delta import DeltaEngine, SccVerdictStore, SharedSccStore
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.pipeline import check_many, solve
from quorum_intersection_tpu_torch.query import Query, QueryEngine, QueryError
from quorum_intersection_tpu_torch.utils import faults, telemetry
from quorum_intersection_tpu_torch.utils.checkpoint import FrontierCheckpoint, SweepCheckpoint
from quorum_intersection_tpu_torch.utils.faults import FaultInjected, FaultPreempted

from _torch_cases import fixture_data
from _torch_faults_cases import late_hit_fbas

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def rec():
    faults.clear_plan()
    record = telemetry.reset_run_record()
    yield record
    faults.clear_plan()
    telemetry.reset_run_record()


def _plan(spec: str) -> faults.FaultPlan:
    return faults.install_plan(faults.parse_faults(spec))


def test_registry_is_a_subset_of_the_jax_catalog():
    port = faults.registry()
    assert set(port) <= set(jax_faults.registry())
    assert set(port) == {
        "sweep.prune", "sweep.bitset", "sweep.dispatch", "sweep.compile", "sweep.window", "sweep.pack",
        "frontier.chunk", "checkpoint.write", "cert.write", "native.build", "native.call",
        "telemetry.dump", "query.dispatch", "delta.diff", "fleet.store", "cost.attribute",
        "serve.admit", "serve.cache", "serve.journal", "serve.drain", "serve.respond", "serve.fuse",
        "fleet.route", "fleet.probe", "fleet.replay", "fleet.join", "fleet.lease", "fleet.hedge", "fleet.ship",
        "fleet.scale", "store.fetch", "pulse.aggregate", "distributed.init",
    }


def test_undeclared_point_raises_even_without_a_plan():
    assert faults.active_plan() is None
    with pytest.raises(KeyError):
        faults.fault_point("sweep.nope")
    with pytest.raises(KeyError):
        faults.FaultRule(point="sweep.nope", mode="error")


@pytest.mark.parametrize("spec", ["checkpoint.write=oserror@3", "native.call=hang:0.5@1",
                                  "sweep.dispatch=oom", "sweep.window=preempt@2+;cert.write=oserror"])
def test_grammar_is_the_jax_grammar(spec):
    port, want = faults.parse_faults(spec), jax_faults.parse_faults(spec)
    assert [r.spec() for r in port.rules] == [r.spec() for r in want.rules]
    assert [(r.point, r.mode, r.first, r.every, r.seconds) for r in port.rules] == \
        [(r.point, r.mode, r.first, r.every, r.seconds) for r in want.rules]
    with pytest.raises(ValueError):
        faults.parse_faults("sweep.dispatch")


def test_chaos_plan_is_the_jax_draw():
    """``sample_plan`` draws the JAX package's schedule for seeds 0-99: the
    same rules, in the same order, with the same hit selectors and label."""
    for seed in range(100):
        got, want = faults.sample_plan(seed), jax_faults.sample_plan(seed)
        assert got.label == want.label
        assert [r.spec() for r in got.rules] == [r.spec() for r in want.rules]
        assert [(r.point, r.mode, r.first, r.every, r.seconds) for r in got.rules] == [
            (r.point, r.mode, r.first, r.every, r.seconds) for r in want.rules]


def test_qi_faults_env_fires_and_counts(monkeypatch, rec):
    monkeypatch.setenv("QI_FAULTS", "cert.write=oserror@2")
    faults.fault_point("cert.write")
    with pytest.raises(OSError):
        faults.fault_point("cert.write")
    faults.fault_point("cert.write")
    assert faults.active_plan().fired == [("cert.write", "oserror", 2)]
    assert rec.counters["faults.injected"] == 1
    assert [e["attrs"] for e in rec.events if e["name"] == "fault.injected"] == [
        {"point": "cert.write", "mode": "oserror", "hit": 2}]


# ---- every point, reached ----------------------------------------------------


def _sweep(**kw):
    return GpuSweepBackend(device="cpu", **kw)


def _fails_solve(point, data=None, **backend_kw):
    """A solve through a sweep point: the injected exception, no verdict."""
    with pytest.raises(FaultInjected) as exc:
        solve(data or synth.majority_fbas(9), backend=_sweep(**backend_kw))
    assert exc.value.point == point


def _scenario_sweep_pack(point, tmp, mp):
    with pytest.raises(FaultInjected):
        check_many([synth.majority_fbas(7), synth.majority_fbas(9)], backend=_sweep())


def _scenario_packed_bitset(point):
    with pytest.raises(FaultInjected):
        check_many([synth.majority_fbas(7), synth.majority_fbas(9)], backend=_sweep(engine="bitset"))


def _scenario_frontier(point, tmp, mp):
    with pytest.raises(FaultInjected) as exc:
        solve(fixture_data("nested_correct.json"), backend=GpuFrontierBackend(device="cpu"))
    assert exc.value.point == "frontier.chunk"


def _scenario_checkpoint(point, tmp, mp):
    rec = telemetry.get_run_record()
    ck = SweepCheckpoint(tmp / "c.ckpt")
    res = solve(synth.majority_fbas(9), backend=_sweep(checkpoint=ck, batch=32))
    assert res.intersects is True
    assert rec.counters["checkpoint.save_errors"] >= 1


def _scenario_cert(point, tmp, mp):
    rec = telemetry.get_run_record()
    res = solve(synth.majority_fbas(5), backend="python")
    assert write_certificate(res.cert, str(tmp / "c.json")) is None
    assert rec.counters["cert.write_errors"] == 1


def _scenario_native_build(point, tmp, mp):
    rec = telemetry.get_run_record()
    mp.setattr(cpp, "BUILD_DIR", tmp / "native")  # nothing built there: the build runs
    mp.setattr(cpp, "_lib", None)
    res = solve(fixture_data("trivial_broken.json"), backend=AutoBackend(device="cpu", race=False))
    assert res.intersects is False and res.stats["backend"] == "python"
    assert [e["attrs"]["to"] for e in rec.events if e["name"] == "degrade"] == ["python-oracle"]


def _scenario_native_call(point, tmp, mp):
    rec = telemetry.get_run_record()
    res = solve(fixture_data("trivial_broken.json"), backend=AutoBackend(device="cpu", race=False))
    want = solve(fixture_data("trivial_broken.json"), backend="python")
    assert (res.intersects, res.q1, res.q2) == (want.intersects, want.q1, want.q2)
    assert res.stats["backend"] == "python"
    assert [e["attrs"]["rung"] for e in rec.events if e["name"] == "degrade"] == ["native"]


def _scenario_dump(point, tmp, mp):
    rec = telemetry.get_run_record()
    assert telemetry.dump_flight_recorder("test", path=str(tmp / "f.json")) is None
    assert rec.counters["telemetry.dump_errors"] == 1


def _scenario_query(point, tmp, mp):
    fa, fb = synth.two_family_preset(core=6, watchers=0, seed=1)
    with pytest.raises(QueryError) as exc:
        QueryEngine(backend="python", device="cpu").resolve(fa, Query.parse({"kind": "relaxed", "family_b": fb}))
    assert exc.value.code == "query_degraded"


def _scenario_delta_diff(point, tmp, mp):
    rec = telemetry.get_run_record()
    data = synth.benchmark_fbas(14, 6, broken=True, seed=3)
    res = DeltaEngine(device="cpu").check_many([data], backend=_sweep())[0]
    want = solve(data, backend=_sweep())
    assert (res.intersects, res.q1, res.q2) == (want.intersects, want.q1, want.q2)
    assert rec.counters["delta.diff_faults"] == 1 and "delta" not in res.cert["provenance"]


def _scenario_fleet_store(point, tmp, mp):
    rec = telemetry.get_run_record()
    engine = DeltaEngine(SccVerdictStore(shared=SharedSccStore(tmp / "store")), device="cpu")
    res = engine.check_many([synth.majority_fbas(5)], backend="python")[0]
    assert res.intersects is True and rec.counters["fleet.store_errors"] >= 1
    assert not (tmp / "store").exists()


def _scenario_cost(point, tmp, mp):
    rec = telemetry.get_run_record()
    engine = DeltaEngine(device="cpu")
    first, again = (engine.check_many([synth.majority_fbas(5)], backend="python")[0] for _ in range(2))
    assert first.intersects is again.intersects is True
    assert again.cert["provenance"]["delta"]["reused_sccs"] == 1 and "cost" not in again.cert["provenance"]
    assert rec.counters["cost.attribute_errors"] == 1


def _served(tmp, submit_raises=None, **engine_kw):
    """One request through a fresh ServeEngine on the host; the response, or
    the exception ``submit_raises`` names (from admission or delivery)."""
    from quorum_intersection_tpu_torch.serve import ServeEngine

    engine = ServeEngine(backend="python", device="cpu", **engine_kw)
    engine.start()
    try:
        if submit_raises is not None:
            with pytest.raises(submit_raises):
                engine.submit(synth.majority_fbas(5), request_id="r0").result(timeout=30.0)
            return None
        res = engine.submit(synth.majority_fbas(5), request_id="r0").result(timeout=30.0)
        assert res.intersects is True
        return res
    finally:
        engine.stop(drain=True, timeout=30.0)


def _scenario_serve_counter(counter, **engine_kw):
    def scenario(point, tmp, mp):
        if "journal" in engine_kw:
            engine_kw["journal"] = tmp / "j.jsonl"
        _served(tmp, **engine_kw)
        assert telemetry.get_run_record().counters[counter] >= 1
    return scenario


class _FleetOf:
    """A started fleet of in-process workers on the host (python backend),
    probes only on demand unless asked, no respawn; always stopped."""

    def __init__(self, tmp, n=2, **kw):
        from quorum_intersection_tpu_torch.fleet import FleetEngine

        kw.setdefault("probe_interval_s", 30.0)
        self.engine = FleetEngine(n, backend="python", worker_mode="local", device="cpu", journal_dir=tmp / "fleet",
                                  respawn_max=0, **kw)

    def __enter__(self):
        self.engine.start()
        return self.engine

    def __exit__(self, *exc):
        self.engine.stop(drain=True, timeout=30.0)
        return False


class _PeerOf:
    """One in-process socket server of the port on the host."""

    def __init__(self, journal=None):
        from quorum_intersection_tpu_torch.serve import ServeEngine
        from quorum_intersection_tpu_torch.serve_transport import SocketServeServer

        self.engine = ServeEngine(backend="python", device="cpu", journal=journal)
        self.engine.start()
        self.server = SocketServeServer(self.engine, port=0, emit_certs=True)
        self.addr = f"127.0.0.1:{self.server.port}"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.server.stop()
        self.engine.stop(drain=True, timeout=30.0)
        return False


def _lapsed(fleet, wid):
    fleet._suspect_worker(wid, "forced partition (test)")
    with fleet._lock:
        fleet._leases[wid] = time.monotonic() - 1.0


def _scenario_fleet_route(point, tmp, mp):
    with _FleetOf(tmp) as fleet:
        assert fleet.submit(synth.majority_fbas(5)).result(timeout=30.0).intersects is True
    assert telemetry.get_run_record().counters["fleet.route_errors"] >= 1


def _scenario_fleet_probe(point, tmp, mp):
    rec = telemetry.get_run_record()
    with _FleetOf(tmp, probe_interval_s=0.05) as fleet:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and rec.snapshot()[0].get("fleet.probe_errors", 0) < 2:
            time.sleep(0.02)
        assert fleet.worker_ids() == ["w0", "w1"]
    assert rec.counters["fleet.probe_errors"] >= 2 and rec.counters.get("fleet.evictions", 0) == 0


def _scenario_fleet_replay(point, tmp, mp):
    from quorum_intersection_tpu_torch.serve import RequestJournal

    journal = RequestJournal(tmp / "dead.journal")
    journal.append_request("orphan", "fp", synth.majority_fbas(5), None)
    journal.close()
    with _FleetOf(tmp) as fleet:
        assert fleet.adopt_journal(journal.path) == 0
        assert fleet.submit(synth.majority_fbas(5)).result(timeout=30.0).intersects is True
    assert telemetry.get_run_record().counters["fleet.replay_errors"] == 1


def _scenario_fleet_join(point, tmp, mp):
    with _PeerOf() as peer:
        with _FleetOf(tmp, n=1, joins=[peer.addr]) as fleet:
            assert fleet.worker_ids() == ["w0"]
            assert fleet.submit(synth.majority_fbas(5)).result(timeout=30.0).intersects is True
    rec = telemetry.get_run_record()
    assert rec.counters["fleet.join_errors"] == 1 and rec.counters.get("fleet.joins", 0) == 0


def _scenario_fleet_lease(point, tmp, mp):
    with _FleetOf(tmp) as fleet:
        _lapsed(fleet, "w1")
        fleet._expire_leases()
        assert fleet.worker_ids() == ["w0", "w1"]  # suspect-only
    rec = telemetry.get_run_record()
    assert rec.counters["fleet.lease_errors"] == 1 and rec.counters.get("fleet.evictions", 0) == 0


def _scenario_fleet_hedge(point, tmp, mp):
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.serve import snapshot_fingerprint

    nodes = synth.majority_fbas(7)
    with _FleetOf(tmp) as fleet:
        fleet._suspect_worker(fleet._ring.route(snapshot_fingerprint(build_graph(parse_fbas(nodes)))), "test")
        assert fleet.submit(nodes).result(timeout=30.0).intersects is True
    rec = telemetry.get_run_record()
    assert rec.counters["fleet.hedge_errors"] >= 1 and rec.counters.get("fleet.hedges", 0) == 0


def _scenario_fleet_ship(point, tmp, mp):
    with _PeerOf(journal=tmp / "peer.journal") as peer:
        with _FleetOf(tmp, n=1, joins=[peer.addr]) as fleet:
            _lapsed(fleet, "j0")
            fleet._expire_leases()
            assert fleet.worker_ids() == ["w0"]
    rec = telemetry.get_run_record()
    assert rec.counters["fleet.ship_errors"] == 1 and rec.counters.get("fleet.ships", 0) == 0


def _scenario_fleet_scale(point, tmp, mp):
    with _FleetOf(tmp, n=1) as fleet:
        fleet.scale_up_ms = -1.0  # would scale up if healthy
        assert fleet.scale_tick(force=True) is None and fleet.worker_ids() == ["w0"]
    assert telemetry.get_run_record().counters["fleet.scale_errors"] == 1


def _scenario_store_fetch(point, tmp, mp):
    from quorum_intersection_tpu_torch.delta import RemoteStoreClient
    from quorum_intersection_tpu_torch.fleet import StoreGateway

    gateway = StoreGateway(SharedSccStore(tmp / "store"))
    client = RemoteStoreClient("127.0.0.1", gateway.port, timeout_s=0.5, retries=1)
    try:
        assert client.fetch("scan", "fp") is None
    finally:
        client.close()
        gateway.stop()
    assert telemetry.get_run_record().counters["store.fetch_errors"] == 1


def _scenario_pulse_aggregate(point, tmp, mp):
    from quorum_intersection_tpu_torch.serve_transport import pong_payload

    rec = telemetry.get_run_record()
    with _FleetOf(tmp) as fleet:
        assert fleet.submit(synth.majority_fbas(5)).result(timeout=30.0).intersects is True
        fleet._aggregate_health({"w0": pong_payload("t")})
    assert rec.counters["pulse.agg_errors"] == 1 and "fleet.pulse.e2e_ms" not in rec.histograms_snapshot()


def _scenario_distributed_init(point, tmp, mp):
    from quorum_intersection_tpu_torch.parallel import distributed

    mp.setattr(distributed, "_initialized", False)
    mp.setattr(distributed, "_retry_sleep", lambda s: None)
    mp.setenv("QI_DIST_INIT_TIMEOUT_S", "0")
    distributed.initialize(coordinator_address="127.0.0.1:1", num_processes=2, process_id=0, backend="gloo")
    ev = [e for e in telemetry.get_run_record().events if e["name"] == "distributed.init_degraded"]
    assert len(ev) == 1 and "injected" in ev[0]["attrs"]["cause"] and not distributed.is_multihost()


SCENARIOS = {
    "sweep.prune": ("error", lambda p, tmp, mp: _fails_solve(p, prune=True)),
    "sweep.bitset": ("error", lambda p, tmp, mp: (_fails_solve(p, engine="bitset"), _scenario_packed_bitset(p))),
    "sweep.dispatch": ("oom", lambda p, tmp, mp: _fails_solve(p)),
    "sweep.compile": ("error", lambda p, tmp, mp: _fails_solve(p)),
    "sweep.window": ("preempt", lambda p, tmp, mp: _fails_solve(p)),
    "sweep.pack": ("error", _scenario_sweep_pack),
    "frontier.chunk": ("oom", _scenario_frontier),
    "checkpoint.write": ("oserror", _scenario_checkpoint),
    "cert.write": ("oserror", _scenario_cert),
    "native.build": ("error", _scenario_native_build),
    "native.call": ("error", _scenario_native_call),
    "telemetry.dump": ("oserror", _scenario_dump),
    "query.dispatch": ("error", _scenario_query),
    "delta.diff": ("error", _scenario_delta_diff),
    "fleet.store": ("oserror", _scenario_fleet_store),
    "cost.attribute": ("error", _scenario_cost),
    "serve.admit": ("error", lambda p, tmp, mp: _served(tmp, submit_raises=FaultInjected)),
    "serve.cache": ("error", _scenario_serve_counter("serve.cache_errors")),
    "serve.journal": ("oserror", _scenario_serve_counter("serve.journal_errors", journal=True)),
    "serve.drain": ("error", _scenario_serve_counter("serve.drain_faults")),
    "serve.respond": ("error", lambda p, tmp, mp: _served(tmp, submit_raises=FaultInjected)),
    "serve.fuse": ("error", _scenario_serve_counter("serve.fuse_faults", fuse_window_ms=5)),
    "fleet.route": ("error", _scenario_fleet_route),
    "fleet.probe": ("error", _scenario_fleet_probe),
    "fleet.replay": ("error", _scenario_fleet_replay),
    "fleet.join": ("error", _scenario_fleet_join),
    "fleet.lease": ("error", _scenario_fleet_lease),
    "fleet.hedge": ("error", _scenario_fleet_hedge),
    "fleet.ship": ("error", _scenario_fleet_ship),
    "fleet.scale": ("error", _scenario_fleet_scale),
    "store.fetch": ("oserror", _scenario_store_fetch),
    "pulse.aggregate": ("error", _scenario_pulse_aggregate),
    "distributed.init": ("error", _scenario_distributed_init),
}


def test_every_declared_point_has_a_scenario():
    assert set(SCENARIOS) == set(faults.registry())


@pytest.mark.parametrize("point", sorted(SCENARIOS))
def test_point_is_reached_and_handled(point, tmp_path, monkeypatch, rec):
    mode, scenario = SCENARIOS[point]
    plan = _plan(f"{point}={mode}")
    scenario(point, tmp_path, monkeypatch)
    assert plan.counts.get(point, 0) >= 1
    assert plan.fired and all(p == point for p, _, _ in plan.fired)
    assert rec.counters["faults.injected"] == len(plan.fired)


# ---- the disk-full cases ------------------------------------------------------


def test_injected_disk_full_counts_and_cleans_tmp(tmp_path, rec):
    _plan("checkpoint.write=oserror@1+")
    p = tmp_path / "c.ckpt"
    SweepCheckpoint(p).record(5, 10)
    assert rec.counters.get("checkpoint.save_errors") == 1
    assert not p.exists() and not p.with_suffix(".tmp").exists()
    ev = [e for e in rec.events if e["name"] == "checkpoint.save_error"]
    assert ev and "injected disk full" in ev[0]["attrs"]["error"]
    FrontierCheckpoint(tmp_path / "f.ckpt").record([[[1], [2]]], fingerprint="fp")
    assert rec.counters.get("checkpoint.save_errors") == 2


def test_sweep_verdict_identical_with_and_without_faults(tmp_path, rec):
    data = synth.majority_fbas(9, broken=True)
    clean = solve(data, backend=_sweep(batch=32))
    _plan("checkpoint.write=oserror@1+")
    faulted = solve(data, backend=_sweep(checkpoint=SweepCheckpoint(tmp_path / "c.ckpt"), batch=32))
    assert faulted.intersects is clean.intersects is False
    assert (faulted.q1, faulted.q2, faulted.stats["hit_index"]) == (clean.q1, clean.q2, clean.stats["hit_index"])


@pytest.mark.parametrize("point", ["cert.write", "checkpoint.write"])
def test_host_faults_keep_the_cli_verdict(point, tmp_path, monkeypatch, capsys, rec):
    data = json.dumps(synth.majority_fbas(9))
    argv = ["--device", "cpu", "--backend", "gpu-sweep", "--cert-out", str(tmp_path / "c.json"),
            "--checkpoint", str(tmp_path / "s.ckpt")]
    monkeypatch.setenv("QI_FAULTS", f"{point}=oserror")
    monkeypatch.setattr("sys.stdin", io.StringIO(data))
    assert cli.main(argv) == 0
    assert capsys.readouterr().out == "true\n"
    counter = {"cert.write": "cert.write_errors", "checkpoint.write": "checkpoint.save_errors"}[point]
    assert telemetry.get_run_record().counters.get(counter, 0) >= 1


def test_preempted_window_resumes_from_the_checkpoint(tmp_path, rec):
    """A preempt at the 40th window, after 8 programs drained: the checkpoint
    on disk holds the drained prefix, and the rerun resumes there to the
    uninterrupted verdict and hit index."""
    data = late_hit_fbas()
    plain = solve(data, backend=_sweep(batch=32))
    assert plain.stats["hit_index"] == 4111
    path = tmp_path / "s.ckpt"
    _plan("sweep.window=preempt@40")
    with pytest.raises(FaultPreempted):
        solve(data, backend=_sweep(batch=32, checkpoint=SweepCheckpoint(path)))
    faults.clear_plan()
    recorded = json.loads(path.read_text())["position"]
    assert 0 < recorded < plain.stats["hit_index"]
    res = solve(data, backend=_sweep(batch=32, checkpoint=SweepCheckpoint(path)))
    assert res.stats["resumed_from"] == recorded
    assert (res.intersects, res.stats["hit_index"], res.q1, res.q2) == \
        (plain.intersects, plain.stats["hit_index"], plain.q1, plain.q2)
    assert not path.exists()


def test_cli_sweep_fault_exits_with_an_error_and_no_verdict(monkeypatch, capsys):
    monkeypatch.setenv("QI_FAULTS", "sweep.dispatch=error")
    monkeypatch.setattr("sys.stdin", io.StringIO(json.dumps(synth.majority_fbas(9))))
    with pytest.raises(FaultInjected, match="sweep.dispatch"):
        cli.main(["--device", "cpu", "--backend", "gpu-sweep"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("spec", ["sweep.pack=error", "sweep.dispatch=oom", "sweep.compile=error"])
def test_auto_packed_rung_fails_not_degrades(spec):
    _plan(spec)
    with pytest.raises(FaultInjected):
        check_many([synth.majority_fbas(7), synth.majority_fbas(9)], backend=AutoBackend(device="cpu", pack=True))


def test_flight_recorder_dump_on_fault(tmp_path, monkeypatch, rec):
    target = tmp_path / "flight.json"
    monkeypatch.setenv("QI_FLIGHT_RECORDER", str(target))
    _plan("sweep.dispatch=error")
    with pytest.raises(FaultInjected):
        solve(synth.majority_fbas(5), backend=_sweep())
    dump = json.loads(target.read_text())
    assert dump["schema"] == "qi-flight/1" and dump["reason"] == "fault:sweep.dispatch:error"
    assert dump["counters"]["faults.injected"] == 1
    assert any(line["name"] == "fault.injected" for line in dump["tail"])
    assert rec.counters["telemetry.dumps"] == 1
    assert not os.path.exists(str(target) + f".tmp{os.getpid()}")
