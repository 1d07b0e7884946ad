"""The port's replicated serve tier (``fleet.py``) against the JAX package's,
on the CPU: twins of ``tests/test_qi_fleet.py``.

- the consistent-hash ring places 1000 seeded keys on the JAX ring's worker,
  for several worker sets and vnode counts, with bounded rebalance;
- the two-level SCC store: cross-store reuse, scoping, a dead shared tier,
  forged fragments;
- fleets of in-process workers (``device="cpu"``) on the four fixture pairs,
  N=2 and N=4, on ``python`` and ``cpp``: every response line equals the
  JAX fleet's once the wall fields (``_torch_serve_cases.WALL_FIELDS``) and
  the per-run trace id are dropped, the verdict and witness equal a single
  engine's, and every certificate passes the unmodified checker;
- the cross-worker composed fragment, duplicate request ids, zipfian stream
  parity, the journal-inheritance matrix, kill-one for an in-process worker
  and a SIGKILL of a ``ProcWorker`` running the port's ``serve --device cpu``;
- the four ``fleet.*`` fault points of the front door;
- the five forced interleavings of ``tools/analyze/schedules.py`` on both
  topologies, through the port's ``fleet._fleet_sync``;
- the ``fleet`` CLI and ``/healthz``, ``/readyz``.

Every wait has a bound.
"""

import io
import json
import random
import sys
import tempfile
import threading
import time
from pathlib import Path

import pytest
import torch

from quorum_intersection_tpu import cost as jax_cost
from quorum_intersection_tpu import fleet as jax_fleet
from quorum_intersection_tpu import serve_transport as jax_transport
from quorum_intersection_tpu.utils import faults as jax_faults
from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu_torch import cost, fleet as fleet_mod, serve_transport
from quorum_intersection_tpu_torch.delta import SccScan, SccVerdict, SccVerdictStore, SharedSccStore
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.fbas.synth import churn_trace, majority_fbas
from quorum_intersection_tpu_torch.fleet import FleetEngine, HashRing
from quorum_intersection_tpu_torch.pipeline import solve
from quorum_intersection_tpu_torch.serve import RequestJournal, ServeEngine, snapshot_fingerprint
from quorum_intersection_tpu_torch.utils import faults, telemetry
from quorum_intersection_tpu_torch.utils.metrics_server import healthz_payload, readyz_payload
from tools.analyze.schedules import _REQUIRED_FLEET_POINTS, FLEET_SCHEDULES, WAIT_S, SyncController
from tools.check_cert import check_certificate

from _torch_cases import fixture_data
from _torch_serve_cases import comparable

torch.set_num_threads(1)

FIXTURES = [("trivial_correct", True), ("trivial_broken", False),
            ("nested_correct", True), ("nested_broken", False)]
# The wire trace echo names the front door's run and span: one more field
# that differs between any two runs.
RUN_FIELDS = ("trace",)


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


def fingerprint_of(nodes):
    return snapshot_fingerprint(build_graph(parse_fbas(nodes)))


def fleet_line(line):
    out = comparable(line)
    for name in RUN_FIELDS:
        out.pop(name, None)
    return out


class _Fleet:
    """A started fleet of in-process workers of either package that always
    stops (bounded)."""

    def __init__(self, tmp_path, n=2, jax=False, **kw):
        kw.setdefault("backend", "python")
        kw.setdefault("worker_mode", "local")
        kw.setdefault("journal_dir", tmp_path / ("jax-fleet" if jax else "fleet"))
        kw.setdefault("probe_interval_s", 30.0)  # probes only on demand
        if not jax:
            kw.setdefault("device", "cpu")
        self.engine = (jax_fleet.FleetEngine if jax else FleetEngine)(n, **kw)

    def __enter__(self):
        self.engine.start()
        return self.engine

    def __exit__(self, *exc):
        self.engine.stop(drain=True, timeout=30.0)
        return False


def fleet_session(lines, tmp_path, jax=False, **kw):
    """One JSONL conversation through a fleet of either package, every line
    admitted before the answers are awaited; the response objects by id."""
    out = io.StringIO()
    module = jax_transport if jax else serve_transport
    with _Fleet(tmp_path, jax=jax, **kw) as fleet:
        session = module.JsonlSession(fleet, out, emit_certs=True)
        for n, line in enumerate(lines):
            session.handle_line(n, line)
        assert session.wait_drained(timeout=30.0)
    objs = [json.loads(ln) for ln in out.getvalue().splitlines()]
    return {o.get("request_id", o.get("pong")): o for o in objs}


def _wait_counter(record, name, want, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if record.snapshot()[0].get(name, 0) >= want:
            break
        time.sleep(0.02)
    return record.snapshot()[0].get(name, 0)


# ---------------------------------------------------------------------------
# the consistent-hash ring


class TestHashRing:
    @pytest.mark.parametrize("workers,vnodes", [(("w0", "w1"), 32), (("w0", "w1", "w2", "w3"), 32),
                                                (("w0", "j0", "e1", "w1.r1", "w2"), 7), (("a",), 1)])
    def test_same_owner_as_the_jax_ring(self, workers, vnodes):
        rng = random.Random(11)
        keys = [f"{rng.getrandbits(256):064x}" for _ in range(1000)]
        port, jax = HashRing(vnodes=vnodes), jax_fleet.HashRing(vnodes=vnodes)
        for w in workers:
            port.add(w)
            jax.add(w)
        assert [port.route(k) for k in keys] == [jax.route(k) for k in keys]
        exclude = {workers[0]}
        assert [port.route_excluding(k, exclude) for k in keys[:200]] == [
            jax.route_excluding(k, exclude) for k in keys[:200]]
        assert port.workers() == jax.workers() and len(port) == len(jax)

    def test_vnodes_default_is_the_jax_default(self, monkeypatch):
        assert HashRing().vnodes == jax_fleet.HashRing().vnodes == 32
        monkeypatch.setenv("QI_FLEET_VNODES", "5")
        assert HashRing().vnodes == jax_fleet.HashRing().vnodes == 5

    def test_bounded_rebalance_on_leave_and_join(self):
        ring = HashRing(vnodes=32)
        for w in ("w0", "w1", "w2", "w3"):
            ring.add(w)
        keys = [f"fp-{i:04d}" for i in range(400)]
        before = {k: ring.route(k) for k in keys}
        ring.remove("w1")
        moved = [k for k in keys if ring.route(k) != before[k]]
        assert moved and all(before[k] == "w1" for k in moved)
        assert len(moved) == sum(1 for v in before.values() if v == "w1")
        ring.add("w1")
        assert {k: ring.route(k) for k in keys} == before
        ring.add("w4")
        moved = [k for k in keys if ring.route(k) != before[k]]
        assert moved and all(ring.route(k) == "w4" for k in moved) and len(moved) < len(keys) / 2

    def test_empty_ring_raises(self):
        with pytest.raises(LookupError):
            HashRing().route("fp")
        assert HashRing().route_excluding("fp", set()) is None


# ---------------------------------------------------------------------------
# the two-level SCC verdict store


class TestSharedStore:
    def test_cross_store_verdict_reuse(self, rec, tmp_path):
        a = SccVerdictStore(64, shared=SharedSccStore(tmp_path / "store"))
        assert a.lease_verdict("fp-1", False)[0] == "leader"
        a.publish_verdict("fp-1", False, SccVerdict(intersects=True, q1_local=None, q2_local=None,
                                                    stats={"backend": "python"}))
        b = SccVerdictStore(64, shared=SharedSccStore(tmp_path / "store"))
        outcome, verdict = b.lease_verdict("fp-1", False)
        assert outcome == "hit" and verdict.intersects is True and verdict.stats["backend"] == "python"
        assert rec.counters.get("fleet.store_hits", 0) >= 1

    def test_cross_store_scan_reuse_and_scope_bit(self, rec, tmp_path):
        a = SccVerdictStore(64, shared=SharedSccStore(tmp_path / "s"))
        a.put_scan("scan-fp", SccScan(quorum_local=(0, 2, 3)))
        b = SccVerdictStore(64, shared=SharedSccStore(tmp_path / "s"))
        assert b.get_scan("scan-fp").quorum_local == (0, 2, 3)
        a.lease_verdict("fp-s", True)
        a.publish_verdict("fp-s", True, SccVerdict(intersects=False, q1_local=[0], q2_local=[1], stats={}))
        assert b.lease_verdict("fp-s", False)[0] == "leader"  # the other scoping: a miss
        b.publish_verdict("fp-s", False, None)

    def test_store_fault_degrades_to_local(self, rec, tmp_path):
        faults.install_plan(faults.parse_faults("fleet.store=error@1+"))
        store = SccVerdictStore(64, shared=SharedSccStore(tmp_path / "s"))
        store.put_scan("fp-x", SccScan(quorum_local=(1,)))
        assert store.get_scan("fp-x").quorum_local == (1,)
        assert rec.counters["fleet.store_errors"] >= 1
        faults.clear_plan()
        assert SccVerdictStore(64, shared=SharedSccStore(tmp_path / "s")).get_scan("fp-x") is None

    def test_forged_fragment_is_a_miss_never_trusted(self, rec, tmp_path):
        root = tmp_path / "store"
        root.mkdir()
        (root / "verdict-s0-forged.json").write_text("{not json", "utf-8")
        (root / "verdict-s0-shape.json").write_text(json.dumps({"intersects": "yes", "stats": {}}), "utf-8")
        store = SccVerdictStore(64, shared=SharedSccStore(root))
        for fp in ("forged", "shape"):
            assert store.lease_verdict(fp, False) == ("leader", None)
            store.publish_verdict(fp, False, None)


# ---------------------------------------------------------------------------
# the fleet against a single engine and against the JAX fleet


class TestFleetDifferential:
    @pytest.mark.parametrize("backend", ["python", "cpp"])
    @pytest.mark.parametrize("n", [2, 4])
    @pytest.mark.parametrize("fixture,verdict", FIXTURES)
    def test_lines_equal_the_jax_fleet_and_a_single_engine(self, rec, tmp_path, fixture, verdict, n, backend):
        nodes = fixture_data(f"{fixture}.json")
        lines = [json.dumps({"request_id": "r0", "nodes": nodes, "client": "c"}), json.dumps({"ping": "p"})]
        got = fleet_session(lines, tmp_path, n=n, backend=backend)
        want = fleet_session(lines, tmp_path, jax=True, n=n, backend=backend)
        assert fleet_line(got["r0"]) == fleet_line(want["r0"])
        assert got["r0"]["verdict"] is verdict
        single = ServeEngine(backend=backend, device="cpu")
        single.start()
        try:
            ref = single.submit(nodes).result(timeout=30.0)
        finally:
            single.stop(drain=True, timeout=30.0)
        assert ref.intersects is verdict
        cert = got["r0"]["cert"]
        if not verdict:
            assert (cert["witness"]["q1"], cert["witness"]["q2"]) == (ref.cert["witness"]["q1"],
                                                                      ref.cert["witness"]["q2"])
        check_certificate(cert, nodes)
        assert set(got["p"]) == set(want["p"]) and got["p"]["ready"] is want["p"]["ready"] is True

    def test_cross_worker_composed_fragment(self, rec, tmp_path):
        """A fragment solved on one worker composes into a certificate
        answered by the other: key-renamed twins share the SCC fingerprint
        while their snapshot fingerprints route to different workers."""
        with _Fleet(tmp_path, n=2, store_dir=tmp_path / "store") as fleet:
            base = majority_fbas(7, prefix="CWAAA")
            base_w = fleet._ring.route(fingerprint_of(base))
            other = next(c for c in (majority_fbas(7, prefix=t) for t in ("CWBBB", "CWCCC", "CWDDD", "CWEEE"))
                         if fleet._ring.route(fingerprint_of(c)) != base_w)
            assert fleet.submit(base).result(timeout=30.0).intersects is True
            second = fleet.submit(other).result(timeout=30.0)
        assert second.intersects is True
        stamp = second.cert["provenance"]["delta"]
        assert (stamp["reused_sccs"], stamp["resolved_sccs"]) == (1, 0)
        check_certificate(second.cert, other)
        assert rec.counters.get("fleet.store_hits", 0) >= 1

    def test_duplicate_request_id_resolves_both(self, rec, tmp_path):
        nodes = majority_fbas(5, prefix="DUP")
        with _Fleet(tmp_path, n=2) as fleet:
            t1 = fleet.submit(nodes, request_id="same-id")
            t2 = fleet.submit(nodes, request_id="same-id")
            r1, r2 = t1.result(timeout=30.0), t2.result(timeout=30.0)
        assert r1.intersects is r2.intersects is True and r1.request_id == r2.request_id == "same-id"
        assert rec.counters.get("fleet.verdicts", 0) + rec.counters.get("fleet.errors", 0) == 2

    def test_zipfian_stream_parity_with_the_jax_fleet(self, rec, tmp_path):
        trace = churn_trace(majority_fbas(7, prefix="ZPF"), 14, seed=2, skew=1.1)
        assert len({json.dumps(s) for s in trace}) < len(trace)  # hot keys repeat
        # Whether a repeat is a cache hit or a coalesced waiter is timing;
        # the verdicts are not.
        lines = [json.dumps({"request_id": f"z{i}", "nodes": s}) for i, s in enumerate(trace)]
        got = fleet_session(lines, tmp_path)
        want = fleet_session(lines, tmp_path, jax=True)
        for i, snap in enumerate(trace):
            assert got[f"z{i}"]["verdict"] is want[f"z{i}"]["verdict"] is solve(
                snap, backend="python", device="cpu").intersects


# ---------------------------------------------------------------------------
# failover


def _journal_with_matrix(tmp_path, pending, done):
    """A dead worker's journal: two pending requests, one done pair and a torn
    tail."""
    path = tmp_path / "dead.journal"
    journal = RequestJournal(path)
    journal.append_request("pend-a", fingerprint_of(pending[0]), pending[0], None)
    journal.append_request("done-b", fingerprint_of(done), done, None)
    journal.append_done("done-b", fingerprint_of(done), "verdict", True)
    journal.append_request("pend-c", fingerprint_of(pending[1]), pending[1], None)
    journal.close()
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"kind": "req", "request_id": "torn-tail", "nod\n')
    return path


class TestFailover:
    def test_journal_inheritance_matrix(self, rec, tmp_path):
        pend = [majority_fbas(5, prefix="INH0"), majority_fbas(5, broken=True, prefix="INH1")]
        path = _journal_with_matrix(tmp_path, pend, majority_fbas(5, prefix="INH2"))
        with _Fleet(tmp_path, n=2) as fleet:
            assert fleet.adopt_journal(path) == 2  # pend-a and pend-c; done-b skipped
            assert _wait_counter(rec, "fleet.replayed_verdicts", 2) == 2
        assert rec.counters["fleet.replays"] == 2
        assert rec.snapshot()[1]["fleet.replay_complete"] == 1

    def test_kill_one_local_rerouted(self, rec, tmp_path):
        snaps = [majority_fbas(n, broken=b, prefix="KLL") for n in (5, 7, 9) for b in (False, True)]
        expected = [solve(s, backend="python", device="cpu").intersects for s in snaps]
        with _Fleet(tmp_path, n=2, batch_max=2) as fleet:
            tickets = [fleet.submit(s) for s in snaps]
            fleet.kill_worker(fleet.worker_ids()[0], evict=True)
            got = [t.result(timeout=30.0).intersects for t in tickets]
        assert got == expected
        assert rec.counters["fleet.evictions"] == 1

    def test_proc_worker_sigkill_zero_lost(self, rec, tmp_path):
        """Subprocess workers running the port's ``serve --device cpu``; one
        is SIGKILLed with requests in flight, its journal inherited by the
        survivor: every ticket resolves once with the oracle's verdict."""
        trace = churn_trace(majority_fbas(9, prefix="SGK"), 5, seed=4)
        expected = [solve(s, backend="python", device="cpu").intersects for s in trace]
        fleet = FleetEngine(2, backend="python", worker_mode="subprocess", device="cpu",
                            journal_dir=tmp_path / "proc", probe_interval_s=0.2, respawn_max=0)
        fleet.start()
        try:
            assert fleet.worker_ids() == ["w0", "w1"]
            cmd = fleet._workers["w0"]._proc.args
            assert cmd[1:4] == ["-m", "quorum_intersection_tpu_torch", "serve"]
            assert cmd[cmd.index("--device") + 1] == "cpu"
            tickets = [fleet.submit(s) for s in trace[:4]]
            fleet.kill_worker("w0")  # a real SIGKILL; the probes find it
            tickets += [fleet.submit(s) for s in trace[4:]]
            got = [t.result(timeout=60.0).intersects for t in tickets]
        finally:
            fleet.stop(drain=True, timeout=30.0)
        assert got == expected
        assert rec.counters["fleet.evictions"] == 1 and rec.counters.get("fleet.errors", 0) == 0


# ---------------------------------------------------------------------------
# the front door's fault points: typed or oracle-equal


def _fault_snaps():
    snaps = [majority_fbas(n, broken=b, prefix="FLT") for n in (5, 7) for b in (False, True)]
    return snaps, [solve(s, backend="python", device="cpu").intersects for s in snaps]


class TestFleetFaultPoints:
    def _all_ok(self, fleet, snaps, expected):
        return [fleet.submit(s).result(timeout=30.0).intersects for s in snaps] == expected

    def test_route_fault_degrades_to_first_live(self, rec, tmp_path):
        snaps, expected = _fault_snaps()
        faults.install_plan(faults.parse_faults("fleet.route=error@1+"))
        with _Fleet(tmp_path, n=2) as fleet:
            assert self._all_ok(fleet, snaps, expected)
        assert rec.counters["fleet.route_errors"] >= len(snaps)

    def test_store_fault_degrades_to_local_lru(self, rec, tmp_path):
        snaps, expected = _fault_snaps()
        faults.install_plan(faults.parse_faults("fleet.store=error@1+"))
        with _Fleet(tmp_path, n=2, store_dir=tmp_path / "store") as fleet:
            assert self._all_ok(fleet, snaps, expected)
        assert rec.counters["fleet.store_errors"] >= 1

    def test_probe_fault_never_evicts(self, rec, tmp_path):
        snaps, expected = _fault_snaps()
        faults.install_plan(faults.parse_faults("fleet.probe=error@1+"))
        with _Fleet(tmp_path, n=2, probe_interval_s=0.05) as fleet:
            assert _wait_counter(rec, "fleet.probe_errors", 2, timeout=5.0) >= 2
            assert self._all_ok(fleet, snaps, expected)
            assert len(fleet.worker_ids()) == 2
        assert rec.counters.get("fleet.evictions", 0) == 0

    def test_replay_fault_degrades_to_inflight_reroute(self, rec, tmp_path):
        pend = majority_fbas(5, prefix="RPL")
        journal = RequestJournal(tmp_path / "dead.journal")
        journal.append_request("orphan", fingerprint_of(pend), pend, None)
        journal.close()
        snaps, expected = _fault_snaps()
        faults.install_plan(faults.parse_faults("fleet.replay=error@1"))
        with _Fleet(tmp_path, n=2) as fleet:
            assert fleet.adopt_journal(journal.path) == 0  # degraded: the journal skipped, loudly
            assert self._all_ok(fleet, snaps, expected)
        assert rec.counters["fleet.replay_errors"] == 1


# ---------------------------------------------------------------------------
# forced interleavings (the twins of tools/analyze/schedules.py's fleet ones)


def _run_schedule(schedule, data, expected, topology):
    """One forced ordering through the port's ``_fleet_sync``; the error, or
    None when the ordering happened and the verdict is right."""
    ctl = SyncController()
    old_sync = fleet_mod._fleet_sync
    fleet_mod._fleet_sync = ctl
    engine = None
    tmp = tempfile.TemporaryDirectory(prefix="qi-fleet-sched-")
    verdict, error = None, None
    try:
        engine = FleetEngine(2, backend="python", worker_mode="local", journal_dir=tmp.name,
                             probe_interval_s=60.0, device="cpu")
        engine.start()
        fp = fingerprint_of(data)
        target = engine._ring.route(fp)

        def in_thread(fn):
            box = {}

            def run():
                try:
                    box["value"] = fn()
                except Exception as exc:  # noqa: BLE001 — the failure is the observable
                    box["error"] = exc
            th = threading.Thread(target=run, daemon=True)
            th.start()
            return th, box

        if schedule == "fleet_route_during_eviction":
            ctl.hold("route.resolved", ctl.reached_event("evict.removed"))
            th, box = in_thread(lambda: engine.submit(data))
            assert ctl.reached_event("route.resolved").wait(WAIT_S), "submit never resolved a route"
            engine.kill_worker(target, evict=True)
            th.join(WAIT_S)
            assert not th.is_alive() and "error" not in box, box
            verdict = box["value"].result(WAIT_S).intersects
        elif schedule == "fleet_replay_races_new_request":
            journal = RequestJournal(Path(tmp.name) / "crashed.journal")
            journal.append_request("ghost-1", fp, data, None)
            journal.close()
            ctl.hold("replay.begin", ctl.reached_event("route.resolved"))
            th, box = in_thread(lambda: engine.adopt_journal(journal.path))
            assert ctl.reached_event("replay.begin").wait(WAIT_S), "adopt_journal never began"
            verdict = engine.submit(data).result(WAIT_S).intersects
            th.join(WAIT_S)
            assert not th.is_alive() and box.get("value") == 1, box
        elif schedule == "fleet_respawn_restores_ring":
            engine.kill_worker(target, evict=True)
            assert ctl.reached_event("respawn.done").wait(WAIT_S), "the respawned worker never rejoined"
            with engine._lock:
                assert len(engine._ring) == 2
            verdict = engine.submit(data).result(WAIT_S).intersects
        elif schedule == "fleet_hedge_races_primary_response":
            rec = telemetry.get_run_record()
            ctl.hold("hedge.sent", ctl.reached_event("response.delivered"))
            engine._suspect_worker(target, "forced partition (schedule)")
            base = rec.snapshot()[0].get("fleet.duplicate_responses", 0)
            verdict = engine.submit(data).result(WAIT_S).intersects
            deadline = time.monotonic() + WAIT_S
            while rec.snapshot()[0].get("fleet.duplicate_responses", 0) < base + 1:
                assert time.monotonic() < deadline, "the hedge straggler was never deduplicated"
                time.sleep(0.002)
        else:  # fleet_scale_down_races_dispatch
            broken = topology.endswith("-broken")
            data2 = next(c for c in (majority_fbas(9, prefix=f"SCALE{i}", broken=broken) for i in range(64))
                         if engine._ring.route(fingerprint_of(c)) == "w1")
            expected = solve(data2, backend="python", device="cpu").intersects
            ctl.hold("route.resolved", ctl.reached_event("scale.retire"))
            th, box = in_thread(lambda: engine.submit(data2))
            assert ctl.reached_event("route.resolved").wait(WAIT_S), "submit never resolved a route"
            assert engine.scale_tick(force=True) == "down"
            th.join(WAIT_S)
            assert not th.is_alive() and "error" not in box, box
            with engine._lock:
                assert len(engine._ring) == 1
            verdict = box["value"].result(WAIT_S).intersects
    except AssertionError as exc:
        error = str(exc)
    finally:
        fleet_mod._fleet_sync = old_sync
        if engine is not None:
            engine.stop(drain=True, timeout=WAIT_S)
        tmp.cleanup()
    missing = [p for p in _REQUIRED_FLEET_POINTS[schedule] if p not in ctl.trace]
    if error is None and missing:
        error = f"ordering never happened: sync point(s) {missing} not reached"
    if error is None and verdict is not expected:
        error = f"verdict {verdict!r}, expected {expected}"
    return error


class TestFleetSchedules:
    @pytest.mark.parametrize("broken", [False, True], ids=["majority9", "majority9-broken"])
    @pytest.mark.parametrize("schedule", FLEET_SCHEDULES)
    def test_forced_interleaving_is_clean(self, rec, schedule, broken):
        data = majority_fbas(9, broken=broken)
        expected = solve(data, backend="python", device="cpu").intersects
        topology = "majority9-broken" if broken else "majority9"
        assert _run_schedule(schedule, data, expected, topology) is None


# ---------------------------------------------------------------------------
# the CLI and the health endpoints


class TestFleetCli:
    def test_fleet_cli_local_workers_lines_equal_the_jax_cli(self, rec, tmp_path):
        from quorum_intersection_tpu_torch import cli

        lines = [json.dumps({"request_id": f"r{i}", "nodes": majority_fbas(5 + i, broken=i == 1, prefix="CLI")})
                 for i in range(3)] + [json.dumps({"ping": "t"}), "not json"]

        def run(main, argv):
            old_in, old_out = sys.stdin, sys.stdout
            sys.stdin, sys.stdout = io.StringIO("\n".join(lines) + "\n"), io.StringIO()
            try:
                rc = main(argv)
                out = sys.stdout.getvalue()
            finally:
                sys.stdin, sys.stdout = old_in, old_out
            return rc, [json.loads(ln) for ln in out.splitlines()]

        rc, got = run(cli.main, ["fleet", "-n", "2", "--backend", "python", "--local-workers", "--device", "cpu",
                                 "--journal-dir", str(tmp_path / "cli")])
        jax_rc, want = run(jax_fleet.fleet_main, ["-n", "2", "--backend", "python", "--local-workers",
                                                  "--journal-dir", str(tmp_path / "jax-cli")])
        assert rc == jax_rc == 0
        assert got[0]["kind"] == want[0]["kind"] == "fleet" and got[0]["workers"] == want[0]["workers"]
        by_id = {o.get("request_id", o.get("pong")): o for o in got[1:]}
        want_by_id = {o.get("request_id", o.get("pong")): o for o in want[1:]}
        assert {k: fleet_line(v) for k, v in by_id.items() if k != "t"} == {
            k: fleet_line(v) for k, v in want_by_id.items() if k != "t"}
        assert {k: v["verdict"] for k, v in by_id.items() if "verdict" in v} == {"r0": True, "r1": False, "r2": True}

    def test_fleet_cli_without_a_card_exits_1(self, rec, tmp_path, capsys):
        from quorum_intersection_tpu_torch.fleet import fleet_main

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device starts")
        assert fleet_main(["-n", "1", "--backend", "python", "--journal-dir", str(tmp_path / "j")]) == 1
        assert "unavailable" in capsys.readouterr().err


class TestFleetHealth:
    def test_healthz_carries_fleet_gauges(self, rec, tmp_path):
        with _Fleet(tmp_path, n=2, probe_interval_s=0.05, store_dir=tmp_path / "store") as fleet:
            fleet.submit(majority_fbas(5, prefix="HLZ")).result(timeout=30.0)
            assert _wait_counter(rec, "fleet.routed", 1) >= 1
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and len(fleet.healthz()["workers"]) < 2:
                time.sleep(0.02)
            payload = healthz_payload()
            health = fleet.healthz()
        assert payload["fleet_workers_live"] == payload["fleet_ring_size"] == 2
        assert health["schema"] == "qi-fleet/1" and sorted(health["workers"]) == ["w0", "w1"]

    def test_readyz_503_while_the_fleet_replays(self, rec):
        rec.gauge("fleet.replay_complete", 0)
        payload, status = readyz_payload()
        assert status == 503 and payload["status"] == "replaying" and payload["fleet_replay_complete"] is False
        rec.gauge("fleet.replay_complete", 1)
        payload, status = readyz_payload()
        assert status == 200 and payload["fleet_replay_complete"] is True

    def test_fleet_tenant_table_merges_worker_costs(self, rec, tmp_path):
        with _Fleet(tmp_path, n=2, probe_interval_s=0.05) as fleet:
            for i in range(3):
                fleet.submit(majority_fbas(5 + i, prefix="TEN"), client=f"t{i % 2}").result(timeout=30.0)
            # The probes merge each worker's table every 0.05 s: wait for the
            # merge to catch up with the last request's booking.
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and cost.fleet_tenant_table().snapshot() != cost.tenant_table().snapshot():
                time.sleep(0.02)
        merged = cost.fleet_tenant_table().snapshot()
        assert set(merged) == {"t0", "t1"} and merged == cost.tenant_table().snapshot()
        assert cost.sloz_payload()["tenants"]["fleet"]


class TestStoreWriters:
    def test_two_writers_of_one_fragment_in_one_process_both_bank(self, rec, tmp_path, monkeypatch):
        """The store gateway's thread and an in-process worker bank the same
        fragment at once: each writes its own temporary file, so neither
        rename loses the other's (the JAX tier's temporary name, keyed by the
        process alone, made the second rename fail with a store error)."""
        import os as os_mod

        from quorum_intersection_tpu_torch import delta as delta_mod

        real_replace = os_mod.replace
        both_written = threading.Barrier(2, timeout=5.0)

        def replace_after_both(src, dst):
            both_written.wait()
            return real_replace(src, dst)

        monkeypatch.setattr(delta_mod.os, "replace", replace_after_both)
        store = SharedSccStore(tmp_path / "store")
        payload = {"intersects": True, "q1": None, "q2": None, "stats": {}}
        results = []
        threads = [threading.Thread(target=lambda: results.append(store.put("verdict", "fp", payload, "s0")))
                   for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(10.0)
        assert results == [True, True] and rec.counters.get("fleet.store_errors", 0) == 0
        assert [p.name for p in (tmp_path / "store").iterdir()] == ["verdict-s0-fp.json"]
