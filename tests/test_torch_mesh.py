"""The port's fleet mesh against the JAX package's, on the CPU: twins of
``tests/test_qi_mesh.py``, and the wire shared across the two packages.

- the versioned join handshake (``hello_ok``, and a typed ``hello_err`` for
  each skew: protocol, fingerprint, token), a skewed join that raises
  ``MeshHandshakeError``, and ``fleet.join`` degrading to a fleet without
  the peer;
- the bind address, a client that dies mid-line;
- a socket-joined fleet (in-process peers on ``device="cpu"``) on the four
  fixture pairs, a request routed to the peer, and a fragment solved on the
  peer that composes, through the front door's store gateway, into a
  certificate answered by the local worker;
- the partition matrix (suspect, hedge, rejoin; lease lapse, eviction,
  journal ship), journal shipping byte-identical, the ``qi-store/1`` wire,
  elasticity and ``adopt_journal``'s typed reject;
- a real ``serve --socket`` process of the port joined over TCP;
- across packages: a JAX front door joined to a port socket server, a port
  front door joined to a JAX socket server, and a JAX ``RemoteStoreClient``
  against a port ``StoreGateway``, each answering as the JAX pair does.

Every wait has a bound.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from quorum_intersection_tpu import delta as jax_delta
from quorum_intersection_tpu import fleet as jax_fleet
from quorum_intersection_tpu import serve as jax_serve
from quorum_intersection_tpu import serve_transport as jax_transport
from quorum_intersection_tpu.utils import faults as jax_faults
from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu_torch import cost
from quorum_intersection_tpu_torch import fleet as fleet_mod
from quorum_intersection_tpu_torch.delta import RemoteStoreClient, SharedSccStore
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.fbas.synth import majority_fbas
from quorum_intersection_tpu_torch.fleet import (
    FleetEngine,
    JournalUnreadableError,
    MeshHandshakeError,
    SocketWorker,
    StoreGateway,
)
from quorum_intersection_tpu_torch.pipeline import solve
from quorum_intersection_tpu_torch.serve import RequestJournal, ServeEngine, snapshot_fingerprint
from quorum_intersection_tpu_torch.serve_transport import (
    MESH_PROTOCOL,
    PROTOCOL_SCHEMA,
    SocketServeServer,
    fleet_token_digest,
    package_fingerprint,
)
from quorum_intersection_tpu_torch.utils import faults, telemetry
from tools.check_cert import check_certificate

from _torch_cases import fixture_data

torch.set_num_threads(1)

FIXTURES = [("trivial_correct", True), ("trivial_broken", False),
            ("nested_correct", True), ("nested_broken", False)]
ROOT = Path(__file__).resolve().parents[1]


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


def fingerprint_of(nodes):
    return snapshot_fingerprint(build_graph(parse_fbas(nodes)))


def _wait_counter(record, name, want, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if record.snapshot()[0].get(name, 0) >= want:
            break
        time.sleep(0.02)
    return record.snapshot()[0].get(name, 0)


class _Peer:
    """One in-process 'remote host': a serve engine of either package behind
    its socket transport, with no shared store of its own."""

    def __init__(self, journal=None, jax=False):
        self.jax = jax
        self.engine = (jax_serve.ServeEngine(backend="python", journal=journal) if jax
                       else ServeEngine(backend="python", journal=journal, device="cpu"))
        self.server = None

    def __enter__(self):
        self.engine.start()
        server_cls = jax_transport.SocketServeServer if self.jax else SocketServeServer
        self.server = server_cls(self.engine, port=0, emit_certs=True)
        return self

    def __exit__(self, *exc):
        self.server.stop()
        self.engine.stop(drain=True, timeout=30.0)
        return False

    @property
    def port(self):
        return self.server.port

    @property
    def addr(self):
        return f"127.0.0.1:{self.server.port}"


class _Mesh:
    """A socket-joined fleet: one in-process worker (w0) plus the peers (j0..),
    no respawn, probes only on demand."""

    def __init__(self, tmp_path, joins, n=1, jax=False, **kw):
        kw.setdefault("backend", "python")
        kw.setdefault("worker_mode", "local")
        kw.setdefault("journal_dir", tmp_path / ("jax-mesh" if jax else "mesh"))
        kw.setdefault("probe_interval_s", 30.0)
        kw.setdefault("respawn_max", 0)
        if not jax:
            kw.setdefault("device", "cpu")
        self.engine = (jax_fleet.FleetEngine if jax else FleetEngine)(n, joins=joins, **kw)

    def __enter__(self):
        self.engine.start()
        return self.engine

    def __exit__(self, *exc):
        self.engine.stop(drain=True, timeout=30.0)
        return False


def _routed_to(engine, want, tag, n=7, broken=False):
    for i in range(64):
        cand = majority_fbas(n, broken=broken, prefix=f"{tag}{i}")
        if engine._ring.route(fingerprint_of(cand)) == want:
            return cand
    raise AssertionError(f"no prefix of {tag} routed to {want}")


def _valid_hello(peer="test-peer"):
    return {"schema": PROTOCOL_SCHEMA, "protocol": MESH_PROTOCOL, "fingerprint": package_fingerprint(),
            "token": fleet_token_digest(), "peer": peer}


def _talk(port, *objs):
    """One connection: each object written, one line read back for each."""
    with socket.create_connection(("127.0.0.1", port), timeout=10.0) as conn:
        fh = conn.makefile("rw", encoding="utf-8")
        out = []
        for obj in objs:
            fh.write(json.dumps(obj) + "\n")
            fh.flush()
            out.append(json.loads(fh.readline()))
        return out


# ---------------------------------------------------------------------------
# the versioned join handshake


class TestMeshHandshake:
    def test_valid_hello_answers_hello_ok_as_the_jax_server(self, rec):
        answers = []
        for jax in (False, True):
            with _Peer(jax=jax) as peer:
                answers.append(_talk(peer.port, {"hello": _valid_hello()})[0]["hello_ok"])
        got, want = answers
        assert got.pop("pid") == want.pop("pid") == os.getpid()
        assert got == want
        assert got["fingerprint"] == package_fingerprint() and got["ready"] is True and "replay" in got
        assert rec.counters.get("serve.hello_rejects", 0) == 0

    @pytest.mark.parametrize("skew,code", [
        ({"schema": "qi-serve/0"}, "protocol_mismatch"),
        ({"protocol": MESH_PROTOCOL + 1}, "protocol_mismatch"),
        ({"fingerprint": "0" * 16}, "fingerprint_mismatch"),
        ({"token": "not-the-digest"}, "bad_token"),
    ])
    def test_skewed_hello_is_the_jax_typed_reject(self, rec, skew, code):
        answers = []
        for jax in (False, True):
            with _Peer(jax=jax) as peer:
                answers.append(_talk(peer.port, {"hello": {**_valid_hello(), **skew}}, {"ping": "after"}))
        assert answers[0][0] == answers[1][0] and answers[0][0]["hello_err"]["code"] == code
        assert answers[0][1]["pong"] == "after"  # a reject is an answer, not a dropped session
        assert rec.counters["serve.hello_rejects"] == 1

    def test_wrong_token_join_raises_mesh_handshake_error(self, rec, tmp_path, monkeypatch):
        """The peer runs under one QI_FLEET_TOKEN, the front door's hello
        carries the digest of another: a typed bad_token reject that the join
        raises, never a retried or skewed mesh."""
        import hashlib

        monkeypatch.setenv("QI_FLEET_TOKEN", "the-peer-secret")
        monkeypatch.setattr(fleet_mod, "fleet_token_digest",
                            lambda: hashlib.sha256(b"another-secret").hexdigest())
        with _Peer() as peer:
            engine = FleetEngine(1, backend="python", worker_mode="local", device="cpu",
                                 journal_dir=tmp_path / "tok", probe_interval_s=30.0, respawn_max=0,
                                 joins=[peer.addr])
            try:
                with pytest.raises(MeshHandshakeError) as exc:
                    engine.start()
            finally:
                engine.stop(drain=False, timeout=10.0)
        assert exc.value.reject_code == "bad_token" and exc.value.code == "mesh_handshake"
        assert rec.counters.get("fleet.joins", 0) == 0 and rec.counters["serve.hello_rejects"] == 1

    def test_skewed_join_propagates_never_runs_skewed(self, rec, tmp_path, monkeypatch):
        with _Peer() as peer:
            monkeypatch.setattr(fleet_mod, "package_fingerprint", lambda: "f" * 16)
            engine = FleetEngine(1, backend="python", worker_mode="local", device="cpu",
                                 journal_dir=tmp_path / "skew", probe_interval_s=30.0, respawn_max=0,
                                 joins=[peer.addr])
            try:
                with pytest.raises(MeshHandshakeError) as exc:
                    engine.start()
            finally:
                engine.stop(drain=False, timeout=10.0)
        assert exc.value.reject_code == "fingerprint_mismatch"
        assert rec.counters.get("fleet.joins", 0) == 0

    def test_join_fault_degrades_to_standalone(self, rec, tmp_path):
        faults.install_plan(faults.parse_faults("fleet.join=error@1+"))
        with _Peer() as peer:
            with _Mesh(tmp_path, [peer.addr]) as fleet:
                assert fleet.worker_ids() == ["w0"]
                assert fleet.submit(fixture_data("trivial_correct.json")).result(timeout=30.0).intersects is True
        assert rec.counters["fleet.join_errors"] == 1 and rec.counters.get("fleet.joins", 0) == 0


class TestBindAndSessions:
    def test_default_bind_is_loopback_and_env_bind_is_honored(self, rec, tmp_path, monkeypatch):
        monkeypatch.delenv("QI_SERVE_BIND", raising=False)
        gateway = StoreGateway(SharedSccStore(tmp_path / "a"))
        assert gateway.host == "127.0.0.1"
        gateway.stop()
        monkeypatch.setenv("QI_SERVE_BIND", "localhost")
        gateway = StoreGateway(SharedSccStore(tmp_path / "b"))
        try:
            assert gateway.host == "localhost"
            with _Peer() as peer:
                assert peer.server.host == "localhost"
                with socket.create_connection(("localhost", peer.port), timeout=10.0) as conn:
                    fh = conn.makefile("rw", encoding="utf-8")
                    fh.write(json.dumps({"ping": "bound"}) + "\n")
                    fh.flush()
                    assert json.loads(fh.readline())["pong"] == "bound"
        finally:
            gateway.stop()

    def test_client_reset_mid_line_spares_the_acceptor(self, rec):
        with _Peer() as peer:
            conn = socket.create_connection(("127.0.0.1", peer.port), timeout=10.0)
            conn.sendall(b'{"request_id": "torn')
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
            conn.close()
            assert _wait_counter(rec, "serve.errors", 1) >= 1
            assert _talk(peer.port, {"ping": "survivor"})[0]["pong"] == "survivor"


# ---------------------------------------------------------------------------
# the socket-joined fleet


class TestMeshDifferential:
    @pytest.mark.parametrize("fixture,verdict", FIXTURES)
    def test_joined_fleet_equals_the_oracle(self, rec, tmp_path, fixture, verdict):
        nodes = fixture_data(f"{fixture}.json")
        with _Peer() as peer:
            with _Mesh(tmp_path, [peer.addr]) as fleet:
                assert fleet.worker_ids() == ["j0", "w0"]
                resp = fleet.submit(nodes).result(timeout=30.0)
        assert resp.intersects is verdict and resp.cert["verdict"] is verdict
        check_certificate(resp.cert, nodes)
        assert rec.counters["fleet.joins"] == 1 and rec.counters["fleet.verdicts"] == 1

    def test_remote_routed_request_answers(self, rec, tmp_path):
        with _Peer() as peer:
            with _Mesh(tmp_path, [peer.addr]) as fleet:
                nodes = _routed_to(fleet, "j0", "MR")
                resp = fleet.submit(nodes).result(timeout=30.0)
        assert resp.intersects is solve(nodes, backend="python", device="cpu").intersects
        check_certificate(resp.cert, nodes)

    def test_cross_host_composed_fragment(self, rec, tmp_path):
        """A fragment solved on the peer is published through the store
        gateway, and a key-renamed twin routed to the local worker composes
        its certificate from it: no re-solve, the checker accepts it."""
        with _Peer() as peer:
            with _Mesh(tmp_path, [peer.addr], store_dir=tmp_path / "store") as fleet:
                base = _routed_to(fleet, "j0", "CH")
                twin = _routed_to(fleet, "w0", "CT")
                assert fleet.submit(base).result(timeout=30.0).intersects is True
                assert _wait_counter(rec, "store.publishes", 1) >= 1
                second = fleet.submit(twin).result(timeout=30.0)
        stamp = second.cert["provenance"]["delta"]
        assert second.intersects is True and (stamp["reused_sccs"], stamp["resolved_sccs"]) == (1, 0)
        check_certificate(second.cert, twin)

    def test_peer_store_miss_is_fetched_through_the_gateway(self, rec, tmp_path):
        """The other direction: a fragment the local worker banked is fetched
        by the peer on its miss (a store.fetch hit) and composes there."""
        with _Peer() as peer:
            with _Mesh(tmp_path, [peer.addr], store_dir=tmp_path / "store") as fleet:
                base = _routed_to(fleet, "w0", "FL")
                twin = _routed_to(fleet, "j0", "FR")
                assert fleet.submit(base).result(timeout=30.0).intersects is True
                fetches = rec.counters.get("store.fetches", 0)
                second = fleet.submit(twin).result(timeout=30.0)
        assert rec.counters["store.fetches"] > fetches and rec.counters.get("store.fetch_errors", 0) == 0
        assert second.cert["provenance"]["delta"]["reused_sccs"] == 1
        check_certificate(second.cert, twin)


# ---------------------------------------------------------------------------
# the partition matrix


def _lapse(fleet, wid):
    fleet._suspect_worker(wid, "forced partition (test)")
    with fleet._lock:
        fleet._leases[wid] = time.monotonic() - 1.0


class TestPartitionMatrix:
    def test_suspect_hedges_then_rejoin_dedups(self, rec, tmp_path):
        with _Mesh(tmp_path, [], n=2) as fleet:
            nodes = _routed_to(fleet, "w1", "PH")
            fleet._suspect_worker("w1", "forced partition (test)")
            assert fleet.submit(nodes).result(timeout=30.0).intersects is solve(
                nodes, backend="python", device="cpu").intersects
            assert _wait_counter(rec, "fleet.duplicate_responses", 1) >= 1
            fleet._renew_lease("w1")
            assert fleet.worker_ids() == ["w0", "w1"]
        c, g = rec.snapshot()
        assert (c["fleet.suspects"], c["fleet.rejoins"], c.get("fleet.evictions", 0)) == (1, 1, 0)
        assert c["fleet.hedges"] >= 1 and g["fleet.suspected"] == 0

    def test_hedge_fault_degrades_to_single_dispatch(self, rec, tmp_path):
        faults.install_plan(faults.parse_faults("fleet.hedge=error@1+"))
        with _Mesh(tmp_path, [], n=2) as fleet:
            nodes = _routed_to(fleet, "w1", "HF")
            fleet._suspect_worker("w1", "forced partition (test)")
            assert fleet.submit(nodes).result(timeout=30.0).intersects is solve(
                nodes, backend="python", device="cpu").intersects
        c = rec.counters
        assert c["fleet.hedge_errors"] >= 1 and c.get("fleet.hedges", 0) == 0
        assert c.get("fleet.duplicate_responses", 0) == 0

    def test_lease_fault_only_delays_eviction(self, rec, tmp_path):
        with _Mesh(tmp_path, [], n=2) as fleet:
            _lapse(fleet, "w1")
            faults.install_plan(faults.parse_faults("fleet.lease=error@1+"))
            fleet._expire_leases()
            assert fleet.worker_ids() == ["w0", "w1"]  # suspect-only
            faults.clear_plan()
            fleet._expire_leases()
            assert fleet.worker_ids() == ["w0"]
            nodes = _routed_to(fleet, "w0", "LE", n=5)
            assert fleet.submit(nodes).result(timeout=30.0).intersects is True
        assert (rec.counters["fleet.lease_errors"], rec.counters["fleet.evictions"]) == (1, 1)

    def test_lease_lapse_evicts_the_socket_peer_and_ships(self, rec, tmp_path):
        pend = majority_fbas(5, prefix="SHPEND")
        journal_path = tmp_path / "remote.journal"
        with _Peer(journal=journal_path) as peer:
            with _Mesh(tmp_path, [peer.addr]) as fleet:
                done = _routed_to(fleet, "j0", "SD", n=5)
                assert fleet.submit(done).result(timeout=30.0).intersects is True
                extra = RequestJournal(journal_path)
                extra.append_request("mesh-pend", fingerprint_of(pend), pend, None)
                extra.close()
                _lapse(fleet, "j0")
                fleet._expire_leases()
                assert fleet.worker_ids() == ["w0"]
                assert _wait_counter(rec, "fleet.replayed_verdicts", 1) >= 1
        c = rec.counters
        assert (c["fleet.ships"], c["fleet.evictions"], c["fleet.replays"]) == (1, 1, 1)
        spool = tmp_path / "mesh" / "shipped" / "j0.shipped.journal"
        assert spool.exists() and spool.read_bytes() == journal_path.read_bytes()

    def test_ship_fault_degrades_to_local_only(self, rec, tmp_path):
        faults.install_plan(faults.parse_faults("fleet.ship=error@1+"))
        with _Peer(journal=tmp_path / "r.journal") as peer:
            with _Mesh(tmp_path, [peer.addr]) as fleet:
                _lapse(fleet, "j0")
                fleet._expire_leases()
                assert fleet.worker_ids() == ["w0"]
        assert rec.counters["fleet.ship_errors"] == 1 and rec.counters.get("fleet.ships", 0) == 0


# ---------------------------------------------------------------------------
# journal shipping


class TestJournalShipping:
    @pytest.mark.parametrize("jax_puller", [False, True], ids=["port-puller", "jax-puller"])
    def test_ship_roundtrip_byte_identical(self, rec, tmp_path, jax_puller):
        """The shipped spool equals the port server's journal byte for byte,
        pulled by the port's SocketWorker or by the JAX package's."""
        journal_path = tmp_path / "peer.journal"
        with _Peer(journal=journal_path) as peer:
            for i in range(3):
                peer.engine.submit(majority_fbas(5, prefix=f"SJ{i}")).result(timeout=30.0)
            cls = jax_fleet.SocketWorker if jax_puller else SocketWorker
            worker = cls("j0", ("127.0.0.1", peer.port), lambda wid, obj: None)
            try:
                assert worker.wait_ready(timeout=30.0)
                spool = worker.ship_journal(tmp_path / "spool", timeout=30.0)
                assert spool is not None and spool.stat().st_size > 0
                assert spool.read_bytes() == journal_path.read_bytes()
            finally:
                worker.close(timeout=10.0)
        assert rec.counters["serve.journal_ships"] == 1

    def test_ship_without_journal_is_a_typed_miss(self, rec, tmp_path):
        with _Peer() as peer:
            worker = SocketWorker("j0", ("127.0.0.1", peer.port), lambda wid, obj: None)
            try:
                assert worker.wait_ready(timeout=30.0)
                assert worker.ship_journal(tmp_path / "spool", timeout=30.0) is None
                assert worker._ship_err["code"] == "no_journal"
            finally:
                worker.close(timeout=10.0)
        assert rec.counters.get("serve.journal_ships", 0) == 0


# ---------------------------------------------------------------------------
# the qi-store/1 wire


class TestStoreWire:
    def test_gateway_rejects_a_bad_token(self, rec, tmp_path):
        gateway = StoreGateway(SharedSccStore(tmp_path / "store"))
        try:
            resp = _talk(gateway.port, {"store_hello": {"schema": "qi-store/1", "token": "wrong"}})[0]
        finally:
            gateway.stop()
        assert resp["ok"] is False and rec.counters["fleet.store_gateway_rejects"] == 1

    def test_client_roundtrip_and_miss(self, rec, tmp_path):
        gateway = StoreGateway(SharedSccStore(tmp_path / "store"))
        client = RemoteStoreClient("127.0.0.1", gateway.port)
        try:
            assert client.fetch("scan", "absent-fp") is None
            payload = {"quorum_local": [1, 2, 3]}
            assert client.publish("scan", "fp-a", payload) is True
            assert client.fetch("scan", "fp-a") == payload
        finally:
            client.close()
            gateway.stop()
        c = rec.counters
        assert (c["store.fetches"], c["store.publishes"], c.get("store.fetch_errors", 0)) == (2, 1, 0)

    def test_fetch_fault_degrades_to_a_local_solve(self, rec, tmp_path):
        faults.install_plan(faults.parse_faults("store.fetch=error@1+"))
        gateway = StoreGateway(SharedSccStore(tmp_path / "store"))
        client = RemoteStoreClient("127.0.0.1", gateway.port, timeout_s=0.5, retries=1)
        try:
            assert client.fetch("scan", "any-fp") is None
            assert client.publish("scan", "any-fp", {"x": 1}) is False
        finally:
            client.close()
            gateway.stop()
        assert rec.counters["store.fetch_errors"] == 2

    def test_dead_gateway_is_a_miss_never_a_raise(self, rec):
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        dead_port = probe.getsockname()[1]
        probe.close()
        client = RemoteStoreClient("127.0.0.1", dead_port, timeout_s=0.2, retries=1)
        try:
            assert client.fetch("scan", "fp") is None
        finally:
            client.close()
        assert rec.counters["store.fetch_errors"] == 1


# ---------------------------------------------------------------------------
# elasticity and adopt_journal


class TestElasticity:
    def test_scale_up_then_drain_retire_with_parity(self, rec, tmp_path):
        nodes = majority_fbas(7, prefix="ELA")
        with _Mesh(tmp_path, [], n=1) as fleet:
            fleet.scale_up_ms = -1.0  # any queue-wait p99 reads as hot
            assert fleet.scale_tick(force=True) == "up"
            ids = fleet.worker_ids()
            assert len(ids) == 2 and any(w.startswith("e") for w in ids)
            assert fleet.submit(nodes).result(timeout=30.0).intersects is True
            fleet.scale_up_ms = 1e12
            fleet.scale_down_ms = 1e12
            assert fleet.scale_tick(force=True) == "down"
            assert fleet.worker_ids() == ["w0"]
            assert fleet.submit(nodes).result(timeout=30.0).intersects is True
        c = rec.counters
        assert (c["fleet.scale_ups"], c["fleet.scale_downs"], c.get("fleet.errors", 0)) == (1, 1, 0)

    def test_steady_state_books_a_hold_and_never_breaches_min(self, rec, tmp_path):
        with _Mesh(tmp_path, [], n=1) as fleet:
            assert fleet.scale_tick(force=True) is None
            fleet.scale_down_ms = 1e12  # always cold
            assert fleet.scale_tick(force=True) is None and fleet.worker_ids() == ["w0"]
        assert rec.counters["fleet.scale_holds"] == 2 and rec.counters.get("fleet.scale_downs", 0) == 0

    def test_scale_fault_freezes_the_fleet_size(self, rec, tmp_path):
        faults.install_plan(faults.parse_faults("fleet.scale=error@1+"))
        with _Mesh(tmp_path, [], n=1) as fleet:
            fleet.scale_up_ms = -1.0
            assert fleet.scale_tick(force=True) is None and fleet.worker_ids() == ["w0"]
        assert rec.counters["fleet.scale_errors"] == 1 and rec.counters.get("fleet.scale_ups", 0) == 0

    def test_unreadable_adopt_path_is_typed(self, rec, tmp_path):
        with _Mesh(tmp_path, [], n=1) as fleet:
            with pytest.raises(JournalUnreadableError) as exc:
                fleet.adopt_journal(tmp_path / "only-on-some-other-host.journal")
        assert exc.value.code == "journal_unreadable" and "ship_journal" in str(exc.value)
        assert rec.counters.get("fleet.replays", 0) == 0


# ---------------------------------------------------------------------------
# a real serve --socket process of the port


class TestTwoProcessMesh:
    def test_port_socket_process_joins_answers_and_ships(self, rec, tmp_path):
        journal_path = tmp_path / "remote.journal"
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "quorum_intersection_tpu_torch", "serve", "--socket", "0",
             "--backend", "python", "--device", "cpu", "--emit-certs", "--journal", str(journal_path)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, cwd=str(ROOT), text=True,
            env={**os.environ, "PYTHONUNBUFFERED": "1"})
        try:
            port = None
            deadline = time.monotonic() + 60.0
            while port is None and time.monotonic() < deadline:
                obj = json.loads(proc.stdout.readline() or "{}")
                port = obj.get("port") if obj.get("kind") == "listening" else None
                assert obj or proc.poll() is None
            assert port is not None
            with _Mesh(tmp_path, [f"127.0.0.1:{port}"]) as fleet:
                assert fleet.worker_ids() == ["j0", "w0"]
                for fixture, verdict in FIXTURES:
                    nodes = fixture_data(f"{fixture}.json")
                    resp = fleet.submit(nodes).result(timeout=60.0)
                    assert resp.intersects is verdict
                    check_certificate(resp.cert, nodes)
                _lapse(fleet, "j0")
                fleet._expire_leases()
                assert fleet.worker_ids() == ["w0"]
        finally:
            proc.stdin.close()
            try:
                proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
        c = rec.counters
        assert (c["fleet.verdicts"], c["fleet.evictions"], c["fleet.ships"]) == (len(FIXTURES), 1, 1)


# ---------------------------------------------------------------------------
# the wire across the two packages


class TestCrossPackage:
    @pytest.mark.parametrize("front_door", ["jax", "port"])
    def test_front_door_of_one_package_joins_a_server_of_the_other(self, rec, tmp_path, front_door):
        """A JAX front door joined to a port socket server, and a port front
        door joined to a JAX one: the handshake passes, a request routed to
        the peer solves there, and the answers equal the same-package pair's."""
        jax_door = front_door == "jax"
        answers = {}
        for mixed in (True, False):
            peer_is_jax = (not jax_door) if mixed else jax_door
            with _Peer(jax=peer_is_jax) as peer:
                with _Mesh(tmp_path / f"m{mixed}", [peer.addr], jax=jax_door) as fleet:
                    assert fleet.worker_ids() == ["j0", "w0"]
                    nodes = _routed_to(fleet, "j0", "XP", broken=True)
                    resp = fleet.submit(nodes).result(timeout=30.0)
                    check_certificate(resp.cert, nodes)
                    answers[mixed] = (resp.intersects, resp.cert["witness"], resp.cert["verdict"])
        assert answers[True] == answers[False] and answers[True][0] is False

    def test_jax_remote_store_client_against_the_port_gateway(self, rec, tmp_path):
        """The JAX package's RemoteStoreClient reads and writes a port
        StoreGateway as it does the JAX one, fragment for fragment."""
        results = {}
        for label, gateway_cls in (("port", StoreGateway), ("jax", jax_fleet.StoreGateway)):
            root = tmp_path / label
            gateway = gateway_cls(SharedSccStore(root) if label == "port" else jax_delta.SharedSccStore(root))
            client = jax_delta.RemoteStoreClient("127.0.0.1", gateway.port)
            try:
                miss = client.fetch("verdict", "absent", "s0")
                stored = client.publish("verdict", "fp-x", {"intersects": True, "q1": None, "q2": None,
                                                            "stats": {"backend": "python"}}, "s0")
                hit = client.fetch("verdict", "fp-x", "s0")
            finally:
                client.close()
                gateway.stop()
            results[label] = (miss, stored, hit, sorted(p.name for p in root.iterdir()),
                              (root / "verdict-s0-fp-x.json").read_bytes())
        assert results["port"] == results["jax"]
        assert results["port"][2]["intersects"] is True
