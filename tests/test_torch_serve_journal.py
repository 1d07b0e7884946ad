"""The port's crash-only request journal on the CPU: twins of
``tests/test_serve.py``'s ``TestJournalReplayMatrix``, the journal's
interchange with the JAX package (one file replays in either package, its
lines byte-equal apart from wall time and pid), and the three process tests:
the port's ``serve`` against the JAX ``serve`` line for line, a hard kill and
replay, and the fleet mesh's handshake lines.  Every wait has a bound.
"""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from quorum_intersection_tpu import serve as jax_serve
from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu_torch import cost, serve
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.fbas.synth import majority_fbas
from quorum_intersection_tpu_torch.pipeline import solve
from quorum_intersection_tpu_torch.utils import faults, telemetry

from _torch_serve_cases import Engine, HeldDrain, comparable

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_CLI = [sys.executable, "-m", "quorum_intersection_tpu_torch", "serve", "--device", "cpu"]
JAX_CLI = [sys.executable, "-m", "quorum_intersection_tpu", "serve"]


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


def fingerprint_of(nodes):
    return serve.snapshot_fingerprint(build_graph(parse_fbas(nodes)))


def req_line(rid, nodes, fingerprint=None):
    return json.dumps({"kind": "req", "request_id": rid, "fingerprint": fingerprint or fingerprint_of(nodes),
                       "deadline_s": None, "nodes": nodes, "t_wall": 0.0})


def journal_with(path, lines):
    path.write_text("".join(line + "\n" for line in lines))
    return path


def replay_report(journal, jax=False):
    with Engine(jax=jax, backend="python", journal=journal) as engine:
        return engine._replay_report


class TestJournalReplayMatrix:
    def test_pending_entry_replays_to_oracle_verdict(self, rec, tmp_path):
        nodes = majority_fbas(7, broken=True)
        journal = journal_with(tmp_path / "j.jsonl", [req_line("r1", nodes)])
        engine = serve.ServeEngine(backend="python", journal=journal, device="cpu")
        report = engine.start()
        try:
            assert report["pending"] == 1
            assert report["verdicts"] == {"r1": solve(nodes, backend="python", device="cpu").intersects}
            assert engine.submit(nodes).result(timeout=30.0).cached is True
        finally:
            engine.stop(drain=True, timeout=30.0)
        again = replay_report(journal)
        assert again["pending"] == 0 and again["verdicts"] == {}

    def test_done_entry_is_final_zero_duplicates(self, rec, tmp_path):
        nodes = majority_fbas(5)
        journal = journal_with(tmp_path / "j.jsonl", [
            req_line("r1", nodes),
            json.dumps({"kind": "done", "request_id": "r1", "fingerprint": fingerprint_of(nodes),
                        "outcome": "verdict", "verdict": True, "t_wall": 0.0})])
        report = replay_report(journal)
        assert (report["already_done"], report["pending"], report["verdicts"]) == (1, 0, {})

    def test_torn_tail_is_tolerated(self, rec, tmp_path):
        journal = journal_with(tmp_path / "j.jsonl", [req_line("r1", majority_fbas(5)),
                                                      '{"kind": "req", "request_id": "r2", "trunca'])
        report = replay_report(journal)
        assert report["torn_tail"] is True and report["verdicts"] == {"r1": True} and report["quarantined"] == 0

    def test_empty_journal_replays_nothing(self, rec, tmp_path):
        journal = tmp_path / "j.jsonl"
        journal.write_text("")
        report = replay_report(journal)
        assert report["entries"] == 0 and report["pending"] == 0

    def test_corrupt_middle_line_quarantines(self, rec, tmp_path):
        journal = journal_with(tmp_path / "j.jsonl", ["not json at all {{{", req_line("r1", majority_fbas(5))])
        report = replay_report(journal)
        assert report["quarantined"] == 1 and report["verdicts"] == {"r1": True}
        assert "not json at all" in journal.with_name(journal.name + ".corrupt").read_text()

    def test_foreign_fingerprint_quarantines(self, rec, tmp_path):
        journal = journal_with(tmp_path / "j.jsonl", [req_line("r1", majority_fbas(5), fingerprint="f" * 32)])
        report = replay_report(journal)
        assert report["quarantined"] == 1 and report["verdicts"] == {}
        assert '"r1"' in journal.with_name(journal.name + ".corrupt").read_text()

    def test_unparseable_nodes_quarantine(self, rec, tmp_path):
        journal = journal_with(tmp_path / "j.jsonl", [json.dumps({
            "kind": "req", "request_id": "r1", "fingerprint": "a" * 32, "deadline_s": None,
            "nodes": {"not": "a node array"}, "t_wall": 0.0})])
        assert replay_report(journal)["quarantined"] == 1

    def test_live_requests_journal_and_mark_done(self, rec, tmp_path):
        journal = tmp_path / "j.jsonl"
        with Engine(backend="python", journal=journal) as engine:
            engine.submit(majority_fbas(7)).result(timeout=30.0)
        entries, corrupt, torn = serve.RequestJournal(journal).scan()
        assert not corrupt and not torn and [e["kind"] for e in entries] == ["req", "done"]
        assert entries[1]["verdict"] is True and entries[0]["fingerprint"] == entries[1]["fingerprint"]

    def test_coalesced_request_journals_its_own_pair(self, rec, tmp_path, monkeypatch):
        hold = HeldDrain()
        monkeypatch.setattr(serve, "_serve_sync", hold)
        journal = tmp_path / "j.jsonl"
        nodes = majority_fbas(9)
        try:
            with Engine(backend="python", journal=journal) as engine:
                t1 = engine.submit(nodes, request_id="primary")
                assert hold.popped.wait(10.0)
                t2 = engine.submit(nodes, request_id="rider")
                hold.release.set()
                t1.result(timeout=30.0), t2.result(timeout=30.0)
        finally:
            hold.release.set()
        by_kind = {}
        for e in serve.RequestJournal(journal).scan()[0]:
            by_kind.setdefault(e["kind"], set()).add(e["request_id"])
        assert by_kind["req"] == by_kind["done"] == {"primary", "rider"}

    def test_duplicate_fingerprint_entries_both_replay(self, rec, tmp_path):
        nodes = majority_fbas(7)
        journal = journal_with(tmp_path / "j.jsonl", [req_line("r1", nodes), req_line("r2", nodes)])
        report = replay_report(journal)
        assert report["pending"] == 2 and report["verdicts"] == {"r1": True, "r2": True}


def _normalized_journal(path):
    """A journal's lines with their wall time and pid masked."""
    text = Path(path).read_text()
    text = re.sub(r'"t_wall": [0-9.]+', '"t_wall": 0', text)
    return re.sub(r'"pid": [0-9]+', '"pid": 0', text)


class TestJournalInterop:
    def test_journal_lines_are_the_jax_packages_bytes(self, rec, tmp_path):
        streams = [majority_fbas(5), majority_fbas(7, broken=True)]
        for rid_ix, module in enumerate((serve, jax_serve)):
            journal = module.RequestJournal(tmp_path / f"j{rid_ix}.jsonl")
            for i, nodes in enumerate(streams):
                journal.append_request(f"r{i}", fingerprint_of(nodes), nodes, 2.5 if i else None,
                                       query={"kind": "intersection"} if i else None, trace="t:1:2" if i else None)
                journal.append_done(f"r{i}", fingerprint_of(nodes), "verdict", bool(i))
            journal.close()
        assert _normalized_journal(tmp_path / "j0.jsonl") == _normalized_journal(tmp_path / "j1.jsonl")

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_a_journal_replays_in_either_package(self, rec, tmp_path, writer):
        """One package serves two requests and journals a third it never
        answered; the other package's restart answers exactly that one, with
        the verdict the writer's own restart gives."""
        done = [majority_fbas(5, prefix="D"), majority_fbas(7, broken=True, prefix="E")]
        pending = majority_fbas(9, broken=True, prefix="P")
        journal = tmp_path / "j.jsonl"
        with Engine(jax=writer == "jax", backend="python", journal=journal) as engine:
            for nodes in done:
                engine.submit(nodes).result(timeout=30.0)
        module = jax_serve if writer == "jax" else serve
        extra = module.RequestJournal(journal)
        extra.append_request("left-over", fingerprint_of(pending), pending, None)
        extra.close()
        twin = tmp_path / "twin.jsonl"
        shutil.copy(journal, twin)
        got = replay_report(journal, jax=writer != "jax")
        want = replay_report(twin, jax=writer == "jax")
        assert got["already_done"] == want["already_done"] == 2
        assert got["verdicts"] == want["verdicts"] == {"left-over": False}
        assert got["quarantined"] == want["quarantined"] == 0


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("QI_")}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT), **extra})
    return env


def _run(cmd, stdin_text, timeout=120.0, **env):
    return subprocess.run(cmd, input=stdin_text, capture_output=True, text=True, timeout=timeout, cwd=ROOT,
                          env=_env(**env))


class TestProcesses:
    def test_port_serve_equals_jax_serve_line_for_line(self, tmp_path):
        streams = [majority_fbas(n, broken=b, prefix=f"S{n}") for n, b in ((5, False), (7, True), (9, False))]
        lines = [json.dumps({"request_id": f"p{i}", "nodes": s, "client": "c"}) for i, s in enumerate(streams)]
        lines += [json.dumps({"request_id": "p0-again", "nodes": streams[0]}), json.dumps({"ping": "x"}),
                  "garbage", json.dumps({"request_id": "bad", "nodes": 3})]
        text = "".join(line + "\n" for line in lines)
        got = _run(PORT_CLI + ["--backend", "python", "--batch-max", "1"], text)
        want = _run(JAX_CLI + ["--backend", "python", "--batch-max", "1"], text)
        assert got.returncode == want.returncode == 0, got.stderr[-2000:]

        def keyed(out):
            objs = [json.loads(ln) for ln in out.splitlines()]
            return {o.get("request_id", o.get("pong")): comparable(o) for o in objs}

        assert keyed(got.stdout) == keyed(want.stdout)
        assert len(got.stdout.splitlines()) == len(lines)

    def test_hard_kill_then_replay(self, tmp_path):
        journal = tmp_path / "kill.jsonl"
        streams = [majority_fbas(n, broken=b, prefix=f"K{n}{int(b)}") for n, b in ((5, False), (7, True), (9, False))]
        oracle = {f"kill-{i}": solve(s, backend="python", device="cpu").intersects for i, s in enumerate(streams)}
        proc = subprocess.Popen(PORT_CLI + ["--journal", str(journal), "--backend", "python"],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                                cwd=ROOT, env=_env(QI_FAULTS="serve.drain=hang:2.0@1+"))
        try:
            for i, s in enumerate(streams):
                proc.stdin.write(json.dumps({"request_id": f"kill-{i}", "nodes": s}) + "\n")
            proc.stdin.flush()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if journal.exists() and journal.read_text().count('"kind": "req"') >= len(streams):
                    break
                time.sleep(0.05)
            else:
                pytest.fail("requests never reached the journal")
        finally:
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30.0)
        answered = {}
        for line in (proc.stdout.read() or "").splitlines():
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "verdict" in obj:
                answered[obj["request_id"]] = obj["verdict"]
        replay = _run(PORT_CLI + ["--journal", str(journal), "--replay-only", "--backend", "python"], "")
        assert replay.returncode == 0, replay.stderr[-2000:]
        report = json.loads(replay.stdout.splitlines()[0])
        assert report["kind"] == "replay"
        replayed = report["verdicts"]
        assert not set(answered) & set(replayed)
        assert set(answered) | set(replayed) == set(oracle)
        for rid, verdict in {**answered, **replayed}.items():
            assert verdict is oracle[rid], rid

    def test_mesh_line_gets_a_typed_error_and_the_stream_goes_on(self, tmp_path):
        """The port's ``serve`` process: a skewed hello gets the typed
        ``hello_err``, a valid one ``hello_ok`` with the server's replay
        report, and the request after them is answered."""
        from quorum_intersection_tpu import serve_transport as jax_transport

        hello = {"schema": "qi-serve/1", "protocol": 1, "token": "", "peer": "test",
                 "fingerprint": jax_transport.package_fingerprint()}
        lines = [json.dumps({"hello": {**hello, "protocol": 2}}), json.dumps({"hello": hello}),
                 json.dumps({"request_id": "after", "nodes": majority_fbas(5)})]
        got = _run(PORT_CLI + ["--backend", "python", "--journal", str(tmp_path / "j.jsonl")],
                   "".join(line + "\n" for line in lines))
        assert got.returncode == 0, got.stderr[-2000:]
        objs = [json.loads(ln) for ln in got.stdout.splitlines()]
        assert [o["kind"] for o in objs[:1]] == ["replay"]
        assert objs[1]["hello_err"]["code"] == "protocol_mismatch"
        ok = objs[2]["hello_ok"]
        assert ok["fingerprint"] == jax_transport.package_fingerprint() and ok["ready"] is True
        assert ok["replay"]["journal"] == str(tmp_path / "j.jsonl")
        assert objs[3]["request_id"] == "after" and objs[3]["verdict"] is True
