"""The port's multi-process runtime (``parallel/distributed.py``) on the CPU:
two processes joined over gloo, each with a 4-rank CPU mesh, run the sharded
sweep; both join (``process_count == 2``), and their verdicts, witnesses,
hit indices, ``candidates_checked`` and ``device_steps`` equal each other's
and the JAX package's single-process solve on the conftest's 8 emulated
devices (its ramp compiled inline, as in ``tests/test_torch_parallel.py``).
The same two processes run the frontier under their mesh (the JAX
``tests/test_distributed.py:87-110`` case): equal to each other, to the
single-process 8-rank solve and to the JAX 8-device one, with the 108
minimal quorums of hier-4x3.  Also: ``initialize()`` is a no-op in a single process, the injected
``distributed.init`` fault retries under ``QI_DIST_INIT_TIMEOUT_S`` through
the ``_retry_sleep`` seam and then degrades loudly with its event, and an
unrecoverable join degrades at once.  Exact equality throughout.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import quorum_intersection_tpu.backends.tpu.sweep as jax_sweep_mod
from quorum_intersection_tpu.backends.tpu.sweep import TpuSweepBackend
from quorum_intersection_tpu.fbas.synth import benchmark_fbas, majority_fbas
from quorum_intersection_tpu.parallel.mesh import candidate_mesh as jax_candidate_mesh
from quorum_intersection_tpu.pipeline import solve as jax_solve
from quorum_intersection_tpu_torch.parallel import distributed
from quorum_intersection_tpu_torch.utils import faults, telemetry

torch.set_num_threads(1)
WORKER = Path(__file__).with_name("_torch_dist_worker.py")
KEYS = ("intersects", "q1", "q2", "hit_index", "candidates_checked", "device_steps")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_process_results():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(WORKER.parent.parent) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(port), str(pid)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append((*p.communicate(timeout=120), p.returncode))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail("two-process run timed out")
    results = []
    for out, err, rc in outs:
        assert rc == 0, "\n".join(err.strip().splitlines()[-12:])
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


class _InlineThread:
    def __init__(self, *a, **k):
        self._target = k.get("target")

    def start(self):
        self._target()

    def is_alive(self):
        return False


@pytest.fixture(scope="module")
def jax_single_process():
    """The JAX sharded sweep in one process over its 8 emulated devices."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sweep_mod, "_thread_factory", _InlineThread)
        cases = {"safe": (majority_fbas(11), {}), "broken": (majority_fbas(11, broken=True), {}),
                 "wide": (benchmark_fbas(48, 12, broken=True, seed=3), {"lo_bits": 6})}
        out = {}
        for label, (data, kw) in cases.items():
            res = jax_solve(data, backend=TpuSweepBackend(batch=512, mesh=jax_candidate_mesh(8), **kw))
            out[label] = {"intersects": res.intersects, "q1": res.q1, "q2": res.q2,
                          **{k: res.stats.get(k) for k in KEYS[3:]}}
        return out


def test_both_processes_joined(two_process_results):
    r0, r1 = two_process_results
    assert r0["process_count"] == r1["process_count"] == 2
    assert {r0["process_index"], r1["process_index"]} == {0, 1}
    assert r0["global_ranks"] == r1["global_ranks"] == 8
    assert r0["safe"]["mesh"] == {"devices": "cpu x4", "ranks": 8, "processes": 2, "collective": "gloo"}


@pytest.mark.parametrize("case", ["safe", "broken", "wide"])
def test_processes_agree_with_each_other_and_with_jax(case, two_process_results, jax_single_process):
    r0, r1 = two_process_results
    got = [{k: r[case][k] for k in KEYS} for r in (r0, r1)]
    assert got[0] == got[1] == jax_single_process[case]
    assert got[0]["intersects"] is (case == "safe")


FRONTIER_KEYS = ("intersects", "q1", "q2", "minimal_quorums", "states_popped", "device_iters", "device_chunks",
                 "flagged", "host_checks")


def test_frontier_across_processes(two_process_results):
    """Both processes' frontier equal each other's, the single-process
    8-rank solve's and the JAX mesh frontier's, with hier-4x3's 108 minimal
    quorums; the gathers went through gloo."""
    from quorum_intersection_tpu.backends.tpu.frontier import TpuFrontierBackend
    from quorum_intersection_tpu.fbas.synth import hierarchical_fbas as jax_hierarchical_fbas
    from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
    from quorum_intersection_tpu_torch.fbas.synth import hierarchical_fbas
    from quorum_intersection_tpu_torch.parallel import candidate_mesh
    from quorum_intersection_tpu_torch.pipeline import solve

    r0, r1 = (r["frontier"] for r in two_process_results)
    got = [{k: r[k] for k in FRONTIER_KEYS} for r in (r0, r1)]
    single = solve(hierarchical_fbas(4, 3), backend=GpuFrontierBackend(device="cpu", arena=1024, pop=64,
                                                                       mesh=candidate_mesh(8, device="cpu")))
    want = jax_solve(jax_hierarchical_fbas(4, 3), backend=TpuFrontierBackend(arena=1024, pop=64,
                                                                            mesh=jax_candidate_mesh(8)))
    for res in (single, want):
        row = {"intersects": res.intersects, "q1": res.q1, "q2": res.q2, **res.stats}
        assert got[0] == {k: row.get(k) for k in FRONTIER_KEYS}
    assert got[0] == got[1] and got[0]["intersects"] is True and got[0]["minimal_quorums"] == 108
    assert r0["mesh"]["ranks"] == 8 and r0["mesh"]["processes"] == 2 and r0["mesh"]["collective"] == "gloo"
    assert r0["mesh"]["iteration_launches"] == r1["mesh"]["iteration_launches"] > 0


def test_frontier_across_processes_runs_the_iteration_instance(two_process_results):
    """Joined processes keep K9's iteration instance and the gathers: no
    kernel reaches another process's memory."""
    for r in two_process_results:
        mesh = r["frontier"]["mesh"]
        assert mesh["instance"] == "iteration" and mesh["processes"] == 2
        assert mesh["iteration_launches"] > 0 and "chunk_launches" not in mesh


@pytest.fixture
def fresh_runtime(monkeypatch):
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setattr(distributed, "_local_devices", None)
    faults.clear_plan()
    rec = telemetry.reset_run_record()
    yield rec
    faults.clear_plan()
    telemetry.reset_run_record()


def test_initialize_is_a_noop_in_a_single_process(fresh_runtime, monkeypatch):
    for name in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize()
    distributed.initialize()
    assert not distributed.is_multihost() and distributed.process_count() == 1
    assert not torch.distributed.is_initialized()
    assert not [e for e in fresh_runtime.events if e["name"].startswith("distributed.")]
    mesh = distributed.global_candidate_mesh(devices=["cpu"] * 3)
    assert (mesh.size, mesh.process_count, mesh.group) == (3, 1, None)
    assert distributed.hybrid_candidate_mesh(devices=["cpu"] * 3) == mesh


def test_injected_fault_retries_then_degrades_loudly(fresh_runtime, monkeypatch):
    slept = []

    def sleep(seconds):
        slept.append(seconds)
        time.sleep(seconds)

    monkeypatch.setattr(distributed, "_retry_sleep", sleep)
    monkeypatch.setenv("QI_DIST_INIT_TIMEOUT_S", "1.2")
    faults.install_plan(faults.parse_faults("distributed.init=error@1+"))
    distributed.initialize(coordinator_address="127.0.0.1:1", num_processes=2, process_id=0, backend="gloo")
    ev = [e for e in fresh_runtime.events if e["name"] == "distributed.init_degraded"]
    assert len(ev) == 1 and ev[0]["attrs"]["attempts"] == 2 and "injected" in ev[0]["attrs"]["cause"]
    assert slept == [distributed._INIT_BACKOFF_S]
    assert not distributed.is_multihost() and not torch.distributed.is_initialized()


def test_unrecoverable_join_degrades_at_once(fresh_runtime, monkeypatch):
    slept = []
    monkeypatch.setattr(distributed, "_retry_sleep", slept.append)
    monkeypatch.setenv("QI_DIST_INIT_TIMEOUT_S", "60")
    monkeypatch.setattr(torch.distributed, "TCPStore", lambda *a, **k: None)

    def twice(*a, **k):
        raise ValueError("trying to initialize the default process group twice!")

    monkeypatch.setattr(torch.distributed, "init_process_group", twice)
    distributed.initialize(coordinator_address="127.0.0.1:1", num_processes=2, process_id=1, backend="gloo")
    ev = [e for e in fresh_runtime.events if e["name"] == "distributed.init_degraded"]
    assert len(ev) == 1 and ev[0]["attrs"]["attempts"] == 1 and slept == []
