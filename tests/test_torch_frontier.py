"""The device-resident frontier (``gpu-frontier``) on the CPU against the JAX
package's ``TpuFrontierBackend``, with exact equality: verdict, witness pair
and every deterministic statistic.

- the cases of ``tests/test_frontier.py`` (differential, arena spill, the
  device flag filter on both sides, determinism, a restricted circuit) and
  the two SCCs above the sweep's reach, replayed from
  ``tests/_torch_frontier_jax.json`` (made by ``tests/_torch_frontier_pin.py``;
  a live JAX run of all of them is past this file's time budget) with one
  case run live against the pin;
- one chunk of the chunk loop (K9) and one block of the flag filter (K10)
  against the JAX programs ``_build_chunk`` / ``_build_flag_filter`` on
  seeded random states;
- checkpoints written by either package resumed by the other, to the same
  verdict and the same remaining counts, on a whole-graph and a restricted
  circuit;
- certificates of both verdicts through the unmodified ``tools/check_cert.py``;
- the CLI's ``--backend gpu-frontier`` and ``--checkpoint``, and the auto
  router's frontier rung, open only inside a planted win region on a
  matching device kind.
"""

import io
import json
import pathlib
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_intersection_tpu.backends.tpu.frontier import FrontierSearchInterrupted as JaxInterrupted
from quorum_intersection_tpu.backends.tpu.frontier import TpuFrontierBackend
from quorum_intersection_tpu.encode.circuit import encode_circuit as jax_encode
from quorum_intersection_tpu.fbas import synth as jax_synth
from quorum_intersection_tpu.fbas.graph import build_graph as jax_build_graph
from quorum_intersection_tpu.fbas.schema import parse_fbas as jax_parse
from quorum_intersection_tpu.pipeline import solve as jax_solve
from quorum_intersection_tpu.utils.checkpoint import FrontierCheckpoint as JaxCheckpoint
from quorum_intersection_tpu_torch import cli
from quorum_intersection_tpu_torch.backends.auto import AutoBackend
from quorum_intersection_tpu_torch.backends.calibration import Calibration
from quorum_intersection_tpu_torch.backends.frontier import (
    FLAG_EXIT_GROWTH,
    FrontierSearchInterrupted,
    GpuFrontierBackend,
)
from quorum_intersection_tpu_torch.encode.circuit import encode_circuit
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph, group_sccs, tarjan_scc
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.kernels.frontier_cuda import ArenaSet, FrontierRef, permute_nodes
from quorum_intersection_tpu_torch.kernels.frontier_ref import ChunkShape
from quorum_intersection_tpu_torch.kernels.sweep_ref import CircuitTables, fixpoint
from quorum_intersection_tpu_torch.pipeline import solve
from quorum_intersection_tpu_torch.utils.checkpoint import FrontierCheckpoint
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record

import _torch_frontier_pin as pin
from tools.check_cert import check_certificate

torch.set_num_threads(1)
PINNED = json.loads(pin.PIN.read_text())


def _port_result(name: str) -> dict:
    return pin.run_case(name, synth, parse_fbas, build_graph, encode_circuit, tarjan_scc, group_sccs, solve,
                        GpuFrontierBackend(device="cpu", **pin.CASES[name][3]))


@pytest.mark.parametrize("name", sorted(pin.CASES))
def test_port_frontier_equals_pinned_jax(name):
    assert _port_result(name) == PINNED[name]


def test_pin_equals_live_jax():
    assert pin.jax_result(pin.LIVE_CASE) == PINNED[pin.LIVE_CASE]


def test_pinned_counts_are_the_frontiers_known_targets():
    """The wide broken twins decide false after the popped counts the JAX
    package's CPU run recorded, and the unpadded runs after the padded
    runs' counts."""
    assert PINNED["stellar-16x3-broken"]["stats"]["states_popped"] == 12543
    assert PINNED["stellar-21x3-broken"]["stats"]["states_popped"] == 8447
    assert PINNED["stellar-21x3-broken"]["stats"]["padded_shape"][0] == 64
    assert not PINNED["stellar-16x3-broken"]["intersects"] and not PINNED["stellar-21x3-broken"]["intersects"]
    # Past 64 lanes: 66 and 126 lanes, padded to 96 and 128 (192 units).
    wide = {name: PINNED[name] for name in ("stellar-22x3-broken", "stellar-42x3-broken")}
    assert [w["stats"]["padded_shape"] for w in wide.values()] == [[96, 96, 128], [128, 128, 192]]
    assert [(w["stats"]["states_popped"], w["stats"]["device_iters"]) for w in wide.values()] == [(8191, 39),
                                                                                                   (16639, 72)]
    assert not any(w["intersects"] for w in wide.values())
    # Past 128 lanes: 129, 180 and 255 lanes, padded to 192, 192 and 256
    # (units 256, 256 and 384), the popped counts of the JAX package's run.
    wider = {name: PINNED[name] for name in ("stellar-43x3-broken", "stellar-60x3-broken", "stellar-85x3-broken")}
    assert [w["stats"]["padded_shape"] for w in wider.values()] == [[192, 192, 256], [192, 192, 256],
                                                                    [256, 256, 384]]
    assert [(w["stats"]["states_popped"], w["stats"]["device_iters"]) for w in wider.values()] == [
        (16895, 73), (26879, 112), (28415, 118)]
    assert not any(w["intersects"] for w in wider.values())
    # pad_shapes=False: the same traversal, no padded shape.
    unpadded = PINNED["stellar-44x3-broken-unpadded"]["stats"]
    assert unpadded["padded_shape"] is None and (unpadded["states_popped"], unpadded["device_iters"]) == (17919, 77)
    for name, padded, counts in (("hier-5x3-unpadded", "hier-5x3-device", (15101, 68)),
                                 ("stellar-22x3-broken-unpadded", "stellar-22x3-broken", (8191, 39))):
        stats = PINNED[name]["stats"]
        assert stats["padded_shape"] is None and (stats["states_popped"], stats["device_iters"]) == counts
        assert stats["states_popped"] == PINNED[padded]["stats"]["states_popped"]


# ---- one chunk and one flag block against the JAX programs ------------------

def _problem(data):
    """Both packages' circuits and the SCC of a network whose nodes form one
    SCC, with its in-degree matrix."""
    graph = build_graph(parse_fbas(data))
    count, comp = tarjan_scc(graph.n, graph.succ)
    scc = max(group_sccs(graph.n, comp, count), key=len)
    assert len(scc) == graph.n
    pos = {v: i for i, v in enumerate(scc)}
    a_scc = np.zeros((len(scc), len(scc)), dtype=np.int32)
    for u in scc:
        for w in graph.succ[u]:
            if w in pos:
                a_scc[pos[u], pos[w]] += 1
    return jax_encode(jax_build_graph(jax_parse(data))), encode_circuit(graph), scc, a_scc


@pytest.mark.parametrize("data,seed", [(synth.hierarchical_fbas(4, 3), 0), (synth.majority_fbas(9), 1)])
def test_one_chunk_equals_jax_build_chunk(data, seed):
    jc, pc, scc, a_scc = _problem(data)
    s, C, K, iters, flag_exit = len(scc), 256, 16, 8, 4
    rng = np.random.default_rng(seed)
    top = 40
    T = np.zeros((C, s), dtype=np.int8)
    D = np.zeros((C, s), dtype=np.int8)
    pick = rng.random((top, s))
    T[:top] = pick < 0.45
    D[:top] = (pick > 0.8) & (rng.random((top, s)) < 0.9)
    jb = TpuFrontierBackend(arena=C, pop=K, flag_exit=flag_exit, chunk_iters=iters)
    run = jb._build_chunk(jc, scc, a_scc, s // 2, K)
    jT, jD, jtop, jflags, jfc, jit, jpop = run(jnp.asarray(T), jnp.asarray(D), jnp.int32(top),
                                                jnp.int32(flag_exit))
    shape = ChunkShape(half=s // 2, K=K, C=C, chunk_iters=iters, flag_cap=flag_exit * FLAG_EXIT_GROWTH + K)
    ref = FrontierRef(pc, scc, a_scc, shape)
    src = ArenaSet(torch.from_numpy(T), torch.from_numpy(D), torch.zeros((shape.flag_cap, s), dtype=torch.int8),
                   torch.tensor([top, 0, 0, 0], dtype=torch.int32))
    dst = ArenaSet.empty(C, s, shape.flag_cap, torch.device("cpu"))
    ref.chunk(src, dst, flag_exit)
    got_top, fcount, got_iters, popped = dst.ctr.tolist()
    assert [got_top, fcount, got_iters, popped] == [int(jtop), int(jfc), int(jit), int(jpop)]
    assert got_iters > 1 and popped > 0
    np.testing.assert_array_equal(dst.T[:got_top].numpy(), np.asarray(jT)[:got_top])
    np.testing.assert_array_equal(dst.D[:got_top].numpy(), np.asarray(jD)[:got_top])
    np.testing.assert_array_equal(dst.flags[:fcount].numpy(), np.asarray(jflags)[:fcount])


@pytest.mark.parametrize("data,seed", [(synth.majority_fbas(8, broken=True), 0),
                                       (synth.hierarchical_fbas(4, 3), 1)])
def test_one_flag_block_equals_jax_flag_filter(data, seed):
    jc, pc, scc, a_scc = _problem(data)
    s, block, count = len(scc), 96, 80
    rng = np.random.default_rng(seed)
    flags = (rng.random((block, s)) < rng.uniform(0.3, 0.8, (block, 1))).astype(np.int8)
    jb = TpuFrontierBackend()
    want = jb._build_flag_filter(jc, scc, False, block)(jnp.asarray(flags), jnp.int32(count))
    shape = ChunkShape(half=s // 2, K=16, C=64, chunk_iters=1, flag_cap=block)
    frozen = np.zeros(pc.n, dtype=np.int32)
    got = FrontierRef(pc, scc, a_scc, shape, frozen=frozen).filter(torch.from_numpy(flags), count)
    assert got.tolist() == [int(want[0]), int(want[1])]
    assert 0 < int(want[0]) < count and int(want[1]) < block


def test_permute_nodes_relabels_the_fixpoint():
    """The card's lane-space circuit: the fixpoint of a permuted row under
    the permuted circuit is the permuted fixpoint."""
    circuit = encode_circuit(build_graph(parse_fbas(synth.random_fbas(12, seed=3, nested_prob=0.5))))
    order = np.random.default_rng(0).permutation(circuit.n)
    rows = (np.random.default_rng(1).random((64, circuit.n)) < 0.7).astype(np.int32)
    want = fixpoint(CircuitTables(circuit, torch.device("cpu")), torch.from_numpy(rows))[:, order]
    lane = CircuitTables(permute_nodes(circuit, order), torch.device("cpu"))
    got = fixpoint(lane, torch.from_numpy(rows[:, order]))
    assert torch.equal(got, want) and want.any()


# ---- checkpoints across the two packages -----------------------------------

RESUME_CASES = {
    "hier-4x3": (lambda s: s.hierarchical_fbas(4, 3), {"arena": 2048, "pop": 64}, {"chunk_iters": 2}, 2),
    "bench-64-14-restricted": (lambda s: s.benchmark_fbas(64, 14, seed=1), {"arena": 1024, "pop": 32},
                               {"chunk_iters": 2}, 1),
}
REMAINING = ("resumed_states", "states_popped", "flagged", "minimal_quorums", "device_chunks", "device_iters")


def _interrupted(writer: str, case: str, path: pathlib.Path) -> None:
    make, kw, extra, after = RESUME_CASES[case]
    if writer == "jax":
        with pytest.raises(JaxInterrupted):
            jax_solve(make(jax_synth), backend=TpuFrontierBackend(
                checkpoint=JaxCheckpoint(path), interrupt_after_chunks=after, **kw, **extra))
    else:
        with pytest.raises(FrontierSearchInterrupted):
            solve(make(synth), backend=GpuFrontierBackend(
                device="cpu", checkpoint=FrontierCheckpoint(path), interrupt_after_chunks=after, **kw, **extra))
    assert path.exists()


def _resumed(reader: str, case: str, path: pathlib.Path):
    make, kw, _, _ = RESUME_CASES[case]
    if reader == "jax":
        return jax_solve(make(jax_synth), backend=TpuFrontierBackend(checkpoint=JaxCheckpoint(path), **kw))
    return solve(make(synth), backend=GpuFrontierBackend(device="cpu", checkpoint=FrontierCheckpoint(path), **kw))


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(writer, case, tmp_path):
    """A frontier file written by one package resumes in the other (the
    fingerprints agree) and in its own, to the same verdict and the same
    remaining counts."""
    path = tmp_path / "frontier.ckpt"
    _interrupted(writer, case, path)
    copy = tmp_path / "copy.ckpt"
    shutil.copy(path, copy)
    other = _resumed("port" if writer == "jax" else "jax", case, path)
    same = _resumed(writer, case, copy)
    assert other.stats.get("resumed_states", 0) > 0
    assert other.intersects is same.intersects is True
    assert {k: other.stats.get(k) for k in REMAINING} == {k: same.stats.get(k) for k in REMAINING}
    assert not path.exists() and not copy.exists()


def test_stale_checkpoint_is_ignored(tmp_path):
    path = tmp_path / "frontier.ckpt"
    _interrupted("port", "hier-4x3", path)
    res = solve(synth.majority_fbas(9), backend=GpuFrontierBackend(
        device="cpu", arena=2048, pop=64, checkpoint=FrontierCheckpoint(path)))
    assert res.intersects is True and "resumed_states" not in res.stats


# ---- certificates, CLI, router ---------------------------------------------

@pytest.mark.parametrize("data", [synth.hierarchical_fbas(4, 3), synth.majority_fbas(10, broken=True)],
                         ids=["true", "false"])
def test_certificates_accepted_by_the_checker(data):
    res = solve(data, backend=GpuFrontierBackend(device="cpu", arena=8192, pop=256))
    notes = check_certificate(res.cert, data)
    assert res.cert["provenance"]["backend"] == "gpu-frontier"
    if res.intersects:
        entry = res.cert["coverage"]["sccs"][0]
        assert (entry["backend"], entry["engine"]) == ("tpu-frontier", "gpu-frontier")
        assert entry["frontier_chunks_drained"] == res.stats["device_chunks"] >= 1
        assert any("frontier ledger" in n for n in notes)
    else:
        assert res.q1 and res.q2 and not set(res.q1) & set(res.q2)


def _cli(argv, data, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(json.dumps(data)))
    rc = cli.main(argv)
    return rc, capsys.readouterr()


def test_cli_frontier_backend_checkpoint_and_cert(tmp_path, monkeypatch, capsys):
    cert = tmp_path / "c.json"
    rc, out = _cli(["--device", "cpu", "--backend", "gpu-frontier", "--checkpoint", str(tmp_path / "f.ckpt"),
                    "--cert-out", str(cert)], synth.majority_fbas(9), monkeypatch, capsys)
    assert (rc, out.out) == (0, "true\n")
    check_certificate(json.loads(cert.read_text()), synth.majority_fbas(9))
    rc, out = _cli(["--device", "cpu", "--backend", "gpu-frontier"], synth.majority_fbas(8, broken=True),
                   monkeypatch, capsys)
    assert (rc, out.out) == (1, "false\n")
    rc, out = _cli(["--device", "cpu", "--backend", "cpp", "--checkpoint", str(tmp_path / "x.ckpt")],
                   synth.majority_fbas(9), monkeypatch, capsys)
    assert rc == 1 and "--checkpoint requires --backend gpu-frontier" in out.err


def _planted(kind: str) -> Calibration:
    return Calibration(kind=kind, sweep_rate=5e5, sweep_overhead_warm_s=1.0, sweep_overhead_cold_s=1.0,
                       oracle_seconds_per_call={"cpp": 1.5e-6, "python": 3.3e-5},
                       frontier_win_min_scc=20, frontier_win_max_scc=22,
                       provenance={"frontier": "planted by the test"})


@pytest.mark.parametrize("orgs,kind,engine", [
    (7, "cpu", "gpu-frontier"),        # |scc| 21, inside [20, 22 + 4] on the matching kind
    (8, "cpu", "gpu-frontier"),        # 24, inside the headroom
    (9, "cpu", "cpp"),                 # 27, past the headroom
    (7, "NVIDIA H100 80GB HBM3", "cpp"),  # a region measured on another kind
])
def test_frontier_rung_opens_only_inside_a_matching_region(orgs, kind, engine):
    router = AutoBackend(device="cpu")
    router._cal = _planted(kind)
    rec = get_run_record()
    ev0 = rec.event_count()
    res = solve(synth.stellar_like_fbas(orgs, 3, broken=True), backend=router)
    assert len(res.main_scc) == 3 * orgs
    assert res.intersects is False and res.q1 and res.q2 and not set(res.q1) & set(res.q2)
    decisions = [e["attrs"] for e in rec.events_since(ev0) if e["name"] == "route.decision"]
    assert decisions[-1]["engine"] == engine
    assert res.stats["backend"] == engine


def _nominate_first_flag(monkeypatch):
    """The flag filter patched to name flag 0 of every block as a witness
    candidate, which on an intersecting network the host check refuses."""
    from quorum_intersection_tpu_torch.kernels import frontier_cuda

    real = frontier_cuda.frontier_filter

    def nominate(kern, flags_blk, count):
        out = real(kern, flags_blk, count)
        out[1] = 0
        return out

    monkeypatch.setattr(frontier_cuda, "frontier_filter", nominate)


def test_plain_filter_disagreement_checks_the_block_on_the_host(monkeypatch):
    """On the CPU the plain filter keeps the JAX drive's answer to a refused
    candidate: the whole block is checked exactly on the host, to the same
    verdict and minimal count (on the card the solve raises instead)."""
    data = synth.hierarchical_fbas(4, 3)
    honest = solve(data, backend=GpuFrontierBackend(device="cpu", flag_check="device", arena=8192, pop=256))
    _nominate_first_flag(monkeypatch)
    res = solve(data, backend=GpuFrontierBackend(device="cpu", flag_check="device", arena=8192, pop=256))
    assert honest.intersects is True and res.intersects is True
    assert res.stats["device_flag_checks"] == honest.stats["device_flag_checks"] > 0
    assert res.stats["host_checks"] == res.stats["device_flag_checks"]
    assert res.stats["minimal_quorums"] == honest.stats["minimal_quorums"]
