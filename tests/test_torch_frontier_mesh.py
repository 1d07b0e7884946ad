"""The frontier under a mesh on the CPU: ``GpuFrontierBackend(device="cpu",
mesh=candidate_mesh(n, device="cpu"))`` against the JAX package's
``TpuFrontierBackend(mesh=candidate_mesh(n))`` on the conftest's 8 emulated
devices, with exact equality of the verdict, the witness pair and the
statistics ``states_popped``, ``device_iters``, ``device_chunks``,
``flagged``, ``minimal_quorums``, ``host_checks``, ``device_flag_checks``,
``spills`` and ``discarded_chunks``.

- the JAX multichip cases (``tests/test_multichip.py:190-290``): hier-4x3 at
  arena 4096, pop 250; the broken ``majority_fbas(12)`` at pop 256;
  hier-5x3 with ``flag_check="device"`` (the plain K10 on the CPU); the
  broken ``stellar_like_fbas(4, 3, 10)``; hier-4x3 at arena 2048, pop 512
  (the JAX test's 3 ranks round the pop to 510), and the "too small" error
  at arena 8, pop 4; an arena small enough to spill; each on meshes of 1,
  2, 3 and 8 ranks; and the broken ``stellar_like_fbas(30 | 42, 3)`` (90
  and 126 lanes, two words a state) on 2;
- a checkpoint written under a mesh and resumed under one by both packages;
- the plain sharded iteration (``frontier_ref.sharded_chunk_loop``) against
  the unsharded chunk loop at the same pop, on 1, 2, 3 and 8 ranks, and its
  gather through ``mesh_all_gather``;
- ``mesh_all_gather`` itself, and a failed gather failing the solve.

Everything compared is an integer, a node list or a string.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from quorum_intersection_tpu.backends.tpu.frontier import FrontierSearchInterrupted as JaxInterrupted
from quorum_intersection_tpu.backends.tpu.frontier import TpuFrontierBackend
from quorum_intersection_tpu.fbas import synth as jax_synth
from quorum_intersection_tpu.parallel.mesh import candidate_mesh as jax_candidate_mesh
from quorum_intersection_tpu.pipeline import solve as jax_solve
from quorum_intersection_tpu.utils.checkpoint import FrontierCheckpoint as JaxCheckpoint
from quorum_intersection_tpu_torch.backends.frontier import (
    FrontierSearchInterrupted,
    GpuFrontierBackend,
    frontier_problem,
)
from quorum_intersection_tpu_torch.encode.circuit import encode_circuit
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.kernels.frontier_cuda import (
    ArenaSet,
    FrontierKernels,
    FrontierRef,
    IterationState,
    mesh_chunk,
)
from quorum_intersection_tpu_torch.kernels.frontier_ref import (
    ChunkShape,
    chunk_loop,
    sharded_chunk_loop,
    stash_half_bytes,
)
from quorum_intersection_tpu_torch.parallel import candidate_mesh
from quorum_intersection_tpu_torch.parallel.mesh import CandidateMesh, mesh_all_gather
from quorum_intersection_tpu_torch.pipeline import quorum_bearing_sccs, solve
from quorum_intersection_tpu_torch.utils.checkpoint import FrontierCheckpoint

from tools.check_cert import check_certificate

torch.set_num_threads(1)

STATS = ("states_popped", "device_iters", "device_chunks", "flagged", "minimal_quorums", "host_checks",
         "device_flag_checks", "spills", "discarded_chunks")
# name: (network, backend arguments, meshes)
CASES = {
    "hier-4x3": (lambda s: s.hierarchical_fbas(4, 3), {"arena": 4096, "pop": 250}, (1, 2, 3, 8)),
    "majority-12-broken": (lambda s: s.majority_fbas(12, broken=True), {"arena": 4096, "pop": 256}, (1, 2, 3, 8)),
    "hier-5x3-device-filter": (lambda s: s.hierarchical_fbas(5, 3),
                               {"arena": 8192, "pop": 256, "flag_check": "device"}, (1, 2, 3, 8)),
    "stellar-4x3-10-broken": (lambda s: s.stellar_like_fbas(n_core_orgs=4, per_org=3, n_watchers=10, broken=True),
                              {"arena": 8192, "pop": 256, "flag_check": "device"}, (1, 2, 3, 8)),
    "hier-4x3-nondividing": (lambda s: s.hierarchical_fbas(4, 3), {"arena": 2048, "pop": 512}, (1, 2, 3, 8)),
    # Overflows its arena: the spill and the refeed write every rank's set.
    "hier-4x3-spill": (lambda s: s.hierarchical_fbas(4, 3), {"arena": 64, "pop": 16}, (1, 2, 3, 8)),
    # Past 64 lanes (90 and 126), where a state is two words of the stash.
    "stellar-30x3-broken": (lambda s: s.stellar_like_fbas(30, 3, broken=True), {"arena": 8192, "pop": 256}, (2,)),
    "stellar-42x3-broken": (lambda s: s.stellar_like_fbas(42, 3, broken=True), {"arena": 8192, "pop": 256}, (2,)),
    # Past 128 lanes (129, padded to 192): three words a state.
    "stellar-43x3-broken": (lambda s: s.stellar_like_fbas(43, 3, broken=True), {"arena": 8192, "pop": 256}, (2,)),
}


def _answer(res) -> dict:
    return {"intersects": res.intersects, "q1": res.q1, "q2": res.q2, **{k: res.stats.get(k) for k in STATS}}


@pytest.mark.parametrize("name,n", [(name, n) for name, (_, _, meshes) in CASES.items() for n in meshes])
def test_mesh_frontier_equals_jax(name, n):
    make, kw, _ = CASES[name]
    want = jax_solve(make(jax_synth), backend=TpuFrontierBackend(mesh=jax_candidate_mesh(n), **kw))
    got = solve(make(synth), backend=GpuFrontierBackend(device="cpu", mesh=candidate_mesh(n, device="cpu"), **kw))
    assert _answer(got) == _answer(want)
    # One process: the mesh-chunk instance, a launch a chunk dispatched (the
    # drained ones and the discarded ones) on the one device.
    assert got.stats["mesh"]["ranks"] == n and got.stats["mesh"]["instance"] == "chunk"
    assert got.stats["mesh"]["chunk_launches"] == got.stats["device_chunks"] + got.stats["discarded_chunks"] > 0
    if not got.intersects:
        assert got.q1 and got.q2 and not set(got.q1) & set(got.q2)
    if name == "hier-4x3-spill":
        assert got.stats["spills"] > 0
    if name == "hier-4x3" and n == 8:
        # The JAX package's measured run: every count follows from pop 256.
        assert (got.stats["states_popped"], got.stats["device_iters"], got.stats["minimal_quorums"]) == (1739, 17, 108)
        assert got.stats["mesh"]["pop"] == 256


@pytest.mark.parametrize("name", ["stellar-60x3-broken", "stellar-85x3-broken"])
def test_mesh_frontier_past_128_lanes_equals_the_jax_pin(name):
    """Two ranks at 180 and 255 lanes, where a branch lane past 127 sets the
    stash code's bit 15: the verdict, witness and counts of the JAX
    package's pinned run (pop 256 splits over 2 ranks, so the traversal is
    the unsharded one's)."""
    import _torch_frontier_pin as pin

    want = json.loads(pin.PIN.read_text())[name]
    got = solve(pin.case_data(name, synth), backend=GpuFrontierBackend(
        device="cpu", mesh=candidate_mesh(2, device="cpu"), **pin.CASES[name][3]))
    assert (got.intersects, got.q1, got.q2) == (want["intersects"], want["q1"], want["q2"])
    for key in ("states_popped", "device_iters", "device_chunks", "flagged", "minimal_quorums", "spills"):
        assert got.stats[key] == want["stats"][key], key
    assert got.stats["mesh"]["instance"] == "chunk"


def test_mesh_rounds_the_pop_block_as_jax():
    """3 ranks at pop 512, arena 2048: K = min(513, 510) = 510, and the
    flag buffer follows the effective K."""
    res = solve(synth.hierarchical_fbas(4, 3), backend=GpuFrontierBackend(
        device="cpu", arena=2048, pop=512, mesh=candidate_mesh(3, device="cpu")))
    assert res.stats["mesh"]["pop"] == 510 and res.stats["device_iters"] == 13


def test_too_small_arena_raises_the_jax_text():
    mesh3 = candidate_mesh(3, device="cpu")
    with pytest.raises(ValueError, match="too small") as jax_err:
        jax_solve(jax_synth.majority_fbas(9), backend=TpuFrontierBackend(arena=8, pop=4, mesh=jax_candidate_mesh(3)))
    with pytest.raises(ValueError, match="too small") as port_err:
        solve(synth.majority_fbas(9), backend=GpuFrontierBackend(device="cpu", arena=8, pop=4, mesh=mesh3))
    assert str(port_err.value) == str(jax_err.value) == "arena=8 too small for a 3-device mesh (needs >= 12)"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_under_a_mesh(writer, tmp_path):
    """A frontier file written under a 2-rank mesh after two chunks resumes
    under a mesh in both packages, to the same verdict and the same
    remaining counts."""
    kw = {"arena": 8192, "pop": 256, "chunk_iters": 2}
    path, copy = tmp_path / "frontier.ckpt", tmp_path / "copy.ckpt"
    if writer == "jax":
        with pytest.raises(JaxInterrupted):
            jax_solve(jax_synth.hierarchical_fbas(5, 3), backend=TpuFrontierBackend(
                mesh=jax_candidate_mesh(2), checkpoint=JaxCheckpoint(path), interrupt_after_chunks=2, **kw))
    else:
        with pytest.raises(FrontierSearchInterrupted):
            solve(synth.hierarchical_fbas(5, 3), backend=GpuFrontierBackend(
                device="cpu", mesh=candidate_mesh(2, device="cpu"), checkpoint=FrontierCheckpoint(path),
                interrupt_after_chunks=2, **kw))
    shutil.copy(path, copy)
    got = solve(synth.hierarchical_fbas(5, 3), backend=GpuFrontierBackend(
        device="cpu", mesh=candidate_mesh(4, device="cpu"), checkpoint=FrontierCheckpoint(path), **kw))
    want = jax_solve(jax_synth.hierarchical_fbas(5, 3), backend=TpuFrontierBackend(
        mesh=jax_candidate_mesh(4), checkpoint=JaxCheckpoint(copy), **kw))
    assert got.stats.get("resumed_states", 0) > 0
    assert _answer(got) == _answer(want) and got.intersects is True
    assert got.stats["resumed_states"] == want.stats["resumed_states"]
    assert not path.exists() and not copy.exists()


@pytest.mark.parametrize("data", [synth.hierarchical_fbas(4, 3), synth.majority_fbas(10, broken=True)],
                         ids=["true", "false"])
def test_mesh_certificates_accepted_by_the_checker(data):
    mesh = candidate_mesh(4, device="cpu")
    res = solve(data, backend=GpuFrontierBackend(device="cpu", arena=4096, pop=256, mesh=mesh))
    check_certificate(res.cert, data)
    assert res.cert["provenance"]["backend"] == "gpu-frontier"


# ---- the plain sharded iteration -------------------------------------------

def _ref(data, K, C=512, chunk_iters=40, flag_exit=64):
    graph = build_graph(parse_fbas(data))
    prob = frontier_problem(graph, encode_circuit(graph), quorum_bearing_sccs(graph)[0][1])
    shape = ChunkShape(half=prob.half, K=K, C=C, chunk_iters=chunk_iters, flag_cap=flag_exit + K)
    return prob, shape, FrontierRef(prob.circuit, prob.scc_dev, prob.a_scc, shape, prob.probe_circuit, prob.frozen)


def _arena(shape, s, T=None, D=None, top=0):
    st = ArenaSet.empty(shape.C, s, shape.flag_cap, torch.device("cpu"))
    if T is not None:
        st.T.copy_(T)
        st.D.copy_(D)
    st.ctr[0] = top
    return st


def _seeded(prob, C, seed):
    """A source arena: the seed state, or a random stack of 40 states."""
    T = torch.zeros((C, prob.s_dev), dtype=torch.int8)
    D = torch.zeros_like(T)
    if seed is None:
        T[0, : prob.s] = 1
        return T, D, 1
    rng = np.random.default_rng(seed)
    pick = rng.random((40, prob.s))
    T[:40, : prob.s] = torch.from_numpy((pick < 0.45).astype(np.int8))
    D[:40, : prob.s] = torch.from_numpy(((pick > 0.8) & (rng.random((40, prob.s)) < 0.9)).astype(np.int8))
    return T, D, 40


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("data,seed", [(synth.hierarchical_fbas(4, 3), None), (synth.hierarchical_fbas(4, 3), 0),
                                       (synth.majority_fbas(9), 1)], ids=["hier-4x3-seed", "hier-4x3-random",
                                                                          "majority-9-random"])
def test_plain_sharded_iteration_equals_unsharded(n, data, seed):
    """Every rank's chunk of sharded iterations ends where the unsharded
    chunk loop does at the same pop: counters, arena rows [0, top), flags."""
    prob, shape, ref = _ref(data, K=24)
    src_T, src_D, top = _seeded(prob, shape.C, seed)
    T, D = torch.zeros_like(src_T), torch.zeros_like(src_D)
    flags = torch.zeros((shape.flag_cap, prob.s_dev), dtype=torch.int8)
    want = chunk_loop(ref.tables, ref.scc_idx, ref.a_mat, shape, src_T, src_D, top, T, D, flags, 64)
    arenas = [(torch.zeros_like(T), torch.zeros_like(D), torch.zeros_like(flags)) for _ in range(n)]
    got = sharded_chunk_loop(ref.tables, ref.scc_idx, ref.a_mat, shape, n, src_T, src_D, top, arenas, 64)
    assert want[2] > 1  # more than one iteration, so the gathered stash is read
    assert got == [tuple(want)] * n
    wtop, wfc = want[:2]
    for rT, rD, rF in arenas:
        assert torch.equal(rT[:wtop], T[:wtop]) and torch.equal(rD[:wtop], D[:wtop])
        assert torch.equal(rF[:wfc], flags[:wfc])


@pytest.mark.parametrize("n", [2, 3])
def test_mesh_chunk_gathers_through_mesh_all_gather(n):
    """The drive's chunk (wrappers, states, mesh_all_gather) equals the plain
    sharded loop's, on every rank."""
    data = synth.hierarchical_fbas(4, 3)
    prob, shape, ref = _ref(data, K=24)
    src_T, src_D, top = _seeded(prob, shape.C, None)
    arenas = [(torch.zeros_like(src_T), torch.zeros_like(src_D),
               torch.zeros((shape.flag_cap, prob.s_dev), dtype=torch.int8)) for _ in range(n)]
    want = sharded_chunk_loop(ref.tables, ref.scc_idx, ref.a_mat, shape, n, src_T, src_D, top, arenas, 64)
    mesh = candidate_mesh(n, device="cpu")
    src = _arena(shape, prob.s_dev, src_T, src_D, top)
    states = [IterationState.empty(shape.K, n, src, _arena(shape, prob.s_dev)) for _ in range(n)]
    steps = mesh_chunk(mesh, [ref] * n, states, 64, iterate=lambda k, st, r, m, fe: k.iteration(st, r, m, fe),
                       batch=3)
    # The launches the chunk needs (its iterations and the one that ends
    # it), in whole batches of 3, never past chunk_iters + 1.
    need = want[0][2] + 1
    assert steps == min(-(-need // 3) * 3, shape.chunk_iters + 1)
    wtop, wfc = want[0][:2]
    for st, (rT, rD, rF) in zip(states, arenas):
        assert tuple(st.dst.ctr.tolist()) == want[0]
        assert torch.equal(st.dst.T[:wtop], rT[:wtop]) and torch.equal(st.dst.D[:wtop], rD[:wtop])
        assert torch.equal(st.dst.flags[:wfc], rF[:wfc])


# ---- the gather ------------------------------------------------------------

def test_mesh_all_gather_concatenates_in_rank_order():
    mesh = candidate_mesh(3, device="cpu")
    parts = [torch.arange(4, dtype=torch.int16) + 10 * r for r in range(3)]
    outs = mesh_all_gather(mesh, parts)
    want = torch.cat(parts)
    assert len(outs) == 3 and all(torch.equal(o, want) for o in outs)
    # In place: each rank's share already sits at its place in its result.
    bufs = [torch.zeros(12, dtype=torch.uint8) for _ in range(3)]
    for r, b in enumerate(bufs):
        b[4 * r: 4 * r + 4] = r + 1
    mesh_all_gather(mesh, [b[4 * r: 4 * r + 4] for r, b in enumerate(bufs)], out=bufs)
    assert all(b.tolist() == [1] * 4 + [2] * 4 + [3] * 4 for b in bufs)
    with pytest.raises(ValueError):
        mesh_all_gather(mesh, parts[:2])
    # A process's ranks sit at its place among the global ranks.
    two = CandidateMesh(devices=(torch.device("cpu"),) * 2, process_index=1, process_count=2)
    assert [two.global_rank(i) for i in range(2)] == [2, 3]


def test_failed_gather_fails_the_solve():
    """A mesh that names a second process with no process group behind it:
    the gather raises and so does the solve, with no verdict."""
    mesh = CandidateMesh(devices=(torch.device("cpu"),) * 2, process_count=2)
    with pytest.raises((RuntimeError, ValueError)):
        solve(synth.hierarchical_fbas(4, 3), backend=GpuFrontierBackend(device="cpu", arena=4096, pop=256, mesh=mesh))


@pytest.mark.parametrize("lanes,words", [(8, 1), (64, 1), (72, 2), (128, 2), (136, 3), (192, 3), (200, 4),
                                         (256, 4)])
def test_stash_share_layout(lanes, words):
    """A share of a stash half is (16 W + 2) Ks bytes: Ks states of W words
    of toRemove, Ks of dontRemove, Ks codes; Ks = K / n rounded up to 8 and
    W = ceil(lanes / 64): 18 Ks at up to 64 lanes, 34 Ks up to 128, 50 Ks up
    to 192, 66 Ks up to 256."""
    from quorum_intersection_tpu_torch.kernels.frontier_ref import stash_half, state_words

    entry = 16 * words + 2
    assert state_words(lanes) == words and entry == {1: 18, 2: 34, 3: 50, 4: 66}[words]
    assert stash_half_bytes(2048, 4, words) == 4 * entry * 512
    assert stash_half_bytes(510, 3, words) == 3 * entry * 176
    assert stash_half_bytes(256, 8, words) == 8 * entry * 32
    with pytest.raises(ValueError):
        stash_half_bytes(250, 8, words)
    shape = ChunkShape(half=1, K=24, C=64, chunk_iters=1, flag_cap=30)
    st = IterationState.empty(24, 3, _arena(shape, lanes), _arena(shape, lanes))
    share = entry * 8
    assert st.stash.numel() == 2 * 3 * share
    assert st.share(24, 2, 3, 1).data_ptr() == st.stash.data_ptr() + 3 * share + 2 * share
    assert st.half(24, 3, 1).numel() == 3 * share
    T, D, code = stash_half(st.stash, 24, 3, 1, words)
    assert T.shape == D.shape == (3, 8, words) and code.shape == (3, 8)
    assert D.data_ptr() - T.data_ptr() == 8 * words * 8 and code.data_ptr() - T.data_ptr() == 16 * words * 8
    assert T[1].data_ptr() - T[0].data_ptr() == share


@pytest.mark.parametrize("lanes", [15, 64, 66, 126, 128, 129, 192, 255, 256])
def test_state_words_round_trip_every_lane(lanes):
    """``pack_words`` keeps every lane, 64 and past it included (no shift
    past bit 63), and ``unpack_words`` gives the rows back."""
    from quorum_intersection_tpu_torch.kernels.frontier_ref import lane_words, pack_words, unpack_words

    rng = np.random.default_rng(lanes)
    rows = torch.from_numpy((rng.random((40, lanes)) < 0.5).astype(np.int8))
    rows[0] = 0
    rows[1] = 1
    rows[2, lanes - 1] = 1
    words = pack_words(rows)
    assert words.shape == (40, -(-lanes // 64)) and words.dtype == torch.int64
    assert torch.equal(unpack_words(words, lanes), rows)
    eye = unpack_words(lane_words(torch.arange(lanes), words.shape[1]), lanes)
    assert torch.equal(eye, torch.eye(lanes, dtype=torch.int8))


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_mesh_lockstep_on_the_cpu(ranks):
    """The card checks' lockstep (``_torch_frontier_blocks.mesh_lockstep``)
    on CPU ranks, where both sides run the plain version: every chunk equal
    across ranks, through a spill, over more than one chunk."""
    from _torch_frontier_blocks import mesh_lockstep

    graph = build_graph(parse_fbas(synth.hierarchical_fbas(4, 3)))
    prob = frontier_problem(graph, encode_circuit(graph), quorum_bearing_sccs(graph)[0][1])
    shape = ChunkShape(half=prob.half, K=16, C=64, chunk_iters=512, flag_cap=512 * 16 + 16)
    kern = FrontierKernels(prob.circuit, prob.scc_dev, prob.a_scc, shape, prob.probe_circuit, prob.frozen,
                           device="cpu")
    done, iters, flags, steps, bad, reasons, tops = mesh_lockstep(prob, shape, kern, kern.ref, ranks, 8, batch=4)
    assert not bad and done > 1 and iters > done and "overflow guard" in reasons


# ---- the mesh-chunk instance's plain version and the routing ----------------

# name: (network, arena, pop, chunk_iters, chunks): the pop splits over 1, 2,
# 4 and 8 ranks; short chunks end on every exit, the spill case overflows.
CHUNK_CASES = {
    "random-24": (lambda: synth.random_fbas(24, seed=0), 512, 24, 6, 4),
    "hier-4x3": (lambda: synth.hierarchical_fbas(4, 3), 512, 24, 6, 4),
    "hier-4x3-spill": (lambda: synth.hierarchical_fbas(4, 3), 64, 16, 512, 6),
}


def _cpu_problem(data, arena, pop, chunk_iters):
    graph = build_graph(parse_fbas(data))
    prob = frontier_problem(graph, encode_circuit(graph), quorum_bearing_sccs(graph)[0][1])
    shape = ChunkShape(half=prob.half, K=pop, C=arena, chunk_iters=chunk_iters, flag_cap=512 * 16 + pop)
    kern = FrontierKernels(prob.circuit, prob.scc_dev, prob.a_scc, shape, prob.probe_circuit, prob.frozen,
                           device="cpu")
    return prob, shape, kern


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_mesh_chunk_ref_equals_the_iteration_lockstep(case, ranks):
    """The mesh-chunk instance's plain version (one arena and one stash for
    every rank, through ``frontier_mesh_chunk`` and directly) against the
    iteration instance's plain lockstep (an arena and a gathered stash a
    rank), chunk for chunk: counters, arena rows [0, top), flags and the
    stash, exactly."""
    from _torch_frontier_blocks import mesh_chunk_lockstep

    make, arena, pop, chunk_iters, chunks = CHUNK_CASES[case]
    prob, shape, kern = _cpu_problem(make(), arena, pop, chunk_iters)
    done, iters, flags, launches, bad, reasons, _ = mesh_chunk_lockstep(prob, shape, kern, kern.ref, ranks, chunks,
                                                                        flag_exit=8, iteration=True)
    assert not bad, bad[:3]
    assert done > 1 and iters > done and launches == done
    if case == "hier-4x3-spill":
        assert "overflow guard" in reasons
    elif case == "hier-4x3":
        assert flags and "chunk_iters" in reasons
    else:
        assert reasons[-2:] == ["chunk_iters", "empty stack"]


def test_mesh_chunk_ref_equals_the_unsharded_chunk_loop():
    """A chunk of the plain mesh-chunk instance on 4 ranks ends where K9's
    plain chunk loop does at the same pop."""
    from quorum_intersection_tpu_torch.kernels.frontier_ref import mesh_chunk_ref

    prob, shape, ref = _ref(synth.majority_fbas(9), K=24)
    src_T, src_D, top = _seeded(prob, shape.C, 1)
    T, D = torch.zeros_like(src_T), torch.zeros_like(src_D)
    flags = torch.zeros((shape.flag_cap, prob.s_dev), dtype=torch.int8)
    want = chunk_loop(ref.tables, ref.scc_idx, ref.a_mat, shape, src_T, src_D, top, T, D, flags, 64)
    gT, gD, gF = torch.zeros_like(T), torch.zeros_like(D), torch.zeros_like(flags)
    ctr = torch.zeros(4, dtype=torch.int32)
    stash = torch.zeros(2 * stash_half_bytes(shape.K, 4, 1), dtype=torch.uint8)
    steps = mesh_chunk_ref(ref.tables, ref.scc_idx, ref.a_mat, shape, 4, src_T, src_D, top, gT, gD, gF, ctr, stash, 64)
    assert want[2] > 1 and steps == want[2] + 1 and tuple(ctr.tolist()) == tuple(want)
    wtop, wfc = want[:2]
    assert torch.equal(gT[:wtop], T[:wtop]) and torch.equal(gD[:wtop], D[:wtop])
    assert torch.equal(gF[:wfc], flags[:wfc])


def test_one_process_mesh_runs_the_chunk_instance():
    """A one-process mesh runs the mesh-chunk instance, a launch a chunk on
    its one device, dispatched ahead as K9's chunks are (a chunk the drive
    drops was launched too); its statistics name it."""
    res = solve(synth.hierarchical_fbas(4, 3), backend=GpuFrontierBackend(
        device="cpu", arena=4096, pop=256, mesh=candidate_mesh(4, device="cpu")))
    mesh = res.stats["mesh"]
    assert mesh["instance"] == "chunk" and mesh["processes"] == 1 and mesh["collective"] == "none"
    assert mesh["chunk_launches"] == res.stats["device_chunks"] + res.stats["discarded_chunks"] > 0
    assert "iteration_launches" not in mesh


def test_mesh_cards_groups_the_ranks_of_a_device():
    cpu = torch.device("cpu")
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import mesh_cards

    assert mesh_cards([cpu] * 3) == [(cpu, (0, 1, 2))]
    assert mesh_cards([a, b, a, b]) == [(a, (0, 2)), (b, (1, 3))]


def test_hoisted_checks_raise_before_any_launch():
    """The iteration instance's checks, made once a chunk, raise the same
    errors as before and before the first launch: a pop that does not split,
    a rank out of range, a stash of the wrong size; so do the mesh-chunk
    instance's: ranks that do not cover the mesh, a second CPU state."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import CardState, frontier_iteration, \
        frontier_mesh_chunk

    prob, shape, kern = _cpu_problem(synth.hierarchical_fbas(4, 3), 512, 24, 6)
    seeded = _arena(shape, prob.s_dev, *_seeded(prob, shape.C, None))
    mesh3 = candidate_mesh(3, device="cpu")

    def fresh(ranks, K=24):
        return [IterationState.empty(K, ranks, seeded, _arena(shape, prob.s_dev)) for _ in range(ranks)]

    with pytest.raises(ValueError, match="does not split"):
        mesh_chunk(candidate_mesh(5, device="cpu"), [kern] * 5, fresh(1) * 5, 64)
    with pytest.raises(ValueError, match="rank 3 of 3"):
        frontier_iteration(kern, fresh(3)[0], 3, 3, 64)
    states = fresh(3)
    states[2].stash = states[2].stash[:-1]
    with pytest.raises(ValueError, match="stash"):
        mesh_chunk(mesh3, [kern] * 3, states, 64)
    # Nothing ran: no step taken, no loop state or destination written.
    assert all(st.step == 0 and not st.loop.any() and not st.dst.ctr.any() for st in states)
    card = CardState.empty(24, 3, (0, 1), seeded, _arena(shape, prob.s_dev))
    with pytest.raises(ValueError, match="cover"):
        frontier_mesh_chunk([kern], [card], 64)
    halves = [CardState.empty(24, 2, (r,), seeded, _arena(shape, prob.s_dev)) for r in range(2)]
    with pytest.raises(ValueError, match="one CPU state"):
        frontier_mesh_chunk([kern] * 2, halves, 64)
    assert not card.dst.ctr.any() and not any(st.dst.ctr.any() or st.stash.any() for st in halves)


def test_iteration_checks_run_once_a_chunk(monkeypatch):
    """``mesh_chunk`` checks and prepares each rank's launches once a chunk,
    not once a launch."""
    from quorum_intersection_tpu_torch.kernels import frontier_cuda

    prob, shape, kern = _cpu_problem(synth.hierarchical_fbas(4, 3), 512, 24, 6)
    seeded = _arena(shape, prob.s_dev, *_seeded(prob, shape.C, None))
    states = [IterationState.empty(24, 3, seeded, _arena(shape, prob.s_dev)) for _ in range(3)]
    prepared = []
    real = frontier_cuda.iteration_launcher
    monkeypatch.setattr(frontier_cuda, "iteration_launcher", lambda *a: prepared.append(a[2]) or real(*a))
    steps = mesh_chunk(candidate_mesh(3, device="cpu"), [kern] * 3, states, 64)
    assert steps > 3 and prepared == [0, 1, 2]


@pytest.mark.parametrize("code", [217, 101, 0])
def test_peer_access_codes_map_to_errors(monkeypatch, code):
    """``enable_peer_access`` maps the library's answer: no peer path
    (``cudaErrorPeerAccessUnsupported``) is a :class:`KernelLimitError`
    naming peer access, any other fault a ``RuntimeError`` naming the CUDA
    error, success nothing."""
    from quorum_intersection_tpu_torch.kernels import frontier_cuda

    class Library:
        calls = []

        def qi_frontier_enable_peer(self, dev, peer):
            self.calls.append((dev, peer))
            return code

        def qi_cuda_error_string(self, err):
            return f"cuda error {err}".encode()

    monkeypatch.setattr(frontier_cuda, "_library", Library)
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    if code == 217:
        with pytest.raises(frontier_cuda.KernelLimitError, match="no peer access from cuda:0 to cuda:1"):
            frontier_cuda.enable_peer_access(a, b)
    elif code:
        with pytest.raises(RuntimeError, match=f"cuda error {code}"):
            frontier_cuda.enable_peer_access(a, b)
    else:
        frontier_cuda.enable_peer_access(a, b)
    assert Library.calls == [(0, 1)]
