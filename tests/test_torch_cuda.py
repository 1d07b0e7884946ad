"""The CUDA kernels on the card — the fused unpacked sweep, the unpacked
bitset sweep, the two lane-packed sweeps and the two block-guard instances,
the PageRank loop and the frontier's kernels — against their plain
PyTorch versions and against the CPU path; incremental re-analysis
(``delta.DeltaEngine``) on the card against the same engine on the CPU; and
the serving layer's cross-request fusion and mid-pack deadline on the card;
and the replicated serve tier (``fleet.py``) of in-process and of process
workers on the card; the tooling on the card (a profiled solve's trace, the
build cache's cold and warm processes) and the native SCC scan inside a card
solve; the mesh sweep K11 (one launch of the fused kernel a card and
program, on 1-8 ranks of one card and on four cards; the mesh solve, its
limits and a failed collective).  Card-only: every test
takes the ``cuda_device``
fixture, which skips on a host without one.  This file imports nothing of
JAX or the JAX package, so on the card's machine it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: exact equality (hit indices, verdicts and witness node lists are
integers).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from quorum_intersection_tpu_torch.encode.circuit import (
    encode_circuit,
    pack_circuits,
    restrict_circuit_pair,
)
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph, group_sccs, tarjan_scc
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.fbas.semantics import max_quorum
from quorum_intersection_tpu_torch.kernels import sweep_ref as ref
from quorum_intersection_tpu_torch.kernels.sweep_cuda import (
    FusedSweep,
    KernelLimitError,
    mask_bits,
    sweep_fused,
)
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
from quorum_intersection_tpu_torch.encode.circuit import bitset_supported
from quorum_intersection_tpu_torch.kernels.packed_cuda import (
    PackedSweep,
    packed_sweep_bitset,
    packed_sweep_dense,
)
from quorum_intersection_tpu_torch.kernels.guard_cuda import BlockGuard, guard_bitset, guard_dense
from quorum_intersection_tpu_torch.kernels.guard_ref import guard_counts
from quorum_intersection_tpu_torch.kernels.packed_ref import PackedRef
from quorum_intersection_tpu_torch.pipeline import check_many, solve

from _torch_circuits import dense_child_circuit
from _torch_frontier_blocks import EXIT_REASONS, exit_reason, wide_flag_block

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)
FIXTURES = pathlib.Path(__file__).resolve().parent.parent / "fixtures"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused kernel has no CPU mode")
    return torch.device("cuda")


def _data(case: str):
    if case.endswith(".json"):
        return json.loads((FIXTURES / case).read_text())
    core, broken = case.split("-")
    return synth.benchmark_fbas(48, int(core), nested_watchers=True, broken=broken == "broken", seed=1)


def _problems(case: str):
    """Narrow (whole graph, Q6 frozen row), restricted (Q6 fold), and wide
    (3 low bits, random hi row) sweep problems of the quorum-bearing SCC."""
    graph = build_graph(parse_fbas(_data(case)))
    count, comp = tarjan_scc(graph.n, graph.succ)
    sccs = group_sccs(graph.n, comp, count)
    scc = next(m for m in sccs if max_quorum(graph, m, [v in set(m) for v in range(graph.n)]))
    whole = encode_circuit(graph)
    out = []
    if whole.n <= 64:
        mask = np.zeros(whole.n, dtype=np.int32)
        mask[scc] = 1
        out.append(("narrow", whole, None, list(scc), mask, 1 - mask, len(scc) - 1, 0))
    if whole.n > len(scc):
        q, d = restrict_circuit_pair(whole, scc)
        local = list(range(len(scc)))
        mask = np.ones(len(scc), dtype=np.int32)
        out.append(("restricted", q, d, local, mask, None, len(scc) - 1, 0))
        out.append(("wide", q, d, local, mask, None, 3, 0b1011))
    return out


@pytest.mark.parametrize(
    "case", ["nested_correct.json", "nested_broken.json", "snapshot_broken.json", "9-broken", "10-correct"]
)
def test_fused_kernel_matches_plain_on_card(case, cuda_device):
    for mode, q, d, local, mask, frozen, lo_bits, hi in _problems(case):
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        hi_row = np.zeros(q.n, dtype=np.int32)
        for j, v in enumerate(local[1 + lo_bits:]):
            hi_row[v] = (hi >> j) & 1
        batch = min(1 << 12, 1 << lo_bits)
        fused = FusedSweep(q, lo_nodes, mask, frozen, batch, circuit_d=d, device=cuda_device)
        plain = ref.SweepRef(q, lo_nodes, mask, frozen, batch, d, cuda_device)
        launches = sweep_fused.launches
        for start in sorted({0, (1 << lo_bits) // 2}):
            got = int(fused.program(start, 2, mask_bits(hi_row)))
            want = int(plain.program(start, 2, hi_row if hi_row.any() else None))
            assert got == want, (mode, start)
        assert sweep_fused.launches > launches


@pytest.mark.parametrize("name", ["trivial_broken.json", "nested_correct.json", "snapshot_broken.json"])
def test_card_solve_matches_cpu_solve(name, cuda_device):
    text = (FIXTURES / name).read_text()
    on_card = solve(text, backend="gpu-sweep", device=cuda_device)
    on_cpu = solve(text, backend="gpu-sweep", device="cpu")
    assert (on_card.intersects, on_card.q1, on_card.q2) == (on_cpu.intersects, on_cpu.q1, on_cpu.q2)
    assert on_card.stats.get("hit_index") == on_cpu.stats.get("hit_index")
    assert on_card.stats["device"] == "cuda"


def test_index_ceiling_raises_before_launch(cuda_device):
    _, q, d, local, mask, frozen, _, _ = _problems("9-broken")[0]
    fused = FusedSweep(q, np.asarray(local[1:], dtype=np.int32), mask, frozen, 1 << 8, d, cuda_device)
    launches = sweep_fused.launches
    with pytest.raises(KernelLimitError, match="2\\^31"):
        sweep_fused(fused, (1 << 31) - 8, 16)
    assert sweep_fused.launches == launches


@pytest.mark.parametrize("broken", [False, True])
def test_fused_kernel_over_256_units_matches_plain(broken, cuda_device):
    """A circuit with 390 units (a child mask of 8 words) on the fused kernel."""
    graph = build_graph(parse_fbas(synth.inner_set_ring_fbas(30, 12, broken=broken)))
    circuit = encode_circuit(graph)
    assert 256 < circuit.n_units <= 1024
    mask = np.ones(circuit.n, dtype=np.int32)
    lo_nodes = np.arange(1, circuit.n, dtype=np.int32)
    fused = FusedSweep(circuit, lo_nodes, mask, None, 1 << 12, device=cuda_device)
    plain = ref.SweepRef(circuit, lo_nodes, mask, None, 1 << 12, None, cuda_device)
    for start in (0, 1 << 20, (1 << 29) - (1 << 13)):
        assert int(fused.program(start, 2)) == int(plain.program(start, 2)), start


def _kofn(n, k, prefix):
    ks = [f"{prefix}{i}" for i in range(n)]
    return [{"publicKey": x, "name": x, "quorumSet": {"threshold": k, "validators": ks}} for x in ks]


def _packs():
    """Packs as the batch drive forms them: a mixed pack with hits, a
    depth-1 pack, and one job split over window groups."""
    backend = GpuSweepBackend(batch=256, device="cpu")

    def plan(datas):
        jobs = []
        for data in datas:
            graph = build_graph(parse_fbas(data))
            jobs.append(backend._prepare_job(graph, encode_circuit(graph), _problems_scc(graph), False))
        return backend.plan_pack(jobs)

    return {
        "mixed": plan([_kofn(8, 5, "A"), _kofn(8, 4, "B"), synth.hierarchical_fbas(3, 4, org_threshold=1),
                       synth.stellar_like_fbas(5, 3, n_watchers=20, seed=1, broken=True)]),
        "depth1": plan([synth.stellar_like_fbas(7, 3, seed=0), synth.stellar_like_fbas(5, 3, seed=1, broken=True)]),
        "split": plan([_kofn(20, 10, "S")]),
    }


def _problems_scc(graph):
    count, comp = tarjan_scc(graph.n, graph.succ)
    return next(m for m in group_sccs(graph.n, comp, count)
                if max_quorum(graph, m, [v in set(m) for v in range(graph.n)]))


@pytest.mark.parametrize("engine", ["dense", "bitset"])
def test_packed_kernels_match_plain_on_card(engine, cuda_device):
    launch = packed_sweep_dense if engine == "dense" else packed_sweep_bitset
    hits = 0
    for name, plan in _packs().items():
        p = plan.packed
        sweep = PackedSweep(p.circuit, p.circuit_d, *plan.tables, 1 << 10, engine=engine, device=cuda_device)
        plain = PackedRef(p.circuit, p.circuit_d, *plan.tables, 1 << 10, engine, cuda_device)
        los = np.asarray([g.lo for g in plan.groups], dtype=np.int64)
        before = launch.launches
        for starts in (los, los + 4096):
            got = sweep.program(starts, 3).cpu().numpy()
            want = plain.program(starts, 3).cpu().numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)
            hits += int((want < ref.INT32_MAX).sum())
        assert launch.launches == before + 2
    assert hits > 0


def _odd_packs():
    """A pack with vote counts up to 3 (a validator listed three times in
    every quorum set), a 1024-unit nested pack, and a densely nested
    1024-unit pack whose byte tables the dense kernel streams."""
    multi = _kofn(10, 6, "M")
    for node in multi:
        node["quorumSet"]["validators"] = [multi[0]["publicKey"]] * 2 + node["quorumSet"]["validators"]
    out = {}
    for name, datas, windows in (("multi-plane", [multi, _kofn(8, 4, "B")], 1),
                                 ("1024-units", [synth.inner_set_ring_fbas(30, 12)], 2)):
        members = []
        for data in datas:
            graph = build_graph(parse_fbas(data))
            members.append(restrict_circuit_pair(encode_circuit(graph), _problems_scc(graph)))
        out[name] = pack_circuits(members * windows)
    out["dense-1024"] = pack_circuits([(dense_child_circuit(), None)])
    return out


@pytest.mark.parametrize("engine", ["dense", "bitset"])
def test_packed_kernels_match_plain_on_multi_plane_streamed_and_ragged(engine, cuda_device):
    launch = packed_sweep_dense if engine == "dense" else packed_sweep_bitset
    packs = _odd_packs()
    assert packs["multi-plane"].circuit.members.max() > 1
    assert packs["1024-units"].circuit.n_units == packs["dense-1024"].circuit.n_units == 1024
    compared = 0
    for name, p in packs.items():
        if engine == "bitset" and not bitset_supported(p.circuit):
            continue
        tables = p.decode_tables()
        # 1000 rows a block: the last tile of each program is ragged.
        sweep = PackedSweep(p.circuit, p.circuit_d, *tables, 1000, engine=engine, device=cuda_device)
        assert sweep.tables.stream == (name == "dense-1024" and engine == "dense")
        plain = PackedRef(p.circuit, p.circuit_d, *tables, 1000, engine, cuda_device)
        before = launch.launches
        for starts in ([0] * p.groups, [(1 << (s - 1)) // 3 for s in p.sizes]):
            got = sweep.program(np.asarray(starts), 2).cpu().numpy()
            want = plain.program(np.asarray(starts), 2).cpu().numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert launch.launches == before + 2
        compared += 1
    assert compared >= 1


@pytest.mark.parametrize("name", ["multi-plane", "1024-units", "dense-1024", "dense-1024, thresholds 1/2"])
def test_dense_kernel_is_stable_over_repeated_launches(name, cuda_device):
    """A fault in how a block's warps share shared memory (the streamed
    instance's ring of table blocks above all) is intermittent: 16 launches
    of 2 x 1000 rows over the two start vectors above, the plain version
    recomputed beside each."""
    if name.endswith("1/2"):
        p = pack_circuits([(dense_child_circuit(quorum=(1, 2)), None)])
    else:
        p = _odd_packs()[name]
    tables = p.decode_tables()
    sweep = PackedSweep(p.circuit, p.circuit_d, *tables, 1000, engine="dense", device=cuda_device)
    assert sweep.tables.stream == name.startswith("dense-1024")
    plain = PackedRef(p.circuit, p.circuit_d, *tables, 1000, "dense", cuda_device)
    windows = ([0] * p.groups, [(1 << (s - 1)) // 3 for s in p.sizes])
    for i in range(16):
        starts = np.asarray(windows[i % 2])
        got = sweep.program(starts, 2).cpu().numpy()
        np.testing.assert_array_equal(got, plain.program(starts, 2).cpu().numpy(), err_msg=f"launch {i}")


@pytest.mark.parametrize("engine", [None, "bitset"])
def test_card_check_many_matches_cpu(engine, cuda_device):
    sources = [_kofn(8, 5, "A"), _kofn(8, 4, "B"), synth.hierarchical_fbas(3, 3, broken=True),
               synth.stellar_like_fbas(5, 3, n_watchers=20, seed=0),
               synth.stellar_like_fbas(5, 3, n_watchers=20, seed=1, broken=True),
               json.loads((FIXTURES / "nested_correct.json").read_text())]
    on_card = check_many(sources, backend=GpuSweepBackend(device=cuda_device, engine=engine))
    on_cpu = check_many(sources, backend=GpuSweepBackend(device="cpu", engine=engine))
    for a, b in zip(on_card, on_cpu):
        assert (a.intersects, a.q1, a.q2) == (b.intersects, b.q1, b.q2)
        assert a.stats.get("hit_index") == b.stats.get("hit_index")
        assert a.stats.get("pack_engine") == b.stats.get("pack_engine")


def test_packed_index_ceiling_raises_before_launch(cuda_device):
    plan = _packs()["split"]
    p = plan.packed
    sweep = PackedSweep(p.circuit, p.circuit_d, *plan.tables, 1 << 8, device=cuda_device)
    before = packed_sweep_dense.launches
    with pytest.raises(KernelLimitError, match="2\\^31"):
        packed_sweep_dense(sweep, [(1 << 31) - 8] * p.groups, 16)
    assert packed_sweep_dense.launches == before


def _guard_circuits():
    """``(label, circuit)``: the scoped circuits the planner guards, and
    a 390-unit one."""
    out = []
    for label, data in (("ndc6", synth.near_disjoint_cores(6, 1)),
                        ("ndc6-broken", synth.near_disjoint_cores(6, 1, broken=True)),
                        ("ndc12", synth.near_disjoint_cores(12, 1)),
                        ("snapshot", json.loads((FIXTURES / "snapshot_correct.json").read_text())),
                        ("ring", synth.inner_set_ring_fbas(30, 12))):
        graph = build_graph(parse_fbas(data))
        scc = _problems_scc(graph)
        whole = encode_circuit(graph)
        circuit = restrict_circuit_pair(whole, scc)[0] if whole.n > len(scc) else whole
        out.append((label, circuit))
    return out


@pytest.mark.parametrize("encoding", ["dense", "bitset"])
def test_guard_kernels_match_plain_on_card(encoding, cuda_device):
    launch = guard_dense if encoding == "dense" else guard_bitset
    rng = np.random.default_rng(11)
    zeros = nonzeros = 0
    for label, circuit in _guard_circuits():
        if encoding == "bitset" and not bitset_supported(circuit):
            continue
        masks = (rng.random((3000, circuit.n)) < rng.random((3000, 1))).astype(np.int8)
        masks[:, 0] = 0
        guard = BlockGuard(circuit, encoding, cuda_device)
        before = launch.launches
        got = guard.counts(masks)
        want = guard_counts(circuit, masks, encoding, cuda_device).cpu().numpy()
        np.testing.assert_array_equal(got, want, err_msg=label)
        assert launch.launches == before + 1 and got.shape == (3000,)
        zeros += int((want == 0).sum())
        nonzeros += int((want > 0).sum())
    assert zeros > 0 and nonzeros > 0


def test_pruned_paths_on_card_match_cpu(cuda_device):
    data = synth.near_disjoint_cores(6, 1)
    for src in (data, synth.near_disjoint_cores(6, 1, broken=True)):
        on_card = solve(src, backend=GpuSweepBackend(prune=True, device=cuda_device))
        on_cpu = solve(src, backend=GpuSweepBackend(prune=True, device="cpu"))
        assert (on_card.intersects, on_card.q1, on_card.q2) == (on_cpu.intersects, on_cpu.q1, on_cpu.q2)
        for key in ("hit_index", "cert", "candidates_checked"):
            assert on_card.stats.get(key) == on_cpu.stats.get(key), key
        assert "pruned_blocks" in on_card.stats["cert"]
    sources = [data, synth.near_disjoint_cores(6, 1, seed=1), synth.near_disjoint_cores(6, 1, broken=True)]
    before = guard_bitset.launches
    on_card = check_many(sources, backend=GpuSweepBackend(prune=True, engine="bitset", device=cuda_device))
    on_cpu = check_many(sources, backend=GpuSweepBackend(prune=True, engine="bitset", device="cpu"))
    assert guard_bitset.launches == before + 3
    for a, b in zip(on_card, on_cpu):
        assert (a.intersects, a.q1, a.q2) == (b.intersects, b.q1, b.q2)
        for key in ("hit_index", "cert", "pack_rows_dispatched", "candidates_checked"):
            assert a.stats.get(key) == b.stats.get(key), key


def test_guard_limits_raise_before_launch(cuda_device):
    """What the guard still refuses (more than 64 nodes, in both encodings)
    raises before any launch; a 1240-unit circuit, which the guard refused
    while it took at most 1024 units, is taken and matches the plain
    version, on both instances."""
    wide = encode_circuit(build_graph(parse_fbas(synth.majority_fbas(70))))
    before = guard_dense.launches, guard_bitset.launches
    for encoding in ("dense", "bitset"):
        with pytest.raises(KernelLimitError, match="at most 64"):
            BlockGuard(wide, encoding, cuda_device)
    assert (guard_dense.launches, guard_bitset.launches) == before
    many = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(40, 30))))
    assert many.n_units > 1024
    rng = np.random.default_rng(3)
    masks = (rng.random((3000, many.n)) < rng.random((3000, 1))).astype(np.int8)
    want = guard_counts(many, masks, "dense", cuda_device).cpu().numpy()
    for stream in (False, True):
        got = BlockGuard(many, "dense", cuda_device, stream=stream).counts(masks)
        bad = np.nonzero(got != want)[0]
        assert not bad.size, f"stream={stream}: rows {bad[:8].tolist()} got {got[bad[:8]].tolist()} " \
                             f"want {want[bad[:8]].tolist()}"
    assert guard_dense.launches == before[0] + 2
    assert (want == 0).any() and (want > 0).any()


def _warp_cases():
    """The new fused kernel's shapes: (label, Q, D, local, scc mask, frozen,
    lo_bits, hi rows, starts)."""
    out = []
    for broken in (False, True):
        q, d, local, mask, frozen = _sweep_problem(synth.benchmark_fbas(256, 34, broken=broken))
        out.append((f"full width broken={broken}", q, d, local, mask, frozen, 30, [0, 5],
                    [0, (1 << 29) + 12345]))
    q, d, local, mask, frozen = _sweep_problem((FIXTURES / "snapshot_broken.json").read_text())
    out.append(("snapshot_broken", q, d, local, mask, frozen, len(local) - 1, [0], [0, 300, (1 << 20) - 4096]))
    me = encode_circuit(build_graph(parse_fbas(_multi_edge_data())))
    out.append(("multi-edge", me, None, list(range(me.n)), np.ones(me.n, dtype=np.int32), None,
                me.n - 1, [0], [0]))
    for broken in (False, True):
        big = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(40, 30, broken=broken))))
        out.append((f"ring(40,30) broken={broken}, {big.n_units} units", big, None, list(range(big.n)),
                    np.ones(big.n, dtype=np.int32), None, 30, [0, 77], [0, (1 << 29) - 3000]))
    return out


def _sweep_problem(text):
    graph = build_graph(parse_fbas(text))
    scc = _problems_scc(graph)
    whole = encode_circuit(graph)
    if whole.n > len(scc):
        q, d = restrict_circuit_pair(whole, scc)
        return q, d, list(range(len(scc))), np.ones(len(scc), dtype=np.int32), None
    mask = np.zeros(whole.n, dtype=np.int32)
    mask[scc] = 1
    return whole, None, list(scc), mask, None


def _multi_edge_data():
    data = _kofn(8, 4, "M")
    for node in data:
        node["quorumSet"]["validators"] = [data[0]["publicKey"]] + node["quorumSet"]["validators"]
    return data


@pytest.mark.parametrize("stream", [False, True])
def test_warp_fused_kernel_matches_plain_on_both_instances(stream, cuda_device):
    """Both instances of the fused kernel (resident, streamed) against the
    plain version at the main path's shapes, multi-edge votes and above
    1024 units; 6000-row programs (a ragged last warp).  A failure names
    the case, the hi row, the start and both results."""
    hits = 0
    for label, q, d, local, mask, frozen, lo_bits, his, starts in _warp_cases():
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        fused = FusedSweep(q, lo_nodes, mask, frozen, 3000, d, cuda_device, stream=stream)
        plain = ref.SweepRef(q, lo_nodes, mask, frozen, 3000, d, cuda_device)
        assert fused.tables.stream is stream
        for hi in his:
            hi_row = np.zeros(q.n, dtype=np.int32)
            for j, v in enumerate(local[1 + lo_bits:]):
                hi_row[v] = (hi >> j) & 1
            for start in starts:
                got = int(fused.program(start, 2, mask_bits(hi_row)))
                want = int(plain.program(start, 2, hi_row if hi_row.any() else None))
                assert got == want, f"{label} stream={stream} hi={hi} start={start}: kernel {got} plain {want}"
                hits += want != ref.INT32_MAX
    assert hits > 0


def _early_ring(n, per):
    """``inner_set_ring_fbas(n, per, broken=True)`` with node 1 also a
    quorum on its own: a hit at index 1."""
    data = synth.inner_set_ring_fbas(n, per, broken=True)
    data[1]["quorumSet"]["threshold"] = 1
    data[1]["quorumSet"]["innerQuorumSets"][0]["threshold"] = 1
    return data


def test_check_many_decides_jobs_past_the_packed_unit_limit(cuda_device):
    """Jobs whose JAX window split passes the packed kernels' 1024 units:
    ``check_many`` on the card plans packs the kernels take and gives the
    verdicts and hit indices of the port's own ``solve`` on the card."""
    sources = [synth.inner_set_ring_fbas(24, 12), synth.inner_set_ring_fbas(24, 12, broken=True),
               _early_ring(30, 12)]
    for engine in (None, "bitset"):
        backend = GpuSweepBackend(engine=engine, device=cuda_device)
        got = check_many(sources, backend=backend)
        assert backend.pack_plans and all(p.packed.circuit.n_units <= 1024 for p in backend.pack_plans)
        for src, r in zip(sources, got):
            solo = solve(src, backend="gpu-sweep", device=cuda_device)
            assert (r.intersects, r.q1, r.q2, r.stats.get("hit_index")) == (
                solo.intersects, solo.q1, solo.q2, solo.stats.get("hit_index")), engine
        assert not got[2].intersects and got[2].stats["hit_index"] == 1


def _checker():
    """``tools/check_cert.py`` loaded by path (it imports only the standard
    library)."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "check_cert.py"
    spec = importlib.util.spec_from_file_location("check_cert", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("race", [True, False])
def test_auto_on_card_matches_gpu_sweep_and_certifies(race, cuda_device):
    """The auto router on the card, race on and off, on the fixtures and a
    2^30 twin pair: the verdicts of ``gpu-sweep`` on the card, witnesses
    that are two disjoint quorums, and certificates the checker accepts."""
    from quorum_intersection_tpu_torch.backends.auto import AutoBackend
    from quorum_intersection_tpu_torch.fbas.semantics import is_quorum

    check = _checker()
    sources = [json.loads((FIXTURES / name).read_text()) for name in
               ("trivial_correct.json", "trivial_broken.json", "nested_correct.json", "nested_broken.json",
                "snapshot_correct.json", "snapshot_broken.json")]
    sources += [synth.benchmark_fbas(256, 31, broken=b) for b in (False, True)]
    for src in sources:
        got = solve(src, backend=AutoBackend(race=race, device=cuda_device))
        want = solve(src, backend="gpu-sweep", device=cuda_device)
        assert got.intersects is want.intersects
        if got.q1 is not None:
            graph = build_graph(parse_fbas(src))
            assert is_quorum(graph, got.q1) and is_quorum(graph, got.q2) and not set(got.q1) & set(got.q2)
        for res in (got, want):
            assert check.check_certificate(res.cert, src)


# ---- K12: the PageRank power loop -------------------------------------------


def _pagerank_both(graph, device, m=0.0001, conv=0.0001, max_iterations=100000):
    """``(kernel, plain)`` results of the same CSR on the card, each as
    ``(rank, iterations, last_diff)``."""
    from quorum_intersection_tpu_torch.analytics.pagerank import in_edge_csr
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import pagerank_power
    from quorum_intersection_tpu_torch.kernels.pagerank_ref import power_loop

    csr = [torch.from_numpy(a).to(device) for a in in_edge_csr(graph)]
    got = pagerank_power(*csr, m, conv, max_iterations)
    torch.cuda.synchronize()
    want = power_loop(*csr, m, conv, max_iterations)
    if int(got[1]) != int(want[1]) and _iterations_agree(got, want, conv):
        # One apart at the stop test's edge: the plain version forced to the
        # kernel's count, so the ranks compare after the same iterations.
        want = power_loop(*csr, m, -1.0, int(got[1]))
    return ([got[0].cpu().numpy(), int(got[1]), float(got[2])],
            [want[0].cpu().numpy(), int(want[1]), float(want[2])])


def _iterations_agree(got, want, conv) -> bool:
    """Equal, or one apart where the stop test sat on the edge."""
    if int(got[1]) == int(want[1]):
        return True
    return abs(int(got[1]) - int(want[1])) == 1 and abs(min(float(got[2]), float(want[2])) - conv) <= 1e-3 * conv


@pytest.mark.parametrize("case", ["parallel-edges", "self-loop", "dangling", "cycle5", "caps", "20k"])
def test_pagerank_kernel_matches_plain_on_card(case, cuda_device):
    """Each rank within rtol 1e-3 and atol 1e-3 * m / n of the plain
    version's, and within the JAX tolerance
    (``_torch_pagerank_graphs.assert_ranks_close``): a rule that refuses the
    planted faults on the 20k graph."""
    from _torch_pagerank_graphs import ITERATION_CAPS, QUIRK_GRAPHS, assert_ranks_close, planted_faults

    from quorum_intersection_tpu_torch.analytics.pagerank import in_edge_csr, pagerank_np
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import pagerank_power

    runs = []
    if case == "caps":
        runs = [(QUIRK_GRAPHS[name], m, cap) for name, m, cap in ITERATION_CAPS]
    elif case == "20k":
        runs = [(synth.stellar_like_fbas(n_watchers=20_000, seed=3), 0.0001, 100000)]
    else:
        # Periodic graphs: they run to the cap (1000 iterations).
        runs = [(QUIRK_GRAPHS[case], 0.0001, 1000)]
    before = pagerank_power.launches
    for data, m, cap in runs:
        graph = build_graph(parse_fbas(data))
        got, want = _pagerank_both(graph, cuda_device, m=m, max_iterations=cap)
        assert got[1] == want[1], (got[1:], want[1:])
        assert_ranks_close(got[0], want[0], m)
        if cap == 0:
            assert got[1] == 0 and got[0][0] == 1.0 and not got[0][1:].any()
        if case == "20k":
            assert_ranks_close(got[0], pagerank_np(graph, m=m), m)
            for fault in planted_faults(got[0], in_edge_csr(graph)[0]).values():
                with pytest.raises(AssertionError):
                    assert_ranks_close(fault, want[0], m)
    assert pagerank_power.launches - before == len(runs)


def test_pagerank_kernel_forced_iterations_match_plain(cuda_device):
    """A convergence threshold no diff can pass: both run exactly the cap,
    with the kernel's one barrier an iteration exercised 60 times."""
    from _torch_pagerank_graphs import assert_ranks_close

    graph = build_graph(parse_fbas(synth.stellar_like_fbas(n_watchers=3000, seed=5)))
    got, want = _pagerank_both(graph, cuda_device, m=0.15, conv=-1.0, max_iterations=60)
    assert got[1] == want[1] == 60
    assert_ranks_close(got[0], want[0], 0.15)


def _pagerank_model_bits(graph, got, m, conv, max_iterations, device) -> bool:
    """Whether the kernel's ``got`` is the CPU model's result bit for bit
    (``tests/_torch_pagerank_schedule.py``, at the wrapper's launch shape)."""
    from _torch_pagerank_schedule import schedule

    from quorum_intersection_tpu_torch.analytics.pagerank import in_edge_csr
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import device_limits, launch_shape

    shape = launch_shape(graph.n, graph.n_edges, *device_limits(device))
    rank, iterations, diff = schedule(*in_edge_csr(graph), m, conv, max_iterations, shape.grid, shape.seg)
    return (rank.tobytes() == np.asarray(got[0]).tobytes() and iterations == got[1]
            and np.float32(diff) == np.float32(got[2]))


def test_pagerank_kernel_heavy_row_on_card(cuda_device):
    """A hub row of 50 003 in-edges (segments finished by the last one's
    warp) beside rows of 0-3: NumPy's iteration count exactly, ranks within
    the tolerance of the plain version's after as many iterations and of
    NumPy's, and the CPU model's bits.

    The count is NumPy's, not the plain version's: the plain version adds the
    hub row's 50 003 terms one by one in float32 (in CSR order on the CPU, by
    atomics on the card), which puts its diff at 1.000e-4 give or take 4e-9
    at iterations 15-17, on the stop test's edge, where a float64 sum gives
    1.219e-4, 6.10e-5 and 3.05e-5.  NumPy's model (``pagerank_np``, the JAX
    package's line for line) sums each row in float64 and stops after 16,
    as the kernel does."""
    from _torch_pagerank_graphs import assert_ranks_close, heavy_row_fbas

    from quorum_intersection_tpu_torch.analytics.pagerank import in_edge_csr, pagerank_np
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import pagerank_power
    from quorum_intersection_tpu_torch.kernels.pagerank_ref import power_loop

    graph = build_graph(parse_fbas(heavy_row_fbas(50_000)))
    csr = [torch.from_numpy(a).to(cuda_device) for a in in_edge_csr(graph)]
    rank, iterations, diff = pagerank_power(*csr, 0.0001, 0.0001, 100000)
    got = (rank.cpu().numpy(), int(iterations), float(diff))
    want = pagerank_np(graph)
    assert np.array_equal(pagerank_np(graph, max_iterations=got[1]), want)
    assert not np.array_equal(pagerank_np(graph, max_iterations=got[1] - 1), want)
    assert_ranks_close(got[0], power_loop(*csr, 0.0001, -1.0, got[1])[0].cpu().numpy())
    assert_ranks_close(got[0], want)
    assert _pagerank_model_bits(graph, got, 0.0001, 0.0001, 100000, cuda_device)


@pytest.mark.parametrize("case", ["quirks", "caps", "20k", "forced"])
def test_pagerank_kernel_matches_schedule_model_on_card(case, cuda_device):
    """The kernel's result is the CPU model of its schedule, bit for bit:
    rank, iteration count and last diff."""
    from _torch_pagerank_graphs import ITERATION_CAPS, QUIRK_GRAPHS

    from quorum_intersection_tpu_torch.analytics.pagerank import in_edge_csr
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import pagerank_power

    if case == "quirks":
        runs = [(QUIRK_GRAPHS[name], 0.0001, 0.0001, 1000) for name in QUIRK_GRAPHS]
    elif case == "caps":
        runs = [(QUIRK_GRAPHS[name], m, 0.0001, cap) for name, m, cap in ITERATION_CAPS]
    elif case == "20k":
        runs = [(synth.stellar_like_fbas(n_watchers=20_000, seed=3), 0.0001, 0.0001, 100000)]
    else:
        runs = [(synth.stellar_like_fbas(n_watchers=3000, seed=5), 0.15, -1.0, 60)]
    for data, m, conv, cap in runs:
        graph = build_graph(parse_fbas(data))
        csr = [torch.from_numpy(a).to(cuda_device) for a in in_edge_csr(graph)]
        rank, iterations, diff = pagerank_power(*csr, m, conv, cap)
        got = (rank.cpu().numpy(), int(iterations), float(diff))
        assert _pagerank_model_bits(graph, got, m, conv, cap, cuda_device), (data[:1], m, cap)


def test_pagerank_kernel_is_deterministic_on_card(cuda_device):
    """Two launches give the same bits: the heavy rows' tickets decide who
    adds a row's segment sums, never the order."""
    from _torch_pagerank_graphs import heavy_row_fbas

    from quorum_intersection_tpu_torch.analytics.pagerank import in_edge_csr
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import pagerank_power

    for data in (heavy_row_fbas(50_000), synth.stellar_like_fbas(n_watchers=20_000, seed=3)):
        graph = build_graph(parse_fbas(data))
        csr = [torch.from_numpy(a).to(cuda_device) for a in in_edge_csr(graph)]
        first = [t.clone() for t in pagerank_power(*csr, 0.0001, 0.0001, 100000)]
        second = pagerank_power(*csr, 0.0001, 0.0001, 100000)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_pagerank_call_is_one_kernel_under_the_profiler(cuda_device):
    """A wrapper call on an uploaded CSR is the K12 launch alone: no other
    kernel and no host-to-device copy under ``torch.profiler``."""
    from quorum_intersection_tpu_torch.analytics.pagerank import in_edge_csr
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import pagerank_power

    graph = build_graph(parse_fbas(synth.stellar_like_fbas(n_watchers=20_000, seed=3)))
    csr = [torch.from_numpy(a).to(cuda_device) for a in in_edge_csr(graph)]
    pagerank_power(*csr, 0.0001, 0.0001, 100000)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        pagerank_power(*csr, 0.0001, 0.0001, 100000)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) > 0]
    assert names and all("pagerank_kernel" in k for k in names), names
    assert not any("HtoD" in e.key for e in prof.key_averages())


def test_pagerank_limits_raise_before_launch(cuda_device):
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import check_limits, pagerank_power

    before = pagerank_power.launches
    with pytest.raises(KernelLimitError, match="CSR entries"):
        check_limits(10, (1 << 31) - 5)
    with pytest.raises(KernelLimitError, match="vertices"):
        check_limits((1 << 31) - 1, 0)
    row_ptr = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        pagerank_power(row_ptr.long(), row_ptr[:0], torch.zeros(2, device=cuda_device), 0.0001, 0.0001, 5)
    assert pagerank_power.launches == before


def test_pagerank_auto_routes_on_card(cuda_device, monkeypatch):
    """The committed floor (None on the H100: a fresh process's kernel route
    lost at every measured size) sends both graphs to NumPy with no launch;
    a floor at the larger graph's edges sends it to the kernel on the card
    the floor was measured on."""
    import dataclasses

    from _torch_pagerank_graphs import assert_ranks_close

    from quorum_intersection_tpu_torch.analytics.pagerank import pagerank_auto, pagerank_np
    from quorum_intersection_tpu_torch.backends import calibration
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import pagerank_power

    small = build_graph(parse_fbas(json.loads((FIXTURES / "snapshot_correct.json").read_text())))
    big = build_graph(parse_fbas(synth.stellar_like_fbas(n_watchers=2800, n_null=150, n_dangling=40, seed=7)))
    floor = calibration.H100.pagerank_min_edges
    before = pagerank_power.launches
    for graph in (small, big):
        if floor is None or graph.n_edges < floor:
            ranks, engine = pagerank_auto(graph)
            assert engine == "numpy" and pagerank_power.launches == before
            np.testing.assert_array_equal(ranks, pagerank_np(graph))
    monkeypatch.setattr(calibration, "H100", dataclasses.replace(calibration.H100, pagerank_min_edges=big.n_edges))
    assert pagerank_auto(small)[1] == "numpy" and pagerank_power.launches == before
    ranks, engine = pagerank_auto(big)
    if torch.cuda.get_device_name(cuda_device) == calibration.H100_KIND:
        assert engine == "cuda" and pagerank_power.launches == before + 1
        assert_ranks_close(ranks, pagerank_np(big))
    else:
        assert engine == "numpy" and pagerank_power.launches == before


# ---- the frontier: K9 (the chunk loop) and K10 (the flag filter) -----------

FRONTIER_CASES = {
    "majority-14": (lambda: synth.majority_fbas(14), 8192, 256),
    "majority-14-broken": (lambda: synth.majority_fbas(14, broken=True), 8192, 256),
    "hier-5x3": (lambda: synth.hierarchical_fbas(5, 3), 8192, 256),
    "hier-4x3-spill": (lambda: synth.hierarchical_fbas(4, 3), 64, 16),
    "random-14": (lambda: synth.random_fbas(14, seed=2, nested_prob=0.3, null_prob=0.1), 8192, 256),
    "bench-64-restricted": (lambda: synth.benchmark_fbas(64, 14, seed=1), 4096, 128),
    # Past 32 lanes (the kernels' upper state word), at the default constants.
    "stellar-16x3-broken": (lambda: synth.stellar_like_fbas(16, 3, broken=True), 1 << 18, 2048),
    "stellar-21x3-broken": (lambda: synth.stellar_like_fbas(21, 3, broken=True), 1 << 18, 2048),
    "stellar-16x3": (lambda: synth.stellar_like_fbas(16, 3), 1 << 18, 2048),
    "hier-8x4": (lambda: synth.hierarchical_fbas(8, 4), 1 << 18, 2048),
    # Wide SCCs whose in-degrees differ from lane to lane (the argmax decides).
    "random-48-slice-12": (lambda: synth.random_fbas(48, seed=0, slice_size=12), 1 << 18, 2048),
    "random-64": (lambda: synth.random_fbas(64, seed=0), 1 << 18, 2048),
    # Past 64 lanes, states of two words (the kernels' W = 2 instances):
    # 66 lanes (padded to 96), 90 (96; its whole search is out of reach, so
    # chunk-level only), 126 (128, 192 units), and 96 and 128 lanes of
    # differing in-degrees.
    "stellar-22x3-broken": (lambda: synth.stellar_like_fbas(22, 3, broken=True), 1 << 18, 2048),
    "stellar-42x3-broken": (lambda: synth.stellar_like_fbas(42, 3, broken=True), 1 << 18, 2048),
    "stellar-30x3": (lambda: synth.stellar_like_fbas(30, 3), 1 << 18, 2048),
    "random-96": (lambda: synth.random_fbas(96, seed=0), 1 << 18, 2048),
    "random-128": (lambda: synth.random_fbas(128, seed=0), 1 << 18, 2048),
    # Past 128 lanes, states of three and four words over the evaluator's
    # two node k-slabs (the W = 3 and W = 4 instances): 129 and 180 lanes
    # (padded to 192), 255 (256, 384 units), and 191 and 255 lanes of
    # differing in-degrees.
    "stellar-43x3-broken": (lambda: synth.stellar_like_fbas(43, 3, broken=True), 1 << 18, 2048),
    "stellar-60x3-broken": (lambda: synth.stellar_like_fbas(60, 3, broken=True), 1 << 18, 2048),
    "stellar-85x3-broken": (lambda: synth.stellar_like_fbas(85, 3, broken=True), 1 << 18, 2048),
    "random-192": (lambda: synth.random_fbas(192, seed=0), 1 << 18, 2048),
    "random-256": (lambda: synth.random_fbas(256, seed=0), 1 << 18, 2048),
}
WIDE_FRONTIER_CASES = ("stellar-22x3-broken", "stellar-42x3-broken", "stellar-30x3", "random-96", "random-128")
WIDER_FRONTIER_CASES = ("stellar-43x3-broken", "stellar-60x3-broken", "stellar-85x3-broken", "random-192",
                        "random-256")


def _frontier_setup(data, device, arena, pop, stream=None, chunk_iters=512):
    from quorum_intersection_tpu_torch.backends.frontier import FLAG_EXIT, FLAG_EXIT_GROWTH, frontier_problem
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import FrontierKernels, FrontierRef
    from quorum_intersection_tpu_torch.kernels.frontier_ref import ChunkShape

    graph = build_graph(parse_fbas(data))
    count, comp = tarjan_scc(graph.n, graph.succ)
    bearing = [m for m in group_sccs(graph.n, comp, count) if max_quorum(graph, m, [v in m for v in range(graph.n)])]
    scc = bearing[0]
    prob = frontier_problem(graph, encode_circuit(graph), scc)
    pop = min(pop, arena // 4)
    shape = ChunkShape(half=prob.half, K=pop, C=arena, chunk_iters=chunk_iters,
                       flag_cap=FLAG_EXIT * FLAG_EXIT_GROWTH + pop)
    args = (prob.circuit, prob.scc_dev, prob.a_scc, shape, prob.probe_circuit, prob.frozen)
    return prob, shape, FrontierKernels(*args, device=device, stream=stream), FrontierRef(*args, device=device)


def _frontier_lockstep(prob, shape, kern, plain, chunks, flag_exit=512, reasons=None):
    """Both versions chunk for chunk from the seed state, each chunk's
    arena rows [0, top), counters, flags and flag filter held equal; the
    host's spill applied alike; each chunk's exit reason appended to
    ``reasons``.  Returns the chunks compared."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import frontier_chunk, frontier_filter

    sets = [[kern.arena(), kern.arena()], [kern.arena(), kern.arena()]]
    for side in sets:
        side[0].T[0, : prob.s] = 1
        side[0].ctr.copy_(torch.tensor([1, 0, 0, 0], dtype=torch.int32))
    src = 0
    for c in range(chunks):
        frontier_chunk(kern, sets[0][src], sets[0][1 - src], flag_exit)
        plain.chunk(sets[1][src], sets[1][1 - src], flag_exit)
        got, want = sets[0][1 - src], sets[1][1 - src]
        torch.cuda.synchronize()
        assert got.ctr.tolist() == want.ctr.tolist(), (c, got.ctr.tolist(), want.ctr.tolist())
        if reasons is not None:
            reasons.append(exit_reason(got.ctr.tolist(), shape, flag_exit))
        top, fcount = want.ctr.tolist()[:2]
        assert torch.equal(got.T[:top], want.T[:top]) and torch.equal(got.D[:top], want.D[:top]), c
        assert torch.equal(got.flags[:fcount], want.flags[:fcount]), c
        if fcount:
            assert frontier_filter(kern, got.flags, fcount).tolist() == plain.filter(want.flags, fcount).tolist(), c
        if top == 0:
            return c + 1
        if top > shape.C - 2 * shape.K:
            keep = top - shape.C // 2
            for st in (got, want):
                st.T[:keep] = st.T[shape.C // 2: top].clone()
                st.D[:keep] = st.D[shape.C // 2: top].clone()
                st.ctr[0] = keep
        src = 1 - src
    return chunks


@pytest.mark.parametrize("case", sorted(FRONTIER_CASES))
def test_frontier_kernels_match_plain_on_card(case, cuda_device):
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import LAUNCHES

    make, arena, pop = FRONTIER_CASES[case]
    prob, shape, kern, plain = _frontier_setup(make(), cuda_device, arena, pop)
    before = LAUNCHES["frontier_chunk"]
    chunks = _frontier_lockstep(prob, shape, kern, plain, chunks=6 if prob.s <= 32 else 3)
    assert LAUNCHES["frontier_chunk"] == before + chunks


def test_frontier_kernels_streamed_instance_matches_plain(cuda_device):
    prob, shape, kern, plain = _frontier_setup(synth.hierarchical_fbas(5, 3), cuda_device, 8192, 256, stream=True)
    assert kern.tables.stream
    _frontier_lockstep(prob, shape, kern, plain, chunks=3)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", WIDE_FRONTIER_CASES)
def test_frontier_wide_kernels_match_plain_on_both_instances(case, stream, cuda_device):
    """K9 and K10 at two words a state (65-128 lanes) against their plain
    versions on the resident and the streamed instance, chunk for chunk."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import LAUNCHES

    make, arena, pop = FRONTIER_CASES[case]
    prob, shape, kern, plain = _frontier_setup(make(), cuda_device, arena, pop, stream=stream)
    assert 64 < prob.s_dev <= 128 and kern.tables.stream is stream
    before = LAUNCHES["frontier_chunk"]
    chunks = _frontier_lockstep(prob, shape, kern, plain, chunks=2)
    assert LAUNCHES["frontier_chunk"] == before + chunks


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", WIDER_FRONTIER_CASES)
def test_frontier_wider_kernels_match_plain_on_both_instances(case, stream, cuda_device):
    """K9 and K10 at three and four words a state (129-256 lanes, two node
    k-slabs) against their plain versions on the resident and the streamed
    instance, chunk for chunk."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import LAUNCHES

    make, arena, pop = FRONTIER_CASES[case]
    prob, shape, kern, plain = _frontier_setup(make(), cuda_device, arena, pop, stream=stream)
    assert 128 < prob.s_dev <= 256 and kern.tables.stream is stream
    before = LAUNCHES["frontier_chunk"]
    chunks = _frontier_lockstep(prob, shape, kern, plain, chunks=2)
    assert LAUNCHES["frontier_chunk"] == before + chunks


# (source, arena, pop, chunks, chunk_iters): between them every exit of the
# chunk loop (empty stack, chunk_iters, flag_exit, the overflow guard).
FRONTIER_EXIT_CASES = (
    (lambda: synth.hierarchical_fbas(5, 3), 8192, 256, 8, 512),
    (lambda: synth.hierarchical_fbas(5, 3), 8192, 256, 4, 3),
    (lambda: synth.hierarchical_fbas(4, 3), 64, 16, 8, 512),
)


@pytest.mark.parametrize("stream", [False, True])
def test_frontier_chunk_leaves_by_every_exit_on_both_instances(stream, cuda_device):
    """K9 equals its plain version on chunks that end by each of the loop's
    four exits, on the resident and the streamed instance."""
    reasons = []
    for make, arena, pop, chunks, chunk_iters in FRONTIER_EXIT_CASES:
        prob, shape, kern, plain = _frontier_setup(make(), cuda_device, arena, pop, stream=stream,
                                                   chunk_iters=chunk_iters)
        assert kern.tables.stream is stream
        _frontier_lockstep(prob, shape, kern, plain, chunks=chunks, reasons=reasons)
    assert set(reasons) == set(EXIT_REASONS), reasons


@pytest.mark.parametrize("case", ["stellar-16x3-broken", "stellar-21x3-broken", "hier-8x4", "random-48-slice-12",
                                  "random-64", *WIDE_FRONTIER_CASES, *WIDER_FRONTIER_CASES])
def test_frontier_filter_on_sets_over_16_members(case, cuda_device):
    """K10 against its plain version on sets of more than 16 members, no
    multiple of 16, so that a set's leave-one-out rows span tiles."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import frontier_filter

    make, arena, pop = FRONTIER_CASES[case]
    prob, shape, kern, plain = _frontier_setup(make(), cuda_device, arena, pop)
    block = wide_flag_block(prob, plain)
    sizes = block.sum(-1)
    assert (sizes > 16).all() and (sizes % 16 != 0).all()
    assert frontier_filter(kern, block, len(block)).tolist() == plain.filter(block, len(block)).tolist()


@pytest.mark.parametrize("case,kw", [
    ("hier-5x3", {"arena": 8192, "pop": 256}),
    ("hier-4x3-spill", {"arena": 64, "pop": 16}),
    ("stellar-4x3-broken", {"arena": 8192, "pop": 256}),
    ("majority-18", {}),
    ("stellar-16x3-broken", {"arena": 8192, "pop": 256}),
    ("stellar-21x3-broken", {"arena": 8192, "pop": 256}),
    ("stellar-22x3-broken", {"arena": 8192, "pop": 256}),
    ("stellar-42x3-broken", {"arena": 8192, "pop": 256}),
    ("stellar-43x3-broken", {"arena": 8192, "pop": 256}),
    ("stellar-60x3-broken", {"arena": 8192, "pop": 256}),
    ("stellar-85x3-broken", {"arena": 8192, "pop": 256}),
    # pad_shapes=False: 15, 66 and 132 lanes, off a multiple of 8.
    ("hier-5x3", {"arena": 8192, "pop": 256, "pad_shapes": False}),
    ("stellar-22x3-broken", {"arena": 8192, "pop": 256, "pad_shapes": False}),
    ("stellar-44x3-broken", {"arena": 8192, "pop": 256, "pad_shapes": False}),
])
def test_frontier_solve_on_card_matches_cpu(case, kw, cuda_device):
    from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import LAUNCHES

    data = {"hier-5x3": lambda: synth.hierarchical_fbas(5, 3),
            "hier-4x3-spill": lambda: synth.hierarchical_fbas(4, 3),
            "stellar-4x3-broken": lambda: synth.stellar_like_fbas(4, 3, n_watchers=10, broken=True),
            "majority-18": lambda: synth.majority_fbas(18),
            "stellar-16x3-broken": lambda: synth.stellar_like_fbas(16, 3, broken=True),
            "stellar-21x3-broken": lambda: synth.stellar_like_fbas(21, 3, broken=True),
            "stellar-22x3-broken": lambda: synth.stellar_like_fbas(22, 3, broken=True),
            "stellar-42x3-broken": lambda: synth.stellar_like_fbas(42, 3, broken=True),
            "stellar-43x3-broken": lambda: synth.stellar_like_fbas(43, 3, broken=True),
            "stellar-44x3-broken": lambda: synth.stellar_like_fbas(44, 3, broken=True),
            "stellar-60x3-broken": lambda: synth.stellar_like_fbas(60, 3, broken=True),
            "stellar-85x3-broken": lambda: synth.stellar_like_fbas(85, 3, broken=True)}[case]()
    before = LAUNCHES["frontier_chunk"]
    on_card = solve(data, backend=GpuFrontierBackend(device=cuda_device, **kw))
    on_cpu = solve(data, backend=GpuFrontierBackend(device="cpu", flag_check="device", **kw))
    assert LAUNCHES["frontier_chunk"] > before
    assert (on_card.intersects, on_card.q1, on_card.q2) == (on_cpu.intersects, on_cpu.q1, on_cpu.q2)
    for key in ("device_iters", "device_chunks", "states_popped", "flagged", "minimal_quorums", "host_checks",
                "device_flag_checks", "spills", "discarded_chunks", "padded_shape"):
        assert on_card.stats.get(key) == on_cpu.stats.get(key), key
    assert on_card.stats["device"] == "cuda"


def test_frontier_limits_raise_before_launch(cuda_device):
    """More than 256 lanes, or more than MAX_POP pops, raise before a launch."""
    from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import LAUNCHES, MAX_POP

    before = dict(LAUNCHES)
    with pytest.raises(KernelLimitError, match="at most 256"):
        solve(synth.majority_fbas(257), backend=GpuFrontierBackend(device=cuda_device))
    with pytest.raises(KernelLimitError, match="lanes 257"):
        solve(synth.majority_fbas(257), backend=GpuFrontierBackend(device=cuda_device, pad_shapes=False))
    with pytest.raises(KernelLimitError, match="pop"):
        solve(synth.majority_fbas(9), backend=GpuFrontierBackend(device=cuda_device, arena=1 << 16,
                                                                  pop=MAX_POP + 8))
    assert LAUNCHES == before


def test_frontier_refused_witness_candidate_fails_the_solve(cuda_device, monkeypatch):
    """A K10 witness candidate that the exact host check refuses fails the
    solve on the card: no host re-check of the block takes its place."""
    from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
    from quorum_intersection_tpu_torch.kernels import frontier_cuda

    real = frontier_cuda.frontier_filter

    def nominate(kern, flags_blk, count):
        out = real(kern, flags_blk, count)
        out[1] = 0
        return out

    monkeypatch.setattr(frontier_cuda, "frontier_filter", nominate)
    with pytest.raises(RuntimeError, match="exact host check refuses"):
        solve(synth.hierarchical_fbas(4, 3), backend=GpuFrontierBackend(device=cuda_device, arena=8192, pop=256))


# ---- K9's iteration instance: the frontier under a mesh ----------------------

MESH_FRONTIER_CASES = {
    "hier-5x3": (lambda: synth.hierarchical_fbas(5, 3), 8192, 256, 6),
    "hier-4x3-spill": (lambda: synth.hierarchical_fbas(4, 3), 64, 16, 8),
    "hier-8x4": (lambda: synth.hierarchical_fbas(8, 4), 1 << 18, 2048, 3),
    "random-64": (lambda: synth.random_fbas(64, seed=0), 1 << 18, 2048, 3),
    # Two words a state.
    "stellar-42x3-broken": (lambda: synth.stellar_like_fbas(42, 3, broken=True), 1 << 18, 2048, 2),
    "stellar-30x3": (lambda: synth.stellar_like_fbas(30, 3), 1 << 18, 2048, 2),
    "random-128": (lambda: synth.random_fbas(128, seed=0), 1 << 18, 2048, 2),
    # Three and four words a state, two node k-slabs.
    "stellar-60x3-broken": (lambda: synth.stellar_like_fbas(60, 3, broken=True), 1 << 18, 2048, 2),
    "stellar-85x3-broken": (lambda: synth.stellar_like_fbas(85, 3, broken=True), 1 << 18, 2048, 2),
}


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(MESH_FRONTIER_CASES))
def test_frontier_iteration_matches_plain_rank_by_rank(case, ranks, cuda_device):
    """The iteration instance and its plain version over a mesh of ranks of
    one card, chunk for chunk: every rank's counters, arena rows and flags
    equal, and the launches counted."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import LAUNCHES

    from _torch_frontier_blocks import mesh_lockstep

    make, arena, pop, chunks = MESH_FRONTIER_CASES[case]
    prob, shape, kern, plain = _frontier_setup(make(), cuda_device, arena, pop)
    before = LAUNCHES["frontier_iteration"]
    done, iters, flags, steps, bad, _, _ = mesh_lockstep(prob, shape, kern, plain, ranks, chunks)
    assert not bad, bad[:3]
    assert iters > 1 and LAUNCHES["frontier_iteration"] - before == steps * ranks >= done * ranks


def test_frontier_mesh_solve_on_card_matches_single_card(cuda_device):
    """A 4-rank mesh of the one card against K9's single-card solve at the
    same pop: verdict, witness and counts; only the mesh-chunk instance ran,
    one launch a dispatched chunk."""
    from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import LAUNCHES
    from quorum_intersection_tpu_torch.parallel import candidate_mesh

    mesh = candidate_mesh(devices=[cuda_device] * 4)
    for data in (synth.hierarchical_fbas(5, 3), synth.majority_fbas(14, broken=True),
                 synth.stellar_like_fbas(42, 3, broken=True), synth.stellar_like_fbas(85, 3, broken=True)):
        want = solve(data, backend=GpuFrontierBackend(device=cuda_device, arena=8192, pop=256))
        before = dict(LAUNCHES)
        got = solve(data, backend=GpuFrontierBackend(arena=8192, pop=256, mesh=mesh))
        assert (got.intersects, got.q1, got.q2) == (want.intersects, want.q1, want.q2)
        for key in ("device_iters", "device_chunks", "states_popped", "flagged", "minimal_quorums", "spills"):
            assert got.stats[key] == want.stats[key], key
        assert LAUNCHES["frontier_chunk"] == before["frontier_chunk"]
        assert LAUNCHES["frontier_iteration"] == before["frontier_iteration"]
        assert LAUNCHES["frontier_mesh_chunk"] - before["frontier_mesh_chunk"] == \
            got.stats["device_chunks"] + got.stats["discarded_chunks"] == got.stats["mesh"]["chunk_launches"]
        assert got.stats["mesh"]["instance"] == "chunk"


def test_frontier_iteration_limits_raise_before_launch(cuda_device):
    """Under a mesh, more than 256 lanes raise before a launch, as K9's
    limits do, padded or not; so does a pop that does not split over the
    ranks."""
    from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import LAUNCHES, IterationState, frontier_iteration
    from quorum_intersection_tpu_torch.parallel import candidate_mesh

    before = dict(LAUNCHES)
    mesh = candidate_mesh(devices=[cuda_device] * 2)
    with pytest.raises(KernelLimitError, match="at most 256"):
        solve(synth.majority_fbas(257), backend=GpuFrontierBackend(mesh=mesh))
    with pytest.raises(KernelLimitError, match="lanes 257"):
        solve(synth.majority_fbas(257), backend=GpuFrontierBackend(mesh=mesh, pad_shapes=False))
    prob, shape, kern, _ = _frontier_setup(synth.hierarchical_fbas(4, 3), cuda_device, 4096, 250)
    st = IterationState.empty(250, 2, kern.arena(), kern.arena())
    with pytest.raises(ValueError, match="does not split"):
        frontier_iteration(kern, st, 0, 3, 512)
    assert LAUNCHES == before


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(MESH_FRONTIER_CASES))
def test_frontier_mesh_chunk_matches_plain(case, ranks, cuda_device):
    """The mesh-chunk instance (one launch a chunk for every rank of the
    card) and its plain version ``mesh_chunk_ref``, chunk for chunk: the
    counters, arena rows, flags and stash equal, a launch a chunk counted."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import LAUNCHES

    from _torch_frontier_blocks import mesh_chunk_lockstep

    make, arena, pop, chunks = MESH_FRONTIER_CASES[case]
    prob, shape, kern, plain = _frontier_setup(make(), cuda_device, arena, pop)
    before = dict(LAUNCHES)
    done, iters, flags, launches, bad, _, _ = mesh_chunk_lockstep(prob, shape, kern, plain, ranks, chunks)
    assert not bad, bad[:3]
    assert iters > 1 and launches == done == LAUNCHES["frontier_mesh_chunk"] - before["frontier_mesh_chunk"]
    assert LAUNCHES["frontier_iteration"] == before["frontier_iteration"]


def test_frontier_mesh_chunk_limits_raise_before_launch(cuda_device, monkeypatch):
    """The mesh-chunk instance's limits raise before any launch: the stash
    slots a half, the shared memory of a block.  (A missing peer path is
    held in ``tests/test_torch_frontier_mesh.py`` through the library's
    answer, since a host whose cards reach each other cannot show it.)"""
    from quorum_intersection_tpu_torch.kernels import frontier_cuda
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import LAUNCHES, CardState, frontier_mesh_chunk

    before = dict(LAUNCHES)
    prob, shape, kern, _ = _frontier_setup(synth.hierarchical_fbas(4, 3), cuda_device, 1 << 15, 8192)
    st = CardState.empty(8192, 4096, range(4096), kern.arena(), kern.arena())
    with pytest.raises(KernelLimitError, match="stash slots"):
        frontier_mesh_chunk([kern], [st], 512)
    st = CardState.empty(8192, 4, range(4), kern.arena(), kern.arena())
    monkeypatch.setattr(frontier_cuda, "SMEM_LIMIT", 1024)
    with pytest.raises(KernelLimitError, match="shared memory"):
        frontier_mesh_chunk([kern], [st], 512)
    assert LAUNCHES == before and not st.dst.ctr.any() and not st.stash.any()


def test_frontier_mesh_chunk_spin_timeout_raises(cuda_device):
    """Two card states on the one card, launched one after the other on its
    stream: the first waits for the second's arrival, which cannot come
    while it runs, and leaves at its spin bound; the wrapper raises, naming
    the timeout, and nothing hangs."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import CardState, frontier_mesh_chunk, mesh_chunk_status

    prob, shape, kern, _ = _frontier_setup(synth.hierarchical_fbas(5, 3), cuda_device, 8192, 256)
    src = kern.arena()
    src.T[0, : prob.s] = 1
    src.ctr.copy_(torch.tensor([1, 0, 0, 0], dtype=torch.int32))
    states = [CardState.empty(256, 4, ranks, src, kern.arena()) for ranks in ((0, 1), (2, 3))]
    frontier_mesh_chunk([kern, kern], states, 512, spin_cycles=200_000)
    with pytest.raises(RuntimeError, match="spin timeout"):
        mesh_chunk_status(states)


def test_frontier_failed_gather_fails_the_solve(cuda_device):
    """A mesh naming a second process with no process group behind it: the
    first gather raises, and so does the solve."""
    from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
    from quorum_intersection_tpu_torch.parallel.mesh import CandidateMesh

    mesh = CandidateMesh(devices=(torch.device("cuda", torch.cuda.current_device()),) * 2, process_count=2)
    with pytest.raises((RuntimeError, ValueError)):
        solve(synth.hierarchical_fbas(4, 3), backend=GpuFrontierBackend(arena=4096, pop=256, mesh=mesh))


# ---- the unpacked bitset sweep (K8) ----------------------------------------


def _bitset_cases():
    from _torch_bitset_cases import card_problems

    return card_problems()


@pytest.mark.parametrize("instance", ["lanes", "resident", "streamed"])
def test_bitset_kernel_matches_plain_on_both_instances(instance, cuda_device):
    """K8 against its plain version on every card problem, the instance
    forced: the lane instance where it takes the circuit (at most 128
    units), the warp instance resident where its tables fit one block,
    streamed everywhere."""
    from quorum_intersection_tpu_torch.kernels.bitset_sweep_cuda import BitsetSweep, bitset_sweep
    from quorum_intersection_tpu_torch.kernels.bitset_sweep_ref import BitsetSweepRef

    hits = ran = 0
    for prob, lo_bits, his, starts, batch, steps in _bitset_cases():
        try:
            kern = BitsetSweep(prob.circuit, prob.decode(lo_bits)[0], prob.scc_mask, prob.frozen, batch,
                               prob.circuit_d, cuda_device, instance=instance)
        except KernelLimitError:
            assert instance != "streamed"  # the streamed warp instance takes every circuit
            assert instance != "lanes" or prob.circuit.n_units > 128
            continue
        ran += 1
        plain = BitsetSweepRef(prob.circuit, prob.decode(lo_bits)[0], prob.scc_mask, prob.frozen, batch,
                               prob.circuit_d, cuda_device)
        for hi in his:
            _, hi_row = prob.decode(lo_bits, hi)
            for start in starts:
                launches = bitset_sweep.launches
                got = int(kern.program(start, steps, mask_bits(hi_row)))
                assert bitset_sweep.launches == launches + 1
                want = int(plain.program(start, steps, hi_row if hi_row.any() else None))
                assert got == want, (prob.label, instance, hi, start)
                hits += want != ref.INT32_MAX
    assert hits > 0 and ran >= 10


def test_bitset_kernel_limits_raise_before_launch(cuda_device):
    """n = 65 and indices past 2^31 raise before a launch; the tables'
    shared memory is the kernel's own count."""
    from quorum_intersection_tpu_torch.encode.circuit import Circuit
    from quorum_intersection_tpu_torch.kernels import bitset_sweep_cuda as bk

    n = 65
    wide = Circuit(n=n, n_units=n, depth=0, thresholds=np.full(n, 33, dtype=np.int32),
                   members=np.ones((n, n), dtype=np.uint8), child=np.zeros((n, n), dtype=np.uint8),
                   unit_depth=np.zeros(n, dtype=np.int32))
    launches = bk.bitset_sweep.launches
    with pytest.raises(KernelLimitError, match="64"):
        bk.BitsetSweep(wide, np.arange(1, 20, dtype=np.int32), np.ones(n, dtype=np.int32), None, 256,
                       device=cuda_device)
    prob = _bitset_cases()[0][0]
    kern = bk.BitsetSweep(prob.circuit, prob.decode(20)[0], prob.scc_mask, prob.frozen, 256, prob.circuit_d,
                          cuda_device)
    with pytest.raises(KernelLimitError, match="2\\^31"):
        bk.bitset_sweep(kern, (1 << 31) - 8, 16)
    assert bk.bitset_sweep.launches == launches
    t = kern.tables
    lib = bk._library()
    for resident in (True, False):
        assert lib.qi_bitset_sweep_smem(t.units_pad, t.n_words, int(resident), t.warps) == \
            bk.smem_bytes(t.units_pad, t.n_words, resident, t.warps)
    assert t.instance == "lanes"
    for n_units, cw in ((t.lanes.n_units, t.lanes.cw), (100, 4), (34, 0)):
        assert lib.qi_bitset_lanes_smem(n_units, cw) == bk.lane_smem_bytes(n_units, cw)


@pytest.mark.parametrize("instance", ["lanes", "resident"])
def test_bitset_kernel_is_bit_identical_over_repeated_launches(instance, cuda_device):
    """21 launches of the same windows (a hit among them) give one answer,
    on the lane instance and the warp instance."""
    from quorum_intersection_tpu_torch.kernels.bitset_sweep_cuda import BitsetSweep

    prob = next(c[0] for c in _bitset_cases() if c[0].label.startswith("sparse_giant(400,broken=True)"))
    kern = BitsetSweep(prob.circuit, prob.decode(23)[0], prob.scc_mask, prob.frozen, 1 << 14,
                       prob.circuit_d, cuda_device, instance=instance)
    for start in (0, 1 << 20):
        first = [int(kern.program(start, 4)) for _ in range(21)]
        assert len(set(first)) == 1, (start, first)


@pytest.mark.parametrize("name", ["snapshot_broken.json", "nested_correct.json"])
def test_bitset_engine_solve_on_card_matches_cpu(name, cuda_device, monkeypatch):
    """QI_SWEEP_ENGINE=bitset through solve on the card: K8 launched, the
    CPU path's verdict, witness and hit index, the bitset stamp."""
    from quorum_intersection_tpu_torch.kernels.bitset_sweep_cuda import bitset_sweep

    monkeypatch.setenv("QI_SWEEP_ENGINE", "bitset")
    text = (FIXTURES / name).read_text()
    launches = bitset_sweep.launches
    on_card = solve(text, backend="gpu-sweep", device=cuda_device)
    assert bitset_sweep.launches > launches
    on_cpu = solve(text, backend="gpu-sweep", device="cpu")
    assert (on_card.intersects, on_card.q1, on_card.q2) == (on_cpu.intersects, on_cpu.q1, on_cpu.q2)
    assert on_card.stats.get("hit_index") == on_cpu.stats.get("hit_index")
    assert on_card.stats["encoding"] == "bitset" and on_card.cert["provenance"]["encoding"] == "bitset"


@pytest.fixture
def fault_plan():
    """Install a ``QI_FAULTS``-style plan for one test, on a fresh run record."""
    from quorum_intersection_tpu_torch.utils import faults, telemetry

    telemetry.reset_run_record()
    yield lambda spec: faults.install_plan(faults.parse_faults(spec))
    faults.clear_plan()
    telemetry.reset_run_record()


@pytest.mark.parametrize("spec,options", [
    ("sweep.bitset=error", {"engine": "bitset"}),
    ("sweep.prune=error", {"prune": True}),
    ("sweep.dispatch=oom", {}),
    ("sweep.window=preempt", {}),
])
def test_sweep_fault_fails_the_card_solve(spec, options, cuda_device, fault_plan):
    """A fired sweep point fails the solve on the card with the injected
    exception: no degrade to the unpruned or dense encoding."""
    from quorum_intersection_tpu_torch.utils.faults import FaultInjected

    plan = fault_plan(spec)
    with pytest.raises(FaultInjected) as exc:
        solve((FIXTURES / "snapshot_correct.json").read_text(),
              backend=GpuSweepBackend(device=cuda_device, **options))
    assert exc.value.point == spec.split("=")[0] and plan.fired


def test_frontier_chunk_fault_fails_the_card_solve(cuda_device, fault_plan):
    from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
    from quorum_intersection_tpu_torch.utils.faults import FaultInjected

    fault_plan("frontier.chunk=oom")
    with pytest.raises(FaultInjected, match="frontier.chunk"):
        solve(synth.hierarchical_fbas(5, 3), backend=GpuFrontierBackend(device=cuda_device))


@pytest.mark.parametrize("spec", ["sweep.pack=error", "sweep.dispatch=oom", "sweep.compile=error"])
def test_sweep_fault_under_auto_card_rung_fails(spec, cuda_device, fault_plan):
    from quorum_intersection_tpu_torch.backends.auto import AutoBackend
    from quorum_intersection_tpu_torch.utils.faults import FaultInjected

    fault_plan(spec)
    with pytest.raises(FaultInjected):
        check_many([synth.majority_fbas(7), synth.majority_fbas(9)], backend=AutoBackend(device=cuda_device, pack=True))


def test_full_width_windows_enumerated(cuda_device):
    """The full-width correct twin's counters: cert.windows_enumerated is the
    2^33-window space less the windows the plan pruned (the wide decode is
    not pruned: none), and the sweep.window events' candidates sum to it."""
    from quorum_intersection_tpu_torch.utils import telemetry

    rec = telemetry.reset_run_record()
    try:
        res = solve(synth.benchmark_fbas(256, 34), backend=GpuSweepBackend(device=cuda_device, prune=True))
    finally:
        telemetry.reset_run_record()
    assert res.intersects is True
    pruned = rec.counters.get("cert.windows_pruned_guard", 0)
    assert res.stats["cert"]["window_space"] == 1 << 33
    assert rec.counters["cert.windows_enumerated"] == (1 << 33) - pruned == res.stats["candidates_checked"]
    windows = [ev["attrs"]["candidates"] for ev in rec.events if ev["name"] == "sweep.window"]
    assert sum(windows) == rec.counters["cert.windows_enumerated"] == rec.counters["sweep.candidates_checked"]


def _delta_steps(device):
    """A 6-step churn of a broken 10-node majority core through one
    ``DeltaEngine`` under gpu-sweep on ``device``, one snapshot a call."""
    from quorum_intersection_tpu_torch.delta import DeltaEngine, SccVerdictStore

    trace = synth.churn_trace(synth.benchmark_fbas(40, 10, broken=True, seed=1), 6, seed=0)
    engine = DeltaEngine(SccVerdictStore(256), device=device)
    return [engine.check_many([snap], backend="gpu-sweep")[0] for snap in trace]


def test_delta_churn_on_card_equals_cpu(cuda_device, fault_plan):
    """Step for step: verdict, witness, hit index and the provenance.delta
    stamp equal between the card and the CPU; the core re-solves at least
    once and some step composes."""
    fault_plan("")  # a fresh run record, no rules
    on_card = _delta_steps(None)
    on_cpu = _delta_steps("cpu")
    for a, b in zip(on_card, on_cpu):
        assert (a.intersects, a.q1, a.q2) == (b.intersects, b.q1, b.q2)
        assert a.stats.get("hit_index") == b.stats.get("hit_index")
        assert a.cert["provenance"]["delta"] == b.cert["provenance"]["delta"]
    stamps = [r.cert["provenance"]["delta"] for r in on_card]
    assert sum(s["resolved_sccs"] for s in stamps) >= 2 and sum(s["reused_sccs"] for s in stamps) >= 1


def test_delta_sweep_fault_fails_the_card_solve(cuda_device, fault_plan):
    """A sweep.dispatch fault inside the incremental solve on the card fails
    the call: the engine does not degrade it into a second solve."""
    from quorum_intersection_tpu_torch.delta import DeltaEngine
    from quorum_intersection_tpu_torch.utils import telemetry
    from quorum_intersection_tpu_torch.utils.faults import FaultInjected

    plan = fault_plan("sweep.dispatch=error")
    with pytest.raises(FaultInjected) as exc:
        DeltaEngine().check_many([synth.benchmark_fbas(40, 10, broken=True, seed=1)], backend="gpu-sweep")
    assert exc.value.point == "sweep.dispatch" and len(plan.fired) == 1
    assert telemetry.get_run_record().counters.get("delta.errors", 0) == 0


def _serve_stream(device, sources, fuse_window_ms, deadlines=None):
    """Serve ``sources`` through one ServeEngine on ``device``, every request
    admitted before the drain starts; the outcomes (response or exception)."""
    from quorum_intersection_tpu_torch.serve import ServeEngine

    engine = ServeEngine(backend="gpu-sweep", fuse_window_ms=fuse_window_ms, device=device)
    deadlines = deadlines or [None] * len(sources)
    tickets = [engine.submit(s, request_id=f"r{i}", deadline_s=d, client=f"c{i % 2}")
               for i, (s, d) in enumerate(zip(sources, deadlines))]
    engine.start()
    out = []
    try:
        for t in tickets:
            try:
                out.append(t.result(timeout=120.0))
            except Exception as exc:  # noqa: BLE001 - the typed outcome is what is compared
                out.append(exc)
    finally:
        engine.stop(drain=True, timeout=60.0)
    return out


def test_fused_serve_on_card_equals_unfused(cuda_device, fault_plan):
    """Cross-request packs on the card: the fused server answers each request
    as the unfused one and the CPU do (verdict, witness, hit index), forms a
    pack of several requests, and its costs sum to the pack totals."""
    from quorum_intersection_tpu_torch.utils import telemetry

    sources = [synth.majority_fbas(n, broken=n % 2 == 0, prefix=f"F{n}") for n in (9, 10, 11, 12)]
    fault_plan("")
    fused = _serve_stream(None, sources, 50.0)
    counters = dict(telemetry.get_run_record().counters)
    unfused = _serve_stream(None, sources, 0.0)
    on_cpu = _serve_stream("cpu", sources, 50.0)
    for a, b, c in zip(fused, unfused, on_cpu):
        assert (a.intersects, a.stats.get("hit_index")) == (b.intersects, b.stats.get("hit_index"))
        assert (a.intersects, a.stats.get("hit_index")) == (c.intersects, c.stats.get("hit_index"))
        assert a.cert.get("witness") == b.cert.get("witness") == c.cert.get("witness")
    assert counters["fuse.packs_formed"] >= 1 and counters["fuse.cross_request_lanes"] > 0
    assert counters["cost.lane_windows_attributed"] == counters["cost.lane_windows_total"]
    assert sum(int(r.cost["lane_windows"]) for r in fused) == counters["cost.lane_windows_total"]


def test_mid_pack_deadline_on_card_retires_only_its_request(cuda_device, fault_plan):
    """A deadline that fires inside a fused pack on the card: that request
    gets a typed deadline error with its partial ledger; its co-packed
    request a full verdict."""
    from quorum_intersection_tpu_torch.serve import DeadlineExceeded

    fault_plan("")
    # 2^30 windows in one lane group, about 0.5 s of K3; 48 nodes, so that the
    # batch former's lane estimate (by node count) leaves room for the others.
    slow = synth.benchmark_fbas(48, 31)
    fast = [synth.majority_fbas(n, prefix=f"M{n}") for n in (9, 10, 11)]  # the pack's other three groups
    check_many([synth.majority_fbas(7)], backend="gpu-sweep")  # the context and the kernels come up first
    dead, *live = _serve_stream(None, [slow] + fast, 200.0, deadlines=[0.25, None, None, None])
    assert [r.intersects for r in live] == [True, True, True]
    assert all(not r.stats.get("cancelled") and r.stats["pack_jobs"] == 4 for r in live)
    assert isinstance(dead, DeadlineExceeded) and dead.cert["partial"] is True
    cov = dead.cert["coverage"]
    assert (cov["windows_enumerated"] + cov["windows_pruned_guard"] + cov["windows_skipped_pack_fill"]
            + cov["windows_cancelled"]) == cov["window_space"]
    assert 0 < cov["windows_cancelled"] < cov["window_space"]  # retired inside its pack


def test_local_worker_fleet_on_card_equals_check_many(cuda_device, fault_plan, tmp_path):
    """Two in-process workers on the card under ``gpu-sweep``: the fleet's
    verdicts, witnesses and hit indices are ``check_many``'s on the card, and
    every certificate passes the unmodified checker."""
    from quorum_intersection_tpu_torch.fleet import FleetEngine

    fault_plan("")
    names = ["trivial_correct.json", "trivial_broken.json", "nested_correct.json", "nested_broken.json",
             "snapshot_correct.json", "snapshot_broken.json"]
    sources = [_data(name) for name in names] + [synth.benchmark_fbas(48, 20, broken=True, seed=2)]
    want = check_many(sources, backend="gpu-sweep")
    fleet = FleetEngine(2, backend="gpu-sweep", worker_mode="local", journal_dir=tmp_path / "fleet",
                        probe_interval_s=30.0, respawn_max=0)
    fleet.start()
    try:
        assert fleet.worker_ids() == ["w0", "w1"] and fleet.device == "cuda"
        got = [fleet.submit(src).result(timeout=300.0) for src in sources]
    finally:
        fleet.stop(drain=True, timeout=60.0)
    checker = _checker()
    for src, g, w in zip(sources, got, want):
        assert (g.intersects, g.stats.get("hit_index")) == (w.intersects, w.stats.get("hit_index"))
        assert g.cert.get("witness") == w.cert.get("witness")
        if g.stats.get("reason") != "scc_guard":  # decided on the host before any search
            assert str(g.stats.get("device", "")).startswith("cuda")
        checker.check_certificate(g.cert, src)


def test_proc_worker_fleet_on_card_survives_sigkill(cuda_device, fault_plan, tmp_path):
    """Two ``serve --device cuda`` worker processes; one is SIGKILLed with
    requests in flight: every ticket resolves once, with ``check_many``'s
    verdict, and the dead worker is evicted."""
    from quorum_intersection_tpu_torch.fleet import FleetEngine
    from quorum_intersection_tpu_torch.utils import telemetry

    fault_plan("")
    trace = synth.churn_trace(synth.majority_fbas(11, prefix="CK"), 6, seed=4)
    want = [r.intersects for r in check_many(trace, backend="gpu-sweep")]
    fleet = FleetEngine(2, backend="gpu-sweep", worker_mode="subprocess", journal_dir=tmp_path / "proc",
                        probe_interval_s=0.2, respawn_max=0)
    fleet.start()
    try:
        assert fleet.worker_ids() == ["w0", "w1"]
        tickets = [fleet.submit(s) for s in trace[:5]]
        fleet.kill_worker("w0")
        tickets += [fleet.submit(s) for s in trace[5:]]
        got = [t.result(timeout=300.0).intersects for t in tickets]
        counters = dict(telemetry.get_run_record().counters)
    finally:
        fleet.stop(drain=True, timeout=60.0)
    assert got == want
    assert counters["fleet.evictions"] == 1 and counters.get("fleet.errors", 0) == 0


def test_profiled_gpu_sweep_solve_traces_k1(cuda_device, fault_plan, tmp_path):
    """``profile_trace`` around a full-width ``gpu-sweep`` solve: the Chrome
    trace holds K1's kernel events and the run's ``qi-trace`` range."""
    from quorum_intersection_tpu_torch.utils import telemetry
    from quorum_intersection_tpu_torch.utils.profiling import profile_trace, trace_file

    fault_plan("")
    src = synth.benchmark_fbas(256, 30)
    solve(src, backend="gpu-sweep")  # the kernel built and loaded first
    with profile_trace(str(tmp_path), cuda_device):
        res = solve(src, backend="gpu-sweep")
    assert res.intersects is True
    trace_id = telemetry.get_run_record().trace_id
    names = [ev.get("name", "") for ev in json.loads(trace_file(str(tmp_path), trace_id).read_text())["traceEvents"]]
    assert sum("sweep_kernel" in name for name in names) >= 1
    assert f"qi-trace:{trace_id}" in names


_BUILD_PROBE = """
import json
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record
seconds = build.timed_build(build.SOURCES)
counters = get_run_record().counters
print(json.dumps({"seconds": seconds, "hits": counters.get("compile_cache.hits", 0),
                  "misses": counters.get("compile_cache.misses", 0)}))
"""


def test_warm_build_takes_at_most_a_tenth_of_a_cold_private_build(cuda_device):
    """The port's counterpart of ``tests/test_warm_start.py``: a process with
    ``QI_NO_COMPILE_CACHE=1`` builds every kernel into a private directory;
    a later process with the cache finds them all and takes at most 10% of
    the cold build's seconds."""
    import os
    import subprocess
    import sys

    from quorum_intersection_tpu_torch.kernels import build

    root = pathlib.Path(__file__).resolve().parent.parent
    build.build_all()  # the cached libraries exist before the warm process

    def probe(**env):
        proc = subprocess.run([sys.executable, "-c", _BUILD_PROBE], cwd=root, capture_output=True, text=True,
                              timeout=900, env={**os.environ, **env})
        assert proc.returncode == 0, proc.stderr
        return json.loads(proc.stdout.strip().splitlines()[-1])

    cold = probe(QI_NO_COMPILE_CACHE="1")
    warm = probe()
    assert (cold["misses"], cold["hits"]) == (len(build.SOURCES), 0)
    assert (warm["misses"], warm["hits"]) == (0, len(build.SOURCES))
    assert warm["seconds"] <= 0.1 * cold["seconds"], (warm, cold)


def test_native_scan_agrees_with_a_card_solve(cuda_device, fault_plan):
    """The dump solved on the card (its scan the Python loop) and the native
    scan of the same SCCs: the same quorum-bearing SCCs and quorums."""
    import gzip

    from quorum_intersection_tpu_torch.backends.cpp import native_scc_scan
    from quorum_intersection_tpu_torch.pipeline import scan_scc_quorums, solve_graph

    fault_plan("")
    text = gzip.decompress((FIXTURES / "dump_scale_correct.json.gz").read_bytes()).decode()
    graph = build_graph(parse_fbas(text))
    res = solve_graph(graph, backend="gpu-sweep")
    count, comp = tarjan_scc(graph.n, graph.succ)
    sccs = group_sccs(graph.n, comp, count)
    native = native_scc_scan(graph, sccs)
    assert native == scan_scc_quorums(graph, sccs)
    assert [sid for sid, q in enumerate(native) if q] == res.quorum_scc_ids
    assert res.intersects is True


# ---- the mesh sweep (K11) ----------------------------------------------------


def _mesh_sweep(devices, q, d, lo_nodes, mask, frozen, per_dev, stream=None):
    """K11 over ``devices`` (ranks; a card may repeat): the card layout's
    ``ShardedSweep``, one ``FusedSweep`` a distinct card."""
    from quorum_intersection_tpu_torch.backends.sweep import ShardedSweep
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import MeshSweep
    from quorum_intersection_tpu_torch.parallel import candidate_mesh

    mesh = candidate_mesh(devices=devices)
    cards = [FusedSweep(q, lo_nodes, mask, frozen, per_dev * mesh.devices.count(dev), circuit_d=d, device=dev,
                        stream=stream) for dev in dict.fromkeys(mesh.devices)]
    return ShardedSweep(mesh, per_dev, MeshSweep(cards))


def _mesh_matches(devices, case, device):
    """The mesh program on ``devices`` against its plain version (K1's plain
    contiguous program over the same coverage) and K1 itself, every
    problem of ``case``, both table instances, one launch a card and
    program."""
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import sweep_mesh

    ranks, cards = len(devices), len(set(devices))
    for mode, q, d, local, mask, frozen, lo_bits, hi in _problems(case):
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        hi_row = np.zeros(q.n, dtype=np.int32)
        for j, v in enumerate(local[1 + lo_bits:]):
            hi_row[v] = (hi >> j) & 1
        hi_arg = hi_row if hi_row.any() else None
        per_dev, steps = max(min(1 << 10, (1 << lo_bits) // (4 * ranks)), 1), 3
        base = per_dev * ranks
        contiguous = FusedSweep(q, lo_nodes, mask, frozen, base, circuit_d=d, device=device)
        plain = ref.SweepRef(q, lo_nodes, mask, frozen, base, d, device)
        for stream in (False, True):
            sharded = _mesh_sweep(devices, q, d, lo_nodes, mask, frozen, per_dev, stream)
            for start in sorted({0, base, (1 << lo_bits) // 2}):
                launches = sweep_mesh.launches
                got = int(sharded.program(start, steps, mask_bits(hi_row)))
                assert sweep_mesh.launches == launches + cards
                want = int(plain.program(start, steps, hi_arg))
                assert got == want == int(contiguous.program(start, steps, mask_bits(hi_row))), \
                    (mode, ranks, stream, start)


@pytest.mark.parametrize("case", ["nested_correct.json", "snapshot_broken.json", "9-broken", "10-correct"])
def test_mesh_instance_matches_plain_on_card(case, cuda_device):
    """1, 2, 4 and 8 ranks of the one card: one launch a program."""
    card = torch.device("cuda", torch.cuda.current_device())
    for ranks in (1, 2, 4, 8):
        _mesh_matches([card] * ranks, case, cuda_device)


@pytest.mark.parametrize("layout", ["cuda:0-3", "c0,c1,c0,c1"])
def test_mesh_instance_on_four_cards(layout, cuda_device):
    """Four cards (or two, each holding two ranks): every card's blocks
    take their minimum into the home card's slot across NVLink."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards of one host")
    cards = [torch.device("cuda", i) for i in range(4)]
    devices = cards if layout == "cuda:0-3" else [cards[0], cards[1]] * 2
    _mesh_matches(devices, "snapshot_broken.json", cards[0])


def test_mesh_limits_raise_before_launch(cuda_device, monkeypatch):
    """A range past 2^31, a share that names another card, and a card pair
    without peer access (the library's answer replaced) raise before any
    launch."""
    import types

    from quorum_intersection_tpu_torch.kernels import sweep_cuda
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import MeshSweep, sweep_mesh

    _, q, d, local, mask, frozen, _, _ = _problems("9-broken")[0]
    lo_nodes = np.asarray(local[1:], dtype=np.int32)
    card = torch.device("cuda", torch.cuda.current_device())
    sharded = _mesh_sweep([card] * 4, q, d, lo_nodes, mask, frozen, 1 << 6)
    launches = sweep_mesh.launches
    with pytest.raises(KernelLimitError, match="2\\^31 index ceiling"):
        sharded.program((1 << 31) - (1 << 8), 2)
    for share in ([(card, (1 << 31) - 64, 128)], [(card, 0, 0)]):
        with pytest.raises(KernelLimitError):
            sweep_mesh(sharded.cards, share)
    with pytest.raises(ValueError, match="one range a card"):
        sweep_mesh(sharded.cards, [(torch.device("cuda", card.index + 1), 0, 64)])
    real = sweep_cuda._library()

    class NoPeerPath:
        def __getattr__(self, name):
            return getattr(real, name)

        def qi_sweep_enable_peer(self, dev, peer):
            return sweep_cuda.CUDA_ERROR_PEER_ACCESS_UNSUPPORTED

    monkeypatch.setattr(sweep_cuda, "_library", NoPeerPath)
    other = torch.device("cuda", card.index + 1)  # a stand-in: the peer check comes first
    with pytest.raises(KernelLimitError, match="no peer access"):
        MeshSweep([sharded.cards.sweeps[0], types.SimpleNamespace(device=other)])
    assert sweep_mesh.launches == launches


@pytest.mark.parametrize("name", ["trivial_broken.json", "nested_correct.json", "snapshot_broken.json"])
def test_mesh_solve_on_card_matches_cpu_mesh(name, cuda_device):
    """Four ranks on the one card against four CPU ranks: the same verdict,
    witness, hit index and drive; K11 launched, K1 not."""
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import sweep_mesh
    from quorum_intersection_tpu_torch.parallel import candidate_mesh

    text = (FIXTURES / name).read_text()
    fused, sharded = sweep_fused.launches, sweep_mesh.launches
    on_card = solve(text, backend=GpuSweepBackend(batch=1 << 12, mesh=candidate_mesh(devices=[cuda_device] * 4)))
    card_fused = sweep_fused.launches - fused
    on_cpu = solve(text, backend=GpuSweepBackend(device="cpu", batch=1 << 12, mesh=candidate_mesh(4, device="cpu")))
    keys = ("hit_index", "candidates_checked", "device_steps")
    assert (on_card.intersects, on_card.q1, on_card.q2) == (on_cpu.intersects, on_cpu.q1, on_cpu.q2)
    assert [on_card.stats.get(k) for k in keys] == [on_cpu.stats.get(k) for k in keys]
    if "candidates_checked" in on_card.stats:
        assert sweep_mesh.launches > sharded and card_fused == 0
        assert on_card.stats["mesh"]["devices"] == "cuda:0 x4"


def test_failed_collective_fails_the_card_solve(cuda_device):
    """A mesh naming a second process with no process group behind it: the
    collective raises and the solve fails, with no verdict."""
    from quorum_intersection_tpu_torch.parallel.mesh import CandidateMesh

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = CandidateMesh(devices=(dev, dev), process_count=2)
    with pytest.raises((RuntimeError, ValueError)):
        solve(synth.majority_fbas(9), backend=GpuSweepBackend(batch=64, mesh=mesh))
