"""The CUDA kernels on the card — the fused unpacked sweep, the two
lane-packed sweeps and the two block-guard instances — against their plain
PyTorch versions and against the CPU path.  Card-only: every test takes the ``cuda_device``
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
    on_card, on_cpu = solve(text, device=cuda_device), solve(text, device="cpu")
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
        for key in ("hit_index", "pruned_blocks", "windows_pruned_guard", "candidates_checked"):
            assert on_card.stats.get(key) == on_cpu.stats.get(key), key
    sources = [data, synth.near_disjoint_cores(6, 1, seed=1), synth.near_disjoint_cores(6, 1, broken=True)]
    before = guard_bitset.launches
    on_card = check_many(sources, backend=GpuSweepBackend(prune=True, engine="bitset", device=cuda_device))
    on_cpu = check_many(sources, backend=GpuSweepBackend(prune=True, engine="bitset", device="cpu"))
    assert guard_bitset.launches == before + 3
    for a, b in zip(on_card, on_cpu):
        assert (a.intersects, a.q1, a.q2) == (b.intersects, b.q1, b.q2)
        for key in ("hit_index", "pruned_blocks", "pack_rows_dispatched", "candidates_checked"):
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
            solo = solve(src, device=cuda_device)
            assert (r.intersects, r.q1, r.q2, r.stats.get("hit_index")) == (
                solo.intersects, solo.q1, solo.q2, solo.stats.get("hit_index")), engine
        assert not got[2].intersects and got[2].stats["hit_index"] == 1
