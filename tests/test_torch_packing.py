"""The port's lane-packed batch path on the CPU against the JAX package.

- the packing and bitset encoders (``pad_targets``, ``pad_circuit``,
  ``plan_packs``, ``pack_circuits``, ``decode_tables``, ``bitset_encode``,
  ``pack_mask_words``) array for array;
- the plain packed program (``kernels/packed_ref.py``, dense and bitset)
  against the JAX XLA program K7 and the Pallas kernels K3 and K4 in
  interpret mode, per group;
- ``GpuSweepBackend.check_sccs`` against ``TpuSweepBackend.check_sccs`` and
  the port's ``check_many`` against the JAX ``check_many``, job for job;
- the fused kernel's unit limit (1024) and the packed wrappers' refusals.

Everything compared is an integer, a node list or a string: exact equality.
"""

import numpy as np
import pytest
import torch

import quorum_intersection_tpu.encode.circuit as jc
from quorum_intersection_tpu.backends.base import CancelToken as JaxCancelToken
from quorum_intersection_tpu.backends.base import SearchCancelled as JaxSearchCancelled
from quorum_intersection_tpu.backends.tpu import kernels as jk
from quorum_intersection_tpu.backends.tpu import pallas_sweep
from quorum_intersection_tpu.backends.tpu.sweep import TpuSweepBackend
from quorum_intersection_tpu.backends.tpu.sweep import resolve_engine as jax_resolve_engine
from quorum_intersection_tpu.fbas import synth as jax_synth
from quorum_intersection_tpu.pipeline import check_many as jax_check_many
import quorum_intersection_tpu_torch.encode.circuit as pc
from quorum_intersection_tpu_torch.backends.base import CancelToken, SearchCancelled
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend, resolve_engine
from quorum_intersection_tpu_torch.encode.circuit import encode_circuit, restrict_circuit_pair
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.kernels.packed_cuda import (
    MAX_UNITS,
    PackedSweep,
    group_decode,
    mma_tables,
    packed_sweep_bitset,
    packed_sweep_dense,
)
from quorum_intersection_tpu_torch.kernels.packed_ref import PackedRef
from quorum_intersection_tpu_torch.kernels.sweep_cuda import KernelLimitError, plane_tables
from quorum_intersection_tpu_torch.pipeline import check_many

from _torch_cases import assert_jobs_equal, fixture_data, jobs_of, kofn, multi_edge

torch.set_num_threads(1)
CPU = torch.device("cpu")


PAIRS = [
    (kofn(8, 5), kofn(8, 4)),
    (kofn(11, 6, "Q"), kofn(11, 5, "Q")),
    (synth.hierarchical_fbas(3, 3), synth.hierarchical_fbas(3, 4, org_threshold=1)),
]
PAIR_DATAS = [d for pair in PAIRS for d in pair]


def _same_circuit(a, b):
    assert (a.n, a.n_units, a.depth) == (b.n, b.n_units, b.depth)
    for f in ("thresholds", "members", "child", "unit_depth"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _members(jax_jobs, port_jobs, scope=False):
    jm = [(q, None if scope else d) for q, d in (jc.restrict_circuit_pair(c, s) for _, c, s in jax_jobs)]
    pm = [(q, None if scope else d) for q, d in (restrict_circuit_pair(c, s) for _, c, s in port_jobs)]
    return jm, pm


ENCODE_SETS = {
    "pairs": PAIR_DATAS,
    "bench": [jax_synth.benchmark_fbas(40, 8, seed=s, broken=s == 1) for s in range(3)]
    + [jax_synth.benchmark_fbas(48, 9, nested_watchers=True, seed=4)],
    "stellar": [jax_synth.stellar_like_fbas(5, 3, n_watchers=20, seed=s, broken=s == 1) for s in range(3)],
}


@pytest.mark.parametrize("name", sorted(ENCODE_SETS))
def test_pack_encoding_matches_jax(name):
    jax_jobs, port_jobs = jobs_of(ENCODE_SETS[name])
    jm, pm = _members(jax_jobs, port_jobs, scope=name == "bench")
    sizes = [q.n for q, _ in pm]
    assert pc.plan_packs(sizes) == jc.plan_packs(sizes)
    assert pc.plan_packs(sizes, lane_tile=32) == jc.plan_packs(sizes, lane_tile=32)
    for pack in pc.plan_packs(sizes) + [list(range(len(pm)))[:2]]:
        jp = jc.pack_circuits([jm[i] for i in pack])
        pp = pc.pack_circuits([pm[i] for i in pack])
        assert (pp.groups, pp.slot, pp.sizes, pp.fill_pct) == (jp.groups, jp.slot, jp.sizes, jp.fill_pct)
        _same_circuit(pp.circuit, jp.circuit)
        assert (pp.circuit_d is None) == (jp.circuit_d is None)
        if pp.circuit_d is not None:
            _same_circuit(pp.circuit_d, jp.circuit_d)
        for a, b in zip(pp.decode_tables(), jp.decode_tables()):
            np.testing.assert_array_equal(a, b)
        assert pc.bitset_supported(pp.circuit) == jc.bitset_supported(jp.circuit)
        if pc.bitset_supported(pp.circuit):
            pb, jb = pc.bitset_encode(pp.circuit), jc.bitset_encode(jp.circuit)
            for f in ("n", "n_units", "depth", "words", "unit_words"):
                assert getattr(pb, f) == getattr(jb, f), f
            for f in ("thresholds", "member_words", "unit_depth"):
                np.testing.assert_array_equal(getattr(pb, f), getattr(jb, f))
            assert (pb.child_words is None) == (jb.child_words is None)
            if pb.child_words is not None:
                np.testing.assert_array_equal(pb.child_words, jb.child_words)
                np.testing.assert_array_equal(pb.decode_child(), pp.circuit.child)
            np.testing.assert_array_equal(pb.decode_members(), pp.circuit.members)


def test_pad_and_word_helpers_match_jax():
    rng = np.random.default_rng(7)
    for n, u in [(1, 1), (7, 7), (21, 28), (33, 31), (100, 300), (129, 1100), (1500, 1600)]:
        assert pc.pad_targets(n, u) == jc.pad_targets(n, u)
        assert pc.ladder_up(n) == jc.ladder_up(n)
    ((_, jcirc, _),), ((_, circuit, _),) = jobs_of([synth.hierarchical_fbas(3, 3)])
    for n_to, u_to in [(circuit.n, circuit.n_units), (16, 24), (24, 64)]:
        _same_circuit(pc.pad_circuit(circuit, n_to, u_to), jc.pad_circuit(jcirc, n_to, u_to))
    with pytest.raises(ValueError, match="below circuit shape"):
        pc.pad_circuit(circuit, circuit.n - 1, circuit.n_units)
    for m, words in [(5, 1), (40, 2), (128, 4), (97, 4)]:
        rows = (rng.random((6, m)) < 0.5).astype(np.uint8)
        got = pc.pack_mask_words(rows, words)
        np.testing.assert_array_equal(got, jc.pack_mask_words(rows, words))
        np.testing.assert_array_equal(pc.unpack_mask_words(got, m), rows)
    with pytest.raises(ValueError, match="do not fit"):
        pc.pack_mask_words(np.ones((1, 33)), 1)


def _window_pack(data, windows):
    """One job split over ``windows`` lane groups, as the drive splits it:
    (jax packed, port packed, window lows)."""
    jax_jobs, port_jobs = jobs_of([data])
    jm, pm = _members(jax_jobs, port_jobs)
    total = 1 << (len(port_jobs[0][2]) - 1)
    los = [total * t // windows for t in range(windows)]
    return jc.pack_circuits(jm * windows), pc.pack_circuits(pm * windows), los


def _pack_case(case):
    if case == "mixed":
        jax_jobs, port_jobs = jobs_of(PAIR_DATAS)
        jm, pm = _members(jax_jobs, port_jobs)
        return jc.pack_circuits(jm), pc.pack_circuits(pm), [[0] * 6, [3, 9, 1, 17, 2, 0]]
    if case == "depth1":
        datas = [synth.hierarchical_fbas(3, 4, org_threshold=1), synth.hierarchical_fbas(4, 3)]
        jax_jobs, port_jobs = jobs_of(datas)
        jm, pm = _members(jax_jobs, port_jobs, scope=True)
        return jc.pack_circuits(jm), pc.pack_circuits(pm), [[0, 0], [40, 1000]]
    if case == "split":
        jp, pp, los = _window_pack(kofn(14, 7, "S"), 8)
        return jp, pp, [los, [lo + 100 for lo in los]]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["mixed", "depth1", "split"])
def test_packed_program_matches_jax_k7_k3_k4(case):
    jp, pp, starts_list = _pack_case(case)
    assert pp.circuit.depth == (0 if case == "split" else 1)
    batch = 128
    tables = pp.decode_tables()
    jax_progs = {
        "K7": jk.packed_sweep_program_factory(jp.circuit, jp.circuit_d, *jp.decode_tables(), batch),
        "K3": pallas_sweep.pallas_packed_program_factory(jp.circuit, jp.circuit_d, *jp.decode_tables(), batch),
        "K4": pallas_sweep.pallas_bitset_program_factory(jp.circuit, jp.circuit_d, *jp.decode_tables(), batch),
    }
    dense = PackedRef(pp.circuit, pp.circuit_d, *tables, batch, "dense", CPU)
    bitset = PackedRef(pp.circuit, pp.circuit_d, *tables, batch, "bitset", CPU)
    hits = 0
    # Two blocks per program: the lockstep advance of every group's start.
    progs = {name: f(2) for name, f in jax_progs.items()}
    for starts in starts_list:
        s = np.asarray(starts, dtype=np.int32)
        want = np.asarray(progs["K7"](s))
        for name in ("K3", "K4"):
            np.testing.assert_array_equal(np.asarray(progs[name](s)), want, err_msg=name)
        np.testing.assert_array_equal(dense.program(s, 2).numpy(), want)
        np.testing.assert_array_equal(bitset.program(s, 2).numpy(), want)
        hits += int((want < jk.INT32_MAX).sum())
    assert hits > 0


CHECK_CASES = {
    "mixed": PAIR_DATAS,
    "k1": [kofn(5, 3)],
    "split-correct": [kofn(16, 9, "W")],
    "split-broken": [kofn(16, 8, "W")],
    "ragged9": [kofn(9 + (i % 4), 5 + (i % 2), f"R{i}") for i in range(9)],
}


@pytest.mark.parametrize("engine", ["xla", "bitset"])
@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_sccs_matches_jax(case, engine):
    jax_jobs, port_jobs = jobs_of(CHECK_CASES[case])
    want = TpuSweepBackend(batch=256, engine=engine).check_sccs(jax_jobs)
    got = GpuSweepBackend(batch=256, device="cpu", engine=engine).check_sccs(port_jobs)
    assert_jobs_equal(got, want, engine)
    assert all(r.stats["packed"] and r.stats["pack_engine"] == engine for r in got)
    if case.startswith("split"):
        assert got[0].stats["pack_groups"] > 1
    if case == "k1":
        assert got[0].stats["pack_groups"] == 1


@pytest.mark.parametrize("engine", ["xla", "bitset"])
def test_per_job_cancel_matches_jax(engine):
    jax_jobs, port_jobs = jobs_of(PAIR_DATAS[:4])
    jax_tokens, port_tokens = [None] * 4, [None] * 4
    jax_tokens[1], port_tokens[1] = JaxCancelToken(), CancelToken()
    jax_tokens[1].cancel()
    port_tokens[1].cancel()
    want = TpuSweepBackend(batch=256, engine=engine).check_sccs(jax_jobs, cancels=jax_tokens)
    got = GpuSweepBackend(batch=256, device="cpu", engine=engine).check_sccs(port_jobs, cancels=port_tokens)
    assert_jobs_equal(got, want, engine)
    assert got[1].stats["cancelled"] is True and got[0].stats.get("cancelled") is None


def test_pre_cancelled_backend_raises_in_both():
    jax_jobs, port_jobs = jobs_of([kofn(8, 5)])
    jax_token, token = JaxCancelToken(), CancelToken()
    jax_token.cancel()
    token.cancel()
    with pytest.raises(JaxSearchCancelled):
        TpuSweepBackend(batch=256, cancel=jax_token).check_sccs(jax_jobs)
    with pytest.raises(SearchCancelled, match="before setup"):
        GpuSweepBackend(batch=256, cancel=token, device="cpu").check_sccs(port_jobs)


def test_multi_edge_bitset_resolves_dense_like_jax():
    datas = [multi_edge(), kofn(8, 4, "E")]
    jax_jobs, port_jobs = jobs_of(datas)
    jm, pm = _members(jax_jobs, port_jobs)
    jr = jax_resolve_engine("bitset", mesh=False, wide=False, restricted=False,
                            circuit=jc.pack_circuits(jm).circuit)
    pr = resolve_engine("bitset", pc.pack_circuits(pm).circuit)
    assert (pr.requested, pr.resolved, pr.reason) == (jr.requested, jr.resolved, jr.reason)
    assert pr.resolved == "xla" and pr.kernel == "dense"
    for requested in ("xla", "pallas"):
        jr = jax_resolve_engine(requested, mesh=False, wide=False, restricted=False,
                                circuit=jc.pack_circuits(jm).circuit)
        pr = resolve_engine(requested, pc.pack_circuits(pm).circuit)
        assert (pr.resolved, pr.reason) == (jr.resolved, jr.reason)
    want = TpuSweepBackend(batch=256, engine="bitset").check_sccs(jax_jobs)
    got = GpuSweepBackend(batch=256, device="cpu", engine="bitset").check_sccs(port_jobs)
    assert_jobs_equal(got, want, "bitset")
    assert got[0].stats["pack_engine"] == "xla"


def test_wide_job_stays_unpacked_like_jax():
    """An enumeration wider than lo_bits takes the unpacked drive in both."""
    datas = [jax_synth.benchmark_fbas(40, 8, broken=True, seed=2), kofn(4, 2, "V")]
    jax_jobs, port_jobs = jobs_of(datas)
    want = TpuSweepBackend(batch=4, lo_bits=3).check_sccs(jax_jobs)
    got = GpuSweepBackend(batch=4, lo_bits=3, device="cpu").check_sccs(port_jobs)
    assert_jobs_equal(got, want, "xla")
    assert "packed" not in got[0].stats and got[1].stats["packed"]


def _check_many_sources():
    return [
        fixture_data("trivial_correct.json"),
        fixture_data("trivial_broken.json"),
        fixture_data("nested_correct.json"),
        fixture_data("nested_broken.json"),
        synth.hierarchical_fbas(3, 3, broken=True),  # guard-decided
        kofn(8, 5),
        kofn(8, 4),
        synth.stellar_like_fbas(5, 3, n_watchers=20, seed=1),
        synth.stellar_like_fbas(5, 3, n_watchers=20, seed=2, broken=True),
    ]


@pytest.mark.parametrize("pack", [True, False])
def test_check_many_matches_jax(pack):
    sources = _check_many_sources()
    want = jax_check_many(sources, backend=TpuSweepBackend(batch=256), pack=None if pack else False)
    backend = GpuSweepBackend(batch=256, device="cpu")
    got = check_many(sources, backend=backend, pack=pack)
    assert len(got) == len(want) == len(sources)
    # Each packed result names the pack it ran in, among the plans the call ran.
    ran = {r.stats["pack_index"]: r.stats for r in got if r.stats.get("packed")}
    assert sorted(ran) == list(range(len(backend.pack_plans))) and bool(ran) == pack
    for ix, plan in enumerate(backend.pack_plans):
        assert ran[ix]["pack_groups"] == plan.packed.groups == len(plan.group_circuits)
    for g, w in zip(got, want):
        assert (g.intersects, g.q1, g.q2) == (w.intersects, w.q1, w.q2)
        assert (g.n_sccs, g.quorum_scc_ids, g.main_scc) == (w.n_sccs, w.quorum_scc_ids, w.main_scc)
        for key in ("reason", "hit_index", "candidates_checked", "packed"):
            assert g.stats.get(key) == w.stats.get(key), key
    assert got[4].stats["reason"] == "scc_guard" and got[4].q1 and got[4].q2
    assert all("search" in r.timers for r in got if "reason" not in r.stats)


def test_check_many_passes_cancels_through():
    sources = _check_many_sources()[5:]
    tokens = [None, CancelToken(), None, None]
    tokens[1].cancel()
    jax_tokens = [None, JaxCancelToken(), None, None]
    jax_tokens[1].cancel()
    want = jax_check_many(sources, backend=TpuSweepBackend(batch=256), cancels=jax_tokens)
    got = check_many(sources, device="cpu", cancels=tokens)
    assert got[1].stats["cancelled"] and got[1].q1 is None
    for g, w in zip(got, want):
        assert (g.intersects, g.q1, g.q2) == (w.intersects, w.q1, w.q2)
        assert g.stats.get("cancelled") == w.stats.get("cancelled")


def test_fused_kernel_takes_up_to_1024_units():
    """The fused kernel's tables: a 390-unit circuit's child votes come back
    from its blocks; past 1024 units, and past one block's shared memory,
    the tables are still built (the streamed instance takes the latter)."""
    graph = build_graph(parse_fbas(synth.inner_set_ring_fbas(30, 12)))
    circuit = encode_circuit(graph)
    assert 256 < circuit.n_units <= 1024 and circuit.n <= 64
    t = plane_tables(circuit, CPU)
    assert (t.c0, t.slabs, t.depth, t.pc) == (0, 4, 1, 1)
    flat = t.blocks.numpy().view(np.uint32).reshape(-1, 32, 4)
    child = np.zeros((t.units, 128 * t.slabs), dtype=np.uint8)
    for c, (first, m, k0, k1) in enumerate(t.chunks.numpy()):
        for x in range(k0, k1):  # lane 4 g + q, word j: unit 32 c + 8 j + g, columns 32 q + [0, 32)
            words = flat[first + m + x - k0].reshape(8, 4, 4).transpose(2, 0, 1).reshape(32, 4)
            bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
            child[32 * c:32 * c + 32, 128 * x:128 * x + 128] = bits.reshape(32, 128)
    np.testing.assert_array_equal(child[: circuit.n_units, : circuit.n_units], circuit.child)
    wide = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(40, 30))))
    assert wide.n_units > 1024
    assert not plane_tables(wide, CPU).stream
    # Two child bit-planes over ~1000 units: resident, well inside one block.
    big = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(32, 30))))
    assert big.n_units <= 1024
    big.child = np.where(big.child > 0, 3, 0).astype(np.uint8)
    assert plane_tables(big, CPU).pc == 2


def test_packed_wrappers_refuse_cpu_tables_and_bad_layouts():
    _, pp, los = _window_pack(kofn(10, 6, "C"), 4)
    tables = pp.decode_tables()
    for engine, launch in (("dense", packed_sweep_dense), ("bitset", packed_sweep_bitset)):
        sweep = PackedSweep(pp.circuit, pp.circuit_d, *tables, 64, engine=engine, device="cpu")
        before = launch.launches
        np.testing.assert_array_equal(
            sweep.program(np.asarray(los, dtype=np.int32), 2).numpy(),
            PackedRef(pp.circuit, pp.circuit_d, *tables, 64, engine, CPU).program(los, 2).numpy(),
        )
        with pytest.raises(ValueError, match="CUDA only"):
            launch(sweep, los, 64)
        assert launch.launches == before
    pos, _, lane_group, group_ind = tables
    base, bits = group_decode(pos, lane_group, group_ind.shape[1])
    assert list(bits) == [9] * 4 and list(base) == [1, 17, 33, 49]
    swapped = pos.copy()
    swapped[[1, 2]] = swapped[[2, 1]]
    with pytest.raises(KernelLimitError, match="shift layout"):
        group_decode(swapped, lane_group, group_ind.shape[1])
    with pytest.raises(ValueError, match="multiplicities"):
        jm, pm = _members(*jobs_of([multi_edge()]))
        multi = pc.pack_circuits(pm)
        PackedRef(multi.circuit, multi.circuit_d, *multi.decode_tables(), 64, "bitset", CPU)


def _early_ring(n, per):
    """``inner_set_ring_fbas(n, per, broken=True)`` with node 1 also a
    quorum on its own: the first hit at index 1, so a CPU sweep ends early."""
    data = synth.inner_set_ring_fbas(n, per, broken=True)
    data[1]["quorumSet"]["threshold"] = 1
    data[1]["quorumSet"]["innerQuorumSets"][0]["threshold"] = 1
    return data


@pytest.mark.parametrize("case", ["ring(30,12)", "ring(24,12)", "four rings in one lane plan"])
def test_packs_fit_the_packed_unit_limit(case):
    """The JAX window split counts lanes only: ``inner_set_ring_fbas(30, 12)``
    plans 4 windows (1568 fused units), ``(24, 12)`` 5 (1560), and four
    rings share one lane plan of 1208 units.  The port's drive plans packs
    the packed kernels take, on both routes where the votes allow."""
    datas = {"ring(30,12)": [synth.inner_set_ring_fbas(30, 12)],
             "ring(24,12)": [synth.inner_set_ring_fbas(24, 12)],
             "four rings in one lane plan": [synth.inner_set_ring_fbas(n, 12) for n in (30, 24, 20, 16)]}[case]
    _, port_jobs = jobs_of(datas)
    backend = GpuSweepBackend(device="cpu")
    prepared = {i: backend._prepare_job(*job, False) for i, job in enumerate(port_jobs)}
    lane_plan = pc.plan_packs([j.circuit.n for j in prepared.values()])
    packs = backend.pack_members(prepared)
    assert sorted(i for p in packs for i in p) == list(range(len(datas)))
    if case.startswith("four"):
        assert len(lane_plan) == 1 and len(packs) == 2
    for members in packs:
        plan = backend.plan_pack([prepared[i] for i in members])
        c = plan.packed.circuit
        assert c.n_units <= MAX_UNITS
        for route in ("u8", "b1") if pc.bitset_supported(c) else ("u8",):
            mma_tables(c, plan.packed.circuit_d, route)  # raises on refusal
    if not case.startswith("four"):
        assert plan.packed.groups > 1  # still split into windows, fewer


def test_check_many_past_the_unit_limit_matches_jax():
    """Four broken rings whose JAX pack (one lane plan, 1208 fused units)
    the port splits in two: every verdict, witness and hit index is the JAX
    ``check_many``'s."""
    sources = [_early_ring(n, 12) for n in (30, 24, 20, 16)]
    want = jax_check_many(sources, backend=TpuSweepBackend(batch=16))
    got = check_many(sources, backend=GpuSweepBackend(batch=16, device="cpu"))
    assert max(w.stats["pack_shape"][1] for w in want) > MAX_UNITS
    assert max(g.stats["pack_shape"][1] for g in got) <= MAX_UNITS
    for g, w in zip(got, want):
        assert (g.intersects, g.q1, g.q2) == (w.intersects, w.q1, w.q2)
        assert g.stats["hit_index"] == w.stats["hit_index"]
        assert g.stats["candidates_checked"] >= 1
