"""The port's bitset engine arm on the CPU against the JAX package.

- the plain K8 (``kernels/bitset_sweep_ref.py``) against the JAX
  ``bitset_sweep_program_factory`` program on restricted (Q and D sides)
  and unrestricted problems: a hit, a clean miss, a chunk tail, a hi row;
- a numpy model of the CUDA kernel's schedule (one warp a row, ballot words,
  trimmed child ranges, the last round's node words only) on the tables
  ``bitset_sweep_cuda.bitset_tables`` builds, against the plain version;
- engine resolution (``resolve_engine``, ``QI_SWEEP_ENGINE`` against the
  ctor) against the JAX ``resolve_engine``;
- the four-rung parity of ``TestDifferential`` (``tests/test_qi_sparse.py``)
  through the port's ``solve`` and ``check_sccs``: verdict, witness, hit
  index, certificates equal but for provenance, the ``encoding`` stamp on
  the bitset one only, both through ``tools/check_cert.py``; rank order and
  pruning; packed against unpacked;
- the router's bitset hint against a test-local ``Calibration`` and the
  win-region rule ``calibration.bitset_region``;
- no in-place degrade: a K8 failure fails the solve.

Every value is an integer or a node list: exact equality.
"""

import io
import json
import sys
from functools import lru_cache

import numpy as np
import pytest
import torch

from quorum_intersection_tpu.backends.tpu import kernels as jk
from quorum_intersection_tpu.backends.tpu.sweep import TpuSweepBackend
from quorum_intersection_tpu.backends.tpu.sweep import resolve_engine as jax_resolve_engine
from quorum_intersection_tpu.pipeline import solve as jax_solve
from quorum_intersection_tpu_torch import cli
from quorum_intersection_tpu_torch.backends import auto as auto_mod
from quorum_intersection_tpu_torch.backends.calibration import HOST_CPU, Calibration, bitset_region
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend, resolve_engine
from quorum_intersection_tpu_torch.encode.circuit import encode_circuit
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.kernels import bitset_sweep_cuda as bk
from quorum_intersection_tpu_torch.kernels.bitset_sweep_ref import BitsetSweepRef
from quorum_intersection_tpu_torch.kernels.packed_ref import popcount32
from quorum_intersection_tpu_torch.pipeline import quorum_bearing_sccs, solve
from quorum_intersection_tpu_torch.utils import telemetry
from tools.check_cert import check_certificate

from _torch_bitset_cases import MODEL_CASES, SOURCES, BitsetProblem, circuit_problem, graph_problem
from _torch_cases import jax_build_graph, jax_encode, jax_parse, jax_restrict, multi_edge
from _torch_circuits import dense_child_circuit

torch.set_num_threads(1)
CPU = torch.device("cpu")
INT32_MAX = 2**31 - 1
BATCH = 256

CORRECT = synth.near_disjoint_cores(6, 1)
BROKEN = synth.near_disjoint_cores(6, 1, broken=True)
FIXTURES = {"correct": (CORRECT, True), "broken": (BROKEN, False)}

@lru_cache(maxsize=None)
def _problem(name: str, broken: bool):
    """``(port problem, jax Q circuit, jax D circuit)`` of one source."""
    make, restrict = SOURCES[name]
    data = make(broken)
    prob = graph_problem(name, data, restrict)
    jax_whole = jax_encode(jax_build_graph(jax_parse(data)))
    if restrict:
        graph = build_graph(parse_fbas(data))
        [(_, scc)] = quorum_bearing_sccs(graph)
        jq, jd = jax_restrict(jax_whole, scc)
        return prob, jq, jd
    return prob, jax_whole, None


# (lo_bits, hi seed or None, starts, steps) of each case; lo_bits None:
# every enumeration bit in the kernel.
CASES = {
    "program": (None, None, lambda total: [0, total // 3], 2),
    "chunk_tail": (6, None, lambda total: [64 - 100 % 64, 64 - 40], 1),
    "hi_row": (5, 11, lambda total: [0, 7], 1),
}


@lru_cache(maxsize=None)
def _jax_program(name: str, broken: bool, lo_bits: int, steps: int):
    prob, jq, jd = _problem(name, broken)
    lo_nodes, _ = prob.decode(lo_bits)
    return jk.bitset_sweep_program_factory(jq, lo_nodes, prob.scc_mask, prob.frozen, BATCH, circuit_d=jd)(steps)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("broken", [False, True])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_plain_k8_matches_jax_program(name, broken, case):
    prob, _, _ = _problem(name, broken)
    bits = len(prob.local) - 1
    lo_bits, hi_seed, starts_of, steps = CASES[case]
    lo_bits = bits if lo_bits is None else lo_bits
    lo_nodes, _ = prob.decode(lo_bits)
    hi = 0
    if hi_seed is not None:
        rng = np.random.default_rng(hi_seed)
        hi = int(sum(1 << j for j in range(bits - lo_bits) if rng.random() < 0.5))
    _, hi_row = prob.decode(lo_bits, hi)
    plain = BitsetSweepRef(prob.circuit, lo_nodes, prob.scc_mask, prob.frozen, BATCH, prob.circuit_d, CPU)
    wrapper = bk.BitsetSweep(prob.circuit, lo_nodes, prob.scc_mask, prob.frozen, BATCH, prob.circuit_d, "cpu")
    program = _jax_program(name, broken, lo_bits, steps)
    launches = bk.bitset_sweep.launches
    for start in starts_of(1 << lo_bits):
        want = int(program(start, hi_row if hi_seed is not None else None))
        assert int(plain.program(start, steps, hi_row if hi_seed is not None else None)) == want, start
        assert int(wrapper.program(start, steps, bk.mask_bits(hi_row))) == want, start
        if not broken:
            assert want == INT32_MAX  # an intersecting network: a clean miss
    assert bk.bitset_sweep.launches == launches  # the CPU path never launches


def test_the_cases_include_hits_misses_and_aliased_rows():
    """The broken twins hit inside the compared windows, and a chunk tail's
    window runs past the decode chunk's end: its rows there alias mod
    2^lo_bits, and its answer masked to the chunk is a real hit."""
    prob, _, _ = _problem("ndc6", True)
    lo_nodes, _ = prob.decode(6)
    one = BitsetSweepRef(prob.circuit, lo_nodes, prob.scc_mask, prob.frozen, 1, prob.circuit_d, CPU)
    hits = [s for s in range(64) if int(one.program(s, 1)) < INT32_MAX]
    assert hits and len(hits) < 64
    plain = BitsetSweepRef(prob.circuit, lo_nodes, prob.scc_mask, prob.frozen, BATCH, prob.circuit_d, CPU)
    for start in CASES["chunk_tail"][2](64):
        assert start + BATCH > 64
        assert int(plain.program(start, 1)) & 63 in hits


# ---- a numpy model of the CUDA kernel's schedule ----------------------------


def _popc(x: np.ndarray) -> np.ndarray:
    return popcount32(torch.from_numpy(x.astype(np.int64))).numpy()


def kernel_model(t: bk.BitsetTables, lo_nodes, hi_bits: int, scc_bits: int, frozen_bits: int,
                 start: int, rows: int) -> int:
    """``csrc/bitset_sweep.cu`` row by row on its own tables: one 16-byte
    unit record, the trimmed child range, the satisfaction words a ballot
    gives, ``rounds`` inner rounds of which the last computes the node
    words only; the least hit index (INT32_MAX on a miss)."""
    units = t.units.numpy().view(np.uint32).astype(np.int64)
    thr = units[:, 2:].astype(np.uint32).view(np.int32)
    ranges = t.ranges.numpy()
    words = t.words.numpy().view(np.uint32).astype(np.int64)
    entries = []  # (unit, k, word)
    for u in range(t.units_pad):
        base, packed = int(ranges[u, 0]), int(ranges[u, 1]) & 0xFFFFFFFF
        for k in range(packed & 0xFFFF, packed >> 16):
            entries.append((u, k, int(words[base + k])))
    e_unit = np.asarray([e[0] for e in entries], dtype=np.int64)
    e_k = np.asarray([e[1] for e in entries], dtype=np.int64)
    e_word = np.asarray([e[2] for e in entries], dtype=np.int64)

    def pack(sat):  # (units_pad,) bool -> (uw,) words
        return (sat.reshape(-1, 32).astype(np.int64) << np.arange(32)).sum(axis=1)

    def node_sat(a, side):
        a0, a1 = a & 0xFFFFFFFF, a >> 32
        base = _popc(a0 & units[:, 0]) + _popc(a1 & units[:, 1])
        sat = base >= thr[:, side]
        for _ in range(t.rounds):
            cur = pack(sat)
            inner = np.zeros(t.units_pad, dtype=np.int64)
            if entries:
                np.add.at(inner, e_unit, _popc(cur[e_k] & e_word))
            sat = base + inner >= thr[:, side]
        w = pack(sat)
        return int(w[0]) | (int(w[1]) << 32 if t.nw > 1 else 0)

    def fixpoint(a, f, side):
        while True:
            nxt = node_sat(a | f, side) & a
            if nxt == a:
                return a
            a = nxt

    for r in range(rows):
        idx = start + r
        a = hi_bits
        for j, v in enumerate(lo_nodes):
            if (idx >> j) & 1:
                a |= 1 << int(v)
        q = fixpoint(a, 0, 0)
        if q and fixpoint(scc_bits & ~q, frozen_bits, 1):
            return idx
    return INT32_MAX


@pytest.mark.parametrize("name,broken,lo_bits,hi,starts", MODEL_CASES)
def test_kernel_model_on_its_tables_matches_plain(name, broken, lo_bits, hi, starts):
    prob, _, _ = _problem(name, broken)
    _check_model(prob, lo_bits, hi, starts, 96)


@pytest.mark.parametrize("which", ["ring(30,12) 390 units", "dense 993 units"])
def test_kernel_model_on_wide_circuits_matches_plain(which):
    """13 and 32 satisfaction words, depth 1 and 2, ranges past word 0."""
    if which.startswith("ring"):
        circuit = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(30, 12, broken=True))))
        prob = circuit_problem(which, circuit)
        _check_model(prob, 29, 0, [(1 << 29) - (1 << 13) + 7930], 48)
    else:
        prob = circuit_problem(which, dense_child_circuit())
        _check_model(prob, 30, 0, [1 << 20], 12)


def _check_model(prob: BitsetProblem, lo_bits, hi, starts, rows):
    lo_nodes, hi_row = prob.decode(lo_bits, hi)
    for instance in (None, "streamed"):  # the warp tables of both placements
        t = bk.bitset_tables(prob.circuit, prob.circuit_d, CPU, instance)
        plain = BitsetSweepRef(prob.circuit, lo_nodes, prob.scc_mask, prob.frozen, rows, prob.circuit_d, CPU)
        for start in starts:
            want = int(plain.program(start, 1, hi_row if hi_row.any() else None))
            got = kernel_model(t, lo_nodes, bk.mask_bits(hi_row), bk.mask_bits(prob.scc_mask),
                               bk.mask_bits(prob.frozen), start, rows)
            assert got == want, (prob.label, start)


def test_tables_pick_the_instance_from_their_size():
    """The 993-unit circuit's tables fit one block; the 3001-unit ones
    (child rows over 94 words) stream; a resident instance it cannot hold
    raises before any launch."""
    small = bk.bitset_tables(dense_child_circuit(), None, CPU)
    wide = bk.bitset_tables(dense_child_circuit(units=3001), None, CPU)
    assert small.resident and not wide.resident and wide.units_pad == 3008
    assert bk.smem_bytes(wide.units_pad, wide.n_words, True, wide.warps) > bk.SMEM_LIMIT
    with pytest.raises(bk.KernelLimitError, match="resident instance"):
        bk.bitset_tables(dense_child_circuit(units=3001), None, CPU, instance="resident")
    with pytest.raises(bk.KernelLimitError, match="one bit per member"):
        bk.bitset_tables(encode_circuit(build_graph(parse_fbas(multi_edge(9, 5, "E")))), None, CPU)


# ---- engine resolution -------------------------------------------------------


def _circuits():
    plain = encode_circuit(build_graph(parse_fbas(CORRECT)))
    multi = encode_circuit(build_graph(parse_fbas(CORRECT)))
    multi.members[0, int(np.argmax(multi.members[0]))] = 2
    big = encode_circuit(build_graph(parse_fbas(CORRECT)))
    big.members[0, int(np.argmax(big.members[0]))] = 200
    return {"plain": plain, "multi-edge": multi, "votes past int8": big}


@pytest.mark.parametrize("requested", ["xla", "pallas", "bitset"])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("restricted", [False, True])
def test_resolve_engine_matches_jax(requested, wide, restricted):
    for label, circuit in _circuits().items():
        want = jax_resolve_engine(requested, mesh=False, wide=wide, restricted=restricted, circuit=circuit)
        got = resolve_engine(requested, circuit, wide=wide, restricted=restricted)
        assert (got.requested, got.resolved, got.reason) == (want.requested, want.resolved, want.reason), label


def test_env_knob_and_ctor_precedence_match_jax(monkeypatch):
    for value in (None, "bitset", "pallas", "xla", "chaotic", " BITSET "):
        if value is None:
            monkeypatch.delenv("QI_SWEEP_ENGINE", raising=False)
        else:
            monkeypatch.setenv("QI_SWEEP_ENGINE", value)
        assert GpuSweepBackend(device="cpu")._engine_mode() == TpuSweepBackend()._engine_mode(), value
        assert GpuSweepBackend(engine="pallas", device="cpu")._engine_mode() == "pallas"
    with pytest.raises(ValueError):
        GpuSweepBackend(engine="chaotic", device="cpu")


# ---- four-rung parity --------------------------------------------------------


@lru_cache(maxsize=None)
def port_solve(fixture, engine, order="natural", prune=False):
    data, _ = FIXTURES[fixture]
    return solve(json.dumps(data), backend=GpuSweepBackend(engine=engine, batch=BATCH, order=order,
                                                           prune=prune, device="cpu"))


@lru_cache(maxsize=None)
def jax_sweep_solve(fixture, engine, order="natural", prune=False):
    data, _ = FIXTURES[fixture]
    return jax_solve(json.dumps(data), backend=TpuSweepBackend(engine=engine, batch=BATCH, order=order,
                                                               prune=prune))


def _strip(cert):
    """The certificate but its provenance, the engine's name in the ledger
    read as the JAX package's (``gpu-sweep`` there is ``tpu-sweep``)."""
    out = json.loads(json.dumps({k: v for k, v in cert.items() if k != "provenance"}))
    for entry in (out.get("coverage") or {}).get("sccs", []):
        if entry.get("backend") == "gpu-sweep":
            entry["backend"] = "tpu-sweep"
    return out


@pytest.mark.parametrize("fixture", ["correct", "broken"])
def test_four_rung_parity_with_jax(fixture):
    data, verdict = FIXTURES[fixture]
    dense, bits = port_solve(fixture, "xla"), port_solve(fixture, "bitset")
    for engine, got in (("xla", dense), ("bitset", bits), ("pallas", port_solve(fixture, "pallas"))):
        want = jax_sweep_solve(fixture, engine)
        assert got.intersects is verdict is want.intersects
        assert (got.q1, got.q2) == (want.q1, want.q2)
        assert got.stats.get("hit_index") == want.stats.get("hit_index")
        assert got.stats["candidates_checked"] == want.stats["candidates_checked"]
        assert got.stats["device_steps"] == want.stats["device_steps"]
        assert _strip(got.cert) == _strip(want.cert)
        assert got.cert["provenance"].get("encoding") == want.cert["provenance"].get("encoding")
    assert bits.cert["provenance"]["encoding"] == "bitset"
    assert "encoding" not in dense.cert["provenance"] and "encoding" not in dense.stats
    assert _strip(bits.cert) == _strip(dense.cert)
    check_certificate(dense.cert, data)
    check_certificate(bits.cert, data)


@pytest.mark.parametrize("engine", ["xla", "pallas", "bitset"])
def test_one_engine_event_a_check(engine):
    res = port_solve("broken", engine)
    events = [e for e in res.cert["provenance"]["events"] if e["name"] == "sweep.engine_resolved"]
    want = [e for e in jax_sweep_solve("broken", engine).cert["provenance"]["events"]
            if e["name"] == "sweep.engine_resolved"]
    assert [e["attrs"] for e in events] == [e["attrs"] for e in want]
    assert len(events) == 1 and events[0]["attrs"]["packed"] is False


@pytest.mark.parametrize("fixture", ["correct", "broken"])
def test_composes_with_rank_order_and_pruning(fixture):
    data, verdict = FIXTURES[fixture]
    dense = port_solve(fixture, "xla", "rank", True)
    bits = port_solve(fixture, "bitset", "rank", True)
    want = jax_sweep_solve(fixture, "bitset", "rank", True)
    assert dense.intersects is verdict and bits.intersects is verdict
    assert (bits.q1, bits.q2) == (dense.q1, dense.q2) == (want.q1, want.q2)
    assert _strip(bits.cert) == _strip(dense.cert) == _strip(want.cert)
    if verdict:
        led = bits.stats["cert"]
        assert led["windows_pruned_guard"] > 0
        assert led["windows_enumerated"] + led["windows_pruned_guard"] == led["window_space"]
        assert any("guard-pruned" in n for n in check_certificate(bits.cert, data))


def _jobs(datas):
    out = []
    for d in datas:
        graph = build_graph(parse_fbas(d))
        [(_, scc)] = quorum_bearing_sccs(graph)
        out.append((graph, encode_circuit(graph), scc))
    return out


def test_packed_bitset_matches_unpacked():
    jobs = _jobs([CORRECT, synth.near_disjoint_cores(6, 1, seed=1), BROKEN])
    unpacked = [GpuSweepBackend(engine="bitset", batch=BATCH, device="cpu").check_scc(g, c, s) for g, c, s in jobs]
    packed = GpuSweepBackend(engine="bitset", batch=BATCH, device="cpu").check_sccs(jobs)
    for u, p in zip(unpacked, packed):
        assert u.intersects == p.intersects and (u.q1, u.q2) == (p.q1, p.q2)
        assert p.stats.get("encoding") == "bitset" == u.stats.get("encoding")
        assert p.stats["pack_engine"] == "bitset"
    dense_packed = GpuSweepBackend(engine="xla", batch=BATCH, device="cpu").check_sccs(jobs)
    for d, p in zip(dense_packed, packed):
        assert d.intersects == p.intersects and (d.q1, d.q2) == (p.q1, p.q2)
        assert "encoding" not in d.stats


def test_env_bitset_reaches_both_drives_and_the_cli(monkeypatch, capsys, tmp_path):
    """QI_SWEEP_ENGINE=bitset, read at check time: the unpacked drive runs
    K8's plain version, packs the bitset one, and the CLI's certificate
    carries the stamp the JAX CLI's does."""
    from quorum_intersection_tpu_torch.kernels import bitset_sweep_ref

    calls = []
    real = bitset_sweep_ref.BitsetSweepRef.program
    monkeypatch.setattr(bitset_sweep_ref.BitsetSweepRef, "program",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    monkeypatch.setenv("QI_SWEEP_ENGINE", "bitset")
    backend = GpuSweepBackend(batch=BATCH, device="cpu")
    res = solve(json.dumps(BROKEN), backend=backend)
    assert calls and res.stats["encoding"] == "bitset"
    packed = backend.check_sccs(_jobs([CORRECT, BROKEN]))
    assert all(r.stats["pack_engine"] == "bitset" and r.stats["encoding"] == "bitset" for r in packed)
    cert = tmp_path / "c.json"
    monkeypatch.setattr(sys, "stdin", io.StringIO(json.dumps(BROKEN)))
    assert cli.main(["--device", "cpu", "--backend", "gpu-sweep", "--cert-out", str(cert)]) == 1
    doc = json.loads(cert.read_text())
    assert doc["provenance"]["encoding"] == "bitset"
    check_certificate(doc, BROKEN)


def test_k8_failure_fails_the_solve(monkeypatch):
    """No in-place degrade to the dense encoding (the JAX drive's
    ``sweep.bitset`` row): a K8 wrapper that raises fails the solve."""
    def broken_program(self, start, steps, hi_mask=0):
        raise RuntimeError("qi_bitset_sweep launch failed: planted")

    monkeypatch.setattr(bk.BitsetSweep, "program", broken_program)
    with pytest.raises(RuntimeError, match="planted"):
        solve(json.dumps(BROKEN), backend=GpuSweepBackend(engine="bitset", batch=BATCH, device="cpu"))
    # The dense engine is untouched by the planted fault.
    assert solve(json.dumps(BROKEN), backend=GpuSweepBackend(engine="xla", batch=BATCH,
                                                             device="cpu")).intersects is False


# ---- routing -----------------------------------------------------------------


@pytest.fixture
def fresh_record():
    rec = telemetry.reset_run_record()
    yield rec
    telemetry.reset_run_record()


def _router(win=5, dmax=1.0, kind="cpu"):
    backend = auto_mod.AutoBackend(device="cpu")
    backend._cal = Calibration(
        kind=kind, sweep_rate=HOST_CPU.sweep_rate, sweep_overhead_warm_s=1.0, sweep_overhead_cold_s=1.0,
        oracle_seconds_per_call=dict(HOST_CPU.oracle_seconds_per_call),
        bitset_win_min_scc=win, bitset_win_max_density=dmax,
    )
    return backend


def test_hint_engages_and_records_the_route(monkeypatch, fresh_record):
    monkeypatch.delenv("QI_SWEEP_ENGINE", raising=False)
    graph, _, scc = _jobs([CORRECT])[0]
    assert _router()._bitset_hint(graph, scc) == "bitset"
    [ev] = [e for e in fresh_record.events if e.get("name") == "route.encoding"]
    assert ev["attrs"]["engine"] == "bitset" and ev["attrs"]["scc"] == len(scc)
    assert "measured win region" in ev["attrs"]["reason"]


def test_env_pin_short_circuits_the_hint(monkeypatch):
    monkeypatch.setenv("QI_SWEEP_ENGINE", "pallas")
    graph, _, scc = _jobs([CORRECT])[0]
    assert _router()._bitset_hint(graph, scc) is None


def test_scc_floor_density_ceiling_and_device_kind(monkeypatch):
    monkeypatch.delenv("QI_SWEEP_ENGINE", raising=False)
    graph, _, scc = _jobs([CORRECT])[0]
    assert _router(win=len(scc) + 1)._bitset_hint(graph, scc) is None
    assert _router(dmax=0.01)._bitset_hint(graph, scc) is None  # the cores are denser
    assert _router(kind="NVIDIA H100 80GB HBM3")._bitset_hint(graph, scc) is None  # measured elsewhere


def test_uncalibrated_hint_stays_off(monkeypatch):
    monkeypatch.delenv("QI_SWEEP_ENGINE", raising=False)
    graph, _, scc = _jobs([CORRECT])[0]
    assert _router(win=None, dmax=None)._bitset_hint(graph, scc) is None
    assert auto_mod.AutoBackend(device="cpu")._bitset_hint(graph, scc) is None  # HOST_CPU: no region


def test_routed_sweep_takes_the_hint(monkeypatch):
    """The sweep rung (the oracle's budget burned) and the race's arm run
    the hinted engine; the answer is the dense engine's."""
    monkeypatch.delenv("QI_SWEEP_ENGINE", raising=False)
    graph, circuit, scc = _jobs([BROKEN])[0]
    for race in (False, True):
        router = _router()
        router.race = race
        res = router.check_scc(graph, circuit, scc, _budget_burned=not race)
        if res.stats["backend"] == "gpu-sweep":
            assert res.stats["encoding"] == "bitset"
        assert res.intersects is False


@pytest.mark.parametrize("rows,want", [
    ([(24, 0.15, 1.3, True), (34, 1.0, 0.4, True)], (24, 0.15)),
    ([(24, 0.15, 1.3, True), (28, 0.15, 1.2, False)], None),          # a wrong verdict vetoes
    ([(24, 0.15, 1.05, True)], None),                                 # under the 1.1x margin
    ([(24, 0.15, 1.3, True), (30, 0.6, 1.2, True), (32, 0.5, 0.8, True)], (24, 0.15)),  # a loss shrinks it
    ([(24, 0.15, 0.5, True), (34, 1.0, 0.7, True)], None),            # no win
])
def test_bitset_region_follows_the_jax_rule(rows, want):
    assert bitset_region(rows) == want
