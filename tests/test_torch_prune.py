"""Block-guard pruning in the port on the CPU against the JAX package.

- the plain guard (``kernels/guard_ref.py``, dense and bitset) against the
  JAX guards K6 (``guard_program_factory``), K2 (``pallas_guard_factory``,
  interpret mode) and the bitset guard, on the JAX planner's own masks;
- ``_PrunePlan`` and the planner against the JAX class and planner;
- the unpacked ``solve`` and the packed ``check_sccs``/``check_many`` under
  pruning against ``TpuSweepBackend(prune=True)``: verdict, witness, hit
  index, the pruned ledger and ``pack_rows_dispatched``;
- the ``QI_SWEEP_PRUNE`` switch, the CLI under it, and no quiet degrade.

Everything compared is an integer or a node list: exact equality.
"""

import json
import os
import subprocess
import sys
from functools import lru_cache

import numpy as np
import pytest
import torch

import quorum_intersection_tpu.backends.tpu.sweep as jax_sweep
import quorum_intersection_tpu.encode.circuit as jc
from quorum_intersection_tpu import cli as jax_cli
from quorum_intersection_tpu.backends.tpu import kernels as jk
from quorum_intersection_tpu.backends.tpu import pallas_sweep
from quorum_intersection_tpu.pipeline import check_many as jax_check_many
from quorum_intersection_tpu.pipeline import solve as jax_solve
import quorum_intersection_tpu_torch.backends.sweep as port_sweep
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend, guard_masks
from quorum_intersection_tpu_torch.encode.circuit import bitset_supported, restrict_circuit_pair
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.kernels.guard_cuda import BlockGuard
from quorum_intersection_tpu_torch.kernels.guard_ref import guard_counts
from quorum_intersection_tpu_torch.pipeline import check_many, solve

from _torch_cases import assert_jobs_equal, fixture_data, jobs_of, kofn, manifest, multi_edge

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCES = {
    "ndc6": lambda: synth.near_disjoint_cores(6, 1),
    "ndc6-broken": lambda: synth.near_disjoint_cores(6, 1, broken=True),
    "ndc10": lambda: synth.near_disjoint_cores(10, 1),
    "snapshot_correct": lambda: fixture_data("snapshot_correct.json"),
    "snapshot_broken": lambda: fixture_data("snapshot_broken.json"),
    "bench-core12": lambda: synth.benchmark_fbas(40, 12, seed=3),
    "stellar": lambda: synth.stellar_like_fbas(5, 3, n_watchers=20, seed=1),
    "stellar-broken": lambda: synth.stellar_like_fbas(5, 3, n_watchers=20, seed=2, broken=True),
    "multi-edge": lambda: multi_edge(9, 5, "E"),
}


def _restricted(name):
    """``(jax scoped circuit, port scoped circuit)`` of the source's
    quorum-bearing SCC, restricted as both sweep drives restrict it."""
    ((_, jcirc, scc),), ((_, circuit, _),) = jobs_of([SOURCES[name]()])
    return jc.restrict_circuit_pair(jcirc, scc)[0], restrict_circuit_pair(circuit, scc)[0]


@lru_cache(maxsize=None)
def plans(name, engine="xla"):
    """The JAX and the port planner on one source's restricted SCC:
    ``(jax plan, jax guard masks, port plan, jax circuit, port circuit)``.
    The JAX masks are caught on their way into the JAX guard factory."""
    jcirc, circuit = _restricted(name)
    bits = circuit.n - 1
    seen = {}
    factory = "bitset_guard_program_factory" if engine == "bitset" else "guard_program_factory"
    real = getattr(jk, factory)

    def spy(circ, batch):
        run = real(circ, batch)

        def guarded(masks):
            seen["masks"] = np.asarray(masks).copy()
            return run(masks)

        return guarded

    setattr(jk, factory, spy)
    try:
        want = jax_sweep.TpuSweepBackend(prune=True)._plan_pruning(
            jcirc, np.arange(1, jcirc.n), bits, 1 << bits, 0, engine
        )
    finally:
        setattr(jk, factory, real)
    got = GpuSweepBackend(prune=True, device="cpu")._plan_pruning(
        circuit, np.arange(1, circuit.n), bits, 1 << bits, 0, engine
    )
    return want, seen["masks"], got, jcirc, circuit


@pytest.mark.parametrize(
    "name", ["ndc6", "ndc6-broken", "snapshot_correct", "bench-core12", "multi-edge"]
)
def test_guard_counts_match_jax_k6_k2_and_bitset(name):
    want_plan, masks, got_plan, jcirc, circuit = plans(name)
    bits = circuit.n - 1
    k = want_plan.block_bits
    np.testing.assert_array_equal(guard_masks(circuit.n, np.arange(1, circuit.n), k, bits - k), masks)
    assert not masks[:, 0].any()  # scc[0] is in no maximal candidate
    want = jk.guard_program_factory(jcirc, 4096)(masks)
    assert got_plan.prefixes == np.nonzero(want == 0)[0].tolist()  # the planner guarded these rows
    if name.startswith("ndc"):
        assert 0 < (want == 0).sum() < len(want)  # pruned and surviving blocks
    np.testing.assert_array_equal(guard_counts(circuit, masks, "dense").numpy(), want)
    # K2 in interpret mode over the first 512 rows and the last 256.
    rows = np.unique(np.r_[0:min(512, len(masks)), max(len(masks) - 256, 0):len(masks)])
    np.testing.assert_array_equal(pallas_sweep.pallas_guard_factory(jcirc)(masks[rows]), want[rows])
    assert bitset_supported(circuit) == jc.bitset_supported(jcirc) == (name != "multi-edge")
    if bitset_supported(circuit):
        bitset = jk.bitset_guard_program_factory(jcirc, 4096)(masks)
        np.testing.assert_array_equal(bitset, want)
        np.testing.assert_array_equal(guard_counts(circuit, masks, "bitset").numpy(), want)
        np.testing.assert_array_equal(BlockGuard(circuit, "bitset", "cpu").counts(masks), want)


def _plan_fields(p):
    return (p.block_bits, p.prefixes, p.windows, p.ranges, p.runs, p.cum, p.run_los, p.guard_rows)


@pytest.mark.parametrize("seed", range(4))
def test_prune_plan_class_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(0, 5))
    blocks = int(rng.integers(1, 64))
    total = blocks << k
    prefixes = sorted(int(p) for p in np.nonzero(rng.random(blocks) < 0.5)[0])
    for start0 in (0, int(rng.integers(0, total))):
        cut = (start0 + (1 << k) - 1) >> k
        kept = [p for p in prefixes if p >= cut]
        want = jax_sweep._PrunePlan.build(k, kept, total, start0, blocks)
        got = port_sweep._PrunePlan.build(k, kept, total, start0, blocks)
        assert _plan_fields(got) == _plan_fields(want)
        for x in rng.integers(0, total + 2, size=24).tolist() + [0, total]:
            y = int(rng.integers(0, total + 2))
            assert got.pruned_before(x) == want.pruned_before(x)
            assert got.skip(x) == want.skip(x)
            assert got.overlap(x, y) == want.overlap(x, y)


@pytest.mark.parametrize("name", ["ndc6", "ndc6-broken", "ndc10", "snapshot_correct"])
def test_planner_matches_jax(name):
    want, _, got, _, _ = plans(name)
    assert (got.block_bits, got.prefixes, got.guard_rows) == (want.block_bits, want.prefixes, want.guard_rows)
    assert got.ranges == want.ranges and got.windows > 0


def test_bitset_planner_matches_jax():
    want, _, got, _, _ = plans("ndc6-broken", "bitset")
    assert got.encoding == "bitset"
    assert _plan_fields(got) == _plan_fields(want)


# Sources whose unpruned port sweep is cheap enough to run beside the
# pruned one here (test_torch_pipeline holds the snapshots' unpruned sweep
# to the JAX package's).
SOLO_UNPRUNED = ("ndc6", "ndc6-broken", "stellar", "stellar-broken")


def _pruned_solve(name):
    data = SOURCES[name]()
    pruned = solve(data, backend=GpuSweepBackend(prune=True, device="cpu"))
    if name in SOLO_UNPRUNED:
        unpruned = solve(data, backend=GpuSweepBackend(prune=False, device="cpu"))
        assert (pruned.intersects, pruned.q1, pruned.q2) == (unpruned.intersects, unpruned.q1, unpruned.q2)
        assert pruned.stats.get("hit_index") == unpruned.stats.get("hit_index")
    return data, pruned


def _assert_ledger(res, want_cert):
    st = res.stats
    assert st.get("windows_pruned_guard", 0) == want_cert["windows_pruned_guard"]
    blocks = want_cert.get("pruned_blocks")
    assert (st.get("pruned_blocks") is None) == (blocks is None)
    if blocks is not None:
        assert st["pruned_blocks"] == blocks
    if res.intersects:
        assert st["candidates_checked"] + st["windows_pruned_guard"] == st["enumeration_total"]


@pytest.mark.parametrize("name", ["ndc6", "ndc6-broken", "snapshot_broken", "stellar", "stellar-broken"])
def test_pruned_solve_matches_jax(name):
    data, got = _pruned_solve(name)
    want = jax_solve(json.dumps(data), backend=jax_sweep.TpuSweepBackend(prune=True, order="natural"))
    assert (got.intersects, got.q1, got.q2) == (want.intersects, want.q1, want.q2)
    assert got.stats.get("hit_index") == want.stats.get("hit_index")
    _assert_ledger(got, want.stats["cert"])
    assert got.stats["guard_rows"] > 0


def test_pruned_solve_snapshot_correct_matches_jax_plan():
    """The JAX drive sweeps this plan's 1120 surviving ranges in about 19 s
    on the CPU, so the JAX side here is its planner (what its drive reports
    under ``cert``) and the fixture's verdict, which the JAX sweep is held
    to in test_torch_pipeline."""
    _, got = _pruned_solve("snapshot_correct")
    want, _, _, _, _ = plans("snapshot_correct")
    assert got.intersects is manifest()["snapshot_correct.json"]["verdict"] is True
    cert = {"windows_pruned_guard": want.windows,
            "pruned_blocks": {"k": want.block_bits, "rule": jax_sweep.PRUNE_RULE_ID,
                              "prefixes": want.prefixes}}
    _assert_ledger(got, cert)


def _assert_packed_ledger(got, want):
    for g, w in zip(got, want):
        cert = w.stats["cert"]
        terms = (g.stats.get("windows_pruned_guard", 0), g.stats["windows_skipped_pack_fill"])
        assert terms == (cert["windows_pruned_guard"], cert["windows_skipped_pack_fill"])
        assert g.stats.get("pruned_blocks") == cert.get("pruned_blocks")
        if g.intersects:
            assert (g.stats["candidates_checked"] + cert["windows_pruned_guard"]
                    + cert["windows_skipped_pack_fill"]) == g.stats["enumeration_total"]


PACK_CASES = {
    "ndc3": [synth.near_disjoint_cores(6, 1), synth.near_disjoint_cores(6, 1, seed=1),
             synth.near_disjoint_cores(6, 1, broken=True)],
    "ragged": [synth.near_disjoint_cores(6, 1, broken=True), kofn(9, 5, "R"), kofn(12, 6, "S"),
               synth.stellar_like_fbas(5, 3, n_watchers=20, seed=1), multi_edge(9, 5, "E"),
               synth.near_disjoint_cores(5, 1, seed=2)],
}


@pytest.mark.parametrize("engine", ["xla", "bitset"])
@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pruned_check_sccs_matches_jax(case, engine):
    jax_jobs, port_jobs = jobs_of(PACK_CASES[case])
    want = jax_sweep.TpuSweepBackend(batch=256, engine=engine, prune=True, order="natural").check_sccs(jax_jobs)
    backend = GpuSweepBackend(batch=256, device="cpu", engine=engine, prune=True)
    got = backend.check_sccs(port_jobs)
    assert_jobs_equal(got, want, engine)
    _assert_packed_ledger(got, want)
    assert any(g.stats.get("windows_pruned_guard") for g in got)
    encodings = {p.encoding for plan in backend.pack_plans for p in plan.prune_plans if p is not None}
    assert encodings == ({"bitset", "dense"} if engine == "bitset" and case == "ragged"
                         else {"bitset"} if engine == "bitset" else {"dense"})


@pytest.mark.parametrize("engine", ["xla", "bitset"])
def test_pruned_check_many_matches_jax(engine):
    sources = [synth.near_disjoint_cores(6, 1, broken=True), kofn(10, 5, "B"),
               fixture_data("nested_broken.json")]
    want = jax_check_many(sources, backend=jax_sweep.TpuSweepBackend(batch=256, engine=engine, prune=True))
    got = check_many(sources, backend=GpuSweepBackend(batch=256, device="cpu", engine=engine, prune=True))
    for g, w in zip(got, want):
        assert (g.intersects, g.q1, g.q2) == (w.intersects, w.q1, w.q2)
        for key in ("reason", "hit_index", "candidates_checked", "pack_rows_dispatched"):
            assert g.stats.get(key) == w.stats.get(key), key
        if "cert" in w.stats:
            assert g.stats.get("windows_pruned_guard", 0) == w.stats["cert"]["windows_pruned_guard"]


@pytest.mark.parametrize("value,on", [(None, False), ("", False), ("0", False), (" 0 ", False),
                                      ("1", True), ("yes", True)])
def test_switch_reads_the_environment_like_jax(value, on, monkeypatch):
    if value is None:
        monkeypatch.delenv("QI_SWEEP_PRUNE", raising=False)
    else:
        monkeypatch.setenv("QI_SWEEP_PRUNE", value)
    assert GpuSweepBackend(device="cpu")._prune_enabled() is on
    assert jax_sweep.TpuSweepBackend()._prune_enabled() is on
    # The constructor argument wins over the environment.
    assert GpuSweepBackend(prune=not on, device="cpu")._prune_enabled() is (not on)
    res = solve(synth.near_disjoint_cores(6, 1), device="cpu")
    assert ("windows_pruned_guard" in res.stats) is on


def test_cli_under_qi_sweep_prune_matches_jax_cli(monkeypatch, capsys):
    text = json.dumps(fixture_data("snapshot_broken.json"))
    env = dict(os.environ, QI_SWEEP_PRUNE="1", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "quorum_intersection_tpu_torch", "--device", "cpu", "-v"],
                          input=text, capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    monkeypatch.setenv("QI_SWEEP_PRUNE", "1")
    monkeypatch.setattr(sys, "stdin", __import__("io").StringIO(text))
    code = jax_cli.main(["--backend", "tpu-sweep", "-v"])
    assert (proc.stdout, proc.returncode) == (capsys.readouterr().out, code)
    assert code == 1 and proc.stdout.endswith("false\n")


def test_a_failing_guard_fails_the_solve(monkeypatch):
    def broken(self, masks):
        raise RuntimeError("guard launch failed")

    monkeypatch.setattr(BlockGuard, "counts", broken)
    with pytest.raises(RuntimeError, match="guard launch failed"):
        solve(synth.near_disjoint_cores(6, 1), backend=GpuSweepBackend(prune=True, device="cpu"))
    _, port_jobs = jobs_of(PACK_CASES["ndc3"][:1])
    with pytest.raises(RuntimeError, match="guard launch failed"):
        GpuSweepBackend(prune=True, device="cpu").check_sccs(port_jobs)

