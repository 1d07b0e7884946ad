"""The port's incremental re-analysis on the CPU, against the JAX package's
``delta.py`` — port twins of ``tests/test_qi_delta.py``'s classes:

- the SCC-local fingerprint and the snapshot diff (identity-invariant,
  structure-sensitive, merges and splits against the churn generator's
  ground truth);
- the JAX ``DeltaEngine`` and the port's on the same churn trace, step by
  step, on every backend pair (port ``python``/``cpp``/``gpu-sweep``/
  ``gpu-frontier`` on ``device="cpu"`` against JAX ``python``/``cpp``/
  ``tpu-sweep``/``tpu-frontier``): verdict, witness pair, hit index on the
  sweep rungs, ``provenance.delta``, the ``delta.*`` counters and the reuse
  percentage equal, and every certificate passes ``tools/check_cert.py``;
- invocation pinning (a watcher wobble reaches no backend, a core wobble
  exactly once), the closedness soundness gate and the store's LRU;
- a fragment directory written by either package composed by the other;
- single flight on two threads, ordered through ``_delta_sync``;
- the faults: ``delta.diff`` and store errors degrade to the full re-solve,
  ``fleet.store`` to local-LRU-only, ``cost.attribute`` to no cost, and a
  backend error (``sweep.dispatch``) propagates — the port's documented
  divergence from the JAX engine's catch-all.
"""

import copy
import os
import threading

import pytest
import torch

from quorum_intersection_tpu import delta as jax_delta
from quorum_intersection_tpu.backends.tpu.frontier import TpuFrontierBackend
from quorum_intersection_tpu.backends.tpu.sweep import TpuSweepBackend
from quorum_intersection_tpu.utils import faults as jax_faults
from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu_torch import delta
from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
from quorum_intersection_tpu_torch.backends.python_oracle import PythonOracleBackend
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
from quorum_intersection_tpu_torch.delta import (
    DeltaEngine,
    SccScan,
    SccVerdict,
    SccVerdictStore,
    SharedSccStore,
)
from quorum_intersection_tpu_torch.fbas.diff import diff_snapshots, localize, project, scc_fingerprint
from quorum_intersection_tpu_torch.fbas.graph import build_graph, group_sccs, tarjan_scc
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.fbas.synth import (
    benchmark_fbas,
    churn_trace,
    churn_trace_steps,
    majority_fbas,
    stellar_like_fbas,
)
from quorum_intersection_tpu_torch.pipeline import check_many, solve
from quorum_intersection_tpu_torch.utils import faults, telemetry
from quorum_intersection_tpu_torch.utils.faults import FaultInjected
from tools.check_cert import check_certificate

torch.set_num_threads(1)

# port backend name -> (port backend factory, JAX backend factory)
BACKENDS = {
    "python": (lambda: "python", lambda: "python"),
    "cpp": (lambda: "cpp", lambda: "cpp"),
    "gpu-sweep": (lambda: GpuSweepBackend(batch=512, device="cpu"), lambda: TpuSweepBackend(batch=512)),
    "gpu-frontier": (lambda: GpuFrontierBackend(arena=4096, pop=128, device="cpu"),
                     lambda: TpuFrontierBackend(arena=4096, pop=128)),
}

# Two traces: watcher churn around an all-inner-set core (the core is never
# mutated: one cold solve, then compositions), and a broken 8-node majority
# core whose threshold wobbles and swaps re-solve it (hit indices move).
TRACES = {
    "watchers": lambda steps: churn_trace(multi_scc_base(seed=7, n_watchers=8), steps, seed=2),
    "core": lambda steps: churn_trace(benchmark_fbas(24, 8, broken=True, seed=1), steps, seed=0),
}


@pytest.fixture
def rec():
    faults.clear_plan()
    jax_faults.clear_plan()
    record = telemetry.reset_run_record()
    jax_telemetry.reset_run_record()
    yield record
    faults.clear_plan()
    jax_faults.clear_plan()
    telemetry.reset_run_record()
    jax_telemetry.reset_run_record()


def multi_scc_base(seed=7, n_watchers=12):
    """One 6-node quorum-bearing core + many single-node watcher SCCs."""
    return stellar_like_fbas(n_core_orgs=3, per_org=2, n_watchers=n_watchers, seed=seed)


def partition(nodes):
    graph = build_graph(parse_fbas(nodes))
    count, comp = tarjan_scc(graph.n, graph.succ)
    return graph, group_sccs(graph.n, comp, count)


def core_scc(nodes):
    graph, sccs = partition(nodes)
    return graph, max(sccs, key=len)


def wobble(nodes, key, step=-1):
    """Deterministic threshold wobble on one node, by publicKey."""
    out = copy.deepcopy(nodes)
    for n in out:
        if n.get("publicKey") == key:
            q = n["quorumSet"]
            q["threshold"] = max(1, min(q["threshold"] + step, len(q["validators"]) or 1))
            return out
    raise KeyError(key)


def core_key(nodes):
    graph, members = core_scc(nodes)
    return graph.node_ids[members[0]]


def watcher_key(nodes):
    """A churnable (non-null-qset) node OUTSIDE the core SCC."""
    graph, members = core_scc(nodes)
    core_keys = {graph.node_ids[v] for v in members}
    for n in nodes:
        q = n.get("quorumSet")
        if n.get("publicKey") not in core_keys and isinstance(q, dict) and q.get("validators"):
            return n["publicKey"]
    raise AssertionError("no churnable watcher in base")


def flat_core(n_watchers=8):
    """A 6-of-majority core with top-level validators (so a threshold
    wobble can reach it) and watchers around it."""
    return benchmark_fbas(6 + n_watchers, 6, seed=3)


class CountingOracle:
    """Python-oracle delegate counting check_scc calls — the observable that
    pins 'a one-SCC diff re-solves exactly one SCC'.  ``gate`` (optional)
    runs inside each call, before the solve."""

    name = "python"
    needs_circuit = False

    def __init__(self, gate=None):
        self.calls = 0
        self.gate = gate
        self._lock = threading.Lock()

    def check_scc(self, graph, circuit, scc, *, scope_to_scc=False):
        with self._lock:
            self.calls += 1
        if self.gate is not None:
            self.gate()
        return PythonOracleBackend().check_scc(graph, circuit, scc, scope_to_scc=scope_to_scc)


def delta_counters(record):
    return {k: v for k, v in record.snapshot()[0].items() if k.startswith("delta.")}


def witness_pair(res):
    return {frozenset(res.q1), frozenset(res.q2)} if not res.intersects else None


class TestSccFingerprint:
    """The SCC-local fingerprint: structural, never identity-sensitive."""

    def test_rename_invariant(self):
        base = multi_scc_base()
        g0, m0 = core_scc(base)
        renamed = copy.deepcopy(base)
        for n in renamed:
            n["name"] = (n.get("name") or "") + "~renamed"
        g1, m1 = core_scc(renamed)
        assert scc_fingerprint(g0, m0) == scc_fingerprint(g1, m1)

    def test_index_shift_invariant(self):
        base = multi_scc_base()
        g0, m0 = core_scc(base)
        shifted = [{"publicKey": f"ZZPREF{i}", "name": f"pad{i}", "quorumSet": None}
                   for i in range(3)] + copy.deepcopy(base)
        g1, m1 = core_scc(shifted)
        assert m0 != m1
        assert scc_fingerprint(g0, m0)[0] == scc_fingerprint(g1, m1)[0]

    def test_threshold_sensitive(self):
        base = flat_core()
        g0, m0 = core_scc(base)
        g1, m1 = core_scc(wobble(base, core_key(base)))
        assert scc_fingerprint(g0, m0)[0] != scc_fingerprint(g1, m1)[0]

    def test_closedness_reported(self):
        open_core = [{"publicKey": k, "name": k,
                      "quorumSet": {"threshold": 2, "validators": ["A", "B", "C", "W"]}}
                     for k in ("A", "B", "C")] + [{"publicKey": "W", "name": "W", "quorumSet": None}]
        graph, members = core_scc(open_core)
        assert scc_fingerprint(graph, members)[1] is False
        g2, m2 = core_scc(majority_fbas(5))
        assert scc_fingerprint(g2, m2)[1] is True

    def test_localize_project_round_trip(self):
        members = [3, 7, 11, 20]
        local = localize([11, 3], members)
        assert local == [2, 0]
        assert project(local, members) == [11, 3]
        assert localize([11, 4], members) is None
        assert localize(None, members) is None
        assert project(None, members) is None


class TestDiffSnapshots:
    """old→new SCC mapping: unchanged | dirty | new, merges and splits."""

    def test_rename_is_all_unchanged(self):
        base = multi_scc_base()
        renamed = copy.deepcopy(base)
        for n in renamed:
            n["name"] = (n.get("name") or "") + "~r"
        diff = diff_snapshots(build_graph(parse_fbas(base)), build_graph(parse_fbas(renamed)))
        assert diff.dirty == 0 and diff.new == 0
        assert diff.unchanged == diff.new_n_sccs

    def test_one_wobble_dirties_one(self):
        base = flat_core()
        diff = diff_snapshots(build_graph(parse_fbas(base)),
                              build_graph(parse_fbas(wobble(base, core_key(base)))))
        assert diff.dirty == 1 and diff.new == 0
        assert diff.unchanged == diff.new_n_sccs - 1
        (dirty,) = [d for d in diff.deltas if d.kind == "dirty"]
        assert dirty.size == 6

    def test_added_node_is_new(self):
        base = multi_scc_base()
        nxt = copy.deepcopy(base) + [{"publicKey": "FRESH1", "name": "fresh",
                                      "quorumSet": {"threshold": 1, "validators": ["FRESH1"]}}]
        diff = diff_snapshots(build_graph(parse_fbas(base)), build_graph(parse_fbas(nxt)))
        assert diff.new == 1
        (new,) = [d for d in diff.deltas if d.kind == "new"]
        assert new.old_indices == []

    def test_merge_and_split_counted(self):
        """Against the ground truth of churn_trace_steps (member key sets,
        computed independently of the differ)."""
        base = multi_scc_base(seed=11)
        trace, metas = churn_trace_steps(base, 10, seed=5, max_diff=1,
                                         kinds=("scc_merge", "scc_split", "threshold"))
        restructured = 0
        for prev, nxt, meta in zip(trace, trace[1:], metas):
            diff = diff_snapshots(build_graph(parse_fbas(prev)), build_graph(parse_fbas(nxt)))
            assert diff.merges == meta["merges"]
            assert diff.splits == meta["splits"]
            if meta["partition_changed"]:
                restructured += 1
                assert diff.dirty + diff.new >= 1
            if not meta["affected_scc_ids"]:
                assert diff.dirty == 0
        assert restructured >= 2


class TestChurnTraceSteps:
    """Ground-truth step annotations (byte identity with the JAX generator
    is pinned in test_torch_convert)."""

    def test_deterministic_and_wrapper_identical(self):
        base = multi_scc_base()
        t1, m1 = churn_trace_steps(base, 6, seed=3)
        t2, m2 = churn_trace_steps(base, 6, seed=3)
        assert t1 == t2 and m1 == m2
        assert churn_trace(base, 6, seed=3) == t1

    def test_affected_ids_match_structural_mutations(self):
        _, metas = churn_trace_steps(multi_scc_base(), 20, seed=9)
        saw_structural = saw_cosmetic = False
        for meta in metas:
            structural = {m["scc_id"] for m in meta["mutations"] if m["structural"] and m["scc_id"] is not None}
            assert structural <= set(meta["affected_scc_ids"])
            if not meta["partition_changed"]:
                assert set(meta["affected_scc_ids"]) == structural
            saw_structural |= bool(structural)
            saw_cosmetic |= any(m["kind"] == "rename" for m in meta["mutations"])
        assert saw_structural and saw_cosmetic

    def test_split_marks_guardward_restructure(self):
        _, metas = churn_trace_steps(multi_scc_base(seed=11), 8, seed=2, max_diff=1, kinds=("scc_split",))
        assert any(m["splits"] >= 1 for m in metas)

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError):
            churn_trace_steps(multi_scc_base(), 1, kinds=("bogus",))


class TestDifferentialChurn:
    """The port's engine equals the JAX engine step by step, every rung."""

    @pytest.mark.parametrize("trace_name", sorted(TRACES))
    @pytest.mark.parametrize("backend", sorted(BACKENDS))
    def test_port_engine_equals_jax_engine(self, rec, backend, trace_name):
        steps = 5 if backend in ("gpu-sweep", "gpu-frontier") else 8
        trace = TRACES[trace_name](steps)
        make_port, make_jax = BACKENDS[backend]
        jax_rec = jax_telemetry.get_run_record()
        jax_engine = jax_delta.DeltaEngine(jax_delta.SccVerdictStore(256))
        engine = DeltaEngine(SccVerdictStore(256), device="cpu")
        composed = 0
        for step, snap in enumerate(trace):
            want = jax_engine.check_many([snap], backend=make_jax())[0]
            got = engine.check_many([snap], backend=make_port())[0]
            assert got.intersects is want.intersects, step
            assert witness_pair(got) == witness_pair(want), step
            if backend == "gpu-sweep":
                assert got.stats.get("hit_index") == want.stats.get("hit_index"), step
            assert got.cert["provenance"]["delta"] == want.cert["provenance"]["delta"], step
            assert delta_counters(rec) == delta_counters(jax_rec), step
            check_certificate(got.cert, snap)
            composed += got.cert["provenance"]["delta"]["reused_sccs"]
        assert engine.store.reuse_pct() == jax_engine.store.reuse_pct() > 0.0
        assert composed >= 1
        if trace_name == "core":
            assert delta_counters(rec)["delta.solves"] >= 2  # the core really re-solved

    @pytest.mark.parametrize("backend", ["python", "gpu-sweep"])
    def test_incremental_equals_scratch(self, rec, backend):
        """Against the port's own from-scratch check_many (the JAX suite's
        bar), on the core trace where the verdict needs the search."""
        trace = TRACES["core"](6)
        make_port, _ = BACKENDS[backend]
        engine = DeltaEngine(SccVerdictStore(256), device="cpu")
        inc = [engine.check_many([snap], backend=make_port())[0] for snap in trace]
        scratch = check_many(trace, backend=make_port(), device="cpu")
        for snap, a, b in zip(trace, inc, scratch):
            assert a.intersects is b.intersects
            assert witness_pair(a) == witness_pair(b)
            check_certificate(a.cert, snap)

    def test_restructuring_churn_parity(self, rec):
        """Merge and split steps (guard flips included) through both
        engines on the python rung, the semantics oracle."""
        trace = churn_trace(multi_scc_base(seed=11), 8, seed=4,
                            kinds=("threshold", "swap", "rename", "scc_merge", "scc_split"))
        jax_rec = jax_telemetry.get_run_record()
        jax_engine = jax_delta.DeltaEngine(jax_delta.SccVerdictStore(256))
        engine = DeltaEngine(SccVerdictStore(256), device="cpu")
        for snap in trace:
            want = jax_engine.check_many([snap], backend="python")[0]
            got = engine.check_many([snap], backend="python")[0]
            assert (got.intersects, witness_pair(got)) == (want.intersects, witness_pair(want))
            assert got.cert["provenance"]["delta"] == want.cert["provenance"]["delta"]
            check_certificate(got.cert, snap)
        assert delta_counters(rec) == delta_counters(jax_rec)

    def test_composed_certificate_claims_no_race_or_order(self, rec, monkeypatch):
        """``race`` and ``order`` describe the original solve's run: the
        cold certificate carries them, a composed one does not, and the
        fragment keeps the verdict, the witness and its coverage."""
        from quorum_intersection_tpu_torch.backends.auto import AutoBackend

        data = TRACES["core"](0)[0]
        engine = DeltaEngine(SccVerdictStore(64), device="cpu")
        cold, again = (engine.check_many([data], backend=AutoBackend(device="cpu"))[0] for _ in range(2))
        assert cold.cert["provenance"]["race"] is not None
        assert again.cert["provenance"]["race"] is None and "race" not in again.stats
        monkeypatch.setenv("QI_SWEEP_ORDER", "rank")
        engine = DeltaEngine(SccVerdictStore(64), device="cpu")
        cold, again = (engine.check_many([data], backend=GpuSweepBackend(device="cpu"))[0] for _ in range(2))
        assert cold.cert["provenance"]["order"]["mode"] == "rank"
        assert "order" not in again.cert["provenance"]
        assert (again.q1, again.q2) == (cold.q1, cold.q2)
        check_certificate(again.cert, data)

    def test_intra_batch_followers_compose(self, rec):
        """Identical snapshots inside ONE batch: a single leader solve, the
        rest compose from the just-banked fragment."""
        counting = CountingOracle()
        engine = DeltaEngine(SccVerdictStore(64), device="cpu", track_diff=False)
        results = engine.check_many([multi_scc_base()] * 4, backend=counting)
        assert counting.calls == 1
        assert len(results) == 4 and len({r.intersects for r in results}) == 1
        assert results[1].cert["provenance"]["delta"]["reused_sccs"] == 1

    def test_one_batch_of_a_trace_twice(self, rec):
        """A whole trace, each snapshot twice, in one call under gpu-sweep
        on the CPU: equal to one scratch check_many of the same list, and to
        the JAX engine's one call (counters, stamps)."""
        trace = TRACES["core"](4)
        batch = trace + trace
        got = DeltaEngine(SccVerdictStore(256), device="cpu").check_many(
            batch, backend=GpuSweepBackend(batch=512, device="cpu"))
        scratch = check_many(batch, backend=GpuSweepBackend(batch=512, device="cpu"), device="cpu")
        want = jax_delta.DeltaEngine(jax_delta.SccVerdictStore(256)).check_many(
            batch, backend=TpuSweepBackend(batch=512))
        for snap, a, b, c in zip(batch, got, scratch, want):
            assert (a.intersects, witness_pair(a)) == (b.intersects, witness_pair(b)) == \
                (c.intersects, witness_pair(c))
            assert a.cert["provenance"]["delta"] == c.cert["provenance"]["delta"]
            check_certificate(a.cert, snap)
        assert delta_counters(rec) == delta_counters(jax_telemetry.get_run_record())
        assert sum(r.cert["provenance"]["delta"]["reused_sccs"] for r in got) >= len(trace)


class TestInvocationPinning:
    """Exactly one SCC reaches a backend on a one-SCC diff."""

    def test_watcher_wobble_resolves_zero(self, rec):
        base = multi_scc_base()
        counting = CountingOracle()
        engine = DeltaEngine(SccVerdictStore(256), device="cpu")
        engine.check_many([base], backend=counting)
        assert counting.calls == 1
        res = engine.check_many([wobble(base, watcher_key(base))], backend=counting)[0]
        assert counting.calls == 1
        assert res.cert["provenance"]["delta"]["reused_sccs"] == 1
        # exactly one SCC's scan re-derived on the second snapshot
        assert delta_counters(rec)["delta.scan_misses"] == res.n_sccs + 1

    def test_core_wobble_resolves_exactly_one(self, rec):
        base = flat_core()
        counting = CountingOracle()
        engine = DeltaEngine(SccVerdictStore(256), device="cpu")
        engine.check_many([base], backend=counting)
        dirtied = wobble(base, core_key(base))
        res = engine.check_many([dirtied], backend=counting)[0]
        assert counting.calls == 2
        assert res.cert["provenance"]["delta"]["resolved_sccs"] == 1
        assert res.intersects is solve(dirtied, backend="python").intersects

    def test_merge_invalidates_core_fragment(self, rec):
        base = flat_core()
        counting = CountingOracle()
        engine = DeltaEngine(SccVerdictStore(256), device="cpu")
        engine.check_many([base], backend=counting)
        graph, members = core_scc(base)
        ckey, wkey = graph.node_ids[members[0]], watcher_key(base)
        merged = copy.deepcopy(base)
        for n in merged:
            if n["publicKey"] == ckey:
                n["quorumSet"]["validators"].append(wkey)
            elif n["publicKey"] == wkey:
                n["quorumSet"]["validators"].append(ckey)
        assert len(core_scc(merged)[1]) == len(members) + 1
        res = engine.check_many([merged], backend=counting)[0]
        assert counting.calls == 2
        assert res.intersects is solve(merged, backend="python").intersects
        engine.check_many([copy.deepcopy(merged)], backend=counting)
        assert counting.calls == 2

    def test_split_flips_to_guard_not_stale(self, rec):
        base = flat_core()
        graph, members = core_scc(base)
        ckey = graph.node_ids[members[0]]
        split = copy.deepcopy(base)
        for n in split:
            if n["publicKey"] == ckey:
                n["quorumSet"] = {"threshold": 1, "validators": [ckey]}
        engine = DeltaEngine(SccVerdictStore(256), device="cpu")
        engine.check_many([base], backend="python")
        res = engine.check_many([split], backend="python")[0]
        assert res.intersects is solve(split, backend="python").intersects is False
        assert res.stats.get("reason") == "scc_guard"
        check_certificate(res.cert, split)


class TestSoundnessGate:
    """A non-closed SCC's verdict is only reusable under scope_to_scc."""

    OPEN = [{"publicKey": k, "name": k, "quorumSet": {"threshold": 2, "validators": ["A", "B", "C", "W"]}}
            for k in ("A", "B", "C")] + [{"publicKey": "W", "name": "W", "quorumSet": None}]

    def test_open_scc_never_cached_whole_graph(self, rec):
        counting = CountingOracle()
        engine = DeltaEngine(SccVerdictStore(64), device="cpu", track_diff=False)
        for _ in range(3):
            engine.check_many([copy.deepcopy(self.OPEN)], backend=counting)
        assert counting.calls == 3
        assert delta_counters(rec)["delta.uncacheable"] == 3

    def test_open_scc_cached_when_scoped(self, rec):
        counting = CountingOracle()
        engine = DeltaEngine(SccVerdictStore(64), device="cpu", scope_to_scc=True, track_diff=False)
        for _ in range(3):
            engine.check_many([copy.deepcopy(self.OPEN)], backend=counting)
        assert counting.calls == 1


class TestFaultDegrade:
    """What degrades to the full re-solve, and what does not."""

    def test_diff_fault_full_resolve_parity(self, rec):
        faults.install_plan(faults.parse_faults("delta.diff=error@1+"))
        trace = churn_trace(multi_scc_base(), 3, seed=1)
        engine = DeltaEngine(SccVerdictStore(64), device="cpu")
        inc = [engine.check_many([s], backend="python")[0] for s in trace]
        faults.clear_plan()
        scratch = check_many(trace, backend="python", device="cpu")
        for a, b in zip(inc, scratch):
            assert (a.intersects, a.q1, a.q2) == (b.intersects, b.q1, b.q2)
            assert "delta" not in a.cert["provenance"]
        assert delta_counters(rec)["delta.diff_faults"] == len(trace)
        assert len(engine.store) == 0

    def test_fault_then_recovery_reuses(self, rec):
        faults.install_plan(faults.parse_faults("delta.diff=error@1"))
        engine = DeltaEngine(SccVerdictStore(64), device="cpu")
        counting = CountingOracle()
        for _ in range(3):
            engine.check_many([multi_scc_base()], backend=counting)
        assert counting.calls == 2

    def test_backend_error_propagates(self, rec):
        """Divergence from the JAX engine: a sweep.dispatch fault inside the
        incremental solve fails the call (no re-run of the batch), and the
        lease it held is released."""
        engine = DeltaEngine(SccVerdictStore(64), device="cpu")
        data = flat_core()
        plan = faults.install_plan(faults.parse_faults("sweep.dispatch=error"))
        with pytest.raises(FaultInjected) as exc:
            engine.check_many([data], backend=GpuSweepBackend(device="cpu"))
        assert exc.value.point == "sweep.dispatch"
        assert len(plan.fired) == 1  # fired once: the batch did not run again
        counters = delta_counters(rec)
        assert counters.get("delta.errors", 0) == 0 and counters["delta.solves"] == 1
        faults.clear_plan()
        res = engine.check_many([data], backend=GpuSweepBackend(device="cpu"))[0]
        assert res.cert["provenance"]["delta"]["resolved_sccs"] == 1

    def test_store_error_degrades_to_full_resolve(self, rec, monkeypatch):
        """An error of the store (not the backend) degrades, on the same
        device, to the scratch verdicts."""
        engine = DeltaEngine(SccVerdictStore(64), device="cpu")

        def broken(*args, **kwargs):
            raise RuntimeError("store broken")

        monkeypatch.setattr(engine.store, "lease_verdict", broken)
        data = flat_core()
        got = engine.check_many([data], backend=GpuSweepBackend(device="cpu"))[0]
        want = check_many([data], backend=GpuSweepBackend(device="cpu"), device="cpu")[0]
        assert (got.intersects, got.q1, got.q2) == (want.intersects, want.q1, want.q2)
        assert delta_counters(rec)["delta.errors"] == 1
        assert [e["name"] for e in rec.events if e["name"] == "delta.degraded"] == ["delta.degraded"]

    def test_cost_fault_drops_the_cost_not_the_verdict(self, rec):
        engine = DeltaEngine(SccVerdictStore(64), device="cpu")
        base = multi_scc_base()
        cold = engine.check_many([base], backend="python")[0]
        faults.install_plan(faults.parse_faults("cost.attribute=error"))
        res = engine.check_many([base], backend="python")[0]
        assert res.intersects is cold.intersects
        assert "cost" not in res.cert["provenance"]
        assert rec.counters["cost.attribute_errors"] == 1
        faults.clear_plan()
        res = engine.check_many([base], backend="python")[0]
        assert res.cert["provenance"]["cost"]["reused"] is True
        assert res.cert["provenance"]["cost"]["credit_lane_windows"] == 0


class TestStore:
    """LRU bound, occupancy gauge, leases, the shared tier."""

    def test_lru_bound_and_evictions(self, rec):
        store = SccVerdictStore(2)
        for i in range(4):
            store.put_scan(f"fp{i}", SccScan(quorum_local=(0,)))
        assert len(store) == 2
        assert store.get_scan("fp0") is None
        assert store.get_scan("fp3") is not None
        counters, gauges = rec.snapshot()
        assert counters["delta.store_evictions"] == 2
        assert gauges["delta.store_size"] == 2

    def test_env_knob_bounds_store(self, rec, monkeypatch):
        monkeypatch.setenv("QI_DELTA_CACHE_MAX", "3")
        assert SccVerdictStore().max_entries == 3 == jax_delta.SccVerdictStore().max_entries

    def test_lease_cycle(self, rec):
        store = SccVerdictStore(8)
        assert store.lease_verdict("fpX", False) == ("leader", None)
        store.publish_verdict("fpX", False, SccVerdict(intersects=True, q1_local=None, q2_local=None))
        outcome, cached = store.lease_verdict("fpX", False)
        assert outcome == "hit" and cached.intersects is True
        assert store.lease_verdict("fpX", True)[0] == "leader"
        store.publish_verdict("fpX", True, None)
        assert store.lease_verdict("fpX", True)[0] == "leader"

    @pytest.mark.parametrize("leader_fails", [False, True], ids=["publishes", "fails"])
    def test_single_flight_on_two_threads(self, rec, monkeypatch, leader_fails):
        """The follower parks on the leader's lease (ordered through
        ``_delta_sync``, not the clock): a published fragment is composed,
        a failed leader hands the lease over and the follower solves."""
        follower_waiting = threading.Event()
        leader_solving = threading.Event()
        points = []

        def sync(point):
            points.append((threading.current_thread().name, point))
            if point == "store.wait":
                follower_waiting.set()

        monkeypatch.setattr(delta, "_delta_sync", sync)

        def leader_gate():
            if not leader_solving.is_set():
                leader_solving.set()
                assert follower_waiting.wait(10)
                if leader_fails:
                    raise RuntimeError("leader's solve failed")

        counting = CountingOracle(gate=leader_gate)
        store = SccVerdictStore(64)
        out = {}

        def run(name):
            engine = DeltaEngine(store, device="cpu", track_diff=False)
            try:
                out[name] = engine.check_many([multi_scc_base()], backend=counting)[0]
            except RuntimeError as exc:
                out[name] = exc

        leader = threading.Thread(target=run, args=("leader",), name="leader")
        leader.start()
        assert leader_solving.wait(10)
        follower = threading.Thread(target=run, args=("follower",), name="follower")
        follower.start()
        leader.join(20)
        follower.join(20)
        assert not leader.is_alive() and not follower.is_alive()
        assert ("follower", "store.wait") in points
        if leader_fails:
            assert isinstance(out["leader"], RuntimeError)  # propagated, not degraded
            assert counting.calls == 2
            assert out["follower"].cert["provenance"]["delta"]["resolved_sccs"] == 1
            assert points.count(("follower", "store.leader")) == 1
        else:
            assert counting.calls == 1
            assert out["follower"].cert["provenance"]["delta"]["reused_sccs"] == 1
            assert out["follower"].intersects is out["leader"].intersects

    def test_single_flight_under_thread_stress(self, rec, monkeypatch):
        """Sixteen engines on one store, the interpreter switching threads
        as often as it can: exactly one backend solve, every other call a
        composition of the same verdict."""
        import sys

        counting = CountingOracle()
        store = SccVerdictStore(64)
        base = flat_core()
        out, start = [], threading.Barrier(16)

        def run():
            engine = DeltaEngine(store, device="cpu", track_diff=False)
            start.wait(10)
            out.append(engine.check_many([base], backend=counting)[0])

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=run) for _ in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(th.is_alive() for th in threads)
        assert len(out) == 16 and counting.calls == 1
        stamps = sorted(r.cert["provenance"]["delta"]["reused_sccs"] for r in out)
        assert stamps == [0] + [1] * 15 and len({r.intersects for r in out}) == 1
        assert delta_counters(rec)["delta.compositions"] == 15

    @pytest.mark.parametrize("writer", ["jax", "port"])
    @pytest.mark.parametrize("backend", ["python", "gpu-sweep", "gpu-frontier"])
    @pytest.mark.parametrize("trace", ["core", "watchers"])
    def test_fragment_directory_shared_across_packages(self, rec, tmp_path, writer, backend, trace):
        """One package solves the base into a shared directory; a fresh
        engine of the other composes it with no backend call, and its
        certificate passes the checker (on an intersecting base too, whose
        coverage ledger the checker reads)."""
        base = TRACES[trace](0)[0]
        make_port, make_jax = BACKENDS[backend]
        jax_engine = jax_delta.DeltaEngine(jax_delta.SccVerdictStore(64, shared=jax_delta.SharedSccStore(tmp_path)))
        port_engine = DeltaEngine(SccVerdictStore(64, shared=SharedSccStore(tmp_path)), device="cpu")
        if writer == "jax":
            want = jax_engine.check_many([base], backend=make_jax())[0]
            counting = CountingOracle()
            got = port_engine.check_many([base], backend=counting)[0]
            assert counting.calls == 0
        else:
            want = port_engine.check_many([base], backend=make_port())[0]
            got = jax_engine.check_many([base], backend="python")[0]
            assert jax_telemetry.get_run_record().snapshot()[0].get("delta.solves", 0) == 0
        assert got.cert["provenance"]["delta"]["reused_sccs"] == 1
        assert (got.intersects, witness_pair(got)) == (want.intersects, witness_pair(want))
        check_certificate(got.cert, base)
        assert sorted(p.name.split("-")[0] for p in tmp_path.glob("*.json")).count("verdict") == 1

    def test_shared_tier_fault_degrades_to_local(self, rec, tmp_path):
        faults.install_plan(faults.parse_faults("fleet.store=oserror"))
        engine = DeltaEngine(SccVerdictStore(64, shared=SharedSccStore(tmp_path)), device="cpu")
        counting = CountingOracle()
        first = engine.check_many([multi_scc_base()], backend=counting)[0]
        second = engine.check_many([multi_scc_base()], backend=counting)[0]
        assert counting.calls == 1  # the local LRU still serves the repeat
        assert first.intersects is second.intersects
        assert rec.counters["fleet.store_errors"] >= 1
        assert list(tmp_path.glob("*.json")) == []

    def test_forged_fragment_is_a_miss(self, rec, tmp_path):
        shared = SharedSccStore(tmp_path)
        shared.put("verdict", "fpF", {"intersects": "yes", "stats": {}}, scope="s0")
        (tmp_path / "scan-g-fpT.json").write_text("{torn")
        store = SccVerdictStore(8, shared=shared)
        assert store.peek_verdict("fpF", False) is None
        assert store.get_scan("fpT") is None
        assert rec.counters["fleet.store_errors"] == 1

    def test_gc_by_mtime_under_budget(self, rec, tmp_path):
        shared = SharedSccStore(tmp_path, max_mb=300 / (1024 * 1024))
        for i in range(6):
            shared.put("scan", f"fp{i}", {"quorum_local": list(range(20))})
            os.utime(tmp_path / f"scan-g-fp{i}.json", (i, i))
        left = sorted(p.name for p in tmp_path.glob("*.json"))
        assert sum(p.stat().st_size for p in tmp_path.glob("*.json")) <= 300
        assert "scan-g-fp5.json" in left and "scan-g-fp0.json" not in left
        assert rec.counters["delta.store_evictions"] >= 1
