"""The port's typed queries (``query.py``) on the CPU, against the JAX
package's, with the same inputs:

- the parse cases of ``tests/test_qi_query.py`` (``TestQueryParse``), and the
  port's wire forms and fingerprints equal to the JAX ones;
- ``relaxed``: the vectorized search against the host oracle and a stdlib
  subset oracle, the two-circuit restriction against the JAX one, and the
  result (verdict, reason, witness, windows enumerated) equal to the JAX
  query's;
- ``whatif``: the verdict table against sequential solves, packed against
  unpacked, and equal to the JAX query's (the delta-aware frontier is not
  ported);
- ``analytics``: every metric's result equal to the JAX query's, the proofs
  re-proved and forgeries refused;
- the ``query.dispatch`` fault, the cancel token, the two-family preset, and
  the ``query`` subcommand's lines and exit codes against the JAX one's.

Every certificate goes through the unmodified ``tools/check_cert.py``.  All
results compare exactly.
"""

import io
import json

import numpy as np
import pytest
import torch

from quorum_intersection_tpu import query as jax_query
from quorum_intersection_tpu.encode import circuit as jax_circuit
from quorum_intersection_tpu.fbas import graph as jax_graph
from quorum_intersection_tpu.fbas import schema as jax_schema
from quorum_intersection_tpu.fbas import synth as jax_synth
from quorum_intersection_tpu.utils import faults as jax_faults
from quorum_intersection_tpu.utils import telemetry as jax_telemetry
from quorum_intersection_tpu_torch import cli
from quorum_intersection_tpu_torch.backends.base import CancelToken, SearchCancelled
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
from quorum_intersection_tpu_torch.encode.circuit import encode_circuit, max_quorum_np, restrict_two_family
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.fbas.semantics import (
    cross_family_disjoint_quorum,
    max_quorum,
    relaxed_disjoint_witness,
)
from quorum_intersection_tpu_torch.pipeline import quorum_bearing_sccs, solve
from quorum_intersection_tpu_torch.query import Query, QueryEngine, QueryError, _relaxed_search, mask_nodes
from quorum_intersection_tpu_torch.utils import faults, telemetry
from tools.check_cert import CheckFailure, check_certificate

from _torch_cases import fixture_data

torch.set_num_threads(1)

FIXTURE_PAIRS = [("trivial_correct", True), ("trivial_broken", False), ("nested_correct", True),
                 ("nested_broken", False)]


def nodes_of(name):
    return fixture_data(f"{name}.json")


def roundtrip(obj):
    return json.loads(json.dumps(obj, default=str))


def engine(**kw):
    kw.setdefault("backend", "python")
    return QueryEngine(device="cpu", **kw)


@pytest.fixture(autouse=True)
def rec():
    faults.clear_plan()
    jax_faults.clear_plan()
    record = telemetry.reset_run_record()
    jax_telemetry.reset_run_record()
    yield record
    faults.clear_plan()
    telemetry.reset_run_record()
    jax_telemetry.reset_run_record()


def subset_oracle(nodes_a, nodes_b):
    """Stdlib relaxed oracle over the whole node set: a disjoint cross-family
    pair exists iff some split S of the vertices holds a family-A quorum
    inside S and a family-B quorum inside its complement."""
    ga, gb = build_graph(parse_fbas(nodes_a)), build_graph(parse_fbas(nodes_b))
    n = ga.n
    for window in range(1, 1 << n):
        chosen = [v for v in range(n) if window >> v & 1]
        avail = [v in set(chosen) for v in range(n)]
        qa = max_quorum(ga, chosen, avail)
        if not qa:
            continue
        rest = [v for v in range(n) if v not in set(qa)]
        if max_quorum(gb, rest, [v in set(rest) for v in range(n)]):
            return False
    return True


def jax_result(nodes, raw, **kw):
    """The JAX package's answer to the same query."""
    out = jax_query.QueryEngine(backend=kw.pop("backend", "python"), **kw).resolve(nodes, jax_query.Query.parse(raw))
    return out


def comparable(result):
    """A result without its embedded certificates (their provenance names
    each package's engine and run)."""
    return {k: v for k, v in result.items() if k != "failing_cert"}


class TestQueryParse:
    def test_absent_is_intersection(self):
        q = Query.parse(None)
        assert q.kind == "intersection" and q.fingerprint() == "" and q.to_wire() is None

    @pytest.mark.parametrize("raw,code", [
        ({"kind": "bogus"}, "unknown_query"),
        ({"kind": "relaxed"}, "invalid_query"),
        ({"kind": "whatif", "max_k": 0}, "invalid_query"),
        ({"kind": "whatif", "max_k": True}, "invalid_query"),
        ({"kind": "analytics", "metric": "nope"}, "unknown_query"),
        ({"kind": "whatif", "candidates": [3]}, "invalid_query"),
        ([1], "invalid_query"),
    ])
    def test_malformed_is_typed_as_in_jax(self, raw, code):
        with pytest.raises(QueryError) as exc:
            Query.parse(raw)
        with pytest.raises(jax_query.QueryError) as jax_exc:
            jax_query.Query.parse(raw)
        assert exc.value.code == jax_exc.value.code == code
        assert str(exc.value) == str(jax_exc.value)

    def test_wire_and_fingerprints_equal_the_jax_ones(self):
        fa, fb = synth.two_family_preset(core=4, watchers=0)
        raws = [{"kind": "relaxed", "family_b": fb}, {"kind": "whatif", "max_k": 2, "candidates": ["TFC0000"]},
                {"kind": "whatif", "max_k": 1}, {"kind": "analytics", "metric": "splitting_set", "splitting_max_k": 1},
                {"kind": "analytics", "metric": "pagerank"}, {"kind": "analytics", "metric": "top_tier"}, None]
        fps = set()
        for raw in raws:
            q, jq = Query.parse(raw), jax_query.Query.parse(raw)
            assert q.to_wire() == jq.to_wire()
            assert q.fingerprint() == jq.fingerprint()
            assert Query.parse(roundtrip(q.to_wire())) == q
            fps.add(q.fingerprint())
        assert len(fps) == len(raws)  # never crossing kinds


class TestRelaxed:
    @pytest.mark.parametrize("broken", [False, True])
    def test_preset_vs_subset_oracle_and_jax(self, broken):
        fa, fb = synth.two_family_preset(core=8, watchers=3, broken=broken, seed=7)
        raw = {"kind": "relaxed", "family_b": fb}
        out = engine().resolve(fa, Query.parse(raw))
        assert out.verdict == subset_oracle(fa, fb) == (not broken)
        assert out.result == jax_result(fa, raw).result
        check_certificate(roundtrip(out.cert), fa)
        if not out.verdict:
            wit = out.result["witness"]
            assert not set(wit["family_a"]) & set(wit["family_b"])

    @pytest.mark.parametrize("fixture,verdict", FIXTURE_PAIRS)
    def test_self_family_matches_intersection(self, fixture, verdict):
        nodes = nodes_of(fixture)
        raw = {"kind": "relaxed", "family_b": nodes}
        out = engine().resolve(nodes, Query.parse(raw))
        assert out.verdict is verdict
        assert out.result == jax_result(nodes, raw).result
        check_certificate(roundtrip(out.cert), nodes)

    @pytest.mark.parametrize("broken", [False, True])
    def test_vectorized_matches_host_oracle_and_jax(self, broken):
        fa, fb = synth.two_family_preset(core=7, watchers=2, broken=broken, seed=11)
        ga, gb = build_graph(parse_fbas(fa)), build_graph(parse_fbas(fb))
        (_sid, members), = quorum_bearing_sccs(ga)
        qa_v, qb_v, enum_v, _ = _relaxed_search(ga, gb, members)
        qa_h, qb_h, enum_h = relaxed_disjoint_witness(ga, gb, members)
        jga = jax_graph.build_graph(jax_schema.parse_fbas(fa))
        jgb = jax_graph.build_graph(jax_schema.parse_fbas(fb))
        assert (qa_v, qb_v, enum_v) == jax_query._relaxed_search(jga, jgb, members)[:3]
        assert enum_v == enum_h and qa_v == qa_h
        if qb_v is not None:
            assert not set(qa_v) & set(qb_v) and cross_family_disjoint_quorum(gb, qa_v)

    def test_two_circuit_restriction_equals_the_jax_one(self):
        fa, fb = synth.two_family_preset(core=6, watchers=2, seed=3)
        ga, gb = build_graph(parse_fbas(fa)), build_graph(parse_fbas(fb))
        (_sid, members), = quorum_bearing_sccs(ga)
        port = restrict_two_family(encode_circuit(ga), encode_circuit(gb), members)
        jga = jax_graph.build_graph(jax_schema.parse_fbas(fa))
        jgb = jax_graph.build_graph(jax_schema.parse_fbas(fb))
        want = jax_circuit.restrict_two_family(jax_circuit.encode_circuit(jga), jax_circuit.encode_circuit(jgb),
                                               members)
        for got, exp in zip(port, want):
            for field in ("thresholds", "members", "child", "unit_depth"):
                np.testing.assert_array_equal(getattr(got, field), getattr(exp, field))
        m = len(members)
        masks = np.zeros((m * m, m), dtype=bool)
        for k, (i, j) in enumerate((i, j) for i in range(m) for j in range(m)):
            masks[k, [i, j]] = True
        for circ, graph in ((port[0], ga), (port[1], gb)):
            for row, mask in zip(max_quorum_np(circ, masks), masks):
                chosen = [members[i] for i in range(m) if mask[i]]
                host = max_quorum(graph, chosen, [v in set(chosen) for v in range(graph.n)])
                assert sorted(members[i] for i in range(m) if row[i]) == sorted(host)
        with pytest.raises(ValueError):
            restrict_two_family(encode_circuit(ga), encode_circuit(build_graph(parse_fbas(synth.majority_fbas(3)))),
                                members)

    def test_mismatched_node_set_typed(self):
        fa, _fb = synth.two_family_preset(core=4, watchers=0)
        with pytest.raises(QueryError) as exc:
            engine().resolve(fa, Query.parse({"kind": "relaxed",
                                              "family_b": synth.majority_fbas(4, prefix="OTHER")}))
        assert exc.value.code == "invalid_query"

    def test_forged_relaxed_witness_rejected(self):
        fa, fb = synth.two_family_preset(core=8, watchers=3, broken=True, seed=7)
        out = engine().resolve(fa, Query.parse({"kind": "relaxed", "family_b": fb}))
        bad = roundtrip(out.cert)
        bad["witness"]["q2"] = bad["witness"]["q1"]
        with pytest.raises(CheckFailure):
            check_certificate(bad, fa)


class TestWhatif:
    def test_table_vs_sequential_oracle_and_jax(self):
        base = synth.majority_fbas(5, prefix="WIF")
        raw = {"kind": "whatif", "max_k": 3}
        out = engine().resolve(base, Query.parse(raw))
        assert out.result["table"][0]["removed"] == []
        for row in out.result["table"]:
            assert row["verdict"] is solve(mask_nodes(base, row["removed"]), backend="python").intersects
        assert out.verdict is False and len(out.result["minimal_failing"]) == 3
        assert comparable(out.result) == comparable(jax_result(base, raw).result)
        check_certificate(roundtrip(out.cert), base)
        check_certificate(roundtrip(out.result["failing_cert"]), mask_nodes(base, out.result["minimal_failing"]))

    def test_packed_vs_sequential_on_the_sweep(self):
        base = synth.majority_fbas(6, prefix="WIP")
        q = Query.parse({"kind": "whatif", "max_k": 2})
        tables = {}
        for pack in (True, False):
            out = engine(backend=GpuSweepBackend(device="cpu", batch=256), pack=pack).resolve(base, q)
            tables[pack] = json.dumps({"table": out.result["table"], "minimal_failing": out.result["minimal_failing"],
                                       "verdict": out.verdict}, sort_keys=True)
            check_certificate(roundtrip(out.cert), base)
        oracle = engine().resolve(base, q)
        assert tables[True] == tables[False] == json.dumps(
            {"table": oracle.result["table"], "minimal_failing": oracle.result["minimal_failing"],
             "verdict": oracle.verdict}, sort_keys=True)

    def test_gpu_sweep_packs_the_variants(self, rec):
        base = fixture_data("nested_correct.json")
        raw = {"kind": "whatif", "max_k": 1, "candidates": ["ORG0N0000", "ORG1N0001", "ORG2N0002"]}
        out = engine(backend="gpu-sweep").resolve(base, Query.parse(raw))
        assert comparable(out.result) == comparable(jax_result(base, raw).result)
        assert "sweep.pack" in {sp.name for sp in rec.spans}
        assert rec.counters["query.whatif_variants"] == 4

    def test_unknown_candidate_typed(self):
        with pytest.raises(QueryError) as exc:
            engine().resolve(synth.majority_fbas(5, prefix="WIF"),
                             Query.parse({"kind": "whatif", "candidates": ["GHOST"]}))
        assert exc.value.code == "invalid_query"

    def test_frontier_truncation_is_loud(self, monkeypatch):
        base = synth.majority_fbas(9, prefix="WIT")
        out = engine(whatif_limit=5).resolve(base, Query.parse({"kind": "whatif", "max_k": 2}))
        assert out.result["truncated"] is True and out.result["variants"] == 5
        monkeypatch.setenv("QI_QUERY_WHATIF_LIMIT", "7")
        out = engine().resolve(base, Query.parse({"kind": "whatif", "max_k": 2}))
        assert out.result["variants"] == 7


class TestAnalytics:
    @pytest.mark.parametrize("metric", ["top_tier", "blocking_set", "splitting_set", "pagerank"])
    @pytest.mark.parametrize("source", ["nested_correct", "trivial_broken", "majority7"])
    def test_result_equals_the_jax_querys(self, metric, source):
        nodes = synth.majority_fbas(7, prefix="ABQ") if source == "majority7" else nodes_of(source)
        raw = {"kind": "analytics", "metric": metric, "splitting_max_k": 2}
        out = engine().resolve(nodes, Query.parse(raw))
        want = jax_result(nodes, raw)
        assert out.verdict is want.verdict is True
        assert out.result == want.result
        assert out.cert["result_digest"] == want.cert["result_digest"]
        notes = check_certificate(roundtrip(out.cert), nodes)
        if metric in ("blocking_set", "splitting_set") and "proof" in out.cert:
            claim = {"blocking_set": "blocking-halts", "splitting_set": "splitting-witness"}[metric]
            assert any(claim in n for n in notes)

    def test_forged_proofs_rejected(self):
        base = synth.majority_fbas(7, prefix="ABF")
        bad = roundtrip(engine().resolve(base, Query.parse({"kind": "analytics", "metric": "blocking_set"})).cert)
        bad["proof"]["nodes"] = base
        with pytest.raises(CheckFailure):
            check_certificate(bad, base)
        base = synth.majority_fbas(5, prefix="ASF")
        bad = roundtrip(engine().resolve(base, Query.parse({"kind": "analytics", "metric": "splitting_set"})).cert)
        bad["proof"]["nodes"] = synth.majority_fbas(len(bad["proof"]["nodes"]), broken=True, prefix="FRG")
        with pytest.raises(CheckFailure):
            check_certificate(bad, base)

    def test_splitting_pool_overbudget_typed(self):
        with pytest.raises(QueryError) as exc:
            engine().resolve(synth.majority_fbas(24, prefix="POOL"),
                             Query.parse({"kind": "analytics", "metric": "splitting_set"}))
        assert exc.value.code == "query_overbudget"


class TestDispatchFault:
    def test_fault_degrades_typed_never_wrong(self, rec):
        fa, fb = synth.two_family_preset(core=6, watchers=0, seed=1)
        eng = engine()
        q = Query.parse({"kind": "relaxed", "family_b": fb})
        faults.install_plan(faults.FaultPlan([faults.FaultRule(point="query.dispatch", mode="error", first=1,
                                                               every=False)]))
        with pytest.raises(QueryError) as exc:
            eng.resolve(fa, q)
        assert exc.value.code == "query_degraded"
        assert eng.resolve(fa, q).verdict is True
        assert rec.counters["query.errors"] == 1
        assert [e["name"] for e in rec.events if e["name"].startswith("query.")] == [
            "query.degraded", "query.relaxed_resolved", "query.dispatched"]

    def test_cancel_token_stops_relaxed_and_analytics(self):
        fa, fb = synth.two_family_preset(core=8, watchers=2, seed=6)
        cancel = CancelToken()
        cancel.cancel()
        with pytest.raises(SearchCancelled):
            engine().resolve(fa, Query.parse({"kind": "relaxed", "family_b": fb}), cancel=cancel)
        with pytest.raises(SearchCancelled):
            engine().resolve(fa, Query.parse({"kind": "analytics", "metric": "top_tier"}), cancel=cancel)

    def test_intersection_path_never_routes_through_dispatch(self):
        faults.install_plan(faults.FaultPlan([faults.FaultRule(point="query.dispatch", mode="error")]))
        out = engine().resolve(synth.majority_fbas(5, prefix="FLT"), Query.parse(None))
        assert out.verdict is True and out.cert["verdict"] is True


class TestTwoFamilyPreset:
    @pytest.mark.parametrize("kwargs", [{}, {"core": 8, "watchers": 4, "seed": 5},
                                        {"core": 9, "watchers": 3, "broken": True}])
    def test_same_json_as_jax(self, kwargs):
        assert json.dumps(synth.two_family_preset(**kwargs)) == json.dumps(jax_synth.two_family_preset(**kwargs))

    def test_broken_invisible_to_family_a(self):
        fa, fb = synth.two_family_preset(core=9, watchers=3, broken=True, seed=0)
        assert solve(fa, backend="python").intersects is True
        assert engine().resolve(fa, Query.parse({"kind": "relaxed", "family_b": fb})).verdict is False


def _run_query(main, argv, text, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO(text))
    code = main(argv)
    return capsys.readouterr().out, code


@pytest.mark.parametrize("argv", [
    ["--kind", "analytics", "--metric", "top_tier"],
    ["--kind", "analytics", "--metric", "splitting_set", "--splitting-max-k", "1"],
    ["--kind", "analytics", "--metric", "pagerank"],
    ["--kind", "whatif", "--max-k", "2", "--remove", "ORG0N0000", "--remove", "ORG1N0000", "--remove", "ORG2N0001"],
    ["--kind", "relaxed", "--family-b", "FAMILY_B"],
    ["--kind", "analytics"],
])
def test_query_subcommand_lines_equal_the_jax_ones(argv, tmp_path, monkeypatch, capsys):
    from quorum_intersection_tpu import cli as jax_cli

    text = json.dumps(fixture_data("nested_correct.json"))
    if "FAMILY_B" in argv:
        fb = tmp_path / "fb.json"
        fb.write_text(text)
        argv = [str(fb) if a == "FAMILY_B" else a for a in argv]
    cert = tmp_path / "q.json"
    got, code = _run_query(cli.main, ["query", *argv, "--device", "cpu", "--backend", "python",
                                      "--cert-out", str(cert)], text, monkeypatch, capsys)
    want, jax_code = _run_query(jax_cli.main, ["query", *argv, "--backend", "python"], text, monkeypatch, capsys)
    line, jax_line = json.loads(got), json.loads(want)
    if "result" in line:
        line["result"], jax_line["result"] = comparable(line["result"]), comparable(jax_line["result"])
    assert (line, code) == (jax_line, jax_code)
    if cert.exists():
        check_certificate(json.loads(cert.read_text()), json.loads(text))
