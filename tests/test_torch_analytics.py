"""The analysis modes and the sanitizer in the port on the CPU against the
JAX package.

- ``top_tier`` (the native enumeration and the forced Python path),
  ``minimal_blocking_set``, ``minimum_blocking_size``, ``delete_nodes`` and
  ``minimum_splitting_set`` equal the JAX package's;
- ``--top-tier``, ``--blocking-set``, ``--splitting-set`` print byte for byte
  what the JAX CLI prints, the "no quorum exists" and "not computed" lines
  and the ``--cert-out`` rejection included;
- the sanitizer, both modes and ``--report-dangling``, equals the JAX one;
- ``--seed`` on the host oracles gives the JAX CLI's verdict and witness.

Everything compared is a node list, a count or a line of text: exact
equality.  The snapshot fixtures' analyses take seconds to minutes per
package on the host (a million-call top-tier enumeration, C(21, k) blocking
and splitting searches), so they enter only through the top tier of
``snapshot_broken.json``.  ``_torch_analysis_lines.json`` pins the JAX CLI's
output on the inputs ``chip_smoke.py`` phase ``analysis`` replays on the
card's machine.
"""

import hashlib
import importlib
import io
import json
import pathlib
import sys

import pytest
import torch

from quorum_intersection_tpu import cli as jax_cli
from quorum_intersection_tpu.analytics import resilience as j_res
from quorum_intersection_tpu.analytics import splitting as j_split
from quorum_intersection_tpu.fbas import sanitize as j_san
from quorum_intersection_tpu.fbas.graph import build_graph as jax_build_graph
from quorum_intersection_tpu.fbas.schema import parse_fbas as jax_parse
from quorum_intersection_tpu.pipeline import quorum_bearing_sccs as jax_bearing
from quorum_intersection_tpu_torch import cli
from quorum_intersection_tpu_torch.analytics import resilience, splitting
from quorum_intersection_tpu_torch.analytics import top_tier as tt
from quorum_intersection_tpu_torch.backends.cpp import native_top_tier
from quorum_intersection_tpu_torch.fbas import sanitize, synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.pipeline import quorum_bearing_sccs

from _torch_cases import JSON_FIXTURES, fixture_data

torch.set_num_threads(1)
j_tt = importlib.import_module("quorum_intersection_tpu.analytics.top_tier")

NO_QUORUM = [{"publicKey": f"N{i}", "quorumSet": None} for i in range(3)]
SMALL_FIXTURES = ["trivial_correct.json", "trivial_broken.json", "nested_correct.json", "nested_broken.json"]
SOURCES = {
    **{name: (lambda name=name: fixture_data(name)) for name in SMALL_FIXTURES},
    "majority-4": lambda: synth.majority_fbas(4),
    "majority-5": lambda: synth.majority_fbas(5),
    "hierarchical": lambda: synth.hierarchical_fbas(3, 3),
    **{f"stellar-{seed}": (lambda seed=seed: synth.stellar_like_fbas(5, 3, seed=seed)) for seed in (0, 1)},
    "no-quorum": lambda: NO_QUORUM,
}
# The splitting search solves C(pool, k) reduced networks per package: the
# 15-node stellar cores stay at k <= 1.
SPLIT_K = {"stellar-0": 1, "stellar-1": 1}
LINES = pathlib.Path(__file__).resolve().parent / "_torch_analysis_lines.json"


def _graphs(name):
    data = SOURCES[name]()
    return data, build_graph(parse_fbas(data)), jax_build_graph(jax_parse(data))


@pytest.mark.parametrize("name", list(SOURCES))
def test_quorum_bearing_sccs_and_top_tier_equal_jax(name):
    _, graph, jgraph = _graphs(name)
    bearing = quorum_bearing_sccs(graph)
    assert bearing == jax_bearing(jgraph)
    for _sid, scc in bearing:
        want = j_tt.top_tier(jgraph, scc)
        assert tt.top_tier(graph, scc) == want
        # The Python enumeration, call for call the JAX one's: the same
        # answer, or the same partial count where both pass the budget.
        python = tt.python_top_tier(graph, scc, 5000)
        assert python == j_tt._python_top_tier(jgraph, scc, 5000)
        assert python == want or python[0] is None


def test_top_tier_on_a_snapshot_equals_jax():
    data = fixture_data("snapshot_broken.json")
    graph, jgraph = build_graph(parse_fbas(data)), jax_build_graph(jax_parse(data))
    (_, scc), = quorum_bearing_sccs(graph)
    members, count = tt.top_tier(graph, scc)
    assert (members, count) == j_tt.top_tier(jgraph, scc)
    assert len(members) == 21 and count == 1218
    # The line the CLI prints for it (its format is held to the JAX CLI's
    # by the tests below), pinned for chip_smoke.py phase `analysis`.
    line = f"top tier ({len(members)} nodes, {count} minimal quorums): {' '.join(graph.label(v) for v in members)}\n"
    assert json.loads(LINES.read_text())["analysis"]["snapshot_broken.json --top-tier"] == line


def test_top_tier_budget_and_python_fallback(monkeypatch):
    _, graph, jgraph = _graphs("stellar-0")
    (_, scc), = quorum_bearing_sccs(graph)
    members, count = native_top_tier(graph, scc, 5)
    assert members is None and count == j_tt.top_tier(jgraph, scc, budget_calls=5)[1]
    assert tt.python_top_tier(graph, scc, 5) == j_tt._python_top_tier(jgraph, scc, 5)
    # Without the native library the Python enumeration answers, under the
    # native budget scaled by the port's measured per-call ratio.
    seen = []

    def no_native(*_a, **_k):
        raise RuntimeError("no g++")

    real = tt.python_top_tier
    monkeypatch.setattr("quorum_intersection_tpu_torch.backends.cpp.native_top_tier", no_native)
    monkeypatch.setattr(tt, "python_top_tier", lambda g, s, budget: seen.append(budget) or real(g, s, budget))
    assert tt.top_tier(graph, scc) == j_tt.top_tier(jgraph, scc)
    assert seen == [tt.python_budget(tt.DEFAULT_BUDGET_CALLS)] and 0 < seen[0] < tt.DEFAULT_BUDGET_CALLS


@pytest.mark.parametrize("name", list(SOURCES))
def test_blocking_sets_equal_jax(name):
    _, graph, jgraph = _graphs(name)
    for _sid, scc in quorum_bearing_sccs(graph):
        part = resilience.minimal_blocking_set(graph, scc)
        assert part == j_res.minimal_blocking_set(jgraph, scc)
        assert resilience.is_blocking(graph, scc, part)
        assert (resilience.minimum_blocking_size(graph, scc, upper=len(part))
                == j_res.minimum_blocking_size(jgraph, scc, upper=len(part)))


@pytest.mark.parametrize("name", list(SOURCES))
def test_splitting_sets_equal_jax(name):
    data, graph, _ = _graphs(name)
    pool = splitting.quorum_scc_keys(data)
    assert pool == j_split.quorum_scc_keys(data)
    for removed in ([], pool[:1], pool[1:3], pool):
        assert splitting.delete_nodes(data, removed) == j_split.delete_nodes(data, removed)
    k = SPLIT_K.get(name, 2)
    assert (splitting.minimum_splitting_set(data, max_k=k, pool=pool)
            == j_split.minimum_splitting_set(data, max_k=k, pool=pool))


def _run(main, argv, text, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    code = main(argv)
    captured = capsys.readouterr()
    return captured.out, captured.err, code


MODES = [["--top-tier", "--compat"], ["--blocking-set", "--dangling-policy", "alias0"],
         ["--splitting-set", "--splitting-max-k", "1"]]


@pytest.mark.parametrize("name", list(SOURCES))
def test_cli_analysis_modes_equal_jax(name, monkeypatch, capsys):
    text = json.dumps(SOURCES[name]())
    for flags in MODES:
        got = _run(cli.main, flags + ["--device", "cpu"], text, monkeypatch, capsys)
        want = _run(jax_cli.main, flags, text, monkeypatch, capsys)
        assert got[0] == want[0] and got[2] == want[2] == 0, flags


def test_cli_not_computed_lines_equal_jax(monkeypatch, capsys):
    # Past the exact-search and candidate-pool caps (22): a 24-node majority.
    text = json.dumps(synth.majority_fbas(24))
    for flags in (["--blocking-set"], ["--splitting-set"]):
        got = _run(cli.main, flags, text, monkeypatch, capsys)
        assert got[0] == _run(jax_cli.main, flags, text, monkeypatch, capsys)[0]
        assert "not computed" in got[0]
    # A top-tier enumeration past its budget, in both packages.
    text = json.dumps(synth.stellar_like_fbas(5, 3))
    for module in (tt, j_tt):
        real = module.top_tier
        monkeypatch.setattr(module, "top_tier", lambda g, s, budget_calls=0, real=real: real(g, s, 5))
    got = _run(cli.main, ["--top-tier"], text, monkeypatch, capsys)
    assert got[0] == _run(jax_cli.main, ["--top-tier"], text, monkeypatch, capsys)[0]
    assert got[0].startswith("top tier: not computed")


def test_cli_rejects_cert_out_in_analysis_modes(tmp_path, monkeypatch, capsys):
    text = json.dumps(fixture_data("trivial_correct.json"))
    for mode in ("-p", "--top-tier", "--blocking-set", "--splitting-set"):
        argv = [mode, "--cert-out", str(tmp_path / "c.json")]
        got = _run(cli.main, argv, text, monkeypatch, capsys)
        assert got == _run(jax_cli.main, argv, text, monkeypatch, capsys)
        assert got[2] == 1 and "--cert-out applies to verdict mode only" in got[1]
    assert not (tmp_path / "c.json").exists()


@pytest.mark.parametrize("name", ["trivial_broken.json", "nested_broken.json", "snapshot_broken.json"])
@pytest.mark.parametrize("backend", ["python", "cpp"])
def test_cli_seed_gives_the_jax_verdict_and_witness(name, backend, monkeypatch, capsys):
    text = json.dumps(fixture_data(name))
    for flags in (["--seed", "3"], ["--seed", "3", "-v"], ["--randomized", "--seed", "11"]):
        argv = ["--backend", backend, *flags]
        got = _run(cli.main, argv + ["--device", "cpu"], text, monkeypatch, capsys)
        want = _run(jax_cli.main, argv, text, monkeypatch, capsys)
        assert (got[0], got[2]) == (want[0], want[2]) and got[2] == 1


SANITIZE_INPUTS = {
    **{name: (lambda name=name: fixture_data(name)) for name in JSON_FIXTURES},
    "insane": lambda: [
        {"publicKey": "A", "quorumSet": {"threshold": 3, "validators": ["A", "B"]}},
        {"publicKey": "B", "quorumSet": {"threshold": 1, "validators": ["A"],
                                         "innerQuorumSets": [{"threshold": 4, "validators": ["C"]}]}},
        {"publicKey": "C", "quorumSet": {"threshold": 0, "validators": ["GONE"]}},
        {"publicKey": "D", "quorumSet": {"threshold": "2", "validators": ["A", "C"]}},
        {"publicKey": "E", "quorumSet": None},
    ],
}


@pytest.mark.parametrize("name", list(SANITIZE_INPUTS))
def test_sanitizer_equals_jax(name, monkeypatch, capsys):
    data = SANITIZE_INPUTS[name]()
    for kw in ({}, {"compat": True}, {"flag_zero_threshold": True}):
        assert sanitize.sanitize(data, **kw) == j_san.sanitize(data, **kw)
    assert sanitize.dangling_refs(data) == j_san.dangling_refs(data)
    text = json.dumps(data)
    for flags in ([], ["--compat"], ["--report-dangling"], ["--flag-zero-threshold", "--report-dangling"]):
        got = _run(sanitize.main, flags, text, monkeypatch, capsys)
        assert got == _run(j_san.main, flags, text, monkeypatch, capsys)


def test_sanitizer_rejects_malformed_input_like_jax(monkeypatch, capsys):
    for text in ("{not json", json.dumps({"nodes": []})):
        got = _run(sanitize.main, [], text, monkeypatch, capsys)
        assert got == _run(j_san.main, [], text, monkeypatch, capsys) and got[2] == 1


# What chip_smoke.py phase `analysis` replays on the card's machine: the
# analysis modes' lines and the sanitizer's output digests, by input.
PINNED_SOURCES = {
    **{name: (lambda name=name: fixture_data(name)) for name in SMALL_FIXTURES},
    "majority_fbas(5)": lambda: synth.majority_fbas(5),
    "stellar_like_fbas(5,3,seed=0)": lambda: synth.stellar_like_fbas(5, 3, seed=0),
}
PINNED_MODES = ["--top-tier", "--blocking-set", "--splitting-set"]
SANITIZE_FLAGS = [[], ["--compat"], ["--report-dangling"]]


def _pinned_lines(main, monkeypatch, capsys):
    return {f"{name} {mode}": _run(main, [mode], json.dumps(src()), monkeypatch, capsys)[0]
            for name, src in PINNED_SOURCES.items() for mode in PINNED_MODES}


def _sanitized(main, monkeypatch, capsys):
    out = {}
    for name in JSON_FIXTURES + ["dump_scale_correct.json.gz"]:
        text = json.dumps(fixture_data(name))
        for flags in SANITIZE_FLAGS:
            stdout, stderr, code = _run(main, flags, text, monkeypatch, capsys)
            out[" ".join([name, *flags])] = {"stdout_sha256": hashlib.sha256(stdout.encode()).hexdigest(),
                                             "stderr": stderr, "exit": code}
    return out


def test_pinned_lines_are_the_jax_clis(monkeypatch, capsys):
    pinned = json.loads(LINES.read_text())
    snapshot = pinned["analysis"].pop("snapshot_broken.json --top-tier")
    assert snapshot.startswith("top tier (21 nodes, 1218 minimal quorums): ")
    assert pinned["analysis"] == _pinned_lines(jax_cli.main, monkeypatch, capsys)
    assert pinned["sanitize"] == _sanitized(j_san.main, monkeypatch, capsys)
    # The port's sanitizer here; its analysis lines are held to the JAX
    # CLI's above (test_cli_analysis_modes_equal_jax) and on the card.
    assert pinned["sanitize"] == _sanitized(sanitize.main, monkeypatch, capsys)
