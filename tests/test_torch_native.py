"""The port's native host layer against the JAX package's: the per-SCC
quorum scan (``native_scc_scan``), the per-candidate check
(``native_candidate_check``), and the pipeline's Python scan, which no
entry point of the port routes to the native one.

Everything compared is a node list or an integer: exact equality.
"""

import json

import numpy as np
import pytest
import torch

from quorum_intersection_tpu.backends.cpp import native_candidate_check as jax_candidate_check
from quorum_intersection_tpu.backends.cpp import native_scc_scan as jax_scan
from quorum_intersection_tpu.fbas import synth as jax_synth
from quorum_intersection_tpu.fbas.graph import build_graph as jax_build_graph
from quorum_intersection_tpu.fbas.graph import group_sccs as jax_group_sccs
from quorum_intersection_tpu.fbas.graph import tarjan_scc as jax_tarjan
from quorum_intersection_tpu.fbas.schema import parse_fbas as jax_parse
from quorum_intersection_tpu.pipeline import scan_scc_quorums as jax_python_scan
from quorum_intersection_tpu_torch import pipeline
from quorum_intersection_tpu_torch.backends import cpp
from quorum_intersection_tpu_torch.delta import DeltaEngine, SccVerdictStore
from quorum_intersection_tpu_torch.fbas.graph import build_graph, group_sccs, tarjan_scc
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.utils import telemetry

from _torch_cases import fixture_data

torch.set_num_threads(1)

SCAN_CASES = {
    "trivial_correct": lambda: fixture_data("trivial_correct.json"),
    "trivial_broken": lambda: fixture_data("trivial_broken.json"),
    "nested_correct": lambda: fixture_data("nested_correct.json"),
    "nested_broken": lambda: fixture_data("nested_broken.json"),
    "snapshot_correct": lambda: fixture_data("snapshot_correct.json"),
    "snapshot_broken": lambda: fixture_data("snapshot_broken.json"),
    "dump_scale_correct": lambda: fixture_data("dump_scale_correct.json.gz"),
    "stellar:0": lambda: jax_synth.stellar_like_fbas(5, 3, n_watchers=40, seed=0),
    "stellar-broken:1": lambda: jax_synth.stellar_like_fbas(5, 3, n_watchers=40, seed=1, broken=True),
    "stellar-nulls:2": lambda: jax_synth.stellar_like_fbas(4, 3, n_watchers=60, n_null=9, n_dangling=5, seed=2),
    "random:3": lambda: jax_synth.random_fbas(24, seed=3),
    "bench-nested:4": lambda: jax_synth.benchmark_fbas(48, 9, nested_watchers=True, seed=4),
    "hier:5": lambda: jax_synth.hierarchical_fbas(3, 3, broken=True),
}


def _graphs(name):
    data = json.dumps(SCAN_CASES[name]())
    return build_graph(parse_fbas(data)), jax_build_graph(jax_parse(data))


def _sccs(graph):
    count, comp = tarjan_scc(graph.n, graph.succ)
    return group_sccs(graph.n, comp, count)


@pytest.fixture
def record():
    rec = telemetry.reset_run_record()
    yield rec
    telemetry.reset_run_record()


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_native_scan_equals_the_jax_scan_and_the_python_loop(name, record):
    graph, jgraph = _graphs(name)
    sccs = _sccs(graph)
    count, comp = jax_tarjan(jgraph.n, jgraph.succ)
    assert jax_group_sccs(jgraph.n, comp, count) == sccs
    got = cpp.native_scc_scan(graph, sccs)
    assert got == jax_scan(jgraph, sccs)
    assert got == pipeline.scan_scc_quorums(graph, sccs)
    assert record.counters["native.scan_fixpoints"] == len(sccs)
    assert record.counters["native.scan_seconds"] >= 0


CHECK_CASES = ["nested_correct", "snapshot_correct", "snapshot_broken", "stellar-broken:1", "random:3", "hier:5"]


@pytest.mark.parametrize("name", CHECK_CASES)
def test_native_candidate_check_hits_equal_the_jax_functions(name):
    graph, jgraph = _graphs(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    masks = rng.integers(0, 2, size=(257, graph.n), dtype=np.uint8)
    # A few dense rows too: the complement probe must find its quorum.
    masks[:8] = rng.random((8, graph.n)) < 0.9
    hits, seconds = cpp.native_candidate_check(graph, masks)
    want, _ = jax_candidate_check(jgraph, masks)
    assert hits == want and seconds >= 0
    assert cpp.native_candidate_rate(graph, masks) > 0


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_python_scan_equals_the_jax_python_loop_in_any_order(name, record):
    # One availability row serves every SCC: the scan in reverse order gives
    # each SCC the same quorum, so nothing is left set between SCCs.
    graph, jgraph = _graphs(name)
    sccs = _sccs(graph)
    got = pipeline.scan_scc_quorums(graph, sccs)
    assert got == jax_python_scan(jgraph, sccs, allow_native=False)
    assert pipeline.scan_scc_quorums(graph, sccs[::-1]) == got[::-1]
    assert "native.scan_fixpoints" not in record.counters


def _sources():
    return [json.dumps(fixture_data(name)) for name in ("snapshot_broken.json", "nested_correct.json")]


ENTRY_POINTS = {
    "solve": lambda backend: [pipeline.solve(src, backend=backend, device="cpu") for src in _sources()],
    "check_many": lambda backend: pipeline.check_many(_sources(), backend=backend, device="cpu"),
    "delta": lambda backend: DeltaEngine(SccVerdictStore(), device="cpu").check_many(_sources(), backend=backend),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
@pytest.mark.parametrize("backend", ["python", "cpp", "auto"])
def test_no_entry_point_scans_natively(entry, backend, record):
    results = ENTRY_POINTS[entry](backend)
    assert [r.intersects for r in results] == [False, True]
    counters = telemetry.get_run_record().counters
    assert "native.scan_fixpoints" not in counters and "native.scan_seconds" not in counters
