"""Shared inputs for the ``test_torch_*`` differential tests: the same FBAS
data through both packages, with the sweep's problem set-up (quorum-bearing
SCC, restriction, decode rows) built the way each package's sweep backend builds it.
"""

from __future__ import annotations

import gzip
import json
import pathlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from quorum_intersection_tpu.encode.circuit import encode_circuit as jax_encode
from quorum_intersection_tpu.encode.circuit import restrict_circuit_pair as jax_restrict
from quorum_intersection_tpu.fbas.graph import build_graph as jax_build_graph
from quorum_intersection_tpu.fbas.schema import parse_fbas as jax_parse
from quorum_intersection_tpu.fbas import synth as jax_synth
from quorum_intersection_tpu_torch.encode.circuit import encode_circuit, restrict_circuit_pair
from quorum_intersection_tpu_torch.fbas.graph import build_graph, group_sccs, tarjan_scc
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.fbas.semantics import max_quorum

FIXTURES = pathlib.Path(__file__).resolve().parent.parent / "fixtures"
JSON_FIXTURES = [
    "trivial_correct.json",
    "trivial_broken.json",
    "nested_correct.json",
    "nested_broken.json",
    "snapshot_correct.json",
    "snapshot_broken.json",
]


def fixture_data(name: str) -> list:
    raw = (FIXTURES / name).read_bytes()
    if name.endswith(".gz"):
        raw = gzip.decompress(raw)
    return json.loads(raw)


def manifest() -> Dict[str, dict]:
    return json.loads((FIXTURES / "MANIFEST.json").read_text())


def synth_data(kind: str, seed: int = 0) -> list:
    """Seeded synthetic networks, from the JAX package's generators (the
    port's copies are held to them in test_torch_convert)."""
    if kind == "maj5":
        return jax_synth.majority_fbas(5)
    if kind == "maj6-broken":
        return jax_synth.majority_fbas(6, broken=True)
    if kind == "bench":
        return jax_synth.benchmark_fbas(40, 8, seed=seed)
    if kind == "bench-broken":
        return jax_synth.benchmark_fbas(40, 8, broken=True, seed=seed)
    if kind == "bench-nested":
        return jax_synth.benchmark_fbas(48, 9, nested_watchers=True, seed=seed)
    if kind == "bench-nested-broken":
        return jax_synth.benchmark_fbas(48, 9, nested_watchers=True, broken=True, seed=seed)
    raise ValueError(kind)


# 18 seeded circuits: the six JSON fixtures plus synthetic networks.
CASES = JSON_FIXTURES + [
    "maj5",
    "maj6-broken",
    "bench:0",
    "bench:1",
    "bench-broken:0",
    "bench-broken:1",
    "bench-nested:0",
    "bench-nested:1",
    "bench-nested-broken:0",
    "bench-nested-broken:1",
    "bench-nested:2",
    "bench-nested-broken:2",
]


def case_data(case: str) -> list:
    if case.endswith(".json"):
        return fixture_data(case)
    kind, _, seed = case.partition(":")
    return synth_data(kind, int(seed or 0))


@dataclass
class SweepCase:
    """One sweep problem in both packages' types."""

    jax_circuit: object  # quorum_intersection_tpu Circuit (whole graph)
    circuit: object  # port Circuit (whole graph)
    scc: List[int]
    # restricted pair (None when the SCC is the whole graph)
    jax_pair: Optional[tuple]
    pair: Optional[tuple]


def sweep_case(case: str) -> SweepCase:
    data = case_data(case)
    graph = build_graph(parse_fbas(data))
    jax_graph = jax_build_graph(jax_parse(data))
    count, comp = tarjan_scc(graph.n, graph.succ)
    sccs = group_sccs(graph.n, comp, count)
    scc = next(
        m for m in sccs if max_quorum(graph, m, [v in set(m) for v in range(graph.n)])
    )
    circuit = encode_circuit(graph)
    jax_circuit = jax_encode(jax_graph)
    pair = jax_pair = None
    if circuit.n > len(scc):
        pair = restrict_circuit_pair(circuit, scc)
        jax_pair = jax_restrict(jax_circuit, scc)
    return SweepCase(jax_circuit, circuit, scc, jax_pair, pair)


def rng_rows(seed: int, rows: int, n: int, density: float = 0.6) -> np.ndarray:
    return (np.random.default_rng(seed).random((rows, n)) < density).astype(np.int32)
