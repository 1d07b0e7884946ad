"""State carried across from the JAX package: its circuit arrays become the
port's circuit and kernel tables exactly, and the port's copies of the host
modules (encoding, restriction, synthetic generators) agree with the
originals.  Exact equality throughout: integer arrays and JSON.
"""

import json

import numpy as np
import pytest
import torch

from quorum_intersection_tpu.encode.circuit import encode_circuit as jax_encode
from quorum_intersection_tpu.encode.circuit import restrict_circuit_pair as jax_restrict
from quorum_intersection_tpu.fbas import synth as jax_synth
from quorum_intersection_tpu.fbas.graph import build_graph as jax_build_graph
from quorum_intersection_tpu.fbas.schema import parse_fbas as jax_parse
from quorum_intersection_tpu_torch.convert import circuit_from_reference
from quorum_intersection_tpu_torch.encode.circuit import encode_circuit
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.kernels.sweep_cuda import plane_tables

from _torch_cases import sweep_case, case_data

torch.set_num_threads(1)

FIELDS = ("n", "n_units", "depth")
ARRAYS = ("thresholds", "members", "child", "unit_depth")


def _assert_same_circuit(a, b):
    assert tuple(getattr(a, f) for f in FIELDS) == tuple(getattr(b, f) for f in FIELDS)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _assert_same_planes(a, b):
    shape = ("n", "n_units", "units", "depth", "c0", "slabs", "pm", "pc", "stream")
    assert tuple(getattr(a, f) for f in shape) == tuple(getattr(b, f) for f in shape)
    for f in ("chunks", "blocks", "neg_thresholds"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize(
    "case",
    ["trivial_broken.json", "nested_correct.json", "nested_broken.json",
     "snapshot_correct.json", "snapshot_broken.json", "bench-nested:1", "bench-broken:2"],
)
def test_circuit_from_reference_equals_port_encoding(case):
    """The JAX encoder's arrays (whole graph where the kernel takes it, the
    SCC-restricted pair always) → the port's own encoding and tables."""
    sc = sweep_case(case)
    pairs = []
    if sc.circuit.n <= 64:
        pairs.append((sc.jax_circuit, sc.circuit))
    if sc.pair is not None:
        pairs += list(zip(sc.jax_pair, sc.pair))
    assert pairs
    for jc, pc in pairs:
        circuit, tables = circuit_from_reference(
            jc.members, jc.child, jc.thresholds, jc.depth, jc.n, device="cpu"
        )
        _assert_same_circuit(circuit, pc)
        _assert_same_planes(tables, plane_tables(pc, torch.device("cpu")))


@pytest.mark.parametrize("case", ["snapshot_broken.json", "bench-nested-broken:0"])
def test_port_encoding_and_restriction_match_jax(case):
    data = case_data(case)
    graph = build_graph(parse_fbas(data))
    jax_graph = jax_build_graph(jax_parse(data))
    _assert_same_circuit(encode_circuit(graph), jax_encode(jax_graph))
    sc = sweep_case(case)
    for port, ref in zip(sc.pair, jax_restrict(jax_encode(jax_graph), sc.scc)):
        _assert_same_circuit(port, ref)


def test_circuit_from_reference_rejects_bad_input():
    sc = sweep_case("nested_correct.json")
    jc = sc.jax_circuit
    with pytest.raises(ValueError, match="depth"):
        circuit_from_reference(jc.members, jc.child, jc.thresholds, jc.depth + 1, jc.n, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        circuit_from_reference(jc.members[:, :-1], jc.child, jc.thresholds, jc.depth, jc.n, device="cpu")


@pytest.mark.parametrize(
    "kwargs",
    [
        {"n_total": 256, "core": 34},
        {"n_total": 256, "core": 34, "broken": True},
        {"n_total": 1024, "core": 34, "nested_watchers": True, "seed": 7},
        {"n_total": 60, "core": 10, "broken": True, "seed": 3},
    ],
)
def test_benchmark_fbas_same_json(kwargs):
    assert json.dumps(synth.benchmark_fbas(**kwargs)) == json.dumps(
        jax_synth.benchmark_fbas(**kwargs)
    )


@pytest.mark.parametrize("n,broken", [(3, False), (9, True)])
def test_majority_fbas_same_json(n, broken):
    assert synth.majority_fbas(n, broken=broken) == jax_synth.majority_fbas(n, broken=broken)


@pytest.mark.parametrize(
    "args,kwargs",
    [((3, 3), {}), ((3, 4), {"org_threshold": 1}), ((4, 3), {"broken": True})],
)
def test_hierarchical_fbas_same_json(args, kwargs):
    assert json.dumps(synth.hierarchical_fbas(*args, **kwargs)) == json.dumps(
        jax_synth.hierarchical_fbas(*args, **kwargs)
    )


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"n_core_orgs": 7, "per_org": 3, "seed": 1, "broken": True},
        {"n_core_orgs": 9, "per_org": 3, "n_watchers": 300, "seed": 2},
        {"n_core_orgs": 5, "per_org": 3, "n_watchers": 20, "seed": 2, "broken": True},
    ],
)
def test_stellar_like_fbas_same_json(kwargs):
    assert json.dumps(synth.stellar_like_fbas(**kwargs)) == json.dumps(
        jax_synth.stellar_like_fbas(**kwargs)
    )


@pytest.mark.parametrize(
    "args,kwargs",
    [((6, 1), {}), ((6, 1), {"broken": True}), ((12, 2), {"seed": 3}),
     ((15, 1), {"broken": True, "prefix": "X"})],
)
def test_near_disjoint_cores_same_json(args, kwargs):
    assert json.dumps(synth.near_disjoint_cores(*args, **kwargs)) == json.dumps(
        jax_synth.near_disjoint_cores(*args, **kwargs)
    )
