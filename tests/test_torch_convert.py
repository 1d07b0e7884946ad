"""State carried across from the JAX package: its circuit arrays become the
port's circuit and kernel tables exactly, and the port's copies of the host
modules (encoding, restriction, synthetic generators, the density
annotations, the churn generators, the SCC fingerprints and the snapshot
diff) agree with the originals.  Exact equality throughout: integer arrays and JSON.
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


@pytest.mark.parametrize(
    "args,kwargs",
    [((13,), {"seed": 0}), ((14,), {"seed": 3, "nested_prob": 0.3, "null_prob": 0.1}),
     ((20,), {"seed": 5, "slice_size": 5, "dangling_prob": 0.2})],
)
def test_random_fbas_same_json(args, kwargs):
    assert json.dumps(synth.random_fbas(*args, **kwargs)) == json.dumps(
        jax_synth.random_fbas(*args, **kwargs)
    )


@pytest.mark.parametrize(
    "args,kwargs",
    [((15,), {}), ((200,), {"seed": 3, "broken": True}), ((300,), {"core_orgs": 4, "fanout": 3, "orgs_per_level": 8})],
)
def test_nested_hierarchy_same_json(args, kwargs):
    assert json.dumps(synth.nested_hierarchy(*args, **kwargs)) == json.dumps(
        jax_synth.nested_hierarchy(*args, **kwargs)
    )


@pytest.mark.parametrize("args,kwargs", [((400,), {}), ((400,), {"broken": True}), ((1000,), {"seed": 2})])
def test_sparse_giant_same_json(args, kwargs):
    assert json.dumps(synth.sparse_giant(*args, **kwargs)) == json.dumps(jax_synth.sparse_giant(*args, **kwargs))


@pytest.mark.parametrize("kwargs", [{}, {"broken": True}, {"core": 12, "watchers": 9, "seed": 4},
                                    {"core": 5, "watchers": 0, "broken": True, "seed": 2}])
def test_two_family_preset_same_json(kwargs):
    assert json.dumps(synth.two_family_preset(**kwargs)) == json.dumps(jax_synth.two_family_preset(**kwargs))


@pytest.mark.parametrize(
    "make",
    [lambda s: s.sparse_giant(400), lambda s: s.benchmark_fbas(256, 34),
     lambda s: s.near_disjoint_cores(6, 1), lambda s: s.stellar_like_fbas(5, 3, n_watchers=20, seed=1)],
)
def test_density_annotations_same_floats(make):
    """``graph_density`` and ``scc_qset_density`` (the bitset routing's
    feature) give the JAX package's floats, bit for bit."""
    from quorum_intersection_tpu.pipeline import quorum_bearing_sccs as jax_bearing
    from quorum_intersection_tpu_torch.pipeline import quorum_bearing_sccs

    data = make(synth)
    assert json.dumps(data) == json.dumps(make(jax_synth))
    graph, jax_graph = build_graph(parse_fbas(data)), jax_build_graph(jax_parse(data))
    assert synth.graph_density(graph) == jax_synth.graph_density(jax_graph)
    [(_, scc)] = quorum_bearing_sccs(graph)
    [(_, jax_scc)] = jax_bearing(jax_graph, allow_native=False)
    assert scc == jax_scc
    assert synth.scc_qset_density(graph, scc) == jax_synth.scc_qset_density(jax_graph, jax_scc)


def test_native_oracle_source_is_the_jax_packages():
    """The port's ``qi_oracle.cpp`` is the JAX package's, byte for byte,
    but for the one comment line that names the reference tool's source by
    its path on the original machine."""
    import pathlib

    import quorum_intersection_tpu.backends.cpp as jax_cpp
    import quorum_intersection_tpu_torch.backends.cpp as port_cpp

    jax_lines = pathlib.Path(jax_cpp.__file__).with_name("qi_oracle.cpp").read_bytes().splitlines(True)
    port_lines = port_cpp.SRC.read_bytes().splitlines(True)
    assert len(port_lines) == len(jax_lines)
    differ = [i for i, (a, b) in enumerate(zip(jax_lines, port_lines)) if a != b]
    assert differ == [3]
    assert port_lines[3] == b"// (the reference tool's quorum_intersection.cpp:90-400) as a standalone C++17\n"
    assert jax_lines[3].endswith(b"/quorum_intersection.cpp:90-400) as a standalone C++17\n")


def test_native_cli_source_is_the_jax_packages():
    """The port's ``qi_native.cpp`` is the JAX package's, byte for byte,
    but for the one comment line that names the reference tool's source by
    its path on the original machine."""
    import pathlib

    import quorum_intersection_tpu.backends.cpp as jax_cpp
    import quorum_intersection_tpu_torch.backends.cpp as port_cpp

    jax_lines = pathlib.Path(jax_cpp.__file__).with_name("qi_native.cpp").read_bytes().splitlines(True)
    port_lines = port_cpp.CLI_SRC.read_bytes().splitlines(True)
    assert len(port_lines) == len(jax_lines)
    differ = [i for i, (a, b) in enumerate(zip(jax_lines, port_lines)) if a != b]
    assert differ == [4]
    assert port_lines[4] == b"// the reference tool's quorum_intersection.cpp:402-800).  This translation unit is\n"
    assert jax_lines[4].endswith(b"/quorum_intersection.cpp:402-800).  This translation unit is\n")


def test_certificate_vocabulary_is_the_jax_packages():
    from quorum_intersection_tpu import cert as jax_cert
    from quorum_intersection_tpu_torch import cert

    assert cert.CERT_SCHEMA == jax_cert.CERT_SCHEMA == "qi-cert/1"
    assert cert.WITNESS_CONVENTION == jax_cert.WITNESS_CONVENTION
    assert cert.PROVENANCE_EVENTS == jax_cert.PROVENANCE_EVENTS


# ---- incremental re-analysis: churn traces, fingerprints, diffs ------------

CHURN_CASES = [
    (lambda s: s.stellar_like_fbas(n_core_orgs=3, per_org=2, n_watchers=8, seed=7), 10,
     {"seed": 2}),
    (lambda s: s.stellar_like_fbas(n_core_orgs=3, per_org=2, n_watchers=12, seed=11), 10,
     {"seed": 5, "max_diff": 1, "kinds": ("scc_merge", "scc_split", "threshold")}),
    (lambda s: s.benchmark_fbas(60, 10, broken=True, seed=1), 12,
     {"seed": 3, "max_diff": 3, "kinds": ("threshold", "swap", "rename", "scc_merge", "scc_split")}),
    (lambda s: s.benchmark_fbas(40, 8, seed=2), 16, {"seed": 4, "skew": 1.1}),
    (lambda s: s.hierarchical_fbas(4, 3), 6, {"seed": 6, "kinds": ("swap", "rename")}),
]


@pytest.mark.parametrize("case", range(len(CHURN_CASES)))
def test_churn_trace_steps_byte_identical(case):
    """Same ``(base, steps, seed, max_diff, kinds, skew)``: the same trace
    and metas, byte for byte (the skew RNG seeded by a string included), and
    ``churn_trace`` is the trace alone."""
    make, steps, kwargs = CHURN_CASES[case]
    base = make(synth)
    assert json.dumps(base) == json.dumps(make(jax_synth))
    got = synth.churn_trace_steps(base, steps, **kwargs)
    want = jax_synth.churn_trace_steps(base, steps, **kwargs)
    assert json.dumps(got) == json.dumps(want)
    assert json.dumps(synth.churn_trace(base, steps, **kwargs)) == json.dumps(got[0])
    assert synth.CHURN_KINDS == jax_synth.CHURN_KINDS


def test_churn_trace_rejects_what_jax_rejects():
    base = synth.majority_fbas(5)
    for kwargs in ({"kinds": ("bogus",)}, {"skew": -1.0}):
        with pytest.raises(ValueError):
            synth.churn_trace_steps(base, 2, **kwargs)
        with pytest.raises(ValueError):
            jax_synth.churn_trace_steps(base, 2, **kwargs)
    with pytest.raises(ValueError):
        synth.churn_trace(base, -1)


def _sccs(graph):
    from quorum_intersection_tpu_torch.fbas.graph import group_sccs, tarjan_scc

    count, comp = tarjan_scc(graph.n, graph.succ)
    return group_sccs(graph.n, comp, count)


@pytest.mark.parametrize("name", ["snapshot_correct.json", "nested_broken.json", "dump_scale_correct.json.gz",
                                  "stellar-broken", "bench-nested"])
@pytest.mark.parametrize("dangling", ["strict", "alias0"])
def test_scc_fingerprints_byte_identical(name, dangling):
    """Every SCC's ``(fingerprint, closed)``: the same 32 hex digits in both
    packages, which is what lets them share one fragment directory."""
    from quorum_intersection_tpu.fbas.diff import scc_fingerprint as jax_fingerprint
    from quorum_intersection_tpu_torch.fbas.diff import scc_fingerprint

    from _torch_cases import fixture_data

    data = {"stellar-broken": lambda: synth.stellar_like_fbas(5, 3, n_watchers=20, broken=True, seed=1),
            "bench-nested": lambda: synth.benchmark_fbas(64, 9, nested_watchers=True, seed=4)}.get(
        name, lambda: fixture_data(name))()
    graph = build_graph(parse_fbas(data), dangling=dangling)
    jax_graph = jax_build_graph(jax_parse(data), dangling=dangling)
    sccs = _sccs(graph)
    got = [scc_fingerprint(graph, m) for m in sccs]
    want = [jax_fingerprint(jax_graph, m) for m in sccs]
    assert got == want
    assert all(len(fp) == 32 for fp, _ in got)
    assert any(closed for _, closed in got)


@pytest.mark.parametrize("case", [0, 1, 2])
def test_diff_summaries_identical(case):
    """Every step of a churn trace diffed by both packages: the same
    summary and the same per-SCC classification."""
    from quorum_intersection_tpu.fbas.diff import diff_snapshots as jax_diff
    from quorum_intersection_tpu_torch.fbas.diff import diff_snapshots

    make, steps, kwargs = CHURN_CASES[case]
    trace, metas = synth.churn_trace_steps(make(synth), steps, **kwargs)
    for prev, nxt, meta in zip(trace, trace[1:], metas):
        got = diff_snapshots(build_graph(parse_fbas(prev)), build_graph(parse_fbas(nxt)))
        want = jax_diff(jax_build_graph(jax_parse(prev)), jax_build_graph(jax_parse(nxt)))
        assert json.dumps(got.summary()) == json.dumps(want.summary())
        assert [vars(d) for d in got.deltas] == [vars(d) for d in want.deltas]
        assert (got.merges, got.splits) == (meta["merges"], meta["splits"])


# ---- the fleet mesh's identity and its chaos draws ---------------------------


@pytest.mark.parametrize("token", [None, "", "s3cret", "mesh token ü"])
def test_mesh_identity_equals_the_jax_packages(token, monkeypatch):
    """The join handshake's package fingerprint and both token digests are
    the JAX package's byte for byte, with ``QI_FLEET_TOKEN`` unset, empty
    and set: either package's front door joins either package's server."""
    from quorum_intersection_tpu import delta as jax_delta
    from quorum_intersection_tpu import serve_transport as jax_transport
    from quorum_intersection_tpu_torch import delta, serve_transport

    if token is None:
        monkeypatch.delenv("QI_FLEET_TOKEN", raising=False)
    else:
        monkeypatch.setenv("QI_FLEET_TOKEN", token)
    assert serve_transport.package_fingerprint() == jax_transport.package_fingerprint()
    assert serve_transport.fleet_token_digest() == jax_transport.fleet_token_digest()
    assert delta._mesh_token_digest() == jax_delta._mesh_token_digest() == serve_transport.fleet_token_digest()
    assert (serve_transport.MESH_PROTOCOL, serve_transport.SHIP_CHUNK_BYTES, delta.STORE_SCHEMA) == (
        jax_transport.MESH_PROTOCOL, jax_transport.SHIP_CHUNK_BYTES, jax_delta.STORE_SCHEMA)
    assert bool(serve_transport.fleet_token_digest()) is bool(token)


@pytest.mark.parametrize("sampler", ["sample_fleet_plan", "sample_mesh_plan"])
def test_fleet_chaos_plans_are_the_jax_draws(sampler):
    from quorum_intersection_tpu.utils import faults as jax_faults
    from quorum_intersection_tpu_torch.utils import faults

    for seed in range(16):
        got, want = getattr(faults, sampler)(seed), getattr(jax_faults, sampler)(seed)
        assert got.label == want.label
        assert [(r.point, r.mode, r.first, r.every, r.seconds) for r in got.rules] == [
            (r.point, r.mode, r.first, r.every, r.seconds) for r in want.rules]
