"""Rank-ordered sweeps in the port on the CPU against the JAX package.

- ``rank_order_nodes`` returns the JAX package's ``(ordered, meta)``;
- under ``order="rank"`` (or ``QI_SWEEP_ORDER=rank``) both drives of the
  port's ``GpuSweepBackend(device="cpu")`` give the JAX
  ``TpuSweepBackend(order="rank")``'s verdict, witness, hit index and
  ``stats["order"]``;
- the port certificate carries ``provenance.order`` and the unmodified
  ``tools/check_cert.py`` accepts it.

Everything compared is an integer or a node list: exact equality.
"""

import io
import json
import sys

import pytest
import torch

import quorum_intersection_tpu.encode.circuit as jc
from quorum_intersection_tpu.backends.tpu.sweep import TpuSweepBackend
from quorum_intersection_tpu.fbas.graph import build_graph as jax_build_graph
from quorum_intersection_tpu.fbas.schema import parse_fbas as jax_parse
from quorum_intersection_tpu.pipeline import check_many as jax_check_many
from quorum_intersection_tpu.pipeline import solve as jax_solve
from quorum_intersection_tpu_torch import cli
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
from quorum_intersection_tpu_torch.encode.circuit import rank_order_nodes
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.pipeline import check_many, quorum_bearing_sccs, solve
from tools.check_cert import check_certificate
from tools.check_cert import main as checker_main

from _torch_cases import FIXTURES, fixture_data, manifest

torch.set_num_threads(1)

SWEEP_SOURCES = {
    "nested_correct.json": lambda: fixture_data("nested_correct.json"),
    "nested_broken.json": lambda: fixture_data("nested_broken.json"),
    **{f"stellar-{seed}{'-broken' if broken else ''}":
       (lambda seed=seed, broken=broken: synth.stellar_like_fbas(5, 3, seed=seed, broken=broken))
       for seed in (0, 1) for broken in (False, True)},
    "ndc6": lambda: synth.near_disjoint_cores(6, 1),
}
ORDER_SOURCES = {**{name: (lambda name=name: fixture_data(name)) for name in sorted(manifest())},
                 "ndc6": lambda: synth.near_disjoint_cores(6, 1)}


@pytest.mark.parametrize("name", list(ORDER_SOURCES))
def test_rank_order_equals_jax(name):
    data = ORDER_SOURCES[name]()
    graph, jgraph = build_graph(parse_fbas(data)), jax_build_graph(jax_parse(data))
    bearing = quorum_bearing_sccs(graph)
    assert bearing
    for _sid, scc in bearing:
        ordered, meta = rank_order_nodes(graph, scc)
        assert (ordered, meta) == jc.rank_order_nodes(jgraph, scc)
        assert sorted(ordered) == sorted(scc) and meta["mode"] == "rank"
        assert meta["bit_nodes"] == [graph.node_ids[v] for v in ordered[1:]]


def _same(got, want):
    assert (got.intersects, got.q1, got.q2) == (want.intersects, want.q1, want.q2)
    assert got.stats.get("hit_index") == want.stats.get("hit_index")
    assert got.stats.get("order") == want.stats.get("order")


@pytest.mark.parametrize("name", list(SWEEP_SOURCES))
def test_rank_ordered_solve_equals_jax_and_certifies(name):
    data = SWEEP_SOURCES[name]()
    got = solve(data, backend=GpuSweepBackend(order="rank", device="cpu"))
    want = jax_solve(data, backend=TpuSweepBackend(order="rank"))
    _same(got, want)
    if got.stats.get("backend") == "gpu-sweep":  # not decided by the SCC guard
        assert got.stats["order"]["mode"] == "rank"
        assert got.cert["provenance"]["order"] == want.cert["provenance"]["order"] == got.stats["order"]
    notes = check_certificate(got.cert, data)
    assert notes and notes[0].startswith("guard:")


def test_rank_ordered_batch_equals_jax_on_both_engines():
    datas = [src() for src in SWEEP_SOURCES.values()]
    want = jax_check_many(datas, backend=TpuSweepBackend(order="rank", batch=256))
    for engine in (None, "bitset"):
        got = check_many(datas, backend=GpuSweepBackend(order="rank", batch=256, engine=engine, device="cpu"))
        assert len(got) == len(want)
        for g, w, data in zip(got, want, datas):
            _same(g, w)
            assert g.stats.get("packed") == w.stats.get("packed")
            check_certificate(g.cert, data)
    assert any(r.stats.get("packed") and r.stats.get("order") for r in got)


def test_rank_order_changes_the_enumeration_but_not_the_verdict():
    data = synth.stellar_like_fbas(5, 3, seed=0, broken=True)
    natural = solve(data, backend=GpuSweepBackend(order="natural", device="cpu"))
    ranked = solve(data, backend=GpuSweepBackend(order="rank", device="cpu"))
    assert natural.intersects is ranked.intersects is False
    assert "order" not in natural.stats and "order" not in natural.cert["provenance"]
    assert natural.stats["hit_index"] != ranked.stats["hit_index"]


def test_sweep_order_env_switch(monkeypatch):
    monkeypatch.delenv("QI_SWEEP_ORDER", raising=False)
    assert GpuSweepBackend(device="cpu")._order_mode() == "natural"
    monkeypatch.setenv("QI_SWEEP_ORDER", "RANK")
    assert GpuSweepBackend(device="cpu")._order_mode() == "rank"
    assert GpuSweepBackend(order="natural", device="cpu")._order_mode() == "natural"
    with pytest.raises(ValueError, match="unknown sweep order"):
        GpuSweepBackend(order="pagerank", device="cpu")
    # Below three nodes there is nothing to order.
    graph = build_graph(parse_fbas(fixture_data("trivial_broken.json")))
    (_, scc), = quorum_bearing_sccs(graph)
    assert GpuSweepBackend(device="cpu")._ordered(graph, scc[:2]) == (scc[:2], None)


def test_cli_under_the_order_variable_certifies(tmp_path, monkeypatch, capsys):
    """QI_SWEEP_ORDER=rank reaches the sweep through the CLI, the default
    router's sweep rung included, and every certificate checks."""
    monkeypatch.setenv("QI_SWEEP_ORDER", "rank")
    for backend in ("gpu-sweep", "auto"):
        for name in ("nested_broken.json", "snapshot_broken.json"):
            path = tmp_path / f"{backend}.{name}"
            monkeypatch.setattr(sys, "stdin", io.StringIO((FIXTURES / name).read_text()))
            code = cli.main(["--device", "cpu", "--backend", backend, "--cert-out", str(path)])
            assert (capsys.readouterr().out, code) == ("false\n", 1)
            cert = json.loads(path.read_text())
            if cert["provenance"]["backend"] == "gpu-sweep":
                assert cert["provenance"]["order"]["mode"] == "rank"
            assert checker_main(["-q", str(path), str(FIXTURES / name)]) == 0
