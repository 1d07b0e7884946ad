"""PageRank in the port on the CPU against the JAX package.

- the port's NumPy model ``pagerank_np`` equals the JAX package's exactly;
- the plain version of the kernel (``kernels/pagerank_ref.py``, both forms)
  matches JAX ``pagerank_np`` and the jitted JAX ``pagerank`` within the
  JAX package's own tolerances (atol 2e-5, or rtol 2e-3 and atol 2e-6 from
  5k nodes) and within rtol 1e-3 and atol 1e-3 * m / n an entry
  (``_torch_pagerank_graphs.assert_ranks_close``: the sums run in another
  order), a rule that refuses planted faults the JAX tolerances pass;
- ``in_edge_csr`` holds the same edges as ``edge_arrays``;
- ``-p`` prints byte for byte what the JAX CLI prints;
- ``pagerank_auto`` routes by the documented rules, touches no CUDA when it
  picks NumPy and raises, never degrades, when the kernel fails.
"""

import dataclasses
import importlib
import io
import json
import sys

import numpy as np
import pytest
import torch

from quorum_intersection_tpu import cli as jax_cli
from quorum_intersection_tpu.fbas.graph import build_graph as jax_build_graph
from quorum_intersection_tpu.fbas.schema import parse_fbas as jax_parse
import quorum_intersection_tpu_torch.analytics.pagerank as pr
from quorum_intersection_tpu_torch import cli
from quorum_intersection_tpu_torch.backends import calibration
from quorum_intersection_tpu_torch.backends.calibration import H100
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.kernels import pagerank_cuda
from quorum_intersection_tpu_torch.kernels.pagerank_ref import power_loop

from _torch_cases import JSON_FIXTURES, fixture_data
from _torch_pagerank_graphs import ITERATION_CAPS, QUIRK_GRAPHS, assert_ranks_close, planted_faults

torch.set_num_threads(1)
# The JAX package's analytics/__init__ exports a function of the same name.
jpr = importlib.import_module("quorum_intersection_tpu.analytics.pagerank")

SOURCES = {
    **QUIRK_GRAPHS,
    **{name: (lambda name=name: fixture_data(name)) for name in JSON_FIXTURES + ["dump_scale_correct.json.gz"]},
    "stellar-300": lambda: synth.stellar_like_fbas(n_watchers=300),
    "stellar-4800": lambda: synth.stellar_like_fbas(n_watchers=4800, n_null=100),
}


def _source(name):
    src = SOURCES[name]
    return src() if callable(src) else src


def _loop(name):
    """The quirk graphs are periodic (mass swings between two sides) and
    never converge: they run to a cap instead of the default 100000."""
    return {"max_iterations": 1000} if name in QUIRK_GRAPHS else {}


def _graphs(name):
    data = _source(name)
    return build_graph(parse_fbas(data)), jax_build_graph(jax_parse(data))


@pytest.mark.parametrize("name", list(SOURCES))
def test_pagerank_np_equals_jax_exactly(name):
    graph, jgraph = _graphs(name)
    np.testing.assert_array_equal(pr.pagerank_np(graph, **_loop(name)), jpr.pagerank_np(jgraph, **_loop(name)))


# Dense count matrices stay below 3000 nodes (the dump's 2971 nodes: 35 MB).
PLAIN_CASES = [(name, dense) for name in SOURCES for dense in (False, True)
               if not (dense and name == "stellar-4800")]


@pytest.mark.parametrize("name,dense", PLAIN_CASES)
def test_plain_version_matches_jax_models(name, dense):
    graph, jgraph = _graphs(name)
    ranks, iterations, diff = pr.power_iteration(graph, dense=dense, device="cpu", **_loop(name))
    assert_ranks_close(ranks, jpr.pagerank_np(jgraph, **_loop(name)))
    assert iterations >= 1 and (diff <= 0.0001 or iterations == 1000)
    if name in ("self-loop", "dangling", "trivial_broken.json", "nested_correct.json", "stellar-300",
                "dump_scale_correct.json.gz", "stellar-4800"):
        # The jitted JAX program (a compile per pad-ladder rung): a subset.
        assert_ranks_close(ranks, jpr.pagerank(jgraph, dense=dense and graph.n <= jpr.DENSE_LIMIT, **_loop(name)))


@pytest.mark.parametrize("name,m,cap", ITERATION_CAPS)
def test_plain_version_honours_the_iteration_cap(name, m, cap):
    graph, jgraph = _graphs(name)
    for dense in (False, True):
        ranks, iterations, _ = pr.power_iteration(graph, m=m, max_iterations=cap, dense=dense, device="cpu")
        assert iterations == min(cap, iterations) and (cap == 0) == (iterations == 0)
        assert_ranks_close(ranks, jpr.pagerank_np(jgraph, m=m, max_iterations=cap), m)
    if cap == 0:
        np.testing.assert_array_equal(ranks, np.eye(graph.n, dtype=np.float32)[0])


@pytest.mark.parametrize("name", ["stellar-300", "dump_scale_correct.json.gz", "stellar-4800"])
@pytest.mark.parametrize("fault", ["unreached zeroed", "base dropped"])
def test_the_tolerance_refuses_planted_faults(name, fault):
    """The comparison rule passes the plain version against the JAX model
    and refuses each planted fault, which the JAX package's own tolerances
    pass on these graphs: a watcher's rank is below them."""
    graph, jgraph = _graphs(name)
    ranks = pr.pagerank(graph, device="cpu")
    want = jpr.pagerank_np(jgraph)
    assert_ranks_close(ranks, want)
    faulty = planted_faults(ranks, pr.in_edge_csr(graph)[0])[fault]
    assert graph.n < 5000
    np.testing.assert_allclose(faulty, want, atol=2e-5)  # the JAX tolerance below 5k nodes
    with pytest.raises(AssertionError):
        assert_ranks_close(faulty, want)


def test_plain_version_on_an_empty_graph_and_the_q7_quirks():
    empty = build_graph(parse_fbas([]))
    assert pr.pagerank(empty, device="cpu").shape == (0,)
    graph = build_graph(parse_fbas(QUIRK_GRAPHS["parallel-edges"]))
    ranks = pr.pagerank(graph, max_iterations=1000, device="cpu")
    assert ranks[1] > ranks[2]  # B gets 2/3 of A's sends, C 1/3
    np.testing.assert_allclose(ranks.sum(), 1.0, atol=1e-5)


@pytest.mark.parametrize("name", ["parallel-edges", "self-loop", "dangling", "snapshot_broken.json",
                                  "dump_scale_correct.json.gz", "stellar-300"])
def test_in_edge_csr_holds_the_edge_arrays_edges(name):
    graph, _ = _graphs(name)
    row_ptr, src, outdeg = pr.in_edge_csr(graph)
    e_src, e_dst, e_outdeg = pr.edge_arrays(graph)
    assert row_ptr.dtype == src.dtype == np.int32 and outdeg.dtype == np.float32
    assert row_ptr[0] == 0 and row_ptr[-1] == graph.n_edges == len(src)
    np.testing.assert_array_equal(outdeg, e_outdeg)
    dst = np.repeat(np.arange(graph.n), np.diff(row_ptr))
    assert sorted(zip(src.tolist(), dst.tolist())) == sorted(zip(e_src.tolist(), e_dst.tolist()))
    for w in range(graph.n):  # rows sorted by source
        row = src[row_ptr[w]:row_ptr[w + 1]]
        assert np.all(row[:-1] <= row[1:])


def test_power_loop_contract_on_the_csr():
    graph = build_graph(parse_fbas(QUIRK_GRAPHS["cycle5"]))
    csr = [torch.from_numpy(a) for a in pr.in_edge_csr(graph)]
    rank, iterations, diff = pagerank_cuda.pagerank_power(*csr, 0.15, 0.0001, 7)
    want = power_loop(*csr, 0.15, 0.0001, 7)
    assert rank.dtype == torch.float32 and iterations.dtype == torch.int32 and diff.dtype == torch.float32
    assert int(iterations) == int(want[1]) == 7
    torch.testing.assert_close(rank, want[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="int32"):
        pagerank_cuda.pagerank_power(csr[0].long(), csr[1], csr[2], 0.15, 0.0001, 7)


def _run(main, argv, text, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    code = main(argv)
    captured = capsys.readouterr()
    return captured.out, code


CLI_FLAGS = [["-p"], ["-p", "-m", "0.001", "-c", "0.01"], ["--pagerank", "-m", "0.15", "-i", "40"]]


@pytest.mark.parametrize("name", JSON_FIXTURES)
def test_cli_pagerank_equals_jax_cli(name, monkeypatch, capsys):
    text = json.dumps(fixture_data(name))
    for flags in CLI_FLAGS:
        for device in ([], ["--device", "cpu"]):
            got = _run(cli.main, flags + device, text, monkeypatch, capsys)
            want = _run(jax_cli.main, flags, text, monkeypatch, capsys)
            assert got == want and got[1] == 0


def test_cli_pagerank_equals_jax_cli_on_the_reference_snapshot(ref_fixture, monkeypatch, capsys):
    text = ref_fixture("correct.json").read_text()
    got = _run(cli.main, ["-p"], text, monkeypatch, capsys)
    assert got == _run(jax_cli.main, ["-p"], text, monkeypatch, capsys)


class TestRouting:
    """``pagerank_auto`` with the kernel route replaced: the route alone."""

    @pytest.fixture
    def no_cuda(self, monkeypatch):
        """Any CUDA query, or any kernel call, fails the test."""
        def touched(*_a, **_k):
            raise AssertionError("the NumPy route touched CUDA or the kernel")

        for name in ("is_available", "is_initialized", "get_device_name", "init", "current_device",
                     "synchronize"):
            monkeypatch.setattr(torch.cuda, name, touched)
        monkeypatch.setattr(pagerank_cuda, "pagerank_power", touched)
        monkeypatch.setattr(pr, "resolve_device", touched)

    @pytest.fixture
    def plain_as_kernel(self, monkeypatch):
        """The kernel route replaced by the plain version; calls counted."""
        calls = []

        def fake(graph, m, convergence, max_iterations, device=None):
            calls.append(graph.n)
            csr = [torch.from_numpy(a) for a in pr.in_edge_csr(graph)]
            return power_loop(*csr, m, convergence, max_iterations)[0].numpy()

        monkeypatch.setattr(pr, "pagerank", fake)
        monkeypatch.setattr(pr, "resolve_device", lambda device: torch.device("cuda"))
        return calls

    @staticmethod
    def floors(monkeypatch, floor, kind=calibration.H100_KIND):
        """The H100's floor set to ``floor``, and the card named ``kind``."""
        monkeypatch.setattr(calibration, "H100", dataclasses.replace(H100, pagerank_min_edges=floor))
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: kind)

    def test_committed_floors_send_a_cold_dump_to_numpy(self, no_cuda):
        """The committed floor: in a fresh process NumPy won at every measured
        size on the H100, so `-p` takes NumPy on the dump, and beyond."""
        graph = build_graph(parse_fbas(fixture_data("dump_scale_correct.json.gz")))
        assert H100.pagerank_min_edges is None or graph.n_edges < H100.pagerank_min_edges
        ranks, engine = pr.pagerank_auto(graph)
        assert engine == "numpy"
        np.testing.assert_array_equal(ranks, pr.pagerank_np(graph))

    @pytest.mark.parametrize("floor", ["one edge past the graph", "none"])
    def test_below_the_floor_numpy_runs_without_touching_cuda(self, no_cuda, monkeypatch, floor):
        graph = build_graph(parse_fbas(fixture_data("snapshot_correct.json")))
        monkeypatch.setattr(calibration, "H100", dataclasses.replace(
            H100, pagerank_min_edges=graph.n_edges + 1 if floor != "none" else None))
        assert pr.pagerank_auto(graph)[1] == "numpy"

    @pytest.mark.parametrize("kind", [calibration.H100_KIND, "another card"])
    def test_from_the_floor_of_the_process_state_the_kernel_runs(self, plain_as_kernel, monkeypatch, kind):
        """From the floor up the kernel runs, on the card the floor was
        measured on; on a card of another kind, whose floor is not measured,
        NumPy runs."""
        graph = build_graph(parse_fbas(fixture_data("snapshot_correct.json")))
        self.floors(monkeypatch, graph.n_edges, kind)
        ranks, engine = pr.pagerank_auto(graph)
        if kind == calibration.H100_KIND:
            assert engine == "cuda" and plain_as_kernel == [graph.n]
            assert_ranks_close(ranks, pr.pagerank_np(graph))
        else:
            assert engine == "numpy" and plain_as_kernel == []
        self.floors(monkeypatch, graph.n_edges + 1, kind)
        assert pr.pagerank_auto(graph)[1] == "numpy" and len(plain_as_kernel) == (kind == calibration.H100_KIND)

    def test_a_failing_kernel_raises_instead_of_degrading(self, monkeypatch):
        """Down to the kernel wrapper: the CSR goes to a device that is not
        the CPU (``meta``, which holds no data), so ``power_iteration`` calls
        the wrapper, which fails; ``pagerank_auto`` passes the error on."""
        def broken(*_a, **_k):
            raise RuntimeError("pagerank_cuda launch failed: simulated")

        monkeypatch.setattr(pagerank_cuda, "pagerank_power", broken)
        monkeypatch.setattr(pr, "resolve_device", lambda device: torch.device("meta"))
        graph = build_graph(parse_fbas(fixture_data("snapshot_correct.json")))
        self.floors(monkeypatch, 1)
        with pytest.raises(RuntimeError, match="simulated"):
            pr.pagerank_auto(graph)

    def test_cuda_without_a_card_raises_above_the_floor(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        graph = build_graph(parse_fbas(fixture_data("snapshot_correct.json")))
        self.floors(monkeypatch, 1)
        with pytest.raises(RuntimeError, match="is_available"):
            pr.pagerank_auto(graph)

    def test_cpu_rule_is_the_jax_packages(self):
        small = build_graph(parse_fbas(synth.stellar_like_fbas(n_watchers=300)))
        data = synth.stellar_like_fbas(n_watchers=1000)
        big = build_graph(parse_fbas(data))
        assert small.n <= pr.JAX_CPU_LIMIT < big.n
        assert pr.pagerank_auto(small, device="cpu")[1] == "numpy"
        ranks, engine = pr.pagerank_auto(big, device="cpu")
        assert engine == "torch-cpu"
        assert_ranks_close(ranks, jpr.pagerank_np(jax_build_graph(jax_parse(data))))
