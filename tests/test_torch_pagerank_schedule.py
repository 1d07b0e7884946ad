"""K12's one-barrier schedule (``kernels/csrc/pagerank.cu``), modelled on the
CPU by ``tests/_torch_pagerank_schedule.py`` in the kernel's order of
operations, against the JAX package.

- The model at the launch shape the wrapper picks for an H100 (132 SMs)
  gives ranks within ``_torch_pagerank_graphs.assert_ranks_close``'s
  tolerance (rtol 1e-3 + atol 1e-3·m/n an entry, and the JAX package's own)
  of the JAX package's ``pagerank_np`` and of its jitted ``pagerank``, on the
  quirk graphs, the iteration caps (0 and 1 among them), the dump fixture
  (one-segment rows) and a heavy-row graph whose hub row spans more than 8
  segments of 1024 (a ticket finish).
- Iteration counts are equal to the JAX model's (k iterations give its
  ranks bit for bit and k - 1 do not).  The rule allows one apart only where the
  model's last diff sits within 1e-3·conv of conv, the edge rule of
  ``tests/test_torch_cuda.py``; no case here sits on that edge.
- The ticket finish gives the same bits in any order of arrival, and so
  does the whole schedule, while a sum in arrival order would not.

Tolerances: the sums run in another order than JAX's (float32).
"""

import importlib

import numpy as np
import pytest
import torch

from quorum_intersection_tpu.fbas.graph import build_graph as jax_build_graph
from quorum_intersection_tpu.fbas.schema import parse_fbas as jax_parse
from quorum_intersection_tpu_torch.analytics.pagerank import in_edge_csr
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.kernels import pagerank_cuda
from quorum_intersection_tpu_torch.kernels.pagerank_cuda import LaunchShape, launch_shape

from _torch_cases import fixture_data
from _torch_pagerank_graphs import ITERATION_CAPS, QUIRK_GRAPHS, assert_ranks_close, heavy_row_fbas
from _torch_pagerank_schedule import LIGHT_ENTRIES, THREADS, schedule, ticket_finish

torch.set_num_threads(1)
jpr = importlib.import_module("quorum_intersection_tpu.analytics.pagerank")
H100_SMS = 132
HEAVY_WATCHERS = 9000  # the hub row: 9003 entries, 9 segments of 1024

CASES = {
    **{name: (data, 0.0001, 1000) for name, data in QUIRK_GRAPHS.items()},
    **{f"{name} m={m} max_iterations={cap}": (QUIRK_GRAPHS[name], m, cap) for name, m, cap in ITERATION_CAPS},
    "dump_scale_correct.json.gz": (None, 0.0001, 100000),
    "heavy-row": (None, 0.0001, 100000),
}
_DATA = {}


def _data(case):
    data = CASES[case][0]
    if data is None:
        if case not in _DATA:
            _DATA[case] = heavy_row_fbas(HEAVY_WATCHERS) if case == "heavy-row" else fixture_data(case)
        data = _DATA[case]
    return data


def _csr(data):
    graph = build_graph(parse_fbas(data))
    return graph, in_edge_csr(graph)


def _h100_shape(graph) -> LaunchShape:
    return launch_shape(graph.n, graph.n_edges, H100_SMS, 1)


def _jax_stops_after(jgraph, m, k, want) -> bool:
    """Whether the JAX model ran exactly k iterations: k gives its ranks
    bit for bit and k - 1 does not."""
    return k >= 0 and np.array_equal(jpr.pagerank_np(jgraph, m=m, max_iterations=k), want) and (
        k == 0 or not np.array_equal(jpr.pagerank_np(jgraph, m=m, max_iterations=k - 1), want))


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_matches_jax(case):
    data, (m, cap) = _data(case), CASES[case][1:]
    graph, csr = _csr(data)
    jgraph = jax_build_graph(jax_parse(data))
    shape = _h100_shape(graph)
    ranks, iterations, diff = schedule(*csr, m, 0.0001, cap, shape.grid, shape.seg)
    want = jpr.pagerank_np(jgraph, m=m, max_iterations=cap)
    assert_ranks_close(ranks, want, m)
    assert _jax_stops_after(jgraph, m, iterations, want) or (
        abs(diff - 0.0001) <= 1e-3 * 0.0001
        and any(_jax_stops_after(jgraph, m, iterations + d, want) for d in (-1, 1)))
    assert (cap == 0) == (iterations == 0)
    if cap == 0:
        np.testing.assert_array_equal(ranks, np.eye(graph.n, dtype=np.float32)[0])
    if case in ("self-loop", "cycle5 m=0.15 max_iterations=7", "heavy-row"):
        # The jitted JAX program (a compile per pad-ladder rung): a subset.
        assert_ranks_close(ranks, jpr.pagerank(jgraph, m=m, max_iterations=cap), m)


def test_heavy_row_graph_spans_segments():
    graph, (row_ptr, _, _) = _csr(_data("heavy-row"))
    degree = np.diff(row_ptr)
    assert degree.max() == HEAVY_WATCHERS + 3 > 8 * 1024
    assert np.sort(degree)[-2] <= 3 and set(np.unique(degree[degree <= 3])) == {0, 1, 2, 3}


@pytest.mark.parametrize("case", ["heavy-row", "dump_scale_correct.json.gz"])
def test_schedule_shapes_agree(case):
    """Every launch shape the kernel takes gives the same iteration count
    and ranks within the tolerance: one block to two blocks an SM, segments
    of 128 to 4096 (one-segment rows and ticket finishes both)."""
    graph, csr = _csr(_data(case))
    base = schedule(*csr, 0.0001, 0.0001, 100000, 1, 4096)
    for grid, seg in ((3, 128), (7, 1024), (H100_SMS, 1024), (2 * H100_SMS, 256)):
        ranks, iterations, _ = schedule(*csr, 0.0001, 0.0001, 100000, grid, seg)
        assert iterations == base[1]
        assert_ranks_close(ranks, base[0])


def test_ticket_finish_is_the_same_bits_in_any_arrival_order():
    rng = np.random.default_rng(11)
    sums = (rng.random(47) * 10.0 ** rng.integers(-9, 0, 47)).astype(np.float32)
    want = ticket_finish(sums)
    arrival_order_sums = set()
    for _ in range(64):
        arrival = rng.permutation(len(sums))
        assert ticket_finish(sums, arrival).tobytes() == want.tobytes()
        acc = np.float32(0)
        for s in arrival:
            acc = np.float32(acc + sums[s])
        arrival_order_sums.add(acc.tobytes())
    # A row summed in the order its segments arrive would change bits.
    assert len(arrival_order_sums) > 1


@pytest.mark.parametrize("case,shape", [
    ("heavy-row", LaunchShape(H100_SMS, 1024)),  # the hub row: 9 segments
    ("dump_scale_correct.json.gz", LaunchShape(H100_SMS, 256)),  # rows of about 680: 3 segments each
])
def test_schedule_bits_do_not_depend_on_arrival(case, shape):
    graph, csr = _csr(_data(case))
    shape = shape or _h100_shape(graph)
    want = schedule(*csr, 0.0001, 0.0001, 100000, shape.grid, shape.seg)
    for seed in range(3):
        got = schedule(*csr, 0.0001, 0.0001, 100000, shape.grid, shape.seg,
                       rng=np.random.default_rng(seed))
        assert got[0].tobytes() == want[0].tobytes() and got[1:] == want[1:]


def test_launch_shape_rules():
    # The dump (2971 nodes, 14 361 entries): a block per 256 vertices, its
    # core rows of about 680 entries in segments of 256.
    dump = launch_shape(2971, 14361, H100_SMS, 1)
    assert dump == LaunchShape(12, 256)
    # 200 049 nodes and 999 634 entries: a block an SM, about a segment a warp.
    full = launch_shape(200_049, 999_634, H100_SMS, 1)
    assert full == LaunchShape(H100_SMS, 1024)
    assert -(-999_634 // full.seg) <= full.warps
    assert launch_shape(200_049, 999_634, H100_SMS, 2) == LaunchShape(2 * H100_SMS, 512)
    for n, e in ((1, 0), (5, 7), (10**6, 10**9)):
        shape = launch_shape(n, e, H100_SMS, 1)
        assert 1 <= shape.grid <= H100_SMS and shape.seg & (shape.seg - 1) == 0
        assert pagerank_cuda.SEGMENT_MIN <= shape.seg <= pagerank_cuda.SEGMENT_MAX
    assert (pagerank_cuda.LIGHT_ENTRIES, pagerank_cuda.THREADS) == (LIGHT_ENTRIES, THREADS)


def test_measurement_entries_refuse_cpu_tensors():
    _, csr = _csr(QUIRK_GRAPHS["cycle5"])
    csr = [torch.from_numpy(a) for a in csr]
    before = pagerank_cuda.pagerank_power.launches
    with pytest.raises(ValueError, match="CUDA"):
        pagerank_cuda.pagerank_timed(*csr, 0.15, 0.0001, 7)
    assert pagerank_cuda.pagerank_power.launches == before
