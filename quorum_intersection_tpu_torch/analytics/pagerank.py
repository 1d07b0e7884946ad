"""Trust-graph PageRank — the port of the JAX package's
``analytics/pagerank.py``: power iteration, semantics-equivalent to the
reference's custom variant, which differs from textbook PageRank in several
pinned ways (SURVEY.md C15):

- initial mass 1 on **vertex 0** only, not uniform;
- per iteration every vertex gets base mass ``m / N`` where ``m`` is the
  ``--dangling_factor`` (default 0.0001, *not* the classic 0.15);
- each vertex with out-degree > 0 sends ``(1-m)/outdeg · rank`` along **every**
  out-edge occurrence — parallel edges and self-loops count with multiplicity
  (Q7); dangling vertices simply leak their mass;
- the L1 convergence diff is computed on the **un-normalized** new vector,
  which is then normalized by the accumulated sum;
- stop at ``diff ≤ convergence`` or ``maxIterations``.

Three engines behind :func:`pagerank_auto`:

- ``numpy`` — :func:`pagerank_np`, the NumPy model, copied line for line from
  the JAX package (the differential baseline, and the rank order's scorer);
- ``cuda`` — the whole power loop as one cooperative CUDA launch
  (:mod:`..kernels.pagerank_cuda`, K12 in PERF.md) over the in-edge CSR of
  :func:`in_edge_csr`, with one host sync per call;
- ``torch-cpu`` — the kernel's plain PyTorch version
  (:mod:`..kernels.pagerank_ref`), on ``device="cpu"`` only.

Exact float accumulation order differs between the engines; agreement is to
float32 tolerance, pinned by ``tests/test_torch_pagerank.py`` and
``chip_smoke.py`` phase ``compare_pagerank``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from quorum_intersection_tpu_torch.backends import calibration
from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.fbas.graph import TrustGraph

# Above this vertex count the O(N²) dense count matrix is replaced by the
# O(E) edge-list representation.
DENSE_LIMIT = 512

# device="cpu": the JAX package's CPU rule (its pagerank.py:237) — NumPy at
# or below this vertex count, the plain PyTorch loop above it.
JAX_CPU_LIMIT = 1024


def adjacency_counts(graph: TrustGraph) -> np.ndarray:
    """Dense (N, N) float32 matrix: A[v, w] = multiplicity of edge v→w."""
    a = np.zeros((graph.n, graph.n), dtype=np.float32)
    for v, targets in enumerate(graph.succ):
        for w in targets:
            a[v, w] += 1.0
    return a


def edge_arrays(graph: TrustGraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO edge arrays ``(src, dst, outdeg)`` with multiplicity preserved —
    one entry per edge occurrence (Q7), so the scatter-add matvec counts
    parallel edges exactly like the dense matrix and the reference's per-edge
    loop."""
    n_edges = graph.n_edges
    src = np.empty(n_edges, dtype=np.int32)
    dst = np.empty(n_edges, dtype=np.int32)
    outdeg = np.zeros(graph.n, dtype=np.float32)
    k = 0
    for v, targets in enumerate(graph.succ):
        outdeg[v] = len(targets)
        for w in targets:
            src[k] = v
            dst[k] = w
            k += 1
    return src, dst, outdeg


def in_edge_csr(graph: TrustGraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The in-edge CSR the kernel gathers over: ``row_ptr`` int32 ``(n+1,)``,
    ``src`` int32 ``(E,)`` sorted by (dst, src) with every edge occurrence
    kept (Q7: parallel edges and self-loops count), ``outdeg`` float32
    ``(n,)``."""
    lengths = np.fromiter((len(t) for t in graph.succ), dtype=np.int64, count=graph.n)
    n_edges = int(lengths.sum())
    src = np.repeat(np.arange(graph.n, dtype=np.int32), lengths)
    dst = np.fromiter((w for t in graph.succ for w in t), dtype=np.int32, count=n_edges)
    order = np.lexsort((src, dst))
    row_ptr = np.zeros(graph.n + 1, dtype=np.int32)
    np.cumsum(np.bincount(dst, minlength=graph.n), out=row_ptr[1:])
    return row_ptr, np.ascontiguousarray(src[order]), lengths.astype(np.float32)


def _use_dense(graph: TrustGraph, dense: Optional[bool]) -> bool:
    return graph.n <= DENSE_LIMIT if dense is None else dense


def pagerank_np(
    graph: TrustGraph,
    m: float = 0.0001,
    convergence: float = 0.0001,
    max_iterations: int = 100000,
    dense: Optional[bool] = None,
) -> np.ndarray:
    """NumPy model of the reference's power loop — the differential
    baseline for the other engines.  ``dense=None`` selects the
    representation by graph size."""
    n = graph.n
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    if _use_dense(graph, dense):
        a = adjacency_counts(graph)
        outdeg = a.sum(axis=1)

        def matvec(send: np.ndarray) -> np.ndarray:
            return a.T @ send
    else:
        src, dst, outdeg = edge_arrays(graph)

        def matvec(send: np.ndarray) -> np.ndarray:
            return np.bincount(dst, weights=send[src], minlength=n).astype(np.float32)

    rank = np.zeros(n, dtype=np.float32)
    rank[0] = 1.0
    m = np.float32(m)
    base = m / np.float32(n)
    diff = np.float32(convergence) + 1
    it = 0
    while diff > convergence and it < max_iterations:
        send = np.where(outdeg > 0, (1 - m) / np.maximum(outdeg, 1) * rank, 0.0).astype(
            np.float32
        )
        tmp = base + matvec(send)
        total = m + (outdeg * send).sum(dtype=np.float32)
        diff = np.abs(tmp - rank).sum(dtype=np.float32)
        rank = (tmp / total).astype(np.float32)
        it += 1
    return rank


def power_iteration(
    graph: TrustGraph,
    m: float = 0.0001,
    convergence: float = 0.0001,
    max_iterations: int = 100000,
    dense: Optional[bool] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, int, float]:
    """``(ranks, iterations, last_diff)`` of the power loop on ``device``
    (None: CUDA): the kernel on a card, the plain version on the CPU, where
    ``dense`` picks its form (None: by size, as :func:`pagerank_np`)."""
    import torch

    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import pagerank_power
    from quorum_intersection_tpu_torch.kernels.pagerank_ref import power_loop

    dev = resolve_device(device)
    n = graph.n
    if n == 0:
        return np.zeros(0, dtype=np.float32), 0, float(np.float32(convergence) + 1)
    csr = [torch.from_numpy(a).to(dev) for a in in_edge_csr(graph)]
    if dev.type == "cpu":
        rank, iterations, diff = power_loop(*csr, m, convergence, max_iterations, _use_dense(graph, dense))
    else:
        rank, iterations, diff = pagerank_power(*csr, m, convergence, max_iterations)
    # The call's one host sync: the ranks, then the two scalars beside them.
    return rank.cpu().numpy(), int(iterations), float(diff)


def pagerank(
    graph: TrustGraph,
    m: float = 0.0001,
    convergence: float = 0.0001,
    max_iterations: int = 100000,
    dense: Optional[bool] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """The power loop on ``device`` (None: CUDA): the hand-written kernel on
    a card, which launches or raises; the plain PyTorch version on the CPU."""
    return power_iteration(graph, m, convergence, max_iterations, dense, device)[0]


def pagerank_auto(
    graph: TrustGraph,
    m: float = 0.0001,
    convergence: float = 0.0001,
    max_iterations: int = 100000,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, str]:
    """Engine selection for the CLI: ``(ranks, engine)``, engine in
    {"cuda", "torch-cpu", "numpy"}.

    On CUDA (the default) the kernel runs from the card's
    ``pagerank_min_edges`` up (``backends/calibration.py``, measured for a
    fresh ``-p`` process, which pays the CUDA context and library load on
    the kernel route), NumPy below it and on a card with no measured floor.
    The floor is read on the host, and the card's name only once the edge
    count has passed it, so a NumPy-routed run creates no CUDA context and
    builds nothing.  On ``device="cpu"`` the JAX package's CPU rule: NumPy up
    to ``JAX_CPU_LIMIT`` nodes, the plain version above.  A kernel that fails
    to build or launch raises: unlike the JAX package, there is no degrade
    to NumPy."""
    import torch

    on_cpu = device is not None and str(device) == "cpu"
    if on_cpu:
        use_torch = graph.n > JAX_CPU_LIMIT
    else:
        cal = calibration.H100
        floor = cal.pagerank_min_edges
        use_torch = (floor is not None and graph.n_edges >= floor
                     and cal.for_kind(torch.cuda.get_device_name(resolve_device(device))) is not None)
    if not use_torch:
        return pagerank_np(graph, m, convergence, max_iterations), "numpy"
    ranks = pagerank(graph, m, convergence, max_iterations, device=device)
    return ranks, "torch-cpu" if on_cpu else "cuda"


def sorted_ranks(graph: TrustGraph, ranks: np.ndarray) -> List[Tuple[str, float]]:
    """Sort descending by rank, ties ascending by label (cpp:601-608)."""
    pairs = [(graph.label(v), float(ranks[v])) for v in range(graph.n)]
    return sorted(pairs, key=lambda p: (-p[1], p[0]))


def format_pagerank(graph: TrustGraph, ranks: np.ndarray) -> str:
    """``label: value`` lines under a ``PageRank:`` header (cpp:585-613, :731)."""
    lines = ["PageRank:"]
    for label, value in sorted_ranks(graph, ranks):
        lines.append(f"{label}: {value:g}")
    return "\n".join(lines) + "\n"
