"""PageRank inputs shared by the CPU and the card tests: the reference's
quirk graphs (SURVEY.md C15, the cases of ``tests/test_pagerank.py``) as raw
stellarbeat node lists, and the tolerance the engines are held to.
Imports nothing of JAX."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

PARALLEL_EDGES = [  # B listed twice by A: A sends twice the mass to B (Q7)
    {"publicKey": "A", "quorumSet": {"threshold": 1, "validators": ["B", "B", "C"]}},
    {"publicKey": "B", "quorumSet": {"threshold": 1, "validators": ["A"]}},
    {"publicKey": "C", "quorumSet": {"threshold": 1, "validators": ["A"]}},
]
SELF_LOOP = [
    {"publicKey": "A", "quorumSet": {"threshold": 1, "validators": ["A", "B"]}},
    {"publicKey": "B", "quorumSet": {"threshold": 2, "validators": ["A", "B", "B"]}},
    {"publicKey": "C", "quorumSet": {"threshold": 1, "validators": ["C", "A"]}},
]
DANGLING = [  # B has no out-edges: its mass leaks
    {"publicKey": "A", "quorumSet": {"threshold": 1, "validators": ["B"]}},
    {"publicKey": "B", "quorumSet": None},
]
CYCLE5 = [  # a directed 5-cycle: mass circulates, so the iteration cap binds
    {"publicKey": f"C{i}", "quorumSet": {"threshold": 1, "validators": [f"C{(i + 1) % 5}"]}}
    for i in range(5)
]

QUIRK_GRAPHS: Dict[str, List[dict]] = {
    "parallel-edges": PARALLEL_EDGES,
    "self-loop": SELF_LOOP,
    "dangling": DANGLING,
    "cycle5": CYCLE5,
}


def heavy_row_fbas(n_watchers: int, seed: int = 0) -> List[dict]:
    """One row far past a segment beside rows of 0-3 entries: every watcher
    trusts the hub (whose row then holds n_watchers + 3 in-edges) and, each
    with probability 1/2, the next three watchers (whose rows hold 0-3);
    the hub trusts the three keepers, each keeper the hub and the next
    keeper (cycles of 2 and 3: the chain is aperiodic and converges)."""
    rng = np.random.default_rng(seed)
    keepers = [{"publicKey": f"K{i}", "quorumSet": {"threshold": 2, "validators": ["HUB", f"K{(i + 1) % 3}"]}}
               for i in range(3)]
    hub = {"publicKey": "HUB", "quorumSet": {"threshold": 2, "validators": ["K0", "K1", "K2"]}}
    pick = rng.random((n_watchers, 3)) < 0.5
    watchers = [{"publicKey": f"W{i}", "quorumSet": {"threshold": 1, "validators": ["HUB"] + [
        f"W{(i + d) % n_watchers}" for d in (1, 2, 3) if pick[i, d - 1]]}} for i in range(n_watchers)]
    return [hub] + keepers + watchers


# (graph, m, max_iterations): the iteration caps of the quirk cases.
ITERATION_CAPS = [("cycle5", 0.15, 0), ("cycle5", 0.15, 1), ("cycle5", 0.15, 7),
                  ("dangling", 0.0001, 50), ("parallel-edges", 0.0001, 7)]

# Per entry: rtol 1e-3 and atol 1e-3 * m / n.  No rank is below m / n (a
# vertex nobody trusts gets the base m / n over a total of at most 1), so
# every entry, the smallest included, is held to a thousandth of itself.
# The JAX package's own tolerances (atol 2e-5, or rtol 2e-3 and atol 2e-6
# from 5k nodes) hold too: alone they exceed the value of a watcher's rank
# and would pass a wrong one.  Float32 sums in another order stay well
# inside both.
RTOL = 1e-3


def assert_ranks_close(got, want, m: float = 0.0001) -> None:
    want = np.asarray(want)
    n = len(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * m / max(n, 1))
    if n >= 5000:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-6)
    else:
        np.testing.assert_allclose(got, want, atol=2e-5)


def planted_faults(ranks, row_ptr) -> Dict[str, np.ndarray]:
    """Wrong variants of a correct rank vector that a check must refuse:
    the vertices with no in-edges zeroed, and the base term m / n dropped
    (every entry less the rank of such a vertex, base / total)."""
    ranks = np.asarray(ranks)
    unreached = np.flatnonzero(np.diff(np.asarray(row_ptr)) == 0)
    zeroed = ranks.copy()
    zeroed[unreached] = 0.0
    return {"unreached zeroed": zeroed, "base dropped": ranks - ranks[unreached[0]]}
