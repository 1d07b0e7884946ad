"""Top-tier analytics: the union of all minimal quorums' members (the port
of the JAX package's ``analytics/top_tier.py``).

The **top tier** of an FBAS is the set of validators that appear in at
least one minimal quorum — the nodes whose configuration actually shapes
consensus (everyone else piggybacks on them).  Third member of the
analysis suite around the verdict, with :mod:`.resilience` (liveness) and
:mod:`.splitting` (safety margin).

Computed by the same branch-and-bound the verdict engines use, with two
deliberate differences (see ``qi_top_tier`` in ``backends/cpp/qi_oracle.cpp``):
the half-size prune is DISABLED (it is sound only for the disjointness
search — minimal quorums larger than ⌊|scc|/2⌋ exist and belong in the
union), and the visitor collects members instead of probing for a disjoint
partner.  Enumeration is exponential in the worst case, so a B&B call budget
bounds the work; exceeding it reports "not computed" rather than a partial
answer.

The Python fallback's budget is the native budget scaled down by the ratio
of the two oracles' seconds per call as this port measured them
(``backends/calibration.py``), not by the JAX package's ratio: the same
wall-clock bound, from this port's own numbers.
"""

from __future__ import annotations

import logging
import sys
from typing import List, Optional, Sequence, Tuple

from quorum_intersection_tpu_torch.fbas.graph import TrustGraph

log = logging.getLogger("quorum_intersection_tpu_torch.analytics.top_tier")

# About 3 s of native enumeration at the measured 1.49 µs a call; the CLI
# prints a "not computed" line beyond it rather than running unbounded.
DEFAULT_BUDGET_CALLS = 2_000_000


def python_budget(budget_calls: int) -> int:
    """The Python enumeration's budget for the same wall-clock bound as
    ``budget_calls`` native calls."""
    from quorum_intersection_tpu_torch.backends.calibration import H100

    spc = H100.oracle_seconds_per_call
    return max(int(budget_calls / (spc["python"] / spc["cpp"])), 1)


def top_tier(
    graph: TrustGraph,
    scc: Sequence[int],
    budget_calls: int = DEFAULT_BUDGET_CALLS,
) -> Tuple[Optional[List[int]], int]:
    """``(members, minimal_quorum_count)`` for the SCC; members is None
    when the enumeration exceeded ``budget_calls`` (count is then the
    partial tally).  Native enumeration with a pure-Python fallback."""
    try:
        from quorum_intersection_tpu_torch.backends.cpp import native_top_tier

        return native_top_tier(graph, list(scc), budget_calls)
    except Exception as exc:  # noqa: BLE001 — no g++ etc.
        log.info("native top-tier unavailable (%s); using Python enumeration", exc)
    return python_top_tier(graph, scc, python_budget(budget_calls))


def python_top_tier(
    graph: TrustGraph, scc: Sequence[int], budget_calls: int
) -> Tuple[Optional[List[int]], int]:
    """The Python oracle's enumeration of the same union and count."""
    from quorum_intersection_tpu_torch.backends.python_oracle import (
        _SearchState,
        iterate_minimal_quorums,
    )

    union: set = set()
    count = [0]

    def visitor(quorum: List[int]) -> bool:
        union.update(quorum)
        count[0] += 1
        return False  # keep enumerating

    state = _SearchState(budget_calls=budget_calls)
    needed = 4 * len(scc) + 1000
    old_limit = sys.getrecursionlimit()
    if needed > old_limit:
        sys.setrecursionlimit(needed)
    try:
        iterate_minimal_quorums(
            list(scc), [], graph, visitor,
            lambda _candidate: False,  # half-size prune disabled
            state, None,
        )
    finally:
        if needed > old_limit:
            sys.setrecursionlimit(old_limit)
    if state.budget_exceeded:
        return None, count[0]
    return sorted(union), count[0]
