"""Liveness-resilience analytics: blocking sets of the quorum structure (the
port of the JAX package's ``analytics/resilience.py``).

Beyond the reference's feature set (it decides only quorum *intersection* —
safety): a set ``B`` of validators is **blocking** for the quorum-bearing
SCC when no quorum survives inside ``scc ∖ B`` — i.e. the network halts if
every member of ``B`` fails.  The size of a minimal blocking set is the
standard liveness-resilience number of an FBAS (how many node failures can
stop consensus), the dual of the safety question the verdict answers.

Built entirely on the pinned host semantics
(:func:`quorum_intersection_tpu_torch.fbas.semantics.max_quorum` — the same
greatest-fixpoint the verdict engines use, cpp:140-177), so the analysis
inherits every quirk policy (Q2/Q3/Q4) without re-deciding them.

Exactness: :func:`minimal_blocking_set` returns an (inclusion-)**minimal**
blocking set via greedy shrinking — no proper subset of the result is
blocking — which upper-bounds the minimum-cardinality blocking set.  The
minimum itself is NP-hard (hitting set over minimal quorums);
:func:`minimum_blocking_size` does an exact subset search for small SCCs.
"""

from __future__ import annotations

from itertools import combinations
from typing import List, Optional, Sequence

from quorum_intersection_tpu_torch.fbas.graph import TrustGraph
from quorum_intersection_tpu_torch.fbas.semantics import max_quorum

# Exact minimum search is C(|scc|, k)-shaped; cap the SCC size so the CLI
# can never wander into hours of work (the greedy bound has no such limit).
EXACT_LIMIT = 22


def _has_quorum(graph: TrustGraph, members: Sequence[int], blocked: frozenset) -> bool:
    avail = [False] * graph.n
    alive = [v for v in members if v not in blocked]
    for v in alive:
        avail[v] = True
    return bool(max_quorum(graph, alive, avail))


def is_blocking(graph: TrustGraph, scc: Sequence[int], blocked: Sequence[int]) -> bool:
    """True iff no quorum survives in ``scc ∖ blocked`` (SCC-scoped
    availability — the principled scoping, cf. quirk Q6)."""
    return not _has_quorum(graph, scc, frozenset(blocked))


def minimal_blocking_set(graph: TrustGraph, scc: Sequence[int]) -> List[int]:
    """An inclusion-minimal blocking set for the SCC.

    Greedy shrink from the full SCC: drop any member whose removal keeps
    the set blocking, until no single member can be dropped.  Each step is
    one fixpoint, so the whole computation is O(|scc|²) fixpoints.  If the
    SCC holds no quorum at all, the empty set is (vacuously) blocking.
    """
    if is_blocking(graph, scc, ()):
        return []
    blocked = list(scc)
    # Drop higher-degree nodes last: keeping well-connected nodes in the
    # blocking set tends to free more droppable members (pure heuristic —
    # minimality of the RESULT does not depend on the order).
    indeg = graph.in_degrees()
    blocked.sort(key=lambda v: indeg[v])
    # One pass suffices: blocking is upward-monotone, so once dropping v
    # fails (a quorum survives in scc ∖ (blocked ∖ {v})), it fails against
    # every later, smaller blocked set too — a second pass can never drop
    # anything more.
    for v in list(blocked):
        trial = [w for w in blocked if w != v]
        if is_blocking(graph, scc, trial):
            blocked = trial
    return sorted(blocked)


def minimum_blocking_size(
    graph: TrustGraph,
    scc: Sequence[int],
    limit: Optional[int] = None,
    upper: Optional[int] = None,
) -> Optional[int]:
    """Exact minimum-cardinality blocking-set size, or None when |scc|
    exceeds the exact-search cap.  Searches k = 0, 1, 2, … over all
    C(|scc|, k) subsets; the greedy bound caps k so the loop always
    terminates at or below it.  Pass ``upper`` (e.g. the length of an
    already-computed :func:`minimal_blocking_set`) to skip the internal
    greedy pass."""
    cap = EXACT_LIMIT if limit is None else limit
    if len(scc) > cap:
        return None
    if upper is None:
        upper = len(minimal_blocking_set(graph, scc))
    for k in range(upper + 1):
        for combo in combinations(scc, k):
            if is_blocking(graph, scc, combo):
                return k
    return upper
