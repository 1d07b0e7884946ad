"""Reference-faithful FBAS set semantics on the host (pure Python).

These are the two leaf operations everything else builds on:

- :func:`slice_satisfied` — is a node's quorum slice satisfied by an
  availability set?  Parity with ``containsQuorumSlice``
  (the reference tool's `quorum_intersection.cpp:90-138`), including its dual
  early-exit counters and the quirks pinned in SURVEY.md §2.3:
  Q2 (null qset never satisfiable), Q3 (``threshold == 0`` and
  ``threshold > members`` never satisfiable — the reference gets there via
  unsigned wraparound; we state it directly), Q4 (self-availability required).
- :func:`max_quorum` — the greatest fixpoint of
  ``f(X) = {x ∈ X : slice(x) satisfied by X}`` — parity with
  ``containsQuorum`` (cpp:140-177): repeatedly drop nodes whose slice is not
  satisfied until stable; the survivors are the unique largest quorum inside
  the candidate set (or empty).

The host pipeline uses these for the per-SCC quorum scan and the sweep's
witness recheck.  The device sweep re-derives the same math as dense
threshold-circuit arrays (``encode.circuit``, ``kernels``) and is
differentially tested against these functions.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from quorum_intersection_tpu_torch.fbas.graph import IndexedQSet, TrustGraph


def slice_satisfied(owner: int, qset: IndexedQSet, avail: Sequence[bool]) -> bool:
    """True iff ``owner``'s slice described by ``qset`` is satisfied by ``avail``.

    Mirrors cpp:90-138: requires self-availability (Q4, cpp:95-98), then counts
    available direct members and recursively satisfied inner sets against the
    threshold with dual early exits (``fail = members − threshold + 1``,
    cpp:100).  A null qset (Q2) or a degenerate threshold (Q3) is never
    satisfiable.
    """
    if qset.threshold is None:  # Q2: null/empty quorumSet
        return False
    if not avail[owner]:  # Q4: self must be available
        return False
    t = qset.threshold
    if t <= 0:
        # Q3, corrected: the reference's behavior for threshold == 0 is
        # *chaotic*, not uniformly unsatisfiable — its `threshold == 0` check
        # sits after the per-member decrements (cpp:105-118), so a
        # zero-threshold slice evaluates TRUE iff its first member is
        # unavailable/unsatisfied (fail-- leaves threshold at 0 → cpp:111
        # fires), FALSE if the first member is available (0 wraps to
        # SIZE_MAX) and FALSE with no members at all.  We deliberately do
        # not reproduce that: threshold <= 0 is normalized to "never
        # satisfiable" everywhere (here and in encode/circuit.py).  No real
        # stellarbeat snapshot contains threshold 0; the sanitizer can flag
        # such inputs (--flag-zero-threshold).
        return False
    fail = len(qset.members) + len(qset.inner) - t + 1
    if fail <= 0:  # Q3: threshold > members can never be met
        return False
    for m in qset.members:
        if avail[m]:
            t -= 1
            if t == 0:
                return True
        else:
            fail -= 1
            if fail == 0:
                return False
    for iq in qset.inner:
        if slice_satisfied(owner, iq, avail):
            t -= 1
            if t == 0:
                return True
        else:
            fail -= 1
            if fail == 0:
                return False
    return False


def max_quorum(
    graph: TrustGraph, candidates: Iterable[int], avail: List[bool]
) -> List[int]:
    """Greatest quorum contained in ``candidates`` under availability ``avail``.

    Parity with ``containsQuorum`` (cpp:140-177): iterate
    ``X ← {x ∈ X : slice(x) ⊆ X}`` to its greatest fixpoint.  ``avail`` is
    temporarily narrowed during the iteration and **restored before returning**
    (cpp:171-173) so callers can reuse their availability vector.  Returns the
    surviving candidates (a quorum — every member's slice is satisfied within
    the set) or ``[]``.
    """
    nodes = list(candidates)
    removed: List[int] = []
    while True:
        before = len(nodes)
        kept: List[int] = []
        for v in nodes:
            if slice_satisfied(v, graph.qsets[v], avail):
                kept.append(v)
            else:
                if avail[v]:
                    avail[v] = False
                    removed.append(v)
        nodes = kept
        if len(nodes) == before:
            break
    for v in removed:
        avail[v] = True
    return nodes


def cross_family_disjoint_quorum(graph_b: TrustGraph, exclude: Sequence[int]) -> List[int]:
    """Greatest family-B quorum avoiding ``exclude``: the cross-family
    overlap guard of the relaxed two-family query (Fast Flexible Paxos,
    arXiv:2008.02671).  Nonempty means ``(exclude, result)`` is a disjoint
    cross-family witness.  Both graphs index one node set in one order."""
    banned = set(exclude)
    candidates = [v for v in range(graph_b.n) if v not in banned]
    avail = [v not in banned for v in range(graph_b.n)]
    return max_quorum(graph_b, candidates, avail)


def relaxed_disjoint_witness(
    graph_a: TrustGraph,
    graph_b: TrustGraph,
    members: Sequence[int],
) -> Tuple[Optional[List[int]], Optional[List[int]], int]:
    """Cross-family disjointness search (the host oracle): an A-quorum and
    a B-quorum that do not intersect, or a proof that none exists among the
    A-quorums inside ``members`` (family A's quorum-bearing SCC).

    Enumerates every nonempty subset of ``members``; per window the greatest
    A-quorum within it is one fixpoint, and each distinct nonempty A-quorum
    runs :func:`cross_family_disjoint_quorum` once.  There is no complement
    symmetry, so all ``2^m - 1`` windows are enumerated.  Returns ``(qa, qb,
    windows_enumerated)``, ``qa``/``qb`` None when every A-quorum meets every
    B-quorum."""
    nodes = list(members)
    m = len(nodes)
    avail = [False] * graph_a.n
    enumerated = 0
    seen: Dict[frozenset, bool] = {}
    for window in range(1, 1 << m):
        enumerated += 1
        chosen = [nodes[i] for i in range(m) if window >> i & 1]
        for v in chosen:
            avail[v] = True
        qa = max_quorum(graph_a, chosen, avail)
        for v in chosen:
            avail[v] = False
        if not qa:
            continue
        key = frozenset(qa)
        if key in seen:
            continue
        qb = cross_family_disjoint_quorum(graph_b, qa)
        seen[key] = bool(qb)
        if qb:
            return sorted(qa), sorted(qb), enumerated
    return None, None, enumerated


def is_quorum(graph: TrustGraph, members: Sequence[int]) -> bool:
    """True iff ``members`` is itself a quorum (every slice satisfied within)."""
    unique = sorted(set(members))
    if not unique:
        return False
    avail = [False] * graph.n
    for v in unique:
        avail[v] = True
    return len(max_quorum(graph, unique, avail)) == len(unique)
