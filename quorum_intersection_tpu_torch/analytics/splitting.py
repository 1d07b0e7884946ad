"""Safety-margin analytics: splitting sets of the quorum structure (the port
of the JAX package's ``analytics/splitting.py``, on the host as there).

A set ``S`` of validators is **splitting** when tolerating ``S`` as
byzantine leaves two disjoint quorums among the survivors — i.e. if the
members of ``S`` misbehave they can drive the network into divergence.
The size of a minimum splitting set is the standard safety-margin number
of an FBAS, complementing
:mod:`.resilience`'s liveness number;
together with the intersection verdict they form the classic FBAS-analysis
triple.

Deletion follows the FBAS ``delete`` operation (byzantine semantics, not
crash semantics): removing ``S`` from a quorum set *decrements its
threshold* by the number of deleted members — byzantine nodes vote for
both sides, so they satisfy everyone's slices.  A (sub-)set whose
threshold reaches 0 becomes **trivially satisfiable**: a trivially
satisfiable inner set contributes its vote to the parent unconditionally
(encoded by dropping it and decrementing the parent threshold), and a
node whose whole slice becomes trivial is encoded as ``1-of-[self]`` —
satisfiable whenever the node itself is available (quirk Q4 makes that
exactly "always").

A candidate is splitting only when the reduced FBAS exhibits an actual
disjoint-quorum WITNESS (``q1``/``q2``); a reduced FBAS with *no* quorum
at all is a halt — that is a blocking set's signature, not a split.

Each candidate check is a full intersection solve of the reduced FBAS
(deletion changes the SCC structure, so nothing short of the whole
pipeline is sound) — NP-hard per check, so the exact search is doubly
capped: candidate pool ≤ :data:`POOL_LIMIT` and subset size ≤ ``max_k``.
Minimal splitting sets live inside the quorum-bearing SCCs (deleting a
node no quorum uses cannot create a disjoint pair), which keeps the pool
small on snapshot-shaped networks.
"""

from __future__ import annotations

from itertools import combinations
from typing import List, Optional, Sequence, Tuple

# Candidate pool cap: C(pool, k) solves is the cost envelope.
POOL_LIMIT = 22
DEFAULT_MAX_K = 2


def _scrub(qset, removed: frozenset) -> Tuple[Optional[dict], bool]:
    """FBAS ``delete`` on one quorum set: returns ``(qset', trivial)``
    where ``trivial`` means the set BECAME trivially satisfiable through
    deletions.  A threshold that was ≤ 0 to begin with keeps the pinned Q3
    semantics (never satisfiable) — only deletion-driven drops flip it."""
    if not isinstance(qset, dict):
        return qset, False
    t = qset.get("threshold")
    if isinstance(t, str):
        # ptree compat: the schema accepts numeric-string thresholds
        # (schema.py); mirror it or deletion silently degrades.
        try:
            t = int(t)
        except ValueError:
            return qset, False  # malformed: leave for the schema to reject
    if not isinstance(t, int) or isinstance(t, bool):
        return qset, False  # malformed: leave for the schema to reject
    if t <= 0:
        return qset, False  # Q3: degenerate threshold stays unsatisfiable
    validators = [v for v in (qset.get("validators") or []) if v not in removed]
    t -= len(qset.get("validators") or []) - len(validators)
    inner: List[dict] = []
    for child in qset.get("innerQuorumSets") or []:
        scrubbed, trivial = _scrub(child, removed)
        if trivial:
            t -= 1  # the child now votes unconditionally
        else:
            inner.append(scrubbed)
    if t <= 0:
        return None, True
    return {"threshold": t, "validators": validators, "innerQuorumSets": inner}, False


def delete_nodes(nodes: Sequence[dict], removed_keys: Sequence[str]) -> List[dict]:
    """The FBAS ``delete`` operation over a raw stellarbeat node list."""
    removed = frozenset(removed_keys)
    out = []
    for node in nodes:
        key = node.get("publicKey")
        if key in removed:
            continue
        q = node.get("quorumSet")
        if q is None:
            out.append(dict(node))
            continue
        scrubbed, trivial = _scrub(q, removed)
        if trivial:
            # Whole slice satisfied by byzantine votes: the node is happy in
            # any quorum containing itself (Q4 supplies the availability).
            scrubbed = {"threshold": 1, "validators": [key], "innerQuorumSets": []}
        out.append({**node, "quorumSet": scrubbed})
    return out


def is_splitting(
    nodes: Sequence[dict], removed_keys: Sequence[str], dangling: str = "strict"
) -> bool:
    """True iff deleting ``removed_keys`` (byzantine semantics) leaves two
    disjoint quorums — witnessed, not merely a failed verdict.  ``dangling``
    follows the caller's Q1 policy so the analysis answers the same FBAS
    as the verdict under the same flags.

    The witness requirement is checked by the certificate layer's
    per-member slice-satisfaction audit instead of a bare
    ``q1 is not None``: a candidate counts as splitting only when
    every member of BOTH claimed quorums is actually satisfied — the same
    audit ``tools/check_cert.py`` performs, so the analytics and the
    checker cannot disagree about what a witness is.  The solve itself
    runs with ``with_cert=False``: this function sits in
    :func:`minimum_splitting_set`'s combinatorial loop, so per-candidate
    certificate assembly and ``cert.*`` telemetry would be pure overhead
    — the evidence is computed directly, and only for the rare candidate
    whose verdict is actually false."""
    from quorum_intersection_tpu_torch.cert import witness_evidence
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.pipeline import solve

    remaining = delete_nodes(nodes, removed_keys)
    if not remaining:
        return False
    res = solve(remaining, backend="python", dangling=dangling,
                with_cert=False)
    if res.intersects or res.q1 is None or res.q2 is None:
        return False
    # Same deterministic front end the solve ran (res.q1/q2 are vertex
    # indices of this graph), audited member-by-member.
    graph = build_graph(parse_fbas(list(remaining)), dangling=dangling)
    members = [*witness_evidence(graph, res.q1),
               *witness_evidence(graph, res.q2)]
    return bool(members) and all(m["satisfied"] for m in members)


def quorum_scc_keys(nodes: Sequence[dict], dangling: str = "strict") -> List[str]:
    """publicKeys of every quorum-bearing SCC's members — the candidate
    pool for splitting-set search."""
    from quorum_intersection_tpu_torch.fbas.graph import build_graph, group_sccs, tarjan_scc
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.pipeline import scan_scc_quorums

    graph = build_graph(parse_fbas(list(nodes)), dangling=dangling)
    count, comp = tarjan_scc(graph.n, graph.succ)
    sccs = group_sccs(graph.n, comp, count)
    keys: List[str] = []
    for sid, quorum in enumerate(scan_scc_quorums(graph, sccs)):
        if quorum:
            keys.extend(graph.node_ids[v] for v in sccs[sid])
    return keys


def minimum_splitting_set(
    nodes: Sequence[dict],
    max_k: int = DEFAULT_MAX_K,
    dangling: str = "strict",
    pool: Optional[Sequence[str]] = None,
) -> Optional[List[str]]:
    """Smallest splitting set with ≤ ``max_k`` members, searching subsets
    of the quorum-bearing SCCs; None when no such set exists within the
    caps (caller distinguishes "safe up to k" from "pool too large" via
    :func:`quorum_scc_keys`).  k = 0 (the FBAS is already split) returns
    ``[]``.  Pass ``pool`` (e.g. from an already-built graph) to skip the
    internal front-end pass."""
    if pool is None:
        pool = quorum_scc_keys(nodes, dangling=dangling)
    if len(pool) > POOL_LIMIT:
        return None
    for k in range(0, max_k + 1):
        for combo in combinations(pool, k):
            if is_splitting(nodes, combo, dangling=dangling):
                return list(combo)
    return None
