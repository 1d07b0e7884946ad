"""Structural snapshot differ over sanitized trust graphs: the structural
half of incremental re-analysis (:mod:`quorum_intersection_tpu_torch.delta`),
the port of the JAX package's ``fbas/diff.py``.

The NP-hard work decomposes per SCC (arXiv:1902.06493 — all minimal quorums
live inside one SCC, and the per-SCC scan is independent), so a snapshot
stream re-solves only the components that changed:

- :func:`scc_fingerprint` — an **SCC-local** fingerprint of one component:
  the resolved quorum sets of its members in SCC-vertex order, with member
  references rewritten to SCC-local ranks and out-of-SCC references
  anonymized to a sentinel.  Two SCCs with equal fingerprints present the
  *identical* restricted solve problem, whatever their global vertex
  indices, display names, or position in the snapshot — so cosmetic churn
  (renames from ``synth.churn_trace``), watcher churn outside the
  component, and global index shifts from node insertion all fingerprint
  identically.  The payload and its JSON encoding are the JAX package's,
  so both packages give the same 32 hex digits and share one fragment
  directory.
- :func:`diff_snapshots` — maps the old snapshot's SCC partition onto the
  new one's and classifies each new SCC as ``unchanged`` (an old SCC with
  the same fingerprint exists), ``dirty`` (members overlap the old
  snapshot but the structure changed — threshold wobble, validator swap,
  or an SCC merge/split restructure), or ``new`` (no member existed
  before), and counts merges (one new SCC spanning >= 2 old ones) and
  splits (one old SCC scattered over >= 2 new ones).

**Soundness note** (why the sentinel is safe): the per-SCC quorum scan
restricts availability to the SCC's members (cpp:645-672 semantics), so an
out-of-SCC reference can never be satisfied — only its *multiplicity*
affects the dual fail counter, never its identity.  The in-SCC
disjointness search is the same under ``scope_to_scc=True``; under the
reference's whole-graph availability (``scope_to_scc=False``, quirk Q6) it
is sound exactly when the SCC is **closed** (no member's quorum set
references an outside node at any nesting depth — true of every sink SCC,
i.e. the quorum-bearing component of every Stellar-like topology).
:func:`scc_fingerprint` therefore also reports closedness, and the verdict
store (``delta.py``) refuses to reuse across snapshots what closedness
cannot justify.
"""

from __future__ import annotations

import hashlib
import json
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from quorum_intersection_tpu_torch.fbas.graph import (
    IndexedQSet,
    TrustGraph,
    group_sccs,
    tarjan_scc,
)

# Sentinel rank for a member reference that points outside the SCC: its
# identity cannot matter (see module docstring), its multiplicity can.
OUTSIDE = -1


def _local_qset(
    q: IndexedQSet, rank: Dict[int, int], closed: List[bool]
) -> List[object]:
    """Canonical SCC-local form of one resolved quorum set: threshold,
    member ranks (:data:`OUTSIDE` for non-members, multiplicity and order
    preserved), inner sets, and the strict-policy dropped-dangling count —
    exactly the inputs the restricted scan and search depend on."""
    if q.threshold is None:
        return [None]
    members: List[int] = []
    for v in q.members:
        r = rank.get(v, OUTSIDE)
        if r == OUTSIDE:
            closed[0] = False
        members.append(r)
    return [
        q.threshold,
        members,
        [_local_qset(iq, rank, closed) for iq in q.inner],
        q.n_dangling,
    ]


def scc_fingerprint(
    graph: TrustGraph, members: List[int]
) -> Tuple[str, bool]:
    """``(fingerprint, closed)`` for one SCC of ``graph``.

    ``members`` must be ascending vertex indices (the :func:`group_sccs`
    contract); their rank in that order is the SCC-local coordinate every
    stored scan/verdict fragment is expressed in.  The fingerprint covers
    the dangling policy (strict vs alias0 resolve to different member
    lists with different ``n_dangling`` semantics) but deliberately NOT
    node names or publicKeys: the verdict is structural, and consumers
    project stored local coordinates back through the *new* snapshot's
    member list, so identity churn costs nothing.  ``closed`` is True iff
    no member's quorum set references an outside vertex at any depth.
    """
    rank = {v: i for i, v in enumerate(members)}
    closed = [True]
    payload = {
        "v": 1,
        "dangling": graph.dangling,
        "size": len(members),
        "qsets": [_local_qset(graph.qsets[v], rank, closed) for v in members],
    }
    digest = hashlib.sha256(
        json.dumps(payload, separators=(",", ":")).encode()
    ).hexdigest()[:32]
    return digest, closed[0]


@dataclass
class SccDelta:
    """One new-snapshot SCC's classification against the old snapshot."""

    index: int  # new-snapshot SCC id (Tarjan completion order)
    kind: str  # "unchanged" | "dirty" | "new"
    fingerprint: str
    closed: bool
    size: int
    old_indices: List[int] = field(default_factory=list)  # by member overlap


@dataclass
class SnapshotDiff:
    """The full old→new SCC partition mapping (see module docstring)."""

    deltas: List[SccDelta]
    old_n_sccs: int
    new_n_sccs: int
    unchanged: int = 0
    dirty: int = 0
    new: int = 0
    merges: int = 0  # new SCCs spanning >= 2 old SCCs
    splits: int = 0  # old SCCs scattered over >= 2 new SCCs

    def summary(self) -> Dict[str, int]:
        return {
            "old_sccs": self.old_n_sccs,
            "new_sccs": self.new_n_sccs,
            "unchanged": self.unchanged,
            "dirty": self.dirty,
            "new": self.new,
            "merges": self.merges,
            "splits": self.splits,
        }

    def dirty_or_new(self) -> List[SccDelta]:
        return [d for d in self.deltas if d.kind != "unchanged"]


def _partition(graph: TrustGraph) -> List[List[int]]:
    count, comp = tarjan_scc(graph.n, graph.succ)
    return group_sccs(graph.n, comp, count)


def diff_snapshots(
    old: TrustGraph,
    new: TrustGraph,
    *,
    old_parts: Optional[List[List[int]]] = None,
    old_fps_list: Optional[List[Tuple[str, bool]]] = None,
    new_parts: Optional[List[List[int]]] = None,
    new_fps_list: Optional[List[Tuple[str, bool]]] = None,
) -> SnapshotDiff:
    """Classify every SCC of ``new`` against ``old`` (see module docstring).

    ``unchanged`` is decided purely structurally (fingerprint match against
    the old partition's fingerprint multiset — each old SCC justifies at
    most one new SCC, so a duplicated component still counts once per
    copy); ``old_indices`` is decided by member-publicKey overlap, which is
    what makes merges and splits visible even when every fingerprint
    changed.

    The keyword arguments let a caller that already partitioned and
    fingerprinted either snapshot (the incremental engine does both as its
    structural prefix, and keeps the previous snapshot's) hand the work in
    instead of paying Tarjan + sha256 again — the diff itself then costs
    only the overlap bookkeeping.
    """
    old_sccs = _partition(old) if old_parts is None else old_parts
    new_sccs = _partition(new) if new_parts is None else new_parts
    if old_fps_list is None:
        old_fps_list = [scc_fingerprint(old, m) for m in old_sccs]
    if new_fps_list is None:
        new_fps_list = [scc_fingerprint(new, m) for m in new_sccs]
    old_fps = Counter(fp for fp, _ in old_fps_list)
    old_scc_of: Dict[str, int] = {}
    for sid, m in enumerate(old_sccs):
        for v in m:
            old_scc_of[old.node_ids[v]] = sid
    deltas: List[SccDelta] = []
    claimed: Counter = Counter()  # old scc id → # new SCCs overlapping it
    for sid, members in enumerate(new_sccs):
        fp, closed = new_fps_list[sid]
        old_ids = sorted({
            old_scc_of[new.node_ids[v]]
            for v in members if new.node_ids[v] in old_scc_of
        })
        for oid in old_ids:
            claimed[oid] += 1
        if old_fps[fp] > 0:
            old_fps[fp] -= 1
            kind = "unchanged"
        elif old_ids:
            kind = "dirty"
        else:
            kind = "new"
        deltas.append(SccDelta(
            index=sid, kind=kind, fingerprint=fp, closed=closed,
            size=len(members), old_indices=old_ids,
        ))
    diff = SnapshotDiff(
        deltas=deltas, old_n_sccs=len(old_sccs), new_n_sccs=len(new_sccs),
    )
    for d in deltas:
        if d.kind == "unchanged":
            diff.unchanged += 1
        elif d.kind == "dirty":
            diff.dirty += 1
        else:
            diff.new += 1
        if len(d.old_indices) >= 2:
            diff.merges += 1
    diff.splits = sum(1 for n in claimed.values() if n >= 2)
    return diff


def project(local: Optional[List[int]], members: List[int]) -> Optional[List[int]]:
    """SCC-local ranks → this snapshot's global vertex indices (the inverse
    of the rank map :func:`scc_fingerprint` canonicalizes under)."""
    if local is None:
        return None
    return [members[r] for r in local]


def localize(
    quorum: Optional[List[int]], members: List[int]
) -> Optional[List[int]]:
    """Global vertex indices → SCC-local ranks; ``None`` when any vertex
    falls outside ``members`` (the caller must then not cache — a witness
    that escapes the SCC is exactly the unsoundness closedness guards)."""
    if quorum is None:
        return None
    rank = {v: i for i, v in enumerate(members)}
    local: List[int] = []
    for v in quorum:
        r = rank.get(v)
        if r is None:
            return None
        local.append(r)
    return local
