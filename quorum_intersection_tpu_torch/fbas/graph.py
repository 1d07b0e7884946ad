"""Trust digraph construction + Tarjan SCC.

Capability parity with the reference's ``buildDependencyGraph``
(the reference tool's `quorum_intersection.cpp:438-473`) and its use of Boost
``strong_components`` (cpp:620-622), with one deliberate semantic fix:

**Dangling validator references (SURVEY.md §2.3-Q1).**  The reference resolves
validator IDs through ``unordered_map::operator[]`` (cpp:456), so an unknown ID
silently default-inserts vertex 0 — unknown validators alias to the *first node
in the JSON file*.  The principled default here is ``dangling="strict"``: an
unknown validator can never be available, which for threshold semantics is
exactly equivalent to dropping it from the member list (each never-available
member decrements the dual fail counter once, cpp:108 — i.e. members-1 with the
same threshold).  ``dangling="alias0"`` reproduces the reference bug bit-for-bit
for differential testing.  Both verdicts agree on all bundled fixtures
(SURVEY.md §2.3-Q1 [verified]).

Parallel edges and self-loops are preserved with multiplicity — one edge per
validator occurrence at every nesting depth (cpp:455-464) — because both the
branching heuristic's in-degree (cpp:224-229) and PageRank's out-degree and
contributions (cpp:561-570) double-count them (SURVEY.md §2.3-Q7).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from quorum_intersection_tpu_torch.fbas.schema import Fbas, QSet

DanglingPolicy = str  # "strict" | "alias0"


@dataclass(frozen=True)
class IndexedQSet:
    """A quorum set with validator IDs resolved to vertex indices.

    ``threshold is None`` still means "never satisfiable" (null qset, Q2).
    Under the strict dangling policy, dropped members are counted in
    ``n_dangling`` so diagnostics can report them.
    """

    threshold: Optional[int]
    members: Tuple[int, ...] = ()
    inner: Tuple["IndexedQSet", ...] = ()
    n_dangling: int = 0


@dataclass
class TrustGraph:
    """Directed trust graph over vertex indices 0..n-1.

    ``succ[i]`` lists successors *with multiplicity* (parallel edges and
    self-loops preserved, Q7).  ``qsets[i]`` is vertex i's indexed quorum set.
    """

    n: int
    succ: List[List[int]]
    qsets: List[IndexedQSet]
    node_ids: List[str] = field(default_factory=list)  # publicKeys
    names: List[str] = field(default_factory=list)  # raw names ("" if unset)
    dangling_refs: int = 0
    # The dangling policy this graph was BUILT under ("strict" | "alias0"):
    # verdict certificates (qi-cert/1) record it so the independent checker
    # evaluates the same FBAS semantics the verdict used.
    dangling: DanglingPolicy = "strict"

    def label(self, v: int) -> str:
        """Display label: name if non-empty else publicKey (cpp:507, :596-597)."""
        return self.names[v] if self.names[v] else self.node_ids[v]

    @property
    def n_edges(self) -> int:
        return sum(len(s) for s in self.succ)

    def in_degrees(self) -> List[int]:
        deg = [0] * self.n
        for srcs in self.succ:
            for d in srcs:
                deg[d] += 1
        return deg


def _index_qset(
    q: QSet,
    index: dict,
    policy: DanglingPolicy,
    out_edges: List[int],
    stats: List[int],
) -> IndexedQSet:
    if q.is_null:
        return IndexedQSet(threshold=None)
    members: List[int] = []
    n_dangling = 0
    for key in q.validators:
        v = index.get(key)
        if v is None:
            stats[0] += 1
            if policy == "alias0":
                # Reference-compatible aliasing to vertex 0 (cpp:456, Q1).
                v = 0
            else:
                n_dangling += 1
                continue  # strict: never-available ≡ dropped member
        members.append(v)
        out_edges.append(v)
    inner = tuple(_index_qset(iq, index, policy, out_edges, stats) for iq in q.inner)
    return IndexedQSet(
        threshold=q.threshold, members=tuple(members), inner=inner, n_dangling=n_dangling
    )


def build_graph(fbas: Fbas, dangling: DanglingPolicy = "strict") -> TrustGraph:
    """Build the trust digraph: one vertex per node (JSON order, cpp:441-446),
    one edge owner→validator per occurrence at every nesting depth (cpp:448-465).
    """
    if dangling not in ("strict", "alias0"):
        raise ValueError(f"unknown dangling policy {dangling!r}")
    n = len(fbas)
    succ: List[List[int]] = []
    qsets: List[IndexedQSet] = []
    stats = [0]
    for node in fbas:
        out_edges: List[int] = []
        qsets.append(_index_qset(node.qset, fbas.index, dangling, out_edges, stats))
        succ.append(out_edges)
    return TrustGraph(
        n=n,
        succ=succ,
        qsets=qsets,
        node_ids=[node.public_key for node in fbas],
        names=[node.name for node in fbas],
        dangling_refs=stats[0],
        dangling=dangling,
    )


def tarjan_scc(n: int, succ: List[List[int]]) -> Tuple[int, List[int]]:
    """Iterative Tarjan strongly-connected components.

    Returns ``(count, comp)`` where ``comp[v]`` is v's component id.
    Components are numbered in completion order, which is *reverse topological
    order of the condensation* — component ids increase from sinks toward
    sources, the same ordering contract Boost's ``strong_components`` gives the
    reference (cpp:643-644 relies on component 0 being "last in topological
    order", i.e. a sink reachable from low-numbered vertices).
    """
    UNVISITED = -1
    comp = [UNVISITED] * n
    low = [0] * n
    disc = [0] * n
    on_stack = [False] * n
    stack: List[int] = []
    timer = 0
    count = 0

    for root in range(n):
        if comp[root] != UNVISITED or disc[root]:
            continue
        # Explicit DFS stack of (vertex, iterator position).
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                timer += 1
                disc[v] = timer
                low[v] = timer
                stack.append(v)
                on_stack[v] = True
            advanced = False
            edges = succ[v]
            while pi < len(edges):
                w = edges[pi]
                pi += 1
                if not disc[w]:
                    work[-1] = (v, pi)
                    work.append((w, 0))
                    advanced = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], disc[w])
            if advanced:
                continue
            work.pop()
            if low[v] == disc[v]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp[w] = count
                    if w == v:
                        break
                count += 1
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
    return count, comp


def group_sccs(n: int, comp: List[int], count: int) -> List[List[int]]:
    """Group vertices by component id, vertices ascending within each group —
    the same grouping the reference builds at cpp:624-633."""
    sccs: List[List[int]] = [[] for _ in range(count)]
    for v in range(n):
        sccs[comp[v]].append(v)
    return sccs
