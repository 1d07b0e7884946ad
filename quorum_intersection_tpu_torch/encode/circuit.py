"""Flatten nested quorum sets into a dense **threshold circuit** suitable for
batched device evaluation (SURVEY.md §7.3 "Nested qsets on TPU").

The reference evaluates slice satisfaction by recursion over qset objects with
dual early-exit counters (the reference tool's `quorum_intersection.cpp:90-138`).
That recursion is hostile to batched kernels (dynamic control flow, pointer
chasing), so we re-express the same math as a monotone threshold-circuit DAG:

- one **unit** per *distinct* quorum set: unit ``i < n`` is node *i*'s
  top-level quorum set; identical inner sets are interned and shared, with a
  repeated inner set contributing its multiplicity as a child vote count;
- ``sat(u) = [ |members(u) ∩ avail| + Σ_{c ∈ children(u)} sat(c) ≥ threshold(u) ]``
- node *i* has a satisfied slice iff ``avail[i] ∧ sat(i)`` — the self-
  availability conjunct is quirk Q4 (cpp:95-98; checking it once at the root is
  equivalent to the reference's per-recursion check because the owner is the
  same at every depth).

The shared circuit is an acyclic DAG; ``depth+1`` synchronous sweeps of the
update rule computed over *all* units converge exactly, where ``depth`` is the
DAG **height** (after sweep *k*, every unit of height < *k* is correct — by
induction on height).  Each sweep is two dense matmuls (``avail @ members``
and ``sat @ childᵀ``) in the plain version, or a few popcounts over bit-planes
per candidate row in the CUDA kernel.  Early-exit counters are pointless on a
device: evaluating everything densely in a batch is the fast path.

Degenerate thresholds are **normalized away at encode time** so device kernels
carry no quirk logic:

- null/empty qset (Q2)      → threshold 1 with zero members: never satisfiable;
- ``threshold == 0`` (Q3)   → ``members + children + 1``: never satisfiable.
  NB the reference's behavior here is *chaotic*, not unsatisfiable: its
  ``threshold == 0`` check sits after the per-member decrements (cpp:105-118),
  so a zero-threshold slice is TRUE iff its first member is unavailable.  We
  deliberately normalize instead of reproducing that (see
  ``fbas/semantics.py:slice_satisfied``);
- ``threshold < 0``         → same normalization (the reference would wrap it
  into an astronomically large unsigned value: never satisfiable);
- ``threshold > members``   → kept as-is (naturally unsatisfiable).

Dangling-reference policy (Q1) is resolved earlier, in
:mod:`quorum_intersection_tpu_torch.fbas.graph`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from quorum_intersection_tpu_torch.fbas.graph import IndexedQSet, TrustGraph

@dataclass
class Circuit:
    """Dense threshold-circuit encoding of a trust graph's quorum sets.

    Array inventory (``U`` = unit count, ``n`` = node count):

    - ``thresholds``  (U,)  int32 — normalized thresholds (see module docs)
    - ``members``     (U,n) uint8 — vote count of node v in unit u's validator
      list: the reference iterates the list, so a validator listed twice
      contributes two votes (cpp:103-110); >255 repeats is rejected as
      pathological input
    - ``child``       (U,U) uint8 — vote count of inner-set unit c within
      unit u (identical inner sets intern to one unit, so a duplicated inner
      set shows up as multiplicity here; same 255 cap)
    - ``unit_depth``  (U,)  int32 — DAG **height** of each unit: 0 for units
      with no children, ``1 + max(child heights)`` otherwise
    - ``depth``       — max height; ``depth+1`` synchronous sweeps evaluate
      the circuit exactly
    """

    n: int
    n_units: int
    depth: int
    thresholds: np.ndarray
    members: np.ndarray
    child: np.ndarray
    unit_depth: np.ndarray


def _check_qset_depth(qsets: List[IndexedQSet]) -> None:
    """Iterative depth guard: the interning recursion below (and the frozen
    dataclass hashes it triggers) must never see a tree deeper than the
    schema-level cap — graphs built through ``parse_fbas`` are pre-capped,
    but programmatically constructed ones are not."""
    from quorum_intersection_tpu_torch.fbas.schema import MAX_QSET_DEPTH

    for root in qsets:
        stack = [(root, 0)]
        while stack:
            q, d = stack.pop()
            if d > MAX_QSET_DEPTH:
                raise ValueError(
                    f"quorumSet nesting exceeds depth {MAX_QSET_DEPTH}"
                )
            stack.extend((iq, d + 1) for iq in q.inner)


def encode_circuit(graph: TrustGraph) -> Circuit:
    """Encode every node's quorum set into one shared threshold circuit.

    Identical inner quorum sets are **interned** — real FBAS configurations
    repeat the same org-level inner sets across every validator of the
    network (a 256-node 16-org network would otherwise carry 16×256 copies of
    16 distinct units).  Sharing keeps the circuit a DAG; the sweep count
    needed for convergence becomes the DAG *height* (longest unit→leaf path),
    stored per unit in ``unit_depth`` with ``depth = max height``.
    """
    n = graph.n
    _check_qset_depth(graph.qsets)

    thresholds_l: List[int] = []
    member_rows: List[dict] = []  # unit → {vertex: vote count}
    child_rows: List[List[int]] = []  # unit → child unit ids
    heights: List[int] = []
    interned: dict = {}

    def new_unit() -> int:
        thresholds_l.append(0)
        member_rows.append({})
        child_rows.append([])
        heights.append(0)
        return len(thresholds_l) - 1

    def fill(unit: int, q: IndexedQSet) -> None:
        n_members = len(q.members) + len(q.inner)
        if q.threshold is None:
            # Q2: null qset — threshold 1 over zero members: never satisfiable.
            thresholds_l[unit] = 1
            return
        if q.threshold <= 0:
            # Q3 normalization: never satisfiable.
            thresholds_l[unit] = n_members + 1
        else:
            thresholds_l[unit] = min(q.threshold, np.iinfo(np.int32).max)
        row = member_rows[unit]
        for v in q.members:
            row[v] = row.get(v, 0) + 1
            if row[v] > np.iinfo(np.uint8).max:
                raise ValueError(f"validator {v} listed >255 times in one quorum set")
        h = 0
        for iq in q.inner:
            cu = intern(iq)
            child_rows[unit].append(cu)
            h = max(h, heights[cu] + 1)
        heights[unit] = h

    def intern(q: IndexedQSet) -> int:
        unit = interned.get(q)
        if unit is None:
            unit = new_unit()
            fill(unit, q)
            interned[q] = unit
        return unit

    # Roots first: unit i is node i's top-level quorum set (kernels rely on
    # this layout); their inner sets are interned/shared below.
    for _ in range(n):
        new_unit()
    for i, q in enumerate(graph.qsets):
        fill(i, q)

    n_units = len(thresholds_l)
    thresholds = np.asarray(thresholds_l, dtype=np.int32)
    members = np.zeros((n_units, n), dtype=np.uint8)
    child = np.zeros((n_units, n_units), dtype=np.uint8)
    unit_depth = np.asarray(heights, dtype=np.int32)
    for u in range(n_units):
        for v, count in member_rows[u].items():
            members[u, v] = count
        for cu in child_rows[u]:
            if child[u, cu] == np.iinfo(np.uint8).max:
                raise ValueError(
                    f"inner quorum set repeated >255 times in one quorum set (unit {u})"
                )
            child[u, cu] += 1

    return Circuit(
        n=n,
        n_units=n_units,
        depth=int(unit_depth.max(initial=0)),
        thresholds=thresholds,
        members=members,
        child=child,
        unit_depth=unit_depth,
    )


def restrict_circuit_pair(circuit: Circuit, scc: List[int]) -> tuple:
    """Project the circuit onto the SCC's columns, folding the constant
    contribution of non-SCC nodes into thresholds — both folds at once:
    ``(scoped, q6)``, identical members/child/unit layout.

    Device searches (sweep, frontier) only ever evaluate availability rows
    whose support lies inside the SCC; every other node's availability is a
    CONSTANT for the whole search — 0 for the candidate-scoped Q-side
    fixpoints, 1 for the Q6 whole-graph-availability probes (cpp:354).
    Constants fold: a unit's non-SCC member votes become a threshold
    reduction, and a unit with no SCC node in its transitive support has a
    statically known satisfaction that folds into its parents the same way.
    What remains is an equivalent circuit over ``len(scc)`` nodes — for a
    1024-node snapshot with a 34-node core, the fixpoint matmuls shrink
    from (B,1024)x(1024,U) to (B,34)x(34,U'), a ~30x work reduction at
    identical semantics.  The dynamic-unit classification is fold-
    independent, so the two variants share every array except thresholds —
    searches that scope their Q-side but probe under Q6 (sweep_step, the
    frontier's flag filter) take one of each.

    Equivalence (pinned by differential tests): for any availability row
    ``a`` with support ⊆ scc,
    ``fixpoint(full, a, frozen)[scc] == fixpoint(restricted, a[scc])``
    where ``frozen`` is the constant outside-availability row of the
    matching fold.  Thresholds may legitimately become <= 0 here
    ("satisfied by constants alone") — the kernels' ``>=`` compare needs
    no special casing.  New node *j* is ``scc[j]``; root-unit layout
    (unit j = node j's qset) is preserved.
    """
    n, U = circuit.n, circuit.n_units
    s = len(scc)
    scc_arr = np.asarray(scc, dtype=np.int64)
    in_s = np.zeros(n, dtype=bool)
    in_s[scc_arr] = True

    members = circuit.members.astype(np.int64)
    child = circuit.child.astype(np.int64)
    const_votes = members[:, ~in_s].sum(axis=1)  # Q6 fold; scoped fold is 0
    has_s_member = members[:, scc_arr].sum(axis=1) > 0

    # Bottom-up (children are always deeper-interned units, so ascending
    # height order visits children first): classify units as dynamic (an
    # SCC node somewhere in the transitive support) and evaluate static
    # units' constant satisfaction under each fold.
    order = np.argsort(circuit.unit_depth, kind="stable")
    dynamic = has_s_member.copy()
    static_sat = {True: np.zeros(U, dtype=bool), False: np.zeros(U, dtype=bool)}
    for u in order:
        kids = np.nonzero(child[u])[0]
        if kids.size and dynamic[kids].any():
            dynamic[u] = True
        if not dynamic[u]:
            for q6 in (False, True):
                votes = const_votes[u] if q6 else 0
                if kids.size:
                    votes += int((child[u, kids] * static_sat[q6][kids]).sum())
                static_sat[q6][u] = votes >= circuit.thresholds[u]

    thr = {q6: circuit.thresholds.astype(np.int64).copy() for q6 in (False, True)}
    for u in np.nonzero(dynamic)[0]:
        kids = np.nonzero(child[u])[0]
        sk = kids[~dynamic[kids]] if kids.size else kids
        for q6 in (False, True):
            if q6:
                thr[q6][u] -= const_votes[u]
            if sk.size:
                thr[q6][u] -= int((child[u, sk] * static_sat[q6][sk]).sum())

    # Keep every SCC root (in scc order — the new root layout) plus the
    # dynamic units reachable from them.  Static children folded above;
    # dynamic units unreachable from SCC roots are dead weight.
    keep: List[int] = [int(v) for v in scc_arr]
    keep_set = set(keep)
    stack = list(keep)
    while stack:
        u = stack.pop()
        for c in np.nonzero(child[u])[0]:
            c = int(c)
            if dynamic[c] and c not in keep_set:
                keep_set.add(c)
                keep.append(c)
                stack.append(c)
    remap = {u: i for i, u in enumerate(keep)}

    U2 = len(keep)
    i32 = np.iinfo(np.int32)
    members2 = np.zeros((U2, s), dtype=np.uint8)
    child2 = np.zeros((U2, U2), dtype=np.uint8)
    thresholds2 = {q6: np.zeros(U2, dtype=np.int32) for q6 in (False, True)}
    for u in keep:
        i = remap[u]
        for q6 in (False, True):
            thresholds2[q6][i] = int(np.clip(thr[q6][u], i32.min + 1, i32.max))
        members2[i] = circuit.members[u, scc_arr]
        for c in np.nonzero(child[u])[0]:
            c = int(c)
            if dynamic[c]:
                child2[i, remap[c]] = circuit.child[u, c]

    depth2 = np.zeros(U2, dtype=np.int32)
    for u in sorted(keep, key=lambda x: int(circuit.unit_depth[x])):
        i = remap[u]
        kids = np.nonzero(child2[i])[0]
        depth2[i] = 0 if kids.size == 0 else int(depth2[kids].max()) + 1

    def build(q6: bool) -> Circuit:
        return Circuit(
            n=s,
            n_units=U2,
            depth=int(depth2.max(initial=0)),
            thresholds=thresholds2[q6],
            members=members2,
            child=child2,
            unit_depth=depth2,
        )

    return build(False), build(True)


def node_sat_np(circuit: Circuit, avail: np.ndarray) -> np.ndarray:
    """NumPy reference evaluator: which nodes have a satisfied slice?

    ``avail``: (..., n) bool.  Returns (..., n) bool.  This is the
    specification the sweep kernels are differentially tested against; it must
    agree with :func:`quorum_intersection_tpu_torch.fbas.semantics.slice_satisfied`.
    """
    avail_f = avail.astype(np.int32)
    base = avail_f @ circuit.members.T.astype(np.int32)  # (..., U)
    sat = np.zeros(avail.shape[:-1] + (circuit.n_units,), dtype=np.int32)
    child_t = circuit.child.T.astype(np.int32)
    for _ in range(circuit.depth + 1):
        sat = ((base + sat @ child_t) >= circuit.thresholds).astype(np.int32)
    return (sat[..., : circuit.n] & avail_f).astype(bool)


def max_quorum_np(circuit: Circuit, avail: np.ndarray) -> np.ndarray:
    """Greatest-fixpoint quorum inside ``avail`` (..., n) — NumPy reference for
    the device fixpoint kernel (parity with cpp:140-177 restricted-availability
    semantics: candidates and availability are the same set here)."""
    cur = avail.astype(bool).copy()
    while True:
        nxt = node_sat_np(circuit, cur)
        if np.array_equal(nxt, cur):
            return cur
        cur = nxt

