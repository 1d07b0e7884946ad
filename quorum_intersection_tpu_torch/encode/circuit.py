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
from typing import Dict, List, Optional, Sequence, Tuple

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


# Rank-ordered windows (the JAX package's encode/circuit.py:201-266): the
# sweep's verdict-equivalence proof holds for ANY ordering of the SCC — any
# single node may be fixed out of the enumeration and any assignment of the
# rest to index bits is exhaustive.  The ordering is therefore a free perf
# knob: candidates composed of low-bit nodes occupy low window indices, so
# putting the nodes most likely to form a (minimal) quorum at the LOW bits
# shrinks the expected first-hit window of a `false` verdict, while low-rank
# nodes ride the high bits.  Scores: top-tier membership (union of minimal
# quorums, budget-bounded) first, PageRank second, and a deterministic
# node-index tie-break so two runs in one process order identically.
# Witness decode is order-transparent — the sweep keeps the permuted
# graph-space id list and maps hit bits back through it before the host
# recheck — and the permutation is stamped into cert provenance.  PageRank
# runs as the NumPy model on the host (never the kernel), so the order is
# bit-identical to the JAX package's.

# B&B call budget for the top-tier score component: bounded so ordering
# setup stays a fraction of any sweep it precedes; exceeding it (or any
# analytics failure) drops the component, leaving PageRank.
RANK_ORDER_TOP_TIER_BUDGET = 200_000


def rank_order_nodes(
    graph: TrustGraph,
    scc: Sequence[int],
    *,
    top_tier_budget: int = RANK_ORDER_TOP_TIER_BUDGET,
) -> Tuple[List[int], Dict[str, object]]:
    """Rank-order an SCC for sweep enumeration: ``(ordered, meta)``.

    ``ordered[0]`` is the node fixed OUT of the enumeration (the
    lowest-ranked member — it occupies "bit infinity"); ``ordered[1 + j]``
    is enumeration bit *j*, descending rank, so the highest-ranked nodes
    occupy the lowest window bits.  ``meta`` is the provenance stamp
    (mode/source/fixed node id/bit → node map) certificates carry.
    """
    from quorum_intersection_tpu_torch.analytics.pagerank import pagerank_np

    ranks = pagerank_np(graph)
    tier: frozenset = frozenset()
    source = "pagerank"
    try:
        from quorum_intersection_tpu_torch.analytics.top_tier import top_tier

        members, _ = top_tier(graph, list(scc), budget_calls=top_tier_budget)
        if members:
            tier = frozenset(members)
            source = "pagerank+top-tier"
    except Exception:  # noqa: BLE001 — ordering is a heuristic, never fatal
        pass
    best_first = sorted(scc, key=lambda v: (0 if v in tier else 1, -float(ranks[v]), v))
    ordered = [best_first[-1]] + best_first[:-1]
    meta: Dict[str, object] = {
        "mode": "rank",
        "source": source,
        "fixed": graph.node_ids[ordered[0]],
        # The full permutation in graph-space ids (bit j = bit_nodes[j]), so
        # any ordered certificate lets a consumer reconstruct the enumeration.
        "bit_nodes": [graph.node_ids[v] for v in ordered[1:]],
    }
    return ordered, meta


# Canonical pad ladder: node and unit counts round UP to the nearest rung so a
# packed block's shape is one of a handful of buckets.  Beyond the ladder the
# exact size is kept.
PAD_LADDER = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


def ladder_up(x: int) -> int:
    """Smallest :data:`PAD_LADDER` rung holding ``x`` (identity beyond the
    ladder) — the rounding primitive of :func:`pad_targets` and of the
    lane-packing slot planner."""
    for rung in PAD_LADDER:
        if x <= rung:
            return rung
    return x


def pad_targets(n: int, n_units: int) -> tuple:
    """Canonical padded ``(n, n_units)`` for one circuit: each dimension
    rounds up to the smallest :data:`PAD_LADDER` rung that holds it (identity
    beyond the ladder).  Two invariants the kernels read off the shapes are
    kept: ``n_units >= n`` (they slice ``sat[..., :n]``, so every padded node
    index needs a unit row) and the STRICT ``n_units > n`` of a circuit with
    inner units (collapsing it to equality would skip the child passes)."""
    n_pad = ladder_up(n)
    if n_units <= n:
        return n_pad, n_pad
    return n_pad, ladder_up(max(n_units, n_pad + 1))


def pad_circuit(circuit: Circuit, n_to: int, units_to: int) -> Circuit:
    """Grow a circuit to ``(n_to, units_to)`` with inert padding — equal
    satisfaction semantics for every availability row supported on the
    original ``n`` nodes.

    Padded node COLUMNS carry zero votes in every unit, and padded unit ROWS
    get the Q2 never-satisfiable encoding (threshold 1 over zero members).
    Callers keep padded nodes out of every availability input (the packed
    decode does so structurally: its ``pos`` table maps only real nodes).
    """
    if n_to == circuit.n and units_to == circuit.n_units:
        return circuit
    if n_to < circuit.n or units_to < max(circuit.n_units, n_to):
        raise ValueError(
            f"pad target ({n_to}, {units_to}) below circuit shape "
            f"({circuit.n}, {circuit.n_units})"
        )
    if circuit.n_units > circuit.n and units_to <= n_to:
        raise ValueError(
            "padding would collapse n_units > n — the inner-unit marker "
            "the kernels key child propagation on"
        )
    thresholds = np.ones(units_to, dtype=np.int32)  # Q2: unsatisfiable filler
    thresholds[: circuit.n_units] = circuit.thresholds
    members = np.zeros((units_to, n_to), dtype=np.uint8)
    members[: circuit.n_units, : circuit.n] = circuit.members
    child = np.zeros((units_to, units_to), dtype=np.uint8)
    child[: circuit.n_units, : circuit.n_units] = circuit.child
    unit_depth = np.zeros(units_to, dtype=np.int32)
    unit_depth[: circuit.n_units] = circuit.unit_depth
    return Circuit(
        n=n_to,
        n_units=units_to,
        depth=circuit.depth,
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


def restrict_two_family(circuit_a: Circuit, circuit_b: Circuit, scc: List[int]) -> tuple:
    """Two-circuit restriction for the relaxed two-family query: both
    families' circuits projected onto the same SCC columns in the same
    member order, ``(a_scoped, b_scoped, b_q6)`` (the JAX package's
    ``restrict_two_family``).  ``a_scoped`` is family A's candidate-scoped
    restriction (the enumeration side, one :func:`max_quorum_np` fixpoint per
    window batch); ``b_scoped`` family B's scoped twin, the fast overlap guard
    (a B-quorum inside ``scc ∖ qa`` under scoped availability is a real
    B-quorum); ``b_q6`` B's whole-graph-availability fold.  Both circuits must
    be encoded over one node set."""
    if circuit_a.n != circuit_b.n:
        raise ValueError(
            f"two-family circuits must share one node set; got {circuit_a.n} != {circuit_b.n} nodes"
        )
    a_scoped, _a_q6 = restrict_circuit_pair(circuit_a, scc)
    b_scoped, b_q6 = restrict_circuit_pair(circuit_b, scc)
    return a_scoped, b_scoped, b_q6


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



# ---------------------------------------------------------------------------
# Lane packing: a PackedCircuit tiles K independent SCC-restricted circuits
# side by side along the lane axis into ONE circuit with block-diagonal
# structure, so one batched sweep resolves K verdicts at once.
#
# Invariants (pinned against the JAX package by tests/test_torch_packing.py):
#
# - **block-diagonal inertness**: group g's units carry votes ONLY from group
#   g's lane columns, and the child matrix links only units of the same
#   group, so each group's fixpoint is computed exactly as it would be alone;
# - **root-unit layout**: lane ``g*slot + j`` (j < n_g) is group g's node j
#   AND unit ``g*slot + j`` is its root unit; padded lane slots get the Q2
#   never-satisfiable filler;
# - **decode-map contract**: :meth:`PackedCircuit.decode_tables` is the ONE
#   source of the per-group decode — group-local bit j toggles local node
#   j+1, node 0 fixed out exactly as in the unpacked sweep.
#
# Members must be SCC-restricted (restrict_circuit_pair): restriction keeps
# the root-unit layout and folds all outside availability into thresholds,
# so the packed block needs no frozen row.

# The lane budget one pack tries to fill (K*slot <= LANE_TILE).
LANE_TILE = 128


@dataclass
class PackedCircuit:
    """K independent circuits fused into one block-diagonal :class:`Circuit`.

    ``circuit`` is the scoped (Q-side) fusion; ``circuit_d`` the Q6-fold
    (D-probe) twin sharing every array except thresholds (None when every
    member was scope-to-scc).  ``slot`` is the uniform lane width per group;
    group g's real nodes live at lanes ``[g*slot, g*slot + sizes[g])``.
    """

    circuit: Circuit
    circuit_d: Optional[Circuit]
    groups: int
    slot: int
    sizes: Tuple[int, ...]
    # Pack provenance: the originating request id per lane group, aligned
    # with ``sizes``; None for packs formed outside the serve drain.
    origins: Optional[Tuple[str, ...]] = None

    @property
    def origin_count(self) -> int:
        """Distinct contributing origins (0 when provenance is untracked)."""
        return len(set(self.origins)) if self.origins else 0

    @property
    def fill_pct(self) -> float:
        """Pack occupancy: verdict-bearing lanes / padded lane width."""
        return 100.0 * float(sum(self.sizes)) / float(max(self.circuit.n, 1))

    def lane_base(self, g: int) -> int:
        return g * self.slot

    def decode_tables(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Per-lane-group decode map: ``(pos, scc_mask, lane_group, group_ind)``.

        - ``pos``        (n,) int32 — enumeration bit per lane (31 = not
          enumerated): group g's local node j >= 1 decodes bit j-1 of that
          group's candidate index; local node 0 is fixed out;
        - ``scc_mask``   (n,) float32 — 1 on every real lane;
        - ``lane_group`` (n,) int32 — owning group per lane (padded lanes map
          to group 0; their ``pos`` of 31 decodes them to 0 regardless);
        - ``group_ind``  (n, K) float32 — lane-to-group indicator for the
          per-group survivor counts.
        """
        n = self.circuit.n
        pos = np.full((n,), 31, dtype=np.int32)
        scc_mask = np.zeros((n,), dtype=np.float32)
        lane_group = np.zeros((n,), dtype=np.int32)
        group_ind = np.zeros((n, self.groups), dtype=np.float32)
        for g, size in enumerate(self.sizes):
            base = g * self.slot
            scc_mask[base : base + size] = 1.0
            lane_group[base : base + size] = g
            group_ind[base : base + size, g] = 1.0
            for j in range(1, size):
                pos[base + j] = j - 1
        return pos, scc_mask, lane_group, group_ind


def plan_packs(sizes: Sequence[int], lane_tile: int = LANE_TILE) -> List[List[int]]:
    """Greedy pack plan: indices into ``sizes`` grouped so each pack's
    ``K * slot`` fits one lane tile, where ``slot`` is the ladder rung of the
    pack's LARGEST member (descending-size order keeps slots tight).  Jobs
    wider than a tile get a singleton pack."""
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    packs: List[List[int]] = []
    cur: List[int] = []
    capacity = 0
    for i in order:
        if cur and len(cur) < capacity:
            cur.append(i)
            continue
        slot = ladder_up(max(int(sizes[i]), 1))
        capacity = max(1, lane_tile // slot)
        cur = [i]
        packs.append(cur)
    return packs


def pack_circuits(
    members: Sequence[Tuple[Circuit, Optional[Circuit]]],
    lane_tile: int = LANE_TILE,
    origins: Optional[Sequence[str]] = None,
) -> PackedCircuit:
    """Fuse K ``(scoped, q6_or_None)`` circuit pairs into one
    :class:`PackedCircuit` (invariants in the section comment above).

    Every member must have root-unit layout (unit j = node j's quorum set for
    j < n) and a Q6 twin, when present, sharing the scoped member's shapes.
    The fused block rounds up to the canonical :data:`PAD_LADDER` shape.
    """
    if not members:
        raise ValueError("pack_circuits needs at least one circuit")
    if origins is not None and len(origins) != len(members):
        raise ValueError(f"{len(origins)} origins for {len(members)} members: pack "
                         f"provenance must be lane-group-aligned")
    sizes = tuple(c.n for c, _ in members)
    for c, d in members:
        if d is not None and (d.n != c.n or d.n_units != c.n_units):
            raise ValueError(
                f"q6 twin shape {(d.n, d.n_units)} does not match scoped "
                f"member {(c.n, c.n_units)}"
            )
    k = len(members)
    slot = ladder_up(max(max(sizes), 1))
    if k > 1 and k * slot > lane_tile:
        raise ValueError(
            f"{k} groups of slot {slot} exceed the {lane_tile}-lane tile; "
            f"plan packs with plan_packs()"
        )
    n_raw = k * slot
    inner_total = sum(c.n_units - c.n for c, _ in members)
    u_raw = n_raw + inner_total

    thresholds = np.ones(u_raw, dtype=np.int32)  # Q2 filler in padded slots
    thresholds_d = np.ones(u_raw, dtype=np.int32)
    members_m = np.zeros((u_raw, n_raw), dtype=np.uint8)
    child = np.zeros((u_raw, u_raw), dtype=np.uint8)
    unit_depth = np.zeros(u_raw, dtype=np.int32)
    any_d = any(d is not None for _, d in members)

    inner_base = n_raw
    for g, (c, d) in enumerate(members):
        base = g * slot
        n_g = c.n
        umap = np.concatenate([
            np.arange(base, base + n_g, dtype=np.int64),
            np.arange(inner_base, inner_base + (c.n_units - n_g), dtype=np.int64),
        ])
        thresholds[umap] = c.thresholds
        thresholds_d[umap] = c.thresholds if d is None else d.thresholds
        members_m[np.ix_(umap, np.arange(base, base + n_g))] = c.members
        child[np.ix_(umap, umap)] = c.child
        unit_depth[umap] = c.unit_depth
        inner_base += c.n_units - n_g

    depth = max(c.depth for c, _ in members)
    fused = Circuit(
        n=n_raw, n_units=u_raw, depth=depth, thresholds=thresholds,
        members=members_m, child=child, unit_depth=unit_depth,
    )
    fused_d: Optional[Circuit] = None
    if any_d:
        # The Q6 twin shares every array except thresholds.
        fused_d = Circuit(
            n=n_raw, n_units=u_raw, depth=depth, thresholds=thresholds_d,
            members=members_m, child=child, unit_depth=unit_depth,
        )

    n_to, units_to = pad_targets(n_raw, u_raw)
    fused = pad_circuit(fused, n_to, units_to)
    if fused_d is not None:
        fused_d = pad_circuit(fused_d, n_to, units_to)
    return PackedCircuit(circuit=fused, circuit_d=fused_d, groups=k, slot=slot, sizes=sizes,
                         origins=tuple(origins) if origins is not None else None)


# ---------------------------------------------------------------------------
# Bitset encoding: the same threshold circuit as packed uint32 membership
# words, for the intersect-and-popcount sweep kernel.  Word counts derive
# from the circuit as given (``words = ceil(n/32)``, ``unit_words =
# ceil(n_units/32)``); thresholds, unit_depth and the inner-set DAG are the
# dense arrays verbatim; a membership bit holds a vote count of 0 or 1 only,
# so circuits with repeated validators or inner sets are not encodable
# (callers gate on :func:`bitset_supported`).

BITSET_WORD_BITS = 32


def pack_mask_words(mask: np.ndarray, words: int) -> np.ndarray:
    """Pack 0/1 rows ``(..., m)`` into uint32 words ``(..., words)``: bit
    ``j % 32`` of word ``j // 32`` is column *j* (LSB-first).  Any nonzero
    value sets its bit."""
    mask = np.asarray(mask)
    m = mask.shape[-1]
    if m > words * BITSET_WORD_BITS:
        raise ValueError(f"{m} columns do not fit {words} uint32 words")
    padded = np.zeros(mask.shape[:-1] + (words * BITSET_WORD_BITS,), dtype=np.uint64)
    padded[..., :m] = mask != 0
    shifts = np.uint64(1) << np.arange(BITSET_WORD_BITS, dtype=np.uint64)
    packed = (padded.reshape(mask.shape[:-1] + (words, BITSET_WORD_BITS)) * shifts).sum(
        axis=-1
    )
    return packed.astype(np.uint32)


def unpack_mask_words(packed: np.ndarray, m: int) -> np.ndarray:
    """Inverse of :func:`pack_mask_words`: ``(..., words)`` uint32 →
    ``(..., m)`` uint8 0/1."""
    packed = np.asarray(packed, dtype=np.uint32)
    j = np.arange(m)
    return (
        (packed[..., j // BITSET_WORD_BITS] >> (j % BITSET_WORD_BITS).astype(np.uint32))
        & np.uint32(1)
    ).astype(np.uint8)


def bitset_supported(circuit: Circuit) -> bool:
    """True iff every member and child vote count is 0/1."""
    return (
        int(circuit.members.max(initial=0)) <= 1
        and int(circuit.child.max(initial=0)) <= 1
    )


@dataclass(frozen=True)
class BitsetCircuit:
    """Bitset twin of :class:`Circuit`: identical thresholds/DAG, packed
    uint32 vote rows.

    - ``member_words`` (U, words)      — bit *v* of unit *u*'s row set iff
      node *v* votes in unit *u*;
    - ``child_words``  (U, unit_words) — bit *c* set iff unit *c* is a child
      of unit *u*; ``None`` when the circuit has no inner units;
    - ``thresholds`` / ``unit_depth`` / ``depth`` — the dense arrays verbatim.
    """

    n: int
    n_units: int
    depth: int
    words: int
    unit_words: int
    thresholds: np.ndarray
    member_words: np.ndarray
    child_words: Optional[np.ndarray]
    unit_depth: np.ndarray

    def decode_members(self) -> np.ndarray:
        """(U, n) uint8 dense member matrix (round-trip of ``members``)."""
        return unpack_mask_words(self.member_words, self.n)

    def decode_child(self) -> Optional[np.ndarray]:
        """(U, U) uint8 dense child matrix (None without inner units)."""
        if self.child_words is None:
            return None
        return unpack_mask_words(self.child_words, self.n_units)


def bitset_encode(circuit: Circuit) -> BitsetCircuit:
    """Encode a (0/1-vote) circuit into its :class:`BitsetCircuit` twin;
    ``ValueError`` for circuits with vote multiplicities > 1."""
    if not bitset_supported(circuit):
        raise ValueError(
            "circuit has vote multiplicities > 1; the bitset encoding is "
            "0/1-vote only — use the dense engine"
        )
    words = (circuit.n + BITSET_WORD_BITS - 1) // BITSET_WORD_BITS
    unit_words = (circuit.n_units + BITSET_WORD_BITS - 1) // BITSET_WORD_BITS
    has_inner = circuit.n_units > circuit.n
    return BitsetCircuit(
        n=circuit.n,
        n_units=circuit.n_units,
        depth=circuit.depth,
        words=max(words, 1),
        unit_words=max(unit_words, 1),
        thresholds=circuit.thresholds.astype(np.int32),
        member_words=pack_mask_words(circuit.members, max(words, 1)),
        child_words=(
            pack_mask_words(circuit.child, max(unit_words, 1)) if has_inner else None
        ),
        unit_depth=circuit.unit_depth,
    )
