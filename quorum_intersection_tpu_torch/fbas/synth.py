"""Synthetic FBAS generators — the seed corpus for differential testing and
benchmarking (SURVEY.md §4.3, BASELINE.json configs).  The port keeps the
generators its chip smoke run and its tests need; the JAX package holds the
full set.  :func:`near_disjoint_cores` is the block-guard pruning preset;
:func:`random_fbas` feeds the frontier's differential cases.  :func:`inner_set_ring_fbas` is the port's own (no counterpart
there): a circuit with hundreds of distinct inner sets inside one SCC, for
the fused kernel's wide satisfaction masks.  :func:`nested_hierarchy`,
:func:`sparse_giant` (the bitset engine's workload), :func:`two_family_preset`
(the relaxed query's two families) and the density
annotations :func:`graph_density` and :func:`scc_qset_density` (the bitset
routing's feature) are the JAX package's, copied unchanged.

All generators emit stellarbeat-style raw dicts (the same shape
:func:`quorum_intersection_tpu_torch.fbas.schema.parse_fbas` accepts), so every
synthetic network also exercises the JSON frontend.

The generators follow the reference fixtures' de-facto test methodology —
*same topology, one knob turned* (SURVEY.md §4.1): each safe generator has a
broken twin differing by a single threshold.
"""

from __future__ import annotations

import random
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

if TYPE_CHECKING:
    from quorum_intersection_tpu_torch.fbas.graph import TrustGraph


def _node(key: str, name: str, qset: Dict) -> Dict:
    return {"publicKey": key, "name": name, "quorumSet": qset}


def _qset(threshold: int, validators: List[str], inner: Optional[List] = None) -> Dict:
    return {
        "threshold": threshold,
        "validators": validators,
        "innerQuorumSets": inner or [],
    }


def keys(n: int, prefix: str = "NODE") -> List[str]:
    return [f"{prefix}{i:04d}" for i in range(n)]


def majority_fbas(n: int, *, broken: bool = False, prefix: str = "NODE") -> List[Dict]:
    """Symmetric k-of-n FBAS with k = n//2 + 1 — all quorums intersect.

    ``broken=True`` turns one knob, mirroring the reference's
    ``broken_trivial.json`` methodology (threshold 2→1 on one node,
    `broken_trivial.json:20`): node 0's threshold drops to 1, making {node0}
    a quorum disjoint from any majority of the remaining nodes.
    """
    ks = keys(n, prefix)
    k = n // 2 + 1
    nodes = []
    for i, key in enumerate(ks):
        t = 1 if (broken and i == 0) else k
        nodes.append(_node(key, f"n{i}", _qset(t, list(ks))))
    return nodes


def hierarchical_fbas(
    n_orgs: int, per_org: int, *, broken: bool = False, org_threshold: Optional[int] = None
) -> List[Dict]:
    """Stellar-like tiered FBAS: each node requires a majority of organizations,
    where an organization counts if a majority of its validators are available —
    expressed with one inner quorum set per organization (nesting depth 1,
    matching the bundled fixtures' observed max depth, SURVEY.md §7.3).

    ``broken=True`` gives the first node a degenerate self-only slice
    (threshold 1 over itself), making {node0} a quorum disjoint from the
    surviving org-majority quorum of everyone else.
    """
    org_keys = [keys(per_org, f"ORG{o}N") for o in range(n_orgs)]
    all_nodes: List[Dict] = []
    t_orgs = org_threshold if org_threshold is not None else n_orgs // 2 + 1
    inner = [_qset(per_org // 2 + 1, list(ok)) for ok in org_keys]
    for o in range(n_orgs):
        for i, key in enumerate(org_keys[o]):
            if broken and o == 0 and i == 0:
                all_nodes.append(_node(key, f"org{o}-v{i}", _qset(1, [key])))
            else:
                all_nodes.append(_node(key, f"org{o}-v{i}", _qset(t_orgs, [], list(inner))))
    return all_nodes


def stellar_like_fbas(
    n_core_orgs: int = 7,
    per_org: int = 3,
    n_watchers: int = 100,
    n_null: int = 28,
    n_dangling: int = 7,
    *,
    broken: bool = False,
    seed: int = 0,
) -> List[Dict]:
    """Stellarbeat-snapshot-shaped network (~150 validators with defaults).

    Mirrors the structural statistics of the bundled `correct.json` snapshot
    scaled up (SURVEY.md §4.1): a small strongly-connected core of
    organizations (the quorum-bearing sink SCC), a long tail of watcher
    nodes that trust the core but are not trusted back (many singleton
    SCCs), a block of null-quorumSet nodes, and a sprinkle of dangling
    validator references.  ``broken=True`` turns one knob in the core —
    org 0's validators drop their org-majority threshold to 1-of-{orgs}
    (trust edges unchanged, so the core SCC stays intact), making the org-0
    trio a quorum disjoint from the quorum of the remaining orgs: the
    search inside the SCC, not the SCC guard, must find it.
    """
    rng = random.Random(seed)
    org_keys = [keys(per_org, f"CORE{o}N") for o in range(n_core_orgs)]
    core_flat = [k for ok in org_keys for k in ok]
    inner = [_qset(per_org // 2 + 1, list(ok)) for ok in org_keys]
    t_orgs = n_core_orgs // 2 + 1
    nodes: List[Dict] = []
    for o in range(n_core_orgs):
        for i, key in enumerate(org_keys[o]):
            t = 1 if (broken and o == 0) else t_orgs
            nodes.append(_node(key, f"core{o}-v{i}", _qset(t, [], list(inner))))
    for w in range(n_watchers):
        trusted = rng.sample(core_flat, min(len(core_flat), rng.randint(3, 7)))
        extra = []
        if w < n_dangling:  # dangling refs concentrated in early watchers
            extra = [f"GONE{w:04d}"]
        t = len(trusted) * 2 // 3 + 1
        nodes.append(_node(f"WATCH{w:04d}", f"w{w}", _qset(t, trusted + extra)))
    for z in range(n_null):
        nodes.append(_node(f"NULLQ{z:04d}", f"z{z}", None))
    rng.shuffle(nodes)  # snapshot order is arbitrary; vertex 0 ≠ core
    return nodes


def benchmark_fbas(
    n_total: int,
    core: int,
    *,
    nested_watchers: bool = False,
    broken: bool = False,
    seed: int = 0,
) -> List[Dict]:
    """North-star verdict-benchmark network (BASELINE.json configs 4-5).

    A ``core``-node symmetric k-of-n majority (k = core//2 + 1 — the
    "k-of-n threshold slices" config) forms the quorum-bearing sink SCC;
    the remaining ``n_total - core`` nodes are a periphery of watchers
    trusting random core subsets, null-qset nodes, and a sprinkle of
    dangling refs — the structural shape of a stellarbeat snapshot
    (SURVEY.md §4.1) scaled to the BASELINE node counts.  The verdict
    therefore requires the full in-SCC disjointness search over the core
    (2^(core-1) candidate subsets), which is what the benchmark times.

    ``nested_watchers=True`` (the "1024-node FBAS with nested inner-sets"
    config) gives every watcher a two-level qset: an innerQuorumSet per
    sampled core pair plus direct validators.  ``broken=True`` turns one
    knob in the core (threshold → 1, the `broken_trivial.json:20`
    methodology) for differential twins.
    """
    if core < 3 or core > n_total:
        raise ValueError(f"need 3 <= core <= n_total, got core={core}, n_total={n_total}")
    rng = random.Random(seed)
    nodes = majority_fbas(core, broken=broken, prefix="CORE")
    core_keys = keys(core, "CORE")
    n_periph = n_total - core
    n_null = n_periph // 10
    n_dangling = min(n_periph // 32, 16)
    for w in range(n_periph - n_null):
        trusted = rng.sample(core_keys, min(core, rng.randint(4, 9)))
        if w < n_dangling:
            trusted = trusted + [f"GONE{w:04d}"]
        inner: List[Dict] = []
        if nested_watchers and len(trusted) >= 6:
            # Two-level slice: pairs of trusted core nodes become 1-of-2
            # inner sets (nesting depth 1 below the watcher's own qset).
            split = len(trusted) // 2
            inner = [
                _qset(1, [trusted[split + 2 * j], trusted[split + 2 * j + 1]])
                for j in range((len(trusted) - split) // 2)
            ]
            trusted = trusted[:split]
        t = (len(trusted) + len(inner)) * 2 // 3 + 1
        nodes.append(_node(f"WATCH{w:04d}", f"w{w}", _qset(t, trusted, inner)))
    for z in range(n_null):
        nodes.append(_node(f"NULLQ{z:04d}", f"z{z}", None))
    rng.shuffle(nodes)  # snapshot order is arbitrary; vertex 0 ≠ core
    return nodes


def inner_set_ring_fbas(n: int, per_node: int, *, broken: bool = False) -> List[Dict]:
    """``n`` nodes on a ring, node i trusting ``per_node`` inner sets
    ``2-of-{i, i+1+j, i+2+2j}`` (mod n) and needing a majority of them: one
    SCC whose circuit carries about ``n * per_node`` distinct inner units
    (depth 1), for the fused kernel's wide satisfaction masks.  :func:`nested_hierarchy`,
:func:`sparse_giant` (the bitset engine's workload) and the density
annotations :func:`graph_density` and :func:`scc_qset_density` (the bitset
routing's feature) are the JAX package's, copied unchanged.

    ``broken=True`` lowers node 0 to 1-of-its-sets with its first set 1-of-3,
    so {node0} alone is a quorum.
    """
    ks = keys(n, "RING")
    nodes = []
    for i, key in enumerate(ks):
        inner = [
            _qset(1 if (broken and i == 0 and j == 0) else 2,
                  [ks[i], ks[(i + 1 + j) % n], ks[(i + 2 + 2 * j) % n]])
            for j in range(per_node)
        ]
        t = 1 if (broken and i == 0) else per_node // 2 + 1
        nodes.append(_node(key, f"r{i}", _qset(t, [], inner)))
    return nodes


def near_disjoint_cores(
    core: int = 10,
    bridge: int = 1,
    *,
    broken: bool = False,
    seed: int = 0,
    prefix: str = "NDC",
) -> List[Dict]:
    """Two dense cores A and B joined by a thin bridge: one SCC of ``2*core
    + bridge`` nodes whose first hit lies deep in the enumeration, where
    block-guard pruning pays.

    - ``a ∈ A``: 2-of-[majority-of-A, all-of-bridge];
    - ``b ∈ B``: the same with B (correct twin);
    - ``m ∈ bridge``: 2-of-[majority-of-A, majority-of-B], so every quorum
      of the correct twin holds the bridge and any two quorums meet there.

    ``broken=True`` turns one knob on the B side: B's slice relaxes to
    1-of-[sub-majority-of-B, all-of-bridge], so two disjoint halves of B are
    both quorums, while the trust edges (and the single SCC) stay.  Any
    block whose maximal candidate misses the bridge or a core's majority
    holds no quorum, which is what the guard prunes.  Same ``(core, bridge,
    seed)``: byte-identical snapshot.
    """
    if core < 3 or bridge < 1:
        raise ValueError(f"need core >= 3 and bridge >= 1, got core={core}, bridge={bridge}")
    rng = random.Random(seed)
    a_keys = keys(core, f"{prefix}A")
    b_keys = keys(core, f"{prefix}B")
    m_keys = keys(bridge, f"{prefix}M")
    maj = core // 2 + 1
    inner_a = _qset(maj, list(a_keys))
    inner_b = _qset(maj, list(b_keys))
    inner_m = _qset(bridge, list(m_keys))
    nodes: List[Dict] = []
    for key in a_keys:
        nodes.append(_node(key, f"a-{key}", _qset(2, [], [dict(inner_a), dict(inner_m)])))
    for key in b_keys:
        if broken:
            nodes.append(_node(key, f"b-{key}", _qset(
                1, [], [_qset(max(core // 2, 1), list(b_keys)), dict(inner_m)]
            )))
        else:
            nodes.append(_node(key, f"b-{key}", _qset(2, [], [dict(inner_b), dict(inner_m)])))
    for key in m_keys:
        nodes.append(_node(key, f"m-{key}", _qset(2, [], [dict(inner_a), dict(inner_b)])))
    rng.shuffle(nodes)  # snapshot order is arbitrary; the witness bits spread
    return nodes


def random_fbas(
    n: int,
    *,
    seed: int = 0,
    slice_size: Optional[int] = None,
    nested_prob: float = 0.0,
    null_prob: float = 0.0,
    dangling_prob: float = 0.0,
) -> List[Dict]:
    """Random FBAS: each node trusts a random subset, threshold a random
    majority-ish fraction of it.  Knobs add nested inner sets, null qsets and
    dangling references to exercise quirk policies (Q1/Q2)."""
    rng = random.Random(seed)
    ks = keys(n, "RND")
    nodes = []
    for i, key in enumerate(ks):
        if rng.random() < null_prob:
            nodes.append(_node(key, f"r{i}", None))
            continue
        size = slice_size or rng.randint(3, max(3, min(n, 8)))
        size = min(size, n)
        chosen = rng.sample(ks, size)
        if rng.random() < dangling_prob:
            chosen[rng.randrange(len(chosen))] = f"MISSING{rng.randrange(1000):04d}"
        inner: List[Dict] = []
        if rng.random() < nested_prob and size >= 4:
            split = size // 2
            inner = [_qset(max(1, (size - split) // 2 + 1), chosen[split:])]
            chosen = chosen[:split]
        t = max(1, (len(chosen) + len(inner)) * 2 // 3 + 1)
        t = min(t, len(chosen) + len(inner))
        nodes.append(_node(key, f"r{i}", _qset(t, chosen, inner)))
    return nodes


def nested_hierarchy(
    n_nodes: int,
    *,
    core_orgs: int = 5,
    per_org: int = 3,
    fanout: int = 6,
    orgs_per_level: int = 64,
    broken: bool = False,
    seed: int = 0,
) -> List[Dict]:
    """Scale preset: a nested multi-level org hierarchy that generates
    honestly at 10k+ nodes (the JAX package's ``synth.nested_hierarchy``,
    copied unchanged).

    Tier 0 is a ``core_orgs × per_org`` org-majority core (the
    quorum-bearing sink SCC, same structure as :func:`hierarchical_fbas`).
    Every later tier is organizations of ``per_org`` validators whose
    slice is a majority over ``fanout`` org inner sets sampled from the
    *previous* tier — nesting depth 2, trust flowing strictly rootward, so
    the tiers are watcher SCCs and the NP-hard search stays confined to
    the core while parse/graph/Tarjan/scan chew through the full node
    count (exactly the front-end load a 10k-node serving request costs).
    Tiers are capped at ``orgs_per_level`` orgs; generation stops at
    ``n_nodes`` (the final org may be partial).

    ``broken=True`` turns the one fixture-pair knob in the core (org 0's
    threshold → 1, the ``stellar_like_fbas`` methodology).  Same
    arguments ⇒ byte-identical snapshot (pinned by seed tests).
    """
    if n_nodes < core_orgs * per_org:
        raise ValueError(
            f"need n_nodes >= {core_orgs * per_org} for the core, "
            f"got {n_nodes}"
        )
    rng = random.Random(seed)
    core_org_keys = [keys(per_org, f"HIER0O{o}N") for o in range(core_orgs)]
    core_inner = [_qset(per_org // 2 + 1, list(ok)) for ok in core_org_keys]
    t_core = core_orgs // 2 + 1
    nodes: List[Dict] = []
    for o in range(core_orgs):
        for i, key in enumerate(core_org_keys[o]):
            t = 1 if (broken and o == 0) else t_core
            nodes.append(
                _node(key, f"t0-org{o}-v{i}", _qset(t, [], list(core_inner)))
            )
    prev_inner = core_inner
    level = 1
    while len(nodes) < n_nodes:
        level_inner: List[Dict] = []
        for o in range(orgs_per_level):
            if len(nodes) >= n_nodes:
                break
            org_keys = keys(per_org, f"HIER{level}O{o}N")
            picked = rng.sample(prev_inner, min(fanout, len(prev_inner)))
            t_up = len(picked) // 2 + 1
            slice_q = _qset(t_up, [], [dict(q) for q in picked])
            for i, key in enumerate(org_keys):
                if len(nodes) >= n_nodes:
                    break
                nodes.append(_node(key, f"t{level}-org{o}-v{i}", slice_q))
            level_inner.append(_qset(per_org // 2 + 1, org_keys))
        prev_inner = level_inner or prev_inner
        level += 1
    rng.shuffle(nodes)  # snapshot order is arbitrary; vertex 0 ≠ core
    return nodes


def two_family_preset(
    core: int = 9,
    watchers: int = 6,
    *,
    broken: bool = False,
    seed: int = 0,
) -> Tuple[List[Dict], List[Dict]]:
    """Adversarial two-family preset (the relaxed query, Fast Flexible Paxos
    arXiv:2008.02671): ``(family_a, family_b)``, two quorum-set families over
    one node set in one vertex order.

    Family A is the classic family, ``k``-of-core majorities (``k = core // 2
    + 1``); family B the fast family, ``t``-of-core slices with ``t = 3·core//4
    + 1`` in the correct twin, above the Fast Paxos bound ``k + t > core``.
    ``broken=True`` turns ``t`` down to ``core - k``: a fast quorum can dodge a
    classic one, a split invisible to family A's own verdict.  Watchers
    (identical in both families) trust a core majority and pad the vertex
    space.  Same arguments, byte-identical pair.
    """
    if core < 4:
        raise ValueError(f"need core >= 4, got {core}")
    rng = random.Random(seed)
    core_keys = keys(core, "TFC")
    k_classic = core // 2 + 1
    t_fast = (core - k_classic) if broken else (3 * core // 4 + 1)
    t_fast = max(t_fast, 1)
    order = list(range(core + watchers))
    rng.shuffle(order)  # one arbitrary vertex order shared by both families

    def family(threshold: int) -> List[Dict]:
        out: List[Dict] = []
        for ix in order:
            if ix < core:
                key = core_keys[ix]
                out.append(_node(key, f"c{ix}", _qset(threshold, list(core_keys))))
            else:
                w = ix - core
                trusted = rng_w[w]
                out.append(_node(f"TFW{w:04d}", f"w{w}", _qset(len(trusted) // 2 + 1, trusted)))
        return out

    rng_w = [rng.sample(core_keys, min(core, 4)) for _ in range(watchers)]
    return family(k_classic), family(t_fast)


def sparse_giant(
    n_nodes: int = 10_000,
    *,
    broken: bool = False,
    seed: int = 7,
) -> List[Dict]:
    """Sparse-giant preset: the JAX package's workload for the bitset
    engine (``synth.sparse_giant``, copied unchanged).

    A :func:`nested_hierarchy` instance sized so the DENSE block-diagonal
    sweep encoding is measurably memory/MAC-bound: ~10k nodes of watcher
    tiers over an 8-org × 3-validator core — a 24-node quorum-bearing SCC
    (2^23 sweep windows, enough device work that per-candidate arithmetic
    dominates setup) whose restricted member matrix is the sparse regime
    the bitset encoding exists for.  ``broken=True`` is the usual one-knob
    twin (core org 0's threshold → 1, verdict flips to False).  Same
    arguments ⇒ byte-identical snapshot.
    """
    return nested_hierarchy(
        n_nodes, core_orgs=8, per_org=3, fanout=6, orgs_per_level=64,
        broken=broken, seed=seed,
    )



def graph_density(graph: TrustGraph) -> Dict[str, float]:
    """Density/fanout annotation of a built :class:`TrustGraph` (the JAX
    package's ``synth.graph_density``, copied unchanged).

    ``edge_density`` is directed trust-edge fill ``edges / (n * (n-1))``
    (self-loops counted toward edges but not capacity, multiplicity
    preserved — the same edge semantics as ``TrustGraph.succ``);
    ``qset_fanout_*`` summarize per-node successor counts — the row count
    a node contributes to the dense member matrix vs the ~``n/32`` words
    the bitset encoding stores regardless of fanout.
    """
    n = graph.n
    fanouts = [len(s) for s in graph.succ]
    edges = sum(fanouts)
    return {
        "nodes": float(n),
        "edges": float(edges),
        "edge_density": (edges / (n * (n - 1))) if n > 1 else 0.0,
        "qset_fanout_mean": (edges / n) if n else 0.0,
        "qset_fanout_max": float(max(fanouts, default=0)),
        "qset_fanout_min": float(min(fanouts, default=0)),
    }



def scc_qset_density(graph: TrustGraph, scc: List[int]) -> float:
    """Member-matrix fill estimate of one SCC's restricted circuit: total
    in-SCC qset references / (qset units × |scc|) (the JAX package's
    ``synth.scc_qset_density``, copied unchanged).

    Walks every SCC node's qset tree counting units (the node slice plus
    each nested inner set) and references (in-SCC validators plus
    inner-unit links) — the graph-side approximation of
    ``nnz(members) / size`` of the dense encoding the sweep would build,
    cheap enough for the router's hot path (no circuit encode, no
    restriction).  A symmetric k-of-n core scores ~1.0 (every unit
    references every member — the dense-friendly regime); an org-nested
    core scores well under 0.2 (each inner set references its few members
    — the regime the bitset twin wins).  Dedup of shared inner units is
    deliberately NOT modeled: the estimate is a routing feature measured
    and consumed under the same definition (calibration
    ``bitset_win_max_density``), not a circuit-size claim.
    """
    sset = set(scc)
    units = 0
    refs = 0
    for v in scc:
        stack = [graph.qsets[v]]
        while stack:
            q = stack.pop()
            units += 1
            refs += sum(1 for m in q.members if m in sset)
            for inner in q.inner:
                refs += 1  # the parent's link to the inner unit
                stack.append(inner)
    denom = units * len(scc)
    return (refs / denom) if denom else 0.0
