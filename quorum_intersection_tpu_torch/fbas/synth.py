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
routing's feature) are the JAX package's, copied unchanged, and so are the
churn generators :func:`churn_trace_steps` and :func:`churn_trace` (the
snapshot streams incremental re-analysis replays): the same arguments give a
byte-identical trace and metas in both packages.

All generators emit stellarbeat-style raw dicts (the same shape
:func:`quorum_intersection_tpu_torch.fbas.schema.parse_fbas` accepts), so every
synthetic network also exercises the JSON frontend.

The generators follow the reference fixtures' de-facto test methodology —
*same topology, one knob turned* (SURVEY.md §4.1): each safe generator has a
broken twin differing by a single threshold.
"""

from __future__ import annotations

import copy
import json
import random
from collections import Counter
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


# The default churn mix (the three bounded mutations a live stellarbeat
# feed actually produces — see churn_trace_steps); the restructuring kinds
# scc_split / scc_merge are opt-in via ``kinds`` because they change the
# SCC partition itself, which most load-shaped consumers don't want.
CHURN_KINDS = ("threshold", "swap", "rename")

def _scc_partition(snapshot: List[Dict]) -> Tuple[List[int], List[str]]:
    """``(comp, keys)``: the snapshot's SCC component id per node (JSON
    order) and each node's publicKey — the ground truth churn annotations
    are expressed against.  Uses the real front end (parse → build →
    Tarjan) so annotations agree with what the pipeline will see."""
    from quorum_intersection_tpu_torch.fbas.graph import build_graph, tarjan_scc
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas

    fbas = parse_fbas(snapshot)
    graph = build_graph(fbas)
    _, comp = tarjan_scc(graph.n, graph.succ)
    return comp, list(graph.node_ids)


def _key_sets(comp: List[int], keys: List[str]) -> List[frozenset]:
    """One partition as member-publicKey sets (the ground-truth currency
    of the restructure annotations)."""
    groups: Dict[int, set] = {}
    for v, c in enumerate(comp):
        groups.setdefault(c, set()).add(keys[v])
    return [frozenset(g) for g in groups.values()]


def _spanning(parts: List[frozenset], others: List[frozenset]) -> int:
    """How many of ``parts`` meet two or more of ``others`` (by list entry):
    the merge and split counts of the restructure ground truth.  The JAX
    package counts the same pairwise (``p & np`` over every pair); this
    indexes each key's cells once, so a dump-scale partition costs linear
    time instead of quadratic."""
    cells: Dict[str, List[int]] = {}
    for j, other in enumerate(others):
        for key in other:
            cells.setdefault(key, []).append(j)
    return sum(1 for part in parts if len({j for key in part for j in cells.get(key, ())}) >= 2)


def _zipf_pick(rng: random.Random, n: int, skew: float) -> int:
    """One draw from a truncated Zipf over ranks ``0..n-1``:
    ``P(r) ∝ 1/(r+1)^skew``.  Rank 0 is the hottest."""
    weights = [(r + 1) ** -skew for r in range(n)]
    total = sum(weights)
    x = rng.random() * total
    acc = 0.0
    for r, w in enumerate(weights):
        acc += w
        if x <= acc:
            return r
    return n - 1


def churn_trace_steps(
    base: List[Dict],
    steps: int,
    seed: int = 0,
    *,
    max_diff: int = 2,
    kinds: Tuple[str, ...] = CHURN_KINDS,
    annotate: bool = True,
    skew: float = 0.0,
) -> Tuple[List[List[Dict]], List[Dict]]:
    """Deterministic snapshot stream with **ground-truth step annotations**
    (qi-delta): ``(trace, metas)`` where ``trace`` has
    ``steps + 1`` consecutive snapshots starting at ``base`` and
    ``metas[k]`` describes the mutations that produced ``trace[k + 1]``:

    - ``mutations``: ``[{kind, node, scc_id}, ...]`` — each churned node's
      publicKey and its SCC id in the **predecessor** snapshot's partition
      (merge mutations list both touched nodes);
    - ``affected_scc_ids``: the predecessor-partition SCC ids whose
      structural fingerprint the step invalidated — empty for a pure
      cosmetic-rename step, so incremental tests can assert *exactly*
      which SCCs a delta engine must re-derive;
    - ``partition_changed`` / ``merges`` / ``splits``: whether the SCC
      partition itself restructured (computed independently of
      ``fbas/diff.py`` by comparing member-key sets, so the differ is
      tested against ground truth, not against itself).

    ``kinds`` selects the mutation mix.  Beyond the bounded trio
    (**threshold wobble**, **validator swap**, **cosmetic rename** — see
    :func:`churn_trace`), two restructuring kinds are available:

    - ``scc_merge``: the churned node and a node of another SCC add each
      other as validators — the 2-cycle merges their components;
    - ``scc_split``: a node of a multi-node SCC replaces its quorum set
      with a self-only slice (threshold 1 over itself), splitting off —
      the classic broken-config shape, so expect guard-decided verdicts.

    Either falls back to a threshold wobble when the partition offers no
    candidate (a single SCC to merge, no multi-node SCC to split).

    ``skew`` (qi-fleet) adds **zipfian temporal skew**: with
    ``skew > 0`` each emitted step either *advances* the underlying
    bounded-diff mutation chain (rank 0) or *re-emits* a recent chain
    snapshot byte-identically, with rank ``r`` (the r-th most recent)
    drawn ``P(r) ∝ 1/(r+1)^skew`` — the hot-key request distribution the
    fleet bench routes (the JAX package's ``benchmarks/serve.py --fleet``: identical
    re-emissions are fleet-wide cache/coalesce hits, the advancing tail
    spreads across workers).  The skew draws come from a separate
    string-seeded RNG, so the mutation chain consumes exactly the same
    ``seed`` stream with or without revisits — ``skew=0.0`` (default) is
    **byte-identical** to the pre-skew generator.  Revisit metas are
    ``{"revisit_of": <trace index>, "mutations": []}`` with empty
    ``affected_scc_ids``: a revisit is a re-emission, not a bounded diff,
    so the per-mutation ground-truth fields do not apply to it.

    Same ``(base, steps, seed, max_diff, kinds, skew)`` ⇒ byte-identical
    trace and metas; annotation never consumes randomness, so
    ``annotate=False`` (what :func:`churn_trace` passes — load-shaped
    consumers pay no parse/Tarjan passes for metas they discard) and the
    default ``kinds`` yield a byte-identical trace with empty metas.
    Nodes with null quorum sets are never churned.  Each snapshot is a
    deep copy: mutating one never aliases another.
    """
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if skew < 0:
        raise ValueError(f"skew must be >= 0, got {skew}")
    for kind in kinds:
        if kind not in ("threshold", "swap", "rename", "scc_split",
                        "scc_merge"):
            raise ValueError(f"unknown churn kind {kind!r}")
    rng = random.Random(seed)
    # Separate, string-seeded RNG for the skew draws (sha-based seeding,
    # deterministic across processes): the mutation chain consumes exactly
    # the same `rng` stream whether or not revisits interleave, so a
    # skew>0 trace shares its underlying chain with the skew=0 one.
    rng_skew = random.Random(f"qi-churn-skew:{seed}")
    trace = [copy.deepcopy(base)]
    metas: List[Dict] = []
    # The distinct mutation chain (head = next mutation's base) and each
    # chain snapshot's first trace index — revisit steps re-emit from here.
    chain: List[List[Dict]] = [trace[0]]
    chain_emit_ix: List[int] = [0]
    all_keys = [n.get("publicKey") for n in base if n.get("publicKey")]
    # Predecessor partition: the coordinate system of the annotations and
    # the candidate pool for merge/split.  Computed once per snapshot and
    # carried forward — each step's successor partition (needed for the
    # restructure ground truth anyway) IS the next step's predecessor, so
    # the front end runs once per snapshot, not twice per step — and not
    # at all when nothing needs it (annotate=False with the bounded trio,
    # whose mutations never consult the partition).
    needs_partition = annotate or bool(
        {"scc_split", "scc_merge"}.intersection(kinds)
    )
    comp, keys = _scc_partition(base) if needs_partition else ([], [])
    for step in range(steps):
        if skew > 0:
            r = _zipf_pick(rng_skew, len(chain) + 1, skew)
            if r > 0:
                # Zipfian revisit: re-emit the r-th most recent distinct
                # snapshot byte-identically (a fleet-wide hot key).
                trace.append(copy.deepcopy(chain[-r]))
                if annotate:
                    metas.append({
                        "step": step + 1,
                        "revisit_of": chain_emit_ix[-r],
                        "mutations": [],
                        "affected_scc_ids": [],
                        "partition_changed": False,
                        "merges": 0,
                        "splits": 0,
                    })
                continue
        prev = chain[-1]
        snap = copy.deepcopy(prev)
        mutable = [
            i for i, n in enumerate(snap)
            if isinstance(n.get("quorumSet"), dict)
            and n["quorumSet"].get("validators")
        ]
        scc_of = dict(zip(keys, comp))
        key_of_ix = [n.get("publicKey") for n in snap]
        mutations: List[Dict] = []
        affected: set = set()
        for ix in (
            rng.sample(mutable, min(max_diff, len(mutable))) if mutable else ()
        ):
            node = snap[ix]
            q = node["quorumSet"]
            kind = rng.choice(kinds)
            own_scc = scc_of.get(key_of_ix[ix])
            structural = False
            extra: Dict = {}
            if kind == "scc_merge":
                partner = _merge_partner(
                    rng, snap, mutable, scc_of, key_of_ix, own_scc
                )
                if partner is None:
                    kind = "threshold"  # no second SCC to merge with
                else:
                    other = snap[partner]
                    q["validators"].append(other["publicKey"])
                    other["quorumSet"]["validators"].append(node["publicKey"])
                    partner_scc = scc_of.get(key_of_ix[partner])
                    structural = True
                    extra = {"partner": other["publicKey"],
                             "partner_scc_id": partner_scc}
                    if partner_scc is not None:
                        affected.add(partner_scc)
            if kind == "scc_split":
                # The drawn node may sit in a single-node SCC (most
                # watchers do); redirect to a split-capable node so the
                # requested kind actually restructures, falling back to a
                # wobble only when NO multi-node SCC exists at all.
                if sum(1 for c in comp if c == own_scc) < 2:
                    sizes = Counter(comp)
                    # A split only replaces the whole quorum set, so any
                    # dict-qset member of a multi-node SCC qualifies —
                    # including org-structured cores whose top-level
                    # validator list is empty (all-inner-sets).
                    capable = [
                        j for j, n in enumerate(snap)
                        if isinstance(n.get("quorumSet"), dict)
                        and sizes.get(scc_of.get(key_of_ix[j]), 0) >= 2
                    ]
                    if not capable:
                        kind = "threshold"  # nothing multi-node to split
                    else:
                        ix = rng.choice(capable)
                        node = snap[ix]
                        q = node["quorumSet"]
                        own_scc = scc_of.get(key_of_ix[ix])
                if kind == "scc_split":
                    node["quorumSet"] = _qset(1, [node["publicKey"]])
                    structural = True
            if kind == "threshold":
                lo, hi = 1, max(1, len(q["validators"]))
                old_t = q.get("threshold", 1)
                t = old_t + rng.choice((-1, 1))
                q["threshold"] = min(max(t, lo), hi)
                # A wobble clamped back to its old value mutated nothing.
                structural = q["threshold"] != old_t
            elif kind == "swap":
                vix = rng.randrange(len(q["validators"]))
                old_key = q["validators"][vix]
                new_key = rng.choice(all_keys)
                q["validators"][vix] = new_key
                # SCC-local structure changes only when an endpoint is
                # inside the owner's component or the dropped ref was
                # dangling (strict policy folds dangling into n_dangling,
                # a fingerprinted field); an outside→outside swap leaves
                # the restricted problem identical — though it can still
                # restructure the partition, which the key-set comparison
                # below catches independently.
                structural = old_key != new_key and (
                    scc_of.get(old_key) == own_scc
                    or scc_of.get(new_key) == own_scc
                    or old_key not in scc_of
                )
                extra = {"old_key": old_key, "new_key": new_key}
            elif kind == "rename":
                node["name"] = f"{node.get('name', '')}~{rng.randrange(999)}"
            mutations.append({
                "kind": kind, "node": node.get("publicKey"),
                "scc_id": own_scc, "structural": structural, **extra,
            })
            if structural and own_scc is not None:
                affected.add(own_scc)
        trace.append(snap)
        chain.append(snap)
        chain_emit_ix.append(len(trace) - 1)
        if not needs_partition:
            continue
        old_parts = _key_sets(comp, keys)
        comp, keys = _scc_partition(snap)  # becomes the next step's prev
        if not annotate:
            continue
        # Partition restructure ground truth, by member-key sets (never by
        # fingerprints — see docstring).  A validator swap can restructure
        # the partition as a side effect (a new edge closing a cycle
        # between components); every old SCC that gained or lost members
        # is invalidated even when its own node wasn't churned.
        new_parts = _key_sets(comp, keys)
        new_set = set(new_parts)
        changed = set(old_parts) != new_set
        merges = _spanning(new_parts, old_parts)
        splits = _spanning(old_parts, new_parts)
        for part in old_parts:
            if part not in new_set:
                sid = old_ix_to_scc_id(part, scc_of)
                if sid is not None:
                    affected.add(sid)
        metas.append({
            "step": step + 1,
            "mutations": mutations,
            "affected_scc_ids": sorted(affected),
            "partition_changed": changed,
            "merges": merges,
            "splits": splits,
        })
    # Determinism belt-and-braces: the trace must be JSON-serializable as
    # produced (the serving layer journals exactly these dicts).
    json.dumps(trace[-1])
    json.dumps(metas)
    return trace, metas


def _merge_partner(
    rng: random.Random,
    snap: List[Dict],
    mutable: List[int],
    scc_of: Dict[str, int],
    key_of_ix: List[Optional[str]],
    own_scc: Optional[int],
) -> Optional[int]:
    """A deterministic merge partner: a mutable node in a different SCC
    (rng draws among the candidates in snapshot order), or ``None``."""
    candidates = [
        j for j in mutable
        if scc_of.get(key_of_ix[j]) is not None
        and scc_of.get(key_of_ix[j]) != own_scc
    ]
    if not candidates or own_scc is None:
        return None
    return rng.choice(candidates)


def old_ix_to_scc_id(
    part: frozenset, scc_of: Dict[str, int]
) -> Optional[int]:
    """The predecessor SCC id of one old partition cell (any member's)."""
    for key in part:
        if key in scc_of:
            return scc_of[key]
    return None


def churn_trace(
    base: List[Dict],
    steps: int,
    seed: int = 0,
    *,
    max_diff: int = 2,
    kinds: Tuple[str, ...] = CHURN_KINDS,
    skew: float = 0.0,
) -> List[List[Dict]]:
    """Deterministic snapshot stream: ``steps + 1`` consecutive snapshots
    starting at ``base``, each differing from its predecessor in at most
    ``max_diff`` nodes' quorum sets (ROADMAP scenario-diversity item; the
    serving layer's realistic traffic — the JAX package's
    ``benchmarks/serve.py``).

    Per step the generator draws, per churned node, one of three bounded
    mutations a live stellarbeat feed actually produces:

    - **threshold wobble**: a top-level threshold moves ±1, clamped to
      ``[1, members]`` — the most common real churn (validators tuning
      safety margins);
    - **validator swap**: one top-level validator reference is replaced by
      another key drawn from the snapshot (trust-edge churn);
    - **cosmetic rename**: the node's display name changes — a diff the
      SCC-local fingerprint (:func:`.diff.scc_fingerprint`) must
      ignore, so caches stay hot across it.

    ``kinds`` extends the mix with the restructuring mutations
    ``scc_split`` / ``scc_merge`` (see :func:`churn_trace_steps`, which
    also returns per-step ground-truth annotations — this wrapper is the
    load-shaped view, so it skips the annotation work entirely:
    ``annotate=False`` costs no parse/Tarjan passes with the default
    ``kinds``).  ``skew > 0`` adds zipfian temporal skew — steps
    re-emitting recent snapshots byte-identically with rank probability
    ``∝ 1/(r+1)^skew`` — the hot-key traffic shape the fleet bench needs
    (the JAX package's ``benchmarks/serve.py --fleet``); the default ``skew=0.0`` keeps the
    trace byte-identical to the pre-skew generator.

    Same ``(base, steps, seed, skew)`` ⇒ byte-identical trace.  Nodes
    with null quorum sets are never churned (there is nothing bounded to
    mutate).  Each snapshot is a deep copy: mutating one never aliases
    another.
    """
    trace, _ = churn_trace_steps(
        base, steps, seed, max_diff=max_diff, kinds=kinds, annotate=False,
        skew=skew,
    )
    return trace
