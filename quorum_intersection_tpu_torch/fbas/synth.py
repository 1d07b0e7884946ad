"""Synthetic FBAS generators — the seed corpus for differential testing and
benchmarking (SURVEY.md §4.3, BASELINE.json configs).  The port keeps the
generators its chip smoke run and its tests need; the JAX package holds the
full set.  :func:`near_disjoint_cores` is the block-guard pruning preset.  :func:`inner_set_ring_fbas` is the port's own (no counterpart
there): a circuit with hundreds of distinct inner sets inside one SCC, for
the fused kernel's wide satisfaction masks.

All generators emit stellarbeat-style raw dicts (the same shape
:func:`quorum_intersection_tpu_torch.fbas.schema.parse_fbas` accepts), so every
synthetic network also exercises the JSON frontend.

The generators follow the reference fixtures' de-facto test methodology —
*same topology, one knob turned* (SURVEY.md §4.1): each safe generator has a
broken twin differing by a single threshold.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional


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
    (depth 1), for the fused kernel's wide satisfaction masks.

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
