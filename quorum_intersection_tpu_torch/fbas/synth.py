"""Synthetic FBAS generators — the seed corpus for differential testing and
benchmarking (SURVEY.md §4.3, BASELINE.json configs).  The port keeps the
two generators its chip smoke run and its tests need; the JAX package holds
the full set.

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
