"""Networks for the fault phases of ``tests/test_torch_faults.py`` and
``chip_smoke.py`` (no JAX: the card's machine imports this too)."""

from typing import Dict, List


def late_hit_fbas(regular: int = 13) -> List[Dict]:
    """One SCC whose every quorum holds one of two hub nodes, which come last
    in its order: two disjoint quorums (a hub each), and the sweep's first
    hit lies past 2^(regular - 1) (4111 of 2^14 at 13; 2^28 + 15 of 2^30 at
    29), so a run stopped early has drained a prefix without a hit."""
    regs = [f"R{i:02d}" for i in range(regular)]
    hubs = ["H0", "H1"]
    need_regs = {"threshold": 4, "validators": regs, "innerQuorumSets": []}
    nodes = [{"publicKey": k, "name": k, "quorumSet": {
        "threshold": 2, "validators": [],
        "innerQuorumSets": [{"threshold": 1, "validators": hubs, "innerQuorumSets": []}, need_regs]}}
        for k in regs]
    nodes += [{"publicKey": h, "name": h, "quorumSet": {"threshold": 2, "validators": [h], "innerQuorumSets": [need_regs]}}
              for h in hubs]
    return nodes
