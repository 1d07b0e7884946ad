"""qi-cost/1, trimmed to what incremental re-analysis books: the schema tag
and the reuse credit of a composed verdict.

The JAX package's ``cost.py`` also attributes each lane pack's device work to
the requests that shared it (``solo_cost``, ``attribute_pack``), keeps the
per-tenant tables and the SLO plane; those come with the serving layer.  Until
then the port's sweep books no cost, so a composed verdict's
``credit_lane_windows`` is 0 unless the fragment it reuses was banked by the
JAX package (whose sweep does book one).
"""

from __future__ import annotations

from typing import Dict, Optional

COST_SCHEMA = "qi-cost/1"


def reuse_credit(cached_cost: Optional[Dict[str, object]]) -> Dict[str, object]:
    """The cost of a delta-reused SCC: zero new device work plus a
    *credit* — the lane·windows the reuse avoided re-sweeping (what the
    cached solve booked, when it carried a cost)."""
    credit = 0
    if isinstance(cached_cost, dict):
        try:
            credit = int(cached_cost.get("lane_windows") or 0)
        except (TypeError, ValueError):
            credit = 0
    return {
        "schema": COST_SCHEMA,
        "fused": False,
        "reused": True,
        "lanes": 0,
        "groups": 0,
        "windows": 0,
        "lane_windows": 0,
        "macs": 0,
        "device_s": 0.0,
        "credit_lane_windows": credit,
    }
