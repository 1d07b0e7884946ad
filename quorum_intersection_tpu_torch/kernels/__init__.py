"""The port's CUDA kernels (``csrc/``), their build, their plain PyTorch
versions.

:func:`launch_counts` reads every wrapper's launch count in this process; at a
run record's finish a process that launched any kernel writes them on one
``{"kind": "launches", "pid", "launches"}`` line of its qi-telemetry stream,
so the launches of a server process the caller did not start itself (a fleet
worker) can still be read (``QI_METRICS_JSON``)."""

import os
import sys
from typing import Dict, List

from quorum_intersection_tpu_torch.utils.telemetry import register_final_lines

# (module, wrapper attribute, name in chip_smoke.py's kernels line)
_WRAPPERS = (
    ("sweep_cuda", "sweep_fused", "sweep_fused_cuda"),
    ("sweep_cuda", "sweep_mesh", "sweep_mesh_cuda"),
    ("guard_cuda", "guard_dense", "guard_dense_cuda"),
    ("guard_cuda", "guard_bitset", "guard_bitset_cuda"),
    ("packed_cuda", "packed_sweep_dense", "packed_sweep_dense_cuda"),
    ("packed_cuda", "packed_sweep_bitset", "packed_sweep_bitset_cuda"),
    ("bitset_sweep_cuda", "bitset_sweep", "bitset_sweep_cuda"),
    ("pagerank_cuda", "pagerank_power", "pagerank_cuda"),
)


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launches in this process so far (a wrapper whose
    module was never imported launched nothing)."""
    counts: Dict[str, int] = {}
    for module, attr, name in _WRAPPERS:
        mod = sys.modules.get(f"{__name__}.{module}")
        counts[name] = int(getattr(getattr(mod, attr, None), "launches", 0) or 0)
    frontier = sys.modules.get(f"{__name__}.frontier_cuda")
    table = getattr(frontier, "LAUNCHES", {}) or {}
    counts["frontier_chunk_cuda"] = int(table.get("frontier_chunk", 0))
    counts["frontier_filter_cuda"] = int(table.get("frontier_filter", 0))
    counts["frontier_iteration_cuda"] = int(table.get("frontier_iteration", 0))
    counts["frontier_mesh_chunk_cuda"] = int(table.get("frontier_mesh_chunk", 0))
    return counts


def _launch_lines() -> List[dict]:
    counts = launch_counts()
    if not any(counts.values()):
        return []  # a host-only run's stream stays as it was
    return [{"kind": "launches", "pid": os.getpid(), "launches": counts}]


register_final_lines(_launch_lines)
