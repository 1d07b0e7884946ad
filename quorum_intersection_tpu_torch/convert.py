"""State carried across from the JAX package.

This system has no weights: its state is the threshold circuit — members
(U, n) vote counts, child (U, U) vote counts, thresholds (U,) and depth.
:func:`circuit_from_reference` takes the JAX package's ``Circuit`` arrays as
plain numpy (so the port never imports the JAX package) and returns the
port's :class:`Circuit` plus the bit-plane tables the CUDA kernel reads.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.encode.circuit import Circuit
from quorum_intersection_tpu_torch.kernels.sweep_cuda import PlaneTables, plane_tables


def _unit_heights(child: np.ndarray) -> np.ndarray:
    """DAG height per unit: 0 without children, else 1 + max child height."""
    u = child.shape[0]
    heights = np.zeros(u, dtype=np.int32)
    for _ in range(u):
        kids = np.where(child > 0, heights[None, :] + 1, 0)
        nxt = kids.max(axis=1, initial=0).astype(np.int32)
        if np.array_equal(nxt, heights):
            return heights
        heights = nxt
    raise ValueError("child matrix is not acyclic")


def circuit_from_reference(
    members: np.ndarray,
    child: np.ndarray,
    thresholds: np.ndarray,
    depth: int,
    n: int,
    device: DeviceLike = None,
) -> Tuple[Circuit, PlaneTables]:
    """The JAX package's circuit arrays → ``(Circuit, PlaneTables)``."""
    members = np.asarray(members)
    child = np.asarray(child)
    thresholds = np.asarray(thresholds)
    n_units = thresholds.shape[0]
    if members.shape != (n_units, n) or child.shape != (n_units, n_units):
        raise ValueError(
            f"shape mismatch: members {members.shape}, child {child.shape}, "
            f"thresholds {thresholds.shape}, n={n}"
        )
    for name, a in (("members", members), ("child", child)):
        if a.size and (a.min() < 0 or a.max() > np.iinfo(np.uint8).max):
            raise ValueError(f"{name} vote counts must lie in [0, 255]")
    unit_depth = _unit_heights(child)
    if int(unit_depth.max(initial=0)) != int(depth):
        raise ValueError(f"depth {depth} disagrees with the child DAG height {unit_depth.max()}")
    circuit = Circuit(
        n=int(n),
        n_units=int(n_units),
        depth=int(depth),
        thresholds=thresholds.astype(np.int32),
        members=members.astype(np.uint8),
        child=child.astype(np.uint8),
        unit_depth=unit_depth,
    )
    return circuit, plane_tables(circuit, resolve_device(device))
