"""Hand-made circuits shared by the port's CPU and card tests.  Imports
nothing of JAX or the JAX package, so the card tests can use it on a
machine without them."""

from __future__ import annotations

import numpy as np

from quorum_intersection_tpu_torch.encode.circuit import Circuit


def dense_child_circuit(n=31, units=993, seed=7, quorum=(3, 5)):
    """A 31-node circuit whose units nest densely (a 1024-unit pack): every
    root and every unit of the upper inner level counts children spread over
    all inner units below it (depth 2), so its chunks name most child slabs
    and the dense kernel's byte blocks exceed one block and stream.  Each
    unit's threshold is the fraction ``quorum`` of its votes.  The same
    circuit as ``chip_smoke.dense_child_circuit``."""
    rng = np.random.default_rng(seed)
    upper = n + (units - n) // 3
    members = (rng.random((units, n)) < 0.2).astype(np.uint8)
    members[np.arange(n), np.arange(n)] = 1
    child = np.zeros((units, units), dtype=np.uint8)
    child[:n, n:] = rng.random((n, units - n)) < 0.01
    child[n:upper, upper:] = rng.random((upper - n, units - upper)) < 0.01
    votes = members.sum(axis=1).astype(np.int64) + child.sum(axis=1)
    unit_depth = np.zeros(units, dtype=np.int32)
    unit_depth[n:upper] = child[n:upper].any(axis=1)
    unit_depth[:n] = np.where(child[:n].any(axis=1), 1 + unit_depth[n:upper].max(), 0)
    return Circuit(n=n, n_units=units, depth=2,
                   thresholds=(votes * quorum[0] // quorum[1]).astype(np.int32),
                   members=members, child=child, unit_depth=unit_depth)
