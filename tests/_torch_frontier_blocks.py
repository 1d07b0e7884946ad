"""Inputs shared by the frontier's card checks (``chip_smoke.py``
``compare_frontier`` and ``tests/test_torch_cuda.py``) and their CPU test
(``tests/test_torch_frontier_fold.py``).  Imports nothing of JAX or the JAX
package.

- :func:`exit_reason`: why a chunk stopped, from its counters;
- :func:`wide_flag_block`: flagged-set rows of more than 16 members, no
  multiple of 16, so that K10's leave-one-out rows of a set span tiles.
"""

from __future__ import annotations

import numpy as np
import torch

from quorum_intersection_tpu_torch.kernels.frontier_ref import rows_in_circuit
from quorum_intersection_tpu_torch.kernels.sweep_ref import fixpoint

EXIT_REASONS = ("empty stack", "chunk_iters", "flag_exit", "overflow guard")


def exit_reason(ctr, shape, flag_exit: int) -> str:
    """The first test of the chunk loop's condition that the counters
    ``[top, fcount, iters, popped]`` fail (the loop stops on one of them)."""
    top, fcount, iters, _ = (int(x) for x in ctr)
    if top <= 0:
        return "empty stack"
    if iters >= shape.chunk_iters:
        return "chunk_iters"
    if fcount >= flag_exit:
        return "flag_exit"
    if top > shape.C - 2 * shape.K:
        return "overflow guard"
    raise ValueError(f"counters {ctr} leave the chunk loop running")


def _greatest_quorums(plain, rows: torch.Tensor) -> torch.Tensor:
    """The greatest quorum within each lane row (plain fixpoint), as lane rows."""
    out = fixpoint(plain.tables, rows_in_circuit(plain.tables, plain.scc_idx, rows))
    return out[:, plain.scc_idx].to(torch.int8)


def wide_flag_block(prob, plain, seed: int = 0, count: int = 48, minimal: int = 6) -> torch.Tensor:
    """Rows over ``prob``'s lanes (``plain``'s device) whose sizes are over
    16 and not multiples of 16: ``count`` random sets of the sizes in turn,
    the greatest quorum within each where it has such a size (a flagged set
    holds a quorum), and up to ``minimal`` of those quorums shrunk member by
    member to minimal quorums (the minimal and witness cases of K10)."""
    s, s_dev = prob.s, prob.s_dev
    sizes = [m for m in range(17, s + 1) if m % 16]
    if not sizes:
        raise ValueError(f"|scc| {s} has no set size over 16 and off a multiple of 16")
    rng = np.random.default_rng(seed)
    rand = np.zeros((count, s_dev), dtype=np.int8)
    for i in range(count):
        rand[i, rng.choice(s, size=sizes[i % len(sizes)], replace=False)] = 1
    device = plain.scc_idx.device
    rows = [torch.from_numpy(rand).to(device)]
    quorums = _greatest_quorums(plain, rows[0])
    size = quorums.sum(-1)
    fit = (size > 16) & (size % 16 != 0)
    rows.append(quorums[fit])
    shrunk = []
    for q in quorums[size > 0][:minimal]:
        q = q.clone()
        for j in range(s):
            if q[j]:
                trial = q.clone()
                trial[j] = 0
                f = _greatest_quorums(plain, trial[None])[0]
                if f.any():
                    q = f
        shrunk.append(q)
    if shrunk:
        shrunk = torch.stack(shrunk)
        size = shrunk.sum(-1)
        rows.append(shrunk[(size > 16) & (size % 16 != 0)])
    return torch.cat(rows).contiguous()
