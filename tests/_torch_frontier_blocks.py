"""Inputs shared by the frontier's card checks (``chip_smoke.py``
``compare_frontier`` and ``tests/test_torch_cuda.py``) and their CPU test
(``tests/test_torch_frontier_fold.py``).  Imports nothing of JAX or the JAX
package.

- :func:`exit_reason`: why a chunk stopped, from its counters;
- :func:`wide_flag_block`: flagged-set rows of more than 16 members, no
  multiple of 16, so that K10's leave-one-out rows of a set span tiles;
- :func:`mesh_lockstep`: K9's iteration instance against its plain version
  rank by rank over a mesh of ranks on one card, chunk for chunk.
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


def mesh_lockstep(prob, shape, kern, plain, ranks: int, chunks: int, flag_exit: int = 512, batch=None):
    """K9's iteration instance (``kern``, on its card) and its plain version
    (``plain``, on the same card) over a mesh of ``ranks`` ranks of that
    card, chunk for chunk from the seed state, the host's spill applied
    alike: every rank's counters, arena rows ``[0, top)`` and flags held
    equal to the plain rank's and to rank 0's.  Returns ``(chunks,
    iterations, flags, launches a rank, mismatches, exit reasons, tops)``."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import MESH_BATCH, IterationState, mesh_chunk
    from quorum_intersection_tpu_torch.parallel import candidate_mesh

    mesh = candidate_mesh(devices=[kern.device] * ranks)
    sides = []
    for _ in range(2):
        pairs = [(kern.arena(), kern.arena()) for _ in range(ranks)]
        for pair in pairs:
            pair[0].T[0, : prob.s] = 1
            pair[0].ctr.copy_(torch.tensor([1, 0, 0, 0], dtype=torch.int32))
        sides.append((pairs, [IterationState.empty(shape.K, ranks, *pair) for pair in pairs]))
    kernels = [kern] * ranks
    plains = [plain] * ranks

    def plain_step(k, st, rank, n, fe):
        k.iteration(st, rank, n, fe)

    src, done, iters, flags, steps, bad, reasons, tops = 0, 0, 0, 0, 0, [], [], []
    for c in range(chunks):
        for (pairs, states), ks, step in ((sides[0], kernels, None), (sides[1], plains, plain_step)):
            for pair, st in zip(pairs, states):
                st.begin(pair[src], pair[1 - src])
            n_steps = mesh_chunk(mesh, ks, states, flag_exit, iterate=step, batch=batch or MESH_BATCH)
            if step is None:
                steps += n_steps
        if kern.device.type == "cuda":
            torch.cuda.synchronize(kern.device)
        done += 1
        want = sides[1][0][0][1 - src]
        w_ctr = want.ctr.tolist()
        top, fcount = w_ctr[:2]
        iters += w_ctr[2]
        flags += fcount
        tops.append(top)
        for r in range(ranks):
            for label, got in (("kernel", sides[0][0][r][1 - src]), ("plain", sides[1][0][r][1 - src])):
                if got.ctr.tolist() != w_ctr:
                    bad.append(f"chunk {c}, {label} rank {r}: counters {got.ctr.tolist()} != {w_ctr}")
                elif not (torch.equal(got.T[:top], want.T[:top]) and torch.equal(got.D[:top], want.D[:top])):
                    bad.append(f"chunk {c}, {label} rank {r}: arena rows differ")
                elif not torch.equal(got.flags[:fcount], want.flags[:fcount]):
                    bad.append(f"chunk {c}, {label} rank {r}: flags differ")
        if bad:
            break
        reasons.append(exit_reason(w_ctr, shape, flag_exit))
        if top == 0:
            break
        if top > shape.C - 2 * shape.K:
            keep = top - shape.C // 2
            for pairs, _ in sides:
                for pair in pairs:
                    st = pair[1 - src]
                    st.T[:keep] = st.T[shape.C // 2: top].clone()
                    st.D[:keep] = st.D[shape.C // 2: top].clone()
                    st.ctr[0] = keep
        src = 1 - src
    return done, iters, flags, steps, bad, reasons, tops
