"""Inputs shared by the frontier's card checks (``chip_smoke.py``
``compare_frontier`` and ``tests/test_torch_cuda.py``) and their CPU test
(``tests/test_torch_frontier_fold.py``).  Imports nothing of JAX or the JAX
package.

- :func:`exit_reason`: why a chunk stopped, from its counters;
- :func:`wide_flag_block`: flagged-set rows of more than 16 members, no
  multiple of 16, so that K10's leave-one-out rows of a set span tiles;
- :func:`mesh_lockstep`: K9's iteration instance against its plain version
  rank by rank over a mesh of ranks on one card, chunk for chunk;
- :func:`mesh_chunk_lockstep`: K9's mesh-chunk instance against its plain
  version (and, on request, the iteration instance's plain lockstep), chunk
  for chunk.
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


def _lockstep(prob, shape, sides, chunks: int, flag_exit: int):
    """Chunks from the seed state, run side by side and the host's spill
    applied alike: ``sides`` is a list of ``(label, pairs, run, stashes)``,
    ``pairs`` the side's arena set pairs (one a card or a rank), ``run(src)``
    one chunk from set ``src`` into the other on every pair, ``stashes()``
    the side's stash tensors after it.  Every pair's counters, arena rows
    ``[0, top)`` and flags, and every stash, are held equal to the first
    pair's and stash of the first side.  Returns ``(chunks, iterations,
    flags, mismatches, exit reasons, tops)``."""
    for _, pairs, _, _ in sides:
        for pair in pairs:
            pair[0].T[0, : prob.s] = 1
            pair[0].ctr.copy_(torch.tensor([1, 0, 0, 0], dtype=torch.int32))
    src, done, iters, flags, bad, reasons, tops = 0, 0, 0, 0, [], [], []
    for c in range(chunks):
        for _, _, run, _ in sides:
            run(src)
        for dev in {pair[0].T.device for _, pairs, _, _ in sides for pair in pairs}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        done += 1
        want = sides[0][1][0][1 - src]
        dev = want.T.device
        w_ctr = want.ctr.tolist()
        top, fcount = w_ctr[:2]
        iters += w_ctr[2]
        flags += fcount
        tops.append(top)
        w_stash = sides[0][3]()[0]
        for label, pairs, _, stashes in sides:
            for r, pair in enumerate(pairs):
                got = pair[1 - src]
                if got.ctr.tolist() != w_ctr:
                    bad.append(f"chunk {c}, {label} {r}: counters {got.ctr.tolist()} != {w_ctr}")
                elif not (torch.equal(got.T[:top].to(dev), want.T[:top])
                          and torch.equal(got.D[:top].to(dev), want.D[:top])):
                    bad.append(f"chunk {c}, {label} {r}: arena rows differ")
                elif not torch.equal(got.flags[:fcount].to(dev), want.flags[:fcount]):
                    bad.append(f"chunk {c}, {label} {r}: flags differ")
            for r, stash in enumerate(stashes()):
                if not torch.equal(stash.to(dev), w_stash):
                    bad.append(f"chunk {c}, {label} {r}: stash differs")
        if bad:
            break
        reasons.append(exit_reason(w_ctr, shape, flag_exit))
        if top == 0:
            break
        if top > shape.C - 2 * shape.K:
            keep = top - shape.C // 2
            for _, pairs, _, _ in sides:
                for pair in pairs:
                    st = pair[1 - src]
                    st.T[:keep] = st.T[shape.C // 2: top].clone()
                    st.D[:keep] = st.D[shape.C // 2: top].clone()
                    st.ctr[0] = keep
        src = 1 - src
    return done, iters, flags, bad, reasons, tops


def _iteration_side(label, shape, kern, ranks, flag_exit, step, batch, count):
    """``ranks`` ranks of the iteration instance on ``kern``'s device, a pair
    a rank; ``step`` None launches the kernel, else the plain iteration."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import MESH_BATCH, IterationState, mesh_chunk
    from quorum_intersection_tpu_torch.parallel import candidate_mesh

    device = kern.device if step is None else kern.scc_idx.device
    mesh = candidate_mesh(devices=[device] * ranks)
    arena = kern.arena if step is None else (lambda: _plain_arena(kern, shape))
    pairs = [(arena(), arena()) for _ in range(ranks)]
    states = [IterationState.empty(shape.K, ranks, *pair) for pair in pairs]

    def run(src):
        for pair, st in zip(pairs, states):
            st.begin(pair[src], pair[1 - src])
        count.append(mesh_chunk(mesh, [kern] * ranks, states, flag_exit, iterate=step, batch=batch or MESH_BATCH))

    return label, pairs, run, lambda: [st.stash for st in states]


def _plain_arena(plain, shape):
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import ArenaSet

    return ArenaSet.empty(shape.C, plain.a_mat.shape[0], shape.flag_cap, plain.scc_idx.device)


def _plain_step(k, st, rank, n, fe):
    k.iteration(st, rank, n, fe)


def mesh_lockstep(prob, shape, kern, plain, ranks: int, chunks: int, flag_exit: int = 512, batch=None):
    """K9's iteration instance (``kern``, on its card) and its plain version
    (``plain``, on the same card) over a mesh of ``ranks`` ranks of that
    card, chunk for chunk from the seed state, the host's spill applied
    alike: every rank's counters, arena rows ``[0, top)``, flags and stash
    held equal to the plain rank 0's.  Returns ``(chunks, iterations,
    flags, launches a rank, mismatches, exit reasons, tops)``."""
    steps = []
    sides = [_iteration_side("plain rank", shape, plain, ranks, flag_exit, _plain_step, batch, []),
             _iteration_side("kernel rank", shape, kern, ranks, flag_exit, None, batch, steps)]
    done, iters, flags, bad, reasons, tops = _lockstep(prob, shape, sides, chunks, flag_exit)
    return done, iters, flags, sum(steps), bad, reasons, tops


def mesh_chunk_lockstep(prob, shape, kern, plain, ranks: int, chunks: int, flag_exit: int = 512, kerns=None,
                        devices=None, iteration: bool = False):
    """K9's mesh-chunk instance over a one-process mesh of ``ranks`` ranks
    (the ranks on ``devices``, by default all on ``kern``'s device; one
    problem a card in ``kerns``, a device → problem map) against its plain
    version :func:`..frontier_ref.mesh_chunk_ref` (``plain``, every rank on
    its one device), chunk for chunk from the seed state, the host's spill
    applied alike: every card's counters, arena rows ``[0, top)``, flags
    and stash held equal to the plain version's.  ``iteration`` adds the
    iteration instance's plain lockstep (:func:`mesh_lockstep`'s plain
    side) to the comparison.  Returns ``(chunks, iterations, flags,
    launches, mismatches, exit reasons, tops)``."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import (
        CardState,
        frontier_mesh_chunk,
        mesh_cards,
        mesh_chunk_status,
    )

    kerns = kerns or {kern.device: kern}
    cards = mesh_cards(devices or [kern.device] * ranks)
    card_kerns = [kerns[d] for d, _ in cards]
    k_pairs = [(k.arena(), k.arena()) for k in card_kerns]
    k_states = [CardState.empty(shape.K, ranks, mine, *pair) for (_, mine), pair in zip(cards, k_pairs)]
    p_pair = (_plain_arena(plain, shape), _plain_arena(plain, shape))
    p_state = CardState.empty(shape.K, ranks, range(ranks), *p_pair)
    launches = []

    def run_kernel(src):
        for pair, st in zip(k_pairs, k_states):
            st.begin(pair[src], pair[1 - src])
        frontier_mesh_chunk(card_kerns, k_states, flag_exit)
        mesh_chunk_status(k_states)
        launches.append(len(k_states))

    def run_plain(src):
        p_state.begin(p_pair[src], p_pair[1 - src])
        plain.mesh_chunk(p_state, flag_exit)

    sides = [("plain chunk", [p_pair], run_plain, lambda: [p_state.stash]),
             ("chunk instance card", k_pairs, run_kernel, lambda: [st.stash for st in k_states])]
    if iteration:
        sides.append(_iteration_side("plain iteration rank", shape, plain, ranks, flag_exit, _plain_step, None, []))
    done, iters, flags, bad, reasons, tops = _lockstep(prob, shape, sides, chunks, flag_exit)
    return done, iters, flags, sum(launches), bad, reasons, tops
