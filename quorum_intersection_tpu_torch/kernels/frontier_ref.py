"""Plain PyTorch versions of the device-resident frontier's two programs —
the CPU path of ``gpu-frontier`` and the yardstick the CUDA kernels
(:mod:`.frontier_cuda`) are held against on the card.

- :func:`chunk_loop` (K9): the branch-and-bound chunk loop of the JAX
  package's ``TpuFrontierBackend._build_chunk`` (``backends/tpu/frontier.py:330``,
  ``expand`` ``:380``, ``chunk_fn`` ``:463``), iteration for iteration;
- :func:`filter_block` (K10): its flag filter ``_build_flag_filter``
  (``frontier.py:254``, ``filter_block`` ``:300``);
- :func:`share_iteration` (K9's iteration instance): one iteration of one
  mesh rank, the JAX ``batch_fixpoint`` under a mesh (``frontier.py:356-363``)
  with the pop block sharded by whole states, and :func:`sharded_chunk_loop`,
  a chunk of such iterations over every rank with the gather of their stash
  shares between two iterations;
- :func:`mesh_chunk_ref` (K9's mesh-chunk instance): the whole chunk of one
  card that holds every rank of a one-process mesh, over one shared arena
  and stash, built on :func:`share_iteration`.

The arena is a LIFO stack of (toRemove, dontRemove) pairs as int8 0/1 rows
over the SCC's ``s`` lanes, lane ``i`` being circuit node ``scc_idx[i]``.
The mesh instances' stash holds a state as ``W`` = ⌈s / 64⌉ int64 words
(:func:`pack_words`, :func:`state_words`), as the kernels do.
Where the JAX program is a pure function of its arrays, :func:`chunk_loop`
writes into the caller's destination arena in place: it first copies the
source's live rows ``[0, top)`` there (a no-op when they are the same
tensors), then runs the loop on the destination.  Rows at or above ``top``
are never read as states, so only ``[0, top)`` of a result is defined.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from quorum_intersection_tpu_torch.kernels.sweep_ref import CircuitTables, fixpoint


@dataclass
class ChunkShape:
    """The chunk loop's constants: ``half`` (the size bound ⌊|scc|/2⌋),
    ``K`` (states popped an iteration), ``C`` (arena rows),
    ``chunk_iters`` and ``flag_cap`` (flag buffer rows)."""

    half: int
    K: int
    C: int
    chunk_iters: int
    flag_cap: int


def rows_in_circuit(tables: CircuitTables, scc_idx: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """(B, s) lane rows → (B, n) rows over the circuit's nodes."""
    out = torch.zeros((lanes.shape[0], tables.n), dtype=tables.dtype, device=tables.device)
    out[:, scc_idx] = lanes.to(tables.dtype)
    return out


def _indegree(f2: torch.Tensor, a_mat: torch.Tensor) -> torch.Tensor:
    """Exact ``f2 @ a_mat`` in int32 (float64 on the card, which has no
    int32 matmul: the sums stay far below 2^53)."""
    if f2.device.type == "cpu":
        return f2.to(torch.int32) @ a_mat.to(torch.int32)
    return (f2.to(torch.float64) @ a_mat.to(torch.float64)).to(torch.int32)


def expand(
    tables: CircuitTables,
    scc_idx: torch.Tensor,
    a_mat: torch.Tensor,
    shape: ChunkShape,
    T: torch.Tensor,
    D: torch.Tensor,
    top: int,
    flags: torch.Tensor,
    fcount: int,
) -> Tuple[int, int, int]:
    """One iteration (JAX ``expand``) on ``T``/``D``/``flags`` in place;
    returns ``(new_top, fcount, popped)``."""
    K, C, half, flag_cap = shape.K, shape.C, shape.half, shape.flag_cap
    k = min(top, K)
    base = top - k
    blk_T = T[base:base + K].to(torch.int32)  # copies: the scatter below overwrites these rows
    blk_D = D[base:base + K].to(torch.int32)
    valid = torch.arange(blk_T.shape[0], device=T.device) < k

    dsize = blk_D.sum(-1)
    union = torch.maximum(blk_T, blk_D)
    live = valid & (dsize <= half) & (union.sum(-1) > 0)

    stacked = rows_in_circuit(tables, scc_idx, torch.cat([blk_D, union], 0))
    out = fixpoint(tables, stacked)[:, scc_idx].to(torch.int32)
    f1, f2 = out[:K], out[K:]

    d_has_q = live & (f1.sum(-1) > 0)
    interior = live & ~d_has_q
    contained = (blk_D * (1 - f2)).sum(-1) == 0
    nonempty = f2.sum(-1) > 0
    eligible = f2 * (1 - blk_D)
    has_eligible = eligible.sum(-1) > 0
    branchable = interior & nonempty & contained & has_eligible

    # Branch variable: max in-degree within quorum ∖ dontRemove, the lowest
    # index on ties (torch.argmax returns the first maximum).
    masked = torch.where(eligible > 0, _indegree(f2, a_mat), torch.full_like(eligible, -1))
    best = torch.argmax(masked, dim=-1)
    best_oh = torch.nn.functional.one_hot(best, blk_D.shape[1]).to(torch.int32)

    child_T = eligible * (1 - best_oh)
    incl_D = torch.clamp(blk_D + best_oh, max=1)
    excl_ok = branchable & ((child_T.sum(-1) + dsize) > 0)
    incl_ok = branchable & (dsize + 1 <= half)

    # Include children below exclude children: the LIFO pops the exclude
    # branch first.  Positions past the arena are dropped.
    n_child = excl_ok.to(torch.int64) + incl_ok.to(torch.int64)
    off = torch.cumsum(n_child, 0) - n_child
    incl_pos = torch.where(incl_ok, base + off, torch.full_like(off, C))
    excl_pos = torch.where(excl_ok, base + off + incl_ok.to(torch.int64), torch.full_like(off, C))
    pos = torch.cat([incl_pos, excl_pos])
    keep = pos < C
    T[pos[keep]] = torch.cat([child_T, child_T])[keep].to(T.dtype)
    D[pos[keep]] = torch.cat([incl_D, blk_D])[keep].to(D.dtype)
    new_top = base + int(n_child.sum())

    nf = d_has_q.to(torch.int64)
    fpos = torch.where(d_has_q, fcount + torch.cumsum(nf, 0) - nf, torch.full_like(nf, flag_cap))
    fkeep = fpos < flag_cap
    flags[fpos[fkeep]] = blk_D[fkeep].to(flags.dtype)
    fcount = min(fcount + int(nf.sum()), flag_cap)
    return new_top, fcount, k


def chunk_loop(
    tables: CircuitTables,
    scc_idx: torch.Tensor,
    a_mat: torch.Tensor,
    shape: ChunkShape,
    src_T: torch.Tensor,
    src_D: torch.Tensor,
    top: int,
    T: torch.Tensor,
    D: torch.Tensor,
    flags: torch.Tensor,
    flag_exit: int,
) -> Tuple[int, int, int, int]:
    """One chunk (JAX ``chunk_fn``): copy ``src[:top]`` into ``T``/``D``,
    then iterate while ``top > 0``, ``iters < chunk_iters``,
    ``fcount < flag_exit`` and ``top <= C - 2K``.  Flagged dontRemove sets
    land in ``flags[:fcount]``.  Returns ``(top, fcount, iters, popped)``."""
    if top and src_T.data_ptr() != T.data_ptr():
        T[:top] = src_T[:top]
        D[:top] = src_D[:top]
    fcount = iters = popped = 0
    while (top > 0 and iters < shape.chunk_iters and fcount < flag_exit
           and top <= shape.C - 2 * shape.K):
        top, fcount, k = expand(tables, scc_idx, a_mat, shape, T, D, top, flags, fcount)
        iters += 1
        popped += k
    return top, fcount, iters, popped


def filter_block(
    tables: CircuitTables,
    probe_tables: CircuitTables,
    scc_idx: torch.Tensor,
    frozen: Optional[torch.Tensor],
    flags_blk: torch.Tensor,
    count: int,
) -> Tuple[int, int]:
    """The flag filter (JAX ``filter_block``) over the first ``count`` rows
    of ``flags_blk`` (B, s): each is a dontRemove set that holds a quorum.
    It is **minimal** iff no leave-one-out row D ∖ {j}, j ∈ D, holds one
    (under ``tables``), and a **witness candidate** iff also the probe over
    ``scc ∖ D`` (under ``probe_tables`` with ``frozen``) holds one.  Returns
    ``(minimal count, first witness index or B)``.

    Only what the result reads is evaluated: the leave-one-out rows of
    members of the valid rows (a non-member's row is D itself, masked out
    by the JAX program) and the probes of the valid rows."""
    B = flags_blk.shape[0]
    if count <= 0:
        return 0, B
    rows = flags_blk[:count].to(torch.int32)
    member = rows > 0
    i_idx, j_idx = torch.nonzero(member, as_tuple=True)
    loo = rows[i_idx].clone()
    loo[torch.arange(loo.shape[0], device=loo.device), j_idx] = 0
    q = fixpoint(tables, rows_in_circuit(tables, scc_idx, loo))
    has_q = torch.zeros(count, dtype=torch.bool, device=rows.device)
    has_q[i_idx[q.sum(-1) > 0]] = True
    minimal = ~has_q

    scc_mask = torch.zeros(probe_tables.n, dtype=torch.int32, device=rows.device)
    scc_mask[scc_idx] = 1
    d_n = rows_in_circuit(probe_tables, scc_idx, rows).to(torch.int32)
    probe_avail = torch.clamp(scc_mask[None, :] - d_n, 0, 1)
    pq = fixpoint(probe_tables, probe_tables.cast(probe_avail), frozen)
    wit = minimal & (pq.sum(-1) > 0)
    hits = torch.nonzero(wit).flatten()
    widx = int(hits[0]) if hits.numel() else B
    return int(minimal.sum()), widx


def frozen_row(n: int, scc_idx: np.ndarray, q6: bool) -> Optional[np.ndarray]:
    """The probe's frozen row (JAX ``frontier.py:292-296``): the nodes
    outside the SCC under the unrestricted Q6 probe, else none."""
    if not q6:
        return None
    row = np.ones(n, dtype=np.int32)
    row[np.asarray(scc_idx, dtype=np.int64)] = 0
    return row


# ---- the iteration instance: one rank's share of one iteration -------------

def share_slots(K: int, ranks: int) -> Tuple[int, int]:
    """``(Kn, Ks)``: the states of a rank's share of a ``K``-state pop block
    over ``ranks`` ranks, and its stash slots (``Kn`` rounded up to 8)."""
    if ranks < 1 or K % ranks:
        raise ValueError(f"a pop block of {K} states does not split over {ranks} ranks")
    Kn = K // ranks
    return Kn, -(-Kn // 8) * 8


def state_words(s: int) -> int:
    """``W``: the 64-bit words a state row of ``s`` lanes packs into."""
    return -(-s // 64)


def stash_half_bytes(K: int, ranks: int, words: int) -> int:
    """Bytes of one stash half of states of ``words`` words: ``ranks``
    shares of ``(16 words + 2) Ks`` bytes."""
    return ranks * (16 * words + 2) * share_slots(K, ranks)[1]


def stash_half(stash: torch.Tensor, K: int, ranks: int, half: int,
               words: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Views ``(T, D, code)`` of stash half ``half`` (``csrc/frontier.cu``'s
    share-major layout), ``T`` and ``D`` ``(ranks, Ks, words)``, ``code``
    ``(ranks, Ks)``: share ``r`` holds its ``Ks`` toRemove states (int64
    words, bit ``x`` of word ``j`` lane ``64 j + x``), its dontRemove
    states, then its codes (int16: bit 0 include, 1 exclude, 2 flag, the
    branch lane from bit 8; read as unsigned, a lane past 127 setting bit
    15)."""
    Ks = share_slots(K, ranks)[1]
    nbytes = stash_half_bytes(K, ranks, words)
    row = 8 * words * Ks
    blk = stash[half * nbytes:(half + 1) * nbytes].view(ranks, (16 * words + 2) * Ks)
    return (blk[:, :row].view(torch.int64).view(ranks, Ks, words),
            blk[:, row:2 * row].view(torch.int64).view(ranks, Ks, words), blk[:, 2 * row:].view(torch.int16))


def pack_words(rows: torch.Tensor) -> torch.Tensor:
    """(B, s) 0/1 lane rows → (B, W) int64 words, bit ``x`` of word ``j``
    lane ``64 j + x`` (no shift past bit 63)."""
    B, s = rows.shape
    W = state_words(s)
    wide = torch.zeros((B, 64 * W), dtype=torch.int64, device=rows.device)
    wide[:, :s] = rows
    bits = torch.arange(64, device=rows.device, dtype=torch.int64)
    return (wide.view(B, W, 64) << bits).sum(-1)


def unpack_words(words: torch.Tensor, s: int) -> torch.Tensor:
    """(B, W) int64 words → (B, s) int8 0/1 lane rows."""
    bits = torch.arange(64, device=words.device, dtype=torch.int64)
    return ((words[:, :, None] >> bits) & 1).reshape(words.shape[0], -1)[:, :s].to(torch.int8)


def lane_words(lanes: torch.Tensor, W: int) -> torch.Tensor:
    """(B,) lane indices → (B, W) int64 words holding each one's bit."""
    out = torch.zeros((lanes.shape[0], W), dtype=torch.int64, device=lanes.device)
    out.scatter_(1, (lanes // 64)[:, None], (torch.ones_like(lanes) << (lanes % 64))[:, None])
    return out


def share_iteration(
    tables: CircuitTables,
    scc_idx: torch.Tensor,
    a_mat: torch.Tensor,
    shape: ChunkShape,
    rank: int,
    ranks: int,
    step: int,
    src_T: torch.Tensor,
    src_D: torch.Tensor,
    src_top: int,
    T: torch.Tensor,
    D: torch.Tensor,
    flags: torch.Tensor,
    ctr: torch.Tensor,
    stash: torch.Tensor,
    loop: torch.Tensor,
    flag_exit: int,
) -> None:
    """Launch ``step`` of a chunk for rank ``rank`` of ``ranks``, as the
    iteration instance does it (``csrc/frontier.cu`` ``iteration_kernel``):
    read the loop state (``loop[step & 1]``; step 0 starts from the source
    arena, copying its rows ``[0, src_top)`` into ``T``/``D``), scan the
    whole gathered stash half of the previous iteration, write its children
    that stay on the stack and its flags, run the exit test, and, if it
    passes, pop this rank's share — states ``[rank K/n, (rank+1) K/n)`` of
    the pop block — and write its stash entries into this rank's share of
    the other half; the new state goes to ``loop[(step + 1) & 1]``.  Once
    the chunk has ended, the counters are in ``ctr`` and a further step only
    carries the state forward.  The JAX program's iteration (``expand``) is
    the same function of the same rows, row for row.  Ranks that share one
    arena (:func:`mesh_chunk_ref`) each write the same source rows, children
    and flags into it, so the repeats change no byte."""
    K, C, half, cap = shape.K, shape.C, shape.half, shape.flag_cap
    Kn, Ks = share_slots(K, ranks)
    s = T.shape[1]
    W = state_words(s)
    dev = T.device
    inp, out = loop[step & 1], loop[(step + 1) & 1]
    if step == 0:
        top, fcount, iters, popped, pbase, pk = src_top, 0, 0, 0, 0, 0
        if top and src_T.data_ptr() != T.data_ptr():
            T[:top] = src_T[:top]
            D[:top] = src_D[:top]
    else:
        state = [int(x) for x in inp.tolist()]
        if state[6]:
            out.copy_(inp)
            return
        top, fcount, iters, popped, pbase, pk = state[:6]

    pT, pD, pcode = stash_half(stash, K, ranks, (iters + 1) & 1, W)
    pT, pD, pcode = pT.reshape(-1, W), pD.reshape(-1, W), pcode.reshape(-1)
    fprev, nflags = fcount, 0
    child_slot = child_excl = fslots = None
    if pk:
        # The scan in slot order: a slot's include child, then its exclude child.
        last = pk - 1
        codes = pcode[: (last // Kn) * Ks + last % Kn + 1].to(torch.int64)
        slot = torch.arange(codes.shape[0], device=dev)
        both = torch.stack([(codes & 1) > 0, (codes & 2) > 0], 1)
        child_slot = torch.stack([slot, slot], 1)[both]
        child_excl = torch.stack([torch.zeros_like(slot), torch.ones_like(slot)], 1)[both] > 0
        top = pbase + int(child_slot.shape[0])
        fslots = slot[(codes & 4) > 0]
        nflags = int(fslots.shape[0])
        fcount = min(fcount + nflags, cap)

    def children(idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Entries ``idx`` of the child list as lane rows: the include child
        adds the branch lane to dontRemove."""
        sl = child_slot[idx]
        d = pD[sl]
        with_best = d | lane_words((pcode[sl].to(torch.int64) & 0xFFFF) >> 8, W)
        return unpack_words(pT[sl], s), unpack_words(torch.where(child_excl[idx, None], d, with_best), s)

    go = top > 0 and iters < shape.chunk_iters and fcount < flag_exit and top <= C - 2 * K
    k = min(top, K) if go else 0
    base = top - k
    if pk:
        nw = min(max(0, base - pbase), max(0, C - pbase))
        if nw:
            T[pbase:pbase + nw], D[pbase:pbase + nw] = children(torch.arange(nw, device=dev))
        nf = max(0, min(nflags, cap - fprev))
        if nf:
            flags[fprev:fprev + nf] = unpack_words(pD[fslots[:nf]], s)
    if not go:
        ctr.copy_(torch.tensor([top, fcount, iters, popped], dtype=torch.int32))
        out.copy_(torch.tensor([top, fcount, iters, popped, pbase, pk, 1, 0], dtype=torch.int32))
        return

    # This rank's share: pop, fixpoint, prune, branch, stash.
    j = torch.arange(Ks, device=dev)
    i = rank * Kn + j
    valid = (j < Kn) & (i < k)
    pos = base + i
    blk_T = torch.zeros((Ks, s), dtype=torch.int32, device=dev)
    blk_D = torch.zeros((Ks, s), dtype=torch.int32, device=dev)
    stashed = valid & (pos >= pbase) if pk else torch.zeros_like(valid)
    in_arena = valid & ~stashed
    if bool(stashed.any()):
        t_rows, d_rows = children(pos[stashed] - pbase)
        blk_T[stashed], blk_D[stashed] = t_rows.to(torch.int32), d_rows.to(torch.int32)
    blk_T[in_arena] = T[pos[in_arena]].to(torch.int32)
    blk_D[in_arena] = D[pos[in_arena]].to(torch.int32)

    dsize = blk_D.sum(-1)
    union = torch.maximum(blk_T, blk_D)
    live = valid & (dsize <= half) & (union.sum(-1) > 0)
    fp = fixpoint(tables, rows_in_circuit(tables, scc_idx, torch.cat([blk_D, union], 0)))[:, scc_idx].to(torch.int32)
    f1, f2 = fp[:Ks], fp[Ks:]
    d_has_q = live & (f1.sum(-1) > 0)
    eligible = f2 * (1 - blk_D)
    branchable = (live & ~d_has_q & (f2.sum(-1) > 0) & ((blk_D * (1 - f2)).sum(-1) == 0)
                  & (eligible.sum(-1) > 0))
    masked = torch.where(eligible > 0, _indegree(f2, a_mat), torch.full_like(eligible, -1))
    best = torch.where(branchable, torch.argmax(masked, dim=-1), torch.zeros_like(dsize).to(torch.int64))
    child_T = eligible * (1 - torch.nn.functional.one_hot(best, s).to(torch.int32))
    incl = branchable & (dsize + 1 <= half)
    excl = branchable & ((child_T.sum(-1) + dsize) > 0)
    code = incl.to(torch.int64) | (excl.to(torch.int64) << 1) | (d_has_q.to(torch.int64) << 2) | (best << 8)
    cT, cD, ccode = stash_half(stash, K, ranks, iters & 1, W)
    zero = torch.zeros((Ks, W), dtype=torch.int64, device=dev)
    cT[rank] = torch.where(valid[:, None], pack_words(child_T), zero)
    cD[rank] = torch.where(valid[:, None], pack_words(blk_D), zero)
    ccode[rank] = torch.where(valid, code, zero[:, 0]).to(torch.int16)
    out.copy_(torch.tensor([top, fcount, iters + 1, popped + k, base, k, 0, 0], dtype=torch.int32))


def mesh_chunk_ref(
    tables: CircuitTables,
    scc_idx: torch.Tensor,
    a_mat: torch.Tensor,
    shape: ChunkShape,
    ranks: int,
    src_T: torch.Tensor,
    src_D: torch.Tensor,
    src_top: int,
    T: torch.Tensor,
    D: torch.Tensor,
    flags: torch.Tensor,
    ctr: torch.Tensor,
    stash: torch.Tensor,
    flag_exit: int,
) -> int:
    """One chunk of K9's mesh-chunk instance (``csrc/frontier.cu``
    ``mesh_chunk_kernel``) on one card that holds all ``ranks`` ranks of a
    mesh: one arena ``T``/``D``/``flags``/``ctr`` and one stash (both
    halves, every rank's share, :func:`stash_half` layout) for them all.
    Iteration by iteration, every rank's :func:`share_iteration` on the
    shared arena and stash, until the chunk has ended.  Each rank writes the
    source rows and the previous iteration's children and flags (step (b)),
    all the same bytes, which the kernel writes once a card.  The stash needs no gather: every rank
    writes its share into it.  Leaves the counters in ``ctr``, the arena
    rows ``[0, top)``, the flags and the stash as the kernel leaves them;
    returns the iterations run, the one that ends the chunk included."""
    loop = torch.zeros((2, 8), dtype=torch.int32, device=T.device)
    step = 0
    while not (step and int(loop[step & 1, 6])):
        if step > shape.chunk_iters:
            raise RuntimeError(f"the chunk did not end within {shape.chunk_iters + 1} iterations")
        for r in range(ranks):
            share_iteration(tables, scc_idx, a_mat, shape, r, ranks, step, src_T, src_D, src_top, T, D, flags,
                            ctr, stash, loop, flag_exit)
        step += 1
    return step


def sharded_chunk_loop(
    tables: CircuitTables,
    scc_idx: torch.Tensor,
    a_mat: torch.Tensor,
    shape: ChunkShape,
    ranks: int,
    src_T: torch.Tensor,
    src_D: torch.Tensor,
    top: int,
    arenas: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    flag_exit: int,
) -> List[Tuple[int, int, int, int]]:
    """One chunk (JAX ``chunk_fn`` under a mesh) over ``ranks`` ranks in
    one process: every rank's :func:`share_iteration`, then the copy of
    each rank's stash share into every other stash, until the chunk has
    ended.  ``arenas[r]`` is rank ``r``'s destination ``(T, D, flags)``.
    Returns each rank's ``(top, fcount, iters, popped)``; with
    :func:`chunk_loop`'s at the same ``K`` they are equal, and so are the
    arena rows ``[0, top)`` and the flags."""
    nbytes = stash_half_bytes(shape.K, ranks, state_words(src_T.shape[1]))
    share = nbytes // ranks
    stashes = [torch.zeros(2 * nbytes, dtype=torch.uint8, device=src_T.device) for _ in range(ranks)]
    loops = [torch.zeros((2, 8), dtype=torch.int32, device=src_T.device) for _ in range(ranks)]
    ctrs = [torch.zeros(4, dtype=torch.int32, device=src_T.device) for _ in range(ranks)]

    def gather(half: int) -> None:
        for r, src in enumerate(stashes):
            part = src[half * nbytes + r * share: half * nbytes + (r + 1) * share]
            for dst in stashes:
                if dst is not src:
                    dst[half * nbytes + r * share: half * nbytes + (r + 1) * share] = part

    step = 0
    while not int(loops[0][step & 1, 6]):
        for r in range(ranks):
            T, D, flags = arenas[r]
            share_iteration(tables, scc_idx, a_mat, shape, r, ranks, step, src_T, src_D, top, T, D, flags,
                            ctrs[r], stashes[r], loops[r], flag_exit)
        gather(step & 1)
        step += 1
        if step > shape.chunk_iters + 1:
            raise RuntimeError("the chunk did not end within chunk_iters + 1 iterations")
    return [tuple(int(x) for x in c.tolist()) for c in ctrs]
