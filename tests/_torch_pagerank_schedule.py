"""K12's one-barrier schedule (``kernels/csrc/pagerank.cu``), modelled in
numpy float32 on the CPU in the kernel's order of operations, so that it
gives the kernel's bits for a launch shape (grid, segment length):

- the rows as the prologue classifies them: at most ``LIGHT_ENTRIES``
  entries a thread's, longer ones cut into segments of ``seg`` entries in
  row order, the multi-segment rows numbered in row order (their slots);
- per iteration k, one pass: each segment's sum by a warp (lane l adds the
  entries l, l + 32, ... in order, then the xor shuffle tree), a one-segment
  row finished by lane 0 of its warp, a longer one by the last of its
  segments to take a ticket (:func:`ticket_finish`: the row's segment sums,
  lane j adding j, j + 32, ..., then the tree), the vertex pass (thread t
  takes vertices t, t + stride, ...: the T term of each, the light rows'
  sums in CSR order), the block sums (warp trees, then warp 0's tree over the
  warps), and after the one barrier the partials in a fixed order;
- every gathered entry c1 inv[s] * (tmp_{k-1}[s] / T_{k-1}), the JAX
  expression per entry, from e0 and T = 1 at k = 0.

Imports nothing of JAX: ``chip_smoke.py`` holds the kernel to it bit for bit
on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

LIGHT_ENTRIES = 16  # csrc/pagerank.cu kLight
THREADS = 256  # csrc/pagerank.cu kThreads
F32 = np.float32
_XOR = [np.arange(32) ^ o for o in (16, 8, 4, 2, 1)]


def xor_tree(x: np.ndarray) -> np.ndarray:
    """The warp's ``x += __shfl_xor_sync(x, o)`` for o = 16 .. 1 over the
    last axis (32 lanes); every lane ends with the same sum."""
    for idx in _XOR:
        x = x + x[..., idx]
    return x[..., 0]


def lane_sums(values: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Per run ``[start, start + length)`` of ``values``: what lane l of a
    warp holds after adding the entries l, l + 32, ... in order, from 0:
    ``(runs, 32)``."""
    rounds = int(-(-lengths.max(initial=0) // 32))
    acc = np.zeros((len(starts), 32), dtype=F32)
    lanes = np.arange(32)
    for r in range(rounds):
        pos = 32 * r + lanes[None, :]
        live = pos < lengths[:, None]
        idx = np.where(live, starts[:, None] + pos, 0)
        acc = acc + np.where(live, values[idx], F32(0))
    return acc


def block_sum(per_thread: np.ndarray, threads: int) -> np.ndarray:
    """``block_sum2`` of the kernel for each block: ``per_thread`` is
    ``(grid * threads,)``; returns ``(grid,)``."""
    warps = xor_tree(per_thread.reshape(-1, threads // 32, 32))  # (grid, warps)
    padded = np.zeros((warps.shape[0], 32), dtype=F32)
    padded[:, :warps.shape[1]] = warps
    return xor_tree(padded)


def ticket_finish(seg_sums: np.ndarray, arrival: Optional[np.ndarray] = None) -> F32:
    """One multi-segment row's sum as the warp with the last ticket forms
    it: the segment sums land in ``seg_sums``' slots in ``arrival`` order
    (None: in segment order), each taking a ticket; the last to arrive
    reads every slot in segment order, lane j adding j, j + 32, ..., then
    the tree.  The order of arrival decides only who adds."""
    k = len(seg_sums)
    slots = np.full(k, np.nan, dtype=F32)
    ticket = 0
    for s in (range(k) if arrival is None else arrival):
        slots[s] = seg_sums[s]
        ticket += 1
        if ticket == k:
            return F32(xor_tree(lane_sums(slots, np.array([0]), np.array([k])))[0])
    raise AssertionError("a row's tickets never reached its segment count")


def schedule(row_ptr: np.ndarray, src: np.ndarray, outdeg: np.ndarray, m: float, conv: float,
             max_iterations: int, grid: int, seg: int,
             rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, int, float]:
    """``(rank, iterations, last_diff)`` as the kernel at ``(grid, seg)``
    gives them; with ``rng``, each multi-segment row's segments
    arrive in a random order every iteration."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    src = np.asarray(src, dtype=np.int64)
    outdeg = np.asarray(outdeg, dtype=F32)
    n = len(outdeg)
    threads = THREADS
    stride = grid * threads
    warps = stride // 32
    mf, c1 = F32(m), F32(1) - F32(m)
    base = mf / F32(n)
    conv32 = F32(conv)
    c = c1 * np.where(outdeg > 0, F32(1) / np.maximum(outdeg, F32(1)), F32(0)).astype(F32)

    degree = np.diff(row_ptr)
    nseg = np.where(degree > LIGHT_ENTRIES, -(-degree // seg), 0)
    seg_row = np.repeat(np.arange(n), nseg)
    seg_idx = np.arange(len(seg_row)) - np.repeat(np.cumsum(nseg) - nseg, nseg)
    seg_start = row_ptr[seg_row] + seg_idx * seg
    seg_len = np.minimum(seg_start + seg, row_ptr[seg_row + 1]) - seg_start
    single = nseg[seg_row] == 1
    slot_rows = np.flatnonzero(nseg > 1)  # in row order: slot h is slot_rows[h]
    first_seg = np.cumsum(nseg) - nseg
    light = np.flatnonzero(degree <= LIGHT_ENTRIES)
    light_cols = int(degree[light].max(initial=0))
    heavy = len(slot_rows)

    # Where each vertex and each single-segment row lands among the threads.
    v_rounds = -(-n // stride)
    thread_of_seg = (np.arange(len(seg_row)) % warps) * 32
    round_of_seg = np.arange(len(seg_row)) // warps

    prev = np.zeros(n, dtype=F32)
    prev[0] = 1.0
    total = F32(1)
    diff = conv32 + F32(1)
    it = 0
    while diff > conv32 and it < max_iterations:
        r = prev / total
        term = c * r  # c1 inv[s] * (tmp_{k-1}[s] / T_{k-1}), per vertex and per entry alike
        cur = np.empty(n, dtype=F32)
        acc_t = np.zeros(stride, dtype=F32)
        acc_d = np.zeros(stride, dtype=F32)
        # (1) segments, a warp each; the one-segment rows' diff on lane 0 in
        # the order of the warp's segments.
        sums = xor_tree(lane_sums(term[src], seg_start, seg_len)) if len(seg_row) else np.zeros(0, F32)
        tmp_single = base + sums[single]
        cur[seg_row[single]] = tmp_single
        d_single = np.zeros(len(seg_row), dtype=F32)
        d_single[single] = np.abs(tmp_single - r[seg_row[single]])
        for q in range(int(round_of_seg.max(initial=-1)) + 1):
            at = round_of_seg == q
            add = np.zeros(stride, dtype=F32)
            add[thread_of_seg[at]] = d_single[at]
            acc_d = acc_d + add
        slots = np.zeros(heavy, dtype=F32)
        for h, w in enumerate(slot_rows):
            arrival = None if rng is None else rng.permutation(nseg[w])
            t = base + ticket_finish(sums[first_seg[w]:first_seg[w] + nseg[w]], arrival)
            cur[w] = t
            slots[h] = np.abs(t - r[w])
        # (2) the vertex pass.
        t_term = np.zeros(v_rounds * stride, dtype=F32)
        t_term[:n] = outdeg * term
        x = np.zeros(len(light), dtype=F32)
        ptr = row_ptr[light]
        for j in range(light_cols):
            live = degree[light] > j
            x = x + np.where(live, term[src[np.where(live, ptr + j, 0)]], F32(0))
        tmp_light = base + x
        cur[light] = tmp_light
        d_term = np.zeros(v_rounds * stride, dtype=F32)
        d_term[light] = np.abs(tmp_light - r[light])
        for q in range(v_rounds):
            acc_t = acc_t + t_term[q * stride:(q + 1) * stride]
            acc_d = acc_d + d_term[q * stride:(q + 1) * stride]
        # (3) the block partials and the slots, then (4) their sum after the barrier.
        part_t = np.concatenate([block_sum(acc_t, threads), np.zeros(heavy, dtype=F32)])
        part_d = np.concatenate([block_sum(acc_d, threads), slots])
        rounds = -(-len(part_t) // threads)
        pt = np.zeros(rounds * threads, dtype=F32)
        pd = np.zeros(rounds * threads, dtype=F32)
        pt[:len(part_t)] = part_t
        pd[:len(part_d)] = part_d
        sum_t = np.zeros(threads, dtype=F32)
        sum_d = np.zeros(threads, dtype=F32)
        for q in range(rounds):
            sum_t = sum_t + pt[q * threads:(q + 1) * threads]
            sum_d = sum_d + pd[q * threads:(q + 1) * threads]
        total = mf + block_sum(sum_t, threads)[0]
        diff = block_sum(sum_d, threads)[0]
        prev = cur
        it += 1
    return prev / total, it, float(diff)
