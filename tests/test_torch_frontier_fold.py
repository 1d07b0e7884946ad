"""K9's single-barrier schedule (``kernels/csrc/frontier.cu``), modelled in
numpy on the CPU and held equal to the plain chunk loop
(``kernels/frontier_ref.chunk_loop``), chunk for chunk: counters, arena rows
``[0, top)`` and flags.

The model follows the kernel's order within an iteration: the scan of the
previous stash at the top (top, fcount, the exit test, the child and flag
maps), the lazy write of the previous stash's children that stay on the
stack and of its flags, the pop of the new block (from the previous stash at
or above its base, from the arena below), and the tail pass that writes the
last stash when the loop ends; it asserts that no iteration writes an arena
row it reads.  Each popped state is evaluated as the kernel does: the plain
fixpoint, the prunes, and the branch variable by popcount over the host's
in-degree bit-planes (``frontier_cuda.indegree_planes``), also held against
``f2 @ a_scc`` here.  Tolerance: exact (integer rows and counters).
"""

import json

import numpy as np
import pytest
import torch

from quorum_intersection_tpu_torch.backends.frontier import FLAG_EXIT_GROWTH, frontier_problem
from quorum_intersection_tpu_torch.encode.circuit import encode_circuit
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.kernels.frontier_cuda import SETS, ArenaSet, FrontierRef, indegree_planes
from quorum_intersection_tpu_torch.kernels.frontier_ref import ChunkShape, rows_in_circuit
from quorum_intersection_tpu_torch.kernels.sweep_ref import fixpoint
from quorum_intersection_tpu_torch.pipeline import quorum_bearing_sccs

from _torch_frontier_blocks import EXIT_REASONS, exit_reason, wide_flag_block

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _bits(rows: np.ndarray) -> np.ndarray:
    """(k, s) 0/1 rows as uint64 words, lane i at bit i."""
    weights = np.left_shift(np.uint64(1), np.arange(rows.shape[1], dtype=np.uint64))
    return (rows.astype(np.uint64) * weights).sum(axis=1, dtype=np.uint64)


def _rows(words, s: int) -> np.ndarray:
    """uint64 words back as (k, s) int8 0/1 rows."""
    words = np.asarray(words, dtype=np.uint64)
    return ((words[:, None] >> np.arange(s, dtype=np.uint64)) & np.uint64(1)).astype(np.int8)


def _plane(planes: np.ndarray, b: int, w: int) -> int:
    """Lane ``w``'s in-degree bit-plane ``b`` as one integer over the
    state's words (``planes`` (P, W, s): word j lanes 64 j to 64 j + 63)."""
    return sum(int(x) << (64 * j) for j, x in enumerate(planes[b, :, w]))


def _popcount(x: np.ndarray) -> np.ndarray:
    return np.array([bin(int(v)).count("1") for v in x.ravel()], dtype=np.int64).reshape(x.shape)


class _Stash:
    """One iteration's stash: per popped state the children's toRemove, the
    dontRemove and the code (bit 0 include, 1 exclude, 2 flag; the branch
    lane from bit 8), as the kernel stores them."""

    def __init__(self, child: np.ndarray, D: np.ndarray, code: np.ndarray):
        self.child, self.D, self.code = child, D, code

    def state(self, x: int):
        """Entry x of the child map (2 e include, 2 e + 1 exclude) as (T, D)."""
        e = x >> 1
        D = int(self.D[e])
        if not x & 1:
            D |= 1 << int(self.code[e] >> 8)
        return int(self.child[e]), D


def _evaluate(plain: FrontierRef, planes: np.ndarray, half: int, T: np.ndarray, D: np.ndarray) -> _Stash:
    """The kernel's per-state work on the popped words T, D: the Q fixpoint
    of D and T | D, the prunes, the branch variable by popcount."""
    s = plain.a_mat.shape[0]
    uni = T | D
    rows = torch.from_numpy(np.concatenate([_rows(D, s), _rows(uni, s)]).astype(np.int32))
    fp = fixpoint(plain.tables, rows_in_circuit(plain.tables, plain.scc_idx, rows))[:, plain.scc_idx]
    fp = _bits(fp.numpy())
    k = len(T)
    f1, f2 = fp[:k], fp[k:]
    dsize = _popcount(D)
    live = (dsize <= half) & (uni != 0)
    dq = live & (f1 != 0)
    elig = f2 & ~D
    br = live & ~dq & (f2 != 0) & ((D & ~f2) == 0) & (elig != 0)
    best = np.zeros(k, dtype=np.int64)
    for r in np.nonzero(br)[0]:
        key = 0
        for w in range(s):
            if int(elig[r]) >> w & 1:
                m = sum(bin(int(f2[r]) & _plane(planes, b, w)).count("1") << b for b in range(len(planes)))
                key = max(key, (m + 1) << 8 | (255 - w))
        best[r] = 255 - (key & 255)
    child = elig & ~np.left_shift(np.uint64(1), best.astype(np.uint64))
    incl = br & (dsize + 1 <= half)
    excl = br & ((_popcount(child) + dsize) > 0)
    code = incl.astype(np.int64) | excl.astype(np.int64) << 1 | dq.astype(np.int64) << 2 | best << 8
    return _Stash(child, D.copy(), code)


def model_chunk(plain: FrontierRef, shape: ChunkShape, src: ArenaSet, dst: ArenaSet, flag_exit: int):
    """One chunk on the kernel's single-barrier schedule, from ``src`` into
    ``dst`` (numpy on the tensors' memory); returns the counters."""
    s = plain.a_mat.shape[0]
    planes = indegree_planes(plain.a_mat.numpy())
    top = int(src.ctr[0])
    T, D, flags = dst.T.numpy(), dst.D.numpy(), dst.flags.numpy()
    T[:top], D[:top] = src.T.numpy()[:top], src.D.numpy()[:top]
    fcount = iters = popped = 0
    pbase, stash = 0, None
    while True:
        # (a) the scan of the previous stash: top, fcount, the maps.
        fprev, nflags = fcount, 0
        if stash is not None:
            code = stash.code
            n_child = (code & 1) + (code >> 1 & 1)
            off = np.cumsum(n_child) - n_child
            cmap = np.zeros(int(n_child.sum()), dtype=np.int64)
            for e in range(len(code)):
                if code[e] & 1:
                    cmap[off[e]] = 2 * e
                if code[e] & 2:
                    cmap[off[e] + (code[e] & 1)] = 2 * e + 1
            fmap = np.nonzero(code & 4)[0]
            top = pbase + len(cmap)
            nflags = len(fmap)
            fcount = min(fcount + nflags, shape.flag_cap)
        go = top > 0 and iters < shape.chunk_iters and fcount < flag_exit and top <= shape.C - 2 * shape.K
        k = min(top, shape.K) if go else 0
        base = top - k
        # (b) the previous stash's children that stay on the stack, its flags.
        written = set()
        if stash is not None:
            for j in range(max(0, base - pbase)):
                pos = pbase + j
                if pos < shape.C:
                    t, d = stash.state(int(cmap[j]))
                    T[pos], D[pos] = _rows([t], s)[0], _rows([d], s)[0]
                    written.add(pos)
            for j in range(min(nflags, shape.flag_cap - fprev)):
                flags[fprev + j] = _rows([stash.D[fmap[j]]], s)[0]
        if not go:
            return [top, fcount, iters, popped]
        # (c) the pop: from the previous stash at or above its base.
        popT, popD = np.zeros(k, dtype=np.uint64), np.zeros(k, dtype=np.uint64)
        read = set()
        for i in range(k):
            pos = base + i
            if stash is not None and pos >= pbase:
                popT[i], popD[i] = stash.state(int(cmap[pos - pbase]))
            else:
                popT[i], popD[i] = _bits(T[pos:pos + 1])[0], _bits(D[pos:pos + 1])[0]
                read.add(pos)
        assert not read & written, f"iteration {iters} reads arena rows it writes: {sorted(read & written)[:4]}"
        stash = _evaluate(plain, planes, shape.half, popT, popD)
        pbase = base
        iters += 1
        popped += k


def _problem(src, arena, pop, chunk_iters=512):
    graph = build_graph(parse_fbas(json.dumps(src)))
    prob = frontier_problem(graph, encode_circuit(graph), quorum_bearing_sccs(graph)[0][1])
    shape = ChunkShape(half=prob.half, K=min(pop, arena // 4), C=arena, chunk_iters=chunk_iters,
                       flag_cap=512 * FLAG_EXIT_GROWTH + min(pop, arena // 4))
    return prob, shape, FrontierRef(prob.circuit, prob.scc_dev, prob.a_scc, shape, prob.probe_circuit, prob.frozen)


def _multi_edge(src, most=5):
    """``src`` with node i's first validator listed ``i % most`` more times
    (parallel edges: in-degree counts up to ``most``)."""
    src = json.loads(json.dumps(src))
    for i, node in enumerate(src):
        qs = node["quorumSet"]
        if qs and qs["validators"]:
            qs["validators"] += [qs["validators"][0]] * (i % most)
    return src


CASES = {
    "majority-14": (lambda: synth.majority_fbas(14), 8192, 256, 512, 512, 8),
    "majority-14-broken": (lambda: synth.majority_fbas(14, broken=True), 8192, 256, 512, 512, 8),
    # Arena 64, pop 16: the overflow guard top > C - 2K ends chunks.
    "hier-4x3-spill": (lambda: synth.hierarchical_fbas(4, 3), 64, 16, 512, 512, 8),
    # Pop 8: many iterations, each popping across the stash and the arena.
    "random-14-nested-multi-edge": (
        lambda: _multi_edge(synth.random_fbas(14, seed=1, nested_prob=0.3, null_prob=0.1)), 1024, 8, 512, 512, 8),
    # A flag exit of 8: chunks end on flag_exit.
    "hier-5x3-flag-exit": (lambda: synth.hierarchical_fbas(5, 3), 8192, 256, 512, 8, 3),
    "hier-5x3-chunk-iters": (lambda: synth.hierarchical_fbas(5, 3), 8192, 256, 3, 512, 3),
}
EXPECTED_EXIT = {"hier-4x3-spill": "overflow guard", "hier-5x3-flag-exit": "flag_exit",
                 "hier-5x3-chunk-iters": "chunk_iters", "majority-14": "empty stack"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_barrier_schedule_equals_plain_chunk_loop(case):
    make, arena, pop, chunk_iters, flag_exit, chunks = CASES[case]
    prob, shape, plain = _problem(make(), arena, pop, chunk_iters)
    sides = [[ArenaSet.empty(shape.C, prob.s_dev, shape.flag_cap, CPU) for _ in range(2)] for _ in range(2)]
    for side in sides:
        side[0].T[0, : prob.s] = 1
        side[0].ctr.copy_(torch.tensor([1, 0, 0, 0], dtype=torch.int32))
    src, reasons = 0, []
    for c in range(chunks):
        got = model_chunk(plain, shape, sides[0][src], sides[0][1 - src], flag_exit)
        sides[0][1 - src].ctr.copy_(torch.tensor(got, dtype=torch.int32))
        plain.chunk(sides[1][src], sides[1][1 - src], flag_exit)
        mine, want = sides[0][1 - src], sides[1][1 - src]
        assert got == want.ctr.tolist(), (c, got, want.ctr.tolist())
        top, fcount = got[:2]
        assert torch.equal(mine.T[:top], want.T[:top]) and torch.equal(mine.D[:top], want.D[:top]), c
        assert torch.equal(mine.flags[:fcount], want.flags[:fcount]), c
        reasons.append(exit_reason(got, shape, flag_exit))
        if top == 0:
            break
        if top > shape.C - 2 * shape.K:
            keep = top - shape.C // 2
            for st in (mine, want):
                st.T[:keep] = st.T[shape.C // 2: top].clone()
                st.D[:keep] = st.D[shape.C // 2: top].clone()
                st.ctr[0] = keep
        src = 1 - src
    if case in EXPECTED_EXIT:
        assert EXPECTED_EXIT[case] in reasons, reasons
    if case == "random-14-nested-multi-edge":
        assert prob.a_scc.max() > 1


@pytest.mark.parametrize("most", [1, 2, 5])
@pytest.mark.parametrize("s", [8, 24, 48, 64, 72, 96, 128, 136, 192, 256])
def test_indegree_planes_give_the_in_degree(s, most):
    """sum_b sum_j popcount(f2_j & plane_b[j][w]) << b == (f2 @ a_scc)[w]
    for random rows f2 (W = ceil(s / 64) words) and edge counts up to
    ``most``."""
    rng = np.random.default_rng(s * 10 + most)
    a = rng.integers(0, most + 1, size=(s, s))
    planes = indegree_planes(a)
    assert planes.dtype == np.uint64 and planes.shape == (int(a.max()).bit_length(), -(-s // 64), s)
    f2 = rng.integers(0, 2, size=(32, s))
    rows = [sum(1 << int(i) for i in np.nonzero(r)[0]) for r in f2]
    got = np.array([[sum(bin(x & _plane(planes, b, w)).count("1") << b for b in range(len(planes)))
                     for w in range(s)] for x in rows])
    np.testing.assert_array_equal(got, f2 @ a)


def test_indegree_planes_of_an_edgeless_scc_are_empty():
    assert indegree_planes(np.zeros((8, 8), dtype=np.int32)).shape == (0, 1, 8)
    assert indegree_planes(np.zeros((96, 96), dtype=np.int32)).shape == (0, 2, 96)
    assert indegree_planes(np.ones((256, 256), dtype=np.int32)).shape == (1, 4, 256)
    with pytest.raises(ValueError):
        indegree_planes(np.ones((257, 257), dtype=np.int32))


def test_exit_reason_follows_the_loop_condition():
    shape = ChunkShape(half=8, K=16, C=64, chunk_iters=3, flag_cap=64)
    assert [exit_reason(c, shape, 8) for c in ([0, 9, 3, 5], [40, 9, 3, 5], [40, 9, 2, 5], [40, 1, 2, 5])] == list(
        EXIT_REASONS)
    with pytest.raises(ValueError):
        exit_reason([20, 1, 2, 5], shape, 8)


def test_wide_flag_block_holds_sets_over_16_members():
    """The card checks' K10 block: every set over 16 members and off a
    multiple of 16, quorums and minimal quorums among them; the plain filter
    finds minimal sets there."""
    prob, shape, plain = _problem(synth.stellar_like_fbas(16, 3, broken=True), 1 << 12, 256)
    block = wide_flag_block(prob, plain, count=24, minimal=2)
    sizes = block.sum(-1)
    assert (sizes > 16).all() and (sizes % 16 != 0).all()
    assert block.shape[1] == prob.s_dev and not block[:, prob.s:].any()
    mins, _ = plain.filter(block, len(block)).tolist()
    assert mins >= 2


def model_filter(plain: FrontierRef, block: torch.Tensor, count: int, sets_a_warp: int = SETS):
    """K10's schedule (``csrc/frontier.cu`` ``filter_kernel``) in numpy: per
    warp task of ``sets_a_warp`` sets, the leave-one-out rows in
    member-major 16-row tiles, sets already known not minimal skipped, then
    the probes of the minimal sets.  Returns ``(minimal count, first witness
    index or B, tiles)``."""
    s = plain.a_mat.shape[0]
    words = _bits(block[:count].numpy())

    def quorums(rows_words, tables, frozen=None):
        rows = torch.from_numpy(_rows(rows_words, s).astype(np.int32))
        out = fixpoint(tables, rows_in_circuit(tables, plain.scc_idx, rows), frozen)
        return _bits(out[:, plain.scc_idx].numpy())

    scc = np.uint64((1 << s) - 1 if s < 64 else (1 << 64) - 1)
    mins, wit, tiles = 0, block.shape[0], 0
    for t0 in range(0, count, sets_a_warp):
        d = words[t0:t0 + sets_a_warp]
        size = _popcount(d)
        done = 0
        pending = [(j, r) for j in range(64) for r in range(len(d)) if size[r] > j]
        while True:
            live = [(j, r) for j, r in pending if not done >> r & 1]
            if not live:
                break
            tile, pending = live[:16], live[16:]
            tiles += 1
            rows = np.array([int(d[r]) & ~(1 << [w for w in range(s) if int(d[r]) >> w & 1][j]) for j, r in tile],
                            dtype=np.uint64)
            for (j, r), e in zip(tile, quorums(rows, plain.tables)):
                if e:
                    done |= 1 << r
        minimal = [r for r in range(len(d)) if not done >> r & 1]
        mins += len(minimal)
        if minimal:
            tiles += 1
            probes = quorums(np.array([scc & ~d[r] for r in minimal], dtype=np.uint64), plain.probe_tables,
                             plain.frozen)
            hits = [t0 + r for r, e in zip(minimal, probes) if e]
            wit = min([wit] + hits)
    return mins, wit, tiles


def _flag_rows(src, arena, pop, chunks):
    """The flagged sets of the first chunks of ``src`` (plain chunk loop)."""
    prob, shape, plain = _problem(src, arena, pop)
    a, b = (ArenaSet.empty(shape.C, prob.s_dev, shape.flag_cap, CPU) for _ in range(2))
    a.T[0, : prob.s] = 1
    a.ctr.copy_(torch.tensor([1, 0, 0, 0], dtype=torch.int32))
    rows = []
    for _ in range(chunks):
        plain.chunk(a, b, 512)
        rows.append(b.flags[: int(b.ctr[1])].clone())
        a, b = b, a
        if int(a.ctr[0]) == 0:
            break
    return prob, plain, torch.cat(rows)


@pytest.mark.parametrize("case", ["hier-5x3", "stellar-16x3-broken-wide"])
def test_filter_schedule_equals_plain_filter(case):
    """K10's tile schedule (member-major leave-one-out rows, settled sets
    skipped, then the minimal sets' probes) gives the plain filter's minimal
    count and first witness, on a network's own flagged sets and on sets
    over 16 members."""
    if case == "hier-5x3":
        prob, plain, block = _flag_rows(synth.hierarchical_fbas(5, 3), 8192, 256, 2)
        block = block[:96]
    else:
        prob, shape, plain = _problem(synth.stellar_like_fbas(16, 3, broken=True), 1 << 12, 256)
        block = wide_flag_block(prob, plain, count=16, minimal=2)
    block = block.contiguous()
    mins, wit, tiles = model_filter(plain, block, len(block))
    assert [mins, wit] == plain.filter(block, len(block)).tolist()
    # Full tiles: fewer than a tile per set and a probe per 16 sets (the
    # per-set tiles the schedule replaced).
    per_set = sum(-(-int(m) // 16) for m in block.sum(-1)) + -(-len(block) // 16)
    assert 1 <= tiles < per_set


def test_arena_rows_keep_the_kernels_pitch():
    """An arena set of ``s`` lanes for kernels that take ``pitch`` (``s`` off
    a multiple of 8, the drive's ``pad_shapes=False``): views of zeroed rows
    ``pitch`` bytes apart, which the wrappers' checks take, and contiguous
    ``s``-lane rows they refuse."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import _check_set

    class Kern:
        s, pitch = 15, 16
        shape = ChunkShape(half=7, K=16, C=64, chunk_iters=1, flag_cap=30)

    st = ArenaSet.empty(64, 15, 30, CPU, pitch=16)
    assert st.T.shape == (64, 15) and st.T.stride() == (16, 1) and st.flags.shape == (30, 15)
    st.T[:3] = 1
    assert not torch.as_strided(st.T, (64, 16), (16, 1))[:, 15].any()
    _check_set(Kern, st)
    with pytest.raises(ValueError, match="16 bytes apart"):
        _check_set(Kern, ArenaSet.empty(64, 15, 30, CPU))


@pytest.mark.parametrize("make,pitch", [(lambda: synth.hierarchical_fbas(5, 3), 16),
                                        (lambda: synth.majority_fbas(13), 16),
                                        (lambda: synth.random_fbas(13, seed=1, nested_prob=0.4), 24)])
def test_lane_padding_keeps_the_fixpoint(make, pitch):
    """The circuit the wrapper grows to ``pitch`` lanes by inert nodes: on
    rows that never hold a padded lane the fixpoint is the circuit's own,
    and padded lanes stay out of it."""
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import _pad_lanes
    from quorum_intersection_tpu_torch.kernels.sweep_ref import CircuitTables

    circuit = encode_circuit(build_graph(parse_fbas(json.dumps(make()))))
    grown = _pad_lanes(circuit, pitch)
    assert grown.n == pitch and (grown.n_units > pitch) == (circuit.n_units > circuit.n)
    rows = (np.random.default_rng(pitch).random((64, circuit.n)) < 0.7).astype(np.int32)
    wide = np.zeros((64, pitch), dtype=np.int32)
    wide[:, : circuit.n] = rows
    want = fixpoint(CircuitTables(circuit, CPU), torch.from_numpy(rows))
    got = fixpoint(CircuitTables(grown, CPU), torch.from_numpy(wide))
    assert want.any() and torch.equal(got[:, : circuit.n], want) and not got[:, circuit.n:].any()
