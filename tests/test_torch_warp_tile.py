"""The host side of the warp-level tensor-core kernels — the fused sweep
(``csrc/sweep.cu``) and the block guard (``csrc/guard.cu``), both over
``csrc/warp_mma.cuh`` — on the CPU:

- the table blocks :func:`plane_tables` builds hold the circuit's own
  bit-planes, at the words the kernel's fragment read (``frag_off``)
  addresses, chunk by chunk in the order a pass reads them; every nonzero
  vote of a chunk lies inside the blocks named for it, and padding is inert;
- the limits: more than 64 nodes raises, more than 1024 units does not, the
  streamed instance is chosen where the resident tables pass one block's
  shared memory;
- a numpy model of the warp tile (16 rows a warp, the b1 fragment mapping,
  Horner over bit-planes, the quad gather of the epilogue, child
  satisfaction updated in place, the per-warp fixpoint exit, the D probe
  under the frozen row, a ragged last warp) equals the plain sweep and
  guard of the port and the JAX ``fixpoint``, on fixtures and synthetic
  networks at depth 0-2, with multi-plane votes, at n = 64 and above 1024
  units;
- the frontier's rows of 129-256 nodes, which span two node k-slabs: the
  tables hold a member block a plane and a slab, slab 0 then slab 1, and the
  model (a plane's two slab products into one sum, root chunk c kept as
  word c & 3 of slab c >> 2) equals the plain and the JAX ``fixpoint``;
  up to 128 nodes the tables are one slab's whatever the node limit.

Everything compared is an integer: exact equality.
"""

import numpy as np
import pytest
import torch

import jax

import quorum_intersection_tpu.encode.circuit as jc
from quorum_intersection_tpu.backends.tpu import kernels as jk
from quorum_intersection_tpu_torch.encode.circuit import encode_circuit
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.kernels import sweep_ref as ref
from quorum_intersection_tpu_torch.kernels.guard_ref import guard_counts
from quorum_intersection_tpu_torch.kernels.sweep_cuda import (
    CHUNK,
    SLAB,
    SMEM_LIMIT,
    KernelLimitError,
    mask_bits,
    plane_tables,
    smem_bytes,
)

from _torch_cases import multi_edge, rng_rows, sweep_case
from _torch_circuits import dense_child_circuit

torch.set_num_threads(1)
CPU = torch.device("cpu")
MISS = ref.INT32_MAX
ROWS = 16  # rows a warp evaluates at once


def frag_off(block, lane, j):
    """``csrc/warp_mma.cuh``'s read of word ``j`` of ``lane`` in table block
    ``block`` (``blocks[32 block + lane]`` as a uint4), term for term."""
    return 128 * block + 4 * lane + j


def _flat(t):
    return t.blocks.numpy().view(np.uint32).reshape(-1)


def _b_words(flat, block):
    """Block ``block`` as the mma reads it: ``(32 units, 4 words)``, unit
    ``8 j + g`` taking word ``q`` from lane ``4 g + q``'s word ``j``."""
    out = np.zeros((32, 4), dtype=np.uint32)
    for lane in range(32):
        g, q = divmod(lane, 4)
        for j in range(4):
            out[8 * j + g, q] = flat[frag_off(block, lane, j)]
    return out


def _words(bits):
    """(rows, 128k) 0/1 → (rows, 4k) uint32, LSB first."""
    bits = np.asarray(bits, dtype=np.uint64)
    w = bits.reshape(bits.shape[0], -1, 32) << np.arange(32, dtype=np.uint64)
    return w.sum(axis=2).astype(np.uint32)


def _ring(n, per, **kw):
    return encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(n, per, **kw))))


def _circuits():
    """(label, Q circuit, D circuit or None, scc mask, frozen or None)."""
    out = []
    for case in ("snapshot_broken.json", "nested_broken.json", "bench-broken:0", "bench-nested-broken:1"):
        sc = sweep_case(case)
        if sc.pair is not None:
            q, d = sc.pair
            out.append((f"{case} restricted", q, d, np.ones(q.n, dtype=np.int32), None))
        mask = np.zeros(sc.circuit.n, dtype=np.int32)
        mask[sc.scc] = 1
        if sc.circuit.n <= 64:
            out.append((f"{case} frozen", sc.circuit, None, mask, 1 - mask))
    me = encode_circuit(build_graph(parse_fbas(multi_edge(k=4))))
    out.append(("multi-edge", me, None, np.ones(me.n, dtype=np.int32), None))
    maj = encode_circuit(build_graph(parse_fbas(synth.majority_fbas(64, broken=True))))
    out.append(("majority(64)", maj, None, np.ones(64, dtype=np.int32), None))
    out.append(("ring(30,12)", _ring(30, 12), None, np.ones(30, dtype=np.int32), None))
    big = _ring(40, 30, broken=True)
    out.append(("ring(40,30) 1240 units", big, None, np.ones(40, dtype=np.int32), None))
    dense = dense_child_circuit()
    out.append(("densely nested, depth 2", dense, None, np.ones(dense.n, dtype=np.int32), None))
    return out


CIRCUITS = {label: rest for label, *rest in _circuits()}


# ---- the tables ---------------------------------------------------------------


@pytest.mark.parametrize("label", sorted(CIRCUITS))
def test_blocks_hold_the_circuit_in_read_order(label):
    circuit = CIRCUITS[label][0]
    t = plane_tables(circuit, CPU)
    flat, chunks = _flat(t), t.chunks.numpy()
    u, n = circuit.n_units, circuit.n
    members = np.zeros((t.units, SLAB), dtype=np.int64)
    members[:u, :n] = circuit.members
    child = np.zeros((t.units, t.slabs * SLAB), dtype=np.int64)
    child[:u, : u - t.c0] = circuit.child[:, t.c0:]
    assert t.c0 % CHUNK == 0 and t.units % CHUNK == 0
    assert (t.pm, t.pc) == (max(1, int(circuit.members.max()).bit_length()),
                            int(circuit.child.max(initial=0)).bit_length())
    got_m = np.zeros_like(members)
    got_c = np.zeros_like(child)
    nxt = 0
    for c, (first, m, k0, k1) in enumerate(chunks):
        rows = slice(CHUNK * c, CHUNK * (c + 1))
        assert first == nxt and m in (0, t.pm)
        blk = first
        for i in range(m):  # member planes, the highest first
            b = t.pm - 1 - i
            np.testing.assert_array_equal(_b_words(flat, blk), _words((members[rows] >> b) & 1))
            got_m[rows] += ((members[rows] >> b) & 1) << b
            blk += 1
        for b in reversed(range(t.pc)):
            for x in range(k0, k1):
                cols = slice(SLAB * x, SLAB * (x + 1))
                np.testing.assert_array_equal(_b_words(flat, blk), _words((child[rows, cols] >> b) & 1))
                got_c[rows, cols] += ((child[rows, cols] >> b) & 1) << b
                blk += 1
        nxt = blk
    assert nxt == t.nblocks or (nxt == 0 and t.nblocks == 1)
    # Every vote lies in a named block; padded units and columns are inert.
    np.testing.assert_array_equal(got_m, members)
    np.testing.assert_array_equal(got_c, child)
    assert (t.neg_thresholds.numpy()[u:] == -1).all()
    np.testing.assert_array_equal(-t.neg_thresholds.numpy()[:u], circuit.thresholds)


def test_limits_and_the_streamed_choice():
    wide = encode_circuit(build_graph(parse_fbas(synth.majority_fbas(70))))
    with pytest.raises(KernelLimitError, match="at most 64"):
        plane_tables(wide, CPU)
    big = _ring(40, 30)
    assert big.n_units > 1024
    t = plane_tables(big, CPU)  # no unit limit
    assert not t.stream and t.slabs > 1
    assert smem_bytes(True, False, t.nblocks, t.units, t.slabs) <= SMEM_LIMIT
    forced = plane_tables(big, CPU, stream=True)
    assert forced.stream and torch.equal(forced.blocks, t.blocks)
    # Three times the units of a densely nested pack: the tables pass one
    # block's shared memory and stream; the guard's too.
    huge = dense_child_circuit(n=40, units=3000)
    for sweep in (True, False):
        t = plane_tables(huge, CPU, sweep=sweep)
        assert t.stream and smem_bytes(sweep, False, t.nblocks, t.units, t.slabs) > SMEM_LIMIT
        assert smem_bytes(sweep, True, t.nblocks, t.units, t.slabs) <= SMEM_LIMIT


# ---- a numpy model of the warp tile ------------------------------------------


class WarpModel:
    """The kernel's evaluation in numpy over the host tables, all warps at
    once: ``(T, 16, 4)`` uint32 availability words (T warps of 16 rows, word
    q of a row in thread q of its quad), per-warp fixpoint loops."""

    def __init__(self, t):
        self.t = t
        flat = _flat(t)
        self.b = np.stack([_b_words(flat, k) for k in range(t.nblocks)])  # (nblocks, 32, 4)
        self.chunks = t.chunks.numpy()
        self.roots = -(-t.n // CHUNK)

    def _product(self, a, block, nb):
        """m16n8k128 b1 and-popc over the chunk's four n8 blocks, skipping
        the blocks at or past ``nb``: ``(T, 16, 32)``."""
        p = np.bitwise_count(a[:, :, None, :] & self.b[block][None, None]).sum(axis=-1).astype(np.int64)
        p[:, :, 8 * nb:] = 0
        return p

    def votes(self, a, s, c, kids):
        t = self.t
        first, m, k0, k1 = (int(x) for x in self.chunks[c])
        nb = min(4, (t.n_units - CHUNK * c + 7) // 8)
        acc = np.zeros(a.shape[:2] + (CHUNK,), dtype=np.int64)
        blk = first
        ns = t.node_slabs
        for i in range(m // ns):  # member planes, each over the node slabs into one sum
            acc = 2 * acc
            for x in range(ns):
                acc += self._product(a[:, :, 4 * x:4 * x + 4], blk, nb)
                blk += 1
        if kids and k0 < k1:
            kid = np.zeros_like(acc)
            for _ in range(t.pc):
                kid = 2 * kid
                for x in range(k0, k1):
                    kid += self._product(s[:, :, 4 * x:4 * x + 4], blk, nb)
                    blk += 1
            acc += kid
        return acc

    @staticmethod
    def gather(acc, thr):
        """The epilogue: thread (g, q) holds acc[4 j + 2 v1 + v0] = votes of
        row g + 8 v1 and unit 8 j + 2 q + v0 and sets those bits; the quad's
        OR gives the row word.  ``(T, 16)`` uint32."""
        words = np.zeros(acc.shape[:2], dtype=np.uint32)
        for q in range(4):  # each thread's part, ORed across the quad
            part = np.zeros_like(words)
            for j in range(4):
                for v0 in range(2):
                    col = 8 * j + 2 * q + v0
                    part |= (acc[:, :, col] >= thr[col]).astype(np.uint32) << np.uint32(col)
            words |= part
        return words

    def fixpoint(self, a, f, thr):
        """``a`` (T, 16, 4 node_slabs) words; ``f`` the frozen row's words."""
        t = self.t
        a = a.copy()
        s = np.zeros(a.shape[:2] + (4 * max(t.slabs, 1),), dtype=np.uint32)
        live = a.any(axis=(1, 2))
        lo, hi = t.c0 // CHUNK, t.units // CHUNK
        while live.any():
            ta = a[live] | f
            sl = s[live]
            for p in range(t.depth):
                for c in range(lo, hi):  # in place, chunk after chunk
                    sl[:, :, c - lo] = self.gather(self.votes(ta, sl, c, p > 0), thr[CHUNK * c:])
            nxt = np.zeros_like(ta)
            for c in range(self.roots):  # thread q = c & 3 keeps word c & 3 of node slab c >> 2
                w = self.gather(self.votes(ta, sl, c, t.depth > 0), thr[CHUNK * c:])
                nxt[:, :, c] = w & a[live][:, :, c]
            s[live] = sl
            changed = (nxt != a[live]).any(axis=(1, 2))
            a[live] = nxt
            idx = np.nonzero(live)[0]
            live[idx[~changed]] = False
            live &= a.any(axis=(1, 2))
        return a


def _row_words(rows_bits):
    """Python-int node rows → ``(T, 16, 4)`` words (rows padded to warps)."""
    rows_bits = list(rows_bits)
    rows_bits += [0] * (-len(rows_bits) % ROWS)
    r = np.asarray(rows_bits, dtype=np.uint64)
    w = np.zeros((len(r), 4), dtype=np.uint32)
    w[:, 0] = (r & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    w[:, 1] = (r >> np.uint64(32)).astype(np.uint32)
    return w.reshape(-1, ROWS, 4)


def _bits(words):
    w = words.reshape(-1, 4).astype(np.uint64)
    return [int(x) for x in (w[:, 0] | (w[:, 1] << np.uint64(32)))]


def _matrix(bits, n):
    return np.array([[(b >> v) & 1 for v in range(n)] for b in bits], dtype=np.int32)


def model_program(circuit, circuit_d, lo_nodes, scc_mask, frozen, start, rows, hi_row=None):
    """The fused kernel's program in the model: min hit index or MISS."""
    t = plane_tables(circuit, CPU)
    model = WarpModel(t)
    thr_q = -t.neg_thresholds.numpy()
    thr_d = thr_q if circuit_d is None else np.concatenate(
        [circuit_d.thresholds, np.ones(t.units - circuit.n_units, dtype=np.int32)])
    hi = mask_bits(hi_row)
    idx = start + np.arange(rows)
    node_rows = [hi | sum(1 << int(v) for j, v in enumerate(lo_nodes) if (i >> j) & 1) for i in idx]
    a = _row_words(node_rows)
    q = model.fixpoint(a, np.zeros(4, dtype=np.uint32), thr_q)
    qnz = q.any(axis=2)
    warps = qnz.any(axis=1)
    if not warps.any():
        return MISS
    scc_w = _row_words([mask_bits(scc_mask)])[0, 0]
    frz_w = _row_words([mask_bits(frozen)])[0, 0]
    d0 = np.where(qnz[warps][:, :, None], scc_w & ~q[warps], 0).astype(np.uint32)
    d = model.fixpoint(d0, frz_w, thr_d)
    hit = np.zeros(qnz.shape, dtype=bool)
    hit[warps] = qnz[warps] & d.any(axis=2)
    hit = hit.reshape(-1)[:rows]
    return int(idx[np.argmax(hit)]) if hit.any() else MISS


def _starts(total, rows):
    # 400 puts snapshot_broken's first hit (495) inside a program.
    return sorted({0, min(400, max(0, total - rows)), max(0, total // 2 - rows // 3), max(0, total - rows)})


@pytest.mark.parametrize("label", sorted(CIRCUITS))
def test_model_program_equals_plain_sweep(label):
    """Programs of 200 rows (a ragged last warp of 8) at three starts, on
    the Q/D circuit pair or under the frozen row, and a wide-decode hi row."""
    q, d, scc_mask, frozen = CIRCUITS[label]
    nodes = np.nonzero(scc_mask)[0]
    lo_nodes = nodes[1:][:min(len(nodes) - 1, 20)]
    hi_row = np.zeros(q.n, dtype=np.int32)
    hi_row[nodes[1 + len(lo_nodes):][::2]] = 1
    rows = 200
    plain = ref.SweepRef(q, lo_nodes, scc_mask, frozen, rows, d, CPU)
    results = []
    for start in _starts(1 << len(lo_nodes), rows):
        for hi in ((None, hi_row) if hi_row.any() else (None,)):
            want = int(plain.program(start, 1, hi))
            got = model_program(q, d, lo_nodes, scc_mask, frozen, start, rows, hi)
            assert got == want, (label, start, hi is not None)
            results.append(want)
    if label.startswith(("snapshot", "multi-edge", "ring(40,30)")):
        assert any(r != MISS for r in results), label


@pytest.mark.parametrize("label", sorted(CIRCUITS))
def test_model_fixpoint_equals_plain_guard_and_jax(label):
    """The Q fixpoint of 72 seeded rows (a ragged last warp) under the
    frozen row: the model against the plain fixpoint and guard and the JAX
    ``fixpoint``."""
    circuit, _, scc_mask, frozen = CIRCUITS[label]
    n = circuit.n
    avail = rng_rows(len(label), 72, n, 0.7) * (np.asarray(scc_mask) != 0)
    fz = np.zeros(n, dtype=np.int32) if frozen is None else np.asarray(frozen, dtype=np.int32)
    t = plane_tables(circuit, CPU)
    model = WarpModel(t)
    rows = [mask_bits(r) for r in avail]
    got = _matrix(_bits(model.fixpoint(_row_words(rows), _row_words([mask_bits(fz)])[0, 0],
                                        -t.neg_thresholds.numpy()))[:72], n)
    np.testing.assert_array_equal(got, ref.fixpoint(ref.CircuitTables(circuit, CPU), avail, fz).numpy())
    jax_circuit = jc.Circuit(**{f: getattr(circuit, f) for f in (
        "n", "n_units", "depth", "thresholds", "members", "child", "unit_depth")})
    arrays = jk.CircuitArrays(jax_circuit)
    want = np.asarray(jax.jit(lambda a, f: jk.fixpoint(arrays, a, f))(arrays.cast(avail), arrays.cast(fz)))
    np.testing.assert_array_equal(got, want)
    if frozen is None:  # the guard: |Q| per row
        counts = _matrix(_bits(model.fixpoint(_row_words(rows), np.zeros(4, dtype=np.uint32),
                                               -t.neg_thresholds.numpy()))[:72], n).sum(axis=1)
        np.testing.assert_array_equal(counts, guard_counts(circuit, avail, "dense", CPU).numpy())


# ---- two node k-slabs: the frontier's rows of 129-256 nodes ----------------


def _wide_words(rows, n):
    """(R, n) 0/1 node rows → ``(T, 16, 4 ns)`` words (rows padded to warps),
    word ``k`` nodes ``[32 k, 32 k + 32)``."""
    ns = max(1, -(-n // SLAB))
    bits = np.zeros((len(rows) + (-len(rows) % ROWS), ns * SLAB), dtype=np.uint8)
    bits[: len(rows), :n] = rows
    return _words(bits).reshape(-1, ROWS, 4 * ns)


def _wide_rows(words, n):
    w = words.reshape(-1, words.shape[-1]).astype(np.uint64)
    bits = (w[:, :, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
    return bits.reshape(w.shape[0], -1)[:, :n].astype(np.int32)


def _frontier_lane_circuit(data):
    """The frontier's lane-space circuit of ``data``'s quorum-bearing SCC,
    as the card's wrapper builds it (restricted, padded up the ladder, node
    i lane i)."""
    from quorum_intersection_tpu_torch.backends.frontier import frontier_problem
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import permute_nodes
    from quorum_intersection_tpu_torch.pipeline import quorum_bearing_sccs

    graph = build_graph(parse_fbas(data))
    prob = frontier_problem(graph, encode_circuit(graph), quorum_bearing_sccs(graph)[0][1])
    return permute_nodes(prob.circuit, prob.scc_dev)


def _doubled_votes(circuit, seed):
    """``circuit`` with some member votes doubled (two member bit-planes),
    thresholds unchanged."""
    members = circuit.members.copy()
    rng = np.random.default_rng(seed)
    pick = (members > 0) & (rng.random(members.shape) < 0.3)
    members[pick] = 2
    return jc.Circuit(n=circuit.n, n_units=circuit.n_units, depth=circuit.depth, thresholds=circuit.thresholds,
                      members=members, child=circuit.child, unit_depth=circuit.unit_depth)


WIDE = {
    "stellar-43x3 lanes (192 nodes, depth 1)": lambda: _frontier_lane_circuit(
        synth.stellar_like_fbas(43, 3, broken=True)),
    "stellar-85x3 lanes (256 nodes, 384 units)": lambda: _frontier_lane_circuit(
        synth.stellar_like_fbas(85, 3, broken=True)),
    "majority(140), doubled votes": lambda: _doubled_votes(
        encode_circuit(build_graph(parse_fbas(synth.majority_fbas(140)))), 3),
    "random(200) nested, slices of 20": lambda: encode_circuit(build_graph(parse_fbas(
        synth.random_fbas(200, seed=2, nested_prob=0.2, slice_size=20)))),
}


@pytest.mark.parametrize("label", sorted(WIDE))
def test_two_node_slabs_model_equals_plain_and_jax(label):
    """Rows of 129-256 nodes: the tables' member blocks (a plane and a node
    slab each, in read order) hold the circuit, and the model's fixpoint of
    48 seeded rows equals the plain ``fixpoint`` and the JAX one."""
    circuit = WIDE[label]()
    n = circuit.n
    assert 128 < n <= 256
    t = plane_tables(circuit, CPU, max_nodes=256)
    assert t.node_slabs == 2
    flat, chunks = _flat(t), t.chunks.numpy()
    members = np.zeros((t.units, 2 * SLAB), dtype=np.int64)
    members[: circuit.n_units, :n] = circuit.members
    got_m = np.zeros_like(members)
    for c, (first, m, _, _) in enumerate(chunks):
        rows = slice(CHUNK * c, CHUNK * (c + 1))
        assert m in (0, 2 * t.pm)
        for i in range(m):
            b, x = t.pm - 1 - i // 2, i % 2
            cols = slice(SLAB * x, SLAB * (x + 1))
            block = _b_words(flat, first + i)
            np.testing.assert_array_equal(block, _words((members[rows, cols] >> b) & 1))
            got_m[rows, cols] += ((members[rows, cols] >> b) & 1) << b
    np.testing.assert_array_equal(got_m, members)
    avail = rng_rows(n, 48, n, 0.8)
    model = WarpModel(t)
    got = _wide_rows(model.fixpoint(_wide_words(avail, n), np.zeros(8, dtype=np.uint32),
                                    -t.neg_thresholds.numpy()), n)[:48]
    fz = np.zeros(n, dtype=np.int32)
    np.testing.assert_array_equal(got, ref.fixpoint(ref.CircuitTables(circuit, CPU), avail, fz).numpy())
    jax_circuit = jc.Circuit(**{f: getattr(circuit, f) for f in (
        "n", "n_units", "depth", "thresholds", "members", "child", "unit_depth")})
    arrays = jk.CircuitArrays(jax_circuit)
    want = np.asarray(jax.jit(lambda a, f: jk.fixpoint(arrays, a, f))(arrays.cast(avail), arrays.cast(fz)))
    np.testing.assert_array_equal(got, want)
    assert got.any(), label


def test_node_limit_and_one_slab_tables():
    """More than 256 nodes raises under the frontier's limit; up to 128 the
    tables are the same whatever the limit (one slab)."""
    big = encode_circuit(build_graph(parse_fbas(synth.majority_fbas(257))))
    with pytest.raises(KernelLimitError, match="at most 256"):
        plane_tables(big, CPU, max_nodes=256)
    with pytest.raises(KernelLimitError, match="at most 128"):
        plane_tables(encode_circuit(build_graph(parse_fbas(synth.majority_fbas(129)))), CPU, max_nodes=128)
    small = encode_circuit(build_graph(parse_fbas(synth.majority_fbas(100))))
    a, b = plane_tables(small, CPU, max_nodes=128), plane_tables(small, CPU, max_nodes=256)
    assert a.node_slabs == b.node_slabs == 1
    assert torch.equal(a.blocks, b.blocks) and torch.equal(a.chunks, b.chunks)
