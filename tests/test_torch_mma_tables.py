"""The host side of the tensor-core packed kernels (``kernels/packed_cuda.py``
``mma_tables``) on the CPU, over the packing corpus of
``tests/test_torch_packing.py``:

- the u8 blocks and the b1 words hold the circuit's own arrays, in the
  layout ``csrc/circuit_mma.cuh`` addresses (``blk_off``);
- every nonzero member and child vote of a 32-unit chunk lies inside the
  k-slabs the host names for it, and a block-diagonal chunk names one slab;
- padded units, lanes and child columns are inert;
- every shape the earlier packed kernels accepted is accepted (hypothesis);
- a numpy model of the tiled evaluator (64-row tiles, a tile-level fixpoint
  loop, in-place child passes, only the named slabs) equals the plain packed
  program and the JAX XLA program K7, for both routes.

Everything compared is an integer: exact equality.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import quorum_intersection_tpu.encode.circuit as jc
from quorum_intersection_tpu.backends.tpu import kernels as jk
from quorum_intersection_tpu.fbas import synth as jax_synth
import quorum_intersection_tpu_torch.encode.circuit as pc
from quorum_intersection_tpu_torch.encode.circuit import Circuit, bitset_encode, unpack_mask_words
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.kernels.packed_cuda import (
    CHUNK,
    ROWS,
    SLAB,
    group_decode,
    mma_tables,
    u8_blocks,
)
from quorum_intersection_tpu_torch.kernels.packed_ref import PackedRef

from _torch_cases import fixture_data, jobs_of, kofn, multi_edge
from _torch_circuits import dense_child_circuit

torch.set_num_threads(1)
CPU = torch.device("cpu")
MISS = jk.INT32_MAX


def _packs(datas, windows=1, scope=False):
    """``(jax packed, port packed)`` of the sources' restricted circuits, each
    source repeated over ``windows`` lane groups."""
    jax_jobs, port_jobs = jobs_of(datas)
    jm = [(q, None if scope else d) for q, d in (jc.restrict_circuit_pair(c, s) for _, c, s in jax_jobs)]
    pm = [(q, None if scope else d) for q, d in (pc.restrict_circuit_pair(c, s) for _, c, s in port_jobs)]
    return jc.pack_circuits(jm * windows), pc.pack_circuits(pm * windows)


def _corpus(name):
    if name == "fixtures":
        return _packs([fixture_data(f) for f in ("trivial_broken.json", "nested_correct.json",
                                                  "snapshot_correct.json", "snapshot_broken.json")])
    if name == "stellar":
        return _packs([jax_synth.stellar_like_fbas(7, 3, seed=s, broken=s == 1) for s in (0, 1)]
                      + [jax_synth.stellar_like_fbas(5, 3, n_watchers=20, seed=2)])
    if name == "bench256":
        return _packs([jax_synth.benchmark_fbas(256, 31)], windows=4)
    if name == "multi-edge":
        return _packs([multi_edge(), kofn(8, 4, "E")])
    if name == "dense-1024":
        circuit = dense_child_circuit()
        jax_circuit = jc.Circuit(**{f: getattr(circuit, f) for f in (
            "n", "n_units", "depth", "thresholds", "members", "child", "unit_depth")})
        return jc.pack_circuits([(jax_circuit, None)]), pc.pack_circuits([(circuit, None)])
    raise ValueError(name)


CORPUS = ["fixtures", "stellar", "bench256", "multi-edge", "dense-1024"]


def _routes(circuit):
    return ("u8", "b1") if pc.bitset_supported(circuit) else ("u8",)


def u8_unblock(flat, r, k):
    """Inverse of ``u8_blocks``: the flat block layout back to ``(r, k)``."""
    blocks = np.asarray(flat, dtype=np.uint8).reshape(r // 32, k // 32, 4, 2, 8, 16)
    return np.ascontiguousarray(blocks.transpose(0, 2, 4, 1, 3, 5)).reshape(r, k)


def blk_off(r, k, rows):
    """``csrc/circuit_mma.cuh`` ``blk_off``, term for term."""
    return (k // 32) * (rows * 32) + (r // 8) * 256 + ((k // 16) & 1) * 128 + (r % 8) * 16 + (k % 16)


def _unname(flat, ranges, first, r, k):
    """Named blocks (``named_blocks``) back to the full ``(r, k)`` matrix."""
    full = np.zeros((r // 32, k // 32, 1024), dtype=np.uint8)
    blocks = np.asarray(flat).reshape(-1, 1024)
    for c, ((lo, hi), f) in enumerate(zip(np.asarray(ranges, dtype=int), np.asarray(first, dtype=int))):
        full[c, lo:hi] = blocks[f:f + hi - lo]
    return u8_unblock(full.reshape(-1), r, k)


def _matrices(t):
    """The tables as ``(member, child)`` integer matrices, unit x column."""
    if t.route == "u8":
        return (_unname(t.member, t.ranges[:, :2], t.first[:, 0], t.units, t.lanes).astype(np.int64),
                _unname(t.child, t.ranges[:, 2:], t.first[:, 1], t.units, t.kcols).astype(np.int64))
    return (unpack_mask_words(t.member, 128).astype(np.int64),
            unpack_mask_words(t.child, t.kcols).astype(np.int64))


@pytest.mark.parametrize("name", CORPUS)
def test_tables_equal_circuit_arrays(name):
    _, pp = _corpus(name)
    c, d = pp.circuit, pp.circuit_d
    u, n = c.n_units, c.n
    for route in _routes(c):
        t = mma_tables(c, d, route)
        assert (t.lanes, t.units) == (-(-n // 32) * 32, -(-max(u, t.lanes) // 32) * 32)
        member, child = _matrices(t)
        np.testing.assert_array_equal(member[:u, :n], c.members)
        np.testing.assert_array_equal(child[:u, : u - t.c0], c.child[:, t.c0:])
        assert not c.child[:, : t.c0].any() and t.c0 % CHUNK == 0
        np.testing.assert_array_equal(t.thr_q[:u], c.thresholds)
        np.testing.assert_array_equal(t.thr_d[:u], (c if d is None else d).thresholds)
        assert t.depth == (c.depth if u > n else 0)
        if route == "b1":
            bits = bitset_encode(c)
            np.testing.assert_array_equal(t.member[:u, : bits.words], bits.member_words)
            if bits.child_words is not None:
                words = bits.child_words[:, t.c0 // 32:]
                np.testing.assert_array_equal(t.child[:u, : words.shape[1]], words)
        else:
            # The named blocks are addressed as the kernel reads them: chunk
            # c's slab x at block first[c] + x - lo, then blk_off inside it.
            rng = np.random.default_rng(3)
            for r, k in zip(rng.integers(0, t.units, 400), rng.integers(0, t.lanes, 400)):
                chunk, slab = int(r) // 32, int(k) // 32
                lo, hi = (int(x) for x in t.ranges[chunk, :2])
                if lo <= slab < hi:
                    at = (int(t.first[chunk, 0]) + slab - lo) * 1024 + blk_off(int(r) % 32, int(k) % 32, 32)
                    assert t.member[at] == member[r, k]
            assert t.member.size == 1024 * int((t.ranges[:, 1] - t.ranges[:, 0]).sum())


def test_u8_blocks_round_trip_and_a_tile_layout():
    rng = np.random.default_rng(1)
    mat = rng.integers(0, 256, size=(96, 64)).astype(np.uint8)
    flat = u8_blocks(mat)
    np.testing.assert_array_equal(u8_unblock(flat, 96, 64), mat)
    # A 64-row tile in the same layout (rows = 64): byte (r, k) at blk_off.
    tile = rng.integers(0, 2, size=(64, 128)).astype(np.uint8)
    placed = np.zeros(64 * 128, dtype=np.uint8)
    for r in range(64):
        for k in range(128):
            placed[blk_off(r, k, ROWS)] = tile[r, k]
    # Per k-slab the tile is one 64 x 32 block of the table layout.
    for s in range(4):
        np.testing.assert_array_equal(
            u8_unblock(placed[s * 2048:(s + 1) * 2048], 64, 32), tile[:, 32 * s:32 * s + 32])


@pytest.mark.parametrize("name", CORPUS)
def test_votes_lie_inside_the_named_slabs(name):
    _, pp = _corpus(name)
    c = pp.circuit
    for route in _routes(c):
        t = mma_tables(c, pp.circuit_d, route)
        # The circuit's own arrays, padded as the tables are.
        member = np.zeros((t.units, t.lanes), dtype=np.int64)
        member[: c.n_units, : c.n] = c.members
        child = np.zeros((t.units, t.kcols), dtype=np.int64)
        child[: c.n_units, : c.n_units - t.c0] = c.child[:, t.c0:]
        sw = SLAB[route]
        for ch in range(t.units // CHUNK):
            rows = slice(CHUNK * ch, CHUNK * (ch + 1))
            m0, m1, k0, k1 = (int(x) for x in t.ranges[ch])
            inside = np.zeros(member.shape[1], dtype=bool)
            inside[m0 * sw:m1 * sw] = True
            assert not member[rows][:, ~inside].any()
            inside = np.zeros(child.shape[1], dtype=bool)
            inside[k0 * sw:k1 * sw] = True
            assert not child[rows][:, ~inside].any()
            assert m1 - m0 <= -(-t.lanes // sw) and k1 - k0 <= t.kcols // sw
        if route == "u8" and pp.slot == 32:
            # Block-diagonal root chunks: one group each, one slab each.
            roots = t.ranges[: pp.groups]
            assert ((roots[:, 1] - roots[:, 0]) == 1).all()


@pytest.mark.parametrize("name", CORPUS)
def test_padding_is_inert(name):
    _, pp = _corpus(name)
    c = pp.circuit
    for route in _routes(c):
        t = mma_tables(c, pp.circuit_d, route)
        member, child = _matrices(t)
        u, n = c.n_units, c.n
        assert not member[u:].any() and not member[:, n:].any()
        assert not child[u:].any() and not child[:, u - t.c0:].any()
        assert (t.thr_q[u:] == 1).all() and (t.thr_d[u:] == 1).all()
        assert (t.ranges[u // CHUNK + (u % CHUNK > 0):] == 0).all()


def _old_accepts(circuit, engine):
    """The earlier packed kernels' limits, as they stood: at most 1024
    units, a child mask of at most 16 uint64 (dense) or 32 uint32 (bitset)
    words over units [c0, U), at most 8 bit-planes, and the tables in one
    block's 227 KB of shared memory."""
    u = circuit.n_units
    if u > 1024:
        return False
    kids = np.nonzero(circuit.child.any(axis=0))[0]
    first = int(kids[0]) if kids.size else u
    bits, widths = (64, (1, 2, 4, 8, 16)) if engine == "dense" else (32, (1, 2, 4, 8, 16, 32))
    c0 = first - first % bits
    need = max(1, -(-(u - c0) // bits))
    words = next((w for w in widths if w >= need), None)
    if words is None:
        return False
    if engine == "dense":
        pm = max(1, int(circuit.members.max(initial=0)).bit_length())
        pc = max(1, int(circuit.child[:, c0:].max(initial=0)).bit_length())
        if max(pm, pc) > 8:
            return False
        nbytes = 8 * u * (2 * pm + words * pc)
    else:
        nbytes = 4 * u * (4 + words)
    return nbytes + 8 * u <= 232448


@st.composite
def circuits(draw):
    n = draw(st.integers(1, 128))
    inner = draw(st.integers(0, 1024 - n))
    u = n + inner
    seed = draw(st.integers(0, 2**31 - 1))
    top = draw(st.sampled_from([1, 3, 255]))
    rng = np.random.default_rng(seed)
    members = (rng.random((u, n)) < 0.1) * rng.integers(1, top + 1, size=(u, n))
    child = np.zeros((u, u), dtype=np.int64)
    if inner:
        first = draw(st.integers(0, u - 1))
        child[:, first:] = (rng.random((u, u - first)) < 0.05) * rng.integers(1, top + 1, size=(u, u - first))
        child[first:, first:] = np.triu(child[first:, first:], 1)  # a DAG
    depth = 1 if child.any() else 0
    return Circuit(n=n, n_units=u, depth=depth,
                   thresholds=rng.integers(-2, 5, size=u).astype(np.int32),
                   members=members.astype(np.uint8), child=child.astype(np.uint8),
                   unit_depth=np.zeros(u, dtype=np.int32))


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(circuits())
def test_every_shape_the_old_kernels_took_is_taken(circuit):
    for engine, route in (("dense", "u8"), ("bitset", "b1")):
        if engine == "bitset" and not pc.bitset_supported(circuit):
            continue
        if _old_accepts(circuit, engine):
            t = mma_tables(circuit, None, route)  # raises on refusal
            assert t.units <= 1024 and t.lanes <= 128


def tile_model(t, tables, starts, rows):
    """The kernel's evaluation in numpy, over the host tables ``t``: 64-row
    tiles, each fixpoint repeated over the whole tile until no row changes,
    the child passes updating the satisfaction tile in place chunk by chunk,
    only the named k-slabs multiplied."""
    pos, scc_mask, lane_group, group_ind = tables
    k = group_ind.shape[1]
    base, bits = group_decode(pos, lane_group, k)
    member, child = _matrices(t)
    gind = np.zeros((t.lanes, k), dtype=np.int64)
    gind[: group_ind.shape[0]] = group_ind != 0
    scc = np.zeros(t.lanes, dtype=np.int64)
    scc[: len(scc_mask)] = np.asarray(scc_mask) != 0
    sw = SLAB[t.route]

    def votes(a, s, c, kids):
        m0, m1, k0, k1 = (int(x) for x in t.ranges[c])
        rows_c = slice(CHUNK * c, CHUNK * (c + 1))
        acc = np.zeros((ROWS, CHUNK), dtype=np.int64)
        for x in range(m0, m1):
            cols = slice(x * sw, min((x + 1) * sw, t.lanes))
            acc += a[:, cols] @ member[rows_c, cols].T
        for x in range(k0, k1) if kids else ():
            cols = slice(x * sw, (x + 1) * sw)
            acc += s[:, cols] @ child[rows_c, cols].T
        return acc

    def fixpoint(a, thr):
        s = np.zeros((ROWS, t.kcols), dtype=np.int64)
        while True:
            for i in range(t.depth):
                for c in range(t.c0 // CHUNK, t.units // CHUNK):
                    sat = votes(a, s, c, i > 0) >= thr[CHUNK * c: CHUNK * (c + 1)]
                    s[:, CHUNK * c - t.c0: CHUNK * (c + 1) - t.c0] = sat
            nxt = np.zeros_like(a)
            for c in range(t.lanes // CHUNK):
                sat = votes(a, s, c, t.depth > 0) >= thr[CHUNK * c: CHUNK * (c + 1)]
                nxt[:, CHUNK * c: CHUNK * (c + 1)] = sat & (a[:, CHUNK * c: CHUNK * (c + 1)] != 0)
            if np.array_equal(nxt, a):
                return a
            a = nxt

    best = np.full(k, MISS, dtype=np.int64)
    for row0 in range(0, rows, ROWS):
        r = row0 + np.arange(ROWS)
        a = np.zeros((ROWS, t.lanes), dtype=np.int64)
        for g in range(k):
            v = (np.asarray(starts, dtype=np.int64)[g] + r) & ((1 << int(bits[g])) - 1)
            for j in range(int(bits[g])):
                a[:, base[g] + j] = (v >> j) & 1
        a[r >= rows] = 0
        if not a.any():
            continue
        q = fixpoint(a, t.thr_q)
        qg = (q @ gind) > 0
        if not qg.any():
            continue
        d0 = scc[None, :] * (1 - q) * ((qg.astype(np.int64) @ gind.T) > 0)
        if not d0.any():
            continue
        dg = (fixpoint(d0, t.thr_d) @ gind) > 0
        for g in range(k):
            hit = np.nonzero(qg[:, g] & dg[:, g])[0]
            if hit.size:
                best[g] = min(best[g], int(starts[g]) + row0 + int(hit[0]))
    return best


@pytest.mark.parametrize("name", CORPUS)
def test_tile_model_equals_plain_program_and_jax_k7(name):
    jp, pp = _corpus(name)
    tables = pp.decode_tables()
    batch, steps = 96, 2  # 192 rows: three tiles, the last one ragged at 64 + 64 + 64
    rows = batch * steps - 40  # and a ragged row count: 152
    k7 = jk.packed_sweep_program_factory(jp.circuit, jp.circuit_d, *jp.decode_tables(), rows)(1)
    total = [1 << (s - 1) for s in pp.sizes]
    hits = 0
    for starts in ([0] * pp.groups, [max(0, (tot // 2) - 77) for tot in total]):
        s = np.asarray(starts, dtype=np.int32)
        want = np.asarray(k7(s))
        for engine, route in (("dense", "u8"), ("bitset", "b1")):
            if engine == "bitset" and not pc.bitset_supported(pp.circuit):
                continue
            plain = PackedRef(pp.circuit, pp.circuit_d, *tables, rows, engine, CPU).program(s, 1).numpy()
            np.testing.assert_array_equal(plain, want, err_msg=engine)
            got = tile_model(mma_tables(pp.circuit, pp.circuit_d, route), tables, s, rows)
            np.testing.assert_array_equal(got, want, err_msg=route)
        hits += int((want < MISS).sum())
    if name in ("fixtures", "multi-edge"):
        assert hits > 0


def test_streamed_variant_is_chosen_for_a_1024_unit_pack():
    """A nested 1024-unit pack whose named byte blocks exceed one block: the
    u8 route streams them; the b1 words stay resident.  A sparser nested
    pack of the same width stays resident."""
    _, pp = _corpus("dense-1024")
    c = pp.circuit
    assert c.n_units == 1024 and c.depth == 2
    t = mma_tables(c, pp.circuit_d, "u8")
    assert t.stream
    assert not mma_tables(c, pp.circuit_d, "b1").stream
    _, ring = _packs([synth.inner_set_ring_fbas(30, 12)], windows=2, scope=True)
    assert ring.circuit.n_units == 1024 and not mma_tables(ring.circuit, None, "u8").stream


@pytest.mark.parametrize("quorum", [(3, 5), (1, 2)])
def test_smoke_and_tests_stream_the_same_dense_pack(quorum):
    """``chip_smoke.py`` keeps its own copy of the densely nested circuit (it
    runs without the tests); both copies give the same circuit."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    a, b = smoke.dense_child_circuit(quorum=quorum), dense_child_circuit(quorum=quorum)
    for field in ("n", "n_units", "depth", "thresholds", "members", "child", "unit_depth"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
