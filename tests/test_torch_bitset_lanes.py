"""The bitset sweep's lane instance (``csrc/bitset_sweep.cu``
``bitset_lane_kernel``) on the CPU: a numpy model of its schedule on its own
tables (``bitset_sweep_cuda.lane_tables``) against the plain version
(``BitsetSweepRef``, which ``tests/test_torch_bitset.py`` holds to the JAX
program), and the host's choice of instance.

The model does what the kernel does: four byte-indexed decode tables, one
candidate row a lane and 32 consecutive rows a warp, one pass over the units
in the tables' order (inner units by height, then the node units), each
unit's sign bit of ``thr - 1 - votes`` with its dense child row against the
words built so far (the node words apart, highest unit first), per-lane fixpoints that run while any lane of the warp
changed, a lane whose Q is empty entering the D fixpoint with nothing
available, the least hit lane of the first warp with a hit, rows past the
window's end masked.  Imports nothing of JAX.  Every value is an integer:
exact equality.
"""

import numpy as np
import pytest
import torch

from quorum_intersection_tpu_torch.encode.circuit import Circuit, encode_circuit
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.kernels import bitset_sweep_cuda as bk
from quorum_intersection_tpu_torch.kernels.bitset_sweep_ref import BitsetSweepRef

from _torch_bitset_cases import MODEL_CASES, BitsetProblem, circuit_problem, graph_problem, source_problem
from _torch_circuits import dense_child_circuit

torch.set_num_threads(1)
CPU = torch.device("cpu")
INT32_MAX = 2**31 - 1
FULL = graph_problem("benchmark_fbas(256,34,broken=True) wide", synth.benchmark_fbas(256, 34, broken=True), True)


def decode_tables(lo_nodes) -> np.ndarray:
    """(4, 256) uint64: entry [k, v] the nodes byte k of an index equal to v
    enables (index bits at or above ``len(lo_nodes)`` enable nothing)."""
    out = np.zeros((4, 256), dtype=np.uint64)
    for k in range(4):
        for v in range(256):
            for i in range(8):
                bit = 8 * k + i
                if bit < len(lo_nodes) and (v >> i) & 1:
                    out[k, v] |= np.uint64(1) << np.uint64(int(lo_nodes[bit]))
    return out


def lane_model(lt: bk.LaneTables, lo_nodes, hi_bits: int, scc_bits: int, frozen_bits: int,
               start: int, rows: int, warp_passes=None) -> int:
    """``bitset_lane_kernel`` on ``lt``: the least hit index of
    ``[start, start + rows)`` (INT32_MAX on a miss), every warp at once.
    ``warp_passes``, a dict, receives the passes the warps run: "q" and
    "d", summed over warps (what a window costs the kernel)."""
    recs = {side: t.numpy().view(np.uint32).astype(np.int64) for side, t in (("q", lt.rec_q), ("d", lt.rec_d))}
    child = None if lt.child is None else lt.child.numpy().view(np.uint32).astype(np.int64)
    groups = -(-rows // 32)
    r = np.arange(groups * 32, dtype=np.int64).reshape(groups, 32)
    inside = r < rows
    idx = (start + r).astype(np.uint64)
    dec = decode_tables(lo_nodes)
    row = np.full(idx.shape, np.uint64(hi_bits))
    for k in range(4):
        row |= dec[k, ((idx >> np.uint64(8 * k)) & np.uint64(255)).astype(np.int64)]
    row = np.where(inside, row, np.uint64(0)).astype(np.int64)  # rows past the end: nothing available

    def popc(x):
        return np.bitwise_count(x.astype(np.uint32)).astype(np.int64)

    def node_sat(rec, a0, a1):
        s = [np.zeros_like(a0) for _ in range(lt.cw)]  # the inner units' bits
        w = [np.zeros_like(a0) for _ in range(2)]      # the node words
        for p in list(range(lt.n, lt.inner_end)) + list(range(lt.n - 1, -1, -1)):
            m0, m1, thr1, mask = (int(x) for x in rec[p])
            c = np.int64(np.int32(np.uint32(thr1))) - popc(a0 & m0)
            if lt.nw > 1:
                c = c - popc(a1 & m1)
            for k in range(lt.cw):
                if (mask >> k) & 1:
                    c = c - popc(s[k] & int(child[p, k]))
            (w if p < lt.n else s)[p >> 5] |= (c < 0).astype(np.int64) << (p & 31)
        return w[0], w[1]

    def fixpoint(rec, a, f, live, side):
        a0, a1 = a & 0xFFFFFFFF, a >> 32
        f0, f1 = f & 0xFFFFFFFF, f >> 32
        live = live.copy()
        while live.any():  # a warp runs passes while any of its lanes changed
            if warp_passes is not None:
                warp_passes[side] = warp_passes.get(side, 0) + int(live.sum())
            s0, s1 = node_sat(rec, a0[live] | f0, a1[live] | f1)
            n0, n1 = s0 & a0[live], s1 & a1[live]
            changed = ((n0 != a0[live]) | (n1 != a1[live])).any(axis=1)
            a0[live], a1[live] = n0, n1
            live[np.nonzero(live)[0][~changed]] = False
        return a0 | (a1 << 32)

    q = fixpoint(recs["q"], row, 0, np.ones(groups, dtype=bool), "q")
    has_q = q != 0
    d_start = np.where(has_q, scc_bits & ~q, 0)
    d = fixpoint(recs["d"], d_start, frozen_bits, has_q.any(axis=1), "d")
    hit = has_q & (d != 0)
    for g in range(groups):
        if hit[g].any():
            return start + 32 * g + int(np.argmax(hit[g]))
    return INT32_MAX


def _plain_and_model(prob: BitsetProblem, lo_bits, hi, start, rows):
    lo_nodes, hi_row = prob.decode(lo_bits, hi)
    plain = BitsetSweepRef(prob.circuit, lo_nodes, prob.scc_mask, prob.frozen, rows, prob.circuit_d, CPU)
    want = int(plain.program(start, 1, hi_row if hi_row.any() else None))
    t = bk.bitset_tables(prob.circuit, prob.circuit_d, CPU, "lanes")
    got = lane_model(t.lanes, lo_nodes, bk.mask_bits(hi_row), bk.mask_bits(prob.scc_mask),
                     bk.mask_bits(prob.frozen), start, rows)
    return got, want


@pytest.mark.parametrize("name,broken,lo_bits,hi,starts", MODEL_CASES)
def test_lane_model_matches_plain(name, broken, lo_bits, hi, starts):
    prob = source_problem(name, broken)
    for start in starts:
        got, want = _plain_and_model(prob, lo_bits, hi, start, 96)
        assert got == want, (name, start)


@pytest.mark.parametrize("hi,start", [(0, 0), (5, 3 << 27), (7, 0), (6, (1 << 30) - 50)])
def test_lane_model_at_full_width_with_hi_rows_past_bit_32(hi, start):
    """n = 34: two node words, the hi row's nodes 31-33 past bit 32."""
    lo_nodes, hi_row = FULL.decode(30, hi)
    assert FULL.circuit.n == 34 and (bk.mask_bits(hi_row) >> 32 > 0) == (hi > 1)
    got, want = _plain_and_model(FULL, 30, hi, start, 64)
    assert got == want


def test_lane_model_masks_rows_past_the_window():
    """A window whose length is no multiple of 32 ends one row before a hit
    inside its last warp: the model (as the kernel) leaves that hit out,
    and one row more takes it."""
    prob = source_problem("sparse_giant", True)
    lo_nodes, _ = prob.decode(23)
    one = BitsetSweepRef(prob.circuit, lo_nodes, prob.scc_mask, prob.frozen, 1 << 14, prob.circuit_d, CPU)
    first = int(one.program(0, 1))
    assert 45 <= first < 1 << 14
    start = first - 45  # the hit is lane 13 of the window's second warp
    for rows in (45, 46, 77):
        got, want = _plain_and_model(prob, 23, 0, start, rows)
        assert got == want, rows
        assert (got == first) is (rows > 45)


@pytest.mark.parametrize("label,n,units,seed,hi,starts", [
    ("depth 2, cw 4", 20, 100, 3, 0, (0, 1 << 14, (1 << 19) - 70)),
    ("depth 2, two node words", 36, 110, 5, 0x1F, (0, 1 << 25, (1 << 30) - 4116)),
    ("depth 2, cw 2", 12, 60, 11, 0, (0, 1 << 6, (1 << 11) - 70)),
])
def test_lane_model_on_nested_circuits_matches_plain(label, n, units, seed, hi, starts):
    """Dense nesting two levels deep: inner units renumbered by height, the
    node units' child rows over two or four unit words."""
    prob = circuit_problem(label, dense_child_circuit(n=n, units=units, seed=seed))
    t = bk.bitset_tables(prob.circuit, None, CPU)
    assert t.instance == "lanes" and t.lanes.inner_end == units
    lo_bits = min(n - 1, 30)
    outcomes = set()
    for start in starts:
        got, want = _plain_and_model(prob, lo_bits, hi, start, 70)
        assert got == want, (label, start)
        outcomes.add(want == INT32_MAX)
    assert False in outcomes  # hits among the windows


def test_the_model_cases_hit_and_miss():
    """The compared windows hold hits and clean misses."""
    outcomes = set()
    for name, broken, lo_bits, hi, starts in MODEL_CASES:
        for start in starts:
            outcomes.add(_plain_and_model(source_problem(name, broken), lo_bits, hi, start, 96)[1] == INT32_MAX)
    assert outcomes == {True, False}


def test_decode_tables_decode_every_low_bit():
    lo_nodes = np.asarray([5, 33, 0, 17, 40, 2, 9, 11, 62, 1, 3], dtype=np.int64)
    dec = decode_tables(lo_nodes)
    rng = np.random.default_rng(0)
    for idx in rng.integers(0, 1 << 31, size=200):
        want = 0
        for j, v in enumerate(lo_nodes):
            if (int(idx) >> j) & 1:
                want |= 1 << int(v)
        got = 0
        for k in range(4):
            got |= int(dec[k, (int(idx) >> (8 * k)) & 255])
        assert got == want


def test_lane_tables_put_children_first():
    """Node units keep positions [0, n); every child sits at a lower
    position than its parent; records carry thr - 1 and the child mask."""
    circuit = dense_child_circuit(n=20, units=100, seed=3)
    lt = bk.lane_tables(circuit, None, CPU)
    assert list(lt.order[:20]) == list(range(20)) and sorted(lt.order) == list(range(100))
    pos = np.empty(100, dtype=np.int64)
    pos[lt.order] = np.arange(100)
    parents, kids = np.nonzero(circuit.child)
    inner = parents >= 20
    assert inner.any() and (~inner).any() and (kids >= 20).all()
    assert (pos[kids[inner]] < pos[parents[inner]]).all()  # node units come last in a pass
    rec = lt.rec_q.numpy().view(np.uint32)
    assert (rec[:, 2].view(np.int32) == circuit.thresholds[lt.order] - 1).all()
    assert lt.cw == 4 and lt.smem == bk.lane_smem_bytes(100, 4)
    rows = lt.child.numpy().view(np.uint32)
    assert (((rec[:, 3, None] >> np.arange(4)) & 1) == (rows != 0)).all()


def _ring(units_of: int):
    return encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(30, units_of))))


def test_host_picks_the_instance_from_the_shape():
    """Narrow circuits take the lane instance; the 390-unit ring and the
    993-unit circuit the resident warp instance, the 3001-unit one the
    streamed; a forced instance the circuit does not fit raises."""
    narrow = {
        "sparse_giant(400)": source_problem("sparse_giant", True),
        "near_disjoint_cores(6,1)": source_problem("ndc6", True),
        "benchmark_fbas(40,8) whole": source_problem("bench40", True),
        "full width": FULL,
        "dense_child_circuit(n=20, units=100)": circuit_problem("d", dense_child_circuit(n=20, units=100, seed=3)),
    }
    for label, prob in narrow.items():
        t = bk.bitset_tables(prob.circuit, prob.circuit_d, CPU)
        assert t.instance == "lanes" and not t.resident, label
        assert (t.lanes.cw, t.lanes.nw) in {(0, 1), (0, 2), (1, 1), (2, 1), (2, 2), (4, 1), (4, 2)}, label
    full = bk.bitset_tables(FULL.circuit, FULL.circuit_d, CPU).lanes
    assert (full.cw, full.nw, full.child) == (0, 2, None)  # depth 0: no child words
    ring = bk.bitset_tables(_ring(12), None, CPU)
    assert ring.n_units == 390 and ring.instance == "resident"
    assert bk.bitset_tables(dense_child_circuit(), None, CPU).instance == "resident"
    wide = bk.bitset_tables(dense_child_circuit(units=3001), None, CPU)
    assert wide.instance == "streamed"
    with pytest.raises(bk.KernelLimitError, match="lane instance"):
        bk.bitset_tables(_ring(12), None, CPU, "lanes")
    with pytest.raises(ValueError):
        bk.bitset_tables(FULL.circuit, FULL.circuit_d, CPU, "warp")
    for instance in ("resident", "streamed"):
        assert bk.bitset_tables(FULL.circuit, FULL.circuit_d, CPU, instance).lanes is None


@pytest.mark.parametrize("fault", ["a node unit as a child", "a child's height not below its parent's"])
def test_a_node_unit_as_a_child_takes_the_warp_instance(fault):
    """One pass in height order needs every child among the inner units and
    below its parent in ``unit_depth``; otherwise the warp instance runs."""
    base = dense_child_circuit(n=12, units=60, seed=11)
    child, unit_depth = base.child.copy(), base.unit_depth.copy()
    if fault.startswith("a node"):
        child[base.n + 1, 3] = 1  # an inner unit counts node unit 3
    else:
        parents, kids = np.nonzero(child[base.n:])
        unit_depth[kids[0]] = unit_depth[base.n + parents[0]]
    circuit = Circuit(n=base.n, n_units=base.n_units, depth=base.depth, thresholds=base.thresholds,
                      members=base.members, child=child, unit_depth=unit_depth)
    assert bk.lane_tables(base, None, CPU) is not None
    assert bk.lane_tables(circuit, None, CPU) is None
    assert bk.bitset_tables(circuit, None, CPU).instance == "resident"
