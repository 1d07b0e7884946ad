"""The port's plain sweep (``kernels/sweep_ref.py``) against the JAX
package's ``backends/tpu/kernels.py`` on the CPU, and the fused CUDA kernel
against the plain version on the card.

Same numpy-seeded inputs through both; tolerance is exact equality, since
every quantity is an integer (vote counts, masks, hit indices).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quorum_intersection_tpu.backends.tpu import kernels as jk
from quorum_intersection_tpu.backends.tpu import pallas_sweep
from quorum_intersection_tpu_torch.encode.circuit import Circuit
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.kernels import sweep_ref as ref
from quorum_intersection_tpu_torch.kernels.sweep_cuda import (
    FusedSweep,
    KernelLimitError,
    mask_bits,
    plane_tables,
    sweep_fused,
)

from _torch_cases import CASES, rng_rows, sweep_case

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _problem(sc, mode: str, seed: int):
    """(jax Q circuit, jax D circuit, port Q, port D, scc, frozen, lo_nodes,
    hi row) for one sweep mode, built the way the sweep backends build them."""
    if mode == "narrow" or sc.pair is None:
        jq, pq, jd, pd = sc.jax_circuit, sc.circuit, None, None
        scc = list(sc.scc)
        n = pq.n
        scc_mask = np.zeros(n, dtype=np.int32)
        scc_mask[scc] = 1
        frozen = None if mode == "restricted" else 1 - scc_mask
    else:
        (jq, jd), (pq, pd) = sc.jax_pair, sc.pair
        scc = list(range(pq.n))
        scc_mask = np.ones(pq.n, dtype=np.int32)
        frozen = None
    hi = None
    lo_nodes = np.asarray(scc[1:], dtype=np.int32)
    if mode == "wide":
        lo_bits = min(len(scc) - 1, 3)
        lo_nodes = lo_nodes[:lo_bits]
        hi = np.zeros(pq.n, dtype=np.int32)
        hi_nodes = scc[1 + lo_bits:]
        pick = np.random.default_rng(seed).random(len(hi_nodes)) < 0.5
        hi[np.asarray(hi_nodes, dtype=np.int64)[pick]] = 1
    return jq, jd, pq, pd, scc_mask, frozen, lo_nodes, hi


@pytest.mark.parametrize("case", CASES)
def test_node_sat_and_fixpoint_match_jax(case):
    sc = sweep_case(case)
    # The restricted pair where there is one (the whole-graph circuit is
    # covered by the narrow sweep_step and program cases).
    pairs = [(sc.jax_circuit, sc.circuit)] if sc.pair is None else list(zip(sc.jax_pair, sc.pair))
    for k, (jc, pc) in enumerate(pairs):
        avail = rng_rows(k, 48, pc.n)
        frozen = rng_rows(k + 7, 1, pc.n, 0.3)[0]
        arrays = jk.CircuitArrays(jc)
        tables = ref.CircuitTables(pc, CPU)
        np.testing.assert_array_equal(
            np.asarray(jk.node_sat(arrays, jnp.asarray(avail, arrays.dtype))),
            ref.node_sat(tables, tables.cast(avail)).numpy(),
        )
        # One compiled JAX fixpoint serves both calls: a None frozen row is
        # the all-zero row there.
        jax_fixpoint = jax.jit(lambda a, f: jk.fixpoint(arrays, a, f))
        for fz in (None, frozen):
            np.testing.assert_array_equal(
                np.asarray(jax_fixpoint(arrays.cast(avail), arrays.cast(np.zeros(pc.n) if fz is None else fz))),
                ref.fixpoint(tables, avail, fz).numpy(),
            )
    # The batch's trip count is its slowest row's pass count (last pair).
    _, passes = ref.fixpoint_passes(tables, avail)
    assert int(passes.max()) == int(jk.fixpoint_iters(arrays, avail)[1])


STEP_CASES = ["nested_correct.json", "nested_broken.json", "snapshot_broken.json",
              "maj6-broken", "bench-broken:0", "bench-nested-broken:1"]


@pytest.mark.parametrize("mode", ["narrow", "wide", "restricted"])
@pytest.mark.parametrize("case", STEP_CASES)
def test_sweep_step_matches_jax(case, mode):
    sc = sweep_case(case)
    jq, jd, pq, pd, scc_mask, frozen, lo_nodes, hi = _problem(sc, mode, 3)
    batch = 64
    total = 1 << len(lo_nodes)
    arrays = jk.CircuitArrays(jq)
    arrays_d = None if jd is None else jk.CircuitArrays(jd)
    tables = ref.CircuitTables(pq, CPU)
    tables_d = None if pd is None else ref.CircuitTables(pd, CPU)
    pos = ref.bit_positions(lo_nodes, pq.n)
    fz = np.zeros(pq.n, dtype=np.int32) if frozen is None else frozen
    jax_step = jax.jit(lambda s: jk.sweep_step(
        arrays, s, batch, jnp.asarray(pos), arrays.cast(scc_mask), arrays.cast(fz),
        None if hi is None else arrays.cast(hi), arrays_d=arrays_d,
    ))
    for start in sorted({0, total // 3, max(total - batch, 0)}):
        j_hit, j_q = jax_step(jnp.int32(start))
        p_hit, p_q = ref.sweep_step(
            tables, start, batch, torch.from_numpy(pos), tables.cast(scc_mask),
            tables.cast(fz), None if hi is None else tables.cast(hi), tables_d=tables_d,
        )
        np.testing.assert_array_equal(np.asarray(j_hit), p_hit.numpy())
        np.testing.assert_array_equal(np.asarray(j_q), p_q.numpy())


@pytest.mark.parametrize("case", CASES)
def test_program_min_hit_matches_jax(case):
    """Per-program min hit: the plain program, the wrapper on the CPU, and
    the JAX ``sweep_program_factory`` agree at several starts."""
    sc = sweep_case(case)
    mode = ("narrow", "wide", "restricted")[CASES.index(case) % 3]
    jq, jd, pq, pd, scc_mask, frozen, lo_nodes, hi = _problem(sc, mode, 5)
    batch = 32
    total = 1 << len(lo_nodes)
    jax_factory = jk.sweep_program_factory(jq, lo_nodes, scc_mask, frozen, batch, circuit_d=jd)
    port_factory = ref.sweep_program_factory(pq, lo_nodes, scc_mask, frozen, batch, circuit_d=pd)
    fused = FusedSweep(pq, lo_nodes, scc_mask, frozen, batch, circuit_d=pd, device="cpu")
    launches = sweep_fused.launches
    for steps in (1, 3):
        jax_prog, port_prog = jax_factory(steps), port_factory(steps)
        for start in sorted({0, total // 2, max(total - batch, 0)}):
            want = int(jax_prog(start, hi))
            assert int(port_prog(start, hi)) == want, (steps, start)
            assert int(fused.program(start, steps, mask_bits(hi))) == want, (steps, start)
    assert sweep_fused.launches == launches  # the CPU path never launches


@pytest.mark.parametrize("case", ["nested_correct.json", "maj6-broken"])
def test_program_matches_pallas_interpret(case):
    """An unrestricted narrow circuit: the plain program against the JAX
    package's fused Pallas kernel in interpret mode (as tests/test_pallas.py
    runs it)."""
    sc = sweep_case(case)
    jq, _, pq, _, scc_mask, frozen, lo_nodes, _ = _problem(sc, "narrow", 0)
    total = 1 << len(lo_nodes)
    batch, _ = pallas_sweep.plan_batch(min(total, 128))
    pal = pallas_sweep.pallas_sweep_program_factory(jq, lo_nodes, scc_mask, frozen, batch)(1)
    port = ref.sweep_program_factory(pq, lo_nodes, scc_mask, frozen, batch)(1)
    for start in sorted({0, max(total - batch, 0)}):
        assert int(port(start)) == int(pal(start)), start


def _multi_edge_circuit() -> Circuit:
    """Vote counts above 1: node 0 lists node 1 three times, an inner set is
    repeated twice, and one threshold is <= 0 (satisfied by constants)."""
    members = np.array(
        [[0, 3, 1, 0], [1, 1, 0, 2], [2, 0, 1, 1], [1, 1, 1, 1], [0, 0, 2, 1]], dtype=np.uint8
    )
    child = np.zeros((5, 5), dtype=np.uint8)
    child[0, 4] = 2
    child[3, 4] = 1
    return Circuit(
        n=4, n_units=5, depth=1,
        thresholds=np.array([4, 3, 0, 3, 2], dtype=np.int32),
        members=members, child=child,
        unit_depth=np.array([1, 0, 0, 1, 0], dtype=np.int32),
    )


def test_plane_tables_rebuild_counts():
    circuit = _multi_edge_circuit()
    t = plane_tables(circuit, CPU)
    blocks = t.blocks.numpy().view(np.uint32)
    first, m, k0, k1 = t.chunks.numpy()[0]

    def counts(block_ixs):
        """Horner over the blocks' planes (highest first); lane 4 g + q's
        word j holds columns 32 q + [0, 32) of unit 8 j + g."""
        total = 0
        for k in block_ixs:
            words = blocks[k].reshape(8, 4, 4).transpose(2, 0, 1).reshape(32, 4)
            total = 2 * total + ((words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(32, 128)
        return total.astype(np.int64)

    members = counts(range(first, first + m))
    child = counts(range(first + m, first + m + t.pc * (k1 - k0)))
    np.testing.assert_array_equal(members[: circuit.n_units, : circuit.n], circuit.members)
    np.testing.assert_array_equal(child[: circuit.n_units, : circuit.n_units - t.c0], circuit.child[:, t.c0:])
    assert (t.pm, t.pc, t.slabs, t.depth) == (2, 2, 1, 1)


def test_multi_edge_plain_matches_jax():
    circuit = _multi_edge_circuit()
    avail = rng_rows(11, 16, circuit.n, 0.5)
    import quorum_intersection_tpu.encode.circuit as jc

    jax_circuit = jc.Circuit(
        n=circuit.n, n_units=circuit.n_units, depth=circuit.depth,
        thresholds=circuit.thresholds, members=circuit.members, child=circuit.child,
        unit_depth=circuit.unit_depth,
    )
    np.testing.assert_array_equal(
        np.asarray(jk.fixpoint(jk.CircuitArrays(jax_circuit), avail)),
        ref.fixpoint(ref.CircuitTables(circuit, CPU), avail).numpy(),
    )


def test_kernel_limits_raise():
    wide = synth.majority_fbas(70)
    from quorum_intersection_tpu_torch.encode.circuit import encode_circuit
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas

    circuit = encode_circuit(build_graph(parse_fbas(wide)))
    with pytest.raises(KernelLimitError, match="at most 64"):
        plane_tables(circuit, CPU)


def test_sweep_fused_launches_only_on_cuda():
    """The kernel wrapper refuses CPU tables instead of running anything."""
    sc = sweep_case("trivial_broken.json")
    _, _, pq, pd, scc_mask, frozen, lo_nodes, _ = _problem(sc, "narrow", 0)
    fused = FusedSweep(pq, lo_nodes, scc_mask, frozen, 4, circuit_d=pd, device="cpu")
    launches = sweep_fused.launches
    with pytest.raises(ValueError, match="CUDA only"):
        sweep_fused(fused, 0, 4)
    assert sweep_fused.launches == launches
