"""The fused CUDA sweep on the card, against its plain PyTorch version and
against the CPU path.  Card-only: every test takes the ``cuda_device``
fixture, which skips on a host without one.  This file imports nothing of
JAX or the JAX package, so on the card's machine it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: exact equality (hit indices, verdicts and witness node lists are
integers).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from quorum_intersection_tpu_torch.encode.circuit import encode_circuit, restrict_circuit_pair
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph, group_sccs, tarjan_scc
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.fbas.semantics import max_quorum
from quorum_intersection_tpu_torch.kernels import sweep_ref as ref
from quorum_intersection_tpu_torch.kernels.sweep_cuda import (
    FusedSweep,
    KernelLimitError,
    mask_bits,
    sweep_fused,
)
from quorum_intersection_tpu_torch.pipeline import solve

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)
FIXTURES = pathlib.Path(__file__).resolve().parent.parent / "fixtures"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused kernel has no CPU mode")
    return torch.device("cuda")


def _data(case: str):
    if case.endswith(".json"):
        return json.loads((FIXTURES / case).read_text())
    core, broken = case.split("-")
    return synth.benchmark_fbas(48, int(core), nested_watchers=True, broken=broken == "broken", seed=1)


def _problems(case: str):
    """Narrow (whole graph, Q6 frozen row), restricted (Q6 fold), and wide
    (3 low bits, random hi row) sweep problems of the quorum-bearing SCC."""
    graph = build_graph(parse_fbas(_data(case)))
    count, comp = tarjan_scc(graph.n, graph.succ)
    sccs = group_sccs(graph.n, comp, count)
    scc = next(m for m in sccs if max_quorum(graph, m, [v in set(m) for v in range(graph.n)]))
    whole = encode_circuit(graph)
    out = []
    if whole.n <= 64:
        mask = np.zeros(whole.n, dtype=np.int32)
        mask[scc] = 1
        out.append(("narrow", whole, None, list(scc), mask, 1 - mask, len(scc) - 1, 0))
    if whole.n > len(scc):
        q, d = restrict_circuit_pair(whole, scc)
        local = list(range(len(scc)))
        mask = np.ones(len(scc), dtype=np.int32)
        out.append(("restricted", q, d, local, mask, None, len(scc) - 1, 0))
        out.append(("wide", q, d, local, mask, None, 3, 0b1011))
    return out


@pytest.mark.parametrize(
    "case", ["nested_correct.json", "nested_broken.json", "snapshot_broken.json", "9-broken", "10-correct"]
)
def test_fused_kernel_matches_plain_on_card(case, cuda_device):
    for mode, q, d, local, mask, frozen, lo_bits, hi in _problems(case):
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        hi_row = np.zeros(q.n, dtype=np.int32)
        for j, v in enumerate(local[1 + lo_bits:]):
            hi_row[v] = (hi >> j) & 1
        batch = min(1 << 12, 1 << lo_bits)
        fused = FusedSweep(q, lo_nodes, mask, frozen, batch, circuit_d=d, device=cuda_device)
        plain = ref.SweepRef(q, lo_nodes, mask, frozen, batch, d, cuda_device)
        launches = sweep_fused.launches
        for start in sorted({0, (1 << lo_bits) // 2}):
            got = int(fused.program(start, 2, mask_bits(hi_row)))
            want = int(plain.program(start, 2, hi_row if hi_row.any() else None))
            assert got == want, (mode, start)
        assert sweep_fused.launches > launches


@pytest.mark.parametrize("name", ["trivial_broken.json", "nested_correct.json", "snapshot_broken.json"])
def test_card_solve_matches_cpu_solve(name, cuda_device):
    text = (FIXTURES / name).read_text()
    on_card, on_cpu = solve(text, device=cuda_device), solve(text, device="cpu")
    assert (on_card.intersects, on_card.q1, on_card.q2) == (on_cpu.intersects, on_cpu.q1, on_cpu.q2)
    assert on_card.stats.get("hit_index") == on_cpu.stats.get("hit_index")
    assert on_card.stats["device"] == "cuda"


def test_index_ceiling_raises_before_launch(cuda_device):
    _, q, d, local, mask, frozen, _, _ = _problems("9-broken")[0]
    fused = FusedSweep(q, np.asarray(local[1:], dtype=np.int32), mask, frozen, 1 << 8, d, cuda_device)
    launches = sweep_fused.launches
    with pytest.raises(KernelLimitError, match="2\\^31"):
        sweep_fused(fused, (1 << 31) - 8, 16)
    assert sweep_fused.launches == launches
