"""Bitset sweep problems shared by the port's CPU and card tests and by
``chip_smoke.py``.  Imports nothing of JAX or the JAX package, so the card
tests can use it on a machine without them."""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional

import numpy as np

from quorum_intersection_tpu_torch.encode.circuit import Circuit, encode_circuit, restrict_circuit_pair
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph, group_sccs, tarjan_scc
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
from quorum_intersection_tpu_torch.fbas.semantics import max_quorum

from _torch_circuits import dense_child_circuit


@dataclass
class BitsetProblem:
    """One sweep problem as the unpacked drive builds it: the Q circuit, the
    D circuit of a restricted problem (None: the Q circuit with ``frozen``),
    the SCC's nodes in the circuit (``local[0]`` fixed out), its row."""

    label: str
    circuit: Circuit
    circuit_d: Optional[Circuit]
    local: List[int]
    scc_mask: np.ndarray
    frozen: Optional[np.ndarray]

    def decode(self, lo_bits: int, hi: int = 0):
        """``(lo_nodes, hi_row)``: the first ``lo_bits`` enumeration bits in
        the kernel, bit j of ``hi`` toggling the node of bit lo_bits + j."""
        lo_nodes = np.asarray(self.local[1:1 + lo_bits], dtype=np.int32)
        hi_row = np.zeros(self.circuit.n, dtype=np.int32)
        for j, v in enumerate(self.local[1 + lo_bits:]):
            hi_row[v] = (hi >> j) & 1
        return lo_nodes, hi_row


def graph_problem(label: str, data, restrict: bool) -> BitsetProblem:
    """The quorum-bearing SCC of ``data``: restricted (Q and D circuits),
    or on the whole graph with the Q6 frozen row."""
    graph = build_graph(parse_fbas(data))
    count, comp = tarjan_scc(graph.n, graph.succ)
    sccs = group_sccs(graph.n, comp, count)
    scc = next(m for m in sccs if max_quorum(graph, m, [v in set(m) for v in range(graph.n)]))
    whole = encode_circuit(graph)
    if restrict:
        q, d = restrict_circuit_pair(whole, scc)
        return BitsetProblem(label, q, d, list(range(len(scc))), np.ones(len(scc), dtype=np.int32), None)
    mask = np.zeros(whole.n, dtype=np.int32)
    mask[scc] = 1
    return BitsetProblem(label, whole, None, list(scc), mask, 1 - mask)


def circuit_problem(label: str, circuit: Circuit) -> BitsetProblem:
    """A hand-made circuit whose every node is in the SCC, scoped."""
    return BitsetProblem(label, circuit, None, list(range(circuit.n)), np.ones(circuit.n, dtype=np.int32), None)


# (source, restrict) of the CPU tests' problems: sparse_giant(400)
# restricts to the 10 000-node default's 24-node SCC (U=32, depth 1);
# near_disjoint_cores(6, 1) is one 13-node SCC, restricted into a Q/D pair
# as the packed drive does; the benchmark network runs unrestricted, with
# the Q6 frozen row.
SOURCES = {
    "sparse_giant": (lambda b: synth.sparse_giant(400, broken=b), True),
    "ndc6": (lambda b: synth.near_disjoint_cores(6, 1, broken=b), True),
    "bench40": (lambda b: synth.benchmark_fbas(40, 8, broken=b, seed=0), False),
}

# (source, broken, lo_bits, hi, starts) the schedule models run on: hits,
# misses, a hi row and a chunk tail (sparse_giant at 10 low bits).
MODEL_CASES = [
    ("sparse_giant", True, 23, 0, [0, (1 << 22) + 5]),
    ("sparse_giant", True, 10, 0x1A5, [(1 << 10) - 40]),
    ("ndc6", True, 12, 0, [0, 1500]),
    ("bench40", True, 7, 0, [0]),
    ("bench40", False, 7, 0, [0]),
]


@lru_cache(maxsize=None)
def source_problem(name: str, broken: bool) -> BitsetProblem:
    make, restrict = SOURCES[name]
    return graph_problem(name, make(broken), restrict)


def card_problems():
    """``(problem, lo_bits, hi values, starts, batch, steps)``: the shapes
    K8 is held to its plain version on, on the card: the bitset workload
    (``sparse_giant(400)``, restricted: U=32, depth 1), a near-disjoint core
    pair scoped and restricted, a whole graph with a frozen row, full width
    (34 nodes, 30 low bits, hi rows past bit 32), chunk tails (rows past a
    decode chunk's end alias), a 390-unit ring (13 satisfaction words) and
    the densely nested 993- and 3001-unit circuits."""
    out = []
    for broken in (False, True):
        sg = graph_problem(f"sparse_giant(400,broken={broken}) restricted",
                           synth.sparse_giant(400, broken=broken), True)
        out.append((sg, 23, [0], [0, 1 << 21, (1 << 23) - 6000], 3000, 2))
        out.append((sg, 10, [0, 0x1a5], [(1 << 10) - 700, (1 << 10) - 100], 256, 4))  # a hi row, chunk tails
        ndc = synth.near_disjoint_cores(6, 1, broken=broken)
        out.append((graph_problem(f"near_disjoint_cores(6,1,broken={broken}) restricted", ndc, True),
                    12, [0], [0, 1500], 1000, 2))
        out.append((graph_problem(f"near_disjoint_cores(6,1,broken={broken}) whole", ndc, False),
                    12, [0], [0, 1500], 1000, 2))
        bench = synth.benchmark_fbas(40, 8, broken=broken, seed=0)
        out.append((graph_problem(f"benchmark_fbas(40,8,broken={broken}) frozen row", bench, False),
                    7, [0], [0], 128, 1))
        full = graph_problem(f"benchmark_fbas(256,34,broken={broken}) wide", synth.benchmark_fbas(256, 34, broken=broken), True)
        out.append((full, 30, [0, 5, 7], [0, 3 << 27], 1 << 14, 4))
        ring = circuit_problem(f"inner_set_ring_fbas(30,12,broken={broken})",
                               encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(30, 12, broken=broken)))))
        out.append((ring, 29, [0], [0, 3 << 20, (1 << 29) - (1 << 13)], 1 << 12, 2))
    out.append((circuit_problem("dense_child_circuit() U=993", dense_child_circuit()), 30, [0], [0, 1 << 20], 2000, 2))
    out.append((circuit_problem("dense_child_circuit(units=3001)", dense_child_circuit(units=3001)), 30, [0],
                [0, 1 << 20], 1000, 2))
    return out
