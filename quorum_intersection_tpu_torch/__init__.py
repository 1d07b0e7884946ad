"""quorum_intersection_tpu_torch — the PyTorch/CUDA port of
``quorum_intersection_tpu``: the CLI verdict path and the batch path, with
the candidate sweeps and the block guard as hand-written CUDA kernels for
Hopper (``kernels/csrc``), the host oracles raced against them, and a
checkable certificate on every verdict; PageRank (its power loop a CUDA
kernel too), the top-tier, blocking-set and splitting-set analyses and the
configuration sanitizer.

Layout mirrors the JAX package so each module's counterpart is easy to find:

- ``fbas``      — stellarbeat JSON frontend, trust graph, Tarjan SCC, semantics
- ``encode``    — nested quorum sets flattened into threshold-circuit arrays
- ``kernels``   — the CUDA kernels, their build, their plain versions
- ``backends``  — ``auto`` (the router), ``gpu-sweep``, ``cpp`` and ``python``
- ``analytics`` — PageRank, top tier, blocking and splitting sets, Graphviz
- ``cert``      — qi-cert/1 certificates, checked by ``tools/check_cert.py``
- ``pipeline``  — parse → graph → SCC guard → search → certificate; ``cli`` on top

The package imports neither JAX nor ``quorum_intersection_tpu``; entry points
run on CUDA unless called with ``device="cpu"``.
"""

__version__ = "0.1.0"

from quorum_intersection_tpu_torch.encode.circuit import Circuit, encode_circuit
from quorum_intersection_tpu_torch.fbas.graph import TrustGraph, build_graph
from quorum_intersection_tpu_torch.fbas.schema import Fbas, parse_fbas
from quorum_intersection_tpu_torch.pipeline import solve

__all__ = [
    "Circuit",
    "Fbas",
    "TrustGraph",
    "build_graph",
    "encode_circuit",
    "parse_fbas",
    "solve",
    "__version__",
]
