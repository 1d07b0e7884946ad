"""quorum_intersection_tpu_torch — the PyTorch/CUDA port of
``quorum_intersection_tpu``: the CLI verdict path, with the candidate sweep
as a hand-written CUDA kernel for Hopper (``kernels/csrc/sweep.cu``).

Layout mirrors the JAX package so each module's counterpart is easy to find:

- ``fbas``      — stellarbeat JSON frontend, trust graph, Tarjan SCC, semantics
- ``encode``    — nested quorum sets flattened into threshold-circuit arrays
- ``kernels``   — the fused sweep: CUDA kernel, its build, its plain version
- ``backends``  — the ``gpu-sweep`` search backend
- ``pipeline``  — parse → graph → SCC guard → search; ``cli`` on top

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
