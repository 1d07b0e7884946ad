"""Plain PyTorch version of the block guard — the CPU path of block-guard
pruning and the yardstick the CUDA guard (:mod:`.guard_cuda`) is held
against on the card.

The function: ``(B, n)`` 0/1 maximal-candidate rows in, ``(B,)`` int32
survivor counts out, the size of each row's Q-side greatest fixpoint.  A
zero count proves that the block's maximal candidate holds no quorum, so no
window of the block can hit.  It is what the JAX package's three guards
compute:

- ``pallas_guard_factory`` (``backends/tpu/pallas_sweep.py:257``, K2);
- ``guard_program_factory`` (``backends/tpu/kernels.py:359``, K6);
- ``bitset_guard_program_factory`` (``kernels.py:722``, the guard half of K8).

The dense encoding runs :func:`.sweep_ref.fixpoint` (any vote multiplicity),
the bitset encoding :func:`.packed_ref.bitset_fixpoint` over
``bitset_encode``'s words (0/1 votes only).  Every row is evaluated once:
there is no fixed chunk shape and no zero padding to strip.
"""

from __future__ import annotations

import numpy as np
import torch

from quorum_intersection_tpu_torch.encode.circuit import Circuit, pack_mask_words
from quorum_intersection_tpu_torch.kernels.packed_ref import BitsetTables, bitset_fixpoint, popcount32
from quorum_intersection_tpu_torch.kernels.sweep_ref import CircuitTables, fixpoint

ENCODINGS = ("dense", "bitset")


def guard_counts(
    circuit: Circuit,
    masks: np.ndarray,
    encoding: str = "dense",
    device: torch.device = torch.device("cpu"),
) -> torch.Tensor:
    """Survivor count of each row of ``masks`` ``(B, n)`` as a ``(B,)``
    int32 tensor on ``device``."""
    if encoding not in ENCODINGS:
        raise ValueError(f"unknown guard encoding {encoding!r}")
    masks = np.asarray(masks)
    if masks.ndim != 2 or masks.shape[1] != circuit.n:
        raise ValueError(f"guard masks have shape {masks.shape}; the circuit has {circuit.n} nodes")
    if encoding == "dense":
        tables = CircuitTables(circuit, device)
        return fixpoint(tables, tables.cast(masks != 0)).sum(dim=1, dtype=torch.int32)
    bt = BitsetTables(circuit, device)
    words = torch.from_numpy(pack_mask_words(masks, bt.words).astype(np.int64)).to(device)
    return popcount32(bitset_fixpoint(bt, words)).sum(dim=1, dtype=torch.int32)
