"""Plain PyTorch version of the PageRank power loop — the CPU route of
``pagerank`` and the yardstick the CUDA kernel (:mod:`.pagerank_cuda`) is
held against on the card.

The function is the JAX package's ``_jitted_power_loops``
(``analytics/pagerank.py:116-174``, K12 in PERF.md), with the kernel's
contract: ``(row_ptr, src, outdeg, m, conv, max_iterations)`` →
``(rank float32 (n,), iterations int32, last_diff float32)``, the in-edge
CSR as ``analytics.pagerank.in_edge_csr`` builds it.  The loop body is
JAX's (``:148-157``), in float32::

    send  = (1 - m) · inv_out · rank
    tmp   = m / n + matvec(send)
    total = m + Σ outdeg · send
    diff  = Σ |tmp − rank|
    rank  = tmp / total

repeated while ``diff > conv and it < max_iterations``, from ``rank = e₀``
and ``diff = conv + 1``.  Two forms, like JAX's two programs: ``sparse`` (a
gather and ``index_add_`` over the CSR's destinations) and ``dense``
(``torch.mv`` on the (N, N) count matrix).  It syncs with the host every
iteration (the stop test); it is a yardstick of correctness, not of speed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def power_loop(
    row_ptr: torch.Tensor,
    src: torch.Tensor,
    outdeg: torch.Tensor,
    m: float,
    conv: float,
    max_iterations: int,
    dense: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The power loop on the tensors' device; ``dense`` picks the form."""
    device = outdeg.device
    n = outdeg.numel()
    mf = torch.tensor(m, dtype=torch.float32, device=device)
    conv32 = float(np.float32(conv))
    # Each CSR entry's destination, and its source as an index.
    dst = torch.repeat_interleave(torch.arange(n, device=device), (row_ptr[1:] - row_ptr[:-1]).long())
    src = src.long()
    if dense:
        counts_t = torch.zeros((n, n), dtype=torch.float32, device=device)
        counts_t.index_put_((dst, src), torch.ones_like(dst, dtype=torch.float32), accumulate=True)

        def matvec(send: torch.Tensor) -> torch.Tensor:
            return torch.mv(counts_t, send)
    else:

        def matvec(send: torch.Tensor) -> torch.Tensor:
            return torch.zeros(n, dtype=torch.float32, device=device).index_add_(0, dst, send[src])

    inv_out = torch.where(outdeg > 0, 1.0 / torch.clamp(outdeg, min=1.0), torch.zeros_like(outdeg))
    base = mf / torch.tensor(float(n), dtype=torch.float32, device=device)
    rank = torch.zeros(n, dtype=torch.float32, device=device)
    rank[0] = 1.0
    diff = torch.tensor(np.float32(conv) + np.float32(1), device=device)
    it = 0
    while float(diff) > conv32 and it < max_iterations:
        send = (1 - mf) * inv_out * rank
        tmp = base + matvec(send)
        total = mf + torch.sum(outdeg * send)
        diff = torch.sum(torch.abs(tmp - rank))
        rank = tmp / total
        it += 1
    return rank, torch.tensor(it, dtype=torch.int32), diff.to(torch.float32)
