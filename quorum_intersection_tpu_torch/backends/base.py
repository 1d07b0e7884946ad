"""Backend protocol and registry (the port knows one backend: ``gpu-sweep``)."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, runtime_checkable

from quorum_intersection_tpu_torch.encode.circuit import Circuit
from quorum_intersection_tpu_torch.fbas.graph import TrustGraph

# Miss sentinel for first-hit index reductions: the sweep kernels return this
# value for a program with no hit; callers compare against it.
INT32_MAX = 2**31 - 1


class SearchCancelled(RuntimeError):
    """A cooperatively-cancelled search stopped before reaching a verdict.

    Raised (never returned as a verdict) by engines that accept a
    :class:`CancelToken`.  Cancellation is an abort signal about
    *scheduling*, never information about the verdict."""


class CancelToken:
    """Cooperative cancellation flag, set exactly once and never cleared;
    the sweep polls :attr:`cancelled`.  (The JAX package's token also
    carries a numpy flag for its native oracle, which the port has not.)"""

    __slots__ = ("_event",)

    def __init__(self) -> None:
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()


@dataclass
class SccCheckResult:
    """Outcome of the disjoint-quorum search inside one SCC.

    ``intersects`` is the verdict for this SCC: True iff every pair of quorums
    intersects.  On False, ``q1``/``q2`` are a witness pair of disjoint
    quorums.  ``stats`` carries backend counters (candidates checked,
    seconds, the hit index).
    """

    intersects: bool
    q1: Optional[List[int]] = None
    q2: Optional[List[int]] = None
    stats: Dict[str, float] = field(default_factory=dict)


@runtime_checkable
class SearchBackend(Protocol):
    name: str

    def check_scc(
        self,
        graph: TrustGraph,
        circuit: Optional[Circuit],
        scc: List[int],
        *,
        scope_to_scc: bool = False,
    ) -> SccCheckResult:
        """Decide disjoint-quorum existence within ``scc``.

        ``scope_to_scc=False`` reproduces the reference's availability
        semantics — the whole graph starts available (cpp:354, quirk Q6) —
        which is only sound for a sink SCC.  ``True`` scopes availability to
        the SCC, the principled default for non-sink components.
        """
        ...


def get_backend(name: str, **options) -> SearchBackend:
    """Instantiate a backend by name (lazy import keeps torch's CUDA setup
    out of the pure host paths)."""
    if name == "gpu-sweep":
        from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend

        return GpuSweepBackend(**options)
    raise ValueError(f"unknown backend {name!r}")
