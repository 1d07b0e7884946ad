"""Accumulating named wall-clock phase timers (``SolveResult.timers``), each
phase also a ``phase.<name>`` span of the run record (the JAX package's
``utils/timers.py``), so one instrumentation point feeds both the CLI's
``--timing`` lines and the telemetry stream."""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator

from quorum_intersection_tpu_torch.utils.telemetry import get_run_record


@dataclass
class PhaseTimers:
    totals: Dict[str, float] = field(default_factory=dict)

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            with get_run_record().span(f"phase.{name}"):
                yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - start

    def summary(self) -> Dict[str, float]:
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))
