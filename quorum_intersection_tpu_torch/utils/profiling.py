"""Profiler hook: a device trace of one solve.

The port's counterpart of the JAX package's ``utils/profiling.py``:
``with profile_trace(dir, device):`` around a solve records it with
``torch.profiler`` (host activity, and the card's kernels through CUPTI when
the device is a card) and writes a Chrome trace (``chrome://tracing``,
``ui.perfetto.dev``) into ``dir``.  A no-op when ``dir`` is falsy, so the
CLI passes its ``--profile-dir`` straight through.

The trace and the run record join on one key: the solve runs inside a
``torch.profiler.record_function`` range named ``qi-trace:<trace_id>`` (and
an NVTX range of the same name on a card), and the record holds the
``profile.trace`` span with ``dir`` and ``trace_id`` and the
``profile.trace_dir`` gauge.  A profiler that fails to start fails the
solve: a profiled run never goes on without its trace.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Iterator, Optional

from quorum_intersection_tpu_torch.device import DeviceLike
from quorum_intersection_tpu_torch.utils.logging import get_logger
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record

log = get_logger("utils.profiling")


def trace_file(trace_dir: str, trace_id: str) -> Path:
    """Where :func:`profile_trace` writes the trace of run ``trace_id``."""
    return Path(trace_dir) / f"qi-trace-{trace_id}.pt.trace.json"


@contextmanager
def profile_trace(trace_dir: Optional[str], device: DeviceLike = None) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the body into ``trace_dir``
    (no-op if falsy); ``device`` (None: CUDA) says whether the card's
    activity is recorded too."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device("cuda" if device is None else device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    rec = get_run_record()
    label = f"qi-trace:{rec.trace_id}"
    out = trace_file(trace_dir, rec.trace_id)
    log.info("recording a torch.profiler trace to %s", out)
    rec.gauge("profile.trace_dir", str(trace_dir))
    with rec.span("profile.trace", dir=str(trace_dir), trace_id=rec.trace_id):
        with profile(activities=activities) as prof:
            with record_function(label), (torch.cuda.nvtx.range(label) if on_card else nullcontext()):
                yield
            if on_card:
                torch.cuda.synchronize()
        out.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out))
