"""The process-wide run record: spans, events, counters, gauges and
histograms, and the sinks that carry them out of the process.

The port of the JAX package's ``utils/telemetry.py``, with the same schema
(``qi-telemetry/1``, one JSON object per line), so ``tools/metrics_report.py``
renders a stream of either package:

    {"kind": "meta",    "schema": "qi-telemetry/1", "pid": ..., "argv0": ..., "t_wall": ..., "trace_id": ...}
    {"kind": "span",    "name": "phase.search", "span_id": 3, "parent_id": 1,
     "start_s": 0.01, "seconds": 1.2, "trace_id": ..., "pid": ..., "tid": ..., "attrs": {...}}
    {"kind": "event",   "name": "sweep.window", "t_s": 0.5, "span_id": 3, "attrs": {...}}
    {"kind": "counter", "name": "sweep.candidates_checked", "value": 1048576}
    {"kind": "gauge",   "name": "sweep.prune_ratio", "value": 0.25}

``t_s``/``start_s`` are seconds since the record's creation (monotonic);
the meta line's ``t_wall`` anchors them to the wall clock.

Sinks attach to the record (:meth:`RunRecord.add_sink`):

- :class:`JsonlSink` — the streaming JSONL file (CLI ``--metrics-json``, env
  ``QI_METRICS_JSON``): every span end and event is written as it happens, so
  a crashed run leaves a parseable prefix; counters, gauges and histograms
  follow at :meth:`RunRecord.finish`;
- :class:`PromFileSink` — a Prometheus textfile rewritten at finish (CLI
  ``--metrics-prom``, env ``QI_METRICS_PROM``), encoded by :func:`prom_lines`;
- :class:`ChromeTraceSink` — Chrome/Perfetto trace-event JSON (CLI
  ``--trace-out``, env ``QI_TRACE_OUT``): spans as complete events on their
  own OS thread's track (the race's sweep arm runs on a worker thread), events
  as instant marks;
- :class:`StderrSummarySink` — the ``[telemetry]`` summary the CLI's
  ``--timing`` prints after its ``[timing]``/``[stats]`` lines.

Every record carries a ``trace_id``, minted or inherited from
``QI_TRACE_CONTEXT`` (:class:`TraceContext`); the router records its decisions
as events and :func:`cert.build_certificate` stamps the slice one solve
produced (:meth:`RunRecord.events_since`) into the certificate.  The
in-memory span and event lists are capped (:data:`MAX_SPANS`,
:data:`MAX_EVENTS`; the JSONL sink still streams every line); past the cap
lines are counted as dropped.  A bounded flight-recorder ring of the last
:data:`FLIGHT_RECORDER_N` span and event lines is always on;
:func:`dump_flight_recorder` writes it crash-only (``QI_FLIGHT_RECORDER``) when a
fault fires, the router degrades or quarantines a rung, or an exception is
not handled.

The serving layer adds :data:`LATENCY_WINDOW` for its p50/p99 gauges, the SLO
plane's :class:`SnapshotRing`, per-request trace adoption
(:meth:`RunRecord.adopted`), finish-time line providers
(:func:`register_final_lines`, the tenant table) and the live metrics endpoint
started from ``QI_METRICS_PORT`` (``utils/metrics_server.py``).
"""

from __future__ import annotations

import atexit
import bisect
import io
import json
import logging
import math
import os
import sys
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Iterator, List, Optional, Protocol, Sequence, Tuple

from quorum_intersection_tpu_torch.utils.env import qi_env

log = logging.getLogger("quorum_intersection_tpu_torch.utils.telemetry")

SCHEMA = "qi-telemetry/1"
FLIGHT_SCHEMA = "qi-flight/1"
PULSE_SCHEMA = "qi-pulse/1"
EXEMPLAR_SCHEMA = "qi-exemplar/1"

# The window behind the serving layer's p50/p99 gauges: large enough to smooth
# scheduler noise, small enough that a live scrape tracks the current load.
LATENCY_WINDOW = 512

# Histogram bucket upper edges in milliseconds: log-spaced from sub-ms to the
# minute class, the JAX package's, so the two packages' histograms merge.
DEFAULT_HIST_BOUNDS_MS: Tuple[float, ...] = (
    0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
    512.0, 1024.0, 2048.0, 4096.0, 8192.0, 16384.0, 32768.0, 65536.0,
)

# In-memory retention caps; overflow is counted, never silent.
MAX_SPANS = 100_000
MAX_EVENTS = 100_000
# Flight-recorder depth: the last N span/event lines kept for crash dumps.
FLIGHT_RECORDER_N = 512


def hist_bounds() -> Tuple[float, ...]:
    """The process's histogram bucket ladder: ``QI_PULSE_BUCKETS`` (a
    comma-separated strictly ascending list of upper edges in ms) overrides
    the default; a malformed override logs and falls back — a typo'd knob
    must cost resolution, never a request."""
    raw = qi_env("QI_PULSE_BUCKETS")
    if not raw:
        return DEFAULT_HIST_BOUNDS_MS
    try:
        bounds = tuple(float(part) for part in raw.split(",") if part.strip())
        if not bounds or list(bounds) != sorted(set(bounds)):
            # A duplicate edge would render duplicate le labels, and
            # Prometheus rejects the whole scrape.
            raise ValueError("bounds must be non-empty, strictly ascending")
        return bounds
    except ValueError as exc:
        log.warning("malformed QI_PULSE_BUCKETS (%s); using defaults", exc)
        return DEFAULT_HIST_BOUNDS_MS


def percentile(sorted_samples: List[float], pct: float) -> float:
    """Nearest-rank percentile of an ascending sample list (0 if empty):
    ``ceil(pct/100 * N)``, a true ceiling."""
    if not sorted_samples:
        return 0.0
    rank = max(math.ceil(pct / 100.0 * len(sorted_samples)) - 1, 0)
    return sorted_samples[min(rank, len(sorted_samples) - 1)]


class Histogram:
    """Fixed-bucket latency histogram (``qi-pulse/1``): non-cumulative
    per-bucket counts over ``bounds`` plus one overflow bucket, exact count
    and sum, lock-protected; the wire form the serving layer merges.  A
    bounded raw-sample window (:data:`LATENCY_WINDOW`) rides along for the
    serving layer's p50/p99 gauges (:meth:`window_percentile`)."""

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None,
                 window: int = LATENCY_WINDOW) -> None:
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(bounds) if bounds is not None else hist_bounds()
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._window: Optional[Deque[float]] = deque(maxlen=window) if window > 0 else None

    def observe(self, value_ms: float) -> None:
        ix = bisect.bisect_left(self.bounds, value_ms)
        with self._lock:
            self._counts[ix] += 1
            self._count += 1
            self._sum += value_ms
            if self._window is not None:
                self._window.append(value_ms)

    def window_percentile(self, pct: float) -> float:
        """Nearest-rank percentile over the bounded raw-sample window (sorted
        outside the lock)."""
        with self._lock:
            samples = list(self._window) if self._window is not None else []
        samples.sort()
        return percentile(samples, pct)

    def snapshot(self) -> Dict[str, object]:
        """The wire form ``{schema, bounds, counts, count, sum}``."""
        with self._lock:
            return {
                "schema": PULSE_SCHEMA,
                "bounds": list(self.bounds),
                "counts": list(self._counts),
                "count": self._count,
                "sum": round(self._sum, 6),
            }

    def set_from_wire(self, wire: Dict[str, object]) -> None:
        """Overwrite this histogram with a merged wire snapshot (the fleet
        front door publishes each aggregation cycle's merge this way).  The
        raw-sample window does not cross the wire and is cleared.  Bounds
        that do not match are refused: merging differently-bucketed
        histograms is unsound."""
        bounds = tuple(float(b) for b in wire.get("bounds") or ())
        counts = [int(c) for c in wire.get("counts") or ()]
        if bounds != self.bounds or len(counts) != len(self._counts):
            raise ValueError(f"histogram {self.name!r}: wire bounds do not match "
                             f"(merging differently-bucketed histograms is unsound)")
        with self._lock:
            self._counts = counts
            self._count = int(wire.get("count") or 0)
            self._sum = float(wire.get("sum") or 0.0)
            if self._window is not None:
                self._window.clear()

    def quantile_ms(self, pct: float) -> float:
        """Bucket-resolution quantile: the upper edge of the bucket holding
        the nearest-rank sample (the overflow bucket answers the largest
        finite edge), which is what a merged view can answer."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total <= 0:
            return 0.0
        rank = max(math.ceil(pct / 100.0 * total), 1)
        seen = 0
        for ix, n in enumerate(counts):
            seen += n
            if seen >= rank:
                return self.bounds[min(ix, len(self.bounds) - 1)]
        return self.bounds[-1]

    @staticmethod
    def merge_wire(parts: Sequence[Dict[str, object]]) -> Dict[str, object]:
        """Bucket-wise addition of wire snapshots: ``merge([h(A), h(B)]) ==
        h(A + B)`` exactly.  Raises ``ValueError`` on bucket ladders that
        differ (adding them would be silently wrong)."""
        if not parts:
            return {"schema": PULSE_SCHEMA, "bounds": [], "counts": [], "count": 0, "sum": 0.0}
        bounds = list(parts[0].get("bounds") or ())
        counts = [0] * len(list(parts[0].get("counts") or ()))
        count = 0
        total = 0.0
        for part in parts:
            if list(part.get("bounds") or ()) != bounds:
                raise ValueError("histogram merge: bucket bounds differ across parts")
            part_counts = list(part.get("counts") or ())
            if len(part_counts) != len(counts):
                raise ValueError("histogram merge: bucket count vectors differ in length")
            for ix, n in enumerate(part_counts):
                counts[ix] += int(n)
            count += int(part.get("count") or 0)
            total += float(part.get("sum") or 0.0)
        return {"schema": PULSE_SCHEMA, "bounds": bounds, "counts": counts, "count": count,
                "sum": round(total, 6)}

    def to_line(self) -> Dict[str, object]:
        """The JSONL stream line (``kind: histogram``)."""
        snap = self.snapshot()
        snap.pop("schema", None)
        return {"kind": "histogram", "name": self.name, **snap}


@dataclass(frozen=True)
class TraceContext:
    """Cross-process trace identity: one ``trace_id`` a run, and the span and
    process a child was spawned from (``QI_TRACE_CONTEXT``)."""

    trace_id: str
    span_id: Optional[int] = None
    pid: Optional[int] = None

    def to_env(self) -> str:
        """``trace_id:span_id:pid`` for ``QI_TRACE_CONTEXT``."""
        return f"{self.trace_id}:{self.span_id or 0}:{self.pid or os.getpid()}"

    @staticmethod
    def from_env(raw: str) -> Optional["TraceContext"]:
        """Parse a :meth:`to_env` string; None when blank.  A garbled tail
        costs the link, never the run."""
        parts = (raw or "").strip().split(":")
        if not parts or not parts[0]:
            return None
        span_id: Optional[int] = None
        pid: Optional[int] = None
        try:
            if len(parts) > 1:
                span_id = int(parts[1]) or None
            if len(parts) > 2:
                pid = int(parts[2]) or None
        except ValueError:
            pass
        return TraceContext(trace_id=parts[0], span_id=span_id, pid=pid)


class Sink(Protocol):
    """What the record needs from a sink: streaming lines and a final flush."""

    def emit(self, line: dict) -> None: ...

    def finish(self, record: "RunRecord") -> None: ...


def _jsonable(value: object) -> object:
    """Attribute values as JSON can carry them (unknown types as text):
    telemetry never costs a solve."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [_jsonable(v) for v in value]
    return str(value)


@dataclass
class Span:
    """One open or finished span; :meth:`set` adds attributes."""

    name: str
    span_id: int
    parent_id: Optional[int]
    start_s: float
    attrs: Dict[str, object] = field(default_factory=dict)
    seconds: Optional[float] = None
    trace_id: str = ""
    tid: int = 0
    pid: int = 0
    # A thread-root span opened under RunRecord.adopted() hangs under another
    # process's span through these; None on every other span.
    remote_parent_span: Optional[int] = None
    remote_parent_pid: Optional[int] = None

    def set(self, **attrs: object) -> "Span":
        self.attrs.update(_jsonable(attrs))  # type: ignore[arg-type]
        return self

    def to_line(self) -> dict:
        line = {
            "kind": "span",
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_s": round(self.start_s, 6),
            "seconds": None if self.seconds is None else round(self.seconds, 6),
            "trace_id": self.trace_id,
            "pid": self.pid,
            "tid": self.tid,
            "attrs": _jsonable(self.attrs),
        }
        if self.remote_parent_span is not None:
            line["remote_parent_span"] = self.remote_parent_span
            line["remote_parent_pid"] = self.remote_parent_pid
        return line


class SnapshotRing:
    """Bounded ring of timestamped metric snapshots (the SLO plane's store).

    :meth:`record` appends ``(t, values)``, a flat name-to-float view of what
    the caller sampled; :meth:`window` answers the samples of the trailing
    ``seconds``, the burn-rate evaluator's only read.  Lock-protected; the
    clock is injectable so tests replay hours in microseconds."""

    def __init__(self, maxlen: int = 4096, clock: Optional[object] = None) -> None:
        self._lock = threading.Lock()
        self._ring: Deque[Tuple[float, Dict[str, float]]] = deque(maxlen=maxlen)
        self._clock = clock if callable(clock) else time.monotonic

    def record(self, values: Dict[str, float], t: Optional[float] = None) -> float:
        """Append one snapshot; returns the timestamp used."""
        now = float(t) if t is not None else float(self._clock())  # type: ignore[operator]
        snap = {str(k): float(v) for k, v in values.items()}
        with self._lock:
            self._ring.append((now, snap))
        return now

    def window(self, seconds: float, now: Optional[float] = None) -> List[Tuple[float, Dict[str, float]]]:
        """Samples within the trailing ``seconds``, oldest first."""
        end = float(now) if now is not None else float(self._clock())  # type: ignore[operator]
        cutoff = end - float(seconds)
        with self._lock:
            return [(t, dict(v)) for t, v in self._ring if t >= cutoff]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# Finish-time line providers: a package module (cost.py's tenant table)
# registers a callable and its lines join the counter and gauge dump; utils/
# never imports the engines.  A provider that raises is skipped.
_FINAL_LINE_PROVIDERS: List[Callable[[], List[dict]]] = []


def register_final_lines(provider: Callable[[], List[dict]]) -> None:
    """Register a finish-time JSONL line provider (idempotent)."""
    if provider not in _FINAL_LINE_PROVIDERS:
        _FINAL_LINE_PROVIDERS.append(provider)


class JsonlSink:
    """Streaming JSONL sink (append mode: processes of one run share a file)."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh: Optional[io.TextIOBase] = None

    def emit(self, line: dict) -> None:
        try:
            with self._lock:
                if self._fh is None:
                    self._fh = open(self.path, "a", buffering=1, encoding="utf-8")
                self._fh.write(json.dumps(line, default=str) + "\n")
        except OSError as exc:  # telemetry never costs the verdict
            log.info("metrics JSONL write failed: %s", exc)

    def finish(self, record: "RunRecord") -> None:
        for line in record.final_lines():
            self.emit(line)
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def _prom_metric(name: str) -> str:
    return "qi_" + "".join(c if c.isalnum() else "_" for c in name)


def prom_lines(record: "RunRecord") -> List[str]:
    """Prometheus text encoding of a record's counters, numeric gauges, span
    rollups and histograms, sorted (an unchanged record encodes to the same
    bytes)."""
    lines: List[str] = []
    counters, gauges = record.snapshot()
    for name, value in sorted(counters.items()):
        m = _prom_metric(name)
        lines += [f"# TYPE {m} counter", f"{m} {value}"]
    for name, value in sorted(gauges.items()):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        m = _prom_metric(name)
        lines += [f"# TYPE {m} gauge", f"{m} {value}"]
    for name, total, count in record.span_rollup():
        m = _prom_metric(f"span_{name}_seconds")
        lines += [f"# TYPE {m} counter", f"{m} {round(total, 6)}",
                  f"# TYPE {m}_count counter", f"{m}_count {count}"]
    for name, snap in sorted(record.histograms_snapshot().items()):
        m = _prom_metric(name)
        lines.append(f"# TYPE {m} histogram")
        cumulative = 0
        for bound, n in zip(snap["bounds"], snap["counts"]):  # type: ignore[arg-type]
            cumulative += int(n)
            lines.append(f'{m}_bucket{{le="{bound:g}"}} {cumulative}')
        lines += [f'{m}_bucket{{le="+Inf"}} {snap["count"]}', f"{m}_sum {snap['sum']}",
                  f"{m}_count {snap['count']}"]
    return lines


class PromFileSink:
    """Prometheus textfile exporter: rewritten atomically at finish."""

    def __init__(self, path: str) -> None:
        self.path = str(path)

    def emit(self, line: dict) -> None:  # a textfile does not stream
        pass

    def finish(self, record: "RunRecord") -> None:
        tmp = f"{self.path}.tmp{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write("\n".join(prom_lines(record)) + "\n")
            os.replace(tmp, self.path)
        except OSError as exc:
            log.info("metrics textfile write failed: %s", exc)


class ChromeTraceSink:
    """Chrome/Perfetto trace-event JSON exporter.

    Spans become complete (``"ph": "X"``) events on their OS thread's track
    (``tid``), so the race's sweep arm shows on its own track; events become
    instant (``"i"``) marks; each process adds a ``process_name`` record.  The
    JSON array is left unterminated (the trace-event format allows it), so
    every event is appended as it happens and a crashed run still leaves a
    loadable trace.  Timestamps are wall-clock microseconds."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh: Optional[io.TextIOBase] = None
        self._pid = os.getpid()
        self._t_wall = time.time()  # refined by the meta line on attach

    def _open(self) -> io.TextIOBase:
        # One process writes the opening "[": O_EXCL creation decides which.
        try:
            fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
            with os.fdopen(fd, "w", encoding="utf-8") as first:
                first.write("[\n")
        except FileExistsError:
            pass
        fh = open(self.path, "a", buffering=1, encoding="utf-8")
        if fh.tell() == 0:
            fh.write("[\n")
        return fh

    def _write(self, obj: dict) -> None:
        try:
            with self._lock:
                if self._fh is None:
                    self._fh = self._open()
                self._fh.write(json.dumps(obj, default=str) + ",\n")
        except OSError as exc:  # telemetry never costs the verdict
            log.info("trace-event write failed: %s", exc)

    def _ts_us(self, rel_s: object) -> float:
        return round((self._t_wall + float(rel_s or 0.0)) * 1e6, 1)

    def emit(self, line: dict) -> None:
        kind = line.get("kind")
        if kind == "meta":
            try:
                self._t_wall = float(line.get("t_wall") or self._t_wall)
            except (TypeError, ValueError):
                pass
            self._write({
                "ph": "M", "name": "process_name", "pid": self._pid, "tid": 0,
                "args": {"name": f"{line.get('argv0') or 'python'} (pid {self._pid}, "
                                 f"trace {line.get('trace_id', '?')})"},
            })
        elif kind == "span" and line.get("seconds") is not None:
            self._write({
                "ph": "X", "cat": "span", "name": line.get("name", "?"),
                "pid": self._pid, "tid": int(line.get("tid") or 0),
                "ts": self._ts_us(line.get("start_s")),
                "dur": max(round(float(line["seconds"]) * 1e6, 1), 1.0),
                "args": line.get("attrs") or {},
            })
        elif kind == "event":
            self._write({
                "ph": "i", "cat": "event", "name": line.get("name", "?"),
                "pid": self._pid, "tid": int(line.get("tid") or 0),
                "ts": self._ts_us(line.get("t_s")), "s": "t",
                "args": line.get("attrs") or {},
            })

    def finish(self, record: "RunRecord") -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


class StderrSummarySink:
    """The ``[telemetry]`` summary on stderr at finish."""

    def emit(self, line: dict) -> None:
        pass

    def finish(self, record: "RunRecord") -> None:
        for line in record.summary_lines():
            sys.stderr.write(line + "\n")


class RunRecord:
    """Process-wide record, safe to use from several threads (the race's
    two arms write into it concurrently); sinks pluggable."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self.t0 = time.monotonic()
        self.t_wall = time.time()
        self.pid = os.getpid()
        self.parent_ctx: Optional[TraceContext] = TraceContext.from_env(qi_env("QI_TRACE_CONTEXT"))
        self.trace_id: str = (self.parent_ctx.trace_id if self.parent_ctx is not None
                              else uuid.uuid4().hex[:16])
        self.spans: List[Span] = []
        self.events: List[dict] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, object] = {}
        self._histograms: Dict[str, Histogram] = {}
        self.dropped = 0
        self.events_dropped = 0
        self._next_id = 0
        self._sinks: List[Sink] = []
        self._finished = False
        # The flight recorder's ring, under its own lock (never nested with
        # self._lock: the emit path takes them in sequence).
        self._flight_lock = threading.Lock()
        self._flight: Deque[dict] = deque(maxlen=FLIGHT_RECORDER_N)

    @contextmanager
    def adopted(self, ctx: Optional[TraceContext]) -> Iterator[None]:
        """Per-request trace adoption: while active on this thread, spans and
        events carry ``ctx.trace_id``, and a thread-root span records
        ``ctx.span_id``/``ctx.pid`` as its remote parent.  ``None`` (or a
        blank trace) is a no-op."""
        if ctx is None or not ctx.trace_id:
            yield
            return
        prev = getattr(self._local, "adopt", None)
        prev_first = getattr(self._local, "adopt_first", False)
        self._local.adopt = ctx
        self._local.adopt_first = True
        try:
            yield
        finally:
            self._local.adopt = prev
            self._local.adopt_first = prev_first

    def snapshot(self) -> Tuple[Dict[str, float], Dict[str, object]]:
        """Consistent copies of (counters, gauges)."""
        with self._lock:
            return dict(self.counters), dict(self.gauges)

    def histogram(self, name: str, bounds: Optional[Sequence[float]] = None) -> Histogram:
        """Get or create the named histogram."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, bounds)
        return h

    def histograms_snapshot(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            hists = dict(self._histograms)
        return {name: h.snapshot() for name, h in hists.items()}

    def flight_tail(self) -> List[dict]:
        """Copy of the flight-recorder ring, oldest first."""
        with self._flight_lock:
            return list(self._flight)

    def event_count(self) -> int:
        """The anchor for :meth:`events_since`."""
        with self._lock:
            return len(self.events)

    def events_since(self, n: int) -> List[dict]:
        """Copies of the events recorded after position ``n``."""
        with self._lock:
            return [dict(ev) for ev in self.events[n:]]

    def events_truncated(self) -> bool:
        """Whether an event was dropped past :data:`MAX_EVENTS`: once true,
        a short :meth:`events_since` slice no longer means a quiet solve."""
        with self._lock:
            return self.events_dropped > 0

    # ---- sinks -----------------------------------------------------------

    def add_sink(self, sink: Sink) -> None:
        """Attach a sink; it opens with its own meta line."""
        with self._lock:
            self._sinks.append(sink)
        meta = {
            "kind": "meta",
            "schema": SCHEMA,
            "pid": self.pid,
            "argv0": os.path.basename(sys.argv[0]) if sys.argv else "",
            "t_wall": round(self.t_wall, 3),
            "trace_id": self.trace_id,
        }
        if self.parent_ctx is not None:
            meta["parent_span"] = self.parent_ctx.span_id
            meta["parent_pid"] = self.parent_ctx.pid
        try:
            sink.emit(meta)
        except Exception as exc:  # noqa: BLE001 — never cost the verdict
            log.info("telemetry sink failed: %s", exc)

    def _emit(self, line: dict) -> None:
        with self._flight_lock:
            self._flight.append(line)
        for sink in list(self._sinks):
            try:
                sink.emit(line)
            except Exception as exc:  # noqa: BLE001 — never cost the verdict
                log.info("telemetry sink failed: %s", exc)

    # ---- spans -----------------------------------------------------------

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @property
    def current_span_id(self) -> Optional[int]:
        stack = self._stack()
        return stack[-1] if stack else None

    @contextmanager
    def span(self, name: str, parent_id: Optional[int] = None, **attrs: object) -> Iterator[Span]:
        """Open a nested span.  Nesting is per thread: a worker thread's
        spans are roots unless ``parent_id`` names one across threads."""
        stack = self._stack()
        with self._lock:
            self._next_id += 1
            sid = self._next_id
        adopt: Optional[TraceContext] = getattr(self._local, "adopt", None)
        local_parent = parent_id if parent_id is not None else (stack[-1] if stack else None)
        # An adopted thread root, and the first span of an adoption even under
        # a local parent, hangs under the remote request span.
        graft = adopt is not None and (local_parent is None or getattr(self._local, "adopt_first", False))
        if adopt is not None:
            self._local.adopt_first = False
        sp = Span(
            name=name,
            span_id=sid,
            parent_id=local_parent,
            start_s=time.monotonic() - self.t0,
            attrs=_jsonable(attrs),  # type: ignore[arg-type]
            trace_id=adopt.trace_id if adopt is not None else self.trace_id,
            tid=threading.get_native_id(),
            pid=self.pid,
            remote_parent_span=adopt.span_id if graft else None,
            remote_parent_pid=adopt.pid if graft else None,
        )
        stack.append(sid)
        try:
            yield sp
        finally:
            stack.pop()
            sp.seconds = (time.monotonic() - self.t0) - sp.start_s
            with self._lock:
                if len(self.spans) < MAX_SPANS:
                    self.spans.append(sp)
                else:
                    self.dropped += 1
            self._emit(sp.to_line())

    # ---- events, counters, gauges ---------------------------------------

    def event(self, name: str, **attrs: object) -> None:
        adopt: Optional[TraceContext] = getattr(self._local, "adopt", None)
        ev = {
            "kind": "event",
            "name": name,
            "t_s": round(time.monotonic() - self.t0, 6),
            "span_id": self.current_span_id,
            "trace_id": adopt.trace_id if adopt is not None else self.trace_id,
            "pid": self.pid,
            "tid": threading.get_native_id(),
            "attrs": _jsonable(attrs),
        }
        with self._lock:
            if len(self.events) < MAX_EVENTS:
                self.events.append(ev)
            else:
                self.dropped += 1
                self.events_dropped += 1
        self._emit(ev)

    def declare(self, name: str) -> None:
        """Ensure a counter exists (zero), so it is emitted untouched."""
        with self._lock:
            self.counters.setdefault(name, 0)

    def add(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: object) -> None:
        with self._lock:
            self.gauges[name] = value

    # ---- rollups, finish -------------------------------------------------

    def span_rollup(self) -> List[Tuple[str, float, int]]:
        """``[(name, total_seconds, count), ...]`` by total, largest first."""
        with self._lock:
            totals: Dict[str, List[float]] = {}
            for sp in self.spans:
                if sp.seconds is None:
                    continue
                cur = totals.setdefault(sp.name, [0.0, 0])
                cur[0] += sp.seconds
                cur[1] += 1
        return sorted(((name, t, int(c)) for name, (t, c) in totals.items()), key=lambda row: -row[1])

    def final_lines(self) -> List[dict]:
        """Counter, gauge and histogram lines, emitted once at finish."""
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            hists = dict(self._histograms)
            dropped = self.dropped
        lines = [{"kind": "counter", "name": name, "value": value} for name, value in sorted(counters.items())]
        lines += [{"kind": "gauge", "name": name, "value": _jsonable(value)} for name, value in sorted(gauges.items())]
        for name in sorted(hists):
            hist_line = hists[name].to_line()
            if hist_line["count"]:  # untouched histograms stay silent
                lines.append(hist_line)
        if dropped:
            lines.append({"kind": "counter", "name": "telemetry.dropped", "value": dropped})
        for provider in list(_FINAL_LINE_PROVIDERS):
            try:
                lines.extend(provider())
            except Exception as exc:  # noqa: BLE001 - never cost the dump
                log.info("final-line provider failed: %s", exc)
        return lines

    def summary_lines(self) -> List[str]:
        """The human summary: span rollup, counters, gauges."""
        out = []
        for name, total, count in self.span_rollup():
            suffix = f" (x{count})" if count > 1 else ""
            out.append(f"[telemetry] span {name}: {total * 1000:.2f} ms{suffix}")
        counters, gauges = self.snapshot()
        out += [f"[telemetry] counter {name}: {value}" for name, value in sorted(counters.items())]
        out += [f"[telemetry] gauge {name}: {value}" for name, value in sorted(gauges.items())]
        return out

    def finish(self) -> None:
        """Flush counters and gauges and close the sinks (idempotent)."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink.finish(self)
            except Exception as exc:  # noqa: BLE001
                log.info("telemetry sink finish failed: %s", exc)


# ---- the process-wide record -----------------------------------------------

_global: Optional[RunRecord] = None
_global_lock = threading.Lock()


def _attach_env_sinks(record: RunRecord) -> None:
    """``QI_METRICS_JSON``, ``QI_METRICS_PROM`` and ``QI_TRACE_OUT``: every
    process of a run appends to the same files without any flag."""
    jsonl = qi_env("QI_METRICS_JSON")
    if jsonl:
        record.add_sink(JsonlSink(jsonl))
    prom = qi_env("QI_METRICS_PROM")
    if prom:
        record.add_sink(PromFileSink(prom))
    trace = qi_env("QI_TRACE_OUT")
    if trace:
        record.add_sink(ChromeTraceSink(trace))


_crash_hook_installed = False


def _install_crash_hook() -> None:
    """With ``QI_FLIGHT_RECORDER`` set, chain ``sys.excepthook`` so an
    unhandled exception dumps the flight recorder before the traceback."""
    global _crash_hook_installed
    if _crash_hook_installed or not qi_env("QI_FLIGHT_RECORDER"):
        return
    _crash_hook_installed = True
    prev = sys.excepthook

    def hook(exc_type, exc, tb):
        dump_flight_recorder(f"unhandled:{exc_type.__name__}")
        prev(exc_type, exc, tb)

    sys.excepthook = hook


def _maybe_start_metrics_server() -> None:
    """Start the live /healthz and /metrics endpoint when QI_METRICS_PORT > 0
    (best effort: a taken port logs and moves on)."""
    if qi_env("QI_METRICS_PORT") in ("", "0"):
        return
    try:
        from quorum_intersection_tpu_torch.utils.metrics_server import maybe_start_from_env

        maybe_start_from_env()
    except Exception as exc:  # noqa: BLE001 - observability never costs the verdict
        log.info("metrics server unavailable: %s", exc)


def get_run_record() -> RunRecord:
    """The process-wide record, created at first use with the env sinks
    attached and flushed at interpreter exit."""
    global _global
    if _global is None:
        with _global_lock:
            if _global is None:
                record = RunRecord()
                _attach_env_sinks(record)
                atexit.register(record.finish)
                _global = record
        _install_crash_hook()
        _maybe_start_metrics_server()
    return _global


def reset_run_record() -> RunRecord:
    """Replace the process-wide record with a fresh one (tests); the old
    one is finished first so its sinks flush."""
    global _global
    with _global_lock:
        old, _global = _global, None
    if old is not None:
        old.finish()
    return get_run_record()


# ---- crash flight recorder --------------------------------------------------

_dump_state = threading.local()


def _write_crash_only(target: str, payload: dict, rec: RunRecord) -> bool:
    """One crash-only dump write (tmp, flush, fsync, rename, best-effort
    directory fsync) behind the ``telemetry.dump`` fault point; any failure
    becomes the ``telemetry.dump_errors`` counter and False."""
    try:
        from quorum_intersection_tpu_torch.utils.faults import fault_point

        fault_point("telemetry.dump")
        tmp = f"{target}.tmp{rec.pid}"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(json.dumps(payload, default=str))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, target)
        try:
            dir_fd = os.open(os.path.dirname(os.path.abspath(target)), os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
        except OSError:
            pass  # directory fsync is best-effort
    except Exception as exc:  # noqa: BLE001 — a crash dump is never the crash
        rec.add("telemetry.dump_errors")
        log.warning("crash-only dump failed (%s); run continues", exc)
        return False
    return True


def dump_exemplar(payload: dict, path: Optional[str] = None) -> Optional[str]:
    """Dump one slow-request exemplar (``qi-exemplar/1``): the caller's
    payload with the flight recorder's tail, to ``path`` or
    ``<QI_FLIGHT_RECORDER>.exemplar``; with neither, only the
    ``pulse.exemplar`` event and ``pulse.exemplars`` counter fire.  Returns
    the path written, or None."""
    rec = get_run_record()
    rec.add("pulse.exemplars")
    rec.event("pulse.exemplar", request_id=payload.get("request_id"), e2e_ms=payload.get("e2e_ms"),
              trace_id=payload.get("trace_id"))
    flight = qi_env("QI_FLIGHT_RECORDER")
    target = path or (f"{flight}.exemplar" if flight else "")
    if not target or getattr(_dump_state, "active", False):
        return None
    _dump_state.active = True
    try:
        full = {"schema": EXEMPLAR_SCHEMA, "pid": rec.pid, "t_wall": round(time.time(), 3), **payload,
                "tail": rec.flight_tail()}
        if not _write_crash_only(target, full, rec):
            return None
        rec.add("telemetry.dumps")
        return str(target)
    finally:
        _dump_state.active = False


def dump_flight_recorder(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Dump the flight recorder crash-only: the last span and event lines and
    a counter/gauge snapshot.  No-op unless ``path`` or ``QI_FLIGHT_RECORDER``
    names a destination; a trigger firing inside a dump does not recurse.
    Returns the path written, or None."""
    target = path or qi_env("QI_FLIGHT_RECORDER")
    if not target or getattr(_dump_state, "active", False):
        return None
    _dump_state.active = True
    try:
        rec = get_run_record()
        counters, gauges = rec.snapshot()
        payload = {
            "schema": FLIGHT_SCHEMA,
            "reason": reason,
            "pid": rec.pid,
            "trace_id": rec.trace_id,
            "t_wall": round(time.time(), 3),
            "t_s": round(time.monotonic() - rec.t0, 6),
            "counters": counters,
            "gauges": _jsonable(gauges),
            "tail": rec.flight_tail(),
        }
        if not _write_crash_only(str(target), payload, rec):
            return None
        rec.add("telemetry.dumps")
        rec.event("telemetry.dumped", path=str(target), reason=reason)
        return str(target)
    finally:
        _dump_state.active = False
