"""Live observability endpoint: ``/healthz``, ``/readyz``, ``/sloz`` and
``/metrics`` over the standard library's HTTP server.

The port of the JAX package's ``utils/metrics_server.py``, started by any run
that sets ``QI_METRICS_PORT`` (``utils/env.py``):

- ``GET /healthz``: JSON (``qi-health/1``), the degradation picture (ladder
  rung, quarantined rungs, lane packs in flight, degrade and fault counters,
  reuse, SLO burn), read from the run record's counters and gauges only;
- ``GET /readyz``: JSON (``qi-ready/1``), the serving layer's admission
  picture, **503** while a restarted server still replays its predecessor's
  journal, 200 once replay completes or when no serving engine runs here;
- ``GET /sloz``: one lazy SLO evaluation and the costliest tenants
  (``qi-slo/1``, ``cost.sloz_payload``);
- ``GET /metrics``: the Prometheus text encoding of the same record, from the
  encoder the textfile sink uses (:func:`utils.telemetry.prom_lines`).

Every body renders deterministically (sorted keys), bound to 127.0.0.1 and
served from a daemon thread: observability never holds a verdict process
alive or opens the solve to the network.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from quorum_intersection_tpu_torch.utils.env import qi_env_int
from quorum_intersection_tpu_torch.utils.logging import get_logger
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record, prom_lines

log = get_logger("utils.metrics_server")

HEALTH_SCHEMA = "qi-health/1"
READY_SCHEMA = "qi-ready/1"


def healthz_payload() -> dict:
    """The /healthz body: run identity + the degradation picture.

    Sourced purely from the run record's counters/gauges snapshot (the
    ladder and the packed sweep keep ``ladder.rung`` /
    ``ladder.quarantined_rungs`` / ``sweep.packs_in_flight`` current), so
    the endpoint stays byte-stable between state changes and has no lock
    interaction with the engines.
    """
    # A scrape is one of the SLO plane's lazy evaluation triggers: evaluate
    # first so the snapshot below reads a fresh slo.burning gauge.  Imported
    # here: utils/ imports no package-level engine at import time.
    from quorum_intersection_tpu_torch.cost import slo_plane
    slo = slo_plane()
    if slo.enabled:
        slo.evaluate()
    rec = get_run_record()
    counters, gauges = rec.snapshot()
    return {
        "schema": HEALTH_SCHEMA,
        "status": "ok",
        "pid": rec.pid,
        "trace_id": rec.trace_id,
        "started_t_wall": round(rec.t_wall, 3),
        "ladder_rung": gauges.get("ladder.rung"),
        "quarantined_rungs": gauges.get("ladder.quarantined_rungs", []),
        "packs_in_flight": gauges.get("sweep.packs_in_flight", 0),
        "degrades": counters.get("ladder.degrades", 0),
        "retries": counters.get("ladder.retries", 0),
        "faults_injected": counters.get("faults.injected", 0),
        "flight_dumps": counters.get("telemetry.dumps", 0),
        # Per-SCC reuse and store occupancy of incremental re-analysis.
        "delta_scc_reuse_pct": gauges.get("delta.scc_reuse_pct", 0.0),
        "delta_store_size": gauges.get("delta.store_size", 0),
        # The fleet front door's picture: workers on the ring against
        # workers answering probes, the shared fragment tier's hit rate and
        # the fleet-wide p99 over the merged worker histograms (0 on any
        # process that is not a front door).
        "fleet_workers_live": gauges.get("fleet.workers_live", 0),
        "fleet_ring_size": gauges.get("fleet.ring_size", 0),
        "fleet_store_hit_pct": gauges.get("fleet.store_hit_pct", 0.0),
        "fleet_e2e_p99_ms": gauges.get("fleet.e2e_p99_ms", 0.0),
        # The SLO burn picture and the attribution health counter (/sloz
        # has the per-target ratios and the tenant table).
        "slo_burning": gauges.get("slo.burning", 0),
        "cost_attribute_errors": counters.get("cost.attribute_errors", 0),
    }


def sloz_payload() -> dict:
    """The /sloz body (``qi-slo/1``): one lazy SLO evaluation (per-target
    bounds, values, fast/slow burn ratios, burning flags) plus the
    costliest tenants — the local table and the fleet-merged one."""
    from quorum_intersection_tpu_torch.cost import sloz_payload as _sloz
    return _sloz()


def readyz_payload() -> tuple:
    """The /readyz body + status code: ``(payload, http_status)``.

    Readiness is the SERVING-layer question (liveness stays /healthz):
    sourced from the ``serve.*`` gauges ``ServeEngine`` keeps current.
    Not ready (503) exactly while a journal replay is in progress —
    ``serve.replay_complete`` was published as 0 at engine start and
    flips to 1 once the crashed predecessor's work is re-solved.  A
    process with no serving engine publishes neither gauge and reports
    ready: for the one-shot CLI, alive == ready.
    """
    rec = get_run_record()
    counters, gauges = rec.snapshot()
    replay = gauges.get("serve.replay_complete")
    replaying = replay is not None and not replay
    # The fleet front door is not ready until every live worker finished its
    # journal replay and every inherited request re-solved
    # (fleet.replay_complete, set only by the front door).
    fleet_replay = gauges.get("fleet.replay_complete")
    fleet_replaying = fleet_replay is not None and not fleet_replay
    not_ready = replaying or fleet_replaying
    payload = {
        "schema": READY_SCHEMA,
        "status": "replaying" if not_ready else "ready",
        "pid": rec.pid,
        "trace_id": rec.trace_id,
        "serving": "serve.queue_depth" in gauges,
        "replay_complete": None if replay is None else bool(replay),
        "fleet_replay_complete": (
            None if fleet_replay is None else bool(fleet_replay)
        ),
        "fleet_workers_live": gauges.get("fleet.workers_live", 0),
        "queue_depth": gauges.get("serve.queue_depth", 0),
        "shed_state": gauges.get("serve.shed_state", 0),
        "shed_total": counters.get("serve.shed", 0),
        "requests": counters.get("serve.requests", 0),
        "verdicts": counters.get("serve.verdicts", 0),
    }
    return payload, (503 if not_ready else 200)


class _Handler(BaseHTTPRequestHandler):
    """Request handler for the two read-only endpoints."""

    server_version = "qi-metrics/1"

    def _respond(self, code: int, content_type: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — http.server's required name
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = ("\n".join(prom_lines(get_run_record())) + "\n").encode()
            self._respond(200, "text/plain; version=0.0.4", body)
        elif path == "/healthz":
            body = (
                json.dumps(healthz_payload(), sort_keys=True) + "\n"
            ).encode()
            self._respond(200, "application/json", body)
        elif path == "/readyz":
            payload, status = readyz_payload()
            body = (json.dumps(payload, sort_keys=True) + "\n").encode()
            self._respond(status, "application/json", body)
        elif path == "/sloz":
            body = (
                json.dumps(sloz_payload(), sort_keys=True) + "\n"
            ).encode()
            self._respond(200, "application/json", body)
        else:
            self._respond(404, "text/plain", b"not found\n")

    def log_message(self, format: str, *args: object) -> None:
        # Route scrape access logs to the qi logger at debug, never stderr —
        # a scraper must not interleave noise into --timing output.
        log.debug("metrics scrape: " + format, *args)


class MetricsServer:
    """One live endpoint server, bound to 127.0.0.1.

    ``port=0`` binds an ephemeral port (tests); read it back via ``.port``.
    The serving thread is a daemon — interpreter exit never waits on a
    scraper — and :meth:`stop` shuts it down deterministically.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1") -> None:
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="qi-metrics-server",
            daemon=True,
        )
        self._thread.start()
        log.info("metrics endpoint serving on http://%s:%d "
                 "(/healthz, /readyz, /sloz, /metrics)", host, self.port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


_server: Optional[MetricsServer] = None
_server_lock = threading.Lock()


def maybe_start_from_env() -> Optional[MetricsServer]:
    """Start the process-wide server once when ``QI_METRICS_PORT`` > 0.

    Best-effort by contract: a port already taken (a bench child inheriting
    the parent's env) logs and returns None — a scrape endpoint is never
    worth a verdict.
    """
    global _server
    with _server_lock:
        if _server is not None:
            return _server
        port = qi_env_int("QI_METRICS_PORT", 0)
        if port <= 0:
            return None
        try:
            _server = MetricsServer(port=port)
        except OSError as exc:
            log.info("metrics endpoint not started on port %d: %s", port, exc)
            return None
        return _server


def stop_server() -> None:
    """Stop the env-started server if one is running (tests)."""
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None
