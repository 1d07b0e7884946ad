"""qi-serve transports: the stdio loop and the socket server.

The port of the JAX package's ``serve_transport.py``.  The engine
(:class:`~quorum_intersection_tpu_torch.serve.ServeEngine`) stays
transport-agnostic (submit, Ticket, callback); everything that turns bytes
into requests and outcomes into bytes lives here:

- **stdio** (:func:`serve_main`): one JSON request a stdin line, one JSON
  response a stdout line in completion order, EOF drains and exits 0;
- **sockets** (:class:`SocketServeServer`): the same JSONL conversation over
  TCP (127.0.0.1 by default), many connections sharing one engine, each with
  its own :class:`JsonlSession` so responses never interleave.

Protocol (one JSON value a line, ``qi-serve/1``):

- request: a raw stellarbeat node array, or ``{"request_id", "nodes"}`` with
  optional ``"deadline_s"``, ``"query"``, ``"trace"`` and ``"client"``;
- response: ``{"request_id", "verdict", "cached", "seconds"}`` (plus
  ``"cost"``, and ``"cert"``/``"stats"`` under ``--emit-certs``) or
  ``{"request_id", "error": {"code", "message"}}``;
- probe: ``{"ping": token}`` answers ``{"pong": token, ...}`` with readiness
  and a counter, gauge and histogram snapshot (:func:`pong_payload`);
- mesh: a fleet front door joining this server over TCP sends ``{"hello":
  ...}`` (protocol, :func:`package_fingerprint`, :func:`fleet_token_digest`)
  and gets ``hello_ok`` or a typed ``hello_err``; ``{"ship_journal": ...}``
  streams this server's journal back in ``ship_chunk`` lines and a
  ``ship_end`` digest (or a typed ``ship_err``), and ``ship_ack`` confirms
  the receiver fsynced it.  The wire is the JAX package's byte for byte, so
  either package's front door joins either package's server.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import hmac
import json
import os
import socketserver
import sys
import threading
from typing import Dict, Iterator, List, Optional, TextIO

from quorum_intersection_tpu_torch.cost import tenant_table
from quorum_intersection_tpu_torch.serve import (
    ServeEngine,
    ServeError,
    ServeResponse,
    Ticket,
)
from quorum_intersection_tpu_torch.utils.env import qi_env
from quorum_intersection_tpu_torch.utils.faults import FaultInjected
from quorum_intersection_tpu_torch.utils.logging import get_logger
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record

log = get_logger("serve.transport")

PROTOCOL_SCHEMA = "qi-serve/1"

# The versioned join handshake a fleet front door performs before a socket
# worker enters its ring.  Bump on any wire-incompatible change: a mismatch
# is a typed reject (hello_err), never a silently skewed mesh.
MESH_PROTOCOL = 1

# Journal-ship framing: chunk payload size before base64.  Each chunk line
# carries its own byte length and the end line the stream digest; the
# receiver fsyncs before it acknowledges, so an acknowledged ship is durable.
SHIP_CHUNK_BYTES = 64 * 1024


def package_fingerprint() -> str:
    """The wire-compatibility fingerprint the join handshake compares: the
    package version and every schema string a mesh peer must agree on.  The
    port's version is the JAX package's, so the two fingerprints are equal
    and either package's peers mesh."""
    from quorum_intersection_tpu_torch import __version__

    basis = "|".join((str(__version__), PROTOCOL_SCHEMA, f"mesh/{MESH_PROTOCOL}"))
    return hashlib.sha256(basis.encode("utf-8")).hexdigest()[:16]


def fleet_token_digest() -> str:
    """SHA-256 digest of the shared mesh secret (``QI_FLEET_TOKEN``); the
    wire never carries the raw token.  Empty token: empty digest
    (unauthenticated loopback mode, and both sides must agree on it)."""
    token = qi_env("QI_FLEET_TOKEN")
    if not token:
        return ""
    return hashlib.sha256(token.encode("utf-8")).hexdigest()

# The counter/gauge slice one pong carries (the JAX package's set, so a
# fleet front door reads either package's pong alike).
PONG_COUNTERS = (
    "serve.requests",
    "serve.verdicts",
    "serve.errors",
    "serve.cache_hits",
    "fleet.store_hits",
    "fleet.store_misses",
    "fleet.store_errors",
    "delta.scc_hits",
    "delta.scc_misses",
)
PONG_GAUGES = (
    "serve.queue_depth",
    "delta.scc_reuse_pct",
    "delta.store_size",
)

# The pulse histograms one pong ships: this server's own per-stage latency
# distributions (the serve-side stage set only).
PONG_PULSE = (
    "pulse.queue_wait_ms",
    "pulse.cache_ms",
    "pulse.delta_ms",
    "pulse.solve_ms",
    "pulse.respond_ms",
    "pulse.e2e_ms",
)


def pong_payload(token: object) -> Dict[str, object]:
    """The ``{"ping": token}`` reply: readiness + a health snapshot +
    the worker's pulse histogram snapshots (the aggregation plane's
    transport — piggybacked here instead of N scrape ports)."""
    rec = get_run_record()
    counters, gauges = rec.snapshot()
    hists = rec.histograms_snapshot()
    replay = gauges.get("serve.replay_complete")
    payload = {
        "pong": token,
        "schema": PROTOCOL_SCHEMA,
        "pid": os.getpid(),
        "ready": bool(replay) if replay is not None else True,
        "counters": {k: counters.get(k, 0) for k in PONG_COUNTERS},
        "gauges": {k: gauges.get(k, 0) for k in PONG_GAUGES},
        "pulse": {k: hists[k] for k in PONG_PULSE if k in hists},
    }
    # The cumulative per-tenant cost table rides the pong like the pulse
    # histograms (the local table only).
    tenants = tenant_table().snapshot()
    if tenants:
        payload["cost"] = tenants
    return payload


def ticket_response(
    ticket: Ticket, *, emit_certs: bool = False
) -> Dict[str, object]:
    """One RESOLVED ticket → its JSONL response object (the single place
    the outcome→wire shape lives; both loop transports share it)."""
    try:
        resp: ServeResponse = ticket.result(timeout=0)
    except ServeError as exc:
        return {"request_id": ticket.request_id,
                "error": {"code": exc.code, "message": str(exc)}}
    except Exception as exc:  # noqa: BLE001 — an untyped failure still gets a response line
        # Typed non-serve failures (the query layer's QueryError rides
        # here) keep their machine-readable code; anything else is
        # "internal" — still a response line, never a silent drop.
        return {"request_id": ticket.request_id,
                "error": {"code": str(getattr(exc, "code", "internal")),
                          "message": str(exc)}}
    line: Dict[str, object] = {
        "request_id": resp.request_id,
        "verdict": resp.intersects,
        "cached": resp.cached,
        "seconds": round(resp.seconds, 6),
    }
    if resp.trace is not None:
        # Wire trace echo (qi-pulse): the request's carried context rides
        # the response so the fleet front door (and any client) can join
        # the verdict to its distributed trace.
        line["trace"] = resp.trace
    if resp.result is not None:
        # Typed-query payload (qi-query/1): verdict stays the boolean
        # summary, the structured table/witness/report rides alongside.
        line["result"] = resp.result
    if resp.cost is not None:
        # qi-cost/1: what this verdict cost on the device; absent on cache
        # hits, degraded attribution and cost-less backends.
        line["cost"] = resp.cost
    if emit_certs:
        line["cert"] = resp.cert
        line["stats"] = resp.stats
    return line


class JsonlSession:
    """One JSONL conversation against one engine.

    Owns the write lock (responses from concurrent ticket callbacks never
    interleave bytes) and the outstanding-ticket count, so a transport can
    drain a single connection without stopping the shared engine.
    """

    def __init__(self, engine: ServeEngine, writer: TextIO,
                 *, emit_certs: bool = False) -> None:
        self._engine = engine
        self._writer = writer
        self._emit_certs = emit_certs
        self._lock = threading.Lock()
        self._outstanding = 0
        self._drained = threading.Condition(self._lock)

    def emit(self, obj: Dict[str, object]) -> None:
        """Write one response line; a vanished client (closed socket) is
        logged and dropped — its verdict is already cached and journaled,
        so a reconnect-and-retry is a cache hit, never lost work."""
        try:
            with self._lock:
                self._writer.write(json.dumps(obj, default=str) + "\n")
                self._writer.flush()
        except (OSError, ValueError) as exc:
            log.warning("response write failed (client gone?): %s", exc)

    def _on_done(self, ticket: Ticket) -> None:
        self.emit(ticket_response(ticket, emit_certs=self._emit_certs))
        with self._drained:
            self._outstanding -= 1
            self._drained.notify_all()

    # ---- the mesh handshake and journal shipping -------------------------

    def _handle_hello(self, hello: object) -> None:
        """The versioned join handshake: protocol, package fingerprint and
        shared-secret digest must all match, or the peer gets a typed
        ``hello_err``.  A valid hello may announce the front door's store
        gateway; the engine then reads through to it on every fragment miss
        and publishes every banked fragment back."""
        rec = get_run_record()
        hello = hello if isinstance(hello, dict) else {}

        def _reject(code: str, message: str) -> None:
            rec.add("serve.hello_rejects")
            rec.event("serve.hello_rejected", code=code)
            log.warning("mesh hello rejected (%s): %s", code, message)
            self.emit({"hello_err": {"code": code, "message": message}})

        schema = hello.get("schema")
        protocol = hello.get("protocol")
        if schema != PROTOCOL_SCHEMA or protocol != MESH_PROTOCOL:
            _reject("protocol_mismatch",
                    f"peer speaks {schema!r}/mesh-{protocol!r}, this worker "
                    f"speaks {PROTOCOL_SCHEMA!r}/mesh-{MESH_PROTOCOL}")
            return
        fingerprint = hello.get("fingerprint")
        if fingerprint != package_fingerprint():
            _reject("fingerprint_mismatch",
                    f"peer package fingerprint {fingerprint!r} != "
                    f"{package_fingerprint()!r} — upgrade one side; a skewed "
                    f"mesh is refused, not guessed at")
            return
        if not hmac.compare_digest(str(hello.get("token") or ""), fleet_token_digest()):
            _reject("bad_token", "QI_FLEET_TOKEN digest mismatch")
            return
        store = hello.get("store")
        if isinstance(store, dict):
            from quorum_intersection_tpu_torch.delta import RemoteStoreClient

            client = RemoteStoreClient(str(store.get("host") or "127.0.0.1"), int(store.get("port") or 0))
            self._engine.attach_remote_store(client)
        rec.event("serve.hello_ok", peer=str(hello.get("peer") or ""))
        _, gauges = rec.snapshot()
        replay = gauges.get("serve.replay_complete")
        self.emit({"hello_ok": {
            "schema": PROTOCOL_SCHEMA,
            "protocol": MESH_PROTOCOL,
            "fingerprint": package_fingerprint(),
            "pid": os.getpid(),
            "ready": bool(replay) if replay is not None else True,
            "replay": self._engine.replay_report,
        }})

    def _handle_ship(self, ship: object) -> None:
        """Stream this server's crash-only journal to the requesting peer:
        ``ship_chunk`` lines each with their byte length, then a ``ship_end``
        line with the stream digest, so the receiver can fsync and then
        acknowledge, and a torn stream is detected, never replayed."""
        rec = get_run_record()
        ship = ship if isinstance(ship, dict) else {}
        if not hmac.compare_digest(str(ship.get("token") or ""), fleet_token_digest()):
            rec.add("serve.hello_rejects")
            rec.event("serve.hello_rejected", code="bad_token")
            self.emit({"ship_err": {"code": "bad_token", "message": "QI_FLEET_TOKEN digest mismatch"}})
            return
        path = self._engine.journal_path
        if path is None:
            self.emit({"ship_err": {"code": "no_journal",
                                    "message": "this worker runs without a request journal"}})
            return
        try:
            raw = path.read_bytes()
        except OSError as exc:
            self.emit({"ship_err": {"code": "journal_unreadable", "message": str(exc)}})
            return
        chunks = 0
        for off in range(0, len(raw), SHIP_CHUNK_BYTES):
            piece = raw[off:off + SHIP_CHUNK_BYTES]
            self.emit({"ship_chunk": {"seq": chunks, "len": len(piece),
                                      "data": base64.b64encode(piece).decode("ascii")}})
            chunks += 1
        self.emit({"ship_end": {"chunks": chunks, "bytes": len(raw), "sha256": hashlib.sha256(raw).hexdigest()}})
        rec.add("serve.journal_ships")
        rec.event("serve.journal_shipped", chunks=chunks, bytes=len(raw))

    def handle_line(self, n: int, line: str) -> None:
        """One request line → submit (or ping/typed rejection), non-blocking."""
        line = line.strip()
        if not line:
            return
        request_id: Optional[str] = None
        try:
            obj = json.loads(line)
            if isinstance(obj, dict) and "ping" in obj:
                self.emit(pong_payload(obj["ping"]))
                return
            if isinstance(obj, dict) and "hello" in obj:
                self._handle_hello(obj["hello"])
                return
            if isinstance(obj, dict) and "ship_journal" in obj:
                self._handle_ship(obj["ship_journal"])
                return
            if isinstance(obj, dict) and "ship_ack" in obj:
                # The receiving peer fsynced the shipped journal: the hand-off
                # is durable on the inheriting side.
                get_run_record().event("serve.ship_acked")
                return
            nodes = obj
            deadline_s: Optional[float] = None
            query: Optional[object] = None
            trace: Optional[str] = None
            if isinstance(obj, dict):
                request_id = obj.get("request_id")
                nodes = obj.get("nodes")
                raw_deadline = obj.get("deadline_s")
                if raw_deadline is not None:
                    deadline_s = float(raw_deadline)
                # qi-query/1: absent means intersection.
                query = obj.get("query")
                # Optional wire trace context "trace_id:span_id[:pid]";
                # absent means the engine's own trace.
                raw_trace = obj.get("trace")
                trace = raw_trace if isinstance(raw_trace, str) else None
                # Optional client id: the tenant this request's device
                # cost books to ("anon" when absent).
                raw_client = obj.get("client")
                client = raw_client if isinstance(raw_client, str) else None
            else:
                client = None
            if not isinstance(nodes, list):
                raise ValueError("expected a node array or "
                                 '{"request_id", "nodes"}')
            ticket = self._engine.submit(
                nodes, request_id=request_id, deadline_s=deadline_s,
                query=query, trace=trace, client=client,
            )
        except ServeError as exc:
            self.emit({"request_id": request_id or f"line-{n + 1}",
                       "error": {"code": exc.code, "message": str(exc)}})
            return
        except (ValueError, TypeError, FaultInjected) as exc:
            # A typed QueryError keeps its own code (unknown_query /
            # invalid_query / ...); other parse failures stay "invalid".
            self.emit({"request_id": request_id or f"line-{n + 1}",
                       "error": {"code": str(getattr(exc, "code", "invalid")),
                                 "message": str(exc)}})
            return
        with self._drained:
            self._outstanding += 1
        ticket.add_done_callback(self._on_done)

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted ticket of THIS session delivered."""
        with self._drained:
            return self._drained.wait_for(
                lambda: self._outstanding == 0, timeout=timeout,
            )


def run_jsonl_loop(session: JsonlSession, reader: TextIO) -> None:
    """Feed ``reader``'s lines through ``session`` until EOF (the caller
    decides whether EOF drains the engine or just this conversation) —
    the one request loop shared by the stdio CLI, the socket handler and
    the fleet CLI."""
    for n, line in enumerate(reader):
        session.handle_line(n, line)


class SocketServeServer:
    """JSONL-over-TCP twin of the stdio loop: one shared engine, many
    concurrent connections (one :class:`JsonlSession` each).  Binds
    ``QI_SERVE_BIND`` (default loopback, like the metrics endpoint).
    ``port=0`` binds ephemeral; read ``.port``.
    """

    def __init__(self, engine: ServeEngine, *, host: Optional[str] = None,
                 port: int = 0, emit_certs: bool = False) -> None:
        outer = self
        host = host or qi_env("QI_SERVE_BIND") or "127.0.0.1"

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                reader = _utf8_lines(self.rfile)
                writer = _Utf8Writer(self.wfile)
                session = JsonlSession(
                    outer.engine, writer, emit_certs=outer.emit_certs,
                )
                try:
                    run_jsonl_loop(session, reader)  # type: ignore[arg-type]
                except (OSError, ValueError) as exc:
                    # A client that connects and dies mid-line (reset,
                    # torn read) ends THIS session with a typed error —
                    # the acceptor loop and every other connection stay
                    # up, and any work the dead client already submitted
                    # still drains below (its verdicts are cached and
                    # journaled; a reconnect-and-retry is a cache hit).
                    rec = get_run_record()
                    rec.add("serve.errors")
                    rec.event("serve.session_error", error=str(exc))
                    log.warning(
                        "socket session ended mid-line (%s); acceptor "
                        "unaffected", exc,
                    )
                # Connection EOF drains the CONNECTION, not the engine:
                # every response this client is owed goes out before the
                # socket closes; other clients' work is untouched.
                session.wait_drained(timeout=None)

        self.engine = engine
        self.emit_certs = emit_certs
        self._httpd = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True,
        )
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="qi-serve-socket",
            daemon=True,
        )
        self._thread.start()
        log.info("serve socket transport on %s:%d", host, self.port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def _utf8_lines(raw: object) -> Iterator[str]:
    """Decode a binary line reader lazily — tiny shim so the socket handler
    can share ``JsonlSession`` with the text-mode stdio loop."""
    for line in raw:  # type: ignore[attr-defined]
        yield line.decode("utf-8", errors="replace")


class _Utf8Writer:
    """Text façade over a binary socket file (write + flush only)."""

    def __init__(self, raw: object) -> None:
        self._raw = raw

    def write(self, text: str) -> int:
        self._raw.write(text.encode("utf-8"))  # type: ignore[attr-defined]
        return len(text)

    def flush(self) -> None:
        self._raw.flush()  # type: ignore[attr-defined]


# ---- CLI subcommand ---------------------------------------------------------


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m quorum_intersection_tpu_torch serve",
        description=(
            "Long-lived snapshot-verdict service: one JSON request per "
            "stdin line (a raw stellarbeat node array, or "
            '{"request_id": ..., "nodes": [...]}), one JSON response per '
            "stdout line in completion order.  EOF drains the queue and "
            "exits 0."
        ),
    )
    p.add_argument("--journal", metavar="PATH", default=None,
                   help="crash-only request journal (env twin: "
                        "QI_SERVE_JOURNAL): accepted requests are "
                        "journaled before solving; a hard kill + restart "
                        "replays unfinished work")
    p.add_argument("--deadline-s", type=float, default=None, metavar="F",
                   help="per-request deadline budget in seconds (env twin: "
                        "QI_SERVE_DEADLINE_S; 0 = none)")
    p.add_argument("--queue-depth", type=int, default=None, metavar="N",
                   help="admission-queue bound; over-depth requests are "
                        "shed with a typed 'overloaded' error (env twin: "
                        "QI_SERVE_QUEUE_DEPTH)")
    p.add_argument("--batch-max", type=int, default=None, metavar="N",
                   help="most requests one drain cycle batches into "
                        "pipeline.check_many (env twin: QI_SERVE_BATCH_MAX)")
    p.add_argument("--cache-max", type=int, default=None, metavar="N",
                   help="verdict-cache capacity (env twin: "
                        "QI_SERVE_CACHE_MAX)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "gpu-sweep", "gpu-frontier", "cpp", "python"],
                   help="search backend for served solves (default auto)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the served solves run (default cuda: the "
                        "card; there is no silent fall back to the host)")
    p.add_argument("--dangling-policy", default="strict",
                   choices=["strict", "alias0"],
                   help="unknown validator refs (default strict)")
    p.add_argument("--scc-select", default="quorum-bearing",
                   choices=["quorum-bearing", "front"],
                   help="which SCC to search (default quorum-bearing)")
    p.add_argument("--scope-scc", action="store_true",
                   help="scope availability to the searched SCC")
    p.add_argument("--no-delta", action="store_true",
                   help="disable incremental re-analysis (qi-delta): every "
                        "snapshot re-solves from scratch instead of reusing "
                        "per-SCC verdict fragments (env twin: "
                        "QI_DELTA_CACHE_MAX=0)")
    p.add_argument("--replay-only", action="store_true",
                   help="replay the journal, print the report, exit "
                        "(restart-recovery probe; no requests accepted)")
    p.add_argument("--emit-certs", action="store_true",
                   help="verdict responses carry their qi-cert/1 "
                        "certificate and solve stats (off by default for "
                        "wire compatibility)")
    p.add_argument("--socket", type=int, default=None, metavar="PORT",
                   help="ALSO serve the same JSONL protocol over TCP on "
                        "PORT (0 = ephemeral; the bound port is "
                        "announced as a {\"kind\": \"listening\"} line); "
                        "stdin EOF still drains and exits")
    p.add_argument("--bind", metavar="ADDR", default=None,
                   help="bind address of the --socket transport (env "
                        "twin: QI_SERVE_BIND; default 127.0.0.1)")
    p.add_argument("--metrics-json", metavar="PATH", default=None,
                   help="stream qi-telemetry/1 JSONL to PATH")
    p.add_argument("--metrics-prom", metavar="PATH", default=None,
                   help="write final counters/gauges to PATH "
                        "(Prometheus textfile)")
    return p


def serve_main(argv: Optional[List[str]] = None) -> int:
    """The ``serve`` subcommand body (dispatched from cli.py)."""
    from quorum_intersection_tpu_torch.utils import telemetry

    args = build_serve_parser().parse_args(argv)
    record = telemetry.get_run_record()
    if args.metrics_json:
        record.add_sink(telemetry.JsonlSink(args.metrics_json))
    if args.metrics_prom:
        record.add_sink(telemetry.PromFileSink(args.metrics_prom))
    try:
        engine = ServeEngine(
            backend=args.backend,
            queue_depth=args.queue_depth,
            batch_max=args.batch_max,
            deadline_s=args.deadline_s,
            cache_max=args.cache_max,
            journal=args.journal,
            dangling=args.dangling_policy,
            scc_select=args.scc_select,
            scope_to_scc=args.scope_scc,
            delta=False if args.no_delta else None,
            device=None if args.device == "cuda" else args.device,
        )
    except (RuntimeError, ValueError) as exc:
        sys.stderr.write(f"device {args.device!r} unavailable: {exc}\n")
        record.finish()
        return 1
    session = JsonlSession(engine, sys.stdout, emit_certs=args.emit_certs)
    server: Optional[SocketServeServer] = None
    try:
        report = engine.start()
        if report is not None:
            session.emit({"kind": "replay", **report})
        if args.replay_only:
            return 0
        if args.socket is not None:
            server = SocketServeServer(
                engine, host=args.bind, port=args.socket,
                emit_certs=args.emit_certs,
            )
            session.emit({"kind": "listening", "host": server.host,
                          "port": server.port})
        run_jsonl_loop(session, sys.stdin)
        # No drain bound at EOF: every accepted request gets its response
        # line before exit, however long its solve runs (deadlines, not
        # timeouts, are the latency control here).
        engine.stop(drain=True, timeout=None)
        session.wait_drained(timeout=None)
        return 0
    finally:
        if server is not None:
            server.stop()
        engine.stop(drain=False, timeout=5.0)
        record.finish()
