"""qi-fleet/1: the replicated serve tier, and its multi-host mesh.

The port of the JAX package's ``fleet.py``.  One ``serve`` process answers one
stream; an operator who runs more than one puts N of them behind this front
door, which behaves like one server:

- **Workers**: N :class:`~quorum_intersection_tpu_torch.serve.ServeEngine`\\ s —
  subprocesses speaking the serve JSONL protocol over pipes
  (:class:`ProcWorker`, the production shape: ``python -m
  quorum_intersection_tpu_torch serve --journal ... --emit-certs --device
  cuda``, each its own process and CUDA context on the card) or in-process
  engines behind the identical duck-type (:class:`LocalWorker`).  Both
  answer in the wire shape ``serve_transport.ticket_response`` emits, so the
  front door cannot tell them apart.
- **Consistent-hash routing** (:class:`HashRing`): the front door keys on the
  sanitized snapshot fingerprint (``serve.snapshot_fingerprint``), so
  identical snapshots from any client coalesce fleet-wide through one
  worker's single-flight path, and a join or leave moves only about 1/N of
  the key space.  The ring is the JAX package's point for point: the same
  keys and worker ids land on the same worker.
- **Shared per-SCC verdict store**: every worker's ``SccVerdictStore`` reads
  through to one :class:`~quorum_intersection_tpu_torch.delta.SharedSccStore`
  directory (``QI_FLEET_STORE_DIR``, exported to each worker), so an SCC
  fragment solved on worker A composes into worker B's certificate, and the
  composed certificate still passes the unmodified ``tools/check_cert.py``.
- **Journal-backed failover**: each worker keeps its own crash-only
  ``RequestJournal``; when health probes (or a broken pipe) declare a worker
  dead, the front door evicts it from the ring and replays its unfinished
  journal on the peers inheriting its hash range, deduplicated against the
  front door's own in-flight tickets and the journal's ``done`` marks: zero
  lost, zero duplicated.  Only a worker's death or a lapsed lease moves work
  elsewhere: a worker's failed solve on the card is its request's typed error
  line, relayed as it came, never retried on another worker or the host.
- **The mesh**: ``--join HOST:PORT`` dials a peer running ``serve --socket``
  on another host (:class:`SocketWorker`) through a versioned handshake
  (protocol, package fingerprint, ``QI_FLEET_TOKEN`` digest; a mismatch is a
  typed reject, :class:`MeshHandshakeError`).  The front door's
  :class:`StoreGateway` serves the shared fragment tier to such peers over
  the wire.  Missed heartbeats on a live connection suspect a peer (its
  requests hedge to the next arc owner); only a lapsed lease evicts it and
  ships its journal over the wire.  The wire is the JAX package's, so either
  package's front door joins either package's server.
- **Aggregation planes**: each probe cycle merges the workers' pong-carried
  pulse histograms bucket-wise (``fleet.pulse.*``, ``fleet.e2e_p99_ms``) and
  their per-tenant cost tables (``cost.fleet_tenant_table``).

Every boundary is a declared fault point (``fleet.route``, ``fleet.probe``,
``fleet.replay``, ``fleet.store``, ``fleet.join``, ``fleet.lease``,
``fleet.hedge``, ``fleet.ship``, ``fleet.scale``, ``store.fetch``,
``pulse.aggregate``) that degrades one rung, loudly, and never to a wrong
verdict.  ``/readyz`` answers 503 until every live worker finished journal
replay (``fleet.replay_complete``).

CLI: ``python -m quorum_intersection_tpu_torch fleet -n 2`` — the serve
subcommand's JSONL stdin/stdout contract, requests fanned across the ring.
"""

from __future__ import annotations

import argparse
import base64
import bisect
import hashlib
import hmac
import json
import os
import random
import socket
import socketserver
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

from quorum_intersection_tpu_torch.delta import STORE_SCHEMA, SharedSccStore
from quorum_intersection_tpu_torch.device import DeviceLike, resolve_device
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import Fbas, parse_fbas
from quorum_intersection_tpu_torch.query import Query
from quorum_intersection_tpu_torch.serve import (
    RequestJournal,
    ServeEngine,
    ServeError,
    ServeResponse,
    Ticket,
    _raw_nodes,
    snapshot_fingerprint,
)
from quorum_intersection_tpu_torch.serve_transport import (
    MESH_PROTOCOL,
    PROTOCOL_SCHEMA,
    JsonlSession,
    fleet_token_digest,
    package_fingerprint,
    pong_payload,
    run_jsonl_loop,
    ticket_response,
)
from quorum_intersection_tpu_torch.utils.env import (
    qi_env,
    qi_env_float,
    qi_env_int,
)
from quorum_intersection_tpu_torch.utils.faults import FaultInjected, fault_point
from quorum_intersection_tpu_torch.utils.logging import get_logger
from quorum_intersection_tpu_torch.utils.telemetry import (
    Histogram,
    RunRecord,
    TraceContext,
    get_run_record,
)

log = get_logger("fleet")

FLEET_SCHEMA = "qi-fleet/1"

# Deterministic-interleaving hook: a no-op in production; a test swaps in a
# controller that blocks at named points to force the routing, eviction and
# replay orderings the wall clock almost never produces
# (route-during-eviction, replay-races-new-request).
_fleet_sync: Callable[[str], None] = lambda point: None


# ---- typed mesh errors ------------------------------------------------------


class MeshHandshakeError(ServeError):
    """A join handshake the peer REFUSED with a typed ``hello_err``
    (protocol_mismatch / fingerprint_mismatch / bad_token): the mesh
    contract is a typed reject, never a silently skewed fleet — this is
    never retried, it propagates to the operator."""

    code = "mesh_handshake"

    def __init__(self, reject_code: str, message: str) -> None:
        self.reject_code = reject_code
        super().__init__(
            f"mesh join rejected ({reject_code}): {message}"
        )


class JournalUnreadableError(ServeError):
    """``adopt_journal`` was handed a path this host cannot read —
    missing, permission-denied, or (the common multi-host mistake) a path
    that only exists on a REMOTE peer's filesystem.  Typed so callers are
    routed to the mesh ship protocol (``serve --socket`` +
    ``fleet --join``: the journal streams over the wire, chunked +
    digest-checked + fsync-before-ack) instead of debugging a bare
    OSError."""

    code = "journal_unreadable"


# ---- consistent-hash ring ---------------------------------------------------


class HashRing:
    """Deterministic consistent-hash ring with virtual nodes.

    Each worker owns ``vnodes`` points (``sha256(worker_id + '#' + i)``,
    first 8 bytes) on a 64-bit circle; a key routes to the first point at
    or after its own hash.  Determinism is the routing contract: the same
    worker set and vnode count produce the identical key→worker map in
    every process and on every run, and adding/removing one worker moves
    only the keys whose arcs that worker's points own — **bounded
    rebalance**, ~1/N of the key space (``tests/test_qi_fleet.py`` pins
    both properties).
    """

    def __init__(self, vnodes: Optional[int] = None) -> None:
        self.vnodes = max(
            vnodes if vnodes is not None
            else qi_env_int("QI_FLEET_VNODES", 32),
            1,
        )
        self._points: List[Tuple[int, str]] = []  # sorted (hash, worker_id)
        self._workers: Set[str] = set()

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.sha256(key.encode("utf-8")).digest()[:8], "big",
        )

    def add(self, worker_id: str) -> None:
        if worker_id in self._workers:
            return
        self._workers.add(worker_id)
        for v in range(self.vnodes):
            bisect.insort(
                self._points, (self._hash(f"{worker_id}#{v}"), worker_id),
            )

    def remove(self, worker_id: str) -> None:
        if worker_id not in self._workers:
            return
        self._workers.discard(worker_id)
        self._points = [p for p in self._points if p[1] != worker_id]

    def route(self, key: str) -> str:
        """The worker owning ``key``'s arc; ``LookupError`` on an empty
        ring (the caller turns it into a typed no-live-workers error)."""
        if not self._points:
            raise LookupError("consistent-hash ring is empty")
        h = self._hash(key)
        ix = bisect.bisect_left(self._points, (h, ""))
        if ix == len(self._points):
            ix = 0
        return self._points[ix][1]

    def route_excluding(self, key: str,
                        exclude: Set[str]) -> Optional[str]:
        """The first arc owner at or after ``key``'s hash whose worker is
        NOT in ``exclude`` — the hedge secondary's "next arc owner"
        contract (qi-mesh): walking the ring point-by-point keeps the
        secondary deterministic for a given worker set, like
        :meth:`route` itself.  ``None`` when every point is excluded."""
        if not self._points:
            return None
        h = self._hash(key)
        start = bisect.bisect_left(self._points, (h, ""))
        for k in range(len(self._points)):
            wid = self._points[(start + k) % len(self._points)][1]
            if wid not in exclude:
                return wid
        return None

    def workers(self) -> List[str]:
        return sorted(self._workers)

    def __len__(self) -> int:
        return len(self._workers)

    def __contains__(self, worker_id: str) -> bool:
        return worker_id in self._workers


# ---- worker handles ---------------------------------------------------------

# A worker handle's response callback: (worker_id, response object).
_OnResponse = Callable[[str, Dict[str, object]], None]


class ProcWorker:
    """One serve worker subprocess speaking JSONL over pipes.

    The production worker shape: ``python -m quorum_intersection_tpu_torch
    serve --journal <own journal> --emit-certs --device <device>`` with
    ``QI_FLEET_STORE_DIR`` exported, so its verdict responses carry
    certificates (the front door relays them verbatim), its solves run on the
    card unless ``device`` is ``"cpu"``, and its per-SCC store shares the
    fleet tier.  A reader thread demultiplexes the pipe: replay reports
    resolve readiness, pongs resolve pending pings, everything else is a
    response handed to the front door.  The worker's stderr goes to
    ``<journal>.stderr`` beside its journal, so a worker that fails at start
    (a card that cannot be reached, a kernel that does not build) leaves its
    reason on disk.
    """

    kind = "proc"

    def __init__(
        self,
        worker_id: str,
        journal_path: Union[str, Path],
        on_response: _OnResponse,
        *,
        backend: str = "auto",
        store_dir: Optional[Union[str, Path]] = None,
        deadline_s: Optional[float] = None,
        batch_max: Optional[int] = None,
        cache_max: Optional[int] = None,
        queue_depth: Optional[int] = None,
        dangling: str = "strict",
        scc_select: str = "quorum-bearing",
        scope_to_scc: bool = False,
        on_exit: Optional[Callable[[str], None]] = None,
        device: str = "cuda",
    ) -> None:
        self.worker_id = worker_id
        self.journal_path = Path(journal_path)
        self._on_response = on_response
        self._on_exit = on_exit
        self._closing = False
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pings: Dict[str, Tuple[threading.Event, List[Dict[str, object]]]] = {}
        self._ready = threading.Event()
        self.replay_report: Optional[Dict[str, object]] = None
        cmd = [
            sys.executable, "-m", "quorum_intersection_tpu_torch", "serve",
            "--journal", str(self.journal_path),
            "--backend", backend,
            "--device", device,
            "--emit-certs",
            "--dangling-policy", dangling,
            "--scc-select", scc_select,
        ]
        if scope_to_scc:
            cmd.append("--scope-scc")
        if deadline_s is not None:
            cmd += ["--deadline-s", str(deadline_s)]
        if batch_max is not None:
            cmd += ["--batch-max", str(batch_max)]
        if cache_max is not None:
            cmd += ["--cache-max", str(cache_max)]
        if queue_depth is not None:
            cmd += ["--queue-depth", str(queue_depth)]
        env = dict(os.environ)
        if store_dir is not None:
            env["QI_FLEET_STORE_DIR"] = str(store_dir)
        # One scrape port cannot be shared by N workers; their health rides
        # the ping/pong protocol instead.
        env["QI_METRICS_PORT"] = "0"
        self.journal_path.parent.mkdir(parents=True, exist_ok=True)
        self.stderr_path = self.journal_path.with_name(self.journal_path.name + ".stderr")
        with self.stderr_path.open("w") as err:
            self._proc = subprocess.Popen(
                cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=err, text=True, env=env,
            )
        self._reader = threading.Thread(
            target=self._read_loop, name=f"qi-fleet-read-{worker_id}",
            daemon=True,
        )
        self._reader.start()

    def _read_loop(self) -> None:
        assert self._proc.stdout is not None
        for line in self._proc.stdout:
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(obj, dict):
                continue
            if obj.get("kind") == "replay":
                self.replay_report = obj
                self._ready.set()
                continue
            if obj.get("kind") == "listening":
                continue
            if "pong" in obj:
                token = str(obj.get("pong"))
                with self._plock:
                    waiter = self._pings.pop(token, None)
                if waiter is not None:
                    waiter[1].append(obj)
                    waiter[0].set()
                continue
            self._on_response(self.worker_id, obj)
        if not self._closing and self._on_exit is not None:
            self._on_exit(self.worker_id)

    def _write(self, obj: Dict[str, object]) -> bool:
        try:
            assert self._proc.stdin is not None
            with self._wlock:
                self._proc.stdin.write(json.dumps(obj, default=str) + "\n")
                self._proc.stdin.flush()
            return True
        except (OSError, ValueError):
            # Broken pipe / closed stdin: the worker is gone — the caller
            # turns this into eviction + failover.
            return False

    def wait_ready(self, timeout: float) -> bool:
        return self._ready.wait(timeout)

    def submit(self, request_id: str, nodes: List[Dict[str, object]],
               deadline_s: Optional[float],
               query: Optional[Dict[str, object]] = None,
               trace: Optional[str] = None,
               client: Optional[str] = None) -> bool:
        line: Dict[str, object] = {"request_id": request_id, "nodes": nodes}
        if deadline_s is not None:
            line["deadline_s"] = deadline_s
        if query is not None:
            line["query"] = query
        if trace is not None:
            # qi-pulse: the front door's request-span context — the worker
            # adopts it so its spans join this request's trace.
            line["trace"] = trace
        if client is not None:
            # qi-cost: the tenant this request books to on the worker.
            line["client"] = client
        return self._write(line)

    def ping(self, timeout: float = 2.0) -> Optional[Dict[str, object]]:
        token = f"{self.worker_id}-{time.monotonic_ns():x}"
        ev: threading.Event = threading.Event()
        box: List[Dict[str, object]] = []
        with self._plock:
            self._pings[token] = (ev, box)
        if not self._write({"ping": token}) or not ev.wait(timeout):
            with self._plock:
                self._pings.pop(token, None)
            return None
        return box[0]

    def alive(self) -> bool:
        return self._proc.poll() is None

    def kill(self) -> None:
        """SIGKILL — the bench's kill-one-of-N hook (a real hard kill: the
        journal's torn tail and unfinished entries are genuine)."""
        self._proc.kill()

    def close(self, timeout: float = 30.0) -> None:
        """Graceful shutdown: stdin EOF drains the worker (every accepted
        request answers before exit, the serve CLI contract)."""
        self._closing = True
        try:
            assert self._proc.stdin is not None
            with self._wlock:
                self._proc.stdin.close()
        except (OSError, ValueError):
            pass
        try:
            self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            log.warning("fleet worker %s did not drain in %gs; killed",
                        self.worker_id, timeout)
            self._proc.kill()
        self._reader.join(timeout=5.0)


class LocalWorker:
    """In-process worker: the same ``ServeEngine`` behind the same handle
    duck-type, answering in the exact shape the JSONL transport emits
    (``serve_transport.ticket_response``) — the front door cannot tell a
    LocalWorker from a ProcWorker.  Used by the deterministic schedule
    harness, the test matrix, and bench smokes where N subprocess
    spin-ups would dominate the measurement.  Its engine solves on
    ``device`` (the card unless ``"cpu"``).

    ``kill()`` simulates a hard kill at the fidelity an in-process worker
    allows: responses stop immediately (suppressed, as a dead process's
    would be) and the engine is torn down without draining — the real
    SIGKILL matrix (torn journal tails) is covered by :class:`ProcWorker`
    rounds and the journal-construction tests.
    """

    kind = "local"

    def __init__(
        self,
        worker_id: str,
        journal_path: Union[str, Path],
        on_response: _OnResponse,
        *,
        backend: str = "auto",
        store_dir: Optional[Union[str, Path]] = None,
        deadline_s: Optional[float] = None,
        batch_max: Optional[int] = None,
        cache_max: Optional[int] = None,
        queue_depth: Optional[int] = None,
        dangling: str = "strict",
        scc_select: str = "quorum-bearing",
        scope_to_scc: bool = False,
        on_exit: Optional[Callable[[str], None]] = None,
        device: str = "cuda",
    ) -> None:
        self.worker_id = worker_id
        self.journal_path = Path(journal_path)
        self._on_response = on_response
        self._dead = False
        self.replay_report: Optional[Dict[str, object]] = None
        self.engine = ServeEngine(
            backend=backend,
            journal=self.journal_path,
            deadline_s=deadline_s,
            batch_max=batch_max,
            cache_max=cache_max,
            queue_depth=queue_depth,
            dangling=dangling,
            scc_select=scc_select,
            scope_to_scc=scope_to_scc,
            shared_store=(
                SharedSccStore(store_dir) if store_dir is not None else None
            ),
            device=device,
        )
        self.replay_report = self.engine.start()

    def wait_ready(self, timeout: float) -> bool:
        return True  # start() above already replayed synchronously

    def _respond(self, obj: Dict[str, object]) -> None:
        if self._dead:
            return  # a killed worker answers nobody
        self._on_response(self.worker_id, obj)

    def _on_ticket_done(self, ticket: Ticket) -> None:
        self._respond(ticket_response(ticket, emit_certs=True))

    def submit(self, request_id: str, nodes: List[Dict[str, object]],
               deadline_s: Optional[float],
               query: Optional[Dict[str, object]] = None,
               trace: Optional[str] = None,
               client: Optional[str] = None) -> bool:
        if self._dead:
            return False
        try:
            ticket = self.engine.submit(
                nodes, request_id=request_id, deadline_s=deadline_s,
                query=query, trace=trace, client=client,
            )
        except ServeError as exc:
            self._respond({"request_id": request_id,
                           "error": {"code": exc.code, "message": str(exc)}})
            return True
        except (ValueError, TypeError, FaultInjected) as exc:
            self._respond({"request_id": request_id,
                           "error": {"code": str(getattr(exc, "code",
                                                         "invalid")),
                                     "message": str(exc)}})
            return True
        ticket.add_done_callback(self._on_ticket_done)
        return True

    def ping(self, timeout: float = 2.0) -> Optional[Dict[str, object]]:
        if self._dead:
            return None
        return pong_payload(f"local-{self.worker_id}")

    def alive(self) -> bool:
        return not self._dead

    def kill(self) -> None:
        self._dead = True
        self.engine.stop(drain=False, timeout=2.0)

    def close(self, timeout: float = 30.0) -> None:
        if not self._dead:
            self.engine.stop(drain=True, timeout=timeout)


class SocketWorker:
    """One REMOTE serve worker joined over TCP (the mesh): a
    peer running ``serve --socket PORT [--bind ADDR]`` on another host,
    behind the same handle duck-type as :class:`ProcWorker` /
    :class:`LocalWorker` — the front door cannot tell them apart.

    The constructor performs the versioned join handshake (protocol +
    package fingerprint + ``QI_FLEET_TOKEN`` digest); the peer's
    ``hello_ok`` carries its replay report (readiness), a ``hello_err``
    is a TYPED reject surfaced via :attr:`handshake_error` — never a
    silently skewed mesh.  The hello also advertises the front door's
    store gateway, so the peer's SCC fragments flow both ways
    (fetch-on-miss, publish-on-solve).

    Liveness is two-tier: a broken CONNECTION (reader EOF) is death —
    same as a ProcWorker's pipe EOF; missed *pings on a live connection*
    are a PARTITION signal the front door turns into suspicion + lease
    accounting, because a stalled wire heals where a dead process never
    does.  ``journal_path`` is ``None`` — the peer's journal lives on its
    host and ships over the wire (:meth:`ship_journal`) instead.
    """

    kind = "socket"

    def __init__(
        self,
        worker_id: str,
        addr: Tuple[str, int],
        on_response: _OnResponse,
        *,
        store_port: Optional[int] = None,
        on_exit: Optional[Callable[[str], None]] = None,
        timeout_s: float = 10.0,
    ) -> None:
        self.worker_id = worker_id
        self.addr = (str(addr[0]), int(addr[1]))
        self.journal_path: Optional[Path] = None  # remote: ships over the wire
        self._on_response = on_response
        self._on_exit = on_exit
        self._closing = False
        self._dead = False
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pings: Dict[str, Tuple[threading.Event, List[Dict[str, object]]]] = {}
        self._ready = threading.Event()
        self.replay_report: Optional[Dict[str, object]] = None
        self.handshake_error: Optional[Dict[str, object]] = None
        # Journal-ship collector.  _ship_lock guards only the collector
        # fields (quick mutations — waiting and fsync happen outside any
        # lock); ship serialization itself is the callers' contract: the
        # evict path is deduplicated by _dead_handled and the retire path
        # removed the worker from _live first, so at most one ship is in
        # flight per worker.
        self._ship_lock = threading.Lock()
        self._ship_done = threading.Event()
        self._ship_chunks: Dict[int, bytes] = {}
        self._ship_end: Optional[Dict[str, object]] = None
        self._ship_err: Optional[Dict[str, object]] = None
        self._sock = socket.create_connection(self.addr, timeout=timeout_s)
        # Reads block on the reader thread; every write is deadline-free
        # JSONL guarded by _wlock (a stuck peer surfaces as ping misses,
        # not a wedged front door — the socket's send buffer absorbs the
        # line or the OS errors the write).
        self._sock.settimeout(None)
        self._rfile = self._sock.makefile("r", encoding="utf-8")
        self._wfile = self._sock.makefile("w", encoding="utf-8")
        hello: Dict[str, object] = {
            "schema": PROTOCOL_SCHEMA,
            "protocol": MESH_PROTOCOL,
            "fingerprint": package_fingerprint(),
            "token": fleet_token_digest(),
            "peer": worker_id,
        }
        if store_port is not None:
            # The address THIS host is reachable at from the peer's side
            # of this very connection — the one host answer that is
            # correct on loopback and multi-homed hosts alike.
            hello["store"] = {
                "host": self._sock.getsockname()[0],
                "port": int(store_port),
            }
        self._reader = threading.Thread(
            target=self._read_loop, name=f"qi-fleet-sock-{worker_id}",
            daemon=True,
        )
        if not self._write({"hello": hello}):
            raise OSError(f"mesh hello write to {self.addr} failed")
        self._reader.start()

    # ---- wire ------------------------------------------------------------

    def _read_loop(self) -> None:
        try:
            for line in self._rfile:
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if not isinstance(obj, dict):
                    continue
                if "hello_ok" in obj:
                    ok = obj["hello_ok"]
                    if isinstance(ok, dict):
                        rep = ok.get("replay")
                        self.replay_report = (
                            rep if isinstance(rep, dict) else None
                        )
                    self._ready.set()
                    continue
                if "hello_err" in obj:
                    err = obj["hello_err"]
                    self.handshake_error = (
                        err if isinstance(err, dict)
                        else {"code": "hello_err"}
                    )
                    self._ready.set()
                    continue
                if "ship_chunk" in obj:
                    self._collect_chunk(obj["ship_chunk"])
                    continue
                if "ship_end" in obj:
                    end = obj["ship_end"]
                    with self._ship_lock:
                        self._ship_end = end if isinstance(end, dict) else {}
                    self._ship_done.set()
                    continue
                if "ship_err" in obj:
                    err = obj["ship_err"]
                    with self._ship_lock:
                        self._ship_err = err if isinstance(err, dict) else {}
                    self._ship_done.set()
                    continue
                if "pong" in obj:
                    token = str(obj.get("pong"))
                    with self._plock:
                        waiter = self._pings.pop(token, None)
                    if waiter is not None:
                        waiter[1].append(obj)
                        waiter[0].set()
                    continue
                self._on_response(self.worker_id, obj)
        except (OSError, ValueError):
            pass
        self._dead = True
        self._ready.set()  # a join blocked in wait_ready wakes to False
        self._ship_done.set()  # a ship blocked mid-stream wakes to None
        if not self._closing and self._on_exit is not None:
            self._on_exit(self.worker_id)

    def _collect_chunk(self, chunk: object) -> None:
        if not isinstance(chunk, dict):
            return
        try:
            data = base64.b64decode(str(chunk.get("data") or ""))
            seq = int(chunk.get("seq") or 0)
            want = int(chunk.get("len"))  # type: ignore[arg-type]
        except (ValueError, TypeError):
            return  # a malformed chunk fails the digest check downstream
        if len(data) == want:
            with self._ship_lock:
                self._ship_chunks[seq] = data

    def _write(self, obj: Dict[str, object]) -> bool:
        try:
            with self._wlock:
                self._wfile.write(json.dumps(obj, default=str) + "\n")
                self._wfile.flush()
            return True
        except (OSError, ValueError):
            # Broken connection: the peer (or the wire) is gone — the
            # caller turns this into suspicion/eviction.
            return False

    # ---- worker duck-type ------------------------------------------------

    def wait_ready(self, timeout: float) -> bool:
        if not self._ready.wait(timeout):
            return False
        return self.handshake_error is None and not self._dead

    def submit(self, request_id: str, nodes: List[Dict[str, object]],
               deadline_s: Optional[float],
               query: Optional[Dict[str, object]] = None,
               trace: Optional[str] = None,
               client: Optional[str] = None) -> bool:
        if self._dead:
            return False
        line: Dict[str, object] = {"request_id": request_id, "nodes": nodes}
        if deadline_s is not None:
            line["deadline_s"] = deadline_s
        if query is not None:
            line["query"] = query
        if trace is not None:
            line["trace"] = trace
        if client is not None:
            line["client"] = client
        return self._write(line)

    def ping(self, timeout: float = 2.0) -> Optional[Dict[str, object]]:
        if self._dead:
            return None
        token = f"{self.worker_id}-{time.monotonic_ns():x}"
        ev: threading.Event = threading.Event()
        box: List[Dict[str, object]] = []
        with self._plock:
            self._pings[token] = (ev, box)
        if not self._write({"ping": token}) or not ev.wait(timeout):
            with self._plock:
                self._pings.pop(token, None)
            return None
        return box[0]

    def alive(self) -> bool:
        # Connection-level liveness only: a SIGSTOPped/partitioned peer
        # keeps its TCP session and stays "alive" here — its missed
        # pings drive the suspect→lease-lapse path instead, because a
        # partition heals where a dead process never does.
        return not self._dead

    def ship_journal(self, spool_dir: Path,
                     timeout: float = 30.0) -> Optional[Path]:
        """Pull the peer's crash-only journal into a local spool file:
        chunked + length-checked + digest-verified, and **fsynced before
        the ack goes back** — an acked ship is durable on this side, and
        a torn stream is detected (digest mismatch), never replayed.
        ``None`` on a broken wire or failed verification."""
        with self._ship_lock:
            self._ship_chunks = {}
            self._ship_end = None
            self._ship_err = None
        self._ship_done.clear()
        if not self._write(
            {"ship_journal": {"token": fleet_token_digest()}}
        ):
            return None
        if not self._ship_done.wait(timeout):
            return None
        with self._ship_lock:
            end = self._ship_end
            err = self._ship_err
            chunks = dict(self._ship_chunks)
        if err is not None or end is None:
            return None
        raw = b"".join(chunks[i] for i in sorted(chunks))
        try:
            intact = (
                len(chunks) == int(end.get("chunks") or 0)
                and len(raw) == int(end.get("bytes") or -1)
                and hashlib.sha256(raw).hexdigest() == end.get("sha256")
            )
        except (ValueError, TypeError):
            intact = False
        if not intact:
            return None
        spool_dir.mkdir(parents=True, exist_ok=True)
        spool = spool_dir / f"{self.worker_id}.shipped.journal"
        with spool.open("wb") as fh:
            fh.write(raw)
            fh.flush()
            os.fsync(fh.fileno())
        self._write({"ship_ack": {"bytes": len(raw)}})
        return spool

    def kill(self) -> None:
        """Hard-drop the CONNECTION (the peer process keeps running on
        its host; from this fleet's view the worker is gone)."""
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self, timeout: float = 30.0) -> None:
        """Graceful: half-close the write side so the peer sees EOF and
        drains this session (every accepted request answers through the
        still-open read half), then tear down."""
        self._closing = True
        try:
            self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        self._reader.join(timeout=timeout)
        self._dead = True
        for closer in (self._rfile, self._wfile, self._sock):
            try:
                closer.close()
            except OSError:
                pass


class StoreGateway:
    """qi-store/1 over TCP (the mesh): the front door's
    :class:`~quorum_intersection_tpu_torch.delta.SharedSccStore` served to
    socket-joined peers, so SCC fragments flow across hosts with no
    shared filesystem — fetch-on-miss, publish-on-solve, through
    ``delta.RemoteStoreClient`` on the peer side.

    Sessions open with a token-authenticated ``store_hello`` (digest
    compare, like the join handshake); each subsequent line is one
    ``get``/``put`` op answered with one ``{"ok": ...}`` line.  Serving
    reads/writes the same atomic file tier the local workers share, and
    safety is unchanged: a forged, torn or stale payload fails the
    client's strict shape validation and re-verification — it is only
    ever a miss, never a trusted verdict.
    """

    def __init__(self, store: SharedSccStore, *,
                 host: Optional[str] = None, port: int = 0) -> None:
        outer = self
        host = host or qi_env("QI_SERVE_BIND") or "127.0.0.1"

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                outer._serve_conn(self.rfile, self.wfile)

        self.store = store
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True,
        )
        self._srv.daemon_threads = True
        self.host = host
        self.port = int(self._srv.server_address[1])
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="qi-store-gateway",
            daemon=True,
        )
        self._thread.start()
        log.info("fleet store gateway on %s:%d", host, self.port)

    def _serve_conn(self, rfile: object, wfile: object) -> None:
        """One authenticated gateway session; a client that dies mid-line
        ends THIS session (logged), never the acceptor."""
        rec = get_run_record()

        def reply(obj: Dict[str, object]) -> None:
            wfile.write(  # type: ignore[attr-defined]
                (json.dumps(obj, default=str) + "\n").encode("utf-8")
            )
            wfile.flush()  # type: ignore[attr-defined]

        try:
            first = (rfile.readline() or b"null")  # type: ignore[attr-defined]
            hello = json.loads(first.decode("utf-8", errors="replace"))
            inner = (hello.get("store_hello")
                     if isinstance(hello, dict) else None)
            if not (isinstance(inner, dict) and hmac.compare_digest(
                str(inner.get("token") or ""), fleet_token_digest(),
            )):
                rec.add("fleet.store_gateway_rejects")
                rec.event("fleet.store_gateway_rejected")
                reply({"ok": False, "error": "store_hello token mismatch"})
                return
            reply({"ok": True, "schema": STORE_SCHEMA})
            for line in rfile:  # type: ignore[attr-defined]
                op = json.loads(line.decode("utf-8", errors="replace"))
                if not isinstance(op, dict):
                    reply({"ok": False, "error": "op is not an object"})
                    continue
                kind = str(op.get("kind") or "")
                fp = str(op.get("fp") or "")
                scope = str(op.get("scope") or "")
                if op.get("op") == "get":
                    reply({"ok": True,
                           "payload": self.store.get(kind, fp, scope)})
                elif op.get("op") == "put":
                    payload = op.get("payload")
                    stored = (
                        self.store.put(kind, fp, payload, scope)
                        if isinstance(payload, dict) else False
                    )
                    reply({"ok": True, "stored": stored})
                else:
                    reply({"ok": False, "error": "unknown op"})
        except (OSError, ValueError) as exc:
            log.warning("store gateway session ended (%s); acceptor "
                        "unaffected", exc)

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


# ---- the front door ---------------------------------------------------------


@dataclass
class _Pending:
    """One in-flight fleet request: the client ticket plus everything a
    failover needs to re-route it (journal-grade payload, routing key).

    ``wire_id`` is the id on the worker protocol — normally the client's
    ``request_id``, made unique when a client reuses an id while the
    first request is still in flight (the serve contract answers every
    submission, so a duplicate must not orphan the earlier ticket)."""

    ticket: Ticket
    wire_id: str
    fingerprint: str
    nodes: List[Dict[str, object]]
    deadline_s: Optional[float]
    worker_id: str = ""
    internal: bool = False  # journal-inherited work with no client ticket
    replaying: bool = False  # dispatched by a failover; gates /readyz
    query: Optional[Dict[str, object]] = None  # qi-query/1 wire form
    # qi-pulse: the wire trace context stamped at admission
    # ("trace_id:span_id[:pid]", parented on the fleet.request span) —
    # re-sent on every failover re-dispatch so the inheriting worker's
    # spans still join the original request's trace.
    trace: Optional[str] = None
    # qi-cost: the client id forwarded to whichever worker ends
    # up solving this request — failover re-dispatches keep the tenant.
    client: Optional[str] = None


class FleetEngine:
    """The replicated serve tier's front door (see module docstring).

    ``submit`` has the same signature and Ticket semantics as
    ``ServeEngine.submit``, so the JSONL transports drive either — the
    ``fleet`` CLI subcommand IS ``serve_transport.JsonlSession`` over this
    class.  ``device`` (None: CUDA) is where every local or subprocess worker
    solves; socket peers solve where their own server was started.
    """

    def __init__(
        self,
        workers: Optional[int] = None,
        *,
        backend: str = "auto",
        worker_mode: str = "subprocess",
        journal_dir: Optional[Union[str, Path]] = None,
        store_dir: Optional[Union[str, Path]] = None,
        deadline_s: Optional[float] = None,
        batch_max: Optional[int] = None,
        cache_max: Optional[int] = None,
        queue_depth: Optional[int] = None,
        dangling: str = "strict",
        scc_select: str = "quorum-bearing",
        scope_to_scc: bool = False,
        vnodes: Optional[int] = None,
        probe_interval_s: Optional[float] = None,
        probe_fails: Optional[int] = None,
        respawn_max: Optional[int] = None,
        joins: Optional[Sequence[str]] = None,
        lease_s: Optional[float] = None,
        scale_interval_s: Optional[float] = None,
        scale_min: Optional[int] = None,
        scale_max: Optional[int] = None,
        device: DeviceLike = None,
    ) -> None:
        if worker_mode not in ("subprocess", "local"):
            raise ValueError(f"unknown worker_mode {worker_mode!r}")
        # The card unless the caller asks for the host, resolved now: a fleet
        # started without a card fails before it spawns a worker.
        self.device = resolve_device(device).type
        # Socket joins (the mesh): "HOST:PORT" peers running
        # ``serve --socket``; slot ids j0.. so the respawn machinery can
        # REDIAL a slot's address after an eviction (the rejoin path).
        self._join_addrs: Dict[str, Tuple[str, int]] = {}
        for i, spec in enumerate(joins or ()):
            host, _, port = str(spec).rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(
                    f"--join expects HOST:PORT, got {spec!r}"
                )
            self._join_addrs[f"j{i}"] = (host, int(port))
        self.n_workers = max(
            workers if workers is not None
            else qi_env_int("QI_FLEET_WORKERS", 2),
            # A pure socket mesh may run with ZERO local workers; without
            # joins at least one local worker keeps the ring non-empty.
            0 if self._join_addrs else 1,
        )
        self.backend = backend
        self.worker_mode = worker_mode
        self.deadline_s = deadline_s
        self.batch_max = batch_max
        self.cache_max = cache_max
        self.queue_depth = queue_depth
        self.dangling = dangling
        self.scc_select = scc_select
        self.scope_to_scc = scope_to_scc
        self.probe_interval_s = (
            probe_interval_s if probe_interval_s is not None
            else max(qi_env_float("QI_FLEET_PROBE_INTERVAL_S", 0.5), 0.05)
        )
        self.probe_fails = max(
            probe_fails if probe_fails is not None
            else qi_env_int("QI_FLEET_PROBE_FAILS", 2),
            1,
        )
        # Worker auto-respawn (without it the ring shrinks on every
        # eviction until restart).  Bounded per SLOT so a
        # crash-looping worker cannot respawn forever; 0 disables.
        self.respawn_max = max(
            respawn_max if respawn_max is not None
            else qi_env_int("QI_FLEET_RESPAWN_MAX", 2),
            0,
        )
        self._respawn_counts: Dict[str, int] = {}
        # Heartbeat leases (qi-mesh): a socket peer that misses its probe
        # hysteresis is SUSPECTED — routed around with hedged dispatch —
        # and only evicted when its lease (renewed by every pong) lapses.
        self.lease_s = max(
            lease_s if lease_s is not None
            else qi_env_float("QI_FLEET_LEASE_S", 3.0),
            0.1,
        )
        self._suspected: Set[str] = set()
        self._leases: Dict[str, float] = {}
        self._store_gateway: Optional[StoreGateway] = None
        # Elasticity (qi-mesh): the pulse→fleet-size supervisor. 0 = off.
        self.scale_interval_s = (
            scale_interval_s if scale_interval_s is not None
            else qi_env_float("QI_FLEET_SCALE_INTERVAL_S", 0.0)
        )
        self.scale_up_ms = qi_env_float("QI_FLEET_SCALE_UP_MS", 250.0)
        self.scale_down_ms = qi_env_float("QI_FLEET_SCALE_DOWN_MS", 20.0)
        self.scale_min = max(
            scale_min if scale_min is not None
            else qi_env_int("QI_FLEET_SCALE_MIN", 1),
            1,
        )
        self.scale_max = max(
            scale_max if scale_max is not None
            else qi_env_int("QI_FLEET_SCALE_MAX", 8),
            self.scale_min,
        )
        self._next_scale_t = 0.0
        self._elastic_seq = 0
        self._tmpdir: Optional[tempfile.TemporaryDirectory] = None
        if journal_dir is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="qi-fleet-")
            journal_dir = self._tmpdir.name
        self.journal_dir = Path(journal_dir)
        env_store = qi_env("QI_FLEET_STORE_DIR")
        self.store_dir = Path(
            store_dir if store_dir is not None
            else (env_store or self.journal_dir / "store")
        )
        self._lock = threading.Lock()
        self._ring = HashRing(vnodes=vnodes)
        self._workers: Dict[str, Union[ProcWorker, LocalWorker]] = {}
        self._live: Set[str] = set()
        self._pending: Dict[str, _Pending] = {}  # wire_id → pending
        self._dead_handled: Set[str] = set()
        self._failovers_active = 0
        self._replays_outstanding = 0
        # Aggregation plane (qi-pulse): merge the workers'
        # pong-carried pulse histograms fleet-wide each probe cycle.
        # "0" restores per-worker-only metrics.
        self._pulse_agg = qi_env("QI_PULSE_AGG") not in ("", "0")
        self._pongs: Dict[str, Dict[str, object]] = {}
        self._closed = False
        self._started = False
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None

    # ---- lifecycle -------------------------------------------------------

    def worker_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._live)

    def start(self) -> Dict[str, object]:
        """Spawn the workers, replay their journals, build the ring.

        ``fleet.replay_complete`` stays 0 (``/readyz`` answers 503) until
        EVERY live worker finished its own journal replay — a restarted
        fleet must not take traffic while any predecessor's work is
        outstanding.  Returns a start report (per-worker replay reports).
        """
        if self._started:
            return {"schema": FLEET_SCHEMA, "workers": self.worker_ids()}
        self._started = True
        rec = get_run_record()
        rec.gauge("fleet.replay_complete", 0)
        self.journal_dir.mkdir(parents=True, exist_ok=True)
        self.store_dir.mkdir(parents=True, exist_ok=True)
        with rec.span("fleet.start", workers=self.n_workers,
                      mode=self.worker_mode):
            if self._join_addrs:
                # Socket peers need a wire path to the shared fragment
                # tier: serve this front door's store directory over the
                # mesh (its address rides each join hello).
                self._store_gateway = StoreGateway(
                    SharedSccStore(self.store_dir),
                )
            for i in range(self.n_workers):
                wid = f"w{i}"
                self._workers[wid] = self._make_worker(wid)
            for wid in sorted(self._join_addrs):
                joined = self._join_worker(wid, self._join_addrs[wid])
                if joined is not None:
                    self._workers[wid] = joined
            reports: Dict[str, object] = {}
            for wid, worker in self._workers.items():
                if not worker.wait_ready(timeout=120.0):
                    log.warning(
                        "fleet worker %s never reported replay-complete; "
                        "left out of the ring", wid,
                    )
                    continue
                reports[wid] = worker.replay_report
                with self._lock:
                    self._live.add(wid)
                    self._ring.add(wid)
                    self._leases[wid] = time.monotonic() + self.lease_s
        with self._lock:
            live, ring_size = len(self._live), len(self._ring)
        rec.gauge("fleet.workers_live", live)
        rec.gauge("fleet.ring_size", ring_size)
        rec.gauge("fleet.replay_complete", 1)
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="qi-fleet-probe", daemon=True,
        )
        self._probe_thread.start()
        log.info(
            "fleet started: %d/%d workers live (mode=%s, store=%s)",
            live, self.n_workers, self.worker_mode, self.store_dir,
        )
        return {
            "schema": FLEET_SCHEMA,
            "workers": self.worker_ids(),
            "mode": self.worker_mode,
            "replay": reports,
        }

    def _make_worker(
        self, wid: str,
    ) -> Union[ProcWorker, LocalWorker, "SocketWorker"]:
        """Construct one worker for slot/replacement id ``wid`` — shared
        by :meth:`start`, the auto-respawn path and the elastic scale-up
        path, so a replacement is configured byte-identically to the
        worker it replaces (only its journal file is fresh: the dead
        journal already failed over).  A join slot (``j<i>`` or its
        ``.r<n>`` replacement) REDIALS its peer address instead — the
        respawn machinery doubles as the mesh rejoin path."""
        addr = self._join_addrs.get(wid.split(".", 1)[0])
        if addr is not None:
            joined = self._join_worker(wid, addr)
            if joined is None:
                raise OSError(
                    f"re-join of {addr[0]}:{addr[1]} failed"
                )
            return joined
        make = ProcWorker if self.worker_mode == "subprocess" else LocalWorker
        return make(
            wid, self.journal_dir / f"{wid}.journal",
            self._on_response,
            backend=self.backend, store_dir=self.store_dir,
            deadline_s=self.deadline_s, batch_max=self.batch_max,
            cache_max=self.cache_max, queue_depth=self.queue_depth,
            dangling=self.dangling,
            scc_select=self.scc_select,
            scope_to_scc=self.scope_to_scc,
            on_exit=self._on_worker_exit,
            device=self.device,
        )

    def _join_worker(self, wid: str,
                     addr: Tuple[str, int]) -> Optional[SocketWorker]:
        """Dial one remote peer behind the ``fleet.join`` fault point:
        versioned handshake, deadline on the connect, bounded
        backoff+jitter retries.  A typed handshake reject
        (:class:`MeshHandshakeError`) PROPAGATES — a skewed mesh is
        refused, never retried into; wire/injected errors degrade to a
        fleet WITHOUT this peer (standalone workers keep serving),
        loudly (``fleet.join_errors`` + ``fleet.join_degraded``)."""
        rec = get_run_record()
        store = self._store_gateway
        last: Optional[Exception] = None
        for attempt in range(3):
            if attempt:
                # Bounded backoff+jitter: a rebooting peer gets breathing
                # room, a blip retries almost immediately.
                time.sleep(
                    min(0.1 * (2 ** (attempt - 1)), 1.0)
                    * (1.0 + random.random())
                )
            worker: Optional[SocketWorker] = None
            try:
                fault_point("fleet.join")
                worker = SocketWorker(
                    wid, addr, self._on_response,
                    store_port=store.port if store is not None else None,
                    on_exit=self._on_worker_exit,
                )
                if not worker.wait_ready(timeout=120.0):
                    err = worker.handshake_error
                    worker.kill()
                    if err is not None:
                        raise MeshHandshakeError(
                            str(err.get("code") or "hello_err"),
                            str(err.get("message") or ""),
                        )
                    raise OSError("join handshake timed out")
                rec.add("fleet.joins")
                rec.event("fleet.joined", worker=wid,
                          addr=f"{addr[0]}:{addr[1]}")
                log.info("fleet worker %s joined from %s:%d", wid,
                         addr[0], addr[1])
                return worker
            except MeshHandshakeError:
                raise
            except (FaultInjected, OSError, ValueError) as exc:
                last = exc
                if worker is not None:
                    worker.kill()
        rec.add("fleet.join_errors")
        rec.event("fleet.join_degraded", worker=wid, error=str(last))
        log.warning(
            "fleet join %s (%s:%d) failed after retries (%s); continuing "
            "without this peer", wid, addr[0], addr[1], last,
        )
        return None

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Close admission, drain (or kill) every worker, resolve whatever
        is left with a typed error — a fleet stop is never a silent drop."""
        with self._lock:
            self._closed = True
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=self.probe_interval_s + 5.0)
        for worker in list(self._workers.values()):
            if drain:
                worker.close(timeout=timeout)
            else:
                worker.kill()
        if self._store_gateway is not None:
            self._store_gateway.stop()
            self._store_gateway = None
        with self._lock:
            leftovers = list(self._pending.values())
            self._pending.clear()
        rec = get_run_record()
        for pending in leftovers:
            if not pending.internal:
                rec.add("fleet.errors")
            pending.ticket._resolve(("err", ServeError(
                "fleet stopped before this request resolved"
            )))
            self._note_replay_resolved(pending)
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None

    # ---- admission / routing ---------------------------------------------

    def submit(
        self,
        source: Union[str, bytes, List[Dict[str, object]], Fbas],
        *,
        request_id: Optional[str] = None,
        deadline_s: Optional[float] = None,
        query: Optional[object] = None,
        trace: Optional[str] = None,
        client: Optional[str] = None,
    ) -> Ticket:
        """Admit one request: fingerprint, route, dispatch.  Same contract
        as ``ServeEngine.submit`` (typed errors, Ticket immediately).
        ``query`` (qi-query/1) extends the ROUTING key with the query
        kind + params, so identical snapshots asked different questions
        route (and coalesce) independently — fingerprints never cross
        query types fleet-wide either.

        ``trace`` (qi-pulse): an upstream client's wire trace context.
        The front door's ``fleet.request`` span adopts it (grafting under
        the client's span), then re-stamps the wire with its OWN span as
        the workers' remote parent — the chain stays one trace end to
        end: client → front door request span → worker spans."""
        rec = get_run_record()
        client_ctx = TraceContext.from_env(trace) if trace else None
        with self._lock:
            closed = self._closed
        if closed:
            rec.add("fleet.errors")
            raise ServeError("fleet is closed to new requests")
        request_id = (
            request_id
            or f"flt-{os.getpid()}-{time.monotonic_ns():x}"
        )
        # The front-door REQUEST SPAN (qi-pulse): it covers
        # fingerprint + route + dispatch, and its span id — stamped into
        # the wire "trace" field in the QI_TRACE_CONTEXT format — is the
        # remote parent every worker span for this request grafts under,
        # so one fleet request renders as one cross-process trace.
        with rec.adopted(client_ctx), rec.span(
            "fleet.request", request_id=request_id,
        ) as req_span:
            parsed_query = (
                query if isinstance(query, Query) else Query.parse(query)
            )
            fbas = source if isinstance(source, Fbas) else parse_fbas(source)
            nodes = _raw_nodes(source, fbas)
            graph = build_graph(fbas, dangling=self.dangling)
            fp = snapshot_fingerprint(
                graph, scc_select=self.scc_select,
                scope_to_scc=self.scope_to_scc,
            )
            qfp = parsed_query.fingerprint()
            if qfp:
                fp = f"{fp}:q:{qfp}"
            ticket = Ticket(request_id, time.monotonic(), deadline_t=None)
            pending = _Pending(
                ticket=ticket, wire_id=request_id, fingerprint=fp,
                nodes=nodes,
                deadline_s=deadline_s if deadline_s is not None
                else self.deadline_s,
                query=parsed_query.to_wire(),
                trace=TraceContext(
                    client_ctx.trace_id if client_ctx is not None
                    else rec.trace_id,
                    req_span.span_id, rec.pid,
                ).to_env(),
                client=client,
            )
            with self._lock:
                # A client may reuse a request_id while the first request
                # is still in flight (the serve contract answers every
                # submission): give the duplicate a unique wire id so the
                # earlier pending entry is never orphaned — both tickets
                # resolve, the client-facing request_id stays its own.
                n = 0
                while pending.wire_id in self._pending:
                    n += 1
                    pending.wire_id = f"{request_id}~dup{n}"
                self._pending[pending.wire_id] = pending
            rec.add("fleet.requests")
            self._dispatch(pending)
        return ticket

    def _route(self, fingerprint: str) -> str:
        """One ring lookup behind the ``fleet.route`` fault point: an
        injected/real failure degrades to the first live worker — only
        fleet-wide coalescing locality is lost, loudly."""
        rec = get_run_record()
        try:
            fault_point("fleet.route")
            with self._lock:
                return self._ring.route(fingerprint)
        except (FaultInjected, OSError) as exc:
            rec.add("fleet.route_errors")
            rec.event("fleet.route_degraded", error=str(exc))
            log.warning(
                "ring routing failed (%s); degrading to first live worker",
                exc,
            )
            with self._lock:
                live = sorted(self._live)
            if not live:
                raise LookupError("no live fleet workers") from exc
            return live[0]

    def _dispatch(self, pending: _Pending) -> None:
        """Route-and-send with bounded retry: a dead worker discovered at
        dispatch time is evicted (its journal replays) and the request
        re-routes through the shrunken ring."""
        rec = get_run_record()
        rid = pending.wire_id
        route_t0 = time.perf_counter()
        try:
            self._dispatch_inner(pending, rec, rid)
        finally:
            # Stage histogram (qi-pulse): ring lookup + wire write per
            # dispatch attempt chain (failover re-dispatches book again).
            rec.histogram("pulse.route_ms").observe(
                (time.perf_counter() - route_t0) * 1000.0
            )

    def _dispatch_inner(self, pending: _Pending, rec: RunRecord,
                        rid: str) -> None:
        for _ in range(len(self._workers) + 1):
            try:
                wid = self._route(pending.fingerprint)
            except LookupError:
                break
            with self._lock:
                if self._pending.get(rid) is not pending:
                    return  # already resolved or superseded
                pending.worker_id = wid
            _fleet_sync("route.resolved")
            with self._lock:
                if pending.worker_id != wid:
                    return  # a concurrent failover re-routed it already
                worker = self._workers.get(wid) if wid in self._live else None
                suspected = wid in self._suspected
            if worker is not None and suspected:
                # The arc owner is under suspicion (missed heartbeats on
                # a live connection): hedge instead of betting on it.
                if self._hedge_dispatch(pending, wid, worker, rec, rid):
                    return
            elif worker is not None and worker.submit(
                rid, pending.nodes, pending.deadline_s, pending.query,
                pending.trace, pending.client,
            ):
                rec.add("fleet.routed")
                return
            self._handle_worker_death(wid, "dispatch failed")
            with self._lock:
                if (self._pending.get(rid) is not pending
                        or pending.worker_id != wid):
                    return  # the failover replay re-dispatched it
        with self._lock:
            still_mine = self._pending.pop(rid, None) is pending
        if still_mine:
            if not pending.internal:
                rec.add("fleet.errors")
            pending.ticket._resolve(("err", ServeError(
                "no live fleet workers to route this request to"
            )))
            self._note_replay_resolved(pending)

    # ---- hedged dispatch (qi-mesh) ---------------------------------------

    def _next_arc_owner(
        self, fingerprint: str, exclude: Set[str],
    ) -> Optional[Tuple[str, Union[ProcWorker, LocalWorker, SocketWorker]]]:
        """The next LIVE, unsuspected worker on the ring after the
        excluded arc owner(s) — the hedge secondary."""
        with self._lock:
            skip = set(exclude) | self._suspected | {
                w for w in self._ring.workers() if w not in self._live
            }
            wid = self._ring.route_excluding(fingerprint, skip)
            worker = self._workers.get(wid) if wid is not None else None
        if wid is None or worker is None:
            return None
        return (wid, worker)

    def _hedge_dispatch(self, pending: _Pending, wid: str,
                        worker: Union[ProcWorker, LocalWorker, SocketWorker],
                        rec: RunRecord, rid: str) -> bool:
        """Dispatch to a SUSPECTED primary and simultaneously to the next
        live arc owner under the SAME wire id: whichever answers first
        resolves the client ticket, the straggler's answer books
        ``fleet.duplicate_responses`` — the failover dedup IS the hedge
        dedup, so a primary that rejoins mid-hedge cannot double-answer.
        The ``fleet.hedge`` fault point degrades to a SINGLE dispatch to
        the secondary (one bet on the healthy peer, none on the
        suspect).  Every exit books exactly one of ``fleet.hedges`` /
        ``fleet.hedge_errors`` (conservation: a hedge decision is
        never silent); ``False`` sends the caller down the
        worker-death/re-route path."""
        _fleet_sync("hedge.decided")
        secondary = self._next_arc_owner(pending.fingerprint, {wid})
        try:
            fault_point("fleet.hedge")
        except (FaultInjected, OSError) as exc:
            rec.add("fleet.hedge_errors")
            rec.event("fleet.hedge_degraded", worker=wid, error=str(exc))
            log.warning(
                "hedge degraded (%s): single dispatch to the next arc "
                "owner", exc,
            )
            twid, tworker = secondary if secondary is not None else (
                wid, worker,
            )
            with self._lock:
                pending.worker_id = twid
            if tworker.submit(rid, pending.nodes, pending.deadline_s,
                              pending.query, pending.trace, pending.client):
                rec.add("fleet.routed")
                return True
            return False
        sent = 0
        if worker.submit(rid, pending.nodes, pending.deadline_s,
                         pending.query, pending.trace, pending.client):
            sent += 1
        if secondary is not None:
            swid, sworker = secondary
            if sworker.submit(rid, pending.nodes, pending.deadline_s,
                              pending.query, pending.trace, pending.client):
                sent += 1
                with self._lock:
                    # Failover bookkeeping follows the HEALTHY secondary:
                    # if the suspect lapses, this request is already owned
                    # by a live peer and must not re-dispatch.
                    pending.worker_id = swid
        if not sent:
            rec.add("fleet.hedge_errors")
            rec.event("fleet.hedge_degraded", worker=wid,
                      error="neither hedge leg accepted the request")
            return False
        rec.add("fleet.hedges")
        rec.add("fleet.routed")
        rec.event(
            "fleet.hedged", worker=wid,
            secondary=secondary[0] if secondary is not None else "",
            legs=sent,
        )
        _fleet_sync("hedge.sent")
        return True

    # ---- responses -------------------------------------------------------

    def _on_response(self, worker_id: str, obj: Dict[str, object]) -> None:
        rec = get_run_record()
        rid = obj.get("request_id")
        with self._lock:
            pending = (
                self._pending.pop(rid, None) if isinstance(rid, str) else None
            )
        if pending is None:
            # A late answer for a request that already failed over or was
            # hedged (two workers solved it): the first resolution won,
            # the client never sees two outcomes.
            rec.add("fleet.duplicate_responses")
            return
        _fleet_sync("response.delivered")
        err = obj.get("error")
        if isinstance(err, dict):
            exc = ServeError(str(err.get("message") or "upstream serve error"))
            exc.code = str(err.get("code") or ServeError.code)  # type: ignore[assignment]
            if not pending.internal:
                rec.add("fleet.errors")
            pending.ticket._resolve(("err", exc))
            self._note_replay_resolved(pending)
            return
        seconds = time.monotonic() - pending.ticket.submitted_t
        cert = obj.get("cert")
        stats = obj.get("stats")
        result = obj.get("result")
        wire_trace = obj.get("trace")
        response = ServeResponse(
            # The CLIENT's id, not the wire id (a deduplicated duplicate
            # answers under the id its client actually sent).
            request_id=pending.ticket.request_id,
            intersects=bool(obj.get("verdict")),
            cert=cert if isinstance(cert, dict) else None,
            stats=dict(stats) if isinstance(stats, dict) else {},
            cached=bool(obj.get("cached")),
            seconds=seconds,
            result=result if isinstance(result, dict) else None,
            # Trace echo (qi-pulse): the worker echoes the context this
            # front door stamped; fall back to the pending record so the
            # client sees the trace even from a pre-pulse worker.
            trace=(wire_trace if isinstance(wire_trace, str)
                   else pending.trace),
            # qi-cost echo: the worker's attributed cost rides the wire
            # line; absent from pre-cost workers, cache hits and degraded
            # attribution — the response shape stays byte-compatible.
            cost=(obj.get("cost")
                  if isinstance(obj.get("cost"), dict) else None),
        )
        if not pending.internal:
            rec.add("fleet.verdicts")
            self._note_latency(seconds)
        else:
            rec.add("fleet.replayed_verdicts")
        pending.ticket._resolve(("ok", response))
        self._note_replay_resolved(pending)

    def _note_replay_resolved(self, pending: _Pending) -> None:
        """One failover-dispatched request reached its outcome; flip
        ``fleet.replay_complete`` back to 1 only when NO failover is mid-
        replay and every inherited request has resolved — the /readyz 503
        window covers the re-SOLVE of inherited work, not just its
        re-dispatch."""
        with self._lock:
            if not pending.replaying:
                return
            pending.replaying = False
            self._replays_outstanding -= 1
            done = (
                self._replays_outstanding == 0
                and self._failovers_active == 0
            )
        if done:
            get_run_record().gauge("fleet.replay_complete", 1)

    def _note_latency(self, seconds: float) -> None:
        # Front-door end-to-end histogram (qi-pulse): submit→delivery as
        # the CLIENT experienced it.  The fleet.p50_ms/p99_ms gauges stay
        # byte-compatible — same nearest-rank estimator over the same
        # 512-sample window the pre-pulse deque carried.
        rec = get_run_record()
        h = rec.histogram("pulse.fleet_e2e_ms")
        h.observe(seconds * 1000.0)
        rec.gauge("fleet.p50_ms", round(h.window_percentile(50.0), 3))
        rec.gauge("fleet.p99_ms", round(h.window_percentile(99.0), 3))

    # ---- health probing / eviction ---------------------------------------

    def _on_worker_exit(self, worker_id: str) -> None:
        self._handle_worker_death(worker_id, "stdout EOF")

    def _probe_loop(self) -> None:
        rec = get_run_record()
        fails: Dict[str, int] = {}
        while not self._stop.wait(self.probe_interval_s):
            _fleet_sync("probe.tick")
            with self._lock:
                targets = [
                    (wid, self._workers[wid]) for wid in sorted(self._live)
                ]
            pongs: Dict[str, Dict[str, object]] = {}
            for wid, worker in targets:
                # The liveness check runs BEFORE the fault point: a dead
                # process must evict even while the probe path is broken
                # (the FLEET_PROBE contract — only the ping half degrades).
                if not worker.alive():
                    self._handle_worker_death(wid, "process exited")
                    continue
                try:
                    fault_point("fleet.probe")
                except (FaultInjected, OSError) as exc:
                    # Inconclusive, not dead: an injected probe failure
                    # must never cost a healthy worker its ring arc.
                    rec.add("fleet.probe_errors")
                    rec.event("fleet.probe_degraded", worker=wid,
                              error=str(exc))
                    continue
                pong = worker.ping(timeout=2.0)
                if pong is None:
                    fails[wid] = fails.get(wid, 0) + 1
                    rec.add("fleet.probe_timeouts")
                    if fails[wid] >= self.probe_fails:
                        reason = f"{fails[wid]} consecutive failed probes"
                        if worker.kind == "socket":
                            # A live-connection socket peer that stops
                            # ponging is PARTITIONED, not dead: suspect
                            # (hedged routing) and let the lease decide.
                            self._suspect_worker(wid, reason)
                        else:
                            self._handle_worker_death(wid, reason)
                else:
                    fails[wid] = 0
                    pongs[wid] = pong
                    self._renew_lease(wid)
            self._aggregate_health(pongs)
            self._expire_leases()
            self.scale_tick()

    # ---- partition tolerance: suspect → hedge → lease (qi-mesh) ----------

    def _suspect_worker(self, wid: str, reason: str) -> None:
        """Missed heartbeats on a SOCKET peer mean *suspected*, never
        immediately dead — a partition heals where a dead process does
        not.  A suspect keeps its ring arc, but every request routed to
        it is HEDGED to the next arc owner until it pongs again (rejoin)
        or its lease lapses (eviction + journal ship)."""
        rec = get_run_record()
        with self._lock:
            if wid in self._suspected or wid not in self._live:
                return
            self._suspected.add(wid)
            n_susp = len(self._suspected)
        rec.add("fleet.suspects")
        rec.gauge("fleet.suspected", n_susp)
        rec.event("fleet.suspected", worker=wid, reason=reason)
        log.warning(
            "fleet worker %s suspected (%s); its requests hedge to the "
            "next arc owner until it pongs or its %.3gs lease lapses",
            wid, reason, self.lease_s,
        )

    def _renew_lease(self, wid: str) -> None:
        """A pong renews the worker's heartbeat lease; a SUSPECTED worker
        answering again is a REJOIN — it takes its ring arc back, and its
        in-flight hedges deduplicate by wire request id (first answer
        resolves the ticket, the straggler books
        ``fleet.duplicate_responses``)."""
        rec = get_run_record()
        with self._lock:
            self._leases[wid] = time.monotonic() + self.lease_s
            rejoined = wid in self._suspected
            if rejoined:
                self._suspected.discard(wid)
                n_susp = len(self._suspected)
        if rejoined:
            rec.add("fleet.rejoins")
            rec.gauge("fleet.suspected", n_susp)
            rec.event("fleet.rejoined", worker=wid)
            log.info("fleet worker %s rejoined; suspicion lifted", wid)

    def _expire_leases(self) -> None:
        """Evict suspected peers whose heartbeat lease lapsed — behind
        the ``fleet.lease`` fault point, which degrades to SUSPECT-ONLY:
        a broken lease clock must never evict a healthy-but-slow peer
        (hedging keeps its requests answered), while a DEAD connection
        still evicts immediately through the reader-EOF path."""
        rec = get_run_record()
        now = time.monotonic()
        with self._lock:
            lapsed = [
                wid for wid in sorted(self._suspected)
                if wid in self._live and now > self._leases.get(wid, 0.0)
            ]
        if not lapsed:
            return
        try:
            fault_point("fleet.lease")
        except (FaultInjected, OSError) as exc:
            rec.add("fleet.lease_errors")
            rec.event("fleet.lease_degraded", error=str(exc))
            log.warning(
                "lease-lapse check degraded (%s); lapsed peers stay "
                "suspect-only (hedged) this cycle", exc,
            )
            return
        for wid in lapsed:
            self._handle_worker_death(wid, "heartbeat lease lapsed")

    # ---- elasticity (qi-mesh) --------------------------------------------

    def scale_tick(self, *, force: bool = False) -> Optional[str]:
        """One elasticity decision — the probe loop calls this every
        cycle when ``QI_FLEET_SCALE_INTERVAL_S`` > 0 (rate-limited to
        that cadence); tests and the bench drive it deterministically
        with ``force=True``.  Returns "up" / "down" / ``None``."""
        if not force:
            if self.scale_interval_s <= 0:
                return None
            now = time.monotonic()
            with self._lock:
                if now < self._next_scale_t or self._closed:
                    return None
                self._next_scale_t = now + self.scale_interval_s
        return self._apply_scale()

    def _apply_scale(self) -> Optional[str]:
        """The pulse→fleet-size control loop: the fleet-MERGED queue-wait
        p99 (the aggregation plane's ``fleet.pulse.queue_wait_ms``) plus
        the SLO plane's burn count turn into a spawn / retire / hold
        decision, bounded by ``QI_FLEET_SCALE_MIN``/``_MAX``.  Behind the
        ``fleet.scale`` fault point: any failure FREEZES the fleet at its
        current size, loudly.  Every exit books exactly one of
        ``fleet.scale_ups`` / ``fleet.scale_downs`` /
        ``fleet.scale_holds`` / ``fleet.scale_errors`` (the
        conservation law: a scale decision is never silent)."""
        rec = get_run_record()
        try:
            fault_point("fleet.scale")
            p99 = rec.histogram("fleet.pulse.queue_wait_ms").quantile_ms(99.0)
            from quorum_intersection_tpu_torch.cost import slo_plane

            burning = slo_plane().burning_count()
            with self._lock:
                live = len(self._live)
            if (p99 > self.scale_up_ms or burning) and live < self.scale_max:
                wid = self._spawn_elastic()
                if wid is None:
                    rec.add("fleet.scale_errors")
                    rec.event("fleet.scale_degraded",
                              error="elastic spawn failed")
                    log.warning(
                        "elasticity degraded (elastic spawn failed); "
                        "fleet size frozen at its current size",
                    )
                    return None
                rec.add("fleet.scale_ups")
                rec.event("fleet.scaled", direction="up", worker=wid,
                          queue_p99_ms=round(p99, 3), burning=burning)
                log.info(
                    "fleet scaled UP to %s (queue p99 %.1fms, %d SLO "
                    "target(s) burning)", wid, p99, burning,
                )
                return "up"
            if (p99 < self.scale_down_ms and not burning
                    and live > self.scale_min):
                wid = self._retire_one()
                if wid is not None:
                    rec.add("fleet.scale_downs")
                    rec.event("fleet.scaled", direction="down", worker=wid,
                              queue_p99_ms=round(p99, 3))
                    log.info(
                        "fleet scaled DOWN (%s drained + retired, queue "
                        "p99 %.1fms)", wid, p99,
                    )
                    return "down"
            rec.add("fleet.scale_holds")
            return None
        except (FaultInjected, OSError, ValueError) as exc:
            rec.add("fleet.scale_errors")
            rec.event("fleet.scale_degraded", error=str(exc))
            log.warning(
                "elasticity degraded (%s); fleet size frozen at its "
                "current size", exc,
            )
            return None

    def _spawn_elastic(self) -> Optional[str]:
        """Scale-up: one fresh ``e<n>`` worker through the same
        construction + ready gate the respawn machinery uses, spawned
        synchronously (the scale loop already runs off the probe
        thread, never on a request path)."""
        with self._lock:
            self._elastic_seq += 1
            wid = f"e{self._elastic_seq}"
        worker = self._make_worker(wid)
        if not worker.wait_ready(timeout=120.0):
            worker.kill()
            return None
        with self._lock:
            arrived_dead = self._closed
            if not arrived_dead:
                self._workers[wid] = worker
                self._live.add(wid)
                self._ring.add(wid)
                self._leases[wid] = time.monotonic() + self.lease_s
                live, ring_size = len(self._live), len(self._ring)
        if arrived_dead:
            worker.kill()
            return None
        rec = get_run_record()
        rec.gauge("fleet.workers_live", live)
        rec.gauge("fleet.ring_size", ring_size)
        return wid

    def _retire_one(self) -> Optional[str]:
        """Scale-down by DRAIN-THROUGH-JOURNAL-INHERITANCE: admission to
        the retiree closes first (ring + live removal, so a racing
        dispatch re-routes through the shrunken ring), it drains
        gracefully (every accepted request answers), and then its journal
        — local file, or SHIPPED over the wire for a socket peer — runs
        the standard failover dedup: zero lost, zero duplicated, the
        kill-one-of-N guarantee extended to voluntary shrink.  Prefers the
        newest elastic (``e<n>``) worker; never touches the last
        ``scale_min``."""
        rec = get_run_record()
        with self._lock:
            if len(self._live) <= self.scale_min:
                return None
            order = sorted(self._live, reverse=True)
            elastic = [w for w in order if w.startswith("e")]
            target = (elastic or order)[0]
            self._live.discard(target)
            self._ring.remove(target)
            # The voluntary close below must not re-enter death handling
            # when the reader thread sees its EOF.
            self._dead_handled.add(target)
            self._suspected.discard(target)
            self._leases.pop(target, None)
            live, ring_size = len(self._live), len(self._ring)
        rec.gauge("fleet.workers_live", live)
        rec.gauge("fleet.ring_size", ring_size)
        rec.gauge("fleet.suspected", len(self._suspected))
        _fleet_sync("scale.retire")
        worker = self._workers.get(target)
        if worker is None:
            return target
        journal: Optional[Path] = worker.journal_path
        if isinstance(worker, SocketWorker):
            # Quiesce, then pull the journal BEFORE closing the wire —
            # after the half-close there is nothing left to ship over.
            self._await_quiesce(target, timeout=30.0)
            journal = self._ship_journal(worker)
            worker.close(timeout=30.0)
        else:
            worker.close(timeout=60.0)
        self._failover(target, journal)
        return target

    def _await_quiesce(self, wid: str, timeout: float) -> None:
        """Bounded wait for every in-flight request assigned to ``wid``
        to resolve (their responses are still flowing on the open
        connection); leftovers after the bound re-route through the
        failover path anyway — bounded staleness, never a lost ticket."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                busy = any(
                    p.worker_id == wid for p in self._pending.values()
                )
            if not busy:
                return
            time.sleep(0.02)

    def _ship_journal(self, worker: SocketWorker) -> Optional[Path]:
        """Pull a remote peer's crash-only journal over the wire before
        its failover replay (chunked + digest-checked + fsync-before-ack
        in :meth:`SocketWorker.ship_journal`).  The ``fleet.ship`` fault
        point — or a wire already dead — degrades to LOCAL-JOURNAL-ONLY
        failover, loudly: the front door's own in-flight tickets still
        re-route (zero lost for everything it admitted), and the peer's
        journaled-but-unshipped work waits for its host to rejoin.
        Every exit books exactly one of ``fleet.ships`` /
        ``fleet.ship_errors`` (conservation)."""
        rec = get_run_record()
        with rec.span("fleet.ship", worker=worker.worker_id):
            spool: Optional[Path] = None
            try:
                fault_point("fleet.ship")
                spool = worker.ship_journal(self.journal_dir / "shipped")
            except (FaultInjected, OSError) as exc:
                rec.add("fleet.ship_errors")
                rec.event("fleet.ship_degraded", worker=worker.worker_id,
                          error=str(exc))
                log.warning(
                    "journal ship from %s degraded (%s); failover "
                    "re-routes the front door's own in-flight tickets "
                    "only", worker.worker_id, exc,
                )
                return None
            if spool is None:
                rec.add("fleet.ship_errors")
                rec.event("fleet.ship_degraded", worker=worker.worker_id,
                          error="wire broken or stream torn")
                log.warning(
                    "journal ship from %s degraded (wire broken or stream "
                    "torn); failover re-routes the front door's own "
                    "in-flight tickets only", worker.worker_id,
                )
                return None
            rec.add("fleet.ships")
            rec.event("fleet.shipped", worker=worker.worker_id,
                      path=str(spool))
            return spool

    def _aggregate_health(self, pongs: Dict[str, Dict[str, object]]) -> None:
        """Fold the workers' pong snapshots into the fleet gauges the
        front door's ``/healthz`` exposes (fleet_workers_live /
        fleet_ring_size / fleet_store_hit_pct)."""
        rec = get_run_record()
        with self._lock:
            # Retain the last-known pong per STILL-LIVE worker: a single
            # missed ping (or one slow cycle) must not drop that worker
            # from the merged histograms — counts on /metrics would go
            # backwards and Prometheus rate() would read the dip+bounce
            # as a counter reset.  Evicted workers are pruned here.
            retained = {
                wid: pong for wid, pong in self._pongs.items()
                if wid in self._live
            }
            retained.update(pongs)
            self._pongs = retained
            live, ring_size = len(self._live), len(self._ring)
        rec.gauge("fleet.workers_live", live)
        rec.gauge("fleet.ring_size", ring_size)
        hits = misses = 0
        d_hits = d_misses = 0
        for pong in pongs.values():
            counters = pong.get("counters")
            if not isinstance(counters, dict):
                continue
            hits += int(counters.get("fleet.store_hits", 0) or 0)
            misses += int(counters.get("fleet.store_misses", 0) or 0)
            d_hits += int(counters.get("delta.scc_hits", 0) or 0)
            d_misses += int(counters.get("delta.scc_misses", 0) or 0)
        if hits + misses:
            rec.gauge(
                "fleet.store_hit_pct",
                round(100.0 * hits / (hits + misses), 2),
            )
        if d_hits + d_misses:
            rec.gauge(
                "fleet.delta_scc_reuse_pct",
                round(100.0 * d_hits / (d_hits + d_misses), 2),
            )
        # The pulse merge covers every live worker's LAST-KNOWN pong, not
        # just this cycle's successes, so the merged view is monotonic
        # between evictions.
        self._aggregate_pulse(retained, rec)
        self._aggregate_cost(retained, rec)

    def _aggregate_pulse(self, pongs: Dict[str, Dict[str, object]],
                         rec: RunRecord) -> None:
        """The qi-pulse aggregation plane: merge the workers'
        pong-carried pulse histogram snapshots bucket-wise into the front
        door's ``fleet.pulse.*`` views — mergeable by construction, so
        the fleet-wide p99 is computed over the UNION of worker samples,
        not the max of per-worker gauges.  Behind the ``pulse.aggregate``
        fault point: any failure degrades this CYCLE to per-worker-only
        metrics (loud counters, stale fleet view) and can never touch a
        verdict — aggregation sits entirely off the request path."""
        if not self._pulse_agg or not pongs:
            return
        try:
            fault_point("pulse.aggregate")
            # One snapshot per distinct worker PROCESS: in local-worker
            # mode every in-process engine shares one RunRecord, so N
            # pongs alias the same histograms — summing them would
            # multiply the fleet view N-fold.  Keyed by the pong's pid,
            # subprocess fleets (distinct pids) merge every worker.
            by_pid: Dict[str, Dict[object, Dict[str, object]]] = {}
            for pong in pongs.values():
                pulse = pong.get("pulse")
                if not isinstance(pulse, dict):
                    continue
                for name, snap in pulse.items():
                    if isinstance(snap, dict):
                        by_pid.setdefault(str(name), {})[
                            pong.get("pid")] = snap
            for name, snaps in sorted(by_pid.items()):
                merged = Histogram.merge_wire(list(snaps.values()))
                rec.histogram(f"fleet.{name}").set_from_wire(merged)
            if "pulse.e2e_ms" in by_pid:
                rec.gauge(
                    "fleet.e2e_p99_ms",
                    rec.histogram("fleet.pulse.e2e_ms").quantile_ms(99.0),
                )
        except (FaultInjected, OSError, ValueError, TypeError, KeyError) as exc:
            rec.add("pulse.agg_errors")
            rec.event("pulse.agg_degraded", error=str(exc))
            log.warning(
                "pulse aggregation degraded this cycle (%s); per-worker "
                "metrics remain available", exc,
            )

    def _aggregate_cost(self, pongs: Dict[str, Dict[str, object]],
                        rec: RunRecord) -> None:
        """The qi-cost aggregation plane: merge the workers'
        pong-carried per-tenant cost snapshots into the front door's
        fleet-wide tenant table.  Same pid-dedupe rule as the pulse merge
        (local workers share one process table — summing N aliased pongs
        would multiply the view N-fold) and the merge REPLACES the fleet
        table each cycle: pong snapshots are cumulative, so accumulating
        them would double-count every prior cycle.  Behind the
        ``cost.attribute`` fault point: a failure degrades this CYCLE to
        per-worker tables only, never touches a verdict."""
        if not pongs:
            return
        try:
            fault_point("cost.attribute")
            from quorum_intersection_tpu_torch.cost import (
                fleet_tenant_table, merge_tenant_snapshots,
            )
            by_pid: Dict[object, Dict[str, Dict[str, object]]] = {}
            for pong in pongs.values():
                cost = pong.get("cost")
                if isinstance(cost, dict) and cost:
                    by_pid[pong.get("pid")] = cost  # type: ignore[assignment]
            if not by_pid:
                return
            merged = merge_tenant_snapshots(list(by_pid.values()))
            fleet_tenant_table().replace(merged)
            rec.gauge("fleet.cost_tenants", len(merged))
        except (FaultInjected, OSError, ValueError, TypeError, KeyError) as exc:
            rec.add("cost.attribute_errors")
            rec.event("cost.degraded", site="fleet.aggregate",
                      error=str(exc))
            log.warning(
                "cost aggregation degraded this cycle (%s); per-worker "
                "tables remain available", exc,
            )

    def healthz(self) -> Dict[str, object]:
        """The aggregated fleet health picture (per-worker last pongs +
        ring state) — the bench and tests read it; the qi-health/1
        endpoint exposes the gauge subset."""
        with self._lock:
            return {
                "schema": FLEET_SCHEMA,
                "workers_live": len(self._live),
                "ring_size": len(self._ring),
                "pending": len(self._pending),
                "suspected": sorted(self._suspected),
                "workers": dict(self._pongs),
            }

    def kill_worker(self, worker_id: str, *, evict: bool = False) -> None:
        """Hard-kill one worker (the bench's kill-one-of-N hook).  With
        ``evict=False`` (default) the health probes discover the death —
        the production path; ``evict=True`` runs eviction + journal
        failover immediately (the deterministic schedule/test path)."""
        worker = self._workers.get(worker_id)
        if worker is None:
            raise KeyError(f"unknown fleet worker {worker_id!r}")
        worker.kill()
        if evict:
            self._handle_worker_death(worker_id, "killed (explicit)")

    # ---- failover --------------------------------------------------------

    def _handle_worker_death(self, worker_id: str, reason: str) -> None:
        rec = get_run_record()
        with self._lock:
            if worker_id in self._dead_handled or worker_id not in self._live:
                return
            self._dead_handled.add(worker_id)
            self._live.discard(worker_id)
            self._ring.remove(worker_id)
            self._suspected.discard(worker_id)
            self._leases.pop(worker_id, None)
            live, ring_size = len(self._live), len(self._ring)
            n_susp = len(self._suspected)
        rec.add("fleet.evictions")
        rec.gauge("fleet.workers_live", live)
        rec.gauge("fleet.ring_size", ring_size)
        rec.gauge("fleet.suspected", n_susp)
        rec.event("fleet.evicted", worker=worker_id, reason=reason)
        log.warning(
            "fleet worker %s evicted (%s); its hash range and unfinished "
            "journal move to the surviving peers", worker_id, reason,
        )
        _fleet_sync("evict.removed")
        worker = self._workers.get(worker_id)
        journal = worker.journal_path if worker is not None else None
        if journal is None and isinstance(worker, SocketWorker):
            # A remote peer's journal lives on its host: ship it over the
            # wire while (if) the connection still answers — a lease
            # lapse often leaves a usable wire, a hard kill does not.
            journal = self._ship_journal(worker)
        self._failover(worker_id, journal)
        self._maybe_respawn(worker_id)

    # ---- auto-respawn ----------------------------------------------------

    def _maybe_respawn(self, dead_id: str) -> None:
        """Schedule a replacement for a dead worker's slot (without it the
        ring shrinks on every eviction until restart).  Bounded per slot by
        ``QI_FLEET_RESPAWN_MAX`` so a
        crash-looping configuration cannot respawn forever; the spawn
        itself runs off-thread with exponential backoff — eviction and
        failover never wait on a subprocess start."""
        slot = dead_id.split(".", 1)[0]
        with self._lock:
            if self._closed or self.respawn_max <= 0:
                return
            n = self._respawn_counts.get(slot, 0) + 1
            if n > self.respawn_max:
                exhausted = True
            else:
                exhausted = False
                self._respawn_counts[slot] = n
        if exhausted:
            get_run_record().event(
                "fleet.respawn_exhausted", worker=dead_id,
                max=self.respawn_max,
            )
            log.warning(
                "fleet worker slot %s exhausted its %d respawns; the ring "
                "stays shrunk for this slot", slot, self.respawn_max,
            )
            return
        new_id = f"{slot}.r{n}"
        threading.Thread(
            target=self._respawn_worker, args=(new_id, n),
            name=f"qi-fleet-respawn-{new_id}", daemon=True,
        ).start()

    def _respawn_worker(self, new_id: str, attempt: int) -> None:
        rec = get_run_record()
        # Bounded exponential backoff: a dying host gets breathing room,
        # a one-off crash gets its replacement almost immediately.
        time.sleep(min(0.1 * (2 ** (attempt - 1)), 2.0))
        with self._lock:
            if self._closed:
                return  # stop() won the backoff window; nothing to restore
        _fleet_sync("respawn.begin")
        try:
            worker = self._make_worker(new_id)
        except Exception as exc:  # noqa: BLE001 — a failed spawn must not kill the probe loop
            rec.add("fleet.respawn_errors")
            rec.event("fleet.respawn_failed", worker=new_id, error=str(exc))
            log.warning("fleet respawn %s failed (%s)", new_id, exc)
            return
        if not worker.wait_ready(timeout=120.0):
            rec.add("fleet.respawn_errors")
            rec.event("fleet.respawn_failed", worker=new_id,
                      error="never reported replay-complete")
            worker.kill()
            return
        with self._lock:
            arrived_dead = self._closed
            if not arrived_dead:
                self._workers[new_id] = worker
                self._live.add(new_id)
                self._ring.add(new_id)
                self._leases[new_id] = time.monotonic() + self.lease_s
                live, ring_size = len(self._live), len(self._ring)
        if arrived_dead:
            worker.kill()
            return
        rec.add("fleet.respawns")
        rec.gauge("fleet.workers_live", live)
        rec.gauge("fleet.ring_size", ring_size)
        rec.event("fleet.respawned", worker=new_id, attempt=attempt)
        log.info(
            "fleet worker %s respawned (attempt %d); ring restored to %d "
            "worker(s)", new_id, attempt, ring_size,
        )
        _fleet_sync("respawn.done")

    def adopt_journal(self, journal_path: Union[str, Path],
                      worker_id: str = "adopted") -> int:
        """Inherit a crashed predecessor's request journal: every
        journaled-but-unfinished request re-solves on the worker its hash
        range now belongs to.  Returns the number of requests replayed
        (the front-door-restart recovery path; also the schedule
        harness's deterministic failover entry).

        The path must be readable on THIS host — an unreadable or
        remote-host path raises the typed
        :class:`JournalUnreadableError` (code ``journal_unreadable``)
        pointing at the mesh ship protocol, instead of letting the
        ``fleet.replay`` degrade path silently swallow what is really a
        caller mistake."""
        path = Path(journal_path)
        try:
            with path.open("rb"):
                pass
        except OSError as exc:
            rec = get_run_record()
            rec.add("fleet.errors")
            rec.event("fleet.adopt_rejected", path=str(path),
                      error=str(exc))
            raise JournalUnreadableError(
                f"journal {path} is not readable on this host ({exc}); a "
                f"REMOTE peer's journal cannot be adopted by path — join "
                f"the peer over the mesh (serve --socket + fleet --join) "
                f"and let the ship_journal protocol stream it (chunked, "
                f"digest-checked, fsync-before-ack)"
            ) from exc
        return self._failover(worker_id, path)

    def _failover(self, worker_id: str,
                  journal_path: Optional[Path]) -> int:
        """Replay a dead worker's unfinished work on the peers inheriting
        its hash range: the front door's own in-flight tickets first
        (they re-route with their clients still attached), then the
        journal's pending entries (zero lost), deduplicated against both
        the in-flight set and the journal's done marks (zero duplicated).
        """
        rec = get_run_record()
        with self._lock:
            self._failovers_active += 1
        rec.gauge("fleet.replay_complete", 0)
        _fleet_sync("replay.begin")
        entries: List[Dict[str, object]] = []
        if journal_path is not None:
            try:
                fault_point("fleet.replay")
                journal = RequestJournal(journal_path)
                scanned, corrupt, torn = journal.scan()
                done_ids = {
                    e.get("request_id") for e in scanned
                    if e.get("kind") == "done"
                }
                entries = [
                    e for e in scanned
                    if e.get("kind") == "req"
                    and e.get("request_id") not in done_ids
                ]
                if torn:
                    rec.add("fleet.replay_torn_tails")
                if corrupt:
                    journal.quarantine(
                        corrupt, "corrupt line in a dead worker's journal",
                    )
            except (FaultInjected, OSError) as exc:
                rec.add("fleet.replay_errors")
                rec.event("fleet.replay_degraded", worker=worker_id,
                          error=str(exc))
                log.warning(
                    "dead worker %s journal unreadable (%s); failover "
                    "degrades to re-routing the front door's own in-flight "
                    "tickets only", worker_id, exc,
                )
                entries = []
        with self._lock:
            local = [
                p for p in self._pending.values()
                if p.worker_id == worker_id
            ]
        replayed = 0
        seen: Set[str] = set()
        with rec.span("fleet.replay", worker=worker_id,
                      inflight=len(local), journaled=len(entries)):
            for pending in local:
                seen.add(pending.wire_id)
                with self._lock:
                    # Flag + counter move together under the lock, and
                    # only while the entry is still unresolved — a ticket
                    # resolving concurrently must not leave the
                    # outstanding count stuck above zero.
                    if (self._pending.get(pending.wire_id) is pending
                            and not pending.replaying):
                        pending.replaying = True
                        self._replays_outstanding += 1
                self._dispatch(pending)
                replayed += 1
            for entry in entries:
                rid = entry.get("request_id")
                nodes = entry.get("nodes")
                if (not isinstance(rid, str) or rid in seen
                        or not isinstance(nodes, list)):
                    continue
                seen.add(rid)
                with self._lock:
                    known = rid in self._pending
                if known:
                    continue  # already re-routed under a different owner
                entry_query = entry.get("query")
                entry_trace = entry.get("trace")
                pending = _Pending(
                    ticket=Ticket(rid, time.monotonic(), None),
                    wire_id=rid,
                    fingerprint=str(entry.get("fingerprint") or rid),
                    nodes=nodes,
                    deadline_s=None,  # its original budget is long since moot
                    internal=True,
                    replaying=True,
                    # Inherited typed queries re-ask the SAME question on
                    # the inheriting peer (the journal carries the wire
                    # form; the fingerprint already keys the kind).
                    query=(entry_query
                           if isinstance(entry_query, dict) else None),
                    # qi-pulse: the dead worker journaled the original
                    # wire trace — the inheriting peer's re-solve joins
                    # the request's trace, not a fresh one.
                    trace=(entry_trace
                           if isinstance(entry_trace, str) else None),
                )
                with self._lock:
                    self._pending[rid] = pending
                    self._replays_outstanding += 1
                _fleet_sync("replay.dispatch")
                self._dispatch(pending)
                replayed += 1
        if replayed:
            rec.add("fleet.replays", replayed)
        rec.event("fleet.replayed", worker=worker_id, requests=replayed)
        _fleet_sync("replay.done")
        with self._lock:
            self._failovers_active -= 1
            done = (
                self._replays_outstanding == 0
                and self._failovers_active == 0
            )
        if done:
            rec.gauge("fleet.replay_complete", 1)
        return replayed


# ---- CLI subcommand ---------------------------------------------------------


def build_fleet_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m quorum_intersection_tpu_torch fleet",
        description=(
            "Replicated snapshot-verdict service: N serve workers behind "
            "a consistent-hash front door.  Same JSONL contract as the "
            "serve subcommand — one JSON request per stdin line, one JSON "
            "response per stdout line in completion order; EOF drains "
            "every worker and exits 0."
        ),
    )
    p.add_argument("-n", "--workers", type=int, default=None, metavar="N",
                   help="worker count (env twin: QI_FLEET_WORKERS)")
    p.add_argument("--journal-dir", metavar="DIR", default=None,
                   help="directory of the per-worker crash-only request "
                        "journals (default: a temporary directory); a "
                        "dead worker's unfinished journal replays on the "
                        "peer inheriting its hash range")
    p.add_argument("--store-dir", metavar="DIR", default=None,
                   help="shared SCC-fragment store directory exported to "
                        "every worker (env twin: QI_FLEET_STORE_DIR; "
                        "default: <journal-dir>/store)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "gpu-sweep", "gpu-frontier", "cpp", "python"],
                   help="search backend inside each worker (default auto)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every worker's solves run (default cuda: the "
                        "card; there is no silent fall back to the host)")
    p.add_argument("--local-workers", action="store_true",
                   help="run the workers in-process instead of as "
                        "subprocesses (debug/smoke mode)")
    p.add_argument("--join", action="append", default=None,
                   metavar="HOST:PORT",
                   help="join a REMOTE serve worker into the ring (a peer "
                        "running 'serve --socket PORT --bind ADDR'); "
                        "repeatable.  The join runs the versioned qi-mesh "
                        "handshake — protocol + package fingerprint + "
                        "QI_FLEET_TOKEN digest — and a mismatch is a "
                        "typed reject, never a silently skewed mesh")
    p.add_argument("--lease-s", type=float, default=None, metavar="F",
                   help="heartbeat lease for socket-joined peers (env "
                        "twin: QI_FLEET_LEASE_S).  Missed probes SUSPECT "
                        "a peer (its requests hedge to the next arc "
                        "owner); only a lapsed lease evicts and ships its "
                        "journal")
    p.add_argument("--scale-interval-s", type=float, default=None,
                   metavar="F",
                   help="elasticity cadence (env twin: "
                        "QI_FLEET_SCALE_INTERVAL_S; 0 disables): the "
                        "fleet-merged pulse queue-wait p99 + SLO burn "
                        "state drive spawn/retire between "
                        "QI_FLEET_SCALE_MIN and QI_FLEET_SCALE_MAX")
    p.add_argument("--deadline-s", type=float, default=None, metavar="F",
                   help="per-request deadline budget forwarded to the "
                        "workers (env twin: QI_SERVE_DEADLINE_S)")
    p.add_argument("--batch-max", type=int, default=None, metavar="N",
                   help="per-worker drain batch bound (QI_SERVE_BATCH_MAX)")
    p.add_argument("--cache-max", type=int, default=None, metavar="N",
                   help="per-worker verdict-cache capacity "
                        "(QI_SERVE_CACHE_MAX)")
    p.add_argument("--dangling-policy", default="strict",
                   choices=["strict", "alias0"],
                   help="unknown validator refs (default strict)")
    p.add_argument("--scc-select", default="quorum-bearing",
                   choices=["quorum-bearing", "front"],
                   help="which SCC to search (default quorum-bearing)")
    p.add_argument("--scope-scc", action="store_true",
                   help="scope availability to the searched SCC")
    p.add_argument("--emit-certs", action="store_true",
                   help="verdict responses carry their qi-cert/1 "
                        "certificate and solve stats")
    p.add_argument("--metrics-json", metavar="PATH", default=None,
                   help="stream qi-telemetry/1 JSONL to PATH")
    p.add_argument("--metrics-prom", metavar="PATH", default=None,
                   help="write final counters/gauges to PATH "
                        "(Prometheus textfile)")
    return p


def fleet_main(argv: Optional[List[str]] = None) -> int:
    """The ``fleet`` subcommand body (dispatched from cli.py)."""
    from quorum_intersection_tpu_torch.utils import telemetry

    args = build_fleet_parser().parse_args(argv)
    record = telemetry.get_run_record()
    if args.metrics_json:
        record.add_sink(telemetry.JsonlSink(args.metrics_json))
    if args.metrics_prom:
        record.add_sink(telemetry.PromFileSink(args.metrics_prom))
    try:
        engine = FleetEngine(
            args.workers,
            backend=args.backend,
            worker_mode="local" if args.local_workers else "subprocess",
            journal_dir=args.journal_dir,
            store_dir=args.store_dir,
            deadline_s=args.deadline_s,
            batch_max=args.batch_max,
            cache_max=args.cache_max,
            dangling=args.dangling_policy,
            scc_select=args.scc_select,
            scope_to_scc=args.scope_scc,
            joins=args.join,
            lease_s=args.lease_s,
            scale_interval_s=args.scale_interval_s,
            device=None if args.device == "cuda" else args.device,
        )
    except RuntimeError as exc:  # resolve_device: no card for --device cuda
        sys.stderr.write(f"device {args.device!r} unavailable: {exc}\n")
        record.finish()
        return 1
    session = JsonlSession(
        engine,  # type: ignore[arg-type] — same submit/Ticket contract
        sys.stdout, emit_certs=args.emit_certs,
    )
    try:
        report = engine.start()
        session.emit({"kind": "fleet", **report})
        run_jsonl_loop(session, sys.stdin)
        engine.stop(drain=True)
        session.wait_drained(timeout=None)
        return 0
    finally:
        engine.stop(drain=False)
        record.finish()
