"""qi-delta/1 — incremental re-analysis of a snapshot stream.

The port of the JAX package's ``delta.py``.  A stream of stellarbeat
snapshots (an explorer replaying history, a service checking each snapshot
its validators submit) mostly changes watchers, yet :func:`pipeline.check_many`
re-solves every SCC of every snapshot.  The NP-hard work decomposes per SCC
(arXiv:1902.06493), so this module re-solves only what changed:

- :class:`SccVerdictStore` — an LRU store (``QI_DELTA_CACHE_MAX``) keyed by
  the SCC-local fingerprints of :mod:`.fbas.diff`: per-SCC **scan** results
  (the polynomial max-quorum fixpoint) and per-SCC **search verdicts** (the
  exponential disjointness search plus its certificate ledger or witness
  fragment), both in SCC-local coordinates so they project onto any snapshot
  whose component is structurally identical.  Concurrent misses on one
  fingerprint are **single-flight**: one leader solves, followers wait and
  reuse.  An attached :class:`SharedSccStore` (fingerprint-keyed files,
  atomic writes) is read through on every local miss and written through on
  every bank, so processes sharing a directory solve each fragment once; a
  dead shared tier degrades to local-LRU-only through the ``fleet.store``
  fault point, loudly, never to a wrong verdict.  The fingerprints and the
  fragment format are the JAX package's, so the two packages share one
  directory.
- :class:`DeltaEngine` — the delta-aware twin of :func:`pipeline.check_many`:
  per snapshot it re-runs only the cheap structural prefix (parse → graph →
  Tarjan), serves every fingerprint-unchanged SCC's scan and the target
  SCC's verdict from the store, and sends **only dirty or new SCCs** to a
  backend — on the card unless the engine was built with ``device="cpu"``.
  A step that wobbles one watcher SCC re-solves *zero* SCCs; a step that
  dirties the quorum-bearing core re-solves exactly that one.
- **Composed certificates**: a store hit stitches the cached fragment into a
  fresh ``qi-cert/1`` built against the *new* snapshot (guard counts, node
  ids and witness evidence recomputed — only the structural verdict and its
  coverage arithmetic are reused), stamped ``provenance.delta`` with reused
  vs re-solved SCC counts and ``provenance.cost`` with the reuse credit, and
  still checkable by the unmodified ``tools/check_cert.py``.

The diff/fingerprint path is a declared fault point (``delta.diff``): an
injected or real failure there, in the store or in a composition degrades to
the full re-solve (``pipeline.check_many`` on the same device) — incremental
re-analysis is an optimization, never a precondition for a verdict.  Unlike
the JAX package, an exception raised by the backend's own solve of the misses
propagates (as ``SearchCancelled`` does): a kernel failure or a fired
``sweep.*`` fault fails the call instead of running the batch again.

``check_many(..., cancels=, origins=)`` carries the serving layer's
per-request cancel tokens and origins into the backend solve of the misses.
A fragment is banked in the form the JAX engine composes too
(:func:`cert.ledger_stats`: a ``gpu-frontier`` solve under its ledger kind).
The remote tier (:class:`RemoteStoreClient`, ``qi-store/1``) reads a
socket-joined fleet worker's misses through the front door's store gateway
and publishes its banked fragments back; its wire is the JAX package's.
Telemetry: the ``delta.check`` span; the ``delta.classified``,
``delta.composed`` and ``delta.degraded`` events; the ``delta.*`` counters;
the ``delta.scc_reuse_pct`` and ``delta.store_size`` gauges.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import random
import socket
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

from quorum_intersection_tpu_torch.backends.base import CancelToken, SearchBackend, SearchCancelled
from quorum_intersection_tpu_torch.cert import build_certificate, ledger_stats
from quorum_intersection_tpu_torch.cost import reuse_credit
from quorum_intersection_tpu_torch.device import DeviceLike
from quorum_intersection_tpu_torch.fbas.diff import diff_snapshots, localize, project, scc_fingerprint
from quorum_intersection_tpu_torch.fbas.graph import TrustGraph, build_graph
from quorum_intersection_tpu_torch.fbas.schema import Fbas, parse_fbas
from quorum_intersection_tpu_torch.pipeline import SolveResult, _classify_sccs, check_many, scan_scc_quorums
from quorum_intersection_tpu_torch.utils.env import qi_env, qi_env_float, qi_env_int
from quorum_intersection_tpu_torch.utils.faults import FaultInjected, fault_point
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record
from quorum_intersection_tpu_torch.utils.timers import PhaseTimers

log = logging.getLogger("quorum_intersection_tpu_torch.delta")

DELTA_SCHEMA = "qi-delta/1"

# Deterministic-interleaving hook: a no-op in production; a test swaps in a
# controller to FORCE the store's single-flight orderings
# (follower-waits-for-leader, leader-fails-follower-takes-over) the wall
# clock almost never produces.
_delta_sync: Callable[[str], None] = lambda point: None

# Bound on one single-flight wait: a follower whose leader died without
# publishing takes the lease over instead of wedging forever.
LEASE_WAIT_S = 60.0

# Stats keys that describe the ORIGINAL solve's run, not the verdict: they
# are dropped from stored fragments so a composed result never claims a
# race it never ran, nor the original run's rank order (the composed result
# swept nothing).  Oracle counters stay: they ARE the coverage evidence the
# composed ledger re-serves.
_VOLATILE_STATS = ("race", "order")

_StoreKey = Tuple[str, str, str]


def _localize_pruned_evidence(
    stats: Dict[str, object], graph: TrustGraph, members: List[int]
) -> Optional[Dict[str, object]]:
    """Rewrite a fragment's pruned-block evidence into SCC-local coordinates
    before banking: the certificate ledger's ``enumeration`` block names
    graph-space publicKeys, and a fingerprint-matched SCC in a LATER snapshot
    may carry different keys (the same rank map the witness localization
    rides).  The ``pruned_blocks`` claims are pure block arithmetic over the
    bit order, so only the bit→node map needs the coordinate change.
    ``None`` when an enumeration id fails to localize (a claim that escaped
    the SCC): the caller must not bank the fragment, because a composed
    certificate could never re-verify it."""
    cert = stats.get("cert")
    if not isinstance(cert, dict) or "enumeration" not in cert:
        return stats
    enum = cert.get("enumeration") or {}
    rank: Dict[str, int] = {graph.node_ids[v]: i for i, v in enumerate(members)}
    try:
        local = {
            "fixed": rank[enum["fixed"]],
            "bit_nodes": [rank[pk] for pk in enum["bit_nodes"]],
        }
    except (KeyError, TypeError):
        return None
    stats = dict(stats)
    cert = dict(cert)
    del cert["enumeration"]
    cert["enumeration_local"] = local
    stats["cert"] = cert
    return stats


def _project_pruned_evidence(
    stats: Dict[str, object], graph: TrustGraph, members: List[int]
) -> Dict[str, object]:
    """Inverse of :func:`_localize_pruned_evidence` at compose time: rebuild
    the ``enumeration`` bit→node map against THIS snapshot's graph, so the
    composed certificate's pruned blocks re-verify under the new ids."""
    cert = stats.get("cert")
    if not isinstance(cert, dict) or "enumeration_local" not in cert:
        return stats
    local = cert["enumeration_local"]
    stats = dict(stats)
    cert = dict(cert)
    del cert["enumeration_local"]
    cert["enumeration"] = {
        "fixed": graph.node_ids[members[local["fixed"]]],
        "bit_nodes": [graph.node_ids[members[r]] for r in local["bit_nodes"]],
    }
    stats["cert"] = cert
    return stats


@dataclass
class SccScan:
    """Cached per-SCC quorum-scan result, SCC-local coordinates."""

    quorum_local: Tuple[int, ...]  # () = no quorum inside this SCC


@dataclass
class SccVerdict:
    """Cached per-SCC search verdict + its certificate fragment."""

    intersects: bool
    q1_local: Optional[List[int]]
    q2_local: Optional[List[int]]
    stats: Dict[str, object] = field(default_factory=dict)


STORE_SCHEMA = "qi-store/1"


def _mesh_token_digest() -> str:
    """SHA-256 digest of ``QI_FLEET_TOKEN`` (empty token: empty digest), the
    store gateway's session auth; the wire never sees the raw token.  Kept
    wire-identical to ``serve_transport.fleet_token_digest`` (importing it
    here would cycle delta, serve, serve_transport)."""
    token = qi_env("QI_FLEET_TOKEN")
    if not token:
        return ""
    return hashlib.sha256(token.encode("utf-8")).hexdigest()


class RemoteStoreClient:
    """``qi-store/1``: SCC fragments fetched and published over the mesh wire.

    One persistent token-authenticated JSONL connection to the fleet front
    door's store gateway (``fleet.StoreGateway``); a socket worker with no
    shared filesystem reads through to it on every local miss
    (fetch-on-miss) and writes every banked fragment back
    (publish-on-solve).  Safe by construction: a fetched payload passes the
    same strict shape validation as a local file and the composed
    certificate re-verifies through the checker, so a torn, corrupt or
    forged fragment is just a miss, never trusted.

    Every round trip sits behind the ``store.fetch`` fault point with a
    deadline (socket timeout) and bounded retry with backoff and jitter;
    exhausted retries degrade to a local solve (``store.fetch_errors``
    counter, ``store.fetch_degraded`` event): shared reuse is lost, the
    verdict is not.
    """

    def __init__(self, host: str, port: int, *, timeout_s: float = 2.0, retries: int = 2) -> None:
        self.host = host
        self.port = int(port)
        self.timeout_s = max(float(timeout_s), 0.05)
        self.retries = max(int(retries), 1)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._reader = None
        self._writer = None

    def _connect_locked(self) -> None:
        sock = socket.create_connection((self.host, self.port), timeout=self.timeout_s)
        sock.settimeout(self.timeout_s)
        reader = sock.makefile("r", encoding="utf-8")
        writer = sock.makefile("w", encoding="utf-8")
        writer.write(json.dumps({"store_hello": {"schema": STORE_SCHEMA, "token": _mesh_token_digest()}}) + "\n")
        writer.flush()
        resp = json.loads(reader.readline() or "null")
        if not (isinstance(resp, dict) and resp.get("ok")):
            raise OSError(f"store gateway rejected the session: {resp!r}")
        self._sock, self._reader, self._writer = sock, reader, writer

    def _close_locked(self) -> None:
        for closer in (self._reader, self._writer, self._sock):
            try:
                if closer is not None:
                    closer.close()
            except OSError:
                pass
        self._sock = self._reader = self._writer = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _request(self, op: Dict[str, object]) -> Optional[Dict[str, object]]:
        """One authenticated round trip: deadline, bounded retry with backoff
        and jitter behind ``store.fetch``; ``None`` means degraded (the
        caller solves locally)."""
        rec = get_run_record()
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            if attempt:
                time.sleep(min(0.05 * (2 ** (attempt - 1)), 0.5) * (1.0 + random.random()))
            try:
                fault_point("store.fetch")
                with self._lock:
                    if self._sock is None:
                        self._connect_locked()
                    assert self._writer is not None and self._reader is not None
                    self._writer.write(json.dumps(op, default=str) + "\n")
                    self._writer.flush()
                    line = self._reader.readline()
                resp = json.loads(line or "null")
                if not (isinstance(resp, dict) and resp.get("ok") is True):
                    raise ValueError(f"store gateway answered {resp!r}")
                return resp
            except (FaultInjected, OSError, ValueError, TypeError) as exc:
                last = exc
                with self._lock:
                    self._close_locked()
        rec.add("store.fetch_errors")
        rec.event("store.fetch_degraded", op=str(op.get("op")), error=str(last))
        log.warning("remote store %s failed after %d attempt(s) (%s); degrading to local solve",
                    op.get("op"), self.retries + 1, last)
        return None

    def fetch(self, kind: str, fp: str, scope: str = "") -> Optional[Dict[str, object]]:
        """One fragment payload from the gateway, or ``None`` (a miss or
        degraded, alike on purpose: both solve locally)."""
        get_run_record().add("store.fetches")
        resp = self._request({"op": "get", "kind": kind, "fp": fp, "scope": scope})
        if resp is None:
            return None
        payload = resp.get("payload")
        return payload if isinstance(payload, dict) else None

    def publish(self, kind: str, fp: str, payload: Dict[str, object], scope: str = "") -> bool:
        """Publish one banked fragment; ``False`` (never an exception) on a
        degraded wire: the fragment stays local, loudly."""
        get_run_record().add("store.publishes")
        resp = self._request({"op": "put", "kind": kind, "fp": fp, "scope": scope, "payload": payload})
        return resp is not None


class SharedSccStore:
    """Fingerprint-keyed shared fragment tier.

    The second level under :class:`SccVerdictStore`: one file per fragment
    under ``root``, named by entry kind + SCC-local fingerprint + scoping
    bit, written atomically (tmp + rename) so concurrent processes never read
    a torn fragment.  Fragments are stored in SCC-local coordinates, which
    is what makes a fragment solved by one process (or by the JAX package)
    composable into another's certificate, with the composed certificate
    still passing the unmodified ``tools/check_cert.py``.

    Every operation sits behind the ``fleet.store`` fault point and
    **degrades to local-LRU-only**: a read error, a full disk, an
    unparseable fragment, or an injected fault costs shared reuse
    (``fleet.store_errors`` counter, loud), never a verdict and never a
    wrong fragment — a fragment that fails shape validation is treated as
    a miss, not trusted.  ``max_mb`` (default ``QI_FLEET_STORE_MAX_MB``;
    <= 0 unbounded) bounds the directory: past it a publish deletes the
    stalest fragments by mtime.
    """

    def __init__(self, root: Union[str, Path], max_mb: Optional[float] = None) -> None:
        self.root = Path(root)
        self.max_bytes = int(
            (max_mb if max_mb is not None else qi_env_float("QI_FLEET_STORE_MAX_MB", 0.0)) * 1024 * 1024
        )
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        # Optional third tier: a RemoteStoreClient to the fleet front door's
        # store gateway, attached on a socket worker
        # (serve.ServeEngine.attach_remote_store).  A local-file miss reads
        # through to it and every local bank is published back.
        self.remote: Optional[RemoteStoreClient] = None

    def _path(self, kind: str, fp: str, scope: str) -> Path:
        return self.root / f"{kind}-{scope or 'g'}-{fp}.json"

    @staticmethod
    def _tmp_path(path: Path) -> Path:
        """The writer's own temporary file: keyed by process and thread, so two
        writers of one fragment in one process (a fleet front door's store
        gateway and its in-process worker) never rename each other's file."""
        return path.with_name(f"{path.name}.tmp-{os.getpid()}-{threading.get_ident()}")

    def _note(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self._hits += 1
            else:
                self._misses += 1
            hits, misses = self._hits, self._misses
        rec = get_run_record()
        rec.add("fleet.store_hits" if hit else "fleet.store_misses")
        rec.gauge(
            "fleet.store_hit_pct",
            round(100.0 * hits / (hits + misses), 2) if hits + misses else 0.0,
        )

    def get(self, kind: str, fp: str, scope: str = "") -> Optional[Dict[str, object]]:
        """One fragment payload, or ``None`` (miss or degraded)."""
        rec = get_run_record()
        try:
            fault_point("fleet.store")
            raw = self._path(kind, fp, scope).read_text(encoding="utf-8")
            payload = json.loads(raw)
            if not isinstance(payload, dict):
                raise ValueError("shared fragment is not a JSON object")
        except FileNotFoundError:
            fetched = self._fetch_remote(kind, fp, scope)
            if fetched is not None:
                self._note(True)
                return fetched
            self._note(False)
            return None
        except (OSError, ValueError, FaultInjected) as exc:
            rec.add("fleet.store_errors")
            rec.event("fleet.store_error", op="get", kind=kind, error=str(exc))
            log.warning("shared store read failed (%s); degrading to local LRU only for this lookup", exc)
            return None
        self._note(True)
        return payload

    def put(self, kind: str, fp: str, payload: Dict[str, object], scope: str = "") -> bool:
        """Bank one fragment; ``False`` (never an exception) on failure."""
        rec = get_run_record()
        path = self._path(kind, fp, scope)
        tmp = self._tmp_path(path)
        try:
            fault_point("fleet.store")
            self.root.mkdir(parents=True, exist_ok=True)
            tmp.write_text(json.dumps(payload, separators=(",", ":")), encoding="utf-8")
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError, FaultInjected) as exc:
            rec.add("fleet.store_errors")
            rec.event("fleet.store_error", op="put", kind=kind, error=str(exc))
            log.warning("shared store write failed (%s); fragment stays local-only", exc)
            try:
                tmp.unlink()
            except OSError:
                pass
            return False
        self._maybe_gc()
        if self.remote is not None:
            # Publish-on-solve, best effort: the client degrades loudly on
            # its own (store.fetch_errors), the local bank stands.
            self.remote.publish(kind, fp, payload, scope)
        return True

    def _fetch_remote(self, kind: str, fp: str, scope: str) -> Optional[Dict[str, object]]:
        """Fetch-on-miss through the mesh gateway, banking the fragment
        locally (atomic tmp and rename, as :meth:`put`) so the next miss is a
        plain file hit.  ``None`` with no remote, on a remote miss, or on a
        degraded wire: all just a local miss."""
        if self.remote is None:
            return None
        payload = self.remote.fetch(kind, fp, scope)
        if payload is None:
            return None
        path = self._path(kind, fp, scope)
        tmp = self._tmp_path(path)
        try:
            self.root.mkdir(parents=True, exist_ok=True)
            tmp.write_text(json.dumps(payload, separators=(",", ":")), encoding="utf-8")
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError):
            try:
                tmp.unlink()
            except OSError:
                pass
        return payload

    def _maybe_gc(self) -> None:
        """LRU-by-mtime sweep on publish: while the fragment directory
        exceeds its size budget the stalest fragments are deleted — loud
        (``delta.store_evictions`` counter + ``delta.store_gc`` event), and
        an evicted fragment costs a future re-solve on a miss, never a
        verdict: a concurrent reader of a just-deleted file sees
        FileNotFoundError, which is already a plain miss."""
        if self.max_bytes <= 0:
            return
        try:
            files = sorted((p.stat().st_mtime, p.stat().st_size, str(p), p) for p in self.root.glob("*.json"))
        except OSError:
            return
        total = sum(size for _, size, _, _ in files)
        if total <= self.max_bytes:
            return
        evicted = 0
        for _, size, _, path in files:
            try:
                path.unlink()
            except OSError:
                continue
            total -= size
            evicted += 1
            if total <= self.max_bytes:
                break
        if evicted:
            rec = get_run_record()
            rec.add("delta.store_evictions", evicted)
            rec.event("delta.store_gc", evicted=evicted, remaining_bytes=max(total, 0),
                      budget_bytes=self.max_bytes)
            log.warning("shared store over its %d-byte budget; %d stalest fragment(s) evicted "
                        "(they re-solve on next miss)", self.max_bytes, evicted)


def _encode_verdict(verdict: SccVerdict) -> Dict[str, object]:
    return {
        "intersects": bool(verdict.intersects),
        "q1_local": verdict.q1_local,
        "q2_local": verdict.q2_local,
        "stats": verdict.stats,
    }


def _decode_verdict(payload: Dict[str, object]) -> Optional[SccVerdict]:
    """Strict shape validation: a forged or torn shared fragment becomes a
    miss, never a trusted verdict."""
    intersects = payload.get("intersects")
    q1 = payload.get("q1_local")
    q2 = payload.get("q2_local")
    stats = payload.get("stats")
    if not isinstance(intersects, bool) or not isinstance(stats, dict):
        return None
    for q in (q1, q2):
        if q is not None and not (isinstance(q, list) and all(isinstance(v, int) for v in q)):
            return None
    return SccVerdict(intersects=intersects, q1_local=q1, q2_local=q2, stats=stats)


def _decode_scan(payload: Dict[str, object]) -> Optional[SccScan]:
    quorum = payload.get("quorum_local")
    if not (isinstance(quorum, list) and all(isinstance(v, int) for v in quorum)):
        return None
    return SccScan(quorum_local=tuple(quorum))


class SccVerdictStore:
    """LRU-bounded, single-flight store of per-SCC scans and verdicts.

    One LRU budget (``QI_DELTA_CACHE_MAX``) covers both entry kinds — scan
    entries are tiny next to verdict fragments, but a shared bound keeps the
    occupancy gauge honest.  Thread-safe; telemetry is emitted outside the
    lock.  With ``shared`` attached, a local scan or verdict miss probes the
    :class:`SharedSccStore` before solving (a shared hit is banked locally
    and counted as a reuse), and every banked fragment is written through.
    """

    def __init__(self, max_entries: Optional[int] = None, shared: Optional[SharedSccStore] = None) -> None:
        self.max_entries = max(
            max_entries if max_entries is not None else qi_env_int("QI_DELTA_CACHE_MAX", 4096),
            1,
        )
        self.shared = shared
        self._lock = threading.Lock()
        self._entries: "OrderedDict[_StoreKey, object]" = OrderedDict()
        self._pending: Dict[_StoreKey, threading.Event] = {}
        self._scc_hits = 0
        self._scc_misses = 0

    @staticmethod
    def _vkey(fp: str, scope_to_scc: bool) -> _StoreKey:
        return ("verdict", fp, str(int(scope_to_scc)))

    # ---- internal ---------------------------------------------------------

    def _put(self, key: _StoreKey, value: object) -> None:
        evicted = 0
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                evicted += 1
            size = len(self._entries)
        rec = get_run_record()
        if evicted:
            rec.add("delta.store_evictions", evicted)
        rec.gauge("delta.store_size", size)

    def _note_verdict_lookup(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self._scc_hits += 1
            else:
                self._scc_misses += 1
            hits, misses = self._scc_hits, self._scc_misses
        rec = get_run_record()
        rec.add("delta.scc_hits" if hit else "delta.scc_misses")
        rec.gauge(
            "delta.scc_reuse_pct",
            round(100.0 * hits / (hits + misses), 2) if hits + misses else 0.0,
        )

    # ---- scans ------------------------------------------------------------

    def get_scan(self, fp: str) -> Optional[SccScan]:
        key = ("scan", fp, "")
        with self._lock:
            scan = self._entries.get(key)
            if scan is not None:
                self._entries.move_to_end(key)
        if scan is None and self.shared is not None:
            payload = self.shared.get("scan", fp)
            if payload is not None:
                scan = _decode_scan(payload)
                if scan is not None:
                    self._put(key, scan)
        get_run_record().add("delta.scan_hits" if scan is not None else "delta.scan_misses")
        return scan  # type: ignore[return-value]

    def put_scan(self, fp: str, scan: SccScan) -> None:
        self._put(("scan", fp, ""), scan)
        if self.shared is not None:
            self.shared.put("scan", fp, {"quorum_local": list(scan.quorum_local)})

    # ---- verdicts (single-flight) -----------------------------------------

    def _shared_verdict(self, fp: str, scope_to_scc: bool) -> Optional[SccVerdict]:
        """Shared-tier verdict probe: a validated hit is banked locally."""
        if self.shared is None:
            return None
        payload = self.shared.get("verdict", fp, scope=f"s{int(scope_to_scc)}")
        if payload is None:
            return None
        verdict = _decode_verdict(payload)
        if verdict is not None:
            self._put(self._vkey(fp, scope_to_scc), verdict)
        return verdict

    def peek_verdict(self, fp: str, scope_to_scc: bool) -> Optional[SccVerdict]:
        """Plain lookup, no lease, no hit/miss accounting — the intra-batch
        follower probe after its leader's batch solved."""
        key = self._vkey(fp, scope_to_scc)
        with self._lock:
            cached = self._entries.get(key)
            if cached is not None:
                self._entries.move_to_end(key)
        if cached is None:
            cached = self._shared_verdict(fp, scope_to_scc)
        return cached  # type: ignore[return-value]

    def lease_verdict(self, fp: str, scope_to_scc: bool) -> Tuple[str, Optional[SccVerdict]]:
        """``("hit", verdict)`` or ``("leader", None)``.

        A concurrent leader already solving this fingerprint parks the
        caller until :meth:`publish_verdict` fires, then re-probes: the
        published verdict is a hit; a leader that failed (published ``None``)
        hands the lease over — the caller becomes the new leader.  Bounded by
        :data:`LEASE_WAIT_S` so a dead leader can never wedge a caller.
        """
        key = self._vkey(fp, scope_to_scc)
        while True:
            wait_ev: Optional[threading.Event] = None
            cached: Optional[object] = None
            with self._lock:
                cached = self._entries.get(key)
                if cached is not None:
                    self._entries.move_to_end(key)
                elif key in self._pending:
                    wait_ev = self._pending[key]
                else:
                    self._pending[key] = threading.Event()
            if cached is not None:
                self._note_verdict_lookup(True)
                return "hit", cached  # type: ignore[return-value]
            if wait_ev is None:
                # Read-through before solving: another process may already
                # have banked this fragment in the shared tier.  A hit
                # releases the just-taken lease — followers re-probe and
                # find the banked local entry.
                shared_hit = self._shared_verdict(fp, scope_to_scc)
                if shared_hit is not None:
                    with self._lock:
                        ev = self._pending.pop(key, None)
                    if ev is not None:
                        ev.set()
                    self._note_verdict_lookup(True)
                    return "hit", shared_hit
                self._note_verdict_lookup(False)
                _delta_sync("store.leader")
                return "leader", None
            _delta_sync("store.wait")
            if not wait_ev.wait(LEASE_WAIT_S):
                # Leader died without publishing: exactly ONE timed-out
                # waiter takes the lease over — it swaps in a fresh event so
                # later arrivals (and the other timed-out waiters, who loop)
                # park on the new leader instead of all re-solving the same
                # fingerprint.  Should the presumed-dead leader publish after
                # all, its publish pops the fresh event and wakes those
                # waiters to re-probe — correctness is unaffected either way.
                with self._lock:
                    if self._pending.get(key) is not wait_ev:
                        continue  # published or already taken over: re-probe
                    self._pending[key] = threading.Event()
                self._note_verdict_lookup(False)
                _delta_sync("store.leader")
                return "leader", None

    def publish_verdict(self, fp: str, scope_to_scc: bool, verdict: Optional[SccVerdict]) -> None:
        """Resolve a lease: store ``verdict`` (``None`` = the leader's solve
        failed or was uncacheable; waiting followers re-contend for the
        lease) and wake every waiter."""
        key = self._vkey(fp, scope_to_scc)
        if verdict is not None:
            self._put(key, verdict)
            if self.shared is not None:
                self.shared.put("verdict", fp, _encode_verdict(verdict), scope=f"s{int(scope_to_scc)}")
        with self._lock:
            ev = self._pending.pop(key, None)
        if ev is not None:
            ev.set()
        _delta_sync("store.publish")

    # ---- introspection ----------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def reuse_pct(self) -> float:
        with self._lock:
            total = self._scc_hits + self._scc_misses
            return 100.0 * self._scc_hits / total if total else 0.0


@dataclass
class _SourceState:
    """Per-source bookkeeping across the classify → compose/solve phases."""

    ix: int
    fbas: Fbas
    graph: TrustGraph
    n_sccs: int = 0
    quorum_scc_ids: List[int] = field(default_factory=list)
    scc_quorums: Dict[int, List[int]] = field(default_factory=dict)
    main_scc: List[int] = field(default_factory=list)
    target_scc: List[int] = field(default_factory=list)
    target_index: int = 0
    target_fp: str = ""
    cacheable: bool = False
    scan_reused: int = 0
    scan_fresh: int = 0
    ev0: int = 0
    timers: Dict[str, float] = field(default_factory=dict)


class _BackendFailure(Exception):
    """Carries the backend's own exception past the degrade handler of
    :meth:`DeltaEngine.check_many`, which re-raises the original."""


class DeltaEngine:
    """Delta-aware batch solver (see module docstring).

    One engine per configuration: all snapshots it sees share the front-end
    options (dangling policy, SCC selection, scoping), which is what makes
    per-SCC fragments interchangeable across them.  ``device`` goes to
    :func:`pipeline.check_many` with every re-solve (None: CUDA).  The engine
    remembers the previous snapshot's graph and emits a ``delta.classified``
    event per snapshot with the :func:`fbas.diff.diff_snapshots` summary —
    the observable that tells cosmetic churn from a core restructure.
    """

    def __init__(
        self,
        store: Optional[SccVerdictStore] = None,
        *,
        device: DeviceLike = None,
        dangling: str = "strict",
        scc_select: str = "quorum-bearing",
        scope_to_scc: bool = False,
        track_diff: bool = True,
    ) -> None:
        self.store = store if store is not None else SccVerdictStore()
        self.device = device
        self.dangling = dangling
        self.scc_select = scc_select
        self.scope_to_scc = scope_to_scc
        self.track_diff = track_diff
        # Previous snapshot's (graph, partition, fingerprints) — kept so the
        # per-snapshot delta.classified diff costs only overlap bookkeeping,
        # never a second Tarjan/fingerprint pass.
        self._prev: Optional[Tuple[TrustGraph, List[List[int]], List[Tuple[str, bool]]]] = None

    # ---- entry point ------------------------------------------------------

    def check_many(
        self,
        sources: Sequence[object],
        *,
        backend: Union[str, SearchBackend] = "auto",
        pack: Optional[bool] = None,
        cancels: Optional[Sequence[Optional[CancelToken]]] = None,
        origins: Optional[Sequence[str]] = None,
    ) -> List[SolveResult]:
        """Batch verdicts for ``sources``, reusing per-SCC work.

        Result verdicts, witnesses and certificates are interchangeable with
        :func:`pipeline.check_many`'s for the same sources; only *which
        engine re-derives them* changes.  Degrades to the full re-solve on an
        injected or real ``delta.diff`` failure, and on any unexpected error
        of the incremental body itself (fingerprint, diff, store, compose).
        The backend's own failure while solving the misses propagates, and so
        does ``SearchCancelled``.  ``cancels`` and ``origins`` are
        source-aligned and ride into the backend solve of the misses (or of
        every source, degraded).
        """
        rec = get_run_record()
        try:
            fault_point("delta.diff")
        except (FaultInjected, OSError) as exc:
            rec.add("delta.diff_faults")
            return self._degrade(sources, backend, pack, exc, cancels, origins)
        try:
            return self._check_many_incremental(sources, backend, pack, cancels, origins)
        except SearchCancelled:
            raise
        except _BackendFailure as failure:
            raise failure.__cause__ from None  # type: ignore[misc]
        except Exception as exc:  # noqa: BLE001 — any differ/store/compose failure
            rec.add("delta.errors")
            return self._degrade(sources, backend, pack, exc, cancels, origins)

    def _degrade(
        self,
        sources: Sequence[object],
        backend: Union[str, SearchBackend],
        pack: Optional[bool],
        exc: BaseException,
        cancels: Optional[Sequence[Optional[CancelToken]]] = None,
        origins: Optional[Sequence[str]] = None,
    ) -> List[SolveResult]:
        get_run_record().event("delta.degraded", error=str(exc))
        log.warning("delta path failed (%s); degrading to full re-solve", exc)
        return check_many(
            sources, backend=backend, device=self.device, dangling=self.dangling,
            scc_select=self.scc_select, scope_to_scc=self.scope_to_scc, pack=pack, cancels=cancels,
            origins=origins,
        )

    def _check_many_incremental(
        self,
        sources: Sequence[object],
        backend: Union[str, SearchBackend],
        pack: Optional[bool],
        cancels: Optional[Sequence[Optional[CancelToken]]] = None,
        origins: Optional[Sequence[str]] = None,
    ) -> List[SolveResult]:
        rec = get_run_record()
        results: List[Optional[SolveResult]] = [None] * len(sources)
        misses: List[_SourceState] = []
        followers: List[_SourceState] = []
        # Fingerprints THIS call holds the lease for: an identical snapshot
        # later in the same batch must not wait on its own batch's lease
        # (single-thread deadlock) — it becomes an intra-batch follower and
        # composes from the store after the leader's batch solve lands.
        held: Set[str] = set()
        reused = 0
        with rec.span("delta.check", sources=len(sources), backend=backend_name(backend)):
            try:
                for ix, source in enumerate(sources):
                    st = self._classify(ix, source)
                    if len(st.quorum_scc_ids) != 1:
                        results[ix] = self._guard_result(st)
                        continue
                    if not st.cacheable:
                        rec.add("delta.uncacheable")
                        misses.append(st)
                        continue
                    if st.target_fp in held:
                        followers.append(st)
                        continue
                    outcome, cached = self.store.lease_verdict(st.target_fp, self.scope_to_scc)
                    if outcome == "hit":
                        assert cached is not None
                        results[ix] = self._compose(st, cached)
                        reused += 1
                    else:
                        held.add(st.target_fp)
                        misses.append(st)
                if misses:
                    self._solve_misses(misses, results, backend, pack, held, cancels, origins)
                for st in followers:
                    cached = self.store.peek_verdict(st.target_fp, self.scope_to_scc)
                    # Intra-batch followers count toward the reuse gauge too:
                    # a composition IS a reuse, whichever path delivered the
                    # fragment — and a straggler that must re-solve is a miss
                    # the gauge must not hide.
                    self.store._note_verdict_lookup(cached is not None)
                    if cached is not None:
                        results[st.ix] = self._compose(st, cached)
                        reused += 1
                strag = [st for st in followers if results[st.ix] is None]
                if strag:
                    # The leader's fragment never landed (failed solve or a
                    # witness that escaped the SCC): solve the stragglers
                    # directly — correctness over reuse.
                    self._solve_misses(strag, results, backend, pack, set(), cancels, origins)
            finally:
                # Any lease still held here (an exception mid-batch, a cancel
                # inside the backend solve) is released as a failure so
                # concurrent followers re-contend instead of wedging until
                # the lease timeout.
                for fp in held:
                    self.store.publish_verdict(fp, self.scope_to_scc, None)
        if reused:
            rec.add("delta.compositions", reused)
        return [r for r in results if r is not None]

    # ---- classification ---------------------------------------------------

    def _classify(self, ix: int, source: object) -> _SourceState:
        """The structural prefix: parse → graph → the SAME
        ``pipeline._classify_sccs`` guard and selection logic the one-shot
        entry points share (so incremental guard verdicts cannot drift),
        with a store-aware scan provider that serves every
        fingerprint-matched SCC's scan from the store."""
        rec = get_run_record()
        timers = PhaseTimers()
        with timers.phase("parse"):
            fbas = source if isinstance(source, Fbas) else parse_fbas(source)
        with timers.phase("graph"):
            graph = build_graph(fbas, dangling=self.dangling)
        st = _SourceState(ix=ix, fbas=fbas, graph=graph)
        st.ev0 = rec.event_count()

        fps: List[Tuple[str, bool]] = []

        def store_scan(g: TrustGraph, sccs: List[List[int]]) -> List[Optional[List[int]]]:
            quorums, scc_fps, reused, fresh = self._serve_scans(g, sccs)
            fps.extend(scc_fps)
            st.scan_reused += reused
            st.scan_fresh += fresh
            return quorums

        count, sccs, quorum_scc_ids, scc_quorums, main_scc = _classify_sccs(
            graph, scc_select=self.scc_select, timers=timers, scan=store_scan,
        )
        st.n_sccs = count
        st.quorum_scc_ids = quorum_scc_ids
        st.scc_quorums = scc_quorums
        st.main_scc = main_scc
        if self.track_diff:
            # Both snapshots' partitions and fingerprints are already in hand
            # (this one's from the scan above, the previous one's kept).
            if self._prev is not None:
                prev_graph, prev_parts, prev_fps = self._prev
                diff = diff_snapshots(
                    prev_graph, graph, old_parts=prev_parts, old_fps_list=prev_fps,
                    new_parts=sccs, new_fps_list=fps,
                )
                rec.event("delta.classified", **diff.summary())
            self._prev = (graph, sccs, fps)
        if len(st.quorum_scc_ids) == 1:
            st.target_index = 0 if self.scc_select == "front" else st.quorum_scc_ids[0]
            st.target_scc = sccs[st.target_index]
            st.target_fp, closed = fps[st.target_index]
            # Soundness gate (fbas/diff.py module docstring): under the
            # reference's whole-graph availability a stored verdict is only
            # reusable when the component cannot see outside itself.
            st.cacheable = closed or self.scope_to_scc
        st.timers = dict(timers.totals)
        return st

    def _serve_scans(
        self, graph: TrustGraph, sccs: List[List[int]]
    ) -> Tuple[List[Optional[List[int]]], List[Tuple[str, bool]], int, int]:
        """Per-SCC quorum scans with the store in front: every
        fingerprint-matched SCC's scan comes from the store, misses run the
        real :func:`pipeline.scan_scc_quorums` and are banked.  Returns
        ``(quorums, fingerprints, reused, fresh)``."""
        fps = [scc_fingerprint(graph, members) for members in sccs]
        quorums: List[Optional[List[int]]] = [None] * len(sccs)
        miss_ids: List[int] = []
        reused = 0
        for sid, members in enumerate(sccs):
            scan = self.store.get_scan(fps[sid][0])
            if scan is None:
                miss_ids.append(sid)
            else:
                quorums[sid] = project(list(scan.quorum_local), members)
                reused += 1
        if miss_ids:
            fresh = scan_scc_quorums(graph, [sccs[sid] for sid in miss_ids])
            for sid, quorum in zip(miss_ids, fresh):
                quorums[sid] = quorum
                local = localize(quorum, sccs[sid])
                if local is not None:
                    self.store.put_scan(fps[sid][0], SccScan(quorum_local=tuple(local)))
        return quorums, fps, reused, len(miss_ids)

    # ---- composition ------------------------------------------------------

    def _compose(self, st: _SourceState, cached: SccVerdict) -> SolveResult:
        """Stitch one cached fragment into a full result + certificate
        against THIS snapshot's graph (guard, node ids and witness evidence
        all rebuilt fresh — see module docstring)."""
        rec = get_run_record()
        t0 = time.perf_counter()
        q1 = project(cached.q1_local, st.target_scc)
        q2 = project(cached.q2_local, st.target_scc)
        stats: Dict[str, object] = _project_pruned_evidence(dict(cached.stats), st.graph, st.target_scc)
        stats["delta"] = {"reused": True, "solved_seconds": stats.get("seconds")}
        # A reused SCC did zero new device work: its cost is a reuse CREDIT
        # (the lane·windows the cached solve booked), replacing the cached
        # stats' own cost so reuse is never billed twice.  Degrades to no
        # cost, never a wrong verdict.
        try:
            fault_point("cost.attribute")
            cached_cost = stats.get("cost")
            stats["cost"] = reuse_credit(cached_cost if isinstance(cached_cost, dict) else None)
        except (FaultInjected, OSError) as exc:
            stats.pop("cost", None)
            rec.add("cost.attribute_errors")
            rec.event("cost.degraded", site="delta.compose", error=repr(exc))
        delta_stamp = {
            "schema": DELTA_SCHEMA,
            "reused_sccs": 1,
            "resolved_sccs": 0,
            "scan_reused": st.scan_reused,
            "scan_fresh": st.scan_fresh,
        }
        timers = dict(st.timers)
        timers["search"] = time.perf_counter() - t0
        stats["seconds"] = timers["search"]
        res = SolveResult(
            intersects=cached.intersects,
            n_sccs=st.n_sccs,
            quorum_scc_ids=list(st.quorum_scc_ids),
            main_scc=st.main_scc,
            q1=q1,
            q2=q2,
            stats=stats,
            timers=timers,
            cert=build_certificate(
                st.graph, intersects=cached.intersects, reason="search",
                n_sccs=st.n_sccs, quorum_bearing=len(st.quorum_scc_ids),
                scc_select=self.scc_select, scope_to_scc=self.scope_to_scc,
                stats=stats, q1=q1, q2=q2,
                target_scc=st.target_scc, target_scc_index=st.target_index,
                events=rec.events_since(st.ev0), batched=True, delta=delta_stamp,
            ),
        )
        rec.event("delta.composed", fingerprint=st.target_fp, verdict=cached.intersects,
                  backend=stats.get("backend"))
        return res

    def _guard_result(self, st: _SourceState) -> SolveResult:
        """Guard-decided snapshot (zero or >= 2 quorum-bearing SCCs) —
        exactly :func:`pipeline.check_many`'s guard path, with the scans
        possibly served from the store."""
        rec = get_run_record()
        q1 = q2 = None
        if len(st.quorum_scc_ids) >= 2:
            q1 = st.scc_quorums[st.quorum_scc_ids[0]]
            q2 = st.scc_quorums[st.quorum_scc_ids[1]]
        delta_stamp = {
            "schema": DELTA_SCHEMA,
            "reused_sccs": 0,
            "resolved_sccs": 0,
            "scan_reused": st.scan_reused,
            "scan_fresh": st.scan_fresh,
        }
        return SolveResult(
            intersects=False, n_sccs=st.n_sccs,
            quorum_scc_ids=list(st.quorum_scc_ids), main_scc=st.main_scc,
            q1=q1, q2=q2, stats={"reason": "scc_guard"},
            timers=dict(st.timers),
            cert=build_certificate(
                st.graph, intersects=False, reason="scc_guard",
                n_sccs=st.n_sccs, quorum_bearing=len(st.quorum_scc_ids),
                scc_select=self.scc_select, scope_to_scc=self.scope_to_scc,
                stats={"reason": "scc_guard"}, q1=q1, q2=q2,
                events=rec.events_since(st.ev0), batched=True, delta=delta_stamp,
            ),
        )

    # ---- backend solves ---------------------------------------------------

    def _solve_misses(
        self,
        misses: List[_SourceState],
        results: List[Optional[SolveResult]],
        backend: Union[str, SearchBackend],
        pack: Optional[bool],
        held: Set[str],
        cancels: Optional[Sequence[Optional[CancelToken]]] = None,
        origins: Optional[Sequence[str]] = None,
    ) -> None:
        """Send the dirty/new target SCCs to the real backend (one batched
        ``check_many`` call — lane packing and the router apply as ever),
        then bank each solved fragment and release its lease.  ``cancels``
        is source-aligned on the outer batch; only the miss subset rides
        along.  The backend's exception leaves as :class:`_BackendFailure`."""
        get_run_record().add("delta.solves", len(misses))
        # The classification prefix already scanned every one of these
        # snapshots; check_many re-derives the same partition from the same
        # Fbas deterministically, so the re-solve leg re-serves the prefix's
        # per-SCC quorums verbatim (non-quorum SCCs scanned empty) — no
        # fixpoint, fingerprint or store work re-runs, and the delta.scan_*
        # counters count each SCC exactly once.
        seq = iter(misses)

        def prefix_scan(g: TrustGraph, sccs: List[List[int]]) -> List[Optional[List[int]]]:
            st = next(seq)
            return [st.scc_quorums.get(sid, []) for sid in range(len(sccs))]

        try:
            solved = check_many(
                [st.fbas for st in misses], backend=backend, device=self.device,
                dangling=self.dangling, scc_select=self.scc_select,
                scope_to_scc=self.scope_to_scc, pack=pack,
                cancels=[cancels[st.ix] for st in misses] if cancels is not None else None,
                origins=[origins[st.ix] for st in misses] if origins is not None else None,
                delta={"schema": DELTA_SCHEMA, "reused_sccs": 0, "resolved_sccs": 1},
                scan=prefix_scan,
            )
        except Exception as exc:
            raise _BackendFailure() from exc
        for st, res in zip(misses, solved):
            results[st.ix] = res
            self._bank(st, res, held)

    def _bank(self, st: _SourceState, res: SolveResult, held: Set[str]) -> None:
        """Store one freshly solved fragment and publish its lease.

        Publishes a failed lease (followers re-contend) whenever the fragment
        could not faithfully re-serve: an un-closed SCC under whole-graph
        availability, a guard flip mid-flight, or a witness that escaped the
        component."""
        publishable: Optional[SccVerdict] = None
        if res.stats.get("cancelled"):
            # A retired job's partial coverage is NOT a verdict — banking it
            # would serve a non-answer to every future match.
            if st.target_fp in held:
                held.discard(st.target_fp)
                self.store.publish_verdict(st.target_fp, self.scope_to_scc, None)
            return
        if st.cacheable and res.stats.get("reason") != "scc_guard":
            q1_local = localize(res.q1, st.target_scc)
            q2_local = localize(res.q2, st.target_scc)
            witness_ok = res.intersects or (q1_local is not None and q2_local is not None)
            if witness_ok:
                stats = _localize_pruned_evidence(
                    ledger_stats({k: v for k, v in res.stats.items() if k not in _VOLATILE_STATS}),
                    st.graph, st.target_scc,
                )
                if stats is not None:
                    publishable = SccVerdict(
                        intersects=bool(res.intersects), q1_local=q1_local, q2_local=q2_local, stats=stats,
                    )
        if st.target_fp in held:
            held.discard(st.target_fp)
            self.store.publish_verdict(st.target_fp, self.scope_to_scc, publishable)
        elif publishable is not None:
            # An intra-batch straggler re-solved after its leader's fragment
            # failed to land: bank the fresh fragment directly.
            self.store.publish_verdict(st.target_fp, self.scope_to_scc, publishable)


def backend_name(backend: Union[str, SearchBackend, None]) -> str:
    """Best-effort backend name (the ``delta.check`` span's attribute)."""
    if backend is None:
        return "auto"
    if isinstance(backend, str):
        return backend
    return getattr(backend, "name", "auto")
