"""qi-query/1 — typed queries over one snapshot, the port of the JAX
package's ``query.py``.

Four kinds, each resolving through the port's engines and each with a
certificate the unmodified ``tools/check_cert.py`` accepts:

- **``intersection``** — the boolean verdict, unchanged.  It does not pass
  through the ``query.dispatch`` fault point.
- **``relaxed``** — two-family mode (Fast Flexible Paxos, arXiv:2008.02671):
  a second quorum-set family over the same node set; does every family-A
  quorum intersect every family-B quorum?  Family A's windows inside its
  quorum-bearing SCC(s) are enumerated on the host, vectorized over window
  batches through the two-circuit restriction
  (``encode.circuit.restrict_two_family``); each distinct A-quorum is guarded
  by one family-B fixpoint.  A ``false`` verdict carries a cross-family
  witness pair with per-member slice evidence against each family's graph.
- **``whatif``** — does the network survive if validators X, Y, Z leave?  The
  removal frontier (subsets of the candidates up to ``max_k``) becomes masked
  variants of one topology (a departed validator's quorum set is nulled,
  never deleted, so every variant keeps one shape) decided in one
  :func:`pipeline.check_many` call: under ``gpu-sweep`` the variants
  lane-pack through the packed kernels.  The result is a per-subset verdict
  table and the minimal failing subset.
- **``analytics``** — top tier, minimal blocking set, minimum splitting set
  and PageRank (``analytics/``) as result certificates
  (``qi-query-cert/1``); blocking and splitting results embed a re-provable
  ``qi-cert/1`` of the masked or reduced network.

Every non-intersection kind passes the ``query.dispatch`` fault point first;
an injected or real failure becomes a typed :class:`QueryError`, never a
wrong or missing verdict.  The default batch solver is
:func:`pipeline.check_many`; the serving layer injects its own
(``check_many_fn=``: delta-aware, cancellable, fused across requests).

CLI: ``python -m quorum_intersection_tpu_torch query`` (one query over the
node array on stdin; the result as one JSON line).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from dataclasses import dataclass, field
from itertools import combinations
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from quorum_intersection_tpu_torch.cert import CERT_SCHEMA, witness_evidence
from quorum_intersection_tpu_torch.device import DeviceLike
from quorum_intersection_tpu_torch.encode.circuit import encode_circuit, max_quorum_np, restrict_two_family
from quorum_intersection_tpu_torch.fbas.graph import TrustGraph, build_graph
from quorum_intersection_tpu_torch.fbas.schema import Fbas, parse_fbas
from quorum_intersection_tpu_torch.fbas.semantics import cross_family_disjoint_quorum, max_quorum
from quorum_intersection_tpu_torch.pipeline import SolveResult, check_many, quorum_bearing_sccs
from quorum_intersection_tpu_torch.utils.env import qi_env_int
from quorum_intersection_tpu_torch.utils.faults import FaultInjected, fault_point
from quorum_intersection_tpu_torch.utils.logging import get_logger
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record

log = get_logger("query")

QUERY_SCHEMA = "qi-query/1"
QUERY_CERT_SCHEMA = "qi-query-cert/1"

KINDS = ("intersection", "relaxed", "whatif", "analytics")
ANALYTICS_METRICS = ("top_tier", "blocking_set", "splitting_set", "pagerank")
BACKENDS = ("auto", "gpu-sweep", "gpu-frontier", "cpp", "python")

# Windows one vectorized relaxed chunk evaluates at once.
RELAXED_CHUNK = 2048
# Size cap on one relaxed enumeration: past 2^22 windows the query is a
# typed error, not an unbounded burn.
RELAXED_SCC_MAX = 22
# The what-if default candidate pool (the main SCC's members) is clipped to
# this many, in vertex order, before the C(candidates, k) expansion.
WHATIF_CANDIDATES_MAX = 16

_CheckMany = Callable[[List[Fbas]], List[SolveResult]]


class QueryError(ValueError):
    """Typed query-layer failure (the ``query.dispatch`` degrade target): an
    unknown kind, a malformed parameter, an over-budget frontier or an
    injected dispatch fault.  ``code`` names which."""

    code = "query_error"

    def __init__(self, message: str, code: Optional[str] = None) -> None:
        super().__init__(message)
        if code is not None:
            self.code = code


@dataclass(frozen=True)
class Query:
    """One parsed, validated typed query (``qi-query/1``)."""

    kind: str = "intersection"
    family_b: Optional[Tuple[str, ...]] = None  # canonical JSON per node
    candidates: Optional[Tuple[str, ...]] = None
    max_k: int = 1
    metric: Optional[str] = None
    splitting_max_k: int = 2

    @staticmethod
    def parse(raw: object) -> "Query":
        """Parse the wire form: ``None`` ⇒ intersection, a string ⇒
        ``{"kind": str}``, a dict ⇒ full parameters.  Anything unknown or
        malformed raises a typed :class:`QueryError`."""
        if raw is None:
            return Query()
        if isinstance(raw, str):
            raw = {"kind": raw}
        if not isinstance(raw, dict):
            raise QueryError(f"query must be a kind string or an object, got {type(raw).__name__}",
                             code="invalid_query")
        kind = raw.get("kind", "intersection")
        if kind not in KINDS:
            raise QueryError(f"unknown query kind {kind!r} (expected one of {KINDS})", code="unknown_query")
        family_b: Optional[Tuple[str, ...]] = None
        if kind == "relaxed":
            fb = raw.get("family_b")
            if not isinstance(fb, list) or not fb:
                raise QueryError(
                    "relaxed query requires family_b: a non-empty stellarbeat node array (the second "
                    "quorum-set family over the same node set)", code="invalid_query",
                )
            family_b = tuple(json.dumps(n, sort_keys=True, separators=(",", ":")) for n in fb)
        candidates: Optional[Tuple[str, ...]] = None
        if raw.get("candidates") is not None:
            cand = raw.get("candidates")
            if not isinstance(cand, list) or not all(isinstance(c, str) for c in cand):
                raise QueryError("whatif candidates must be a list of publicKeys", code="invalid_query")
            candidates = tuple(cand)
        max_k = raw.get("max_k", 1)
        if not isinstance(max_k, int) or isinstance(max_k, bool) or max_k < 1:
            raise QueryError(f"whatif max_k must be a positive integer, got {max_k!r}", code="invalid_query")
        metric: Optional[str] = None
        if kind == "analytics":
            metric = raw.get("metric")
            if metric not in ANALYTICS_METRICS:
                raise QueryError(f"unknown analytics metric {metric!r} (expected one of {ANALYTICS_METRICS})",
                                 code="unknown_query")
        smk = raw.get("splitting_max_k", 2)
        if not isinstance(smk, int) or isinstance(smk, bool) or smk < 0:
            raise QueryError(f"splitting_max_k must be a non-negative integer, got {smk!r}",
                             code="invalid_query")
        return Query(kind=str(kind), family_b=family_b, candidates=candidates, max_k=int(max_k),
                     metric=metric, splitting_max_k=int(smk))

    def family_b_nodes(self) -> List[Dict[str, object]]:
        """The second family's raw node list (relaxed queries only)."""
        assert self.family_b is not None
        return [json.loads(n) for n in self.family_b]

    def to_wire(self) -> Optional[Dict[str, object]]:
        """The JSON wire form (``None`` for the intersection query)."""
        if self.kind == "intersection":
            return None
        out: Dict[str, object] = {"kind": self.kind}
        if self.family_b is not None:
            out["family_b"] = self.family_b_nodes()
        if self.candidates is not None:
            out["candidates"] = list(self.candidates)
        if self.kind == "whatif":
            out["max_k"] = self.max_k
        if self.metric is not None:
            out["metric"] = self.metric
            if self.metric == "splitting_set":
                out["splitting_max_k"] = self.splitting_max_k
        return out

    def fingerprint(self) -> str:
        """Cache and routing key component: empty for intersection, else a
        digest of the canonical wire form, so ``fingerprint(parse(to_wire(q)))
        == fingerprint(q)`` and fingerprints never cross kinds."""
        if self.kind == "intersection":
            return ""
        return hashlib.sha256(
            json.dumps({"v": 2, "wire": self.to_wire()}, sort_keys=True, separators=(",", ":")).encode()
        ).hexdigest()[:16]


@dataclass
class QueryResult:
    """One resolved query: verdict, structured payload and certificate (the
    ``intersects``/``cert``/``stats`` slice of :class:`pipeline.SolveResult`)."""

    kind: str
    verdict: bool
    result: Dict[str, object] = field(default_factory=dict)
    cert: Optional[Dict[str, object]] = None
    stats: Dict[str, object] = field(default_factory=dict)

    @property
    def intersects(self) -> bool:
        return bool(self.verdict)


def mask_nodes(nodes: Sequence[Dict[str, object]], removed: Sequence[str]) -> List[Dict[str, object]]:
    """One what-if variant: the departed validators' quorum sets nulled,
    never deleted (a null qset is never satisfiable), so every variant of one
    base keeps its node count and order and one circuit shape."""
    gone = frozenset(removed)
    return [{**node, "quorumSet": None} if node.get("publicKey") in gone else dict(node) for node in nodes]


def _default_check_many(backend: object, device: DeviceLike, dangling: str, scc_select: str,
                        scope_to_scc: bool, pack: Optional[bool]) -> _CheckMany:
    def run(sources: List[Fbas]) -> List[SolveResult]:
        return check_many(sources, backend=backend, device=device, dangling=dangling,  # type: ignore[arg-type]
                          scc_select=scc_select, scope_to_scc=scope_to_scc, pack=pack)

    return run


class QueryEngine:
    """Resolver for the four query kinds.  ``backend`` and ``device`` are
    those of :func:`pipeline.check_many` (a name or a backend; ``device``
    None is CUDA); PageRank runs on ``device`` too."""

    def __init__(
        self,
        *,
        backend: object = "auto",
        device: DeviceLike = None,
        dangling: str = "strict",
        scc_select: str = "quorum-bearing",
        scope_to_scc: bool = False,
        pack: Optional[bool] = None,
        whatif_limit: Optional[int] = None,
    ) -> None:
        self.backend = backend
        self.device = device
        self.dangling = dangling
        self.scc_select = scc_select
        self.scope_to_scc = scope_to_scc
        self.pack = pack
        self.whatif_limit = (whatif_limit if whatif_limit is not None
                             else max(qi_env_int("QI_QUERY_WHATIF_LIMIT", 512), 1))

    # ---- dispatch --------------------------------------------------------

    def resolve(
        self,
        nodes: List[Dict[str, object]],
        query: Query,
        *,
        check_many_fn: Optional[_CheckMany] = None,
        cancel: Optional[object] = None,
    ) -> QueryResult:
        """Resolve one typed query against one snapshot.

        Every non-intersection kind passes the ``query.dispatch`` fault
        point first; an injected fault or any resolver failure becomes a
        typed :class:`QueryError`.  ``cancel`` (a ``CancelToken``) is checked
        per relaxed window chunk and between the analytics' SCCs, raising
        ``SearchCancelled``, which propagates untouched."""
        from quorum_intersection_tpu_torch.backends.base import SearchCancelled

        rec = get_run_record()
        run = check_many_fn or _default_check_many(self.backend, self.device, self.dangling,
                                                   self.scc_select, self.scope_to_scc, self.pack)
        rec.add("query.requests")
        if query.kind == "intersection":
            res = run([parse_fbas(nodes)])[0]
            return QueryResult(kind="intersection", verdict=bool(res.intersects),
                               result={"kind": "intersection", "verdict": bool(res.intersects)},
                               cert=res.cert, stats=dict(res.stats))
        rec.add(f"query.{query.kind}")
        try:
            fault_point("query.dispatch")
            if query.kind == "relaxed":
                out = self._resolve_relaxed(nodes, query, cancel)
            elif query.kind == "whatif":
                out = self._resolve_whatif(nodes, query, run)
            elif query.kind == "analytics":
                out = self._resolve_analytics(nodes, query, cancel)
            else:  # unreachable past Query.parse; typed anyway
                raise QueryError(f"unknown query kind {query.kind!r}", code="unknown_query")
        except (QueryError, SearchCancelled):
            rec.add("query.errors")
            raise
        except (FaultInjected, OSError) as exc:
            rec.add("query.errors")
            rec.event("query.degraded", kind=query.kind, error=str(exc))
            log.warning("query dispatch degraded (%s); typed error, never a wrong verdict", exc)
            raise QueryError(f"query dispatch degraded: {exc}", code="query_degraded") from exc
        except Exception as exc:  # noqa: BLE001 — any resolver failure is a typed error
            rec.add("query.errors")
            rec.event("query.degraded", kind=query.kind, error=str(exc))
            raise QueryError(f"{query.kind} query failed: {exc}", code="query_failed") from exc
        rec.event("query.dispatched", kind=query.kind, verdict=out.verdict)
        return out

    # ---- relaxed (two-family) -------------------------------------------

    def _resolve_relaxed(self, nodes: List[Dict[str, object]], query: Query,
                         cancel: Optional[object] = None) -> QueryResult:
        from quorum_intersection_tpu_torch.fbas.graph import tarjan_scc

        rec = get_run_record()
        graph_a = build_graph(parse_fbas(nodes), dangling=self.dangling)
        nodes_b = query.family_b_nodes()
        graph_b = build_graph(parse_fbas(nodes_b), dangling=self.dangling)
        if list(graph_a.node_ids) != list(graph_b.node_ids):
            raise QueryError("two-family query requires both families over the SAME node set in the same "
                             "order (publicKey sequences differ)", code="invalid_query")
        n_sccs_a, _ = tarjan_scc(graph_a.n, graph_a.succ)
        bearing_a = quorum_bearing_sccs(graph_a)
        b_any = max_quorum(graph_b, range(graph_b.n), [True] * graph_b.n)
        reason = "search"
        qa: Optional[List[int]] = None
        qb: Optional[List[int]] = None
        ledger: List[Dict[str, object]] = []
        engine = "relaxed-host"
        if not bearing_a:
            reason = "no_quorum_family_a"
        elif not b_any:
            reason = "no_quorum_family_b"
        else:
            for sid, members in bearing_a:
                if len(members) > RELAXED_SCC_MAX:
                    raise QueryError(f"relaxed enumeration over a {len(members)}-node SCC exceeds the "
                                     f"2^{RELAXED_SCC_MAX} window budget", code="query_overbudget")
                qa, qb, enumerated, engine = _relaxed_search(graph_a, graph_b, members, cancel=cancel)
                ledger.append({
                    "scc_index": sid,
                    "size": len(members),
                    "nodes": [graph_a.node_ids[v] for v in members],
                    "window_space": (1 << len(members)) - 1,
                    "windows_enumerated": enumerated,
                    "backend": engine,
                })
                if qa is not None:
                    break
        verdict = qa is None
        cert = self._relaxed_certificate(graph_a, graph_b, nodes_b, verdict=verdict, reason=reason,
                                         n_sccs=n_sccs_a, bearing=len(bearing_a), qa=qa, qb=qb,
                                         ledger=ledger, engine=engine)
        result: Dict[str, object] = {
            "kind": "relaxed",
            "verdict": verdict,
            "reason": reason,
            "windows_enumerated": sum(int(e["windows_enumerated"]) for e in ledger),  # type: ignore[arg-type]
        }
        if qa is not None and qb is not None:
            result["witness"] = {"family_a": [graph_a.node_ids[v] for v in qa],
                                 "family_b": [graph_b.node_ids[v] for v in qb]}
        rec.event("query.relaxed_resolved", verdict=verdict, reason=reason)
        return QueryResult(kind="relaxed", verdict=verdict, result=result, cert=cert,
                           stats={"backend": engine, "reason": reason})

    def _relaxed_certificate(
        self,
        graph_a: TrustGraph,
        graph_b: TrustGraph,
        nodes_b: List[Dict[str, object]],
        *,
        verdict: bool,
        reason: str,
        n_sccs: int,
        bearing: int,
        qa: Optional[List[int]],
        qb: Optional[List[int]],
        ledger: List[Dict[str, object]],
        engine: str,
    ) -> Dict[str, object]:
        """A ``qi-cert/1`` certificate with a ``query`` block: family B rides
        inside it, so the checker validates the witness pair against each
        family's own nodes and the two-family ledger arithmetic."""
        rec = get_run_record()
        cert: Dict[str, object] = {
            "schema": CERT_SCHEMA,
            "verdict": verdict,
            "dangling": graph_a.dangling,
            "scc_select": self.scc_select,
            "scope_to_scc": False,
            "graph": {"n": graph_a.n, "edges": graph_a.n_edges},
            "query": {"kind": "relaxed", "family_b": nodes_b},
            "guard": {"n_sccs": n_sccs, "quorum_bearing_sccs": bearing, "reason": reason},
            "provenance": {"backend": engine, "trace_id": rec.trace_id, "query_kind": "relaxed"},
        }
        if verdict:
            cert["coverage"] = {"sccs": list(ledger)}
            if reason != "search":
                cert["vacuous"] = reason
        else:
            assert qa is not None and qb is not None
            cert["witness"] = {
                "convention": "q1=family-A quorum, q2=family-B quorum (relaxed two-family mode)",
                "q1": [graph_a.node_ids[v] for v in qa],
                "q2": [graph_b.node_ids[v] for v in qb],
                "q1_index": list(qa),
                "q2_index": list(qb),
                "evidence": {"q1": witness_evidence(graph_a, qa), "q2": witness_evidence(graph_b, qb)},
            }
        rec.add("cert.certificates")
        rec.event("cert.emitted", verdict=verdict, backend=engine, reason=f"relaxed:{reason}")
        return cert

    # ---- whatif ----------------------------------------------------------

    def _resolve_whatif(self, nodes: List[Dict[str, object]], query: Query, run: _CheckMany) -> QueryResult:
        rec = get_run_record()
        graph = build_graph(parse_fbas(nodes), dangling=self.dangling)
        known = set(graph.node_ids)
        if query.candidates is not None:
            candidates = list(query.candidates)
            missing = [c for c in candidates if c not in known]
            if missing:
                raise QueryError(f"whatif candidates not in the snapshot: {missing}", code="invalid_query")
        else:
            # The quorum-bearing SCC's members (whose departure can change the
            # verdict), clipped in vertex order.
            pool: List[str] = []
            for _sid, members in quorum_bearing_sccs(graph):
                pool.extend(graph.node_ids[v] for v in sorted(members))
            candidates = pool[:WHATIF_CANDIDATES_MAX]
        subsets: List[Tuple[str, ...]] = [()]
        truncated = False
        for k in range(1, min(query.max_k, len(candidates)) + 1):
            for combo in combinations(candidates, k):
                if len(subsets) >= self.whatif_limit:
                    truncated = True
                    break
                subsets.append(combo)
            if truncated:
                break
        if truncated:
            log.warning("whatif frontier truncated at %d variants (QI_QUERY_WHATIF_LIMIT)", self.whatif_limit)
        variants = [parse_fbas(mask_nodes(nodes, subset)) for subset in subsets]
        rec.add("query.whatif_variants", len(variants))
        results = run(variants)
        if any(res.stats.get("cancelled") for res in results):
            from quorum_intersection_tpu_torch.backends.base import SearchCancelled

            raise SearchCancelled("what-if variants cancelled mid-solve (request deadline)")
        rows: List[Dict[str, object]] = []
        minimal_failing: Optional[List[str]] = None
        failing_cert: Optional[Dict[str, object]] = None
        for subset, res in zip(subsets, results):
            rows.append({"removed": list(subset), "verdict": bool(res.intersects),
                         "reason": str(res.stats.get("reason", "search"))})
            if not res.intersects and subset and minimal_failing is None:
                # Subsets expand in (size, lexicographic) order: the first
                # failing non-empty one is of minimum size.
                minimal_failing = list(subset)
                failing_cert = res.cert
        verdict = all(bool(r["verdict"]) for r in rows)
        base_cert = dict(results[0].cert or {})
        base_cert["query"] = {"kind": "whatif", "candidates": list(candidates), "max_k": query.max_k}
        result: Dict[str, object] = {
            "kind": "whatif",
            "verdict": verdict,
            "base_verdict": bool(results[0].intersects),
            "candidates": list(candidates),
            "max_k": query.max_k,
            "variants": len(subsets),
            "truncated": truncated,
            "table": rows,
            "minimal_failing": minimal_failing,
        }
        if failing_cert is not None:
            # Checkable against mask_nodes(base, minimal_failing).
            result["failing_cert"] = failing_cert
        rec.event("query.whatif_resolved", verdict=verdict, variants=len(subsets),
                  minimal_failing=len(minimal_failing or []))
        return QueryResult(kind="whatif", verdict=verdict, result=result, cert=base_cert,
                           stats={"backend": str(results[0].stats.get("backend", "?")), "variants": len(subsets)})

    # ---- analytics -------------------------------------------------------

    def _resolve_analytics(self, nodes: List[Dict[str, object]], query: Query,
                           cancel: Optional[object] = None) -> QueryResult:
        from quorum_intersection_tpu_torch.pipeline import solve

        rec = get_run_record()
        graph = build_graph(parse_fbas(nodes), dangling=self.dangling)
        metric = query.metric or "top_tier"
        _check_cancel(cancel)
        payload: Dict[str, object] = {"kind": "analytics", "metric": metric}
        proof: Optional[Dict[str, object]] = None
        if metric == "top_tier":
            from quorum_intersection_tpu_torch.analytics.top_tier import top_tier

            members: List[int] = []
            quorum_count = 0
            exceeded = False
            for _sid, scc in quorum_bearing_sccs(graph):
                _check_cancel(cancel)
                part, n_min = top_tier(graph, scc)
                if part is None:
                    exceeded = True
                    break
                members.extend(part)
                quorum_count += n_min
            payload.update({"members": sorted(graph.node_ids[v] for v in members),
                            "minimal_quorums": quorum_count, "exceeded": exceeded})
        elif metric == "blocking_set":
            from quorum_intersection_tpu_torch.analytics.resilience import minimal_blocking_set, minimum_blocking_size

            blocking: List[int] = []
            minimum_total: Optional[int] = 0
            for _sid, scc in quorum_bearing_sccs(graph):
                _check_cancel(cancel)
                part = minimal_blocking_set(graph, scc)
                blocking.extend(part)
                minimum = minimum_blocking_size(graph, scc, upper=len(part))
                minimum_total = None if (minimum is None or minimum_total is None) else minimum_total + minimum
            keys = sorted(graph.node_ids[v] for v in blocking)
            payload.update({"blocking": keys, "minimum_size": minimum_total})
            if keys:
                # Re-proof: with the blocking set masked out no quorum
                # survives, so the masked solve claims no_quorum.
                masked = mask_nodes(nodes, keys)
                res = solve(masked, backend="python", dangling=self.dangling)
                proof = {"cert": res.cert, "nodes": masked, "claim": "blocking-halts"}
        elif metric == "splitting_set":
            from quorum_intersection_tpu_torch.analytics.splitting import (
                POOL_LIMIT,
                delete_nodes,
                minimum_splitting_set,
            )

            pool: List[str] = []
            for _sid, scc in quorum_bearing_sccs(graph):
                pool.extend(graph.node_ids[v] for v in scc)
            if len(pool) > POOL_LIMIT:
                raise QueryError(f"splitting-set candidate pool {len(pool)} > {POOL_LIMIT}",
                                 code="query_overbudget")
            split = minimum_splitting_set(nodes, max_k=query.splitting_max_k, dangling=self.dangling, pool=pool)
            payload.update({"splitting": split, "max_k": query.splitting_max_k})
            if split:
                # Re-proof: the reduced network's false certificate.
                reduced = delete_nodes(nodes, split)
                res = solve(reduced, backend="python", dangling=self.dangling)
                proof = {"cert": res.cert, "nodes": reduced, "claim": "splitting-witness"}
        else:  # pagerank
            from quorum_intersection_tpu_torch.analytics.pagerank import pagerank_auto

            ranks, engine = pagerank_auto(graph, device=self.device)
            order = sorted(range(graph.n), key=lambda v: (-ranks[v], graph.node_ids[v]))
            payload.update({"engine": engine,
                            "ranks": [[graph.node_ids[v], round(float(ranks[v]), 8)] for v in order]})
        digest = hashlib.sha256(
            json.dumps(payload, sort_keys=True, separators=(",", ":"), default=str).encode()
        ).hexdigest()[:32]
        cert: Dict[str, object] = {
            "schema": QUERY_CERT_SCHEMA,
            "query": {"kind": "analytics", "metric": metric},
            "result_digest": digest,
            "provenance": {"trace_id": rec.trace_id, "dangling": graph.dangling, "scc_select": self.scc_select},
        }
        if proof is not None:
            cert["proof"] = proof
            # The claimed set rides in the cert, so the checker re-derives
            # the proof's network from the primary snapshot.
            cert["result"] = {k: payload[k] for k in ("blocking", "splitting") if k in payload}
        rec.event("query.analytics_resolved", metric=metric)
        # Analytics are reports, not verdicts: like -p they succeed as a
        # query whatever the numbers say.
        return QueryResult(kind="analytics", verdict=True, result=payload, cert=cert,
                           stats={"backend": "analytics", "metric": metric})


# ---- the relaxed search --------------------------------------------------------


def _check_cancel(cancel: Optional[object]) -> None:
    """Raise ``SearchCancelled`` once the token is tripped."""
    if cancel is not None and getattr(cancel, "cancelled", False):
        from quorum_intersection_tpu_torch.backends.base import SearchCancelled

        raise SearchCancelled("query cancelled by deadline supervisor")


def _relaxed_search(
    graph_a: TrustGraph, graph_b: TrustGraph, members: List[int], cancel: Optional[object] = None,
) -> Tuple[Optional[List[int]], Optional[List[int]], int, str]:
    """The relaxed enumeration over one family-A SCC, vectorized on the
    host: ``(qa, qb, windows_enumerated, engine)``.

    Family A's scoped circuit evaluates whole window batches through
    :func:`max_quorum_np`; family B's scoped twin is the fast overlap guard,
    and :func:`cross_family_disjoint_quorum` the sound slow guard for
    B-quorums leaning on nodes outside the SCC.  Window order, memoization of
    distinct A-quorums and the first witness window are those of the host
    oracle ``fbas.semantics.relaxed_disjoint_witness``.
    """
    m = len(members)
    a_scoped, b_scoped, _b_q6 = restrict_two_family(encode_circuit(graph_a), encode_circuit(graph_b), list(members))
    member_arr = np.asarray(members, dtype=np.int64)
    bits = np.arange(m, dtype=np.int64)
    enumerated = 0
    seen: Dict[bytes, bool] = {}
    for start in range(1, 1 << m, RELAXED_CHUNK):
        _check_cancel(cancel)
        stop = min(start + RELAXED_CHUNK, 1 << m)
        idx = np.arange(start, stop, dtype=np.int64)
        masks = ((idx[:, None] >> bits) & 1).astype(bool)
        fixes = max_quorum_np(a_scoped, masks)
        nonempty = fixes.any(axis=1)
        for i in range(len(idx)):
            enumerated += 1
            if not nonempty[i]:
                continue
            key = fixes[i].tobytes()
            if key in seen:
                continue
            qa_local = fixes[i]
            qa_global = [int(v) for v in member_arr[qa_local]]
            # Fast guard: a B-quorum inside scc ∖ qa under scoped
            # availability is a real B-quorum.
            qb_fix = max_quorum_np(b_scoped, ~qa_local[None, :])[0]
            if qb_fix.any():
                seen[key] = True
                return sorted(qa_global), sorted(int(v) for v in member_arr[qb_fix]), enumerated, "relaxed-vector"
            # Sound slow guard: whole-graph availability for family B.
            qb = cross_family_disjoint_quorum(graph_b, qa_global)
            seen[key] = bool(qb)
            if qb:
                return sorted(qa_global), sorted(qb), enumerated, "relaxed-vector"
    return None, None, enumerated, "relaxed-vector"


# ---- the CLI subcommand ---------------------------------------------------------


def build_query_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m quorum_intersection_tpu_torch query",
        description=("One-shot typed query (qi-query/1) over a stellarbeat node array on stdin; the JSON "
                     "result prints to stdout."),
    )
    p.add_argument("--kind", default="intersection", choices=list(KINDS), help="query kind (default intersection)")
    p.add_argument("--family-b", metavar="PATH", default=None,
                   help="relaxed mode: the second quorum-set family (a stellarbeat node array over the SAME "
                        "node set)")
    p.add_argument("--remove", action="append", default=None, metavar="KEY",
                   help="whatif mode: candidate validator publicKey (repeatable; default: the quorum-bearing "
                        "SCC's members)")
    p.add_argument("--max-k", type=int, default=1, metavar="K",
                   help="whatif mode: removal subsets up to size K (default 1)")
    p.add_argument("--metric", default=None, choices=list(ANALYTICS_METRICS),
                   help="analytics mode: which analysis to serve")
    p.add_argument("--splitting-max-k", type=int, default=2, metavar="K",
                   help="analytics splitting_set search depth (default 2)")
    p.add_argument("--backend", default="auto", choices=list(BACKENDS),
                   help="search backend for solve-backed kinds (default auto)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the sweep and the PageRank kernel run (default cuda)")
    p.add_argument("--dangling-policy", default="strict", choices=["strict", "alias0"])
    p.add_argument("--cert-out", metavar="PATH", default=None,
                   help="write the query certificate to PATH (atomic, cert.write fault point — same "
                        "contract as the verdict CLI's --cert-out)")
    return p


def query_main(argv: Optional[List[str]] = None) -> int:
    """The ``query`` subcommand: exit 0 when the query verdict is true (all
    intersect, the network survives, the analytics ran), 1 when false, and
    1 with a typed JSON error line on a :class:`QueryError`.  A device that
    is not there (``--device cuda`` without a card) exits 1 with a message."""
    from quorum_intersection_tpu_torch.device import resolve_device

    args = build_query_parser().parse_args(argv)
    raw: Dict[str, object] = {"kind": args.kind}
    if args.family_b is not None:
        with open(args.family_b, encoding="utf-8") as fh:
            raw["family_b"] = json.load(fh)
    if args.remove:
        raw["candidates"] = list(args.remove)
    raw["max_k"] = args.max_k
    if args.metric is not None:
        raw["metric"] = args.metric
    raw["splitting_max_k"] = args.splitting_max_k
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        sys.stderr.write(f"device {args.device!r} unavailable: {exc}\n")
        return 1
    try:
        nodes = json.loads(sys.stdin.read())
        if not isinstance(nodes, list):
            raise QueryError("stdin must be a stellarbeat node array", code="invalid_query")
        query = Query.parse(raw)
        engine = QueryEngine(backend=args.backend, device=device, dangling=args.dangling_policy)
        out = engine.resolve(nodes, query)
    except (QueryError, ValueError) as exc:
        sys.stdout.write(json.dumps({
            "schema": QUERY_SCHEMA,
            "error": {"code": getattr(exc, "code", "invalid"), "message": str(exc)},
        }) + "\n")
        return 1
    if args.cert_out and out.cert is not None:
        from quorum_intersection_tpu_torch.cert import write_certificate

        write_certificate(out.cert, args.cert_out)
    sys.stdout.write(json.dumps({"schema": QUERY_SCHEMA, "kind": out.kind, "verdict": out.verdict,
                                 "result": out.result}, default=str) + "\n")
    return 0 if out.verdict else 1
