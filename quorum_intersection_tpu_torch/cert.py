"""qi-cert/1 — checkable verdict certificates, the port's copy of the JAX
package's ``cert.py`` (``:1-322``).

Every verdict carries one:

- **``false``**: the two disjoint quorums in graph-space node ids plus
  per-member slice-satisfaction evidence;
- **``true``**: a coverage ledger for the searched SCC — the sweep's window
  counts (enumerated, pruned by the guard, skipped by pack fill, cancelled;
  they sum to ``2^(|scc|-1)``) with the checkable pruned-block ledger, the
  host oracles' branch-and-bound counts, or the frontier's worklist
  accounting (ledger kind ``tpu-frontier``, engine ``gpu-frontier``);
- **always**: provenance — the engine that answered, the run record's
  ``trace_id``, the router's events of this solve (race, routing, degrade),
  and the front end's dangling-reference decisions; under incremental
  re-analysis also ``delta`` (reused vs re-solved SCCs) and, on a composed
  verdict, ``cost`` (the reuse credit).

``tools/check_cert.py``, a checker that imports only the standard library,
re-validates a certificate against the raw stellarbeat JSON.  Certificates
ride :class:`pipeline.SolveResult` (``cert``) and the CLI's ``--cert-out``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

from quorum_intersection_tpu_torch.fbas.graph import IndexedQSet, TrustGraph
from quorum_intersection_tpu_torch.utils.faults import fault_point
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record

log = logging.getLogger("quorum_intersection_tpu_torch.cert")

CERT_SCHEMA = "qi-cert/1"

# Reference witness-pair convention (cpp:372-373), recorded verbatim in
# every witness block so a consumer never has to guess which side was the
# enumerated quorum: q1 is the disjointness-probe result, q2 the
# enumerated/minimal quorum.
WITNESS_CONVENTION = "q1=disjoint-probe, q2=enumerated (cpp:372-373)"

# The event names a solve's provenance block carries out of the run record:
# routing decisions, race verdicts, ladder transitions, calibration gates,
# engine resolutions, pack builds, and injected faults — the "why this
# engine answered" trail, scoped to the one solve via events_since().  The
# set is the JAX package's, name for name, so certificates from both
# packages speak one vocabulary.
PROVENANCE_EVENTS = frozenset((
    "route.decision",
    "race",
    "degrade",
    "degrade.retry",
    "ladder.quarantined",
    "native.watchdog_cancel",
    "sweep.engine_resolved",
    "sweep.packed",
    "sweep.cancelled",
    "calibration.foreign_artifact_ignored",
    "fault.injected",
))


# Ledger kinds by engine: the card's frontier keeps the ledger of the JAX
# package's device frontier (worklist accounting, `frontier_chunks_drained`),
# under the name the checker knows (tools/check_cert.py); the engine that ran
# is named beside it (`engine`).
LEDGER_KIND = {"gpu-frontier": "tpu-frontier"}


def ledger_stats(stats: Dict[str, object]) -> Dict[str, object]:
    """A result's stats in the form a fragment shared with the JAX package
    is banked in: ``backend`` as the ledger kind, the engine's own name kept
    under ``cert.engine``.  The JAX certificate builder copies ``backend``
    raw and ``stats["cert"]`` whole into its ledger entry, so a port-banked
    ``gpu-frontier`` fragment composes there into an entry the checker
    knows."""
    backend = stats.get("backend")
    if backend not in LEDGER_KIND:
        return stats
    out = dict(stats)
    out["backend"] = LEDGER_KIND[backend]  # type: ignore[index]
    cert_stats = out.get("cert")
    out["cert"] = {**(cert_stats if isinstance(cert_stats, dict) else {}), "engine": backend}
    return out


def _slice_evidence(
    owner: int,
    qset: IndexedQSet,
    member_set: frozenset,
    graph: TrustGraph,
) -> Dict[str, object]:
    """Slice-satisfaction evidence for ``owner``'s quorum slice against a
    witness quorum: which direct members inside the quorum and how many
    recursively-satisfied inner sets meet the threshold.  Mirrors the
    pinned host semantics (fbas/semantics.py slice_satisfied): Q2 null
    qsets never satisfy, Q3 degenerate/unreachable thresholds never
    satisfy, Q4 requires the owner itself inside the quorum."""
    if qset.threshold is None:
        return {"threshold": None, "satisfied": False, "reason": "null qset (Q2)"}
    direct = [v for v in qset.members if v in member_set]
    inner = [
        _slice_evidence(owner, iq, member_set, graph) for iq in qset.inner
    ]
    inner_sat = sum(1 for ev in inner if ev["satisfied"])
    t = qset.threshold
    m_count = len(qset.members) + len(qset.inner)
    satisfied = (
        owner in member_set  # Q4 self-availability
        and 0 < t <= m_count  # Q3 normalization
        and len(direct) + inner_sat >= t
    )
    return {
        "threshold": t,
        "members": m_count,
        "direct_met": [graph.node_ids[v] for v in direct],
        "inner_satisfied": inner_sat,
        "satisfied": satisfied,
    }


def witness_evidence(graph: TrustGraph, quorum: List[int]) -> List[Dict[str, object]]:
    """Per-member slice-satisfaction evidence for one witness quorum —
    the auditable half of a ``false`` certificate."""
    member_set = frozenset(quorum)
    return [
        {
            "id": graph.node_ids[v],
            "index": v,
            **_slice_evidence(v, graph.qsets[v], member_set, graph),
        }
        for v in quorum
    ]


def witness_block(
    graph: TrustGraph, q1: List[int], q2: List[int]
) -> Dict[str, object]:
    """The ``witness`` block of a false certificate: both quorums in
    graph-space node ids plus per-member evidence."""
    return {
        "convention": WITNESS_CONVENTION,
        "q1": [graph.node_ids[v] for v in q1],
        "q2": [graph.node_ids[v] for v in q2],
        "q1_index": list(q1),
        "q2_index": list(q2),
        "evidence": {
            "q1": witness_evidence(graph, q1),
            "q2": witness_evidence(graph, q2),
        },
    }


def ledger_entry(
    graph: TrustGraph, scc: List[int], stats: Dict[str, object],
    scc_index: Optional[int] = None,
) -> Dict[str, object]:
    """One coverage-ledger entry for the SCC a backend searched, from the
    backend's result stats.  Sweep engines contribute the window counters
    maintained in their drive/pack loops (``stats["cert"]``); the host
    oracles echo their B&B node counts."""
    backend = stats.get("backend", "?")
    entry: Dict[str, object] = {
        "scc_index": scc_index,
        "size": len(scc),
        "nodes": [graph.node_ids[v] for v in scc],
        "backend": LEDGER_KIND.get(backend, backend),  # type: ignore[arg-type]
    }
    if backend in LEDGER_KIND:
        entry["engine"] = backend
    cert_stats = stats.get("cert")
    if isinstance(cert_stats, dict):
        entry.update(cert_stats)
    # Oracle B&B counts ride along even for backends that predate the
    # explicit cert stats (defense in depth: the ledger never goes empty).
    for key in ("bnb_calls", "minimal_quorums", "fixpoint_calls",
                "native_call_id"):
        if key in stats and key not in entry:
            entry[key] = stats[key]
    if stats.get("packed"):
        entry["packed"] = True
        if "pack_engine" in stats:
            entry["engine"] = stats["pack_engine"]
    return entry


def build_certificate(
    graph: TrustGraph,
    *,
    intersects: bool,
    reason: str,
    n_sccs: int,
    quorum_bearing: int,
    scc_select: str,
    scope_to_scc: bool,
    stats: Dict[str, object],
    q1: Optional[List[int]] = None,
    q2: Optional[List[int]] = None,
    target_scc: Optional[List[int]] = None,
    target_scc_index: Optional[int] = None,
    events: Optional[List[dict]] = None,
    batched: bool = False,
    delta: Optional[Dict[str, object]] = None,
) -> Dict[str, object]:
    """Assemble one ``qi-cert/1`` certificate and record its summary
    (``cert.emitted`` event, ``cert.certificates`` counter).

    ``delta`` is the incremental re-analysis stamp (:mod:`.delta`): reused
    vs re-solved SCC counts for this verdict, recorded under
    ``provenance.delta`` so a consumer can tell a composed certificate
    (a cached SCC fragment stitched against this snapshot) from a
    from-scratch solve.  Purely provenance: the witness and ledger claims
    are rebuilt against THIS graph either way, so ``tools/check_cert.py``
    checks both alike."""
    rec = get_run_record()
    cert: Dict[str, object] = {
        "schema": CERT_SCHEMA,
        "verdict": bool(intersects),
        "dangling": graph.dangling,
        "scc_select": scc_select,
        "scope_to_scc": bool(scope_to_scc),
        "graph": {"n": graph.n, "edges": graph.n_edges},
        "guard": {
            "n_sccs": n_sccs,
            "quorum_bearing_sccs": quorum_bearing,
            "reason": reason,
        },
        "provenance": {
            "backend": stats.get("backend", reason),
            "trace_id": rec.trace_id,
            "packed": bool(stats.get("packed", False)),
            "batched": bool(batched),
            "native_call_id": stats.get("native_call_id"),
            "race": stats.get("race"),
            "sanitize": {
                "dangling_policy": graph.dangling,
                "dangling_refs": graph.dangling_refs,
            },
            "events": [
                {"name": ev.get("name"), "t_s": ev.get("t_s"),
                 "attrs": ev.get("attrs") or {}}
                for ev in (events or [])
                if ev.get("name") in PROVENANCE_EVENTS
            ],
            # After a MAX_EVENTS overflow the slice above may be empty or
            # clipped; without this flag a consumer cannot distinguish "no
            # routing/degrade events happened" from "the buffer overflowed".
            "events_truncated": rec.events_truncated(),
        },
    }
    if delta is not None:
        cert["provenance"]["delta"] = dict(delta)  # type: ignore[index]
    order = stats.get("order")
    if isinstance(order, dict):
        # Rank-ordered windows: which enumeration permutation the sweep ran
        # under (mode/score source/fixed-out node) — provenance only; the
        # witness and every ledger claim are already in graph-space node ids
        # (a pruned ledger carries its own explicit `enumeration` block).
        cert["provenance"]["order"] = dict(order)  # type: ignore[index]
    encoding = stats.get("encoding")
    if isinstance(encoding, str):
        # Which encoding proved the verdict (only the bitset path stamps it,
        # so dense certificates stay as they were).  Provenance only: the
        # witness and the ledger do not depend on it.
        cert["provenance"]["encoding"] = encoding  # type: ignore[index]
    cost = stats.get("cost")
    if isinstance(cost, dict):
        # qi-cost/1: a composed verdict's reuse credit (cost.py).  Provenance
        # only: the checker ignores it.
        cert["provenance"]["cost"] = dict(cost)  # type: ignore[index]
    summary: Dict[str, object] = {
        "verdict": bool(intersects),
        "backend": stats.get("backend", reason),
        "reason": reason,
    }
    if intersects:
        entry = ledger_entry(
            graph, target_scc or [], stats, scc_index=target_scc_index
        )
        cert["coverage"] = {"sccs": [entry]}
        for key in ("window_space", "windows_enumerated",
                    "windows_pruned_guard", "windows_skipped_pack_fill",
                    "windows_cancelled", "frontier_chunks_drained",
                    "bnb_calls"):
            if key in entry:
                summary[key] = entry[key]
    elif q1 and q2:
        cert["witness"] = witness_block(graph, q1, q2)
        summary["witness_sizes"] = [len(q1), len(q2)]
    else:
        # Zero quorum-bearing SCCs: no quorum exists at all, so no witness
        # pair is possible — the certificate claims (and the checker
        # re-verifies) graph-wide quorum absence instead.
        cert["no_quorum"] = True
        summary["no_quorum"] = True
    rec.add("cert.certificates")
    rec.event("cert.emitted", **summary)
    return cert


def write_certificate(cert: Dict[str, object], path: str) -> Optional[str]:
    """Write one certificate to ``path`` (atomic tmp+rename).

    The write passes the ``cert.write`` fault point.  An ``OSError``
    (injected or real) downgrades to the ``cert.write_errors`` counter plus a
    ``cert.write_error`` event, a logged warning, and None.  A certificate is
    evidence about a verdict; failing to record it must never flip or
    cost the verdict itself."""
    rec = get_run_record()
    try:
        fault_point("cert.write")
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(cert, fh, indent=1, default=str)
            fh.write("\n")
        os.replace(tmp, path)
    except OSError as exc:
        rec.add("cert.write_errors")
        rec.event("cert.write_error", path=str(path), error=str(exc))
        log.warning("certificate write failed (%s); verdict unaffected", exc)
        return None
    rec.add("cert.writes")
    rec.event("cert.written", path=str(path))
    return str(path)
