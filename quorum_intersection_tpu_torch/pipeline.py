"""Orchestration: parse → graph → SCC reduction → guard → backend search.

The port of the JAX package's ``pipeline.py:48-544`` and ``:547-576``: the
exponential search runs in **the** quorum-bearing SCC (the Q5 fix;
``scc_select="front"`` reproduces the reference's ``sccs.front()``), and the
verbose narration mirrors the reference's ``-v`` messages.  :func:`solve`
decides one snapshot, :func:`check_many` a batch of them in one lane-packed
backend call.  The per-SCC quorum scan is the Python loop at every graph
size.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, TextIO, Tuple, Union

from quorum_intersection_tpu_torch.backends.base import (
    CancelToken,
    SearchBackend,
    get_backend,
)
from quorum_intersection_tpu_torch.device import DeviceLike
from quorum_intersection_tpu_torch.encode.circuit import Circuit, encode_circuit
from quorum_intersection_tpu_torch.fbas.graph import (
    TrustGraph,
    build_graph,
    group_sccs,
    tarjan_scc,
)
from quorum_intersection_tpu_torch.fbas.schema import Fbas, parse_fbas
from quorum_intersection_tpu_torch.fbas.semantics import max_quorum
from quorum_intersection_tpu_torch.utils.timers import PhaseTimers


def scan_scc_quorums(graph: TrustGraph, sccs: List[List[int]]) -> List[List[int]]:
    """One max-quorum per SCC, restricted to its members (cpp:645-672)."""
    quorums: List[List[int]] = []
    for members in sccs:
        avail = [False] * graph.n
        for v in members:
            avail[v] = True
        quorums.append(max_quorum(graph, members, avail))
    return quorums


def _classify_sccs(
    graph: TrustGraph, *, scc_select: str, timers: PhaseTimers
) -> Tuple[int, List[List[int]], List[int], Dict[int, List[int]], List[int]]:
    """Tarjan + per-SCC quorum scan + main-SCC selection (Q5/Q8 semantics).
    Returns ``(count, sccs, quorum_scc_ids, scc_quorums, main_scc)``."""
    with timers.phase("scc"):
        count, comp = tarjan_scc(graph.n, graph.succ)
        sccs = group_sccs(graph.n, comp, count)
    quorum_scc_ids: List[int] = []
    scc_quorums: Dict[int, List[int]] = {}
    with timers.phase("scc_scan"):
        for sid, quorum in enumerate(scan_scc_quorums(graph, sccs)):
            if quorum:
                quorum_scc_ids.append(sid)
                scc_quorums[sid] = quorum
    # The reference labels sccs.front() the main component (cpp:675-678) —
    # the sink, not the largest (Q8); with the Q5 fix it is the
    # quorum-bearing one when unique.
    if scc_select == "front" or not quorum_scc_ids:
        main_scc = sccs[0] if sccs else []
    else:
        main_scc = sccs[quorum_scc_ids[0]]
    return count, sccs, quorum_scc_ids, scc_quorums, main_scc


@dataclass
class SolveResult:
    intersects: bool
    n_sccs: int = 0
    quorum_scc_ids: List[int] = field(default_factory=list)
    main_scc: List[int] = field(default_factory=list)
    q1: Optional[List[int]] = None
    q2: Optional[List[int]] = None
    stats: Dict[str, object] = field(default_factory=dict)
    timers: Dict[str, float] = field(default_factory=dict)


def print_quorum(quorum: List[int], graph: TrustGraph, out: TextIO) -> None:
    """Verbose quorum dump — the reference's ``printQuorum`` (cpp:475-490):
    per node its name, ID, top-level threshold and top-level validator IDs."""
    for v in quorum:
        q = graph.qsets[v]
        names = " ".join(graph.node_ids[v2] for v2 in q.members) if q.members else ""
        threshold = "null" if q.threshold is None else str(q.threshold)
        out.write(
            f"{graph.names[v]} {graph.node_ids[v]}\n"
            f"( quorumslice: threshold = {threshold} {names}{' ' if names else ''}) \n\n"
        )
    out.write("\n")


def solve_graph(
    graph: TrustGraph,
    *,
    backend: Union[str, SearchBackend] = "gpu-sweep",
    device: DeviceLike = None,
    verbose: bool = False,
    out: TextIO = sys.stdout,
    graphviz: bool = False,
    scc_select: str = "quorum-bearing",
    scope_to_scc: bool = False,
    circuit: Optional[Circuit] = None,
    timers: Optional[PhaseTimers] = None,
) -> SolveResult:
    """Decide quorum intersection for a built trust graph.  A backend named
    by string is built on ``device`` (None: CUDA)."""
    timers = timers or PhaseTimers()
    if isinstance(backend, str):
        backend = get_backend(backend, device=device)

    count, sccs, quorum_scc_ids, scc_quorums, main_scc = _classify_sccs(
        graph, scc_select=scc_select, timers=timers
    )

    if graphviz:
        from quorum_intersection_tpu_torch.analytics.graphviz import write_graphviz_sccs

        write_graphviz_sccs(graph, sccs, out)

    if verbose:
        out.write(f"total number of strongly connected components: {count}\n")
        for sid in quorum_scc_ids:
            out.write("found quorum inside of a strongly connected component:\n")
            print_quorum(scc_quorums[sid], graph, out)
        out.write(
            f"number of strongly connected components containing some quorum: {len(quorum_scc_ids)}\n"
        )
        out.write(f"size of the main strongly connected component: {len(main_scc)}\n")
        out.write(
            "main strongly connected component (all minimal quorums are included in it; "
            "small size means small resilience of the network):\n"
        )
        print_quorum(main_scc, graph, out)

    if len(quorum_scc_ids) != 1:
        # Guard (cpp:681-688): zero quorum-bearing SCCs means no quorum at
        # all; two or more means two disjoint quorums across components,
        # and their per-SCC quorums are the witness pair.
        if verbose:
            out.write(
                "network's configuration is broken - more than one strongly connected "
                f"component contains a quorum - {len(quorum_scc_ids)}\n"
            )
        q1 = q2 = None
        if len(quorum_scc_ids) >= 2:
            q1 = scc_quorums[quorum_scc_ids[0]]
            q2 = scc_quorums[quorum_scc_ids[1]]
        return SolveResult(
            intersects=False,
            n_sccs=count,
            quorum_scc_ids=quorum_scc_ids,
            main_scc=main_scc,
            q1=q1,
            q2=q2,
            stats={"reason": "scc_guard"},
            timers=timers.summary(),
        )

    if circuit is None and getattr(backend, "needs_circuit", True):
        with timers.phase("encode"):
            circuit = encode_circuit(graph)

    target_scc = sccs[0] if scc_select == "front" else sccs[quorum_scc_ids[0]]
    with timers.phase("search"):
        res = backend.check_scc(graph, circuit, target_scc, scope_to_scc=scope_to_scc)

    if verbose:
        if not res.intersects:
            out.write("found two non-intersecting quorums\n")
            out.write("first quorum:\n")
            print_quorum(res.q1 or [], graph, out)
            out.write("second quorum:\n")
            print_quorum(res.q2 or [], graph, out)
        else:
            out.write("all quorums are intersecting\n")

    return SolveResult(
        intersects=res.intersects,
        n_sccs=count,
        quorum_scc_ids=quorum_scc_ids,
        main_scc=main_scc,
        q1=res.q1,
        q2=res.q2,
        stats=dict(res.stats),
        timers=timers.summary(),
    )


def solve(
    source: Union[str, bytes, List[Dict[str, object]], Fbas],
    *,
    backend: Union[str, SearchBackend] = "gpu-sweep",
    device: DeviceLike = None,
    dangling: str = "strict",
    verbose: bool = False,
    out: TextIO = sys.stdout,
    graphviz: bool = False,
    scc_select: str = "quorum-bearing",
    scope_to_scc: bool = False,
) -> SolveResult:
    """Full pipeline from JSON (stream/str/list) or a parsed :class:`Fbas`;
    ``device=None`` runs the search on CUDA, ``device="cpu"`` on the host."""
    timers = PhaseTimers()
    with timers.phase("parse"):
        fbas = source if isinstance(source, Fbas) else parse_fbas(source)
    with timers.phase("graph"):
        graph = build_graph(fbas, dangling=dangling)
    return solve_graph(
        graph,
        backend=backend,
        device=device,
        verbose=verbose,
        out=out,
        graphviz=graphviz,
        scc_select=scc_select,
        scope_to_scc=scope_to_scc,
        timers=timers,
    )


def check_many(
    sources: Sequence[object],
    *,
    backend: Union[str, SearchBackend] = "gpu-sweep",
    device: DeviceLike = None,
    dangling: str = "strict",
    scc_select: str = "quorum-bearing",
    scope_to_scc: bool = False,
    pack: bool = True,
    cancels: Optional[Sequence[Optional[CancelToken]]] = None,
) -> List[SolveResult]:
    """Decide quorum intersection for MANY FBAS sources in one call — the
    shape a queue of snapshot checks arrives in.

    Each source runs the same parse → graph → SCC scan → guard pipeline as
    :func:`solve` (minus narration); guard-decided sources (zero or >= 2
    quorum-bearing SCCs) resolve from the scan, and the rest become ONE
    ``check_sccs`` call that fuses them into lane packs.  ``pack=False``
    calls the backend per problem instead.  Results come back in source
    order; every searched source's timers carry the batch's shared
    ``search`` wall.  A backend named by string is built on ``device``
    (None: CUDA).

    ``cancels`` is source-aligned: a tripped token retires that source alone
    and it comes back with ``stats["cancelled"]`` and no verdict claim.
    """
    if isinstance(backend, str):
        backend = get_backend(backend, device=device)
    results: List[Optional[SolveResult]] = [None] * len(sources)
    jobs: List[Tuple[int, TrustGraph, Optional[Circuit], List[int]]] = []
    metas: Dict[int, Tuple[int, List[int], List[int], Dict[str, float]]] = {}
    for ix, source in enumerate(sources):
        timers = PhaseTimers()
        with timers.phase("parse"):
            fbas = source if isinstance(source, Fbas) else parse_fbas(source)
        with timers.phase("graph"):
            graph = build_graph(fbas, dangling=dangling)
        count, sccs, quorum_scc_ids, scc_quorums, main_scc = _classify_sccs(
            graph, scc_select=scc_select, timers=timers
        )
        if len(quorum_scc_ids) != 1:
            # Guard-decided, exactly as solve_graph.
            q1 = q2 = None
            if len(quorum_scc_ids) >= 2:
                q1 = scc_quorums[quorum_scc_ids[0]]
                q2 = scc_quorums[quorum_scc_ids[1]]
            results[ix] = SolveResult(
                intersects=False, n_sccs=count, quorum_scc_ids=quorum_scc_ids,
                main_scc=main_scc, q1=q1, q2=q2, stats={"reason": "scc_guard"},
                timers=timers.summary(),
            )
            continue
        circuit: Optional[Circuit] = None
        if getattr(backend, "needs_circuit", True):
            with timers.phase("encode"):
                circuit = encode_circuit(graph)
        target_scc = sccs[0] if scc_select == "front" else sccs[quorum_scc_ids[0]]
        jobs.append((ix, graph, circuit, target_scc))
        metas[ix] = (count, quorum_scc_ids, main_scc, timers.summary())

    if jobs:
        job_cancels = [cancels[ix] for ix, _, _, _ in jobs] if cancels is not None else None
        t_search = time.perf_counter()
        if pack:
            scc_results = backend.check_sccs(
                [(g, c, s) for _, g, c, s in jobs], scope_to_scc=scope_to_scc, cancels=job_cancels
            )
        else:
            scc_results = []
            for jx, (_, g, c, s) in enumerate(jobs):
                tok = job_cancels[jx] if job_cancels is not None else None
                if tok is not None and tok.cancelled:
                    scc_results.append(backend._cancelled_result(s))
                else:
                    scc_results.append(backend.check_scc(g, c, s, scope_to_scc=scope_to_scc))
        search_s = time.perf_counter() - t_search
        for (ix, _, _, _), res in zip(jobs, scc_results):
            count, quorum_scc_ids, main_scc, timer_summary = metas[ix]
            timer_summary = dict(timer_summary, search=search_s)
            cancelled = bool(res.stats.get("cancelled"))
            results[ix] = SolveResult(
                intersects=res.intersects, n_sccs=count, quorum_scc_ids=quorum_scc_ids,
                main_scc=main_scc, q1=None if cancelled else res.q1,
                q2=None if cancelled else res.q2, stats=dict(res.stats), timers=timer_summary,
            )
    return [r for r in results if r is not None]
