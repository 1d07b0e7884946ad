"""Command-line interface — the JAX package's CLI (``cli.py:63-161``,
``:176-218``, ``:221-473``) on the card, with its ``serve``, ``fleet`` and
``query`` subcommands routed to ``serve_transport.py``, ``fleet.py`` and
``query.py``.

- input is always **stdin**, output always stdout;
- the default mode prints ``true``/``false`` and exits 0 iff intersecting,
  else 1;
- ``-p/--pagerank`` switches to PageRank mode (``-i/--max_iterations``,
  ``-m/--dangling_factor``, ``-c/--convergence``), always exit 0;
- ``--top-tier``, ``--blocking-set`` and ``--splitting-set``
  (``--splitting-max-k``) print an analysis instead of the verdict, exit 0;
- ``-g/--graph`` dumps the SCC-colored Graphviz digraph before the verdict;
- ``-v/--verbose`` narrates SCC/quorum findings; ``-t/--trace`` enables
  debug logging;
- malformed input prints ``invalid FBAS configuration: …`` and exits 1;
- an invalid option prints ``Invalid option!`` plus usage and exits 1.

``--backend`` picks the search engine: ``auto`` (default: the host oracle
raced against the sweep on the card), ``gpu-sweep``, ``gpu-frontier`` (the
device-resident branch and bound), ``cpp`` or ``python``; ``--checkpoint
PATH`` records and resumes a long search in the JAX package's file formats:
the sweep's scan position under ``auto`` and ``gpu-sweep``, the frontier's
state under ``gpu-frontier`` (the host oracles refuse it);
``--no-race`` runs the auto router's sequential chain instead of the race;
``--mesh N|all`` shards the search over N cards (``all``: every visible
card; with ``--device cpu``, N CPU ranks, ``all`` one) under ``auto``,
``gpu-sweep`` and ``gpu-frontier`` (:mod:`.parallel.mesh`);
``--cert-out PATH`` writes the verdict's qi-cert/1 certificate, which
``tools/check_cert.py`` re-validates against the input.  ``--seed`` and
``--randomized`` switch the host oracles to the reference's randomized
branching tie-break.  ``--compat`` is shorthand for ``--dangling-policy
alias0 --scc-select front``.  ``--device {cuda,cpu}`` (default ``cuda``)
picks where the sweep and the PageRank kernel run; it plays the part the
``JAX_PLATFORMS`` variable plays for the JAX package.

Observability (the JAX CLI's, ``cli.py:104-119``, ``:199-218``,
``:458-468``): ``--metrics-json PATH`` streams the run record as
``qi-telemetry/1`` JSONL (``tools/metrics_report.py`` renders it),
``--metrics-prom PATH`` writes its counters and gauges as a Prometheus
textfile, ``--trace-out PATH`` appends its spans and events as
Chrome/Perfetto trace events, and ``--timing`` prints the ``[timing]``
phase lines and ``[stats]`` lines to stderr, then the ``[telemetry]``
summary.  The record is finished on every exit path.  ``--profile-dir DIR``
records a ``torch.profiler`` trace of the solve (the card's kernels
included) into DIR (:mod:`.utils.profiling`, the JAX CLI's ``cli.py:137``,
``:440``).

Subcommands: ``query`` — one typed query over the snapshot on stdin
(:mod:`.query`: relaxed two-family intersection, what-if removals,
analytics), with its own flags and exit codes; ``serve`` — the long-lived
JSONL serving layer (:mod:`.serve`, :mod:`.serve_transport`).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from quorum_intersection_tpu_torch.utils.logging import get_logger, set_trace
from quorum_intersection_tpu_torch.utils.pipes import run_with_pipe_hygiene

log = get_logger("cli")


class _RefCompatParser(argparse.ArgumentParser):
    """argparse with the reference's error contract: ``Invalid option!`` +
    usage on stdout, exit code 1 (cpp:771-775)."""

    def error(self, message: str) -> None:  # type: ignore[override]
        sys.stdout.write("Invalid option!\n")
        self.print_help(sys.stdout)
        raise SystemExit(1)


def build_parser() -> argparse.ArgumentParser:
    p = _RefCompatParser(
        prog="quorum_intersection_tpu_torch",
        description=(
            "Decide the quorum-intersection property of a Stellar FBAS "
            "(stellarbeat /nodes/raw JSON on stdin)."
        ),
        add_help=False,
    )
    p.add_argument("--help", "-h", action="help", help="produce help message")
    p.add_argument("--verbose", "-v", action="store_true", help="print info about the analyzed configuration")
    p.add_argument("--graph", "-g", action="store_true", help="print graphviz representation of the configuration")
    p.add_argument("--trace", "-t", action="store_true", help="print debug information")
    p.add_argument("--pagerank", "-p", action="store_true", help="compute PageRank of the trust graph instead")
    p.add_argument("--max_iterations", "-i", type=int, default=100000, metavar="N",
                   help="maximal number of PageRank iterations (default 100000)")
    p.add_argument("--dangling_factor", "-m", type=float, default=0.0001, metavar="F",
                   help="PageRank dangling factor (default 0.0001)")
    p.add_argument("--convergence", "-c", type=float, default=0.0001, metavar="F",
                   help="PageRank convergence threshold (default 0.0001)")
    p.add_argument("--backend", default="auto", choices=["auto", "gpu-sweep", "gpu-frontier", "cpp", "python"],
                   help="disjoint-quorum search backend (default auto)")
    p.add_argument("--checkpoint", metavar="PATH", default=None,
                   help="auto, gpu-sweep and gpu-frontier: checkpoint file of a long search (the "
                        "sweep's position or the frontier's state), written as it runs and resumed "
                        "when it matches the problem")
    p.add_argument("--no-race", action="store_true",
                   help="auto backend only: run the budgeted oracle first and the sweep only "
                        "after its budget burns, instead of racing them (same verdicts)")
    p.add_argument("--cert-out", metavar="PATH", default=None,
                   help="write the qi-cert/1 verdict certificate to PATH (check it with "
                        "python tools/check_cert.py PATH INPUT.json)")
    p.add_argument("--timing", action="store_true",
                   help="print phase timers (and the telemetry summary) to stderr")
    p.add_argument("--metrics-json", metavar="PATH", default=None,
                   help="stream run-record telemetry (spans, counters, events) to PATH as JSONL; "
                        "render with tools/metrics_report.py")
    p.add_argument("--metrics-prom", metavar="PATH", default=None,
                   help="write final counters/gauges to PATH as a Prometheus-style textfile "
                        "(node_exporter textfile collector format)")
    p.add_argument("--trace-out", metavar="PATH", default=None,
                   help="append the run's spans/events to PATH as Chrome/Perfetto trace-event JSON "
                        "(one timeline incl. both race arms; open in ui.perfetto.dev); env twin: "
                        "QI_TRACE_OUT")
    p.add_argument("--profile-dir", metavar="DIR", default=None,
                   help="record a torch.profiler trace of the solve into DIR (a Chrome trace "
                        "holding the card's kernels and the range qi-trace:<trace_id>)")
    p.add_argument("--mesh", metavar="N", default=None,
                   help="shard the device search across N devices ('all' = every "
                        "visible device); applies to auto/gpu-sweep")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the sweep and the PageRank kernel run (default cuda; cpu runs "
                        "the plain versions)")
    p.add_argument("--dangling-policy", default=None, choices=["strict", "alias0"],
                   help="unknown validator refs: strict=never available (default), "
                        "alias0=reference-compatible aliasing to vertex 0 (Q1)")
    p.add_argument("--scc-select", default=None, choices=["quorum-bearing", "front"],
                   help="which SCC to search: the quorum-bearing one (default, Q5 fix) "
                        "or Tarjan component 0 like the reference")
    p.add_argument("--scope-scc", action="store_true",
                   help="scope availability to the searched SCC (principled; default "
                        "reproduces the reference's whole-graph availability, Q6)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed for the randomized branching tie-break (implies --randomized)")
    p.add_argument("--randomized", action="store_true",
                   help="use the reference's randomized branching tie-break instead of "
                        "the deterministic lowest-index rule")
    p.add_argument("--compat", action="store_true",
                   help="reference-bug-compatible mode: --dangling-policy alias0 --scc-select front")
    p.add_argument("--blocking-set", action="store_true",
                   help="liveness-resilience mode: print a minimal blocking set of "
                        "the quorum-bearing SCC (node failures that halt consensus) "
                        "instead of the intersection verdict")
    p.add_argument("--splitting-set", action="store_true",
                   help="safety-margin mode: print a minimum splitting set (node "
                        "deletions that leave two disjoint quorums) up to "
                        "--splitting-max-k members, instead of the verdict")
    p.add_argument("--splitting-max-k", type=int, default=2, metavar="K",
                   help="splitting-set search depth (subsets up to size K; each "
                        "candidate is a full NP-hard solve — default 2)")
    p.add_argument("--top-tier", action="store_true",
                   help="analysis mode: print the top tier (union of all minimal "
                        "quorums' members — the validators that shape consensus) "
                        "instead of the verdict")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    arglist = sys.argv[1:] if argv is None else list(argv)
    if arglist and arglist[0] == "serve":
        # The long-lived serving layer: one JSON request a stdin line, one
        # JSON response a stdout line; serve_transport.py owns its flags and
        # exit semantics (a stream has no one verdict to exit with).
        from quorum_intersection_tpu_torch.serve import serve_main

        return serve_main(arglist[1:])
    if arglist and arglist[0] == "fleet":
        # The replicated serve tier: N serve workers behind a consistent-hash
        # front door, the same JSONL contract; fleet.py owns its flags.
        from quorum_intersection_tpu_torch.fleet import fleet_main

        return fleet_main(arglist[1:])
    if arglist and arglist[0] == "query":
        # One-shot typed query: query.py owns its flags and exit codes.
        from quorum_intersection_tpu_torch.query import query_main

        return query_main(arglist[1:])
    args = build_parser().parse_args(arglist)
    if args.trace:
        set_trace(True)

    from quorum_intersection_tpu_torch.utils import telemetry

    record = telemetry.get_run_record()
    if args.metrics_json:
        record.add_sink(telemetry.JsonlSink(args.metrics_json))
    if args.metrics_prom:
        record.add_sink(telemetry.PromFileSink(args.metrics_prom))
    if args.trace_out:
        record.add_sink(telemetry.ChromeTraceSink(args.trace_out))
    try:
        return _main(args, record)
    finally:
        # One flush for every exit path: the final counter and gauge lines
        # reach the JSONL stream and the textfile is written.
        record.finish()


def _main(args, record) -> int:
    dangling = args.dangling_policy or ("alias0" if args.compat else "strict")
    scc_select = args.scc_select or ("front" if args.compat else "quorum-bearing")
    if args.cert_out and (args.pagerank or args.top_tier or args.splitting_set or args.blocking_set):
        # The analysis modes return before the solve that builds a
        # certificate: reject rather than exit 0 with no file written.
        sys.stderr.write(
            "--cert-out applies to verdict mode only (certificates are not "
            "produced by --rank/--top-tier/--splitting-set/--blocking-set)\n"
        )
        return 1

    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas

    try:
        # Buffered: the splitting-set mode re-reads the raw node list.
        with record.span("phase.parse"):
            stdin_text = sys.stdin.read()
            fbas = parse_fbas(stdin_text)
    except ValueError as exc:
        # FbasSchemaError and json.JSONDecodeError both derive from ValueError.
        sys.stderr.write(f"invalid FBAS configuration: {exc}\n")
        return 1
    with record.span("phase.graph"):
        graph = build_graph(fbas, dangling=dangling)
    if args.pagerank:
        return _pagerank_mode(args, graph)
    if args.top_tier:
        return _top_tier_mode(graph)
    if args.splitting_set:
        return _splitting_mode(args, graph, stdin_text, dangling)
    if args.blocking_set:
        return _blocking_mode(graph)

    from quorum_intersection_tpu_torch.pipeline import named_backend, solve_graph

    if args.no_race and args.backend != "auto":
        sys.stderr.write("--no-race only applies to the auto router (--backend auto)\n")
        return 1
    if args.checkpoint is not None and args.backend not in ("auto", "gpu-sweep", "gpu-frontier"):
        sys.stderr.write("--checkpoint requires --backend gpu-frontier, gpu-sweep or auto (the host oracles "
                         "keep no progress)\n")
        return 1
    options: dict = {}
    if args.backend in ("python", "cpp", "auto") and (args.seed is not None or args.randomized):
        options = {"seed": args.seed, "randomized": True}
    if args.no_race:
        options["race"] = False
    if args.checkpoint is not None:
        from quorum_intersection_tpu_torch.utils.checkpoint import FrontierCheckpoint, SweepCheckpoint

        # The frontier records (toRemove, dontRemove) states, the sweep a
        # scan position.
        checkpoint_class = FrontierCheckpoint if args.backend == "gpu-frontier" else SweepCheckpoint
        options["checkpoint"] = checkpoint_class(args.checkpoint)
    if args.mesh is not None:
        if args.backend not in ("auto", "gpu-sweep", "gpu-frontier"):
            sys.stderr.write("--mesh requires a device backend (auto/gpu-sweep/gpu-frontier)\n")
            return 1
        try:
            n_dev = None if args.mesh == "all" else int(args.mesh)
        except ValueError:
            sys.stderr.write(f"--mesh expects a device count or 'all', got {args.mesh!r}\n")
            return 1
        if n_dev is not None and n_dev < 1:
            sys.stderr.write(f"--mesh expects a positive device count, got {n_dev}\n")
            return 1
        try:
            from quorum_intersection_tpu_torch.parallel.mesh import candidate_mesh

            options["mesh"] = candidate_mesh(n_dev, device=args.device)
        except (RuntimeError, ValueError) as exc:
            # ValueError: more devices requested than visible; RuntimeError:
            # no card — the same one-line contract as backend construction.
            sys.stderr.write(f"--mesh {args.mesh}: {exc}\n")
            return 1
    try:
        backend = named_backend(args.backend, args.device, **options)
    except (RuntimeError, ValueError) as exc:
        sys.stderr.write(f"backend {args.backend!r} unavailable: {exc}\n")
        return 1
    from quorum_intersection_tpu_torch.utils.profiling import profile_trace

    with profile_trace(args.profile_dir, args.device):
        result = solve_graph(
            graph,
            backend=backend,
            verbose=args.verbose,
            out=sys.stdout,
            graphviz=args.graph,
            scc_select=scc_select,
            scope_to_scc=args.scope_scc,
        )
    if args.cert_out and result.cert is not None:
        from quorum_intersection_tpu_torch.cert import write_certificate

        # A failed write is logged and counted; the verdict is never at stake.
        write_certificate(result.cert, args.cert_out)
    if args.timing:
        # The legacy lines first, then the run record's summary.
        for name, seconds in result.timers.items():
            sys.stderr.write(f"[timing] {name}: {seconds * 1000:.2f} ms\n")
        for key, value in result.stats.items():
            sys.stderr.write(f"[stats] {key}: {value}\n")
        from quorum_intersection_tpu_torch.utils.telemetry import StderrSummarySink

        StderrSummarySink().finish(record)
    sys.stdout.write("true\n" if result.intersects else "false\n")
    return 0 if result.intersects else 1


def _pagerank_mode(args, graph) -> int:
    from quorum_intersection_tpu_torch.analytics.pagerank import format_pagerank, pagerank_auto

    ranks, engine = pagerank_auto(
        graph,
        m=args.dangling_factor,
        convergence=args.convergence,
        max_iterations=args.max_iterations,
        device=args.device,
    )
    log.debug("pagerank engine: %s", engine)
    if args.timing:
        sys.stderr.write(f"[stats] pagerank_engine: {engine}\n")
    sys.stdout.write(format_pagerank(graph, ranks))
    return 0  # PageRank mode always exits 0 (cpp:787)


def _top_tier_mode(graph) -> int:
    from quorum_intersection_tpu_torch.analytics.top_tier import top_tier
    from quorum_intersection_tpu_torch.pipeline import quorum_bearing_sccs

    members: list = []
    quorum_count = 0
    exceeded = False
    bearing = quorum_bearing_sccs(graph)
    for _sid, scc in bearing:
        part, n_min = top_tier(graph, scc)
        if part is None:
            exceeded = True
            break
        members.extend(part)
        quorum_count += n_min
    if not bearing:
        sys.stdout.write("top tier: empty (no quorum exists)\n")
    elif exceeded:
        sys.stdout.write(
            "top tier: not computed (minimal-quorum enumeration exceeded its call budget)\n"
        )
    else:
        labels = " ".join(graph.label(v) for v in sorted(members))
        sys.stdout.write(f"top tier ({len(members)} nodes, {quorum_count} minimal quorums): {labels}\n")
    return 0


def _splitting_mode(args, graph, stdin_text: str, dangling: str) -> int:
    from quorum_intersection_tpu_torch.analytics.splitting import POOL_LIMIT, minimum_splitting_set
    from quorum_intersection_tpu_torch.pipeline import quorum_bearing_sccs

    raw = json.loads(stdin_text)
    # Candidate pool from the graph already built under the user's dangling
    # policy — no second front-end pass.
    pool: list = []
    for _sid, scc in quorum_bearing_sccs(graph):
        pool.extend(graph.node_ids[v] for v in scc)
    if len(pool) > POOL_LIMIT:
        sys.stdout.write(f"splitting set: not computed (candidate pool {len(pool)} > {POOL_LIMIT})\n")
        return 0
    split = minimum_splitting_set(raw, max_k=args.splitting_max_k, dangling=dangling, pool=pool)
    if split is None:
        sys.stdout.write(
            f"no splitting set with <= {args.splitting_max_k} nodes "
            "(network stays intersecting under any such deletion)\n"
        )
    elif not split:
        sys.stdout.write("minimum splitting set (0 nodes): already split\n")
    else:
        sys.stdout.write(f"minimum splitting set ({len(split)} nodes): {' '.join(split)}\n")
    return 0


def _blocking_mode(graph) -> int:
    from quorum_intersection_tpu_torch.analytics.resilience import (
        EXACT_LIMIT,
        minimal_blocking_set,
        minimum_blocking_size,
    )
    from quorum_intersection_tpu_torch.pipeline import quorum_bearing_sccs

    bearing = quorum_bearing_sccs(graph)
    if not bearing:
        sys.stdout.write("blocking set: none needed (no quorum exists)\n")
        return 0
    # Halting the whole network means blocking every quorum-bearing SCC: the
    # minimal set is the union of per-SCC minimal sets, the minimum size the
    # sum of per-SCC minimums.
    blocking: list = []
    minimum_total: Optional[int] = 0
    for _sid, scc in bearing:
        part = minimal_blocking_set(graph, scc)
        blocking.extend(part)
        minimum = minimum_blocking_size(graph, scc, upper=len(part))
        minimum_total = None if (minimum is None or minimum_total is None) else minimum_total + minimum
    labels = " ".join(graph.label(v) for v in blocking)
    sys.stdout.write(f"minimal blocking set ({len(blocking)} nodes): {labels}\n")
    if minimum_total is not None:
        sys.stdout.write(f"minimum blocking size: {minimum_total}\n")
    else:
        sys.stdout.write(f"minimum blocking size: not computed (|scc| > {EXACT_LIMIT})\n")
    return 0


def run() -> int:
    """``main`` with pipe hygiene."""
    return run_with_pipe_hygiene(main)


if __name__ == "__main__":
    sys.exit(run())
