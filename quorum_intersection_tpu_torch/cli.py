"""Command-line interface — the verdict mode of the JAX package's CLI
(``cli.py:63-161``, ``:221-473``), on the card.

- input is always **stdin**, output always stdout;
- prints ``true``/``false`` and exits 0 iff intersecting, else 1;
- ``-g/--graph`` dumps the SCC-colored Graphviz digraph before the verdict;
- ``-v/--verbose`` narrates SCC/quorum findings; ``-t/--trace`` enables
  debug logging;
- malformed input prints ``invalid FBAS configuration: …`` and exits 1;
- an invalid option prints ``Invalid option!`` plus usage and exits 1.

``--device {cuda,cpu}`` (default ``cuda``) picks where the sweep runs; it
plays the part the ``JAX_PLATFORMS`` variable plays for the JAX package.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional


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
    p.add_argument("--backend", default="gpu-sweep", choices=["gpu-sweep"],
                   help="disjoint-quorum search backend (default gpu-sweep)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the sweep runs (default cuda; cpu runs the plain version)")
    p.add_argument("--dangling-policy", default="strict", choices=["strict", "alias0"],
                   help="unknown validator refs: strict=never available (default), "
                        "alias0=reference-compatible aliasing to vertex 0 (Q1)")
    p.add_argument("--scc-select", default="quorum-bearing", choices=["quorum-bearing", "front"],
                   help="which SCC to search: the quorum-bearing one (default, Q5 fix) "
                        "or Tarjan component 0 like the reference")
    p.add_argument("--scope-scc", action="store_true",
                   help="scope availability to the searched SCC (principled; default "
                        "reproduces the reference's whole-graph availability, Q6)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.trace:
        logger = logging.getLogger("quorum_intersection_tpu_torch")
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter("[%(levelname)s] %(name)s: %(message)s"))
            logger.addHandler(handler)
        logger.setLevel(logging.DEBUG)

    from quorum_intersection_tpu_torch.backends.base import get_backend
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.pipeline import solve_graph

    try:
        fbas = parse_fbas(sys.stdin.read())
    except ValueError as exc:
        # FbasSchemaError and json.JSONDecodeError both derive from ValueError.
        sys.stderr.write(f"invalid FBAS configuration: {exc}\n")
        return 1
    graph = build_graph(fbas, dangling=args.dangling_policy)
    try:
        backend = get_backend(args.backend, device=args.device)
    except (RuntimeError, ValueError) as exc:
        sys.stderr.write(f"backend {args.backend!r} unavailable: {exc}\n")
        return 1
    result = solve_graph(
        graph,
        backend=backend,
        verbose=args.verbose,
        out=sys.stdout,
        graphviz=args.graph,
        scc_select=args.scc_select,
        scope_to_scc=args.scope_scc,
    )
    sys.stdout.write("true\n" if result.intersects else "false\n")
    return 0 if result.intersects else 1


def run() -> int:
    """``main`` with pipe hygiene: a closed stdout (``… | head``) exits 1
    quietly instead of dumping a BrokenPipeError traceback."""
    import os

    try:
        return main()
    except BrokenPipeError:
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 1


if __name__ == "__main__":
    sys.exit(run())
