"""Configuration sanitizer — the port's copy of the JAX package's
``fbas/sanitize.py``: the capability of the reference's
``fix_quorum_configurations.py`` (all 21 lines of it), made recursive and
dangling-aware.

The reference keeps a node iff its **top-level** quorum set satisfies
``len(validators) + len(innerQuorumSets) >= threshold``
(``fix_quorum_configurations.py:11-15``); it does not recurse
into inner sets and does not touch dangling validator references.  It also
crashes with a ``TypeError`` on any node whose ``quorumSet`` is ``null``
(the reference's own ``correct.json`` has 26 of them).

This sanitizer:

- treats a ``null``/empty quorum set as *sane* (such nodes are harmless —
  their slice is never satisfiable, SURVEY.md §2.3-Q2 — and real stellarbeat
  snapshots are full of them);
- by default checks sanity **recursively** (an inner set with
  ``threshold > members`` poisons its parent's slice just as surely);
- optionally also flags degenerate ``threshold == 0`` sets (unsatisfiable in
  the reference due to unsigned wraparound, SURVEY.md §2.3-Q3) and dangling
  validator references;
- ``compat=True`` reproduces the reference's exact filter (top-level only,
  ``>=`` check only), except that null-qset nodes are kept instead of crashing.

Usable as a stdin→stdout filter exactly like the reference::

    python -m quorum_intersection_tpu_torch.fbas.sanitize < nodes.json > clean.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterable, List, Mapping, Optional, Set


def _qset_sane(q: Optional[Mapping], *, recursive: bool,
               flag_zero_threshold: bool) -> bool:
    if q is None or not q:
        return True  # null/empty qset: never satisfiable but harmless
    threshold = q.get("threshold")
    if isinstance(threshold, str):
        # schema.py accepts numeric strings (boost::property_tree stores
        # scalars as strings); the sanitizer must agree or it would silently
        # drop nodes the parser considers valid.
        try:
            threshold = int(threshold)
        except ValueError:
            return False
    if not isinstance(threshold, int) or isinstance(threshold, bool):
        return False
    validators = q.get("validators") or []
    inner = q.get("innerQuorumSets") or []
    if len(validators) + len(inner) < threshold:
        return False
    if flag_zero_threshold and threshold == 0:
        return False
    if recursive:
        return all(
            _qset_sane(iq, recursive=True, flag_zero_threshold=flag_zero_threshold)
            for iq in inner
        )
    return True


def dangling_refs(data: List[Mapping]) -> Set[str]:
    """All validator IDs referenced (at any depth) but not present as nodes."""
    known = {node.get("publicKey") for node in data}
    seen: Set[str] = set()

    def walk(q) -> None:
        if not q:
            return
        for v in q.get("validators") or []:
            if v not in known:
                seen.add(v)
        for iq in q.get("innerQuorumSets") or []:
            walk(iq)

    for node in data:
        walk(node.get("quorumSet"))
    return seen


def sanitize(
    data: List[Mapping],
    *,
    recursive: bool = True,
    flag_zero_threshold: bool = False,
    compat: bool = False,
) -> List[Mapping]:
    """Return the nodes whose quorum configuration is sane.

    ``compat=True`` → the reference's top-level-only ``members >= threshold``
    filter (`fix_quorum_configurations.py:11-12`), null-tolerant.
    """
    if compat:
        recursive = False
        flag_zero_threshold = False
    return [
        node
        for node in data
        if _qset_sane(
            node.get("quorumSet"),
            recursive=recursive,
            flag_zero_threshold=flag_zero_threshold,
        )
    ]


def main(argv: Optional[Iterable[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m quorum_intersection_tpu_torch.fbas.sanitize",
        description="Drop FBAS nodes with insane quorum configurations (stdin → stdout).",
    )
    parser.add_argument(
        "--compat",
        action="store_true",
        help="reference-compatible filter: top-level threshold sanity only",
    )
    parser.add_argument(
        "--flag-zero-threshold",
        action="store_true",
        help="also drop nodes containing a threshold == 0 quorum set",
    )
    parser.add_argument(
        "--report-dangling",
        action="store_true",
        help="report dangling validator references on stderr",
    )
    args = parser.parse_args(list(argv) if argv is not None else None)

    try:
        data = json.load(sys.stdin)
        if not isinstance(data, list):
            raise ValueError(f"top level must be a JSON array, got {type(data).__name__}")
        if args.report_dangling:
            for ref in sorted(dangling_refs(data)):
                print(f"dangling validator reference: {ref}", file=sys.stderr)
        out = sanitize(
            data,
            compat=args.compat,
            flag_zero_threshold=args.flag_zero_threshold,
        )
    except RecursionError:
        # Deep nesting can surface in the json C scanner or in the recursive
        # sanity walks; either way the input is hostile, not a crash.
        sys.stderr.write("invalid FBAS configuration: JSON nesting too deep\n")
        return 1
    except (ValueError, AttributeError, TypeError) as exc:
        # Clean diagnostic + exit 1 on malformed stdin (the reference's
        # 21-line sanitizer tracebacks here).
        sys.stderr.write(f"invalid FBAS configuration: {exc}\n")
        return 1
    json.dump(out, sys.stdout)
    return 0


def run() -> int:
    from quorum_intersection_tpu_torch.utils.pipes import run_with_pipe_hygiene

    return run_with_pipe_hygiene(main)


if __name__ == "__main__":
    sys.exit(run())
