"""Graphviz export with SCC coloring — capability of the reference's
``printGraphvizWithSccs`` (the reference tool's `quorum_intersection.cpp:492-530`):

- node fill color ``#%06x`` computed as ``(0xFFFFFF // scc_count) * scc_index``
  (cpp:498, :505) — a crude but deterministic palette;
- label is the node name, falling back to the publicKey (cpp:507);
- white font (cpp:509);
- one edge line per edge occurrence (parallel edges preserved).
"""

from __future__ import annotations

from typing import List, TextIO

from quorum_intersection_tpu_torch.fbas.graph import TrustGraph


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def write_graphviz_sccs(graph: TrustGraph, sccs: List[List[int]], out: TextIO) -> None:
    colors = [0] * graph.n
    for scc_index, members in enumerate(sccs):
        for v in members:
            colors[v] = scc_index
    offset = 0xFFFFFF // max(len(sccs), 1)
    out.write("digraph G {\n")
    for v in range(graph.n):
        color = f"{offset * colors[v]:06x}"
        label = _escape(graph.label(v))
        out.write(
            f'{v}[style=filled color="#{color}" label="{label}" fontcolor="white"];\n'
        )
    for v, targets in enumerate(graph.succ):
        for w in targets:
            out.write(f"{v}->{w} ;\n")
    out.write("}\n")
