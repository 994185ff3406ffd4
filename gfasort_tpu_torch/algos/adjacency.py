"""Bidirected adjacency index shared by the host graph algorithms.

The reference stores each edge in only one of its two equivalent forms
(``A+→B+`` ≡ ``B-→A-``, gfasort ``src/graph_ops.rs:626-638``) and every
traversal rescans the whole edge set per handle, matching both forms
with helper closures (``src/graph_ops.rs:1369-1392``).  That rescan is
what makes the reference's topo sorts quadratic (SURVEY.md §4.4).

Here the matching is done once: for every stored edge we index which
handles it leaves ("outgoing of h": ``e.from == h`` or
``e.to == flip(h)``) and which it enters ("incoming of h":
``e.to == h`` or ``e.from == flip(h)``).  Lists are kept in the
reference's deterministic edge order — sorted by
``(from_id, from_rev, to_id, to_rev)`` (``src/graph_ops.rs:1365-1366``)
— so traversal order, and therefore output, is bit-identical.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .. import handle as H

__all__ = ["AdjacencyIndex"]


class AdjacencyIndex:
    """Deterministic per-handle edge index over the stored edge forms."""

    def __init__(self, graph) -> None:
        # Edges sorted by (from_id, from_rev, to_id, to_rev) — since a
        # handle is id<<1|rev, this is just sorting the (from, to) pairs.
        self.edges: List[Tuple[int, int]] = sorted(graph.edges)
        self.n_edges = len(self.edges)

        # outgoing[h] -> list of edge indices e with edge_goes_from(e, h)
        # incoming[h] -> list of edge indices e with edge_goes_to(e, h)
        self.outgoing: Dict[int, List[int]] = {}
        self.incoming: Dict[int, List[int]] = {}
        for i, (f, t) in enumerate(self.edges):
            self.outgoing.setdefault(f, []).append(i)
            tf = H.flip(t)
            if tf != f:  # self-complement match: count once (Rust if/else-if)
                self.outgoing.setdefault(tf, []).append(i)
            self.incoming.setdefault(t, []).append(i)
            ff = H.flip(f)
            if ff != t:
                self.incoming.setdefault(ff, []).append(i)

    def next_handle(self, edge_idx: int, h: int) -> int:
        """Successor handle following edge ``edge_idx`` out of ``h``
        (src/graph_ops.rs:1385-1392): direct form gives ``e.to``,
        complement form gives ``flip(e.from)``."""
        f, t = self.edges[edge_idx]
        return t if f == h else H.flip(f)

    def prev_handle(self, edge_idx: int, h: int) -> int:
        """Predecessor handle following edge ``edge_idx`` backwards into
        ``h`` (priority topo reverse mode, src/graph_ops.rs:1670-1686):
        direct form gives ``e.from``, complement gives ``flip(e.to)``."""
        f, t = self.edges[edge_idx]
        return f if t == h else H.flip(t)

    def incoming_source_node(self, edge_idx: int, h: int) -> int:
        """Node id of the source of an edge incoming to ``h``
        (src/graph_ops.rs:1399-1408)."""
        f, t = self.edges[edge_idx]
        return H.node_id(f) if t == h else H.node_id(t)

    def out_edges(self, h: int) -> List[int]:
        return self.outgoing.get(h, [])

    def in_edges(self, h: int) -> List[int]:
        return self.incoming.get(h, [])
