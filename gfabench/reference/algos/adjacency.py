"""Bidirected adjacency index shared by the host graph algorithms.

The reference stores each edge in only one of its two equivalent forms
(``A+→B+`` ≡ ``B-→A-``, gfasort ``src/graph_ops.rs:626-638``).  For every
stored edge this indexes which handles it leaves ("outgoing of h":
``e.from == h`` or ``e.to == flip(h)``) and which it enters ("incoming of
h": ``e.to == h`` or ``e.from == flip(h)``), each handle's edges in the
reference's edge order, sorted by ``(from, to)``
(``src/graph_ops.rs:1365-1366``).

The same index as ``gfasort_tpu_torch/algos/adjacency.py`` builds with a
Python dict of lists, built here with numpy as offset arrays (CSR) over
the handles and handed to the loops as Python lists.
"""

from __future__ import annotations

import numpy as np

__all__ = ["AdjacencyIndex"]


def _csr(handles: np.ndarray, edge_idx: np.ndarray, n_handles: int):
    """(offsets, edge indices): each handle's edges, ascending."""
    order = np.lexsort((edge_idx, handles))
    counts = np.bincount(handles, minlength=n_handles)
    off = np.concatenate([[0], np.cumsum(counts)])
    return off.tolist(), edge_idx[order].tolist(), counts


class AdjacencyIndex:
    """Deterministic per-handle edge index over the stored edge forms."""

    def __init__(self, graph) -> None:
        ef, et = graph.edges_to_arrays()
        order = np.lexsort((et, ef))       # sorted by (from, to)
        ef, et = ef[order], et[order]
        self.n_edges = len(ef)
        self.ef, self.et = ef.tolist(), et.tolist()
        top = int(max(ef.max(), et.max())) if len(ef) else 0
        self.n_handles = (top | 1) + 1
        i = np.arange(len(ef), dtype=np.int64)
        # a self-complement match counts once (the Rust if / else-if)
        tf, ff = et ^ 1, ef ^ 1
        mo, mi = tf != ef, ff != et
        self.out_off, self.out_idx, _ = _csr(
            np.concatenate([ef, tf[mo]]), np.concatenate([i, i[mo]]),
            self.n_handles)
        self.in_off, self.in_idx, in_counts = _csr(
            np.concatenate([et, ff[mi]]), np.concatenate([i, i[mi]]),
            self.n_handles)
        self.in_counts = in_counts.tolist()

    def out_edges(self, h: int) -> list:
        if h >= self.n_handles:
            return []
        return self.out_idx[self.out_off[h]:self.out_off[h + 1]]

    def in_edges(self, h: int) -> list:
        if h >= self.n_handles:
            return []
        return self.in_idx[self.in_off[h]:self.in_off[h + 1]]

    def next_handle(self, ei: int, h: int) -> int:
        """Successor handle following edge ``ei`` out of ``h``
        (src/graph_ops.rs:1385-1392): the direct form gives ``e.to``, the
        complement form ``flip(e.from)``."""
        f = self.ef[ei]
        return self.et[ei] if f == h else f ^ 1
