"""The graph model of the plain reference: nodes as an id-indexed list of
sequences, edges as their stored forms (one of edge / complement, two
int64 columns of handles), paths as int64 handle arrays, ``node_order``
in GFA insertion order.

The semantics of ``gfasort_tpu_torch/graph.py`` for what the CLI's steps
use: a renumbering through a lookup table (``apply_ordering``, the groom's
``_apply_node_id_mapping_arrays``) rewrites the edges' and the paths'
node ids and keeps each handle's orientation bit; a flip XORs the bit of
every handle of a flipped node.  Both mappings the steps use are
injective, so no two stored edges merge.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BiPath", "EdgeSet", "BidirectedGraph"]


class BiPath:
    """A path through the graph: a name plus an int64 array of handles."""

    __slots__ = ("name", "steps")

    def __init__(self, name: str, steps: Optional[Sequence[int]] = None):
        self.name = name
        self.steps = np.asarray(
            steps if steps is not None else [], dtype=np.int64)

    def __len__(self) -> int:
        return int(self.steps.shape[0])


class EdgeSet:
    """The stored edge forms as two int64 columns (from, to)."""

    __slots__ = ("ef", "et")

    def __init__(self, ef=(), et=()):
        self.ef = np.ascontiguousarray(ef, dtype=np.int64)
        self.et = np.ascontiguousarray(et, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.ef)

    def remapped(self, lut: np.ndarray, drop_unmapped: bool) -> "EdgeSet":
        """Node ids through ``lut`` (unmapped: ``lut[id] < 0`` or id past
        the table), orientation bits kept; an edge with an unmapped end is
        dropped (``drop_unmapped``) or keeps that end's id."""
        ef, et = self.ef, self.et
        nf, nt = ef >> 1, et >> 1
        inl_f = (nf >= 0) & (nf < len(lut))
        inl_t = (nt >= 0) & (nt < len(lut))
        mf = np.where(inl_f, lut[np.where(inl_f, nf, 0)], -1)
        mt = np.where(inl_t, lut[np.where(inl_t, nt, 0)], -1)
        if drop_unmapped:
            keep = (mf >= 0) & (mt >= 0)
            return EdgeSet((mf[keep] << 1) | (ef[keep] & 1),
                           (mt[keep] << 1) | (et[keep] & 1))
        return EdgeSet((np.where(mf < 0, nf, mf) << 1) | (ef & 1),
                       (np.where(mt < 0, nt, mt) << 1) | (et & 1))

    def flipped(self, flip_mask: np.ndarray) -> "EdgeSet":
        """XOR the orientation bit of every handle whose node id has
        ``flip_mask[id] != 0`` (ids past the mask unflipped)."""
        m = np.asarray(flip_mask, dtype=np.int64)

        def fl(h):
            nid = h >> 1
            return h ^ np.where(nid < len(m), m[np.minimum(nid, len(m) - 1)],
                                0)

        return EdgeSet(fl(self.ef), fl(self.et))


class BidirectedGraph:
    """Bidirected sequence graph with the reference's semantics."""

    def __init__(self) -> None:
        # index = node id; None = absent
        self.nodes: List[Optional[bytes]] = []
        # stored edge forms; the complement of a stored edge is implied
        # and never stored (src/graph_ops.rs:626-638)
        self.edges = EdgeSet()
        self.paths: List[BiPath] = []
        # GFA insertion order of node ids, never rewritten on renumber:
        # SGD seeding iterates it as it is (src/sgd.rs:276-284)
        self.node_order: List[int] = []

    def add_node(self, nid: int, sequence: bytes) -> None:
        """Insert or overwrite a node (src/graph_ops.rs:613-623)."""
        if nid >= len(self.nodes):
            self.nodes.extend([None] * (nid + 1 - len(self.nodes)))
        if self.nodes[nid] is None:
            self.node_order.append(nid)
        self.nodes[nid] = bytes(sequence)

    def node_len_array(self) -> np.ndarray:
        """Per-id sequence lengths as int64, ``-1`` for absent slots."""
        return np.array([-1 if s is None else len(s) for s in self.nodes],
                        dtype=np.int64)

    def edges_to_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.edges.ef, self.edges.et

    def _remap(self, lut: np.ndarray, keep_unmapped: bool) -> None:
        """Edges and path steps through ``lut`` (lut[id] = new id, -1 =
        unmapped).  Unmapped path steps keep their id under both
        semantics (src/graph_ops.rs:52-83, :1983-2020)."""
        self.edges = self.edges.remapped(lut, drop_unmapped=not keep_unmapped)
        max_old = max((len(lut) - 1,
                       *(int(p.steps.max() >> 1) for p in self.paths
                         if len(p))))
        plut = np.arange(max_old + 1, dtype=np.int64)
        mapped = np.flatnonzero(lut >= 0)
        plut[mapped] = lut[mapped]
        for path in self.paths:
            if len(path):
                path.steps = (plut[path.steps >> 1] << 1) | (path.steps & 1)

    def apply_node_id_mapping(self, keys: np.ndarray,
                              vals: np.ndarray) -> None:
        """Renumber ``keys`` to ``vals`` (src/graph_ops.rs:36-84);
        unmapped ids keep their id."""
        lut = np.full(max(len(self.nodes),
                          int(keys.max()) + 1 if len(keys) else 1),
                      -1, dtype=np.int64)
        lut[keys] = vals
        live = np.flatnonzero(self.node_len_array() >= 0)
        lv = lut[live]
        new_of_live = np.where(lv >= 0, lv, live)
        new_nodes: List[Optional[bytes]] = [None] * (
            int(new_of_live.max()) + 1 if len(live) else 1)
        for old, new in zip(live.tolist(), new_of_live.tolist()):
            new_nodes[new] = self.nodes[old]
        self.nodes = new_nodes
        self._remap(lut, keep_unmapped=True)

    def apply_ordering(self, ordering: Sequence[int]) -> None:
        """Renumber so ``ordering[k]`` (a handle; its orientation ignored)
        becomes id k+1; nodes absent from the ordering are dropped
        (src/graph_ops.rs:1939-2025)."""
        if len(ordering) == 0:
            return
        ids = np.asarray(ordering, dtype=np.int64) >> 1
        n = len(ids)
        lut = np.full(int(ids.max()) + 1, -1, dtype=np.int64)
        lut[ids] = np.arange(1, n + 1, dtype=np.int64)
        nodes = self.nodes
        new_nodes: List[Optional[bytes]] = [None] * (n + 1)
        lutl = lut.tolist()
        for k, old in enumerate(ids.tolist()):
            if lutl[old] != k + 1:
                continue  # a later duplicate of this id won
            if old < len(nodes) and nodes[old] is not None:
                new_nodes[k + 1] = nodes[old]
        self.nodes = new_nodes
        self._remap(lut, keep_unmapped=False)
