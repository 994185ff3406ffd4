"""Host-side bidirected graph kernel.

Struct-of-arrays rebuild of the reference's ``BidirectedGraph``
(gfasort ``src/graph_ops.rs:7-16``): nodes are a dense id-indexed list of
optional sequences (stable iteration order), edges a set of (from, to)
handle pairs with the bidirected "store one of edge/complement" invariant
(``src/graph_ops.rs:626-638``), paths carry numpy ``int64`` handle arrays
so the path index and all step remappings are vectorized, and
``node_order`` records GFA insertion order, which seeds the SGD initial
positions (``src/graph_ops.rs:14-16``, ``src/sgd.rs:275-294``).

This layer is deliberately host/NumPy: graph mutation (renumbering,
grooming, unchop) is a worklist problem that does not belong on the MXU.
The TPU-resident view of the graph is built from it by
:mod:`gfasort_tpu_torch.index`.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import handle as H
from .trace import spanned

__all__ = ["BiPath", "BidirectedGraph"]


class BiPath:
    """A path through the graph: a name plus an int64 array of handles.

    Mirrors the reference ``BiPath`` (src/graph.rs:131-172) with an
    array-of-handles representation.
    """

    __slots__ = ("name", "steps")

    def __init__(self, name: str, steps: Optional[Sequence[int]] = None):
        self.name = name
        self.steps = np.asarray(
            steps if steps is not None else [], dtype=np.int64
        )

    def add_step(self, handle: int) -> None:
        self.steps = np.append(self.steps, np.int64(handle))

    def __len__(self) -> int:
        return int(self.steps.shape[0])

    def __repr__(self) -> str:
        return f"BiPath({self.name!r}, {len(self)} steps)"


class EdgeSet:
    """Set-like container for the stored edge forms with a lazy SoA
    fast path (r5).

    The reference stores edges in native vectors; a Python set of
    (from, to) tuples costs ~3-4 s of PyObject churn to rebuild per
    renumber at 4M edges (the dominant host cost of every reorder step
    at genome scale).  This container keeps edges in ONE of two modes:

    * ``set``   — a real Python set of tuples (general: membership,
      add/discard); the mode every mutation runs in.
    * ``array`` — two int64 numpy columns, produced by the VECTORIZED
      ``remapped`` used by apply_ordering / apply_node_id_mapping
      (~50 ms at 4M edges).  Promoted back to ``set`` lazily, only
      when a consumer actually needs membership or mutation (C
      materializer: native/py_assemble.cpp gfa_build_edges).

    Duck-types the set operations the codebase uses (len, iteration as
    tuples, ``in``, add/discard, ==); plain-set assignments to
    ``graph.edges`` keep working (graph methods accept either)."""

    __slots__ = ("_set", "_arr")

    def __init__(self, init=None):
        if isinstance(init, EdgeSet):
            self._set = set(init._set) if init._set is not None else None
            self._arr = (
                tuple(a.copy() for a in init._arr)
                if init._arr is not None else None
            )
        else:
            self._set = set(init) if init is not None else set()
            self._arr = None

    @classmethod
    def from_arrays(cls, ef: np.ndarray, et: np.ndarray) -> "EdgeSet":
        es = cls.__new__(cls)
        es._set = None
        es._arr = (np.ascontiguousarray(ef, dtype=np.int64),
                   np.ascontiguousarray(et, dtype=np.int64))
        return es

    def _materialize(self) -> set:
        if self._set is None:
            ef, et = self._arr
            s = None
            if len(ef) >= 4096:
                try:
                    from .native.build import load_py

                    pylib = load_py()
                    if pylib is not None:
                        import ctypes

                        p = ctypes.POINTER(ctypes.c_int64)
                        s = pylib.gfa_build_edges(
                            len(ef), ef.ctypes.data_as(p),
                            et.ctypes.data_as(p),
                        )
                except Exception:
                    s = None
            if s is None:
                s = set(zip(ef.tolist(), et.tolist()))
            self._set, self._arr = s, None
        return self._set

    def to_arrays(self):
        """(from, to) int64 columns; fresh arrays the caller may own."""
        if self._arr is not None:
            return self._arr[0].copy(), self._arr[1].copy()
        return _edge_set_to_arrays(self._set)

    def remapped(self, lut: np.ndarray, drop_unmapped: bool,
                 dedup: bool = True) -> "EdgeSet":
        """Vectorized node-id remap (semantics of the legacy per-edge
        loop: unmapped = lut[id] < 0 or id >= len(lut); identical
        stored forms after a many-to-one mapping are deduped).
        ``dedup=False`` skips the unique pass — valid when the mapping
        is injective (apply_ordering), where distinct stored forms
        stay distinct."""
        if self._arr is not None:
            ef, et = self._arr
        else:
            ef, et = _edge_set_to_arrays(self._set)
        nf, nt = ef >> 1, et >> 1
        inl_f = (nf >= 0) & (nf < len(lut))
        inl_t = (nt >= 0) & (nt < len(lut))
        mf = np.where(inl_f, lut[np.where(inl_f, nf, 0)], -1)
        mt = np.where(inl_t, lut[np.where(inl_t, nt, 0)], -1)
        if drop_unmapped:
            keep = (mf >= 0) & (mt >= 0)
            ef2 = (mf[keep] << 1) | (ef[keep] & 1)
            et2 = (mt[keep] << 1) | (et[keep] & 1)
        else:
            mf = np.where(mf < 0, nf, mf)
            mt = np.where(mt < 0, nt, mt)
            ef2 = (mf << 1) | (ef & 1)
            et2 = (mt << 1) | (et & 1)
        if not dedup:
            return EdgeSet.from_arrays(ef2, et2)
        if len(ef2) and max(int(ef2.max()), int(et2.max())) < (1 << 32):
            # dedup via one packed-u64 unique (np.unique sorts; set
            # iteration order was never meaningful)
            key = np.unique(
                (ef2.astype(np.uint64) << np.uint64(32))
                | et2.astype(np.uint64)
            )
            ef2 = (key >> np.uint64(32)).astype(np.int64)
            et2 = (key & np.uint64(0xFFFFFFFF)).astype(np.int64)
            return EdgeSet.from_arrays(ef2, et2)
        # huge handles (>= 2^32): fall back to set dedup
        return EdgeSet(set(zip(ef2.tolist(), et2.tolist())))

    def flipped(self, flip_mask: np.ndarray) -> "EdgeSet":
        """XOR the orientation bit of every handle whose node id has
        ``flip_mask[id] != 0`` (grooming; ids >= len(mask) unflipped).
        Injective per handle — no dedup needed."""
        if self._arr is not None:
            ef, et = self._arr
        else:
            ef, et = _edge_set_to_arrays(self._set)
        m = np.asarray(flip_mask, dtype=np.int64)

        def fl(h):
            nid = h >> 1
            bit = np.where(nid < len(m), m[np.minimum(nid, len(m) - 1)], 0)
            return h ^ bit

        return EdgeSet.from_arrays(fl(ef), fl(et))

    # ---- set-protocol surface the codebase uses ----
    def __len__(self) -> int:
        return (len(self._arr[0]) if self._set is None else len(self._set))

    def __iter__(self):
        if self._set is not None:
            return iter(self._set)
        ef, et = self._arr
        return iter(zip(ef.tolist(), et.tolist()))

    def __contains__(self, edge) -> bool:
        return edge in self._materialize()

    def add(self, edge) -> None:
        self._materialize().add(edge)

    def discard(self, edge) -> None:
        self._materialize().discard(edge)

    def remove(self, edge) -> None:
        self._materialize().remove(edge)

    def __eq__(self, other) -> bool:
        if isinstance(other, EdgeSet):
            return self._materialize() == other._materialize()
        if isinstance(other, (set, frozenset)):
            return self._materialize() == other
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __repr__(self) -> str:
        mode = "set" if self._set is not None else "array"
        return f"EdgeSet(n={len(self)}, mode={mode})"


def _edge_set_to_arrays(edges: set) -> Tuple[np.ndarray, np.ndarray]:
    """Python edge set -> two int64 columns (C fast path when big)."""
    n = len(edges)
    ef = np.empty(n, dtype=np.int64)
    et = np.empty(n, dtype=np.int64)
    if n >= 4096:
        try:
            from .native.build import load_py

            pylib = load_py()
            if pylib is not None:
                import ctypes

                p = ctypes.POINTER(ctypes.c_int64)
                if pylib.edge_set_to_arrays(
                    edges, ef.ctypes.data_as(p), et.ctypes.data_as(p)
                ) == n:
                    return ef, et
        except Exception:
            pass
    for i, (f, t) in enumerate(edges):
        ef[i] = f
        et[i] = t
    return ef, et


class BidirectedGraph:
    """Bidirected sequence graph with the reference's exact semantics."""

    def __init__(self) -> None:
        # Index = node id; None = deleted / never present.
        self.nodes: List[Optional[bytes]] = []
        # Optional per-node rank assigned by apply_ordering (0-based).
        self.ranks: Dict[int, int] = {}
        # Stored edge forms; the complement of a stored edge is implied
        # and never stored (src/graph_ops.rs:626-638).  EdgeSet
        # duck-types a set of (from, to) tuples; plain-set assignment
        # also works.
        self.edges: EdgeSet = EdgeSet()
        self.paths: List[BiPath] = []
        # GFA insertion order of node ids.  NEVER rewritten on renumber;
        # the reference keeps it stale on purpose and SGD seeding
        # iterates it as-is (src/sgd.rs:276-284).
        self.node_order: List[int] = []

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    def add_node(self, nid: int, sequence: bytes) -> None:
        """Insert/overwrite a node (src/graph_ops.rs:613-623)."""
        if nid >= len(self.nodes):
            self.nodes.extend([None] * (nid + 1 - len(self.nodes)))
        if self.nodes[nid] is None:
            self.node_order.append(nid)
        self.nodes[nid] = bytes(sequence)

    def add_edge(self, from_h: int, to_h: int) -> None:
        """Insert the edge unless it or its complement exists
        (src/graph_ops.rs:626-638)."""
        edge = (from_h, to_h)
        complement = (H.flip(to_h), H.flip(from_h))
        if edge not in self.edges and complement not in self.edges:
            self.edges.add(edge)

    def build_path(self, name: str, steps: Iterable[Tuple[int, bool]]) -> None:
        """Append a path from (node_id, is_reverse) pairs
        (src/graph_ops.rs:684-690)."""
        self.paths.append(
            BiPath(name, [H.encode(nid, int(rev)) for nid, rev in steps])
        )

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------
    def node_count(self) -> int:
        return sum(1 for n in self.nodes if n is not None)

    def node_len_array(self) -> np.ndarray:
        """Per-id sequence lengths as int64, ``-1`` for dead/absent slots.
        One native pass at scale; the Python loop is the fallback."""
        out = np.empty(len(self.nodes), dtype=np.int64)
        if len(self.nodes) >= 4096:
            from .native.build import load_py

            pylib = load_py()
            if pylib is not None:
                import ctypes

                n = pylib.node_len_fill(
                    self.nodes,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                )
                if n >= 0:
                    return out
        for i, seq in enumerate(self.nodes):
            out[i] = -1 if seq is None else len(seq)
        return out

    def live_node_ids(self) -> List[int]:
        if len(self.nodes) >= 4096:
            return np.flatnonzero(self.node_len_array() >= 0).tolist()
        return [i for i, n in enumerate(self.nodes) if n is not None]

    def edges_to_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """The stored edge forms as two int64 arrays (from, to)."""
        if isinstance(self.edges, EdgeSet):
            return self.edges.to_arrays()
        return _edge_set_to_arrays(self.edges)

    def total_sequence_length(self) -> int:
        return sum(len(n) for n in self.nodes if n is not None)

    def get_sequence(self, handle: int) -> Optional[bytes]:
        """Oriented sequence of a handle (src/graph_ops.rs:641-646)."""
        nid = H.node_id(handle)
        if nid >= len(self.nodes) or self.nodes[nid] is None:
            return None
        seq = self.nodes[nid]
        return H.reverse_complement(seq) if H.is_reverse(handle) else seq

    def has_edge(self, from_h: int, to_h: int) -> bool:
        """Edge existence, checking both forms (src/graph_ops.rs:649-653)."""
        return (from_h, to_h) in self.edges or (
            H.flip(to_h),
            H.flip(from_h),
        ) in self.edges

    def edges_from(self, handle: int) -> List[int]:
        """All successors of ``handle``, matching direct and complement
        stored forms (src/graph_ops.rs:656-667)."""
        out = []
        for f, t in self.edges:
            if f == handle:
                out.append(t)
            elif H.flip(t) == handle:
                out.append(H.flip(f))
        return out

    def edges_to(self, handle: int) -> List[int]:
        """All predecessors of ``handle`` (src/graph_ops.rs:670-681)."""
        out = []
        for f, t in self.edges:
            if t == handle:
                out.append(f)
            elif H.flip(f) == handle:
                out.append(H.flip(t))
        return out

    def paths_through_node(self, nid: int) -> List[int]:
        """Indices of paths visiting ``nid`` (src/graph_ops.rs:513-524)."""
        out = []
        for i, path in enumerate(self.paths):
            if np.any((path.steps >> 1) == nid):
                out.append(i)
        return out

    def path_sequence(self, path: BiPath) -> bytes:
        """Concatenated oriented sequence of a path (src/graph.rs:161-172)."""
        parts = []
        for h in path.steps.tolist():
            seq = self.get_sequence(int(h))
            if seq is not None:
                parts.append(seq)
        return b"".join(parts)

    # ------------------------------------------------------------------
    # Renumbering / ordering
    # ------------------------------------------------------------------
    def _remap_arrays(self, mapping: Dict[int, int], keep_unmapped: bool) -> None:
        """Rewrite edges and path steps through an id mapping.

        ``keep_unmapped=True`` reproduces apply_node_id_mapping semantics
        (unmapped ids pass through, src/graph_ops.rs:52-83);
        ``keep_unmapped=False`` reproduces apply_ordering semantics
        (edges touching unmapped ids are dropped; unmapped path steps
        keep their old id, src/graph_ops.rs:1983-2020).
        """
        if not mapping:
            # legacy behavior: an empty mapping leaves paths untouched
            # and (with drop semantics) empties the edge set
            if not keep_unmapped:
                self.edges = EdgeSet()
            return
        lut = np.full(max(mapping) + 1, -1, dtype=np.int64)
        keys = np.fromiter(mapping.keys(), dtype=np.int64, count=len(mapping))
        vals = np.fromiter(mapping.values(), dtype=np.int64, count=len(mapping))
        lut[keys] = vals
        self._remap_arrays_lut(lut, keep_unmapped, dedup=True)

    def _remap_arrays_lut(self, lut: np.ndarray, keep_unmapped: bool,
                          dedup: bool) -> None:
        """LUT-based core of :meth:`_remap_arrays` (lut[id] = new id,
        -1 = unmapped; ids >= len(lut) unmapped).  Vectorized end to
        end: even the r1-r4 C set-to-set pass cost ~3-4 s of PyObject
        churn at 4M edges — the EdgeSet array mode removes the churn
        entirely and materializes a real set only on demand."""
        es = (self.edges if isinstance(self.edges, EdgeSet)
              else EdgeSet(self.edges))
        self.edges = es.remapped(
            lut, drop_unmapped=not keep_unmapped, dedup=dedup
        )

        # paths: unmapped step ids keep their old id under BOTH
        # semantics (src/graph_ops.rs:52-83, :1983-2020)
        max_old = max(
            (len(lut) - 1,
             *(int(p.steps.max() >> 1) for p in self.paths if len(p))),
        )
        plut = np.arange(max_old + 1, dtype=np.int64)
        mapped = np.flatnonzero(lut >= 0)
        plut[mapped] = lut[mapped]
        for path in self.paths:
            if len(path):
                ids = path.steps >> 1
                path.steps = (plut[ids] << 1) | (path.steps & 1)

    def apply_node_id_mapping(self, mapping: Dict[int, int]) -> None:
        """Renumber nodes through ``mapping`` (src/graph_ops.rs:36-84).
        Ids absent from the mapping keep their old id."""
        if not mapping:
            return
        keys = np.fromiter(mapping.keys(), dtype=np.int64, count=len(mapping))
        vals = np.fromiter(mapping.values(), dtype=np.int64, count=len(mapping))
        self._apply_node_id_mapping_arrays(keys, vals)

    def _apply_node_id_mapping_arrays(self, keys: np.ndarray,
                                      vals: np.ndarray) -> None:
        """Vectorized core of :meth:`apply_node_id_mapping` (r5: the
        dict-based per-node loop cost seconds at genome scale).
        Semantics preserved: unmapped ids keep their old id; when
        several old ids map to one new id, the LARGEST old id wins the
        node slot (the legacy loop iterated old ids ascending and
        overwrote)."""
        lut = np.full(
            max(len(self.nodes), int(keys.max()) + 1 if len(keys) else 1),
            -1, dtype=np.int64,
        )
        lut[keys] = vals
        live = np.asarray(self.live_node_ids(), dtype=np.int64)
        lv = lut[live]
        new_of_live = np.where(lv >= 0, lv, live)
        max_new = int(new_of_live.max()) if len(live) else 0
        nodes = self.nodes
        ranks = self.ranks
        new_nodes: List[Optional[bytes]] = [None] * (max_new + 1)
        new_ranks: Dict[int, int] = {}
        if ranks:
            for old, new in zip(live.tolist(), new_of_live.tolist()):
                new_nodes[new] = nodes[old]
                if old in ranks:
                    new_ranks[new] = ranks[old]
        else:
            for old, new in zip(live.tolist(), new_of_live.tolist()):
                new_nodes[new] = nodes[old]
        self.nodes = new_nodes
        self.ranks = new_ranks
        self._remap_arrays_lut(lut, keep_unmapped=True, dedup=True)

    def renumber_nodes_sequentially(self) -> None:
        """Compact live ids to 1..N in id order (src/graph_ops.rs:88-102)."""
        mapping = {old: i + 1 for i, old in enumerate(self.live_node_ids())}
        self.apply_node_id_mapping(mapping)

    @spanned("graph.reorder")
    def apply_ordering(self, ordering: Sequence[int]) -> None:
        """Renumber so ordering[k] becomes id k+1 (src/graph_ops.rs:1939-2025).

        ``ordering`` is a sequence of handles; orientation bits are
        ignored for the renumbering (the reference maps node ids only).
        Nodes absent from the ordering are dropped.

        Vectorized (r5): LUT instead of a dict, injective remap skips
        the edge dedup pass — the per-node Python path cost ~6 s at 1M
        nodes / 4M edges and dominated the warm-server Y step.
        """
        if len(ordering) == 0:
            return
        ids = np.asarray(ordering, dtype=np.int64) >> 1
        n = len(ids)
        lut = np.full(int(ids.max()) + 1, -1, dtype=np.int64)
        lut[ids] = np.arange(1, n + 1, dtype=np.int64)  # duplicate: last wins
        nodes = self.nodes
        n_nodes = len(nodes)
        new_nodes: List[Optional[bytes]] = [None] * (n + 1)
        new_ranks: Dict[int, int] = {}
        lutl = lut.tolist()
        for k, old in enumerate(ids.tolist()):
            if lutl[old] != k + 1:
                continue  # a later duplicate of this handle won
            if old < n_nodes and nodes[old] is not None:
                new_nodes[k + 1] = nodes[old]
                new_ranks[k + 1] = k  # 0-based rank (rs:1976)
        self.nodes = new_nodes
        self.ranks = new_ranks
        # the mapping is injective on new ids -> no edge dedup needed
        self._remap_arrays_lut(lut, keep_unmapped=False, dedup=False)

    # ------------------------------------------------------------------
    # Validation & hashing (src/graph_ops.rs:741-893)
    # ------------------------------------------------------------------
    def validate_graph_consistency(self) -> List[str]:
        """Edges/paths must reference live nodes (src/graph_ops.rs:741-778).
        Returns a list of error strings (empty = consistent)."""
        errors = []
        n = len(self.nodes)

        def live(nid: int) -> bool:
            return nid < n and self.nodes[nid] is not None

        for f, t in self.edges:
            if not live(H.node_id(f)):
                errors.append(f"Edge references non-existent node: {H.node_id(f)} (from)")
            if not live(H.node_id(t)):
                errors.append(f"Edge references non-existent node: {H.node_id(t)} (to)")
        for path in self.paths:
            for nid in np.unique(path.steps >> 1).tolist():
                if not live(int(nid)):
                    errors.append(
                        f"Path {path.name} references non-existent node: {nid}"
                    )
        return errors

    def compute_path_hash(self, path: BiPath) -> str:
        """SHA-256 over the oriented step sequences (src/graph_ops.rs:781-791)."""
        hasher = hashlib.sha256()
        for h in path.steps.tolist():
            seq = self.get_sequence(int(h))
            if seq is not None:
                hasher.update(seq)
        return hasher.hexdigest()

    def compute_all_path_hashes(self) -> Dict[str, str]:
        return {p.name: self.compute_path_hash(p) for p in self.paths}

    def validate_path_hashes(self, expected: Dict[str, str]) -> bool:
        """True iff every expected path hash is unchanged
        (src/graph_ops.rs:838-859)."""
        current = self.compute_all_path_hashes()
        return all(current.get(name) == h for name, h in expected.items())

    def verify_path_edges(self) -> int:
        """Add any path-implied edges missing from the edge set; returns the
        number added (src/graph_ops.rs:862-893)."""
        added = 0
        for path in self.paths:
            steps = path.steps.tolist()
            for a, b in zip(steps, steps[1:]):
                if not self.has_edge(int(a), int(b)):
                    self.edges.add((int(a), int(b)))
                    added += 1
        return added

    def validate_paths(self) -> Dict[str, int]:
        """Path statistics (src/graph_ops.rs:805-835): counts of
        consecutive repeated steps and max per-node visit count per
        path.  Repeated nodes are VALID (structural variation); this
        reports, never fails."""
        stats = {"paths_with_repeats": 0, "consecutive_repeats": 0}
        for path in self.paths:
            steps = path.steps
            if len(steps) < 2:
                continue
            consec = int((steps[:-1] == steps[1:]).sum())
            ids, counts = np.unique(steps >> 1, return_counts=True)
            if consec > 0 or (counts > 5).any():
                stats["paths_with_repeats"] += 1
            stats["consecutive_repeats"] += consec
        return stats

    # ------------------------------------------------------------------
    # Misc
    # ------------------------------------------------------------------
    def count_edge_directions(self) -> Tuple[int, int]:
        """(forward, backward) edge counts by node-id order
        (src/graph_ops.rs:1215-1227); self-id edges uncounted."""
        fwd = bwd = 0
        for f, t in self.edges:
            fid, tid = H.node_id(f), H.node_id(t)
            if fid < tid:
                fwd += 1
            elif fid > tid:
                bwd += 1
        return fwd, bwd

    def clone(self) -> "BidirectedGraph":
        g = BidirectedGraph()
        g.nodes = list(self.nodes)
        g.ranks = dict(self.ranks)
        g.edges = EdgeSet(self.edges)
        g.paths = [BiPath(p.name, p.steps.copy()) for p in self.paths]
        g.node_order = list(self.node_order)
        return g

    def __repr__(self) -> str:
        return (
            f"BidirectedGraph(nodes={self.node_count()}, "
            f"edges={len(self.edges)}, paths={len(self.paths)})"
        )


def alignment_to_edges(
    query_handle: int,
    target_handle: int,
    query_len: int,
    target_len: int,
    is_reverse_alignment: bool,
) -> List[Tuple[int, int]]:
    """Edge(s) implied by an oriented alignment
    (src/graph_ops.rs:2028-2049): for reverse alignments the target
    handle is flipped; one edge from query end to target start."""
    del query_len, target_len  # kept for API parity; unused (as in ref)
    to_h = H.flip(target_handle) if is_reverse_alignment else target_handle
    return [(query_handle, to_h)]
