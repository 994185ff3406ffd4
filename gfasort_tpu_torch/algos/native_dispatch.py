"""Dispatch host graph passes to the native (C++) implementations.

The Python implementations in :mod:`gfasort_tpu_torch.algos` are the semantic
definition (validated against naive transcriptions of the reference);
``graph_algos.cpp`` is a bit-identical port used for large graphs, where
the Python BFS/Kahn loops cost seconds per million nodes.  Randomized
equivalence tests (tests/test_algos.py) pin C++ == Python.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["graph_arrays", "native_topo", "native_groom", "NATIVE_MIN_EDGES"]

# Below this, Python is fast enough and array marshalling dominates.
NATIVE_MIN_EDGES = 2048


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def graph_arrays(graph) -> Tuple[np.ndarray, ...]:
    """(e_from, e_to, live_ids, steps, path_off, max_id) as contiguous
    int64 (+ int).  ``max_id`` covers live nodes AND any dangling ids
    referenced by edges or path steps — the C side sizes its id-indexed
    arrays by it, and dangling references are legal graph state
    (validate_graph_consistency reports them, nothing forbids them)."""
    ef, et = graph.edges_to_arrays()
    live = np.asarray(graph.live_node_ids(), dtype=np.int64)
    parts = [p.steps for p in graph.paths if len(p)]
    steps = (
        np.ascontiguousarray(np.concatenate(parts), dtype=np.int64)
        if parts
        else np.zeros(0, np.int64)
    )
    counts = [len(p) for p in graph.paths if len(p)]
    path_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    max_id = 0
    for arr in (live, ef >> 1, et >> 1, steps >> 1):
        if len(arr):
            max_id = max(max_id, int(arr.max()))
    return ef, et, live, steps, path_off, max_id


def _lib():
    from ..native.build import load

    return load()


def native_topo(graph, use_heads: bool, use_tails: bool) -> Optional[List[int]]:
    """Native exact-ODGI topo order, or None if unavailable."""
    lib = _lib()
    if lib is None:
        return None
    ef, et, live, steps, path_off, max_id = graph_arrays(graph)
    if len(live) == 0:
        return []
    out = np.empty(len(live), dtype=np.int64)
    n = lib.topo_exact_order(
        len(ef), _p64(ef), _p64(et),
        len(live), _p64(live), max_id,
        len(steps), _p64(steps), len(path_off) - 1, _p64(path_off),
        int(use_heads), int(use_tails),
        _p64(out),
    )
    if n < 0:
        return None
    return out[:n].tolist()


def native_simple_components(graph) -> Optional[List[List[int]]]:
    """Native unchop component finder, or None if unavailable."""
    lib = _lib()
    if lib is None:
        return None
    ef, et, live, steps, path_off, max_id = graph_arrays(graph)
    if len(live) == 0:
        return []
    out_chains = np.empty(2 * (max_id + 1), dtype=np.int64)
    out_off = np.empty(2 * len(live) + 1, dtype=np.int64)
    n = lib.find_simple_components_native(
        len(ef), _p64(ef), _p64(et),
        len(live), _p64(live), max_id,
        len(steps), _p64(steps), len(path_off) - 1, _p64(path_off),
        _p64(out_chains), _p64(out_off),
    )
    if n < 0:
        return None
    return [
        out_chains[out_off[c]:out_off[c + 1]].tolist() for c in range(n)
    ]


def native_priority_topo(
    graph, priority_order, use_heads: bool, reverse_edges: bool
) -> Optional[List[int]]:
    """Native priority topological order, or None if unavailable."""
    lib = _lib()
    if lib is None:
        return None
    ef, et, live, steps, path_off, max_id = graph_arrays(graph)
    if len(live) == 0:
        return []
    prio = np.ascontiguousarray(np.asarray(priority_order, dtype=np.int64))
    out = np.empty(len(live), dtype=np.int64)
    n = lib.priority_topo_order(
        len(ef), _p64(ef), _p64(et),
        len(live), _p64(live), max_id,
        len(steps), _p64(steps), len(path_off) - 1, _p64(path_off),
        len(prio), _p64(prio),
        int(use_heads), int(reverse_edges),
        _p64(out),
    )
    if n < 0:
        return None
    return out[:n].tolist()


def native_groom(graph, use_bfs: bool) -> Optional[List[int]]:
    """Native groom order (BFS/DFS modes), or None if unavailable."""
    lib = _lib()
    if lib is None:
        return None
    ef, et, live, steps, path_off, max_id = graph_arrays(graph)
    if len(live) == 0:
        return []
    out = np.empty(len(live), dtype=np.int64)
    n = lib.groom_order(
        len(ef), _p64(ef), _p64(et),
        len(live), _p64(live), max_id,
        len(steps), _p64(steps), len(path_off) - 1, _p64(path_off),
        int(use_bfs),
        _p64(out),
    )
    if n < 0:
        return None
    return out[:n].tolist()
