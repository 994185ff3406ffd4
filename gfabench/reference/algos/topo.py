"""Exact-ODGI topological sort and head detection, as the CLI's ``s`` step
runs it (heads, no tails).

The modified Kahn algorithm for cyclic bidirected graphs of gfasort
``src/graph_ops.rs:1232-1485``, in the O(E log V) form of
``gfasort_tpu_torch/algos/topo.py``: the ready set a min-heap popped in
handle order, an incrementally kept count of each handle's unmasked
incoming edges, the edges of each handle in the reference's sorted order.
Restated with the handles' state in flat arrays (a byte per handle, a
count per handle) instead of sets and dicts; the emission order is the
same.
"""

from __future__ import annotations

import heapq
from typing import List

import numpy as np

from .adjacency import AdjacencyIndex

__all__ = ["find_head_nodes", "exact_odgi_topological_order"]


def _live_ids(graph) -> np.ndarray:
    return np.flatnonzero(graph.node_len_array() >= 0)


def find_head_nodes(graph) -> List[int]:
    """Forward handles with no edge entering their left side, sorted by
    earliest path position (the smallest step rank of the node in any
    path), then node id (src/graph_ops.rs:1111-1183).

    An edge enters the left side of node n iff it is stored as
    ``e.to == n+`` (direct) or ``e.from == n-`` (complement form).
    """
    ef, et = graph.edges_to_arrays()
    live = _live_ids(graph)
    top = max([int(live.max()) if len(live) else 0]
              + [int(a.max() >> 1) for a in (ef, et) if len(a)]
              + [int(p.steps.max() >> 1) for p in graph.paths if len(p)])
    has_left = np.zeros(top + 1, dtype=bool)
    has_left[et[(et & 1) == 0] >> 1] = True
    has_left[ef[(ef & 1) == 1] >> 1] = True
    heads = live[~has_left[live]]
    big = np.iinfo(np.int64).max
    first = np.full(top + 1, big, dtype=np.int64)
    for path in graph.paths:
        # each id's first rank in this path
        ids, rank = np.unique(path.steps >> 1, return_index=True)
        first[ids] = np.minimum(first[ids], rank)
    order = np.lexsort((heads, first[heads]))
    return (heads[order] << 1).tolist()


def exact_odgi_topological_order(graph) -> List[int]:
    """Modified Kahn for cyclic bidirected graphs (heads seeded,
    src/graph_ops.rs:1232-1485).  Returns forward handles in emission
    order; orientation of traversal never changes the emitted handle
    (``:1349-1360``)."""
    live = _live_ids(graph).tolist()
    if not live:
        return []
    adj = AdjacencyIndex(graph)
    ef, et = adj.ef, adj.et
    n_h = max(adj.n_handles, 2 * live[-1] + 2)
    # unvisited handles; both orientations leave together when a node
    # enters the ready set (:1277-1279)
    unv = bytearray(n_h)
    for nid in live:
        unv[2 * nid] = unv[2 * nid + 1] = 1
    n_unv = 2 * len(live)
    visited = bytearray(n_h // 2 + 1)
    masked = bytearray(adj.n_edges)
    in_count = adj.in_counts + [0] * (n_h - adj.n_handles)
    seeds: List[int] = []          # consumed min-first (:1296-1315)
    in_seeds = bytearray(n_h)
    # min(unvisited) (:1320-1334): the live handles ascending, a cursor
    # past the ones that left
    all_h = [h for nid in live for h in (2 * nid, 2 * nid + 1)]
    cursor = 0
    s: List[int] = []              # the ready set, a min-heap
    out: List[int] = []

    def enqueue(h: int) -> None:
        nonlocal n_unv
        heapq.heappush(s, h)
        if unv[h]:
            unv[h] = 0
            n_unv -= 1
        if unv[h ^ 1]:
            unv[h ^ 1] = 0
            n_unv -= 1

    for head in find_head_nodes(graph):
        enqueue(head)

    while n_unv or s:
        if not s:
            while seeds and not s:
                h = heapq.heappop(seeds)
                in_seeds[h] = 0
                if unv[h]:
                    enqueue(h)
            if not s and n_unv:
                while not unv[all_h[cursor]]:
                    cursor += 1
                enqueue(all_h[cursor])

        while s:
            handle = heapq.heappop(s)
            fwd = handle & ~1
            nid = handle >> 1
            if not visited[nid]:
                visited[nid] = 1
                out.append(fwd)
            # mask incoming edges whose source node is no longer
            # unvisited (:1394-1423)
            for ei in adj.in_edges(fwd):
                if masked[ei]:
                    continue
                f, t = ef[ei], et[ei]
                sf = (f if t == fwd else t) & ~1
                if not unv[sf] and not unv[sf ^ 1]:
                    masked[ei] = 1
                    in_count[t] -= 1
                    if f ^ 1 != t:
                        in_count[f ^ 1] -= 1
            # follow outgoing edges from the forward orientation
            # (:1427-1476)
            for ei in adj.out_edges(fwd):
                if masked[ei]:
                    continue
                f, t = ef[ei], et[ei]
                masked[ei] = 1
                in_count[t] -= 1
                if f ^ 1 != t:
                    in_count[f ^ 1] -= 1
                nxt = t if f == fwd else f ^ 1
                if unv[nxt]:
                    if in_count[nxt] == 0:
                        enqueue(nxt)
                    elif not in_seeds[nxt]:
                        heapq.heappush(seeds, nxt)
                        in_seeds[nxt] = 1
    return out
