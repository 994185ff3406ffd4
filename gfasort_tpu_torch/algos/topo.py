"""Exact-ODGI topological sort and head/tail detection.

Reproduces the reference's modified Kahn algorithm for cyclic bidirected
graphs (gfasort ``src/graph_ops.rs:1232-1485``) with identical emission
order and tie-breaking, but in O(E log V):

* the ready set is a min-heap popped in handle order (the reference's
  ``BTreeSet`` min-first pop, ``:1246``, ``:1344-1346``);
* "does this handle still have an unmasked incoming edge" is an
  incrementally maintained counter instead of a full edge-set rescan
  (``:1443-1451``);
* edges are examined in the reference's sorted order via
  :class:`~gfasort_tpu_torch.algos.adjacency.AdjacencyIndex`.
"""

from __future__ import annotations

import heapq
from typing import Dict, List

from .. import handle as H
from .adjacency import AdjacencyIndex

__all__ = [
    "find_head_nodes",
    "find_tail_nodes",
    "build_path_position_map",
    "exact_odgi_topological_order",
]


def build_path_position_map(graph) -> Dict[int, int]:
    """node_id -> earliest step rank in any path
    (src/graph_ops.rs:1111-1125)."""
    pos: Dict[int, int] = {}
    for path in graph.paths:
        for rank, h in enumerate(path.steps.tolist()):
            nid = h >> 1
            if nid not in pos or rank < pos[nid]:
                pos[nid] = rank
    return pos


def find_head_nodes(graph) -> List[int]:
    """Forward handles with no edge entering their left side, sorted by
    earliest path position then node id (src/graph_ops.rs:1138-1183).

    An edge enters the left side of node n iff it is stored as
    ``e.to == n+`` (direct) or ``e.from == n-`` (complement form).
    """
    has_left = set()
    for f, t in graph.edges:
        if not H.is_reverse(t):
            has_left.add(H.node_id(t))     # edge.to == fwd
        if H.is_reverse(f):
            has_left.add(H.node_id(f))     # edge.from == rev
    heads = [
        H.forward(nid)
        for nid in graph.live_node_ids()
        if nid not in has_left
    ]
    path_pos = build_path_position_map(graph)
    heads.sort(key=lambda h: (path_pos.get(H.node_id(h), float("inf")), H.node_id(h)))
    return heads


def find_tail_nodes(graph) -> List[int]:
    """Forward handles with no edge stored leaving their forward
    orientation, sorted by node id (src/graph_ops.rs:1186-1212).

    Note the reference checks only the direct stored form
    (``edge.from == n+``), not the complement — reproduced as-is.
    """
    has_out = set()
    for f, _t in graph.edges:
        if not H.is_reverse(f):
            has_out.add(H.node_id(f))
    tails = [
        H.forward(nid)
        for nid in graph.live_node_ids()
        if nid not in has_out
    ]
    tails.sort(key=lambda h: H.node_id(h))
    return tails


def exact_odgi_topological_order(
    graph,
    use_heads: bool = True,
    use_tails: bool = False,
) -> List[int]:
    """Modified Kahn for cyclic bidirected graphs
    (src/graph_ops.rs:1232-1485).  Returns forward handles in emission
    order; orientation of traversal never changes the emitted handle
    (``:1349-1360``).
    """
    live = graph.live_node_ids()
    if not live:
        return []

    if len(graph.edges) >= 2048:
        from .native_dispatch import native_topo

        out = native_topo(graph, use_heads, use_tails)
        if out is not None:
            return out

    adj = AdjacencyIndex(graph)
    sorted_out: List[int] = []

    # Ready set: min-heap in handle order == (node_id, is_reverse).
    s: List[int] = []

    visited_nodes = set()
    # Unvisited handles; both orientations removed together when a node
    # enters the ready set (:1277-1279).
    unvisited = set()
    for nid in live:
        unvisited.add(H.forward(nid))
        unvisited.add(H.reverse(nid))

    # Seeds consumed min-first (the reference re-sorts and pops the
    # front each time, :1296-1315) — a heap yields the same order in
    # O(log n) per op.
    seeds: List[int] = []
    seeds_set = set()

    # Lazy-deletion heap mirroring `min(unvisited)` (:1320-1334): live
    # ids are sorted, so interleaving fwd/rev handles is already a valid
    # heap; entries are skipped once no longer unvisited.
    unvisited_heap: List[int] = []
    for nid in live:
        unvisited_heap.append(H.forward(nid))
        unvisited_heap.append(H.reverse(nid))

    masked = [False] * adj.n_edges
    # Unmasked-incoming count per handle (replaces the per-check rescan).
    in_count: Dict[int, int] = {
        h: len(lst) for h, lst in adj.incoming.items()
    }

    def mask_edge(ei: int) -> None:
        if masked[ei]:
            return
        masked[ei] = True
        f, t = adj.edges[ei]
        in_count[t] -= 1
        ff = H.flip(f)
        if ff != t:
            in_count[ff] -= 1

    def enqueue(h: int) -> None:
        heapq.heappush(s, h)
        unvisited.discard(h)
        unvisited.discard(H.flip(h))

    if use_heads:
        for head in find_head_nodes(graph):
            enqueue(head)
    elif use_tails:
        for tail in find_tail_nodes(graph):
            enqueue(tail)

    while unvisited or s:
        if not s:
            # Consume seeds in (node_id, orientation) order until one is
            # still unvisited (:1296-1315).
            while seeds and not s:
                h = heapq.heappop(seeds)
                seeds_set.discard(h)
                if h in unvisited:
                    enqueue(h)
            # Fallback: minimum unvisited handle (:1320-1334).
            if not s and unvisited:
                while unvisited_heap[0] not in unvisited:
                    heapq.heappop(unvisited_heap)
                enqueue(unvisited_heap[0])

        while s:
            handle = heapq.heappop(s)
            fwd = H.forward(H.node_id(handle))

            nid = H.node_id(handle)
            if nid not in visited_nodes:
                visited_nodes.add(nid)
                sorted_out.append(fwd)

            # Mask incoming edges whose source node is already visited
            # (i.e. no longer in unvisited) (:1394-1423).
            for ei in adj.in_edges(fwd):
                if masked[ei]:
                    continue
                src = adj.incoming_source_node(ei, fwd)
                sf = H.forward(src)
                if sf not in unvisited and H.flip(sf) not in unvisited:
                    mask_edge(ei)

            # Follow outgoing edges from the FORWARD orientation
            # (:1427-1476).
            for ei in adj.out_edges(fwd):
                if masked[ei]:
                    continue
                mask_edge(ei)
                nxt = adj.next_handle(ei, fwd)
                if nxt in unvisited:
                    if in_count.get(nxt, 0) == 0:
                        enqueue(nxt)
                    elif nxt not in seeds_set:
                        heapq.heappush(seeds, nxt)
                        seeds_set.add(nxt)

    return sorted_out
