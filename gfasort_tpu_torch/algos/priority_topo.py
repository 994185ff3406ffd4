"""Priority topological sort ('S' pipeline step).

Reproduces the reference's priority-based Kahn variant
(gfasort ``src/graph_ops.rs:1492-1760``): the ready set is a min-heap
keyed ``(rank_in_priority_order, is_reverse, node_id)``, auto "reverse
mode" follows edges backwards when backward edges outnumber forward
edges 2:1 (``:1548-1549``), and a post-pass reverses the whole output if
it is majority-against the priority order (``:1736-1757``).

Unlike :func:`exact_odgi_topological_order`, edges are examined relative
to the handle actually popped (not its forward orientation), and
incoming edges are masked unconditionally (``:1688-1693``).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence

from .. import handle as H
from .adjacency import AdjacencyIndex
from .topo import find_head_nodes, find_tail_nodes

__all__ = ["priority_topological_order"]


def priority_topological_order(
    graph,
    priority_order: Sequence[int],
    use_heads: bool = True,
    reverse_edges: bool = False,
) -> List[int]:
    live = graph.live_node_ids()
    if not live:
        return []

    if len(graph.edges) >= 2048:
        from .native_dispatch import native_priority_topo

        out = native_priority_topo(graph, priority_order, use_heads, reverse_edges)
        if out is not None:
            return out

    rank: Dict[int, int] = {nid: i for i, nid in enumerate(priority_order)}
    max_rank = len(priority_order)

    adj = AdjacencyIndex(graph)
    fwd_cnt, bwd_cnt = graph.count_edge_directions()
    reverse_mode = reverse_edges or (bwd_cnt > fwd_cnt * 2)

    # In reverse mode, "incoming" and "outgoing" swap (:1648-1666).
    in_of = adj.out_edges if reverse_mode else adj.in_edges
    out_of = adj.in_edges if reverse_mode else adj.out_edges
    next_of = adj.prev_handle if reverse_mode else adj.next_handle
    in_lists = adj.outgoing if reverse_mode else adj.incoming

    s: List = []  # heap of (rank, is_reverse, node_id)

    def heap_key(h: int):
        return (rank.get(H.node_id(h), max_rank), H.is_reverse(h), H.node_id(h))

    visited_nodes = set()
    unvisited = set()
    for nid in live:
        unvisited.add(H.forward(nid))
        unvisited.add(H.reverse(nid))

    # Seeds heap keyed (rank, is_reverse, insertion seq): the reference
    # stable-sorts by (rank, is_reverse) and removes the front
    # (:1586-1590), so ties resolve by insertion order — the seq field
    # reproduces that in O(log n) per op.
    seeds: List = []
    seeds_seq = 0
    seeds_set = set()

    # Lazy-deletion heap for the fallback min-rank unvisited handle.
    # The reference takes min_by_key((rank, is_reverse)) over a HashSet
    # (:1604-1610) — tie-break there is hash-iteration order, i.e.
    # nondeterministic; breaking ties by node id is deterministic and
    # agrees whenever the reference is itself well-defined.
    unvisited_heap: List = [
        (rank.get(nid, max_rank), rev, nid)
        for nid in live
        for rev in (0, 1)
    ]
    heapq.heapify(unvisited_heap)

    masked = [False] * adj.n_edges
    in_count: Dict[int, int] = {h: len(lst) for h, lst in in_lists.items()}

    def mask_edge(ei: int) -> None:
        if masked[ei]:
            return
        masked[ei] = True
        f, t = adj.edges[ei]
        if reverse_mode:
            # "incoming" = outgoing lists: edge leaves f and flip(t)
            a, b = f, H.flip(t)
        else:
            a, b = t, H.flip(f)
        in_count[a] = in_count.get(a, 0) - 1
        if b != a:
            in_count[b] = in_count.get(b, 0) - 1

    def enqueue(h: int) -> None:
        heapq.heappush(s, heap_key(h))
        unvisited.discard(h)
        unvisited.discard(H.flip(h))

    if use_heads:
        inits = find_tail_nodes(graph) if reverse_mode else find_head_nodes(graph)
        for h in inits:
            enqueue(h)

    sorted_out: List[int] = []
    while unvisited or s:
        if not s:
            found_seed = False
            if seeds:
                # Lowest-rank seed first (:1586-1601); one removal per
                # attempt, used or not.
                _, _, _, h = heapq.heappop(seeds)
                seeds_set.discard(h)
                if h in unvisited:
                    enqueue(h)
                    found_seed = True
            if not found_seed and not s and unvisited:
                while True:
                    _, rev, nid = unvisited_heap[0]
                    h = H.encode(nid, rev)
                    if h in unvisited:
                        break
                    heapq.heappop(unvisited_heap)
                enqueue(h)

        while s:
            r, is_rev, nid = heapq.heappop(s)
            handle = H.encode(nid, int(is_rev))

            if nid not in visited_nodes:
                visited_nodes.add(nid)
                sorted_out.append(H.forward(nid))

            # Mask all "incoming" edges unconditionally (:1688-1693).
            for ei in in_of(handle):
                mask_edge(ei)

            # Process "outgoing" edges (:1695-1726).
            for ei in out_of(handle):
                if masked[ei]:
                    continue
                mask_edge(ei)
                nxt = next_of(ei, handle)
                if nxt in unvisited:
                    if in_count.get(nxt, 0) == 0:
                        enqueue(nxt)
                    elif nxt not in seeds_set:
                        heapq.heappush(
                            seeds,
                            (rank.get(H.node_id(nxt), max_rank),
                             H.is_reverse(nxt), seeds_seq, nxt),
                        )
                        seeds_seq += 1
                        seeds_set.add(nxt)

    # Post-pass: reverse output if majority-against priority order
    # (:1736-1757); skipped in reverse mode.
    if not reverse_mode and len(sorted_out) > 0 and len(priority_order) > 1:
        in_order = out_of_order = 0
        for prev, curr in zip(sorted_out, sorted_out[1:]):
            pr = rank.get(H.node_id(prev), max_rank)
            cr = rank.get(H.node_id(curr), max_rank)
            if pr < cr:
                in_order += 1
            else:
                out_of_order += 1
        if out_of_order > in_order:
            sorted_out.reverse()

    return sorted_out
