"""Local topological refinement (unused by the reference CLI but part of
its library surface; gfasort ``src/graph_ops.rs:1766-1929``).

Bubble-sort-style local swaps that fix short backward edges
(id-order distance ≤ ``max_distance``) without increasing the total
backward-edge count; up to 10 passes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .. import handle as H

__all__ = ["local_topological_refinement", "count_edge_directions_for_order"]


def count_edge_directions_for_order(graph, order: Sequence[int]):
    """(forward, backward) edge counts for a node order
    (src/graph_ops.rs:1909-1929)."""
    pos = {nid: i for i, nid in enumerate(order)}
    fwd = bwd = 0
    for f, t in graph.edges:
        fp = pos.get(H.node_id(f))
        tp = pos.get(H.node_id(t))
        if fp is None or tp is None:
            continue
        if fp < tp:
            fwd += 1
        elif fp > tp:
            bwd += 1
    return fwd, bwd


def local_topological_refinement(
    graph, initial_order: Sequence[int], max_distance: int
) -> List[int]:
    if not initial_order:
        return []

    pos: Dict[int, int] = {nid: i for i, nid in enumerate(initial_order)}
    order = list(initial_order)

    adjacency: Dict[int, List[int]] = {}
    rev_adjacency: Dict[int, List[int]] = {}
    for f, t in graph.edges:
        adjacency.setdefault(H.node_id(f), []).append(H.node_id(t))
        rev_adjacency.setdefault(H.node_id(t), []).append(H.node_id(f))

    def count_backward(nid: int, npos: int) -> int:
        c = 0
        for t in adjacency.get(nid, ()):  # outgoing backward
            tp = pos.get(t)
            if tp is not None and tp < npos:
                c += 1
        for s in rev_adjacency.get(nid, ()):  # incoming backward
            sp = pos.get(s)
            if sp is not None and sp > npos:
                c += 1
        return c

    for _pass in range(10):  # max_passes (rs:1827)
        swaps = 0
        backward_edges = []
        for f, t in graph.edges:
            fid, tid = H.node_id(f), H.node_id(t)
            fp, tp = pos.get(fid), pos.get(tid)
            if fp is not None and tp is not None and fp > tp and fp - tp <= max_distance:
                backward_edges.append((fid, tid))
        backward_edges.sort(key=lambda e: pos[e[0]] - pos[e[1]])

        for fid, tid in backward_edges:
            from_pos, to_pos = pos[fid], pos[tid]
            if from_pos <= to_pos:
                continue
            current = from_pos
            while current > to_pos:
                swap_pos = current - 1
                other = order[swap_pos]
                before = count_backward(fid, current) + count_backward(other, swap_pos)
                after = count_backward(fid, swap_pos) + count_backward(other, current)
                if after <= before:
                    order[current], order[swap_pos] = order[swap_pos], order[current]
                    pos[fid], pos[other] = swap_pos, current
                    current = swap_pos
                    swaps += 1
                else:
                    break
        if swaps == 0:
            break

    return [H.forward(nid) for nid in order]
