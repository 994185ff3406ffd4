"""Grooming (BFS, the ``g`` step): orient nodes consistently along paths
(gfasort ``src/groom.rs``), as the BFS branch of
``gfasort_tpu_torch/algos/groom.py`` does it: seeds the path-position
sorted heads (else the lowest live node id, forward), neighbours in
``(node_id, is_reverse)`` order (``src/groom.rs:249-250``), the
multi-component restart loop (``:136-174``), a node flipped iff first
reached through its reverse handle.  Restated with the nodes' state in
flat arrays instead of sets.

The output is the current node set in sorted-id order with the chosen
orientation per node (``:176-197``); :func:`apply_grooming_with_reorder`
applies it and renumbers (``:533-605``).
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np

from .adjacency import AdjacencyIndex
from .topo import find_head_nodes

__all__ = ["RC_TABLE", "groom", "apply_grooming_with_reorder",
           "reverse_complement"]

# Reverse-complement lookup covering the bases the reference maps
# (A/T/C/G case-insensitive -> complement uppercase, N/n -> N, everything
# else passes through unchanged; reference: src/graph.rs:72-85).
RC_TABLE = np.arange(256, dtype=np.uint8)
for _src, _dst in [
    (b"A", b"T"), (b"a", b"T"),
    (b"T", b"A"), (b"t", b"A"),
    (b"C", b"G"), (b"c", b"G"),
    (b"G", b"C"), (b"g", b"C"),
    (b"N", b"N"), (b"n", b"N"),
]:
    RC_TABLE[_src[0]] = _dst[0]


def reverse_complement(seq: bytes) -> bytes:
    """Reverse complement of a DNA byte string (reference: src/graph.rs:72-85)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return RC_TABLE[arr[::-1]].tobytes()


def groom(graph) -> List[int]:
    """Groomed handle order, BFS mode (src/groom.rs:49-198): the live
    nodes in sorted-id order, each with its chosen orientation."""
    adj = AdjacencyIndex(graph)
    live = np.flatnonzero(graph.node_len_array() >= 0)
    seeds = find_head_nodes(graph)
    if not seeds and len(live):
        seeds = [int(live[0]) << 1]
    top = max(int(live.max()) if len(live) else 0, adj.n_handles // 2)
    visited = bytearray(top + 1)
    flipped = bytearray(top + 1)
    n_visited = 0
    live_l = live.tolist()
    scan = 0
    current = seeds
    # the reference compares the visited count with the node count; the
    # fresh-seed scan resumes from a cursor (`live` is sorted and the
    # visited set only grows), the same seeds as its rescan (:150-158)
    while n_visited < len(live_l) or current:
        if not current:
            while scan < len(live_l) and visited[live_l[scan]]:
                scan += 1
            if scan == len(live_l):
                break
            current = [live_l[scan] << 1]
        queue = deque()
        for seed in current:
            nid = seed >> 1
            if not visited[nid]:
                queue.append(seed)
                visited[nid] = 1
                n_visited += 1
                flipped[nid] = seed & 1
        while queue:
            h = queue.popleft()
            nxt = sorted(adj.next_handle(ei, h) for ei in adj.out_edges(h))
            for n in nxt:
                nid = n >> 1
                if not visited[nid]:
                    visited[nid] = 1
                    n_visited += 1
                    flipped[nid] = n & 1
                    queue.append(n)
        current = []
    flip = np.frombuffer(bytes(flipped), dtype=np.uint8)[live]
    return ((live << 1) | flip).tolist()


def apply_grooming_with_reorder(graph, groomed_handles: List[int]) -> None:
    """Apply orientation flips and renumber (src/groom.rs:533-605):
    reverse-complement flipped node sequences, XOR orientations on
    touching edges and path steps, then renumber nodes 1..N by the
    groomed handle order."""
    handles_arr = np.asarray(groomed_handles, dtype=np.int64)
    flip_ids = handles_arr[(handles_arr & 1) == 1] >> 1
    flips = set(flip_ids.tolist())

    for nid in flips:
        if nid < len(graph.nodes) and graph.nodes[nid] is not None:
            graph.nodes[nid] = reverse_complement(graph.nodes[nid])
    # the orientation bit of every handle of a flipped node, XORed
    mask = np.zeros(len(graph.nodes) + 1, dtype=np.int64)
    mask[flip_ids[flip_ids < len(mask)]] = 1
    graph.edges = graph.edges.flipped(mask)

    if flips:
        flip_arr = np.zeros(len(graph.nodes) + 1, dtype=np.int64)
        flip_arr[list(flips)] = 1
        for path in graph.paths:
            if len(path):
                path.steps = path.steps ^ flip_arr[path.steps >> 1]

    graph.apply_node_id_mapping(
        handles_arr >> 1, np.arange(1, len(handles_arr) + 1, dtype=np.int64))
