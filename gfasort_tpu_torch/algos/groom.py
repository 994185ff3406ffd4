"""Grooming: orient nodes consistently along paths.

Reproduces the reference grooming (gfasort ``src/groom.rs``): BFS
("ODGI greedy") default, plain DFS, and coverage-weighted DFS modes,
with the same seed selection (path-position-sorted heads, fallback to
the lowest live node id forward), the same deterministic neighbor order
(sorted by ``(node_id, is_reverse)``, ``src/groom.rs:249-250``), and the
same multi-component restart loop (``:136-174``).

The output is the current node set in sorted-id order with the chosen
orientation per node (``:176-197``); orientation is applied (and the
graph optionally renumbered) by :func:`apply_grooming_with_reorder`
(``:533-605``).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Set, Tuple

from .. import handle as H
from .adjacency import AdjacencyIndex
from .topo import find_head_nodes

__all__ = [
    "groom",
    "groom_with_mode",
    "apply_grooming_with_reorder",
    "analyze_orientation_preferences",
    "count_edge_coverage",
    "groom_and_sort",
    "sort_groom_sort",
    "iterative_groom",
]


def analyze_orientation_preferences(graph) -> Dict[int, Tuple[int, int]]:
    """node_id -> (forward_count, reverse_count) over all path steps
    (src/groom.rs:12-27)."""
    prefs: Dict[int, Tuple[int, int]] = {}
    for path in graph.paths:
        for h in path.steps.tolist():
            nid, rev = h >> 1, h & 1
            f, r = prefs.get(nid, (0, 0))
            prefs[nid] = (f + (1 - rev), r + rev)
    return prefs


def count_edge_coverage(graph) -> Dict[Tuple[int, int], int]:
    """(from_handle, to_handle) -> number of path adjacencies
    (src/groom.rs:31-43)."""
    cov: Dict[Tuple[int, int], int] = {}
    for path in graph.paths:
        steps = path.steps.tolist()
        for a, b in zip(steps, steps[1:]):
            cov[(a, b)] = cov.get((a, b), 0) + 1
    return cov


def _successors(adj: AdjacencyIndex, current: int) -> List[int]:
    """Handles reachable from ``current`` over direct + complement edge
    forms, sorted by (node_id, is_reverse) (src/groom.rs:233-250)."""
    nxt = [adj.next_handle(ei, current) for ei in adj.out_edges(current)]
    nxt.sort()  # handle order == (node_id, is_reverse)
    return nxt


def _bfs(adj: AdjacencyIndex, seeds: List[int], visited: Set[int], flipped: Set[int]) -> None:
    """ODGI greedy BFS: flip a node iff first reached via its reverse
    handle (src/groom.rs:202-275)."""
    queue = deque()
    for seed in seeds:
        nid = H.node_id(seed)
        if nid not in visited:
            queue.append(seed)
            visited.add(nid)
            if H.is_reverse(seed):
                flipped.add(nid)
    while queue:
        current = queue.popleft()
        for nxt in _successors(adj, current):
            nid = H.node_id(nxt)
            if nid not in visited:
                visited.add(nid)
                if H.is_reverse(nxt):
                    flipped.add(nid)
                queue.append(nxt)


def _dfs(adj: AdjacencyIndex, seeds: List[int], visited: Set[int], flipped: Set[int]) -> None:
    """Plain DFS variant (src/groom.rs:279-332).  Successors are pushed
    in sorted order, so the stack pops the highest-sorted first, exactly
    like the reference."""
    stack = list(seeds)
    while stack:
        current = stack.pop()
        nid = H.node_id(current)
        if nid in visited:
            continue
        visited.add(nid)
        if H.is_reverse(current):
            flipped.add(nid)
        for nxt in _successors(adj, current):
            if H.node_id(nxt) not in visited:
                stack.append(nxt)


def _coverage_dfs(
    adj: AdjacencyIndex,
    seeds: List[int],
    visited: Set[int],
    flipped: Set[int],
    coverage: Dict[Tuple[int, int], int],
) -> None:
    """Coverage-weighted DFS: follow high-path-coverage edges first
    (src/groom.rs:337-408)."""
    stack = list(seeds)
    while stack:
        current = stack.pop()
        nid = H.node_id(current)
        if nid in visited:
            continue
        visited.add(nid)
        if H.is_reverse(current):
            flipped.add(nid)
        outgoing = []
        for ei in adj.out_edges(current):
            f, t = adj.edges[ei]
            if f == current:
                nxt = t
                cov = coverage.get((f, t), 0)
            else:
                nxt = H.flip(f)
                # complement form: look up (current, next) (:383)
                cov = coverage.get((current, nxt), 0)
            outgoing.append((nxt, cov))
        # sort by coverage desc then (node_id, is_reverse) (:389)
        outgoing.sort(key=lambda x: (-x[1], H.node_id(x[0]), H.is_reverse(x[0])))
        # push in reverse so highest coverage pops first (:402)
        for nxt, _cov in reversed(outgoing):
            if H.node_id(nxt) not in visited:
                stack.append(nxt)


def groom_with_mode(
    graph,
    use_bfs: bool = True,
    use_coverage_dfs: bool = False,
) -> List[int]:
    """Compute groomed handle order (src/groom.rs:56-198).  Returns the
    live nodes in sorted-id order, each with its chosen orientation."""
    if not use_coverage_dfs and len(graph.edges) >= 2048:
        from .native_dispatch import native_groom

        out = native_groom(graph, use_bfs)
        if out is not None:
            return out

    adj = AdjacencyIndex(graph)
    coverage = count_edge_coverage(graph) if use_coverage_dfs else {}

    seeds = find_head_nodes(graph)
    visited: Set[int] = set()
    flipped: Set[int] = set()

    live = graph.live_node_ids()
    if not seeds:
        # lowest live node id, forward (src/groom.rs:118-132)
        seeds = [H.forward(min(live))] if live else []
    current_seeds = seeds

    # Multi-component loop.  The reference compares against the raw node
    # Vec length (including None slots); structurally this is "repeat
    # until no unvisited live node remains" (:136-174).  The fresh-seed
    # scan resumes from a persistent cursor: `live` is sorted and
    # `visited` only grows, so the first unvisited id is monotone — same
    # seed sequence as the reference's from-scratch rescan (:150-158)
    # without the quadratic component blowup.
    live_set = set(live)
    scan = 0
    while len(visited) < len(live_set) or current_seeds:
        if not current_seeds:
            while scan < len(live) and live[scan] in visited:
                scan += 1
            if scan == len(live):
                break
            current_seeds = [H.forward(live[scan])]
        if use_coverage_dfs:
            _coverage_dfs(adj, current_seeds, visited, flipped, coverage)
        elif use_bfs:
            _bfs(adj, current_seeds, visited, flipped)
        else:
            _dfs(adj, current_seeds, visited, flipped)
        current_seeds = []

    # Output in sorted-id order with chosen orientation (:176-197).
    return [
        H.reverse(nid) if nid in flipped else H.forward(nid)
        for nid in sorted(live_set)
    ]


def groom(graph, use_bfs: bool = True) -> List[int]:
    """Default grooming = BFS (src/groom.rs:49-51)."""
    return groom_with_mode(graph, use_bfs=use_bfs, use_coverage_dfs=False)


def apply_grooming_with_reorder(graph, groomed_handles: List[int], reorder: bool) -> None:
    """Apply orientation flips and optional renumbering
    (src/groom.rs:533-605): reverse-complement flipped node sequences,
    XOR orientations on touching edges and path steps; if ``reorder``,
    renumber nodes 1..N by the groomed handle order."""
    import numpy as np

    from ..graph import EdgeSet

    handles_arr = np.asarray(groomed_handles, dtype=np.int64)
    flip_ids = handles_arr[(handles_arr & 1) == 1] >> 1
    flips = set(flip_ids.tolist())

    native_done = False
    if len(flips) + len(graph.edges) >= 4096:
        from ..native.build import load_py

        pylib = load_py()
        if pylib is not None:
            import ctypes

            pylib.rc_nodes_inplace(
                graph.nodes,
                np.ascontiguousarray(flip_ids).ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int64)
                ),
                len(flip_ids),
            )
            # vectorized handle-flip through the EdgeSet array mode
            # (r5; the C set-to-set pass still churned ~50M PyObjects
            # at genome scale)
            mask = np.zeros(len(graph.nodes) + 1, dtype=np.int64)
            mask[flip_ids[flip_ids < len(mask)]] = 1
            es = (graph.edges if isinstance(graph.edges, EdgeSet)
                  else EdgeSet(graph.edges))
            graph.edges = es.flipped(mask)
            native_done = True
    if not native_done:
        for nid in flips:
            if nid < len(graph.nodes) and graph.nodes[nid] is not None:
                graph.nodes[nid] = H.reverse_complement(graph.nodes[nid])

        new_edges = set()
        for f, t in graph.edges:
            nf = H.flip(f) if H.node_id(f) in flips else f
            nt = H.flip(t) if H.node_id(t) in flips else t
            new_edges.add((nf, nt))
        graph.edges = new_edges

    if flips:
        flip_arr = np.zeros(len(graph.nodes) + 1, dtype=np.int64)
        flip_arr[list(flips)] = 1
        for path in graph.paths:
            if len(path):
                path.steps = path.steps ^ flip_arr[path.steps >> 1]

    if reorder:
        # arrays straight through — the 4M-entry dict comp cost
        # seconds at genome scale (r5)
        graph._apply_node_id_mapping_arrays(
            handles_arr >> 1,
            np.arange(1, len(handles_arr) + 1, dtype=np.int64),
        )


# ---------------------------------------------------------------------
# Extra orchestrations (src/groom.rs:411-525; not reachable from the
# reference CLI but part of the library surface).
# ---------------------------------------------------------------------
def groom_and_sort(graph) -> None:
    """Groom (BFS) then exact-ODGI topo sort (src/groom.rs:411-431)."""
    from .topo import exact_odgi_topological_order

    order = groom(graph, True)
    apply_grooming_with_reorder(graph, order, reorder=False)
    graph.apply_ordering(exact_odgi_topological_order(graph, True, False))


def sort_groom_sort(graph) -> None:
    """Sort, coverage-weighted groom, sort again (src/groom.rs:434-461)."""
    from .topo import exact_odgi_topological_order

    graph.apply_ordering(exact_odgi_topological_order(graph, True, False))
    order = groom_with_mode(graph, use_bfs=False, use_coverage_dfs=True)
    apply_grooming_with_reorder(graph, order, reorder=False)
    graph.apply_ordering(exact_odgi_topological_order(graph, True, False))


def iterative_groom(graph, max_iterations: int) -> int:
    """Sort+groom+sort until the flip count stabilizes
    (src/groom.rs:464-525).  Returns the number of iterations run."""
    from .topo import exact_odgi_topological_order

    iteration = 0
    prev_flipped = None
    while iteration < max_iterations:
        iteration += 1
        graph.apply_ordering(exact_odgi_topological_order(graph, True, False))
        order = groom(graph, True)
        flipped_count = sum(1 for h in order if H.is_reverse(h))
        apply_grooming_with_reorder(graph, order, reorder=False)
        graph.apply_ordering(exact_odgi_topological_order(graph, True, False))
        if flipped_count == prev_flipped or flipped_count == 0:
            break
        prev_flipped = flipped_count
    return iteration
