"""Legacy orientation-less graph compatibility layer.

Rebuild of the reference's legacy ``Graph`` surface (gfasort
``src/legacy_graph_ops.rs`` + ``src/compaction.rs``; SURVEY.md §2 rows
27-28).  The reference keeps this layer only for back-compat — it is
unreachable from the CLI pipeline — but its API (orientation-less graph,
converters, simple topo sort, Tarjan SCC, union-find compaction) is part
of the library surface, so an equivalent is provided.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from . import handle as H
from .graph import BiPath, BidirectedGraph

__all__ = ["SimpleGraph", "tarjan_scc", "union_find_components", "compact_simple"]


@dataclass
class SimpleGraph:
    """Orientation-less graph: nodes by id, directed edges, paths as
    node-id lists (legacy Graph, src/legacy_graph_ops.rs)."""

    nodes: Dict[int, bytes] = field(default_factory=dict)
    edges: Set[Tuple[int, int]] = field(default_factory=set)
    paths: List[Tuple[str, List[int]]] = field(default_factory=list)

    # -- converters (src/graph_ops.rs:540-610) -------------------------
    @classmethod
    def from_bidirected(cls, g: BidirectedGraph) -> "SimpleGraph":
        """Keep only forward-to-forward edges, drop orientations."""
        sg = cls()
        for nid, seq in enumerate(g.nodes):
            if seq is not None:
                sg.nodes[nid] = seq
        for f, t in g.edges:
            if not H.is_reverse(f) and not H.is_reverse(t):
                sg.edges.add((H.node_id(f), H.node_id(t)))
        for path in g.paths:
            sg.paths.append((path.name, [int(h) >> 1 for h in path.steps]))
        return sg

    def to_bidirected(self) -> BidirectedGraph:
        """All nodes forward; paths become forward-step paths."""
        g = BidirectedGraph()
        for nid, seq in sorted(self.nodes.items()):
            g.add_node(nid, seq)
        for a, b in self.edges:
            g.add_edge(H.forward(a), H.forward(b))
        for name, ids in self.paths:
            g.paths.append(BiPath(name, [H.forward(i) for i in ids]))
        return g

    # -- simple topological sort (legacy variant) ----------------------
    def topological_sort(self) -> List[int]:
        """Kahn's algorithm with lowest-id tie-breaking; cycles broken
        at the minimum-id remaining node."""
        import heapq

        indeg: Dict[int, int] = {n: 0 for n in self.nodes}
        succ: Dict[int, List[int]] = {n: [] for n in self.nodes}
        for a, b in self.edges:
            if a in indeg and b in indeg:
                succ[a].append(b)
                indeg[b] += 1
        ready = [n for n, d in indeg.items() if d == 0]
        heapq.heapify(ready)
        remaining = set(self.nodes)
        out: List[int] = []
        while remaining:
            if not ready:
                seed = min(remaining)
                indeg[seed] = 0
                heapq.heappush(ready, seed)
            n = heapq.heappop(ready)
            if n not in remaining:
                continue
            remaining.discard(n)
            out.append(n)
            for m in sorted(succ.get(n, ())):
                if m in remaining:
                    indeg[m] -= 1
                    if indeg[m] <= 0:
                        heapq.heappush(ready, m)
        return out


def tarjan_scc(graph: SimpleGraph) -> List[List[int]]:
    """Tarjan strongly-connected components (iterative;
    src/legacy_graph_ops.rs:349-430)."""
    succ: Dict[int, List[int]] = {n: [] for n in graph.nodes}
    for a, b in graph.edges:
        if a in succ and b in succ:
            succ[a].append(b)
    index: Dict[int, int] = {}
    lowlink: Dict[int, int] = {}
    on_stack: Set[int] = set()
    stack: List[int] = []
    sccs: List[List[int]] = []
    counter = [0]

    for root in sorted(graph.nodes):
        if root in index:
            continue
        work = [(root, iter(sorted(succ[root])))]
        index[root] = lowlink[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = lowlink[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(succ[w]))))
                    advanced = True
                    break
                elif w in on_stack:
                    lowlink[v] = min(lowlink[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                lowlink[pv] = min(lowlink[pv], lowlink[v])
            if lowlink[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(sorted(comp))
    return sccs


def _are_perfect_neighbors(graph: SimpleGraph, left: int, right: int) -> bool:
    """ODGI perfect-neighbor test on the legacy graph
    (src/compaction.rs:21-64): every path visit to ``left`` must
    continue to ``right`` (a path may not end at ``left``), and the
    number of visits to ``right`` must equal those transitions."""
    left_visits = 0
    left_to_right = 0
    for _name, path in graph.paths:
        for i, node in enumerate(path):
            if node == left:
                left_visits += 1
                if i + 1 < len(path):
                    if path[i + 1] == right:
                        left_to_right += 1
                    else:
                        return False
                else:
                    return False
    right_visits = sum(
        1 for _name, path in graph.paths for node in path if node == right
    )
    return (
        left_visits > 0
        and left_to_right == left_visits
        and left_to_right == right_visits
    )


def find_simple_components_legacy(graph: SimpleGraph) -> List[List[int]]:
    """Legacy simple components (src/compaction.rs:7-255): union
    degree-(1,1) edge pairs that pass the perfect-neighbor test, then
    order each component by following edges from a chain head; if no
    complete linear order exists, fall back to sorted-id order (the
    reference compacts such components anyway, :229-243)."""
    forward: Dict[int, List[int]] = {}
    backward: Dict[int, List[int]] = {}
    for a, b in sorted(graph.edges):
        forward.setdefault(a, []).append(b)
        backward.setdefault(b, []).append(a)

    parent: Dict[int, int] = {n: n for n in graph.nodes}

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for node_id in sorted(graph.nodes):
        nexts = forward.get(node_id, [])
        if len(nexts) == 1:
            nxt = nexts[0]
            if node_id != nxt and len(backward.get(nxt, [])) == 1:
                if _are_perfect_neighbors(graph, node_id, nxt):
                    ra, rb = find(node_id), find(nxt)
                    if ra != rb:
                        parent[ra] = rb

    comp_map: Dict[int, List[int]] = {}
    for node_id in sorted(graph.nodes):
        comp_map.setdefault(find(node_id), []).append(node_id)

    components: List[List[int]] = []
    for _root, comp in sorted(comp_map.items()):
        if len(comp) < 2:
            continue
        # find a chain head: no in-edge, or single in-edge from outside
        start = None
        for node in comp:
            prevs = backward.get(node, [])
            if not prevs or (len(prevs) == 1 and prevs[0] not in comp):
                start = node
                break
        ordered = None
        if start is not None:
            chain = [start]
            seen = {start}
            cur = start
            while len(chain) < len(comp):
                found = False
                for nxt in forward.get(cur, []):
                    if nxt in comp and nxt not in seen:
                        in_from_comp = sum(
                            1 for p in backward.get(nxt, []) if p in comp
                        )
                        if in_from_comp == 1:
                            chain.append(nxt)
                            seen.add(nxt)
                            cur = nxt
                            found = True
                            break
                if not found:
                    break
            if len(chain) == len(comp):
                ordered = chain
        components.append(ordered if ordered is not None else sorted(comp))
    return components


def compact_simple(graph: SimpleGraph) -> int:
    """ODGI-style compaction on the legacy graph
    (src/compaction.rs:258-425), independent of the bidirected
    compactor: merge each simple component into its first node's id
    (concatenated sequence), rewrite paths by replacing exact
    consecutive runs of the full component (partial runs are kept
    as-is, :341-356), remap edges to the merged id and drop internal
    consecutive-pair edges (:362-394).  Returns the number of nodes
    eliminated.  Like the reference, path-sequence preservation is
    validated afterwards (warning only, :400-422)."""
    import sys

    original_seqs = {
        name: b"".join(graph.nodes.get(n, b"") for n in path)
        for name, path in graph.paths
    }

    components = find_simple_components_legacy(graph)
    compacted = 0
    for component in components:
        if len(component) < 2:
            continue
        new_id = component[0]
        graph.nodes[new_id] = b"".join(
            graph.nodes.get(n, b"") for n in component
        )
        for node_id in component[1:]:
            graph.nodes.pop(node_id, None)

        comp_len = len(component)
        new_paths = []
        for name, path in graph.paths:
            new_path: List[int] = []
            i = 0
            while i < len(path):
                if path[i] == new_id and i + comp_len <= len(path) and all(
                    path[i + j] == component[j] for j in range(comp_len)
                ):
                    new_path.append(new_id)
                    i += comp_len
                else:
                    new_path.append(path[i])
                    i += 1
            new_paths.append((name, new_path))
        graph.paths = new_paths

        comp_set = set(component)
        internal = {
            (component[i], component[i + 1]) for i in range(comp_len - 1)
        }
        new_edges: Set[Tuple[int, int]] = set()
        for f, t in graph.edges:
            nf = new_id if f in comp_set else f
            nt = new_id if t in comp_set else t
            if nf == new_id and nt == new_id and (f, t) in internal:
                continue
            new_edges.add((nf, nt))
        graph.edges = new_edges
        compacted += comp_len - 1

    for name, path in graph.paths:
        rec = b"".join(graph.nodes.get(n, b"") for n in path)
        if rec != original_seqs.get(name, rec):
            print(
                f"WARNING: Path {name} sequence changed during compaction!",
                file=sys.stderr,
            )
    return compacted


def union_find_components(graph: SimpleGraph) -> List[List[int]]:
    """Union-find linear-chain components for legacy compaction
    (src/compaction.rs:66-124): nodes joined when connected by an edge
    that is the unique out-edge of its source and unique in-edge of its
    target."""
    outdeg: Dict[int, int] = {}
    indeg: Dict[int, int] = {}
    for a, b in graph.edges:
        outdeg[a] = outdeg.get(a, 0) + 1
        indeg[b] = indeg.get(b, 0) + 1

    parent: Dict[int, int] = {n: n for n in graph.nodes}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in sorted(graph.edges):
        if outdeg.get(a) == 1 and indeg.get(b) == 1 and a in parent and b in parent:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

    comps: Dict[int, List[int]] = {}
    for n in graph.nodes:
        comps.setdefault(find(n), []).append(n)
    return [sorted(v) for _, v in sorted(comps.items()) if len(v) >= 1]
