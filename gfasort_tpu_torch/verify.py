"""Verification suite: structural invariants for pipeline outputs.

Rebuild of the reference's legacy verification ideas (gfasort
``src/legacy_graph_ops.rs:691-1143``; SURVEY.md §2 row 27 recommends
porting them as invariant checks) as standalone functions over
:class:`~gfasort_tpu_torch.graph.BidirectedGraph`:

* :func:`verify_path_embedding` — every adjacent path step pair is
  connected by an edge (``:691-708``)
* :func:`reconstruct_path_sequence` — oriented concatenation
  (``:767-802``)
* :func:`verify_edge_traversal` — edges reference live nodes and are
  traversable in both stored directions (``:916-1016``)
* :func:`validate_gfa_format` — textual GFA well-formedness
  (``:1019-1080``)
* :func:`comprehensive_verify` — all of the above plus path-hash
  invariance and graph consistency (``:1083-1142``)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import handle as H
from .graph import BidirectedGraph

__all__ = [
    "verify_path_embedding",
    "reconstruct_path_sequence",
    "verify_edge_traversal",
    "validate_gfa_format",
    "comprehensive_verify",
    "VerifyReport",
]


def verify_path_embedding(graph: BidirectedGraph) -> List[str]:
    """Every adjacent step pair in every path must be joined by an edge
    (direct or complement form).  Returns error strings."""
    errors = []
    for path in graph.paths:
        steps = path.steps.tolist()
        for i, (a, b) in enumerate(zip(steps, steps[1:])):
            if not graph.has_edge(int(a), int(b)):
                errors.append(
                    f"Path {path.name}: steps {i},{i+1} "
                    f"({H.fmt(a)}->{H.fmt(b)}) have no edge"
                )
    return errors


def reconstruct_path_sequence(graph: BidirectedGraph, path_idx: int) -> bytes:
    """Oriented concatenated DNA of a path."""
    return graph.path_sequence(graph.paths[path_idx])


def verify_edge_traversal(graph: BidirectedGraph) -> List[str]:
    """Edges must reference live nodes, and EVERY stored edge must be
    discoverable from both of its endpoint handles.  The reference's
    legacy suite checks all edges (src/legacy_graph_ops.rs:916-1016);
    the AdjacencyIndex makes the full check O(E), so no sampling."""
    from .algos.adjacency import AdjacencyIndex

    errors = []
    n = len(graph.nodes)
    for f, t in sorted(graph.edges):
        for h, side in ((f, "from"), (t, "to")):
            nid = H.node_id(h)
            if nid >= n or graph.nodes[nid] is None:
                errors.append(f"Edge {H.fmt(f)}->{H.fmt(t)}: dead {side} node {nid}")
    # full traversability check through the AdjacencyIndex (the
    # structure the production algorithms traverse), validated against
    # an inline first-principles transcription of the complement
    # matching rules (src/graph_ops.rs:1369-1392) — not against the
    # index's own construction:
    adj = AdjacencyIndex(graph)
    for i, (f, t) in enumerate(adj.edges):
        # membership predicate must accept both stored and complement form
        if not graph.has_edge(f, t):
            errors.append(f"Edge {H.fmt(f)}->{H.fmt(t)} fails has_edge")
        if not graph.has_edge(H.flip(t), H.flip(f)):
            errors.append(
                f"Edge {H.fmt(f)}->{H.fmt(t)} complement fails has_edge"
            )
        # following the edge out of each endpoint handle must land on
        # the right neighbour
        if adj.next_handle(i, f) != t:
            errors.append(f"Edge {H.fmt(f)}->{H.fmt(t)}: next_handle(from) wrong")
        if adj.prev_handle(i, t) != f:
            errors.append(f"Edge {H.fmt(f)}->{H.fmt(t)}: prev_handle(to) wrong")
    # every adjacency entry must satisfy the matching rule it claims,
    # and the totals must equal the count implied by the edge set
    n_out = n_in = 0
    for h, idxs in adj.outgoing.items():
        for i in idxs:
            f, t = adj.edges[i]
            if not (f == h or H.flip(t) == h):
                errors.append(f"outgoing({H.fmt(h)}) lists non-matching edge {H.fmt(f)}->{H.fmt(t)}")
            n_out += 1
    for h, idxs in adj.incoming.items():
        for i in idxs:
            f, t = adj.edges[i]
            if not (t == h or H.flip(f) == h):
                errors.append(f"incoming({H.fmt(h)}) lists non-matching edge {H.fmt(f)}->{H.fmt(t)}")
            n_in += 1
    want_out = sum(1 + (H.flip(t) != f) for f, t in adj.edges)
    want_in = sum(1 + (H.flip(f) != t) for f, t in adj.edges)
    if n_out != want_out:
        errors.append(f"outgoing entry count {n_out} != expected {want_out}")
    if n_in != want_in:
        errors.append(f"incoming entry count {n_in} != expected {want_in}")
    return errors


def validate_gfa_format(text: str) -> List[str]:
    """Textual GFA v1 well-formedness: S lines have id+sequence, L lines
    have 4 fields with +/- orients referencing declared segments, P
    steps reference declared segments."""
    errors = []
    seen = set()
    lines = text.splitlines()
    for ln, line in enumerate(lines, 1):
        if line.startswith("S"):
            f = line.split("\t")
            if len(f) < 3:
                errors.append(f"line {ln}: S line needs id and sequence")
            else:
                seen.add(f[1])
    for ln, line in enumerate(lines, 1):
        if line.startswith("L"):
            f = line.split("\t")
            if len(f) < 5:
                errors.append(f"line {ln}: L line needs 4 fields")
                continue
            if f[2] not in "+-" or f[4] not in "+-":
                errors.append(f"line {ln}: bad orientation")
            for nid in (f[1], f[3]):
                if nid not in seen:
                    errors.append(f"line {ln}: L references undeclared segment {nid}")
        elif line.startswith("P"):
            f = line.split("\t")
            if len(f) < 3:
                errors.append(f"line {ln}: P line needs name and steps")
                continue
            for step in f[2].split(","):
                step = step.strip()
                if not step:
                    continue
                if step[-1] not in "+-":
                    errors.append(f"line {ln}: path step {step!r} missing orientation")
                elif step[:-1] not in seen:
                    errors.append(
                        f"line {ln}: P references undeclared segment {step[:-1]}"
                    )
    return errors


@dataclass
class VerifyReport:
    consistency: List[str] = field(default_factory=list)
    path_embedding: List[str] = field(default_factory=list)
    edge_traversal: List[str] = field(default_factory=list)
    hash_mismatches: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not (
            self.consistency
            or self.path_embedding
            or self.edge_traversal
            or self.hash_mismatches
        )

    def all_errors(self) -> List[str]:
        return (
            self.consistency
            + self.path_embedding
            + self.edge_traversal
            + self.hash_mismatches
        )


def comprehensive_verify(
    graph: BidirectedGraph,
    expected_hashes: Optional[Dict[str, str]] = None,
) -> VerifyReport:
    """Run every structural check; optionally compare path SHA-256
    hashes against a pre-pipeline snapshot (the key invariant: no
    pipeline step may change any path's DNA)."""
    report = VerifyReport()
    report.consistency = graph.validate_graph_consistency()
    report.path_embedding = verify_path_embedding(graph)
    report.edge_traversal = verify_edge_traversal(graph)
    if expected_hashes is not None:
        current = graph.compute_all_path_hashes()
        for name, h in expected_hashes.items():
            got = current.get(name)
            if got != h:
                report.hash_mismatches.append(
                    f"Path {name}: hash {got} != expected {h}"
                )
    return report
