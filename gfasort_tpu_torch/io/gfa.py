"""GFA v1 parsing and writing.

The reference ships two parsers with different id semantics and both are
reproduced here because pipeline parity depends on the choice
(SURVEY.md §8.3):

* :func:`parse_gfa_numeric` — the CLI parser: segment names are parsed
  as integers and kept verbatim (gfasort ``src/bin/gfasort.rs:88-167``).
  This is the behavior to match for pipeline parity.
* :func:`load_gfa` — the library parser: segment *names* map to fresh
  sequential ids from 1 in file order (``src/gfa_parser.rs:45-49``).

Writers:

* :func:`write_gfa` — CLI-style output (``src/graph_ops.rs:693-738``):
  H line, S lines in id order, L lines, P lines with a ``*`` overlap
  column.  Unlike the reference (which iterates a randomized HashSet,
  ``src/graph_ops.rs:711-720``) L lines are emitted in sorted order so
  output is deterministic; SURVEY.md §8.2 requires canonicalizing
  L-line order for byte comparisons anyway.
* :func:`write_gfa_library` — library-style output with per-step ``0M``
  overlaps and sorted L lines (``src/gfa_parser.rs:136-184``).
"""

from __future__ import annotations

import io as _io
from typing import Dict, Union

import numpy as np

from .. import handle as H
from ..graph import BiPath, BidirectedGraph

__all__ = [
    "parse_gfa_numeric",
    "parse_gfa_named",
    "load_gfa",
    "write_gfa",
    "write_gfa_library",
    "canonical_gfa",
]


def _parse_lines(text: str):
    for line in text.splitlines():
        line = line.strip("\n")
        if not line:
            continue
        yield line.split("\t")


def parse_gfa_numeric(text: str) -> BidirectedGraph:
    """Parse GFA with numeric segment ids kept verbatim
    (src/bin/gfasort.rs:88-167).  Three passes in S, L, P order so
    ``node_order`` matches the reference exactly."""
    g = BidirectedGraph()
    rows = [f for f in _parse_lines(text)]
    for f in rows:
        if f[0] == "S" and len(f) >= 3:
            g.add_node(int(f[1]), f[2].encode())
    for f in rows:
        if f[0] == "L" and len(f) >= 5:
            from_h = H.encode(int(f[1]), int(f[2] != "+"))
            to_h = H.encode(int(f[3]), int(f[4] != "+"))
            g.add_edge(from_h, to_h)
    for f in rows:
        if f[0] == "P" and len(f) >= 3:
            path = BiPath(f[1])
            steps = []
            for step in f[2].split(","):
                step = step.strip()
                if not step:
                    continue
                orient = step[-1]
                # any non-'+' final char is reverse (src/bin/gfasort.rs:149)
                steps.append(H.encode(int(step[:-1]), int(orient != "+")))
            path.steps = np.asarray(steps, dtype=np.int64)
            g.paths.append(path)
    return g


def parse_gfa_named(text: str) -> BidirectedGraph:
    """Parse GFA mapping segment names to sequential ids from 1 in file
    order (src/gfa_parser.rs:9-134).  Steps with unknown names or
    missing orientation are skipped, paths with no steps are dropped,
    exactly like the reference."""
    g = BidirectedGraph()
    name_to_id: Dict[str, int] = {}
    next_id = 1
    pending_links = []
    pending_paths = []
    for f in _parse_lines(text):
        tag = f[0]
        if tag == "S" and len(f) >= 3:
            name = f[1]
            if name not in name_to_id:
                name_to_id[name] = next_id
                next_id += 1
            g.add_node(name_to_id[name], f[2].encode())
        elif tag == "L" and len(f) >= 5:
            pending_links.append((f[1], f[2], f[3], f[4]))
        elif tag == "P" and len(f) >= 3:
            pending_paths.append((f[1], f[2]))
    for fn, fo, tn, to in pending_links:
        if fn not in name_to_id or tn not in name_to_id:
            raise ValueError(f"Unknown node in link: {fn if fn not in name_to_id else tn}")
        g.add_edge(
            H.encode(name_to_id[fn], int(fo != "+")),
            H.encode(name_to_id[tn], int(to != "+")),
        )
    for name, node_list in pending_paths:
        steps = []
        for step in node_list.split(","):
            step = step.strip()
            if not step:
                continue
            if step.endswith("+"):
                nm, rev = step[:-1], 0
            elif step.endswith("-"):
                nm, rev = step[:-1], 1
            else:
                continue
            if nm in name_to_id:
                steps.append(H.encode(name_to_id[nm], rev))
        if steps:
            g.paths.append(BiPath(name, steps))
    return g


def load_gfa(path) -> BidirectedGraph:
    """Load a GFA file with library (name-mapping) semantics."""
    with open(path) as fh:
        return parse_gfa_named(fh.read())


def _fmt_steps(path: BiPath) -> str:
    return ",".join(H.fmt(int(h)) for h in path.steps)


def _native_writer(graph: BidirectedGraph, sort_edges: bool, overlaps):
    """Shared native fast path: returns the full GFA text or None.
    ``overlaps(path)`` gives the P-line overlap column."""
    if len(graph.nodes) + len(graph.edges) < 4096:
        return None
    from ..native.build import load_py

    pylib = load_py()
    if pylib is None:
        return None
    import ctypes

    import numpy as np

    p64 = ctypes.POINTER(ctypes.c_int64)
    parts = [b"H\tVN:Z:1.0\n", pylib.format_s_lines(graph.nodes)]
    ef, et = graph.edges_to_arrays()
    if sort_edges:
        # lexicographic (from, to) == sorted(set of tuples)
        order = np.lexsort((et, ef))
        ef, et = np.ascontiguousarray(ef[order]), np.ascontiguousarray(et[order])
    parts.append(
        pylib.format_l_lines(
            len(ef), ef.ctypes.data_as(p64), et.ctypes.data_as(p64), 1
        )
    )
    for path in graph.paths:
        steps = np.ascontiguousarray(path.steps, dtype=np.int64)
        step_str = pylib.format_steps(len(steps), steps.ctypes.data_as(p64))
        parts.append(
            b"P\t" + path.name.encode() + b"\t" + step_str
            + b"\t" + overlaps(path).encode() + b"\n"
        )
    return b"".join(parts).decode()


def write_gfa(graph: BidirectedGraph, sort_edges: bool = True) -> str:
    """CLI-style GFA text (src/graph_ops.rs:693-738), with L lines sorted
    for determinism (set ``sort_edges=False`` for insertion-arbitrary
    order)."""
    native = _native_writer(graph, sort_edges, lambda p: "*")
    if native is not None:
        return native
    out = _io.StringIO()
    out.write("H\tVN:Z:1.0\n")
    for nid, seq in enumerate(graph.nodes):
        if seq is not None:
            out.write(f"S\t{nid}\t{seq.decode()}\n")
    edges = sorted(graph.edges) if sort_edges else list(graph.edges)
    for f, t in edges:
        out.write(
            f"L\t{H.node_id(f)}\t{H.orientation_char(f)}"
            f"\t{H.node_id(t)}\t{H.orientation_char(t)}\t0M\n"
        )
    for path in graph.paths:
        out.write(f"P\t{path.name}\t{_fmt_steps(path)}\t*\n")
    return out.getvalue()


def write_gfa_library(graph: BidirectedGraph) -> str:
    """Library-style GFA text with per-step 0M overlaps and sorted L
    lines (src/gfa_parser.rs:136-184)."""
    native = _native_writer(
        graph, True, lambda p: ",".join(["0M"] * max(len(p) - 1, 0))
    )
    if native is not None:
        return native
    out = _io.StringIO()
    out.write("H\tVN:Z:1.0\n")
    for nid, seq in enumerate(graph.nodes):
        if seq is not None:
            out.write(f"S\t{nid}\t{seq.decode()}\n")
    for f, t in sorted(graph.edges):
        out.write(
            f"L\t{H.node_id(f)}\t{H.orientation_char(f)}"
            f"\t{H.node_id(t)}\t{H.orientation_char(t)}\t0M\n"
        )
    for path in graph.paths:
        overlaps = ",".join(["0M"] * max(len(path) - 1, 0))
        out.write(f"P\t{path.name}\t{_fmt_steps(path)}\t{overlaps}\n")
    return out.getvalue()


def canonical_gfa(text_or_graph: Union[str, BidirectedGraph]) -> str:
    """Canonical form for byte comparison: S lines in id order, L lines
    sorted with each link in its canonical (smaller-handle-first) form,
    P lines in order, overlap columns dropped.  Required because the
    reference's own L-line order is HashSet-iteration-dependent
    (SURVEY.md §8.2, src/graph_ops.rs:711-720)."""
    if isinstance(text_or_graph, BidirectedGraph):
        graph = text_or_graph
    else:
        graph = parse_gfa_numeric(text_or_graph)
    lines = ["H\tVN:Z:1.0"]
    for nid, seq in enumerate(graph.nodes):
        if seq is not None:
            lines.append(f"S\t{nid}\t{seq.decode()}")
    links = []
    for f, t in graph.edges:
        # canonical form: smaller handle first (src/graph.rs:189-198)
        if f > t:
            f, t = H.flip(t), H.flip(f)
        links.append((f, t))
    for f, t in sorted(set(links)):
        lines.append(
            f"L\t{H.node_id(f)}\t{H.orientation_char(f)}"
            f"\t{H.node_id(t)}\t{H.orientation_char(t)}"
        )
    for path in graph.paths:
        lines.append(f"P\t{path.name}\t{_fmt_steps(path)}")
    return "\n".join(lines) + "\n"
