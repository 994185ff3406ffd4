"""GFA v1 parsing and writing of the plain reference: the CLI parser
(numeric segment ids kept verbatim, ``src/bin/gfasort.rs:88-167``) and the
CLI writer (H, S lines in id order, L lines sorted, P lines with a ``*``
overlap column, ``src/graph_ops.rs:693-738``), with the semantics of
``gfasort_tpu_torch/io/gfa.py::parse_gfa_numeric`` and ``write_gfa``, for
tab-separated lines that end in a newline and steps written as the
generator writes them (the generator's files).
"""

from __future__ import annotations

import re

import numpy as np

from ..graph import BiPath, BidirectedGraph, EdgeSet
from ...gfa_tokens import parse_steps, steps_text

__all__ = ["parse_gfa_numeric", "write_gfa"]


_S = re.compile(rb"^S\t([^\t\n]*)\t([^\t\n]*)", re.M)
_L = re.compile(rb"^L\t([^\t\n]*)\t([^\t\n]*)\t([^\t\n]*)\t([^\t\n]*)",
                re.M)
_P = re.compile(rb"^P\t([^\t\n]*)\t([^\t\n]*)", re.M)


def parse_gfa_numeric(data: bytes) -> BidirectedGraph:
    """Parse GFA with numeric segment ids kept verbatim
    (src/bin/gfasort.rs:88-167): S lines in file order (``node_order``
    the order of first insertion, a repeated id's sequence overwritten),
    L lines in file order, each added unless it or its complement is
    there already, then P lines; a step whose last character is not '+'
    is reverse (:149)."""
    g = BidirectedGraph()
    for nid, seq in _S.findall(data):
        g.add_node(int(nid), seq)
    links = _L.findall(data)
    if links:
        a, ao, b, bo = zip(*links)
        ef = (np.array([int(x) for x in a], dtype=np.int64) << 1) | np.array(
            [o != b"+" for o in ao], dtype=np.int64)
        et = (np.array([int(x) for x in b], dtype=np.int64) << 1) | np.array(
            [o != b"+" for o in bo], dtype=np.int64)
        # an edge and its complement (flip(to), flip(from)) are one link:
        # the first of each in file order is stored, as written
        cf, ct = et ^ 1, ef ^ 1
        use_c = (cf < ef) | ((cf == ef) & (ct < et))
        key = (np.where(use_c, cf, ef) << 32) | np.where(use_c, ct, et)
        _, first = np.unique(key, return_index=True)
        first.sort()
        g.edges = EdgeSet(ef[first], et[first])
    for name, steps in _P.findall(data):
        path = BiPath(name.decode())
        sid, rev = parse_steps(steps)
        path.steps = (sid << 1) | rev
        g.paths.append(path)
    return g


def write_gfa(graph: BidirectedGraph) -> str:
    """CLI-style GFA text (src/graph_ops.rs:693-738): H, the S lines in id
    order, the L lines sorted by their stored (from, to) handles, the P
    lines with a ``*`` overlap column."""
    sign = ("+", "-")
    out = ["H\tVN:Z:1.0"]
    out += [f"S\t{nid}\t{seq.decode()}" for nid, seq in enumerate(graph.nodes)
            if seq is not None]
    ef, et = graph.edges_to_arrays()
    order = np.lexsort((et, ef))
    out += [f"L\t{f >> 1}\t{sign[f & 1]}\t{t >> 1}\t{sign[t & 1]}\t0M"
            for f, t in zip(ef[order].tolist(), et[order].tolist())]
    for path in graph.paths:
        steps = steps_text(path.steps >> 1, path.steps & 1).decode()
        out.append(f"P\t{path.name}\t{steps}\t*")
    out.append("")
    return "\n".join(out)
