"""Fast GFA loading through the native C++ parser.

Behavior-identical to :func:`gfasort_tpu_torch.io.gfa.parse_gfa_numeric`
(CLI-parser semantics, numeric ids kept verbatim, edge complement dedup)
but parses in C++ and assembles the graph from struct-of-arrays
buffers — the host-I/O path for chromosome-scale GFAs.  Falls back to
the pure-Python parser when no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..graph import BiPath, BidirectedGraph

__all__ = ["load_gfa_numeric_fast", "parse_gfa_numeric_fast"]


def _assemble(lib, h) -> BidirectedGraph:
    err = lib.gfa_error(h)
    if err:
        raise ValueError(err.decode())
    n_segs = lib.gfa_n_segs(h)
    n_links = lib.gfa_n_links(h)
    n_paths = lib.gfa_n_paths(h)
    n_steps = lib.gfa_n_steps(h)

    names = ctypes.string_at(lib.gfa_path_names(h), lib.gfa_path_names_len(h)).decode()
    steps = np.ctypeslib.as_array(lib.gfa_step_handles(h), shape=(n_steps,)).copy() if n_steps else np.zeros(0, np.int64)
    path_off = np.ctypeslib.as_array(lib.gfa_path_offsets(h), shape=(n_paths + 1,)).copy()

    g = BidirectedGraph()
    from ..native.build import load_py

    pylib = load_py()
    if pylib is not None:
        # CPython-API fast path: build nodes/order/edges straight from
        # the parser's buffers (no per-element Python loop).
        g.nodes, g.node_order = pylib.gfa_build_nodes(
            n_segs, lib.gfa_seg_ids(h), lib.gfa_seq_offsets(h), lib.gfa_seq_blob(h)
        )
        g.edges = pylib.gfa_build_edges(n_links, lib.gfa_link_from(h), lib.gfa_link_to(h))
    else:
        seg_ids = np.ctypeslib.as_array(lib.gfa_seg_ids(h), shape=(n_segs,)).copy() if n_segs else np.zeros(0, np.int64)
        seq_off = np.ctypeslib.as_array(lib.gfa_seq_offsets(h), shape=(n_segs + 1,)).copy()
        blob = ctypes.string_at(lib.gfa_seq_blob(h), lib.gfa_seq_blob_len(h))
        link_from = np.ctypeslib.as_array(lib.gfa_link_from(h), shape=(n_links,)).copy() if n_links else np.zeros(0, np.int64)
        link_to = np.ctypeslib.as_array(lib.gfa_link_to(h), shape=(n_links,)).copy() if n_links else np.zeros(0, np.int64)
        max_id = int(seg_ids.max()) if n_segs else -1
        g.nodes = [None] * (max_id + 1)
        # plain-list iteration: indexing numpy scalars per element is
        # ~10x slower than pre-converting with tolist()
        ids_l = seg_ids.tolist()
        off_l = seq_off.tolist()
        nodes = g.nodes
        order_append = g.node_order.append
        for i, nid in enumerate(ids_l):
            if nodes[nid] is None:
                order_append(nid)
            nodes[nid] = blob[off_l[i] : off_l[i + 1]]
        g.edges = set(zip(link_from.tolist(), link_to.tolist()))
    path_names = names.split("\n")[:-1] if names else []
    for p in range(n_paths):
        g.paths.append(
            BiPath(path_names[p], steps[int(path_off[p]) : int(path_off[p + 1])])
        )
    return g


def parse_gfa_numeric_fast(text: str) -> BidirectedGraph:
    from ..native.build import load

    lib = load()
    if lib is None:
        from .gfa import parse_gfa_numeric

        return parse_gfa_numeric(text)
    data = text.encode()
    h = lib.gfa_parse_buffer(data, len(data))
    try:
        return _assemble(lib, h)
    finally:
        lib.gfa_free(h)


def load_gfa_numeric_fast(path) -> BidirectedGraph:
    from ..native.build import load

    lib = load()
    if lib is None:
        from .gfa import parse_gfa_numeric

        with open(path) as fh:
            return parse_gfa_numeric(fh.read())
    h = lib.gfa_parse_file(str(path).encode())
    if not h:
        raise OSError(f"Error reading file: {path}")
    try:
        return _assemble(lib, h)
    finally:
        lib.gfa_free(h)
