"""Compare sampled stress between a gfasort layout TSV and an ODGI
layout TSV (reference: ``src/bin/compare_layouts.rs``).

ODGI format: two rows per node, even rows = + end (``:119-153``); only
the + end is used.  Stress: same sampled metric as the engine (random
step pairs within paths, seed 12345, ``:156-255``).
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Tuple

from ..index import PathIndex
from ..io import gfa as gfa_io
from ..ops.rng import UniformInt, Xoshiro256Plus


def load_gfasort_layout(path: str) -> Dict[int, Tuple[float, float]]:
    """idx, x+, y+ columns of a gfasort TSV (:93-117)."""
    layout = {}
    with open(path) as fh:
        for i, line in enumerate(fh):
            if i == 0 or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3:
                layout[int(parts[0])] = (float(parts[1]), float(parts[2]))
    return layout


def load_odgi_layout(path: str) -> Dict[int, Tuple[float, float]]:
    """ODGI layout: 2 rows/node, even row = + end (:122-153)."""
    layout = {}
    with open(path) as fh:
        for i, line in enumerate(fh):
            if i == 0 or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3:
                idx = int(parts[0])
                if idx % 2 == 0:
                    layout[idx // 2] = (float(parts[1]), float(parts[2]))
    return layout


def calculate_stress(graph, layout: Dict[int, Tuple[float, float]],
                     sample_count: int, pidx: PathIndex | None = None) -> float:
    """Sampled normalized stress over a coordinate map (:156-255).
    Dispatches to the C++ oracle when available (bit-identical RNG
    stream; ~1000x the pure-Python loop on 100k samples)."""
    pidx = pidx or PathIndex.from_graph(graph)
    if pidx.total_steps < 2:
        return 0.0

    from ..native import available, layout_stress_2d_native

    if available():
        import numpy as np

        n = pidx.num_nodes
        xs = np.zeros(n)
        ys = np.zeros(n)
        present = np.zeros(n, np.uint8)
        for idx, (x, y) in layout.items():
            if 0 <= idx < n:
                xs[idx] = x
                ys[idx] = y
                present[idx] = 1
        return layout_stress_2d_native(pidx, xs, ys, present, sample_count)

    return calculate_stress_py(pidx, layout, sample_count)


def calculate_stress_py(pidx: PathIndex, layout: Dict[int, Tuple[float, float]],
                        sample_count: int) -> float:
    """Pure-Python stress loop (bit-parity reference for the native
    path; ~1000x slower at 100k samples)."""
    rng = Xoshiro256Plus(12345)
    step_dist = UniformInt(0, pidx.total_steps)
    stress_sum = 0.0
    count = 0
    for _ in range(sample_count):
        sa0 = step_dist.sample(rng)
        p = int(pidx.step_path[sa0])
        cnt = int(pidx.path_count[p])
        if cnt < 2:
            continue
        rank_a = int(pidx.step_rank[sa0])
        rank_b = UniformInt(0, cnt).sample(rng)
        if rank_a == rank_b:
            continue
        sa = int(pidx.path_first[p]) + rank_a
        sb = int(pidx.path_first[p]) + rank_b
        path_dist = abs(float(pidx.step_pos[sa]) - float(pidx.step_pos[sb]))
        if path_dist == 0.0:
            continue
        ia = int(pidx.step_node_idx[sa])
        ib = int(pidx.step_node_idx[sb])
        if ia not in layout or ib not in layout:
            continue
        xa, ya = layout[ia]
        xb, yb = layout[ib]
        d = math.hypot(xa - xb, ya - yb)
        err = d - path_dist
        stress_sum += (err * err) / (path_dist * path_dist)
        count += 1
    return math.sqrt(stress_sum / count) if count else 0.0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print(
            f"Usage: {sys.argv[0]} <gfa_file> <gfasort_layout.tsv> <odgi_layout.tsv>",
            file=sys.stderr,
        )
        return 1
    gfa_path, ours_path, odgi_path = argv
    with open(gfa_path) as fh:
        graph = gfa_io.parse_gfa_numeric(fh.read())
    print(f"Loaded graph: {graph.node_count()} nodes, {len(graph.edges)} edges, "
          f"{len(graph.paths)} paths", file=sys.stderr)
    ours = load_gfasort_layout(ours_path)
    odgi = load_odgi_layout(odgi_path)
    print(f"Loaded gfasort layout: {len(ours)} nodes", file=sys.stderr)
    print(f"Loaded ODGI layout: {len(odgi)} nodes", file=sys.stderr)
    sample_count = 100_000
    s_ours = calculate_stress(graph, ours, sample_count)
    s_odgi = calculate_stress(graph, odgi, sample_count)
    print(f"Stress comparison ({sample_count} samples):")
    print(f"  gfasort: {s_ours:.6f}")
    print(f"  ODGI:    {s_odgi:.6f}")
    ratio = s_ours / s_odgi if s_odgi else float("inf")
    print(f"  ratio (gfasort/ODGI): {ratio:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
