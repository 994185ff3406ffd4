"""1D layout quality from node ids as positions: per-path and overall
MSE/MAE/RMSE plus normalized per-bp metrics (reference:
``src/bin/measure_layout_quality.rs:98-209``).

Positions: cumulative sequence length over live nodes in id order.  For
each consecutive path step pair, genomic distance = length of the first
node; error = |layout distance − genomic distance|.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import Dict, List

from ..io import gfa as gfa_io


@dataclass
class QualityReport:
    per_path: List[tuple]  # (name, mse, mae, length)
    total_steps: int
    total_path_length: float
    total_length: float
    mse: float
    rmse: float
    mae: float
    normalized_mse: float
    normalized_mae: float


def measure(graph) -> QualityReport:
    positions: Dict[int, float] = {}
    pos = 0.0
    for nid in graph.live_node_ids():
        positions[nid] = pos
        pos += len(graph.nodes[nid])
    total_length = pos

    per_path = []
    tot_sq = tot_abs = tot_len = 0.0
    tot_steps = 0
    for path in graph.paths:
        if len(path) < 2:
            continue
        steps = path.steps.tolist()
        p_sq = p_abs = p_len = 0.0
        p_steps = 0
        for a, b in zip(steps, steps[1:]):
            na, nb = a >> 1, b >> 1
            if na >= len(graph.nodes) or graph.nodes[na] is None:
                continue
            genomic = float(len(graph.nodes[na]))
            p_len += genomic
            d = abs(positions.get(nb, 0.0) - positions.get(na, 0.0))
            err = d - genomic
            p_sq += err * err
            p_abs += abs(err)
            p_steps += 1
        tot_sq += p_sq
        tot_abs += p_abs
        tot_steps += p_steps
        tot_len += p_len
        if p_steps:
            per_path.append((path.name, p_sq / p_steps, p_abs / p_steps, p_len))

    if tot_steps:
        mse = tot_sq / tot_steps
        mae = tot_abs / tot_steps
        return QualityReport(
            per_path, tot_steps, tot_len, total_length,
            mse, math.sqrt(mse), mae,
            tot_sq / total_length if total_length else 0.0,
            tot_abs / total_length if total_length else 0.0,
        )
    return QualityReport(per_path, 0, 0.0, total_length, 0.0, 0.0, 0.0, 0.0, 0.0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(f"Usage: {sys.argv[0]} <graph.gfa>", file=sys.stderr)
        return 1
    with open(argv[0]) as fh:
        graph = gfa_io.parse_gfa_numeric(fh.read())
    print(f"Graph has {len([n for n in graph.nodes if n is not None])} nodes "
          f"and {len(graph.paths)} paths", file=sys.stderr)
    rep = measure(graph)

    print("\nPer-path metrics:")
    print(f"{'Path':<40} {'MSE':>12} {'MAE':>12} {'Length':>12}")
    print("-" * 80)
    for name, mse, mae, length in rep.per_path:
        display = name if len(name) <= 40 else name[:37] + "..."
        print(f"{display:<40} {mse:>12.2f} {mae:>12.2f} {length:>12.0f}")
    print("-" * 80)
    if rep.total_steps:
        print("\nOverall metrics:")
        print(f"  Total steps analyzed: {rep.total_steps}")
        print(f"  Total path length: {rep.total_path_length:.0f} bp")
        print(f"  Total graph length: {rep.total_length:.0f} bp")
        print()
        print(f"  Mean Squared Error (MSE): {rep.mse:.2f}")
        print(f"  Root Mean Squared Error (RMSE): {rep.rmse:.2f}")
        print(f"  Mean Absolute Error (MAE): {rep.mae:.2f}")
        print()
        print(f"  Normalized MSE (per bp): {rep.normalized_mse:.6f}")
        print(f"  Normalized MAE (per bp): {rep.normalized_mae:.6f}")
        print()
        print("Layout quality score (lower is better):")
        print(f"  RMSE: {rep.rmse:.2f} bp displacement per step")
        avg = rep.total_path_length / rep.total_steps
        print(f"  Relative error: {rep.mae / avg * 100.0:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
