"""SGD diagnostics: per-path orientation stats and problematic adjacent
step pairs (reference: ``src/bin/sgd_diagnostics.rs``).

A pair is "problematic" when the id-order (SGD-position) distance of two
adjacent path steps exceeds 10× their path distance
(src/bin/sgd_diagnostics.rs:167-186).  SGD positions are cumulative
sequence lengths over nodes in sorted-id order (:123-134).
"""

from __future__ import annotations

import sys

from .. import handle as H
from ..io import gfa as gfa_io

RATIO_THRESHOLD = 10.0


def diagnose(graph, log=print):
    log("[sgd_diagnostics] Graph loaded:")
    log(f"  Nodes: {graph.node_count()}")
    log(f"  Paths: {len(graph.paths)}")
    log(f"  Edges: {len(graph.edges)}")

    log("\n[sgd_diagnostics] Path orientation analysis:")
    for path in graph.paths:
        total = len(path)
        rev = int((path.steps & 1).sum())
        fwd = total - rev
        pct = (rev / total * 100.0) if total else 0.0
        log(f"  {path.name}: {total} steps, {fwd} forward, {rev} reverse "
            f"({pct:.1f}% reverse)")

    # node-id -> SGD position (cumulative length in sorted-id order)
    pos_map = {}
    pos = 0.0
    for nid in graph.live_node_ids():
        pos_map[nid] = pos
        pos += len(graph.nodes[nid])

    log("\n[sgd_diagnostics] Analyzing path step pairs:")
    total_problematic = 0
    for path in graph.paths:
        log(f"\n  Path: {path.name}")
        steps = path.steps.tolist()
        cum = 0
        step_positions = []
        for h in steps:
            step_positions.append(cum)
            nid = h >> 1
            if nid < len(graph.nodes) and graph.nodes[nid] is not None:
                cum += len(graph.nodes[nid])
        problems = []
        for i in range(len(steps) - 1):
            ha, hb = steps[i], steps[i + 1]
            path_dist = abs(step_positions[i + 1] - step_positions[i])
            sa = pos_map.get(ha >> 1, 0.0)
            sb = pos_map.get(hb >> 1, 0.0)
            sgd_dist = abs(sb - sa)
            ratio = sgd_dist / path_dist if path_dist > 0 else 0.0
            if ratio > RATIO_THRESHOLD:
                problems.append((ha, hb, step_positions[i], step_positions[i + 1],
                                 path_dist, sgd_dist, ratio))
        if not problems:
            log("    No problematic adjacent pairs found")
        else:
            log(f"    Found {len(problems)} problematic adjacent pairs:")
            total_problematic += len(problems)
            for ha, hb, pa, pb, pd, sd, ratio in problems:
                log(f"      Node {H.fmt(ha)}->{H.fmt(hb)}:")
                log(f"        Path positions: {pa} -> {pb} (dist={pd:.0f}bp)")
                log(f"        SGD positions: {pos_map.get(ha >> 1, 0):.0f} -> "
                    f"{pos_map.get(hb >> 1, 0):.0f} (dist={sd:.0f})")
                log(f"        Ratio: {ratio:.1f}x (SGD dist / path dist)")
    log("\n[sgd_diagnostics] Analysis complete")
    return total_problematic


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print(f"Usage: {sys.argv[0]} <input.gfa>", file=sys.stderr)
        print("Analyzes SGD behavior to find problematic node pairs", file=sys.stderr)
        return 1
    with open(argv[0]) as fh:
        graph = gfa_io.parse_gfa_numeric(fh.read())
    diagnose(graph, log=lambda *a: print(*a, file=sys.stderr))
    return 0


if __name__ == "__main__":
    sys.exit(main())
