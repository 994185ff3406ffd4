"""Multi-device scaling harness of the port (counterpart of
``bench_scaling.py``).

Runs the sharded sweep engine over meshes of 1, 2, 4, ... shards of one
device type on a fixed workload and prints one JSON row per mesh size:
pair-updates/s, per shard, the efficiency against one shard, the shard
length, the consensus period, the all-reduce bytes per consensus
(an [N]-sized sum and count, independent of S) and, in strong mode, the
per-period wall split (one consensus period of sweeps with and without
the all-reduce: ``period_wall_ms``, ``sweeps_wall_ms``, their
difference ``collective_ms`` and its share ``collective_frac``) and the
rank agreement of each mesh's order with one shard's
(``spearman_vs_1dev``).  When the shards share one device (the CPU, or
several shards of one card), the walls are not a scaling measurement:
the run then shows that the sharded program runs and keeps per-shard
work balanced.

    python -m gfasort_tpu_torch.tools.bench_scaling [max_shards] [--weak]
        [--device cuda|cpu]

``--weak``: the workload grows with the mesh (2 paths x 50k steps per
shard), so every shard holds the same length at every mesh size.  The
strong workload is 1M nodes, 16 paths x 250k steps on the card, and
100k nodes, 16 x 50k on the CPU.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import replace
from typing import Callable, Optional

import numpy as np

ROUNDS = 16
FRAC = 0.8


def default_workload(nd: int, weak: bool, virtual: bool):
    """The harness's own workload for a mesh of ``nd`` shards."""
    from ..bench_util import synthetic_path_index

    if weak:
        # constant shard: 2 paths x 50k steps per shard
        return synthetic_path_index(int(1e5), 2 * nd, int(5e4), seed=0)
    return synthetic_path_index(
        int(1e5) if virtual else int(1e6),
        16,
        int(5e4) if virtual else int(25e4),
        seed=0,
    )


def run_scaling(max_shards: Optional[int] = None, weak: bool = False,
                device="cuda",
                workload: Optional[Callable[[int], object]] = None,
                reps: int = 3, part_reps: int = 5, emit=print) -> list:
    """One row per mesh size 1, 2, 4, ... <= ``max_shards`` (default:
    the visible cards, 1 on the CPU).  ``workload(nd)`` returns the
    PathIndex of a mesh of ``nd`` shards (default:
    :func:`default_workload`); ``emit`` receives each row's JSON line."""
    import torch

    from ..bench_util import bench_params, rank_quality
    from ..ops.keys import key_data
    from ..parallel import default_mesh
    from ..parallel.sweep_shard import build_sharded_sweep

    dev_type = torch.device(device).type
    virtual = dev_type == "cpu"
    if max_shards is None:
        max_shards = len(default_mesh(None, device).devices)
    if workload is None:
        def workload(nd):
            return default_workload(nd, weak, virtual)

    def sync():
        if dev_type == "cuda":
            torch.cuda.synchronize()

    sizes = []
    d = 1
    while d <= max_shards:
        sizes.append(d)
        d *= 2
    key = key_data(0)
    rows = []
    base_rate = None
    base_order = None
    for nd in sizes:
        pidx = workload(nd)
        ups = max(1, int(pidx.total_steps * FRAC))
        p = replace(
            bench_params(pidx, 1, 1), iter_max=ROUNDS - 1,
            min_term_updates=ups,
        )
        mesh = default_mesh(nd, device)
        # consensus_every=None -> the base auto period scaled by the
        # SHARD length (sweep_shard.shard_consensus_every): strong
        # rows show ce growing as shards shrink
        run, arrays, make_state, info = build_sharded_sweep(
            pidx, p, mesh, per_octave=2, consensus_every=None,
            active_frac=FRAC, rotate=8, expose_parts=not weak,
        )
        xs0, xn0 = make_state()
        run(xs0, xn0, key, *arrays)
        sync()  # settle: first launches, allocations
        best = float("inf")
        for _rep in range(reps):
            xs0, xn0 = make_state()
            sync()
            t0 = time.perf_counter()
            x_final = run(xs0, xn0, key, *arrays).cpu().numpy()
            best = min(best, time.perf_counter() - t0)
        updates = info["n_sweeps"] * info["updates_per_sweep"]
        rate = updates / best
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        psum_bytes = pidx.num_nodes * 4 * 2  # sum + count arrays
        row = {
            "devices": nd,
            "updates_per_s": round(rate, 1),
            "updates_per_s_per_device": round(rate / nd, 1),
            "scaling_efficiency": round(eff, 3),
            "virtual_devices": virtual or len(set(mesh.devices)) < nd,
            "weak": weak,
            "psum_bytes_per_consensus": psum_bytes,
            "shard_len": info["shard_len"],
            "consensus_every": info["consensus_every"],
            "grid_consensus": info["grid_consensus"],
        }
        if not weak:
            # per-period wall split: one consensus period of sweeps
            # WITHOUT the all-reduce vs WITH it; the difference isolates
            # the per-period collective cost as executed on this mesh
            parts = info["parts"]

            def _best(fn):
                fn(make_state()[0], key, *arrays)
                sync()
                b = float("inf")
                for _i in range(part_reps):
                    xs_t = make_state()[0]
                    sync()
                    t0 = time.perf_counter()
                    fn(xs_t, key, *arrays)
                    sync()
                    b = min(b, time.perf_counter() - t0)
                return b

            t_sweeps = _best(parts["sweeps_fn"])
            t_period = _best(parts["period_fn"])
            coll_ms = max((t_period - t_sweeps) * 1e3, 0.0)
            row["period_wall_ms"] = round(t_period * 1e3, 3)
            row["sweeps_wall_ms"] = round(t_sweeps * 1e3, 3)
            row["collective_ms"] = round(coll_ms, 3)
            row["collective_frac"] = round(
                coll_ms / max(t_period * 1e3, 1e-9), 4
            )
            row["model"] = "docs/SCALING.md#4"
            # strong mode: same workload at every size; the adaptive
            # period changes the schedule per mesh size, so outputs are
            # convergence-equivalent, not bit-equal
            order = np.argsort(x_final, kind="stable")
            if base_order is None:
                base_order = order
                row["spearman_vs_1dev"] = 1.0
            else:
                row["spearman_vs_1dev"] = round(
                    rank_quality(order, base_order)["spearman"], 6
                )
        rows.append(row)
        emit(json.dumps(row))
    return rows


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="gfasort_tpu_torch.tools.bench_scaling")
    ap.add_argument("max_shards", nargs="?", type=int, default=None)
    ap.add_argument("--weak", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run_scaling(args.max_shards, args.weak, args.device,
                       emit=lambda line: print(line, flush=True))
    if any(r["virtual_devices"] for r in rows):
        print("# NOTE: the shards share one device; wall-clock efficiency "
              "above is not a hardware scaling measurement", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
