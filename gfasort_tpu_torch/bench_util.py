"""Workloads and quality measures of the port's smoke run and GPU tests.

``synthetic_path_index`` and ``rank_quality`` are copied unchanged from
``gfasort_tpu/bench_util.py``; ``layout_quality_vs_oracle`` is that
module's layout certificate with the port's sweep engine on ``device``;
``cuda_ms`` times device work with CUDA events.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np

from .index import PathIndex

__all__ = ["synthetic_path_index", "rank_quality", "layout_quality_vs_oracle",
           "cuda_ms"]


def synthetic_path_index(
    n_nodes: int = 100_000,
    n_paths: int = 16,
    steps_per_path: int = 100_000,
    seed: int = 0,
) -> PathIndex:
    """Build a chromosome-scale synthetic PathIndex directly (no
    host-graph construction): each path is a noisy monotone walk over
    the node space — the structure of a real pangenome path after a
    reasonable sort — with random node lengths 1..16 bp."""
    rng = np.random.default_rng(seed)
    node_len = rng.integers(1, 17, size=n_nodes).astype(np.int64)

    handles, poss, pths, rnks = [], [], [], []
    counts, lens = [], []
    for p in range(n_paths):
        # monotone-ish walk with local jitter and occasional reversals
        base = np.sort(rng.integers(0, n_nodes, size=steps_per_path))
        jitter = rng.integers(-50, 51, size=steps_per_path)
        nodes = np.clip(base + jitter, 0, n_nodes - 1)
        rev = rng.random(steps_per_path) < 0.05
        handles.append(((nodes + 1) << 1) | rev.astype(np.int64))
        lengths = node_len[nodes]
        pos = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        poss.append(pos)
        pths.append(np.full(steps_per_path, p, dtype=np.int32))
        rnks.append(np.arange(steps_per_path, dtype=np.int64))
        counts.append(steps_per_path)
        lens.append(int(lengths.sum()))

    step_handle = np.concatenate(handles)
    path_count = np.asarray(counts, dtype=np.int64)
    path_first = np.concatenate([[0], np.cumsum(path_count)[:-1]]).astype(np.int64)
    node_ids = np.arange(1, n_nodes + 1, dtype=np.int64)
    step_node_idx = (step_handle >> 1) - 1

    return PathIndex(
        step_handle=step_handle,
        step_pos=np.concatenate(poss),
        step_path=np.concatenate(pths),
        step_rank=np.concatenate(rnks),
        path_first=path_first,
        path_count=path_count,
        path_len=np.asarray(lens, dtype=np.int64),
        node_ids=node_ids,
        node_len=node_len,
        handle_to_idx={int(n): i for i, n in enumerate(node_ids)},
        step_node_idx=step_node_idx,
        step_count_of_step=path_count[np.concatenate(pths)],
    )


def rank_quality(order_a: np.ndarray, order_b: np.ndarray) -> dict:
    """Rank agreement between two orderings of the same node set:
    mean absolute rank displacement (as a fraction of N) and Spearman
    correlation of the rank vectors."""
    n = len(order_a)
    ra = np.empty(n, np.int64)
    rb = np.empty(n, np.int64)
    ra[np.asarray(order_a)] = np.arange(n)
    rb[np.asarray(order_b)] = np.arange(n)
    disp = np.abs(ra - rb)
    sa = (ra - ra.mean()) / max(ra.std(), 1e-12)
    sb = (rb - rb.mean()) / max(rb.std(), 1e-12)
    return {
        "rank_mae_frac": float(disp.mean()) / max(n, 1),
        "spearman": float((sa * sb).mean()),
    }


def layout_quality_vs_oracle(
    n_nodes: int = 20_000,
    n_paths: int = 4,
    steps_per_path: int = 20_000,
    dims: int = 2,
    *,
    device="cuda",
    **sweep_kw,
) -> Optional[dict]:
    """Layout certificate: sampled stress of the port's sweep layout vs
    the C++ oracle layout on the same workload and from the same initial
    coordinates.  None when the C++ oracle cannot be built."""
    from .native import available, path_linear_sgd_layout_native
    from .ops.exact import calculate_layout_stress_pidx, layout_initial_coords
    from .ops.sweep_nd import path_linear_sgd_layout_sweep
    from .params import LayoutSGDParams

    if not available():
        return None
    pidx = synthetic_path_index(n_nodes, n_paths, steps_per_path, seed=11)
    lp = LayoutSGDParams().derive_from_graph(pidx, dims)
    lp = replace(lp, dtype="float32", pow_mode="fast")
    init = layout_initial_coords(pidx, dims, lp.seed)

    lay_s = path_linear_sgd_layout_sweep(
        None, lp, pidx, init_coords=init, device=device, **sweep_kw
    )
    lo = replace(lp, dtype="float64", pow_mode="fpp")
    lay_o = path_linear_sgd_layout_native(None, lo, pidx, init_coords=init)

    stress_s = calculate_layout_stress_pidx(pidx, lay_s, 10_000)
    stress_o = calculate_layout_stress_pidx(pidx, lay_o, 10_000)
    return {
        "stress": stress_s,
        "oracle_stress": stress_o,
        "ratio": stress_s / max(stress_o, 1e-12),
        "n_nodes": n_nodes,
        "dims": dims,
    }


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA
    events, after two warm-up runs)."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
