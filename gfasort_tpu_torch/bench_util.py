"""Workloads and quality measures of the port's smoke run and GPU tests.

``synthetic_path_index``, ``rank_quality`` and ``bench_params`` are
copied unchanged from ``gfasort_tpu/bench_util.py``;
``layout_quality_vs_oracle`` is that module's layout certificate with the port's sweep engine on ``device``;
``cuda_ms`` times device work with CUDA events; ``BENCH_SHAPE``,
``contract_choices`` and ``bench_layout_coords`` make the bucket kernels'
inputs of ``chip_smoke.py`` and ``tools/kernel_ab.py``, ``fused_cases`` the
fused sweep apply's.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np

from .index import PathIndex
from .params import PathSGDParams

__all__ = ["synthetic_path_index", "rank_quality", "bench_params",
           "layout_quality_vs_oracle",
           "cuda_ms", "BENCH_SHAPE", "contract_choices", "bench_layout_coords",
           "fused_cases"]

# the bench-shape graph: nodes, paths, steps per path (bench.py:50-52)
BENCH_SHAPE = (1_000_000, 16, 250_000)


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


def bench_params(pidx: PathIndex, batch: int, rounds: int) -> PathSGDParams:
    """Params that make the production engine run exactly ``rounds``
    rounds of width ``batch`` (iter_max = rounds-1, mtu = batch)."""
    p = PathSGDParams().derive_from_graph(pidx)
    return replace(
        p,
        iter_max=rounds - 1,
        min_term_updates=batch,
        batch=batch,
        dtype="float32",
        pow_mode="fast",
    )


def layout_quality_vs_oracle(
    n_nodes: int = 20_000,
    n_paths: int = 4,
    steps_per_path: int = 20_000,
    dims: int = 2,
    *,
    device="cuda",
    engine: str = "sweep",
    mesh=None,
    **sweep_kw,
) -> Optional[dict]:
    """Layout certificate: sampled stress of the port's layout vs the C++
    oracle layout on the same workload and from the same initial
    coordinates.  ``engine``: ``"sweep"`` (f32, ``pow_mode="fast"``,
    ``sweep_kw`` passed on), ``"sweep-sharded"`` (the same on ``mesh``,
    by default ``default_mesh`` on ``device``) or ``"batched"`` (f32
    states, the engine's default ``pow_mode="fpp"``).  None when the C++
    oracle cannot be built."""
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

    if engine == "batched":
        from .ops.sgd import path_linear_sgd_layout_batched

        lay_s = path_linear_sgd_layout_batched(
            None, replace(lp, pow_mode="fpp"), pidx, init_coords=init,
            device=device)
    elif engine == "sweep-sharded":
        from .parallel import (default_mesh,
                               path_linear_sgd_layout_sweep_sharded)

        lay_s = path_linear_sgd_layout_sweep_sharded(
            None, lp, mesh or default_mesh(device=device), pidx,
            init_coords=init, **sweep_kw)
    else:
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


def contract_choices(rng, S, buckets, P):
    """Random choice words that obey the sampler contract: every +k / -k
    choice stays inside the array (as in tests/test_sweep_dense.py).
    One int32 [S] array (P == 1) or the ceil(P / 4) packed words, on the
    CPU."""
    import torch

    from .ops.sweep_common import INACTIVE, pack_choices_words

    kis = [ki for _, ki in buckets]
    iota = np.arange(S)
    pool = np.array(kis + [~ki for ki in kis] + [int(INACTIVE)], np.int32)

    def draw():
        s = pool[rng.integers(0, len(pool), S)]
        for k, ki in buckets:
            s = np.where((s == ki) & (iota + k >= S), INACTIVE, s)
            s = np.where((s == ~ki) & (iota - k < 0), INACTIVE, s)
        return torch.from_numpy(s.astype(np.int32))

    if P == 1:
        return [draw()]
    return pack_choices_words([draw() for _ in range(P)])


def bench_layout_coords(rng, pos_np: np.ndarray, D: int) -> np.ndarray:
    """f32 [D, S] layout coordinates at the bench's scale: x ~ the path
    position, the other dimensions ~ N(0, 2N); a few coincident ones hit
    the zero guard."""
    S = pos_np.shape[0]
    c_np = (rng.standard_normal((D, S)) * 1414.0).astype(np.float32)
    c_np[0] = pos_np + rng.standard_normal(S).astype(np.float32)
    c_np[:, 7::1001] = c_np[:, 8::1001][:, :c_np[:, 7::1001].shape[1]]
    return c_np


def fused_cases(pidx, plan, dev):
    """The fused sweep apply's cases on ``pidx`` (its real rank and cnt)
    over the full offset sets of ``plan``'s phases 0 and 1, each at the
    first and the last sweep's eta: xs ~ N(0, 100^2) and P = 1 contract
    choices from seed 2.  One dict per case: ``phase_of_plan``,
    ``eta_of`` ("first" or "last"), ``eta``, ``offs``, ``phase``,
    ``layout``, the unpadded ``xs``, ``pos``, ``sidx`` and ``args``, the
    padded (xs, pos, sidx, rank, cnt) in the layout's [rows, 128] views,
    all on ``dev``."""
    import torch
    import torch.nn.functional as F

    from .ops.sweep_fused import (build_sweep_apply, pad_sidx, pad_state,
                                  pad_static)

    S = pidx.total_steps
    rng = np.random.default_rng(2)
    xs = torch.from_numpy((rng.standard_normal(S) * 100).astype(np.float32)).to(dev)
    pos_np = pidx.step_pos.astype(np.float32)
    pos = torch.from_numpy(pos_np).to(dev)
    rank = torch.from_numpy(pidx.step_rank.astype(np.int32)).to(dev)
    cnt = torch.from_numpy(pidx.step_count_of_step.astype(np.int32)).to(dev)
    etas = {"first": float(plan.sweep_eta[0]), "last": float(plan.sweep_eta[-1])}
    cases = []
    for ph_i in (0, 1):
        phase = plan.phases[ph_i]
        offs = tuple(int(k) for k in phase.offs)
        sidx = contract_choices(rng, S, [(k, ki) for ki, k in enumerate(offs)],
                                1)[0].to(dev)
        _, lay = build_sweep_apply(offs, S)
        tail = (0, lay["S_pad"] - S)
        args = (pad_state(xs, lay),
                torch.from_numpy(pad_static(pos_np, lay)).to(dev),
                pad_sidx(sidx, lay), F.pad(rank, tail), F.pad(cnt, tail))
        for eta_of, eta in etas.items():
            cases.append(dict(phase_of_plan=ph_i, eta_of=eta_of, eta=eta,
                              offs=offs, phase=phase, layout=lay, xs=xs,
                              pos=pos, sidx=sidx, args=args))
    return cases
