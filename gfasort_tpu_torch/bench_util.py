"""Workloads, timed runs and quality measures of the port's bench, smoke
run and GPU tests.

Counterpart of ``gfasort_tpu/bench_util.py``, with an explicit
``device`` on every function that runs an engine (default ``"cuda"``).
``synthetic_path_index``, ``shuffled_path_index``, ``rank_quality`` and
``bench_params`` are copies.  The measurement functions run the port's
engines: ``bench_sweep_1d``, ``bench_sweep_nd`` and ``bench_batched_1d``
time whole runs from one device synchronisation to the next, the first
run reported apart as ``warmup_s``; ``measure_applied_frac`` replays the
sampler through ``ops.sweep.build_applied_counter``; ``roofline_model``
holds a measured rate against the H100 peaks (``HBM_BYTES_S``,
``F32_OPS_S``; the int32 and conversion rates beside them serve
``chip_smoke.bound_ms``); ``bench_native_1d`` and ``bench_native_1d_mt`` time the
C++ oracle's loop on the host; ``sweep_quality_vs_oracle`` and
``layout_quality_vs_oracle`` certify the sweep engines against the C++
oracle.  ``gather_consensus_ms`` and ``cuda_ms`` time device work
(``cuda_ms`` back to back, host launch path included), ``device_ms``
the device alone;
``BENCH_SHAPE``, ``contract_choices`` and ``bench_layout_coords`` make
the bucket kernels' inputs of ``chip_smoke.py`` and
``tools/kernel_ab.py``, ``fused_cases`` the fused sweep apply's and
``sampler_cases`` / ``roll_cases`` the sampler's and the roll kernels'
(``edge_phase`` builds their edge cases' offset sets).
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Optional

import numpy as np

from .index import PathIndex
from .params import PathSGDParams

__all__ = ["synthetic_path_index", "shuffled_path_index", "rank_quality",
           "bench_params", "bench_batched_1d", "bench_sweep_1d",
           "bench_sweep_nd", "HBM_BYTES_S", "F32_OPS_S", "F64_OPS_S", "H100_SMS",
           "MAX_SM_CLOCK_MHZ", "INT32_OPS_PER_CLOCK", "CVT_OPS_PER_CLOCK",
           "roofline_model",
           "measure_applied_frac", "bench_native_1d", "bench_native_1d_mt",
           "sweep_quality_vs_oracle", "layout_quality_vs_oracle",
           "gather_consensus_ms", "cuda_ms", "device_ms", "BENCH_SHAPE",
           "contract_choices", "bench_layout_coords", "fused_cases",
           "edge_phase", "sampler_cases", "roll_cases"]

# the bench-shape graph: nodes, paths, steps per path (bench.py:50-52)
BENCH_SHAPE = (1_000_000, 16, 250_000)

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates, at
# the 700 W power limit): HBM bytes/s and f32 operations/s outside the
# tensor cores.  ``roofline_model`` and ``chip_smoke.bound_ms`` read them.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# f64 operations/s outside the tensor cores (the same data sheet, SXM)
F64_OPS_S = 34e12
# Per-clock rates of the H100 SXM's 132 SMs, from the CUDA C++
# Programming Guide's arithmetic-throughput table for compute capability
# 9.0: 32-bit integer add, multiply, shift, compare and logic at 64 per
# clock per SM; type conversions, the f32 transcendentals (log2, exp2,
# reciprocal, square root) and population counts at 16.  At the
# published maximum SM clock of 1,980 MHz they give 16.7e12 int32 and
# 4.18e12 conversion operations/s.  ``chip_smoke.bound_ms`` reads them.
H100_SMS = 132
MAX_SM_CLOCK_MHZ = 1980.0
INT32_OPS_PER_CLOCK = H100_SMS * 64
CVT_OPS_PER_CLOCK = H100_SMS * 16


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


def shuffled_path_index(
    n_nodes: int = 1_000_000,
    n_paths: int = 16,
    steps_per_path: int = 250_000,
    seed: int = 0,
) -> PathIndex:
    """Adversarial-locality variant of :func:`synthetic_path_index`:
    node identities are randomly permuted, so consecutive steps
    reference scattered node ids and the grid consensus's band-locality
    assumption fails (coverage collapses; ops/sweep.select_consensus
    then auto-falls back to the gather-sum consensus).  Path structure,
    distances and ranks are unchanged — only the step->node map is
    scrambled."""
    pidx = synthetic_path_index(n_nodes, n_paths, steps_per_path, seed=seed)
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(n_nodes)  # new node index of old index i
    new_node_idx = perm[pidx.step_node_idx]
    new_node_len = np.empty_like(pidx.node_len)
    new_node_len[perm] = pidx.node_len
    new_handle = ((new_node_idx + 1) << 1) | (pidx.step_handle & 1)
    return PathIndex(
        step_handle=new_handle,
        step_pos=pidx.step_pos,
        step_path=pidx.step_path,
        step_rank=pidx.step_rank,
        path_first=pidx.path_first,
        path_count=pidx.path_count,
        path_len=pidx.path_len,
        node_ids=pidx.node_ids,
        node_len=new_node_len,
        handle_to_idx={int(n): i for i, n in enumerate(pidx.node_ids)},
        step_node_idx=new_node_idx,
        step_count_of_step=pidx.step_count_of_step,
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


def _sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed_runs(make_inputs, run, device, repeats: int):
    """``run(*make_inputs())`` once as warm-up, then ``repeats`` times,
    each run timed from a synchronisation of ``device`` after its inputs
    are made to one after it returns.  Returns (the warm-up's whole
    seconds, inputs included; the best run's seconds; its output)."""
    def timed():
        inputs = make_inputs()
        _sync(device)
        t0 = time.perf_counter()
        out = run(*inputs)
        _sync(device)
        return time.perf_counter() - t0, out

    t0 = time.perf_counter()
    timed()
    warmup = time.perf_counter() - t0
    best, out = min((timed() for _ in range(repeats)), key=lambda t: t[0])
    return warmup, best, out


def bench_batched_1d(
    pidx: PathIndex, batch: int = 262_144, rounds: int = 50,
    repeats: int = 3, *, device="cuda",
) -> dict:
    """Time the batched engine (``ops/sgd.build_1d_runner``) end to end
    on ``device``.  Returns rates in updates/s; ``warmup_s`` is the
    first run's seconds."""
    import torch

    from .device import resolve_device
    from .ops.keys import key_data
    from .ops.sgd import build_1d_runner

    dev = resolve_device(device)
    params = bench_params(pidx, batch, rounds)
    run, make_x0, _n = build_1d_runner(pidx, params, device=dev)
    key = key_data(params.seed)
    warmup, best, x = _timed_runs(lambda: (make_x0(), key), run, dev,
                                   repeats)
    total_updates = batch * rounds
    return {
        "seconds": best,
        "updates": total_updates,
        "updates_per_s": total_updates / best,
        "final_finite": bool(torch.isfinite(x).all()),
        "batch": batch,
        "rounds": rounds,
        "warmup_s": warmup,
    }


def bench_sweep_1d(
    pidx: PathIndex, rounds: int = 50, repeats: int = 3,
    per_octave: Optional[int] = None, consensus_every: Optional[int] = None,
    active_frac: Optional[float] = None, rotate=None,
    dense_upto: Optional[int] = None, proposals: Optional[int] = None,
    *, device="cuda",
) -> dict:
    """Time the 1D sweep engine (throughput mode: ``rounds`` sweeps of
    one iteration each) on ``device``.  The runner is built once; each
    run starts from a fresh state and is timed from one synchronisation
    to the next; ``warmup_s`` is the first run's seconds."""
    import torch

    from .device import resolve_device
    from .ops.keys import key_data
    from .ops.sweep import build_sweep_runner
    from .ops.sweep_policy import auto_sweep_config

    dev = resolve_device(device)
    p = bench_params(pidx, 1, 1)
    S = pidx.total_steps
    N = pidx.num_nodes
    frac = (active_frac if active_frac is not None
            else auto_sweep_config(S, N)["active_frac"])
    ups = max(1, int(S * frac))
    p = replace(p, iter_max=rounds - 1, min_term_updates=ups)

    run, arrays, make_state, info = build_sweep_runner(
        pidx, p, per_octave=per_octave, consensus_every=consensus_every,
        active_frac=frac, rotate=rotate, dense_upto=dense_upto,
        proposals=proposals, device=dev,
    )
    key = key_data(p.seed)
    warmup, best, x = _timed_runs(
        lambda: (*make_state(), key, *arrays), run, dev, repeats)
    updates = info["n_sweeps"] * info["updates_per_sweep"]
    return {
        "seconds": best,
        "updates": updates,
        "updates_per_s": updates / best,
        "sweeps": info["n_sweeps"],
        "final_finite": bool(torch.isfinite(x).all()),
        "active_frac": frac,
        # the knobs in effect after the runner's adjustments (rotate
        # resolved, ce fitted and rounded up to whole rotations)
        "consensus_every_eff": info["consensus_every"],
        "rotate_eff": info["rotate"],
        "proposals": info.get("proposals", 1),
        "consensus": info.get("consensus"),
        "consensus_coverage": (round(info["consensus_coverage"], 4)
                               if info.get("consensus_coverage") is not None
                               else None),
        "kernel_buckets_per_phase": info.get("kernel_buckets_per_phase"),
        "xla_buckets_per_phase": info.get("xla_buckets_per_phase"),
        "warmup_s": warmup,
    }


def roofline_model(rate: float, info: dict, applied_frac: float,
                   consensus_ms: float) -> dict:
    """HBM bytes and f32 operations per update of the 1D sweep engine at
    a measured ``rate`` (pair-proposals/s), against the H100 peaks
    ``HBM_BYTES_S`` and ``F32_OPS_S``.

    The per-element-per-sweep counts are the JAX model's
    (``gfasort_tpu/bench_util.py::roofline_model``), which count the
    passes the port makes too (P = proposals per sweep):

    HBM bytes:
      * sampler: read rank+cnt (8), write P choices (4P)       = 8 + 4P
      * bucket kernel (k <= KMAX): read xs/pos (8) + P choices
        (4P), write dsum/csum (8)                              = 16 + 4P
      * roll passes (k > KMAX, the JAX "XLA" buckets): re-read
        xs + P choices at 2 alignments (8 + 8P), term distances
        8 per bucket, dsum/csum read+write (16)                = 24 + 8P + 8·n_roll
      * combine: read xs/dsum/csum, write xs                    = 16
    Operations (f32 ALU ops; the ``vpu_*`` keys keep the JAX names and
    read as f32 ALU operations on this card):
      * sampler: ~76 shared + ~114 per proposal (155 at P = 1)
      * bucket kernel: (62 + 8P) per bucket
      * roll pass: (42 + 8P) per bucket
      * combine: ~10

    The consensus is accounted as measured time: ``consensus_ms`` is one
    consensus run's milliseconds on the same device (no default: it is
    measured where the rate is), amortised over ``consensus_every``
    sweeps."""
    n_kern = float(info.get("kernel_buckets_per_phase") or 0.0)
    n_xla = float(info.get("xla_buckets_per_phase") or 0.0)
    ce = max(int(info.get("consensus_every_eff")
                 or info.get("consensus_every") or 1), 1)
    frac = float(info.get("active_frac") or 1.0)
    P = max(int(info.get("proposals") or 1), 1)

    bytes_pe = ((8 + 4 * P) + (16 + 4 * P)
                + (24 + 8 * P + 8 * n_xla if n_xla else 0) + 16)
    ops_pe = (76 + 114 * P if P > 1 else 155) \
        + (62 + 8 * P) * n_kern + (42 + 8 * P) * n_xla + 10
    # the rate counts proposals (P·S·frac per sweep); the per-element
    # costs do not depend on the density (masked passes), so the cost
    # per update is the per-element cost over frac·P
    bytes_pu = bytes_pe / max(frac * P, 1e-9)
    ops_pu = ops_pe / max(frac * P, 1e-9)

    bw_frac = bytes_pu * rate / HBM_BYTES_S
    vpu_frac = ops_pu * rate / F32_OPS_S
    ups = float(info.get("updates_per_sweep")
                or (info["updates"] / max(info.get("sweeps", 1), 1)
                    if "updates" in info else 1.0))
    t_sweep_s = ups / max(rate, 1.0)
    cons_frac = (consensus_ms * 1e-3 / ce) / max(t_sweep_s, 1e-12)
    binding = "vpu" if vpu_frac >= bw_frac else "hbm"
    ceiling = (F32_OPS_S / ops_pu if binding == "vpu"
               else HBM_BYTES_S / bytes_pu)
    return {
        "bytes_per_update": round(bytes_pu, 1),
        "vpu_ops_per_update": round(ops_pu, 1),
        "achieved_bw_frac": round(bw_frac, 4),
        "vpu_frac": round(vpu_frac, 4),
        "consensus_time_frac": round(cons_frac, 4),
        "applied_updates_frac": round(applied_frac, 4),
        "binding": binding,
        "implied_ceiling_updates_per_s": round(ceiling, 1),
        "model": "gfasort_tpu_torch.bench_util.roofline_model",
    }


def measure_applied_frac(pidx: PathIndex, rounds: int = 24, *,
                         device="cuda", **cfg) -> dict:
    """Fraction of the proposed pair updates the 1D sweep engine applies
    under ``cfg`` (the ``bench_sweep_1d`` schedule of ``rounds``
    sweeps), replayed exactly by ``ops.sweep.build_applied_counter``
    with the engine's keys on ``device``."""
    from .ops.keys import key_data
    from .ops.sweep import build_applied_counter
    from .ops.sweep_policy import auto_sweep_config

    p = bench_params(pidx, 1, 1)
    S, N = pidx.total_steps, pidx.num_nodes
    frac = cfg.get("active_frac")
    if frac is None:
        frac = auto_sweep_config(S, N)["active_frac"]
        cfg = dict(cfg, active_frac=frac)
    ups = max(1, int(S * frac))
    p = replace(p, iter_max=rounds - 1, min_term_updates=ups)
    count_fn, arrays, info = build_applied_counter(pidx, p, device=device,
                                                   **cfg)
    res = count_fn(key_data(p.seed), *arrays)
    applied, proposed = res["applied"], res["proposed_actual"]
    # the scheduled denominator: the counter's executed sweeps (whole
    # consensus periods) at the expected S·active_frac per sweep;
    # ``proposed_actual`` is the replay's exact activation count
    executed = info["total_exec_sweeps"] * info["updates_per_sweep"]
    return {
        "applied": applied,
        "proposed_actual": proposed,
        "proposed_scheduled": executed,
        "applied_frac": applied / max(proposed, 1),
        "applied_vs_scheduled": applied / max(executed, 1),
        "total_exec_sweeps": info["total_exec_sweeps"],
        "n_sweeps": info["n_sweeps"],
    }


def bench_native_1d(pidx: PathIndex, n_updates: int = 2_000_000,
                    repeats: int = 3) -> Optional[dict]:
    """CPU baseline: the C++ sequential oracle's inner loop (the
    reference's per-update semantics at one thread), best of
    ``repeats`` passes.  None when the library cannot be built."""
    from .native import _p64, _pf64, available, load
    from .ops.fastpow import zeta_table

    if not available():
        return None
    lib = load()
    params = bench_params(pidx, 1, 1)
    sp = np.ascontiguousarray(pidx.step_path, dtype=np.int64)
    sr = np.ascontiguousarray(pidx.step_rank, dtype=np.int64)
    spos = np.ascontiguousarray(pidx.step_pos, dtype=np.int64)
    snode = np.ascontiguousarray(pidx.step_node_idx, dtype=np.int64)
    pf = np.ascontiguousarray(pidx.path_first, dtype=np.int64)
    pc = np.ascontiguousarray(pidx.path_count, dtype=np.int64)
    x = pidx.initial_positions().copy()
    zetas = zeta_table(
        params.space, params.space_max, params.space_quantization_step,
        params.theta,
    )
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        lib.sgd1d_bench(
            pidx.total_steps, _p64(sp), _p64(sr), _p64(spos), _p64(snode),
            _p64(pf), _p64(pc),
            _pf64(x), n_updates, float(params.eta_max), params.theta,
            params.space, params.space_max, params.space_quantization_step,
            42, _pf64(zetas), len(zetas),
        )
        best = min(best, time.perf_counter() - t0)
    return {"seconds": best, "updates": n_updates,
            "updates_per_s": n_updates / best, "repeats": repeats}


def bench_native_1d_mt(
    workload: tuple = (1_000_000, 16, 250_000),
    n_updates_each: int = 2_000_000,
    n_workers: Optional[int] = None,
) -> Optional[dict]:
    """Multi-core CPU baseline: ``n_workers`` spawned processes each run
    the C++ oracle's loop at once on their own copy of the synthetic
    workload (the reference runs Hogwild over all cores).  Each worker
    owns its positions, so this counts compute and memory-bandwidth
    contention but not Hogwild's shared-array cache traffic: a generous
    estimate of the reference's all-core rate."""
    import concurrent.futures
    import multiprocessing
    import os

    from .native import available

    if not available():
        return None
    n_workers = n_workers or os.cpu_count() or 1

    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            n_workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = [
            ex.submit(_native_bench_worker, workload, n_updates_each)
            for _ in range(n_workers)
        ]
        rates = [f.result() for f in futs]
    wall = time.perf_counter() - t0
    total = n_updates_each * n_workers
    return {
        # the sum of the workers' rates (each times only its own loop;
        # the loops overlap, so contention is counted): vs_baseline_mt's
        # denominator
        "updates_per_s": float(np.sum(rates)),
        "updates_per_s_wall": total / wall,  # with start-up and set-up
        "updates": total,
        "seconds": wall,
        "n_workers": n_workers,
        "per_worker_median": float(np.median(rates)),
    }


def _native_bench_worker(workload: tuple, n_updates: int) -> float:
    pidx = synthetic_path_index(*workload, seed=0)
    r = bench_native_1d(pidx, n_updates)
    return r["updates_per_s"] if r else 0.0


def sweep_quality_vs_oracle(
    n_nodes: int = 100_000,
    n_paths: int = 4,
    steps_per_path: int = 100_000,
    iter_max: int = 30,
    *,
    device="cuda",
    **sweep_kw,
) -> Optional[dict]:
    """Certificate of a 1D sweep configuration: run it (``sweep_kw``)
    through a full schedule of ``iter_max`` iterations on ``device`` on
    the seed-7 synthetic workload, and compare its node order with the
    C++ oracle's on the same workload.  None when the oracle cannot be
    built."""
    from .native import available, path_linear_sgd_native
    from .ops.sweep import path_linear_sgd_sweep

    if not available():
        return None
    pidx = synthetic_path_index(n_nodes, n_paths, steps_per_path, seed=7)
    p = PathSGDParams().derive_from_graph(pidx)
    p = replace(p, iter_max=iter_max, dtype="float32", pow_mode="fast")

    x_sweep = path_linear_sgd_sweep(None, p, pidx, device=device, **sweep_kw)
    po = replace(p, dtype="float64", pow_mode="fpp")
    x_oracle = path_linear_sgd_native(None, po, pidx)

    q = rank_quality(np.argsort(x_sweep, kind="stable"),
                     np.argsort(x_oracle, kind="stable"))
    q["n_nodes"] = n_nodes
    q["iter_max"] = iter_max
    return q


def bench_sweep_nd(
    pidx: PathIndex, dims: int = 2, rounds: int = 48, repeats: int = 3,
    consensus_every: Optional[int] = None, rotate=None,
    active_frac: Optional[float] = None,
    dense_upto: Optional[int] = None, proposals: Optional[int] = None,
    *, device="cuda",
) -> dict:
    """Time the nD layout sweep engine on ``device`` (``rounds`` sweeps
    of one iteration each), as :func:`bench_sweep_1d` times the 1D one."""
    import torch

    from .device import resolve_device
    from .ops.exact import layout_initial_coords
    from .ops.keys import key_data
    from .ops.sweep_nd import build_sweep_nd_runner
    from .ops.sweep_policy import auto_sweep_config
    from .params import LayoutSGDParams

    dev = resolve_device(device)
    lp = LayoutSGDParams().derive_from_graph(pidx, dims)
    S = pidx.total_steps
    N = pidx.num_nodes
    frac = (active_frac if active_frac is not None
            else auto_sweep_config(S, N, layout=True)["active_frac"])
    ups = max(1, int(S * frac))
    lp = replace(lp, iter_max=rounds - 1, min_term_updates=ups,
                 dtype="float32", pow_mode="fast")

    run, arrays, make_state, info = build_sweep_nd_runner(
        pidx, lp, consensus_every=consensus_every, active_frac=frac,
        rotate=rotate, dense_upto=dense_upto, proposals=proposals,
        device=dev,
    )
    init = layout_initial_coords(pidx, dims, lp.seed)
    key = key_data(lp.seed)
    warmup, best, xn = _timed_runs(
        lambda: (*make_state(init), key, *arrays), run, dev, repeats)
    updates = info["n_sweeps"] * info["updates_per_sweep"]
    return {
        "seconds": best,
        "updates": updates,
        "updates_per_s": updates / best,
        "sweeps": info["n_sweeps"],
        "dims": dims,
        "final_finite": bool(torch.isfinite(xn).all()),
        "consensus_every_eff": info["consensus_every"],
        "rotate_eff": info["rotate"],
        "proposals": info.get("proposals", 1),
        "warmup_s": warmup,
    }


def layout_quality_vs_oracle(
    n_nodes: int = 20_000,
    n_paths: int = 4,
    steps_per_path: int = 20_000,
    dims: int = 2,
    *,
    device="cuda",
    engine: str = "sweep",
    mesh=None,
    dtype: str = "float32",
    **sweep_kw,
) -> Optional[dict]:
    """Layout certificate: sampled stress of the port's layout vs the C++
    oracle layout on the same workload and from the same initial
    coordinates.  ``engine``: ``"sweep"`` (``dtype``, f32 by default, or
    f64; ``pow_mode="fast"``, ``sweep_kw`` passed on), ``"sweep-sharded"``
    (the same on ``mesh``, by default ``default_mesh`` on ``device``) or
    ``"batched"`` (f32 states, the engine's default ``pow_mode="fpp"``).
    None when the C++ oracle cannot be built."""
    from .native import available, path_linear_sgd_layout_native
    from .ops.exact import calculate_layout_stress_pidx, layout_initial_coords
    from .ops.sweep_nd import path_linear_sgd_layout_sweep
    from .params import LayoutSGDParams

    if not available():
        return None
    pidx = synthetic_path_index(n_nodes, n_paths, steps_per_path, seed=11)
    lp = LayoutSGDParams().derive_from_graph(pidx, dims)
    lp = replace(lp, dtype=dtype, pow_mode="fast")
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


def gather_consensus_ms(pidx: PathIndex, *, device="cuda",
                        reps: int = 20) -> float:
    """Milliseconds of one run of the 1D engine's gather consensus on
    ``pidx`` (f32 [S], the runner's tables) on ``device``: CUDA events
    on the card (:func:`cuda_ms`), the host clock on the CPU."""
    import torch

    from .device import resolve_device
    from .ops.node_sum import JAX_ROW_RUN, build_gather_consensus

    dev = resolve_device(device)
    gc = build_gather_consensus(pidx.step_node_idx, pidx.num_nodes, dev,
                                run=JAX_ROW_RUN)
    xs = torch.from_numpy(
        pidx.initial_positions().astype(np.float32)[pidx.step_node_idx]).to(dev)
    if dev.type == "cuda":
        return cuda_ms(lambda: gc(xs), reps)
    gc(xs)
    t0 = time.perf_counter()
    for _ in range(reps):
        gc(xs)
    return (time.perf_counter() - t0) * 1e3 / reps


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


# cycles of ``torch.cuda._sleep`` ahead of each ``device_ms`` window:
# ~1 ms at the H100's 1,980 MHz, far longer than the host takes to
# enqueue one window's calls
SLEEP_CYCLES = 2_000_000
# bytes read ahead of a cold ``device_ms`` window: five times the H100's
# 50 MB L2, which then holds none of the timed call's data and no dirty
# line to write back during it
FLUSH_BYTES = 256 << 20
# back-to-back calls in a warm ``device_ms`` window
WARM_CALLS = 20


def device_ms(fn, reps: int = 20, warm: bool = False) -> float:
    """Median device milliseconds of one call of ``fn``, the host's
    launch path left out.  In each of ``reps`` windows the stream first
    sleeps (``torch.cuda._sleep``) while the host enqueues the rest:
    cold, a read of ``FLUSH_BYTES``, then two CUDA events around one
    call; warm, one call, then two events around ``WARM_CALLS`` calls
    back to back (their inputs L2-resident where they fit).  A window
    counts only where the stream had not reached an event enqueued just
    before the timed calls by the time the host had enqueued them all,
    so no host gap lies between the events; otherwise the sleep doubles
    and the window is taken again (raises after six doublings)."""
    import torch

    for _ in range(2):
        fn()
    flush = None if warm else torch.ones(FLUSH_BYTES // 4, device="cuda")
    calls = WARM_CALLS if warm else 1
    cycles, ms = SLEEP_CYCLES, []
    while len(ms) < reps:
        guard = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        if warm:
            fn()
        else:
            flush.sum()
        guard.record()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        gap = guard.query()   # the stream caught up with the host
        torch.cuda.synchronize()
        if gap:
            cycles *= 2
            if cycles > SLEEP_CYCLES << 6:
                raise RuntimeError("device_ms: the host could not enqueue "
                                   "a window within the sleep")
            continue
        ms.append(start.elapsed_time(end) / calls)
    return float(np.median(ms))


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


def edge_phase(pidx, params, offs):
    """A rotation phase over the offsets ``offs`` with the Zipf constants
    the plans give them, every bucket a roll bucket: the sampler's and
    the roll kernels' edge cases (a full 64-offset table, a cut set
    whose largest offset lies below most jump spaces)."""
    from .ops.fastpow import zeta_table
    from .ops.sweep_plan import COOL_THETA, PhasePlan, bucket_consts

    offs = np.asarray(offs, dtype=np.int32)
    zetas = zeta_table(params.space, params.space_max,
                       params.space_quantization_step, params.theta)
    warm = bucket_consts(offs, params, zetas, float(params.theta))
    cool = bucket_consts(offs, params, zetas, COOL_THETA)
    return PhasePlan(
        offs=offs, kernel_buckets=(),
        roll_buckets=tuple((int(k), ki) for ki, k in enumerate(offs.tolist())),
        zeta=np.array([warm[0], cool[0]]), eta_z=np.array([warm[1], cool[1]]),
        zeta2theta=np.array([warm[2], cool[2]]),
        theta=np.array([float(params.theta), COOL_THETA]),
        space=int(params.space))


def wide_offsets(pidx, params, K: int = 64) -> np.ndarray:
    """K offsets spread over the whole jump range (the largest table the
    sampler kernel takes at K = 64): every ``len / K``-th of the
    log-spaced set with 8 per octave above 16, its ends included."""
    from .ops.sweep_policy import offset_set

    max_jump = max(1, min(int(params.space), pidx.max_path_step_count - 1))
    full = offset_set(max_jump, 8, 16)
    if len(full) < K:
        raise ValueError(f"{len(full)} offsets below {max_jump}, fewer than {K}")
    return full[np.linspace(0, len(full) - 1, K).round().astype(np.int64)]


# The sampler's routes: (name suffix, ``GFASORT_SWEEP_RNG``, dtype).  The
# hash route at f32 is the default; threefry draws at f32 and every f64
# run (always threefry) take the threefry kernel.
SAMPLER_ROUTES = (("", "hash", "float32"), ("_threefry", "threefry", "float32"),
                  ("_f64", "hash", "float64"))


def sampler_cases(pidx, plans, dev, routes=SAMPLER_ROUTES):
    """The sampler kernel's cases on ``pidx`` (its real rank and cnt):
    the 1D plan's P (``plans["1d"]``), the 2D and 3D layout plans'
    (``plans[2]``, ``plans[3]``) with the end coin, and P = 1, each on
    plan phases 0 and 1, warm and cooling, active fraction 1.0 and 0.6,
    snap stoch and down; then the edges, each warm and cooling with both
    snaps: P = 5 with the coin (three unused fields), a 64-offset table
    (``wide_offsets``) and phase 0's offsets cut to their first half (z
    past the last offset: promotions to oidx = K).  All of them on every
    route of ``routes`` (``SAMPLER_ROUTES``: hash f32, threefry f32 and
    f64, the names suffixed "", "_threefry" and "_f64"), the threefry
    routes from the ``threefry_key_table`` of the same keys.  One dict
    per case: ``name``, ``route`` (the suffix's route: "hash",
    "threefry" or "f64"), ``phase_of_plan``, ``P``, ``coin``,
    ``cooling``, ``frac``, ``snap``, ``K``, ``main`` (the case each name
    is timed at: its first phase, warm, fraction 1, stoch) and ``args``
    for ``sample_words`` (the last one its ``rng``)."""
    import torch

    from .ops.keys import key_data
    from .ops.sweep_common import route_keys, sampler_consts
    from .params import PathSGDParams

    rank = torch.from_numpy(pidx.step_rank.astype(np.int32)).to(dev)
    cnt = torch.from_numpy(pidx.step_count_of_step.astype(np.int32)).to(dev)
    p1d = plans["1d"]
    ph0 = p1d.phases[0]
    params = PathSGDParams().derive_from_graph(pidx)
    K0 = len(ph0.offs)
    wide = edge_phase(pidx, params, wide_offsets(pidx, params))
    cut = edge_phase(pidx, params, ph0.offs[: K0 // 2])
    grid = [(c, f, s) for c in (False, True) for f in (1.0, 0.6)
            for s in ("stoch", "down")]
    edge_grid = [(c, 1.0, s) for c in (False, True) for s in ("stoch", "down")]
    groups = [
        ("1d", p1d.proposals, False, (0, 1), p1d.phases, grid),
        ("2d", plans[2].proposals, True, (0, 1), plans[2].phases, grid),
        ("3d", plans[3].proposals, True, (0, 1), plans[3].phases, grid),
        ("p1", 1, False, (0, 1), p1d.phases, grid),
        ("p5", 5, True, (0,), p1d.phases, edge_grid),
        ("k64", 12, False, ("k64",), {"k64": wide}, edge_grid),
        ("past_last", 12, False, ("cut",), {"cut": cut}, edge_grid),
    ]
    for suffix, rng, dtype in routes:
        tdt = getattr(torch, dtype)
        route = "f64" if dtype == "float64" else rng
        for name, P, coin, ph_ids, phases, cases in groups:
            key_words = route_keys(key_data(7), 1, P, rng, tdt)[0]
            for n_ph, ph_i in enumerate(ph_ids):
                for n_c, (cooling, frac, snap) in enumerate(cases):
                    consts = sampler_consts(phases[ph_i], cooling, dev, tdt)
                    yield dict(name=name + suffix, route=route,
                               phase_of_plan=ph_i, P=P, coin=coin,
                               cooling=cooling, frac=frac, snap=snap,
                               K=len(phases[ph_i].offs),
                               main=n_ph == 0 and n_c == 0,
                               args=(consts, key_words, cooling, rank, cnt,
                                     frac, snap, rng))


def roll_cases(pidx, plans, dev, f64: bool = True):
    """The roll kernels' cases on ``pidx``, from the sampler's words and
    the bucket kernels' sums: 1D at the 1D plan's P, 2D and 3D at the
    layout plans', each on plan phases 0 and 1 and on phase 0 with every
    bucket a roll bucket (as under ``GFASORT_DENSE_KERNEL=xla``); then
    the 1D, 2D and 3D edge: P = 5 words (three unused fields, 0) with
    roll buckets k > S / 2 at ki = 0, k = S + 7 and k = 2S + 3 (partners
    read mod S) and phase 0's kernel buckets; and in 3D plan phase 1 at
    P = 8 (``"1_p8"``: the sharded 3D layout's two words, its engine
    having no proposal clamp).  Then, with ``f64``, the f64 route's
    cases in 1D, 2D and 3D (f64 state, the f64 sampler's words, every
    bucket a roll bucket as the f64 plans have them): plan phases 0 and 1
    (``"f64_0"``, ``"f64_1"``), the edge (``"f64_edge"``: P = 5,
    phase 0's buckets and the far ones) and phase 0 with its farthest
    bucket fifth (``"f64_order"``: short buckets after a long one).  One
    dict per case: ``dims``, ``phase_of_plan``, ``P``, ``kb``, ``rb``,
    ``kernel`` ("roll_apply" or "roll_apply_nd"), ``dtype`` ("float32"
    or "float64"), ``words_in`` / ``words_out`` (the 4-byte words per
    step each input and output holds, for the byte bound) and ``args``
    for ``roll_apply`` / ``roll_apply_nd``."""
    import torch

    from .convert import layout_static_arrays
    from .ops.keys import key_data
    from .ops.sweep_common import route_keys, sample_words, sampler_consts
    from .ops.sweep_dense import bucket_apply, dense_apply_nd
    from .ops.sweep_nd import chosen_ends

    S = pidx.total_steps
    rng = np.random.default_rng(3)
    pos, rank, cnt, rev, length = layout_static_arrays(pidx, dev)
    edge_rb = ((S // 2 + 12_345, 0), (S + 7, 1), (2 * S + 3, 2))

    def phases(plan, P, dims):
        for ph_i in (0, 1):
            ph = plan.phases[ph_i]
            yield ph_i, ph, P, ph.kernel_buckets, ph.roll_buckets
        ph = plan.phases[0]
        yield "0_all", ph, P, (), tuple(sorted(
            ph.kernel_buckets + ph.roll_buckets, key=lambda b: b[1]))
        yield "edge", ph, 5, ph.kernel_buckets, edge_rb
        if dims == 3:
            ph = plan.phases[1]
            yield "1_p8", ph, 8, ph.kernel_buckets, ph.roll_buckets

    def all_rolled(ph):
        return tuple(sorted(ph.kernel_buckets + ph.roll_buckets,
                            key=lambda b: b[1]))

    def f64_phases(plan, P, dims):
        for ph_i in (0, 1):
            ph = plan.phases[ph_i]
            yield f"f64_{ph_i}", ph, P, (), all_rolled(ph)
        ph = plan.phases[0]
        yield "f64_edge", ph, 5, (), all_rolled(ph) + edge_rb
        # the farthest bucket moved after the first four: the short ones
        # behind it run on the long path
        rb = all_rolled(ph)
        yield "f64_order", ph, P, (), rb[:4] + rb[-1:] + rb[4:-1]

    def n_words(P):
        return 1 if P == 1 else -(-P // 4)

    # the f32 cases, then the f64 route's from a generator of their own
    routes = [("float32", phases, rng)]
    if f64:
        routes.append(("float64", f64_phases, np.random.default_rng(4)))
    p1d = plans["1d"]
    for dtype, route_phases, rng in routes:
        tdt = getattr(torch, dtype)
        w = 2 if dtype == "float64" else 1     # 4-byte words per value

        def key_rows(seed, P):
            # f64 draws threefry bits: the threefry_key_table of the keys
            return route_keys(key_data(seed), 1, P, "hash", tdt)[0]

        pos_t, len_t = pos.to(tdt), length.to(tdt)
        xs = torch.from_numpy(rng.standard_normal(S) * 100).to(tdt).to(dev)
        eta = float(p1d.sweep_eta[0])
        for ph_i, ph, P, kb, rb in route_phases(p1d, p1d.proposals, 1):
            words, _ = sample_words(sampler_consts(ph, False, dev, tdt),
                                    key_rows(5, P), False, rank, cnt, 1.0)
            sums = (bucket_apply(xs, pos_t, words, eta, kb, P) if kb
                    else (None, None))
            # xs, pos, dsum, csum and the words in, xs out
            yield dict(dims=1, phase_of_plan=ph_i, P=P, kb=kb, rb=rb,
                       kernel="roll_apply", dtype=dtype,
                       words_in=w * (2 + 2 * bool(kb)) + n_words(P),
                       words_out=w, args=(xs, pos_t, words, eta, rb, P, *sums))
            del words, sums
        del xs
        for D in (2, 3):
            plan = plans[D]
            eta = float(plan.sweep_eta[0])
            cs = torch.from_numpy(np.concatenate([
                bench_layout_coords(rng, pidx.step_pos.astype(np.float32), D)
                for _ in range(2)])).to(tdt).to(dev)
            for ph_i, ph, P, kb, rb in route_phases(plan, plan.proposals, D):
                words, coin = sample_words(sampler_consts(ph, False, dev, tdt),
                                           key_rows(6, P), False, rank, cnt, 1.0,
                                           coin=True)
                my_pos, lane0, my_c = chosen_ends(cs, pos_t, len_t, rev, coin)
                sums = (dense_apply_nd(my_pos, words, my_c, eta, kb, P) if kb
                        else (None, None))
                # my_pos, my_c, lane0's byte, cs, acc, wacc and the words
                # in, cs out
                yield dict(dims=D, phase_of_plan=ph_i, P=P, kb=kb, rb=rb,
                           kernel="roll_apply_nd", dtype=dtype,
                           words_in=(w * (1 + D + 2 * D + (D + 1) * bool(kb))
                                     + 0.25 + n_words(P)),
                           words_out=w * 2 * D,
                           args=(my_pos, my_c, lane0, cs, words, eta, rb, P,
                                 *sums))
                del words, coin, my_pos, lane0, my_c, sums
            del cs
        del pos_t, len_t
