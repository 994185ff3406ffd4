"""The 1D offset-sweep engine in PyTorch.

Counterpart of ``gfasort_tpu/ops/sweep.py`` (same signatures and return
contracts, plus ``device=``).  State lives in step space: ``xs[s]`` is
the position of step ``s``.  One sweep draws P partner proposals per
step (``sweep_common.sample_blocks``), applies the pair updates of every
bucket with k <= KMAX in one bucket-apply kernel launch, the larger
offsets by roll passes, and combines ``xs + dsum / max(csum, 1)``.
Every ``consensus_every`` sweeps the node consensus averages the steps
of each node.  The schedule runs eagerly from Python.  The JAX engine's
dk tables were a TPU workaround that changes no result, and are not
ported.  Its dispatch chunking is not ported either, but it does change
results: the JAX engine executes whole dispatches of consensus periods,
so where the chunk does not divide the periods it runs more sweeps (at
the terminal eta) and more consensus runs.  The plan reproduces that
count (``SweepPlan.n_exec``).  At float64 every bucket runs as a roll
pass, the sampler draws threefry bits and works in f64, and the
consensus sums in f64, as in the JAX engine.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..convert import initial_state, static_arrays
from ..device import resolve_device
from ..graph import BidirectedGraph
from ..index import PathIndex
from ..params import PathSGDParams
from . import runner_cache
from .keys import key_data, sweep_key_table
from .node_sum import JAX_ROW_RUN, build_gather_consensus
from .sweep_common import (SamplerConsts, pack_choices_words, sample_blocks,
                           sampler_consts, sweep_rng)
from .sweep_dense import bucket_apply
from .sweep_plan import PhasePlan, make_sweep_plan, torch_dtype
from .sweep_policy import SweepResult

__all__ = ["apply_choices", "build_sweep_runner", "path_linear_sgd_sweep",
           "path_sgd_sort_sweep", "sweep_once"]


def _roll_half(xs, pos, eta_t, shift: int, pairs, iota):
    """Contribution received at each step from the pair (t, t + shift)
    for an offset above KMAX.  ``pairs``: per proposal, (my mask, the
    rolled partner mask); the wrap-around of the roll is guarded on the
    partner mask only — my own choice is in-path by construction."""
    S = xs.shape[0]
    xs_o = torch.roll(xs, shift)
    guard = iota < S + shift if shift < 0 else iota >= shift
    w = None
    for w_mine, w_theirs in pairs:
        wb = (w_mine | (w_theirs & guard)).to(xs.dtype)
        w = wb if w is None else w + wb
    d = torch.abs(pos - torch.roll(pos, shift))
    valid = d != 0
    w = torch.where(valid, w, 0.0)
    safe = torch.where(valid, d, 1.0)
    mu = torch.clamp_max(eta_t / safe, 1.0)
    dx = xs - xs_o
    dx = torch.where(dx == 0, 1e-9, dx)
    mag = torch.abs(dx)
    half_sgn = torch.where(dx >= 0, 0.5, -0.5).to(xs.dtype)
    r_x = mu * (mag - safe) * half_sgn
    return -w * r_x, w


def sweep_once(xs, pos, rank, cnt, phase: PhasePlan, consts: SamplerConsts,
               key_words, eta: float, cooling: bool, proposals: int,
               active_frac: float, snap: str = "stoch", rng: str = "hash"):
    """One sweep; returns the new xs.  ``consts``: the phase's sampler
    constants for ``cooling``; ``key_words``: the sweep's ``(b2, b1)``
    words per proposal (a row of ``sweep_key_table``); ``rng``: the
    ``sweep_rng`` mode."""
    S = xs.shape[0]
    draws = (sweep_rng(w, S, xs.device, rng, xs.dtype) for w in key_words)
    sidxs = sample_blocks(consts, draws, cooling, rank, cnt, active_frac, snap)
    return apply_choices(xs, pos, sidxs, phase, eta, proposals)


def apply_choices(xs, pos, sidxs, phase: PhasePlan, eta: float,
                  proposals: int):
    """The pair updates of one sweep for the given choice arrays (one
    int32 [S] per proposal) and the combine; returns the new xs.  The
    bucket-apply kernel serves the phase's buckets with k <= KMAX, roll
    passes the rest."""
    S = xs.shape[0]
    if phase.kernel_buckets:
        words = sidxs[:1] if proposals == 1 else pack_choices_words(sidxs)
        dsum, csum = bucket_apply(xs, pos, words, eta, phase.kernel_buckets,
                                  proposals)
    else:
        dsum = torch.zeros_like(xs)
        csum = torch.zeros_like(xs)
    if phase.roll_buckets:
        iota = torch.arange(S, device=xs.device)
        eta_t = torch.full((), eta, dtype=xs.dtype, device=xs.device)
        for k, ki in phase.roll_buckets:
            # partner ahead (t+k): I chose +k, or they chose -k
            d1, w1 = _roll_half(xs, pos, eta_t, -k, [
                (s == ki, torch.roll(s, -k) == ~ki) for s in sidxs], iota)
            # partner behind (t-k): I chose -k, or they chose +k
            d2, w2 = _roll_half(xs, pos, eta_t, +k, [
                (s == ~ki, torch.roll(s, k) == ki) for s in sidxs], iota)
            dsum = dsum + d1 + d2
            csum = csum + w1 + w2
    return xs + dsum / torch.clamp_min(csum, 1.0)


def build_sweep_runner(
    pidx: PathIndex,
    params: PathSGDParams,
    per_octave: Optional[int] = None,
    consensus_every: Optional[int] = None,
    active_frac: Optional[float] = None,
    rotate=None,
    dense_upto: Optional[int] = None,
    proposals: Optional[int] = None,
    *,
    device="cuda",
):
    """Build the runner once.  Returns (run_fn, arrays, make_state, info):
    ``run_fn(xs, x_node_init, base_key, *arrays)`` runs the whole
    schedule and returns the final node positions [N] on the device;
    ``base_key`` is the u32 [2] key data (``ops.keys.key_data(seed)``).
    The environment knobs come from ``ops.env.sweep_knobs``, read once
    by the plan.  Under the warm-process server (GFASORT_RUNNER_CACHE=1)
    the whole built runner is memoized (:mod:`.runner_cache`)."""
    dev = resolve_device(device)
    ck = None
    if runner_cache.enabled():
        ck = ("sweep1d", runner_cache.fingerprint_pidx(pidx),
              runner_cache.params_key(params), runner_cache.env_key(),
              per_octave, consensus_every, active_frac, str(rotate),
              dense_upto, proposals, str(dev))
        hit = runner_cache.get(ck)
        if hit is not None:
            return hit
    plan = make_sweep_plan(pidx, params, per_octave, consensus_every,
                           active_frac, rotate, dense_upto, proposals)
    npd = np.dtype(plan.dtype).type
    tdt = torch_dtype(plan.dtype)
    gc = build_gather_consensus(pidx.step_node_idx, pidx.num_nodes, dev,
                                run=JAX_ROW_RUN, dtype=npd)
    arrays = static_arrays(pidx, dev, npd)
    # [phase][cooling]
    consts = [[sampler_consts(ph, c, dev, tdt) for c in (False, True)]
              for ph in plan.phases]
    ce = plan.consensus_every
    P = plan.proposals

    def run(xs, x_node_init, base_key, pos, rank, cnt):
        keys = sweep_key_table(base_key, plan.n_exec, P)
        xn = None
        for e in range(plan.n_exec):
            i, eta, cooling = plan.sweep(e)
            xs = sweep_once(xs, pos, rank, cnt, plan.phases[i],
                            consts[i][cooling], keys[e], eta, cooling, P,
                            plan.active_frac, plan.knobs.snap, plan.knobs.rng)
            if (e + 1) % ce == 0:
                xs, xn = gc(xs)
        return gc.to_node_order(xn, x_node_init)

    def make_state(x0=None):
        return initial_state(pidx, x0, dev, npd)

    info = dict(plan.info(), consensus="gather", consensus_coverage=None)
    built = (run, arrays, make_state, info)
    if ck is not None:
        runner_cache.put(ck, built)
    return built


def path_linear_sgd_sweep(
    graph: Optional[BidirectedGraph],
    params: PathSGDParams,
    pidx: Optional[PathIndex] = None,
    per_octave: Optional[int] = None,
    consensus_every: Optional[int] = None,
    active_frac: Optional[float] = None,
    rotate=None,
    dense_upto: Optional[int] = None,
    proposals: Optional[int] = None,
    x0: Optional[np.ndarray] = None,
    return_info: bool = False,
    *,
    device="cuda",
):
    """1D path SGD via offset sweeps: node positions [N] (f64 numpy),
    None when no path has two steps; same contract as the JAX
    ``path_linear_sgd_sweep``."""
    pidx = pidx or PathIndex.from_graph(graph)
    if pidx.num_nodes == 0:
        return np.zeros(0)
    if not pidx.has_multi_step_path():
        return None
    run, arrays, make_state, info = build_sweep_runner(
        pidx, params, per_octave, consensus_every, active_frac, rotate,
        dense_upto, proposals, device=device,
    )
    xs0, x_node0 = make_state(x0)
    x_final = run(xs0, x_node0, key_data(params.seed), *arrays)
    x = x_final.cpu().numpy().astype(np.float64)
    if return_info:
        return SweepResult(
            x=x, sweeps=info["n_sweeps"],
            updates_est=info["n_sweeps"] * info["updates_per_sweep"],
        )
    return x


def path_sgd_sort_sweep(graph: BidirectedGraph, params: PathSGDParams,
                        *, device="cuda", **kw):
    """Node order (forward handles) by the sweep engine's positions."""
    pidx = PathIndex.from_graph(graph)
    x = path_linear_sgd_sweep(graph, params, pidx, device=device, **kw)
    if x is None or len(x) == 0:
        return []
    order = np.argsort(x, kind="stable")
    return (np.asarray(pidx.node_ids)[order] << 1).tolist()
