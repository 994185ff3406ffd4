"""The 1D offset-sweep engine in PyTorch.

Counterpart of ``gfasort_tpu/ops/sweep.py`` (same signatures and return
contracts, plus ``device=``).  State lives in step space: ``xs[s]`` is
the position of step ``s``.  One sweep draws P partner proposals per
step and packs them (``sweep_common.sample_words``: one sampler kernel
launch), applies the pair updates of every bucket with k <= KMAX in one
bucket-apply kernel launch, and the larger offsets and the combine
``xs + dsum / max(csum, 1)`` in one roll kernel launch
(``roll_apply.roll_apply``).
Every ``consensus_every`` sweeps the node consensus averages the steps
of each node.  The schedule runs eagerly from Python.  The JAX engine's
dk tables were a TPU workaround that changes no result, and are not
ported.  Its dispatch chunking is not ported either, but it does change
results: the JAX engine executes whole dispatches of consensus periods,
so where the chunk does not divide the periods it runs more sweeps (at
the terminal eta) and more consensus runs.  The plan reproduces that
count (``SweepPlan.n_exec``).  Under ``GFASORT_SWEEP_RNG=threefry``, and
always at float64, the sampler kernel draws threefry bits from the run's
``keys.threefry_key_table``; at float64 it works in f64, every bucket
runs in the f64 roll kernel and the consensus sums in f64, as in the
JAX engine.

``build_applied_counter`` replays the sampler of a schedule, with the
engine's keys, and counts the pair updates the engine applies.
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
from .roll_apply import roll_apply
from .sweep_common import (INACTIVE, SamplerConsts, sample_blocks,
                           route_keys, sample_words, sampler_consts,
                           sweep_rng)
from .sweep_dense import bucket_apply
from .sweep_plan import PhasePlan, make_sweep_plan, torch_dtype
from .sweep_policy import SweepResult

__all__ = ["apply_choices", "build_applied_counter", "build_sweep_runner",
           "path_linear_sgd_sweep", "path_sgd_sort_sweep", "sweep_once"]


def sweep_once(xs, pos, rank, cnt, phase: PhasePlan, consts: SamplerConsts,
               key_words, eta: float, cooling: bool, proposals: int,
               active_frac: float, snap: str = "stoch", rng: str = "hash"):
    """One sweep; returns the new xs.  ``consts``: the phase's sampler
    constants for ``cooling``; ``key_words``: the sweep's row of the
    run's :func:`route_keys`; ``rng``: the ``sweep_rng`` mode.  Every
    route draws its words with ``sample_words`` (the sampler kernel on
    the card)."""
    words, _ = sample_words(consts, key_words, cooling, rank, cnt,
                            active_frac, snap, rng)
    return apply_choices(xs, pos, words, phase, eta, proposals)


def apply_choices(xs, pos, words, phase: PhasePlan, eta: float,
                  proposals: int):
    """The pair updates of one sweep for the given choice words (the raw
    int32 [S] choices for one proposal, else the packed words of
    ``sweep_common.pack_words``) and the combine; returns the new xs.
    The bucket-apply kernel serves the phase's buckets with k <= KMAX
    (none at f64), the roll kernel the rest and the combine."""
    dsum = csum = None
    if phase.kernel_buckets:
        dsum, csum = bucket_apply(xs, pos, words, eta, phase.kernel_buckets,
                                  proposals)
    return roll_apply(xs, pos, words, eta, phase.roll_buckets, proposals,
                      dsum, csum)


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
        keys = route_keys(base_key, plan.n_exec, P, plan.knobs.rng, tdt)
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


def build_applied_counter(
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
    """Exact count of the pair updates a sweep schedule applies, by a
    replay of its sampler (``gfasort_tpu/ops/sweep.py::
    build_applied_counter``).

    Whether a proposed pair is applied never depends on the positions:
    it depends on the sampler's choice (from the key and the static rank
    and cnt) and on the static path positions only (a pair at term
    distance 0 is skipped).  So the replay draws every sweep's choices
    with the engine's keys (``fold_in(base_key, e)``, per proposal
    ``fold_in(key, p)``), eta and cooling from the clamped index, on
    the route ``ops.env.sweep_knobs`` selects, and counts a +k choice at
    step t when ``pos[t] != pos[t + k]`` and a -k choice when
    ``pos[t] != pos[t - k]`` (indices modulo S, as the JAX counter's
    rolls; the sampler never chooses a partner outside the path).

    Returns (count_fn, arrays, info); ``count_fn(base_key, *arrays)`` ->
    ``{"applied": int, "proposed_actual": int}``, the latter the
    sampler's activations (choices != INACTIVE).  Both sum in int64 on
    the device.  The replay covers ``info["total_exec_sweeps"]``, the
    JAX counter's whole consensus periods (``n_periods * ce``): like it,
    it leaves out the dispatch padding the engines also execute
    (``SweepPlan.n_exec``)."""
    dev = resolve_device(device)
    plan = make_sweep_plan(pidx, params, per_octave, consensus_every,
                           active_frac, rotate, dense_upto, proposals)
    tdt = torch_dtype(plan.dtype)
    S = pidx.total_steps
    ce = plan.consensus_every
    total_exec = -(-plan.n_sweeps // ce) * ce
    consts = [[sampler_consts(ph, c, dev, tdt) for c in (False, True)]
              for ph in plan.phases]
    P = plan.proposals
    arrays = static_arrays(pidx, dev, np.dtype(plan.dtype).type)

    def count_fn(base_key, pos, rank, cnt):
        keys = sweep_key_table(base_key, total_exec, P)
        t = torch.arange(S, device=pos.device)
        applied = torch.zeros((), dtype=torch.int64, device=pos.device)
        proposed = torch.zeros_like(applied)
        for e in range(total_exec):
            i, _, cooling = plan.sweep(e)
            c = consts[i][cooling]
            draws = (sweep_rng(w, S, pos.device, plan.knobs.rng, pos.dtype)
                     for w in keys[e])
            for sidx in sample_blocks(c, draws, cooling, rank, cnt,
                                      plan.active_frac, plan.knobs.snap):
                active = sidx != int(INACTIVE)
                back = sidx < 0
                ki = torch.where(back, ~sidx, torch.where(active, sidx, 0))
                k = c.offs[ki].to(torch.int64)
                partner = torch.remainder(torch.where(back, t - k, t + k), S)
                proposed += active.sum()
                applied += (active & (pos[partner] != pos)).sum()
        return {"applied": int(applied), "proposed_actual": int(proposed)}

    info = {
        "n_sweeps": plan.n_sweeps,
        "total_exec_sweeps": total_exec,
        "updates_per_sweep": plan.updates_per_sweep,
        "proposed": plan.n_sweeps * plan.updates_per_sweep,
        "active_frac": plan.active_frac,
    }
    return count_fn, arrays, info


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
