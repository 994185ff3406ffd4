"""The nD layout sweep engine (the ``L`` step) in PyTorch.

Counterpart of ``gfasort_tpu/ops/sweep_nd.py`` (same signatures and
return contracts, plus ``device=``).  State is the per-step, per-end
coordinate block ``cs [2D, S]``: row ``e*D + d`` holds end ``e``'s
dimension ``d`` (end 0 = '+', 1 = '-').  One sweep draws P partner
proposals per step and its end coin from proposal 0's bits (one
sampler kernel launch), applies the Euclidean pair updates of every
bucket with k <= KMAX in one nD bucket-apply kernel launch, and the
larger offsets and the move of the chosen end's rows by
``acc / max(wacc, 1)`` in one roll kernel launch.  Every
``consensus_every`` sweeps the node consensus averages each (node, end,
dimension) row.  The schedule runs eagerly from Python, as in the 1D
engine, executing the sweeps the JAX engine's dispatch chunking
executes (``SweepPlan.n_exec``); ``build_sweep_nd_runner`` memoizes its
runners through :mod:`.runner_cache` (key ``"sweepnd"``), as the JAX
engine does.  As in the 1D engine, the sampler kernel draws threefry
bits under ``GFASORT_SWEEP_RNG=threefry`` and at float64, where every
bucket runs in the f64 roll kernel, as in the JAX engine.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..convert import layout_state, layout_static_arrays
from ..device import resolve_device
from ..graph import BidirectedGraph
from ..index import PathIndex
from ..io.layout_tsv import Layout
from ..params import LayoutSGDParams
from . import runner_cache
from .keys import key_data
from .node_sum import build_gather_consensus
from .roll_apply import roll_apply_nd
from .sweep_common import (SamplerConsts, route_keys, sample_words,
                           sampler_consts)
from .sweep_dense import dense_apply_nd
from .sweep_plan import PhasePlan, make_layout_plan, torch_dtype

__all__ = ["build_sweep_nd_runner", "chosen_ends", "nd_sweep_once",
           "path_linear_sgd_layout_sweep"]


def chosen_ends(cs, pos, length, rev, other_end):
    """(my_pos [S], lane0 bool [S], my_c [D, S]) of each step's chosen
    end.  ``other_end`` is the per-step end coin (proposal 0's bits): the
    other end moves the step's path position by its node's length, and
    the end index is coin XOR orientation."""
    D = cs.shape[0] // 2
    my_pos = torch.where(other_end, pos + length, pos)
    lane0 = torch.where(other_end, 1 - rev, rev) == 0
    return my_pos, lane0, torch.where(lane0, cs[:D], cs[D:])


def nd_sweep_once(cs, pos, rank, cnt, rev, length, phase: PhasePlan,
                  consts: SamplerConsts, key_words, eta: float, cooling: bool,
                  proposals: int, active_frac: float, snap: str = "stoch",
                  rng: str = "hash"):
    """One nD sweep; returns the new ``cs [2D, S]``.  ``consts``: the
    phase's sampler constants for ``cooling``; ``key_words``: the
    sweep's row of the run's ``sweep_common.route_keys``; ``snap``/``rng``: the
    sampler's snap and the ``sweep_rng`` mode.  As in the 1D
    ``sweep_once``, every route runs the sampler kernel and the roll
    kernel."""
    words, other_end = sample_words(consts, key_words, cooling, rank, cnt,
                                    active_frac, snap, rng, coin=True)
    my_pos, lane0, my_c = chosen_ends(cs, pos, length, rev, other_end)
    acc = wacc = None
    if phase.kernel_buckets:
        acc, wacc = dense_apply_nd(my_pos, words, my_c, eta,
                                   phase.kernel_buckets, proposals)
    return roll_apply_nd(my_pos, my_c, lane0, cs, words, eta,
                         phase.roll_buckets, proposals, acc, wacc)


def build_sweep_nd_runner(
    pidx: PathIndex,
    params: LayoutSGDParams,
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
    ``run_fn(cs, cs_node_init, base_key, *arrays)`` runs the whole
    schedule and returns the final node-end coordinates [2D, N] on the
    device; ``base_key`` is the u32 [2] key data
    (``ops.keys.key_data(seed)``); ``make_state(init_node_coords)`` maps
    [2N, D] node-end coordinates to ``(cs0 [2D, S], cs_node0 [2D, N])``.
    Knobs left as None take the shape-aware defaults of
    ``auto_sweep_config(layout=True)``.  Under the warm-process server
    (GFASORT_RUNNER_CACHE=1) the whole built runner is memoized
    (:mod:`.runner_cache`)."""
    dev = resolve_device(device)
    ck = None
    if runner_cache.enabled():
        ck = ("sweepnd", runner_cache.fingerprint_pidx(pidx),
              runner_cache.params_key(params), runner_cache.env_key(),
              int(params.dimensions), per_octave, consensus_every,
              active_frac, str(rotate), dense_upto, proposals, str(dev))
        hit = runner_cache.get(ck)
        if hit is not None:
            return hit
    plan = make_layout_plan(pidx, params, per_octave, consensus_every,
                            active_frac, rotate, dense_upto, proposals)
    npd = np.dtype(plan.dtype).type
    gc = build_gather_consensus(pidx.step_node_idx, pidx.num_nodes, dev,
                                dtype=npd)
    arrays = layout_static_arrays(pidx, dev, npd)
    # [phase][cooling]
    tdt = torch_dtype(plan.dtype)
    consts = [[sampler_consts(ph, c, dev, tdt) for c in (False, True)]
              for ph in plan.phases]
    ce = plan.consensus_every
    P = plan.proposals

    def run(cs, cs_node_init, base_key, pos, rank, cnt, rev, length):
        keys = route_keys(base_key, plan.n_exec, P, plan.knobs.rng, tdt)
        xn = None
        for e in range(plan.n_exec):
            i, eta, cooling = plan.sweep(e)
            cs = nd_sweep_once(cs, pos, rank, cnt, rev, length,
                               plan.phases[i], consts[i][cooling], keys[e],
                               eta, cooling, P, plan.active_frac,
                               plan.knobs.snap, plan.knobs.rng)
            if (e + 1) % ce == 0:
                cs, xn = gc(cs)
        return gc.to_node_order(xn, cs_node_init)

    def make_state(init_node_coords: np.ndarray):
        return layout_state(pidx, init_node_coords, plan.dims, dev, npd)

    built = (run, arrays, make_state, plan.layout_info())
    if ck is not None:
        runner_cache.put(ck, built)
    return built


def path_linear_sgd_layout_sweep(
    graph: Optional[BidirectedGraph],
    params: LayoutSGDParams,
    pidx: Optional[PathIndex] = None,
    per_octave: Optional[int] = None,
    consensus_every: Optional[int] = None,
    active_frac: Optional[float] = None,
    rotate=None,
    dense_upto: Optional[int] = None,
    proposals: Optional[int] = None,
    init_coords: Optional[np.ndarray] = None,
    *,
    device="cuda",
) -> Layout:
    """nD layout via offset sweeps; same contract as the JAX
    ``path_linear_sgd_layout_sweep``: an empty layout for an empty
    graph, the unset layout when no path has two steps."""
    pidx = pidx or PathIndex.from_graph(graph)
    n = pidx.num_nodes
    dims = params.dimensions
    if n == 0:
        return Layout(dims, 0)
    if not pidx.has_multi_step_path():
        return Layout(dims, n)

    if init_coords is None:
        from .exact import layout_initial_coords

        init_coords = layout_initial_coords(pidx, dims, params.seed)

    run, arrays, make_state, _ = build_sweep_nd_runner(
        pidx, params, per_octave, consensus_every, active_frac, rotate,
        dense_upto, proposals, device=device,
    )
    cs0, cs_node0 = make_state(init_coords)
    x_node = run(cs0, cs_node0, key_data(params.seed), *arrays)
    # [2D, N] rows -> [2N, D] node-end-major state
    xn = x_node.cpu().numpy().astype(np.float64)
    state = np.ascontiguousarray(
        xn.reshape(2, dims, n).transpose(2, 0, 1).reshape(2 * n, dims)
    )
    return Layout.from_state(state)
