"""The nD layout sweep engine (the ``L`` step) in PyTorch.

Counterpart of ``gfasort_tpu/ops/sweep_nd.py`` (same signatures and
return contracts, plus ``device=``).  State is the per-step, per-end
coordinate block ``cs [2D, S]``: row ``e*D + d`` holds end ``e``'s
dimension ``d`` (end 0 = '+', 1 = '-').  One sweep draws P partner
proposals per step, takes a per-step end coin from proposal 0's bits,
applies the Euclidean pair updates of every bucket with k <= KMAX in one
nD bucket-apply kernel launch and the larger offsets by roll passes, and
moves the chosen end's rows by ``acc / max(wacc, 1)``.  Every
``consensus_every`` sweeps the node consensus averages each (node, end,
dimension) row.  The schedule runs eagerly from Python, as in the 1D
engine, executing the sweeps the JAX engine's dispatch chunking
executes (``SweepPlan.n_exec``); its runner cache is not ported.  At
float64 every bucket runs as a roll pass and the sampler draws threefry
bits, as in the JAX engine.
"""

from __future__ import annotations

import itertools
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
from .keys import key_data, sweep_key_table
from .node_sum import build_gather_consensus
from .sweep_common import (SamplerConsts, pack_choices_words, sample_blocks,
                           sampler_consts, sweep_rng)
from .sweep_dense import dense_apply_nd, sqrt_rn
from .sweep_plan import PhasePlan, make_layout_plan, torch_dtype

__all__ = ["build_sweep_nd_runner", "nd_sweep_once",
           "path_linear_sgd_layout_sweep"]


def _roll_half_nd(my_pos, my_c, eta_t, shift: int, pairs, iota):
    """(acc [D, S], w [S]) received at each step from the pair
    (t, t + shift) for an offset above KMAX; the nD twin of the 1D
    engine's ``_roll_half`` (the wrap-around of the roll is guarded on
    the partner mask only)."""
    S = my_pos.shape[0]
    pos_o = torch.roll(my_pos, shift)
    c_o = torch.roll(my_c, shift, dims=1)
    guard = iota < S + shift if shift < 0 else iota >= shift
    w = None
    for w_mine, w_theirs in pairs:
        wb = (w_mine | (w_theirs & guard)).to(my_pos.dtype)
        w = wb if w is None else w + wb
    d = torch.abs(my_pos - pos_o)
    valid = d != 0
    w = torch.where(valid, w, 0.0)
    safe = torch.where(valid, d, 1.0)
    mu = torch.clamp_max(eta_t / safe, 1.0)
    deltas = my_c - c_o
    mag_sq = deltas[0] * deltas[0]
    for dim in range(1, my_c.shape[0]):
        mag_sq = mag_sq + deltas[dim] * deltas[dim]
    zero = mag_sq == 0
    deltas[0] = torch.where(zero, 1e-9, deltas[0])
    mag_sq = torch.where(zero, 1e-18, mag_sq)
    # 1 / sqrt for the JAX rsqrt, as in ops/sweep_dense.dense_apply_nd_ref
    inv = 1.0 / sqrt_rn(mag_sq)
    mag = mag_sq * inv
    r = torch.clamp_max(mu * (mag - safe) * 0.5 * inv, 1e30)
    return -(w * r) * deltas, w


def nd_sweep_once(cs, pos, rank, cnt, rev, length, phase: PhasePlan,
                  consts: SamplerConsts, key_words, eta: float, cooling: bool,
                  proposals: int, active_frac: float, snap: str = "stoch",
                  rng: str = "hash"):
    """One nD sweep; returns the new ``cs [2D, S]``.  ``consts``: the
    phase's sampler constants for ``cooling``; ``key_words``: the
    sweep's ``(b2, b1)`` words per proposal (a row of
    ``sweep_key_table``); ``snap``/``rng``: the sampler's snap and the
    ``sweep_rng`` mode."""
    S = pos.shape[0]
    D = cs.shape[0] // 2
    first = sweep_rng(key_words[0], S, cs.device, rng, cs.dtype)
    rest = (sweep_rng(w, S, cs.device, rng, cs.dtype) for w in key_words[1:])
    sidxs = sample_blocks(consts, itertools.chain([first], rest), cooling,
                          rank, cnt, active_frac, snap)
    # the per-step end coin, from proposal 0's bits: the other end moves
    # the step's path position by its node's length, and the end index
    # is coin XOR orientation
    other_end = ((first[0] >> 29) & 1) == 1
    del first
    my_pos = torch.where(other_end, pos + length, pos)
    lane0 = torch.where(other_end, 1 - rev, rev) == 0
    my_c = torch.where(lane0, cs[:D], cs[D:])

    if phase.kernel_buckets:
        words = sidxs[:1] if proposals == 1 else pack_choices_words(sidxs)
        acc, wacc = dense_apply_nd(my_pos, words, my_c, eta,
                                   phase.kernel_buckets, proposals)
    else:
        acc = torch.zeros_like(my_c)
        wacc = torch.zeros_like(my_pos)
    if phase.roll_buckets:
        iota = torch.arange(S, device=cs.device)
        eta_t = torch.full((), eta, dtype=cs.dtype, device=cs.device)
        for k, ki in phase.roll_buckets:
            # partner ahead (t+k): I chose +k, or they chose -k
            d1, w1 = _roll_half_nd(my_pos, my_c, eta_t, -k, [
                (s == ki, torch.roll(s, -k) == ~ki) for s in sidxs], iota)
            # partner behind (t-k): I chose -k, or they chose +k
            d2, w2 = _roll_half_nd(my_pos, my_c, eta_t, +k, [
                (s == ~ki, torch.roll(s, k) == ki) for s in sidxs], iota)
            acc = acc + d1 + d2
            wacc = wacc + w1 + w2
    # the chosen end is fixed for the whole sweep: its rows take the
    # mean update, the other end's rows are unchanged
    upd = acc / torch.clamp_min(wacc, 1.0)
    return torch.cat([cs[:D] + torch.where(lane0, upd, 0.0),
                      cs[D:] + torch.where(lane0, 0.0, upd)])


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
    consts = [[sampler_consts(ph, c, dev, torch_dtype(plan.dtype))
               for c in (False, True)] for ph in plan.phases]
    ce = plan.consensus_every
    P = plan.proposals

    def run(cs, cs_node_init, base_key, pos, rank, cnt, rev, length):
        keys = sweep_key_table(base_key, plan.n_exec, P)
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
