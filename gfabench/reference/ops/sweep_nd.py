"""The nD offset-sweep layout engine (the ``L`` step), plain PyTorch.

A frozen copy of ``gfasort_tpu_torch/ops/sweep_nd.py`` with every kernel
replaced by its plain version: the sampler with its end coin
(``sweep_common.sample_words``), the nD bucket pass
(``sweep_dense.dense_apply_nd_ref``) and the nD roll passes with the
per-end combine (``roll_apply.roll_apply_nd_ref``).  The state is
``cs [2D, S]``: row ``e*D + d`` holds end ``e``'s dimension ``d`` of every
step.  ``round_state`` as in :mod:`.sweep`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index import PathIndex
from ..params import LayoutSGDParams
from .keys import key_data, sweep_key_table
from .layout_init import layout_initial_coords
from .node_sum import build_gather_consensus
from .roll_apply import roll_apply_nd_ref
from .sweep_common import sample_words, sampler_consts
from .sweep_dense import dense_apply_nd_ref
from .sweep_plan import make_layout_plan

__all__ = ["chosen_ends", "layout_coords"]


def chosen_ends(cs, pos, length, rev, other_end):
    """(my_pos [S], lane0 bool [S], my_c [D, S]) of each step's chosen
    end.  ``other_end`` is the per-step end coin (proposal 0's bits): the
    other end moves the step's path position by its node's length, and
    the end index is coin XOR orientation."""
    D = cs.shape[0] // 2
    my_pos = torch.where(other_end, pos + length, pos)
    lane0 = torch.where(other_end, 1 - rev, rev) == 0
    return my_pos, lane0, torch.where(lane0, cs[:D], cs[D:])


def layout_coords(pidx: PathIndex, params: LayoutSGDParams, device,
                  round_state=None):
    """Node-end coordinates [2N, D] (f64 numpy; row ``2n + e`` is end
    ``e`` of node ``n``), or None when no path has two steps."""
    n, dims = pidx.num_nodes, params.dimensions
    if n == 0 or not pidx.has_multi_step_path():
        return None
    init = layout_initial_coords(pidx, dims, params.seed)
    plan = make_layout_plan(pidx, params)
    dev = torch.device(device)
    gc = build_gather_consensus(pidx.step_node_idx, n, dev, dtype=np.float32)
    pos = torch.from_numpy(pidx.step_pos.astype(np.float32)).to(dev)
    rank = torch.from_numpy(pidx.step_rank.astype(np.int32)).to(dev)
    cnt = torch.from_numpy(pidx.step_count_of_step.astype(np.int32)).to(dev)
    rev = torch.from_numpy(np.ascontiguousarray(
        (pidx.step_handle & 1).astype(np.int32))).to(dev)
    length = torch.from_numpy(np.ascontiguousarray(np.asarray(
        pidx.node_len, dtype=np.float32)[pidx.step_node_idx])).to(dev)
    consts = [[sampler_consts(ph, c, dev) for c in (False, True)]
              for ph in plan.phases]
    nc = np.asarray(init, dtype=np.float32).reshape(n, 2, dims)
    cs = torch.from_numpy(np.ascontiguousarray(
        nc[pidx.step_node_idx].transpose(1, 2, 0).reshape(2 * dims, -1))).to(dev)
    cs_node0 = torch.from_numpy(np.ascontiguousarray(
        nc.transpose(1, 2, 0).reshape(2 * dims, n))).to(dev)
    P = plan.proposals
    keys = sweep_key_table(key_data(params.seed), plan.n_exec, P)
    keep = round_state or (lambda t: t)
    xn = None
    for e in range(plan.n_exec):
        i, eta, cooling = plan.sweep(e)
        ph = plan.phases[i]
        words, other_end = sample_words(consts[i][cooling], keys[e], cooling,
                                        rank, cnt, plan.active_frac,
                                        plan.knobs.snap, coin=True)
        my_pos, lane0, my_c = chosen_ends(cs, pos, length, rev, other_end)
        acc = wacc = None
        if ph.kernel_buckets:
            acc, wacc = dense_apply_nd_ref(my_pos, words, my_c, eta,
                                           ph.kernel_buckets, P)
        cs = keep(roll_apply_nd_ref(my_pos, my_c, lane0, cs, words, eta,
                                    ph.roll_buckets, P, acc, wacc))
        if (e + 1) % plan.consensus_every == 0:
            cs, xn = gc(cs)
            cs, xn = keep(cs), keep(xn)
    x_node = gc.to_node_order(xn, cs_node0)
    xn64 = x_node.cpu().numpy().astype(np.float64)
    # [2D, N] rows -> [2N, D] node-end-major state
    return np.ascontiguousarray(
        xn64.reshape(2, dims, n).transpose(2, 0, 1).reshape(2 * n, dims))
