"""The 1D offset-sweep engine (the ``Y`` step), plain PyTorch.

A frozen copy of ``gfasort_tpu_torch/ops/sweep.py::build_sweep_runner``
and ``path_sgd_sort_sweep`` with every kernel replaced by its plain
version: the sampler (``sweep_common.sample_words``), the bucket pass
(``sweep_dense.bucket_apply_ref``) and the roll passes with the combine
(``roll_apply.roll_apply_ref``).  State lives in step space: ``xs[s]`` is
the position of step ``s``; every ``consensus_every`` sweeps the node
consensus averages the steps of each node.

``round_state`` (default: none) is applied to the state after every sweep
and every consensus; the control of the benchmark's comparison passes a
rounding to a lower precision there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index import PathIndex
from ..params import PathSGDParams
from .keys import key_data, sweep_key_table
from .node_sum import JAX_ROW_RUN, build_gather_consensus
from .roll_apply import roll_apply_ref
from .sweep_common import sample_words, sampler_consts
from .sweep_dense import bucket_apply_ref
from .sweep_plan import PhasePlan, make_sweep_plan

__all__ = ["apply_choices", "sweep_positions", "path_sgd_sort_sweep"]


def apply_choices(xs, pos, words, phase: PhasePlan, eta: float,
                  proposals: int):
    """The pair updates of one sweep for the given choice words and the
    combine; returns the new xs."""
    dsum = csum = None
    if phase.kernel_buckets:
        dsum, csum = bucket_apply_ref(xs, pos, words, eta,
                                      phase.kernel_buckets, proposals)
    return roll_apply_ref(xs, pos, words, eta, phase.roll_buckets,
                          proposals, dsum, csum)


def sweep_positions(pidx: PathIndex, params: PathSGDParams, device,
                    round_state=None) -> np.ndarray:
    """Final node positions [N] (f64 numpy) of the whole schedule."""
    plan = make_sweep_plan(pidx, params)
    dev = torch.device(device)
    gc = build_gather_consensus(pidx.step_node_idx, pidx.num_nodes, dev,
                                run=JAX_ROW_RUN, dtype=np.float32)
    pos = torch.from_numpy(pidx.step_pos.astype(np.float32)).to(dev)
    rank = torch.from_numpy(pidx.step_rank.astype(np.int32)).to(dev)
    cnt = torch.from_numpy(pidx.step_count_of_step.astype(np.int32)).to(dev)
    consts = [[sampler_consts(ph, c, dev) for c in (False, True)]
              for ph in plan.phases]
    x_node0 = np.asarray(pidx.initial_positions(), dtype=np.float32)
    xs = torch.from_numpy(np.ascontiguousarray(
        x_node0[pidx.step_node_idx])).to(dev)
    P = plan.proposals
    keys = sweep_key_table(key_data(params.seed), plan.n_exec, P)
    keep = round_state or (lambda t: t)
    xn = None
    for e in range(plan.n_exec):
        i, eta, cooling = plan.sweep(e)
        words, _ = sample_words(consts[i][cooling], keys[e], cooling, rank,
                                cnt, plan.active_frac, plan.knobs.snap)
        xs = keep(apply_choices(xs, pos, words, plan.phases[i], eta, P))
        if (e + 1) % plan.consensus_every == 0:
            xs, xn = gc(xs)
            xs, xn = keep(xs), keep(xn)
    x_node = gc.to_node_order(xn, torch.from_numpy(x_node0).to(dev))
    return x_node.cpu().numpy().astype(np.float64)


def path_sgd_sort_sweep(graph, params: PathSGDParams, device,
                        round_state=None):
    """Node order (forward handles) by the sweep engine's positions."""
    pidx = PathIndex.from_graph(graph)
    if pidx.num_nodes == 0 or not pidx.has_multi_step_path():
        return []
    x = sweep_positions(pidx, params, device, round_state)
    order = np.argsort(x, kind="stable")
    return (np.asarray(pidx.node_ids)[order] << 1).tolist()
