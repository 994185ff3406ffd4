"""Multi-device nD layout SGD: local sweeps + an all-reduced node-end
consensus.

Counterpart of ``gfasort_tpu/parallel/sweep_nd_shard.py``, the layout
twin of :mod:`.sweep_shard` for the ``L`` step.  Every shard holds the
``[2D, L]`` coordinate rows of its path-packed steps and sweeps them
with the single-card engine's :func:`~..ops.sweep_nd.nd_sweep_once` (the
nD bucket kernel runs once per shard and sweep); every
``consensus_every`` sweeps the ``[2D, N]`` per-(node, end, dimension)
sums are all-reduced over the mesh and every shard takes the means.

The plan is :func:`~..ops.sweep_plan.make_sharded_layout_plan`.  Unlike
the single-card layout plan it does not clamp the proposals to
``max(1, 4 - D)`` choice words: the JAX sharded engine hands its P
(8 in the large regime) to every shard, so a 3D sharded layout runs
P = 8 (2 words).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..graph import BidirectedGraph
from ..index import PathIndex
from ..io.layout_tsv import Layout
from ..ops.keys import key_data
from ..ops.sweep_nd import nd_sweep_once
from ..ops.sweep_plan import make_sharded_layout_plan
from ..params import LayoutSGDParams
from .mesh import default_mesh, partition_paths
from .sweep_shard import (ShardConsensus, _device_consts, _shard_arrays,
                          _shard_keys, _upload)

__all__ = [
    "build_sharded_sweep_nd",
    "path_linear_sgd_layout_sweep_sharded",
]


def _rev_len_rows(pidx: PathIndex, node_np: np.ndarray, n_shards: int, dtype):
    """Per-shard orientation bits and node lengths [n_shards, L] in the
    packing of ``_shard_arrays`` (dead slots: rev 0, len 0)."""
    L = node_np.shape[1]
    rev_np = np.zeros((n_shards, L), dtype=np.int32)
    len_np = np.zeros((n_shards, L), dtype=dtype)
    live = node_np >= 0
    len_np[live] = pidx.node_len[node_np[live]].astype(dtype)
    rev_src = (pidx.step_handle & 1).astype(np.int32)
    for d, paths in enumerate(partition_paths(pidx.path_count.tolist(),
                                              n_shards)):
        off = 0
        for p in paths:
            f = int(pidx.path_first[p])
            c = int(pidx.path_count[p])
            rev_np[d, off : off + c] = rev_src[f : f + c]
            off += c
    return rev_np, len_np


def build_sharded_sweep_nd(
    pidx: PathIndex,
    params: LayoutSGDParams,
    mesh,
    per_octave: Optional[int] = None,
    consensus_every: Optional[int] = None,
    active_frac: Optional[float] = None,
    rotate=None,
    dense_upto: Optional[int] = None,
    proposals: Optional[int] = None,
):
    """Returns (run, arrays, make_state, info).  ``run(cs, cs_node_init,
    base_key, *arrays)`` executes the full layout schedule on every local
    shard and returns the [2D, N] node-end coordinates on the first
    shard's device; ``cs`` is a list of per-shard ``[2D, L]`` rows and
    ``arrays`` the per-shard (pos, rank, cnt, rev, len) lists.
    ``make_state(init_node_coords)`` maps [2N, D] node-end coordinates
    to ``(cs, cs_node0)``."""
    dtype = {"float32": np.float32, "float64": np.float64}[params.dtype]
    N = pidx.num_nodes
    D = int(params.dimensions)
    pos_np, rank_np, cnt_np, node_np, _, L = _shard_arrays(
        pidx, mesh.size, dtype)
    rev_np, len_np = _rev_len_rows(pidx, node_np, mesh.size, dtype)
    plan = make_sharded_layout_plan(pidx, params, L, per_octave,
                                    consensus_every, active_frac, rotate,
                                    dense_upto, proposals)
    consensus = ShardConsensus(mesh, node_np, N, dtype)
    arrays = tuple(_upload(mesh, a)
                   for a in (pos_np, rank_np, cnt_np, rev_np, len_np))
    consts = _device_consts(mesh, plan)
    ce = plan.consensus_every
    P = plan.proposals

    def run(cs, cs_node_init, base_key, pos, rank, cnt, rev, length):
        keys = _shard_keys(mesh, base_key, plan.n_exec, P)
        xn = None
        for e in range(plan.n_exec):
            i, eta, cooling = plan.sweep(e)
            cs = [nd_sweep_once(c, p, r, n, v, ln, plan.phases[i],
                                consts[c.device][i][cooling], k[e], eta,
                                cooling, P, plan.active_frac,
                                plan.knobs.snap, plan.knobs.rng)
                  for c, k, p, r, n, v, ln in zip(cs, keys, pos, rank, cnt,
                                                  rev, length)]
            if (e + 1) % ce == 0:
                cs, xn = consensus(cs)
        return consensus.finish(xn, cs_node_init)

    def make_state(init_node_coords: np.ndarray):
        nc = np.asarray(init_node_coords, dtype=dtype).reshape(N, 2, D)
        per_node_rows = np.ascontiguousarray(
            nc.transpose(1, 2, 0).reshape(2 * D, N))
        cs0 = np.zeros((mesh.size, 2 * D, L), dtype=dtype)
        for d in range(mesh.size):
            lv = node_np[d] >= 0
            cs0[d][:, lv] = per_node_rows[:, node_np[d][lv]]
        return (_upload(mesh, cs0),
                torch.from_numpy(per_node_rows).to(mesh.devices[0]))

    info = {
        "n_sweeps": plan.n_sweeps, "updates_per_sweep": plan.updates_per_sweep,
        "proposals": P, "active_frac": plan.active_frac,
        "n_offsets": len(plan.offs), "shard_len": L, "rotate": plan.rotate,
        "consensus_every": ce, "grid_consensus": False,
    }
    return run, arrays, make_state, info


def path_linear_sgd_layout_sweep_sharded(
    graph: Optional[BidirectedGraph],
    params: LayoutSGDParams,
    mesh=None,
    pidx: Optional[PathIndex] = None,
    init_coords: Optional[np.ndarray] = None,
    **kw,
) -> Layout:
    """Multi-device nD layout; same output contract as
    :func:`gfasort_tpu_torch.ops.sweep_nd.path_linear_sgd_layout_sweep`."""
    pidx = pidx or PathIndex.from_graph(graph)
    n = pidx.num_nodes
    dims = params.dimensions
    if n == 0:
        return Layout(dims, 0)
    if not pidx.has_multi_step_path():
        return Layout(dims, n)

    if init_coords is None:
        from ..ops.exact import layout_initial_coords

        init_coords = layout_initial_coords(pidx, dims, params.seed)

    mesh = mesh or default_mesh()
    run, arrays, make_state, _ = build_sharded_sweep_nd(pidx, params, mesh, **kw)
    cs0, cs_node0 = make_state(init_coords)
    x_node = run(cs0, cs_node0, key_data(params.seed), *arrays)
    xn = x_node.cpu().numpy().astype(np.float64)
    state = np.ascontiguousarray(
        xn.reshape(2, dims, n).transpose(2, 0, 1).reshape(2 * n, dims))
    return Layout.from_state(state)
