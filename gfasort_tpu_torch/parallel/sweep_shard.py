"""Multi-device offset-sweep SGD: local sweeps + an all-reduced node
consensus.

Counterpart of ``gfasort_tpu/parallel/sweep_shard.py`` (same names,
signatures and return contracts, with a :class:`~.mesh.Mesh` of shards
for the JAX mesh).  Paths are packed whole into the shards, so no term
pair crosses a shard: every shard sweeps its own ``[L]`` steps with the
single-card engine's :func:`~..ops.sweep.sweep_once`, and the bucket
kernel runs once per shard and sweep.  The only collective is the node
consensus every ``consensus_every`` sweeps: each shard sums its steps
per node, :meth:`Mesh.all_reduce` adds the shards' ``[N]`` sums, and
every shard takes its nodes' means.

The plan is :func:`~..ops.sweep_plan.make_sharded_sweep_plan`: the JAX
sharded engine's knobs (the consensus period raised by shard length,
the executed sweeps counted at ``L`` steps per sweep).  Shard ``g``
draws from ``fold_in(key, g)``.  The JAX engine's grid consensus (an MXU
one-hot design) is not ported: ``GFASORT_CONSENSUS=auto`` and ``gather``
run the gather consensus, ``grid`` raises (``ops/env.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..graph import BidirectedGraph
from ..index import PathIndex
from ..ops.keys import fold_in, key_data, sweep_key_table
from ..ops.node_sum import build_gather_consensus
from ..ops.sweep import sweep_once
from ..ops.sweep_common import sampler_consts
from ..ops.sweep_plan import make_sharded_sweep_plan, torch_dtype
from ..ops.sweep_policy import LARGE_S
from ..params import PathSGDParams
from .mesh import default_mesh, partition_paths

__all__ = ["CE_CAP", "PSUM_AMORT_STEPS", "ShardConsensus",
           "build_sharded_sweep", "path_linear_sgd_sweep_sharded",
           "path_sgd_sort_sweep_sharded", "shard_consensus_every"]

# Steps a shard processes between consensus collectives, so that the
# collective's fixed cost stays amortized; the period is capped at
# CE_CAP sweeps (the JAX engine's strong-scaling knob, kept for parity).
PSUM_AMORT_STEPS = 4_000_000
CE_CAP = 384


def shard_consensus_every(L: int, base_ce: int, S_total: int) -> int:
    """Consensus period for shard length ``L``: at least the single-card
    auto period, raised so that ce x L covers PSUM_AMORT_STEPS, capped at
    CE_CAP.  Only in the large regime (total steps >= LARGE_S); small
    graphs keep the single-card period."""
    if S_total < LARGE_S:
        return int(base_ce)
    need = -(-PSUM_AMORT_STEPS // max(L, 1))
    return int(np.clip(need, base_ce, CE_CAP))


def _shard_arrays(pidx: PathIndex, n_shards: int, dtype):
    """Per-shard padded step arrays [n_shards, L] in path-contiguous
    layout.  Pad slots: cnt=1 (never active), node=-1 (left out of the
    consensus), path=-1."""
    assignment = partition_paths(pidx.path_count.tolist(), n_shards)
    sizes = [int(sum(pidx.path_count[p] for p in paths)) for paths in assignment]
    L = max(max(sizes), 1)

    pos = np.zeros((n_shards, L), dtype=dtype)
    rank = np.zeros((n_shards, L), dtype=np.int32)
    cnt = np.ones((n_shards, L), dtype=np.int32)
    node = np.full((n_shards, L), -1, dtype=np.int32)
    path = np.full((n_shards, L), -1, dtype=np.int32)

    for d, paths in enumerate(assignment):
        off = 0
        for p in paths:
            f = int(pidx.path_first[p])
            c = int(pidx.path_count[p])
            sl = slice(off, off + c)
            pos[d, sl] = pidx.step_pos[f : f + c]
            rank[d, sl] = pidx.step_rank[f : f + c]
            cnt[d, sl] = c
            node[d, sl] = pidx.step_node_idx[f : f + c]
            path[d, sl] = p
            off += c
    return pos, rank, cnt, node, path, L


def _upload(mesh, a: np.ndarray):
    """Row ``g`` of the [n_shards, ...] array ``a`` on local shard ``g``'s
    device, for each of this process's shards."""
    return [torch.from_numpy(np.ascontiguousarray(a[g])).to(dev)
            for g, dev in zip(mesh.shards, mesh.devices)]


def _device_consts(mesh, plan):
    """The plan's sampler constants on each device of the mesh:
    ``[device][phase][cooling]``."""
    tdt = torch_dtype(plan.dtype)
    return {dev: [[sampler_consts(ph, c, dev, tdt) for c in (False, True)]
                  for ph in plan.phases]
            for dev in dict.fromkeys(mesh.devices)}


def _shard_keys(mesh, base_key, n: int, proposals: int):
    """Per local shard ``g``, the key table of ``n`` sweeps under
    ``fold_in(base_key, g)``."""
    base = np.asarray(base_key, np.uint32)
    return [sweep_key_table(fold_in(base, g), n, proposals)
            for g in mesh.shards]


class ShardConsensus:
    """The sharded engines' node consensus over a static step->node map.

    Each shard adds its live steps' values per node in step order (the
    order of the JAX scatter-add, which starts each sum at +0), the mesh
    all-reduces the ``[..., N]`` sums, and every shard's live steps take
    their node's mean (the sum times the host-rounded ``1 / degree``);
    pad steps keep their values.  Works on ``[L]`` positions and on
    ``[R, L]`` coordinate rows alike."""

    def __init__(self, mesh, node_np: np.ndarray, n_nodes: int, dtype):
        self.mesh = mesh
        self.N = int(n_nodes)
        live_nodes = node_np[node_np >= 0].astype(np.int64)
        cnt_total = np.bincount(live_nodes, minlength=self.N)
        inv_cnt = (1.0 / np.maximum(cnt_total, 1)).astype(dtype)
        self.inv_cnt, self.has_steps, self.tables = {}, {}, []
        for g, dev in zip(mesh.shards, mesh.devices):
            row = node_np[g]
            n_live = int((row >= 0).sum())
            # _shard_arrays packs every shard's live steps first
            if (row[:n_live] < 0).any():
                raise ValueError("a shard's live steps must come first")
            gc = (build_gather_consensus(row[:n_live], self.N, dev, dtype=dtype)
                  if n_live else None)
            node_t = torch.from_numpy(row[:n_live].astype(np.int64)).to(dev)
            self.tables.append((n_live, gc, node_t))
            if dev not in self.inv_cnt:
                self.inv_cnt[dev] = torch.from_numpy(inv_cnt).to(dev)
                self.has_steps[dev] = torch.from_numpy(cnt_total > 0).to(dev)

    def __call__(self, xs):
        """xs: per local shard [L] or [R, L] -> (new xs per shard; the
        node means [N] or [R, N] on the first shard's device)."""
        parts = []
        for x, (n_live, gc, _) in zip(xs, self.tables):
            part = x.new_zeros(x.shape[:-1] + (self.N,))
            if n_live:
                # + 0.0: a sum the scatter-add starts at +0 is never -0
                part[..., gc.slot_node] = gc.sums(x[..., :n_live]) + 0.0
            parts.append(part)
        totals = self.mesh.all_reduce(parts)
        means = {}
        out = []
        for x, total, (n_live, _, node_t) in zip(xs, totals, self.tables):
            dev = x.device
            if dev not in means:
                means[dev] = total * self.inv_cnt[dev]
            new = x.clone()
            new[..., :n_live] = means[dev][..., node_t]
            out.append(new)
        return out, means[xs[0].device]

    def finish(self, x_node, x_node_init):
        """The final node values: the last consensus's means, and
        ``x_node_init`` for nodes that have no step."""
        return torch.where(self.has_steps[x_node.device], x_node, x_node_init)


def build_sharded_sweep(
    pidx: PathIndex,
    params: PathSGDParams,
    mesh,
    per_octave: Optional[int] = None,
    consensus_every: Optional[int] = None,
    active_frac: Optional[float] = None,
    rotate=None,
    dense_upto: Optional[int] = None,
    proposals: Optional[int] = None,
    expose_parts: bool = False,
):
    """Returns (run, arrays, make_state, info).  ``run(xs, x_node_init,
    base_key, *arrays)`` executes the full schedule on every local shard
    and returns the node positions [N] on the first shard's device;
    ``xs`` is a list of per-shard ``[L]`` step positions, ``base_key``
    the u32 [2] key data (``ops.keys.key_data(seed)``) and ``arrays`` the
    per-shard (pos, rank, cnt) lists.  ``make_state(x0=None)`` returns
    ``(xs, x_node0)``.

    ``expose_parts=True`` also puts two single-period functions in
    ``info["parts"]``: ``sweeps_fn(xs, base_key, *arrays)`` runs one
    consensus period of sweeps without the collective; ``period_fn``
    runs the same period with it.  Both return the per-shard xs."""
    dtype = {"float32": np.float32, "float64": np.float64}[params.dtype]
    N = pidx.num_nodes
    pos_np, rank_np, cnt_np, node_np, _, L = _shard_arrays(
        pidx, mesh.size, dtype)
    plan = make_sharded_sweep_plan(pidx, params, L, per_octave,
                                   consensus_every, active_frac, rotate,
                                   dense_upto, proposals)
    consensus = ShardConsensus(mesh, node_np, N, dtype)
    arrays = tuple(_upload(mesh, a) for a in (pos_np, rank_np, cnt_np))
    consts = _device_consts(mesh, plan)
    ce = plan.consensus_every
    P = plan.proposals

    def sweep_all(xs, keys, e, pos, rank, cnt):
        i, eta, cooling = plan.sweep(e)
        return [sweep_once(x, p, r, c, plan.phases[i],
                           consts[x.device][i][cooling], k[e], eta, cooling,
                           P, plan.active_frac, plan.knobs.snap,
                           plan.knobs.rng)
                for x, k, p, r, c in zip(xs, keys, pos, rank, cnt)]

    def run(xs, x_node_init, base_key, pos, rank, cnt):
        keys = _shard_keys(mesh, base_key, plan.n_exec, P)
        xn = None
        for e in range(plan.n_exec):
            xs = sweep_all(xs, keys, e, pos, rank, cnt)
            if (e + 1) % ce == 0:
                xs, xn = consensus(xs)
        return consensus.finish(xn, x_node_init)

    def make_state(x0=None):
        x_node0 = np.asarray(
            x0 if x0 is not None else pidx.initial_positions(), dtype=dtype)
        xs0 = np.zeros((mesh.size, L), dtype=dtype)
        live = node_np >= 0
        xs0[live] = x_node0[node_np[live]]
        return (_upload(mesh, xs0),
                torch.from_numpy(x_node0.copy()).to(mesh.devices[0]))

    info = {"n_sweeps": plan.n_sweeps,
            "updates_per_sweep": plan.updates_per_sweep,
            "proposals": P, "active_frac": plan.active_frac,
            "n_offsets": len(plan.offs), "shard_len": L,
            "rotate": plan.rotate, "consensus_every": ce,
            "grid_consensus": False, "grid_coverage": None}

    if expose_parts:
        n_period = max(ce // len(plan.phases), 1) * len(plan.phases)

        def _mk(with_consensus):
            def period(xs, base_key, pos, rank, cnt):
                keys = _shard_keys(mesh, base_key, n_period, P)
                for e in range(n_period):
                    xs = sweep_all(xs, keys, e, pos, rank, cnt)
                if with_consensus:
                    xs, _ = consensus(xs)
                return xs
            return period

        info["parts"] = {"sweeps_fn": _mk(False), "period_fn": _mk(True)}

    return run, arrays, make_state, info


def path_linear_sgd_sweep_sharded(
    graph: Optional[BidirectedGraph],
    params: PathSGDParams,
    mesh=None,
    pidx: Optional[PathIndex] = None,
    **kw,
) -> Optional[np.ndarray]:
    """Sharded 1D path SGD via offset sweeps: node positions [N] (f64
    numpy), None when no path has two steps.  ``mesh`` defaults to
    :func:`~.mesh.default_mesh` (every visible card)."""
    pidx = pidx or PathIndex.from_graph(graph)
    if pidx.num_nodes == 0:
        return np.zeros(0)
    if not pidx.has_multi_step_path():
        return None
    mesh = mesh or default_mesh()
    run, arrays, make_state, _ = build_sharded_sweep(pidx, params, mesh, **kw)
    xs0, x_node0 = make_state()
    out = run(xs0, x_node0, key_data(params.seed), *arrays)
    return out.cpu().numpy().astype(np.float64)


def path_sgd_sort_sweep_sharded(graph, params, mesh=None, **kw):
    """Node order (forward handles) by the sharded sweep's positions."""
    pidx = PathIndex.from_graph(graph)
    x = path_linear_sgd_sweep_sharded(graph, params, mesh, pidx, **kw)
    if x is None or len(x) == 0:
        return []
    order = np.argsort(x, kind="stable")
    return (np.asarray(pidx.node_ids)[order] << 1).tolist()
