"""Sharded 1D path SGD: step arrays sharded over a mesh, positions
replicated, each round's deltas all-reduced.

Counterpart of ``gfasort_tpu/parallel/sgd_shard.py`` (same names,
signatures and return contracts, with a :class:`~.mesh.Mesh` of shards).
Paths are packed whole into the shards; per round, every shard samples
``B_local = ceil(B / n_shards)`` step slots uniformly from its padded
``[L]`` slots (pads are never valid), computes the terms' updates
against the round's positions, and sums them per node; the mesh
all-reduces the ``[N]`` sums and counts of every round, and every shard
applies ``x + dsum / max(cnt, 1)`` to its copy of x.

It is not the single-card batched engine (:mod:`..ops.sgd`), whose
sampler, schedule and summing order it reuses:

* shard ``g`` draws round ``r`` from ``fold_in(fold_in(key(seed), g), r)``
  split five ways (slot, coin, direction, uniform, uniform rank);
* the schedule is built for ``B_local * n_shards`` terms per round;
* a term's update is ``(delta / |dx|) * dx``, not ``delta * sign(dx)``;
* the round's per-node sums and counts cross the mesh every round.

Each shard adds its node's terms in the XLA:CPU scatter-add's order
(first nodes, then second ones, each in draw order, from +0) through the
per-chunk sorted tables of :mod:`..ops.sgd`, and the mesh adds the
shards in shard order, so a one-process run equals the JAX engine on
the same number of shards bit for bit.  With every shard on one card
and no process group, the round loop is replayed as a CUDA graph, as
in :mod:`..ops.sgd`; otherwise it runs eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..graph import BidirectedGraph
from ..index import PathIndex
from ..ops.fastpow import zeta_table
from ..ops.keys import fold_in, key_data
from ..ops.sgd import (_NP, _TORCH, DeviceIndex, _ChunkGraphs, _chunks,
                       _fold_tables, _make_sampler, _round_keys, _row_sums,
                       build_schedule, effective_batch)
from ..params import PathSGDParams
from .mesh import default_mesh, partition_paths

__all__ = ["ShardedIndex", "path_linear_sgd_sharded", "path_sgd_sort_sharded"]


@dataclass(frozen=True)
class ShardedIndex:
    """Per-shard padded path-index arrays, stacked on a leading shard
    axis.  Pad slots have ``step_node == -1``."""

    step_rank: np.ndarray     # [D, L] int32
    step_pos: np.ndarray      # [D, L] float
    step_node: np.ndarray     # [D, L] int32 (-1 = pad)
    step_first: np.ndarray    # [D, L] int32: shard-local first-step of the slot's path
    step_count: np.ndarray    # [D, L] int32: step count of the slot's path
    num_nodes: int
    shard_len: int

    @classmethod
    def build(cls, pidx: PathIndex, n_shards: int, dtype=np.float32) -> "ShardedIndex":
        assignment = partition_paths(pidx.path_count.tolist(), n_shards)
        shard_sizes = [
            int(sum(pidx.path_count[p] for p in paths)) for paths in assignment
        ]
        L = max(max(shard_sizes), 1)

        ranks = np.zeros((n_shards, L), dtype=np.int32)
        poss = np.zeros((n_shards, L), dtype=dtype)
        nodes = np.full((n_shards, L), -1, dtype=np.int32)
        firsts = np.zeros((n_shards, L), dtype=np.int32)
        counts = np.ones((n_shards, L), dtype=np.int32)

        for d, paths in enumerate(assignment):
            off = 0
            for p in paths:
                f = int(pidx.path_first[p])
                c = int(pidx.path_count[p])
                sl = slice(off, off + c)
                ranks[d, sl] = pidx.step_rank[f : f + c]
                poss[d, sl] = pidx.step_pos[f : f + c]
                nodes[d, sl] = pidx.step_node_idx[f : f + c]
                firsts[d, sl] = off
                counts[d, sl] = c
                off += c
        return cls(
            step_rank=ranks, step_pos=poss, step_node=nodes,
            step_first=firsts, step_count=counts,
            num_nodes=pidx.num_nodes, shard_len=L,
        )

    def device_index(self, g: int, device) -> DeviceIndex:
        """Shard ``g`` as a :class:`~..ops.sgd.DeviceIndex` for the
        batched sampler: its paths numbered in slot order, every pad slot
        on one extra path of one step at slot 0 (the JAX engine's pad:
        first 0, count 1, so never a valid term)."""
        first, count = self.step_first[g], self.step_count[g]
        live = self.step_node[g] >= 0
        starts = np.flatnonzero(live & (np.arange(self.shard_len) == first))
        step_path = np.full(self.shard_len, len(starts), np.int64)
        step_path[live] = np.searchsorted(starts, np.flatnonzero(live),
                                          side="right") - 1
        path_first = np.append(first[starts], 0).astype(np.int32)
        path_count = np.append(count[starts], 1).astype(np.int32)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return DeviceIndex(
            step_path=up(step_path), step_rank=up(self.step_rank[g]),
            step_pos=up(self.step_pos[g]),
            step_node=up(self.step_node[g].astype(np.int64)),
            step_rev=up(np.zeros(self.shard_len, np.int64)),
            path_first=up(path_first), path_count=up(path_count),
            node_len=up(np.zeros(0, self.step_pos.dtype)),
            total_steps=self.shard_len, num_nodes=self.num_nodes,
        )


def _shard_part(x, table, ij, mu, safe, valid_r, tgt, cnt, N: int):
    """One shard's round: its terms' updates against ``x`` [N + 1] and
    their per-node (sum, count) [2, N + 1], each node's terms added in
    the JAX scatter-add's order (row N takes what no node takes)."""
    B = ij.shape[0] // 2
    g = x[ij]
    dx = g[:B] - g[B:]
    dx = torch.where(dx == 0, 1e-9, dx)
    mag = torch.abs(dx)
    delta = mu * (mag - safe) / 2.0
    r_x = torch.where(valid_r, (delta / mag) * dx, 0.0)
    vals = torch.cat([-r_x, r_x, r_x.new_zeros(1)])
    part = x.new_zeros((2, N + 1))
    part[0, tgt] = _row_sums(vals[table])
    part[1, tgt] = cnt
    return part


def _rounds(mesh, N: int, xs, tabs):
    """Rounds in place on the per-shard positions ``xs`` ([N + 1] each;
    shards on one device share one tensor): ``tabs`` holds, per local
    shard, its (table, ij, mu, safe, valid_r, tgt, cnt) over the rounds
    (leading axis R)."""
    for r in range(tabs[0][0].shape[0]):
        parts = [_shard_part(x, *(t[r] for t in tab), N)
                 for x, tab in zip(xs, tabs)]
        done = set()
        for x, total in zip(xs, mesh.all_reduce(parts)):
            if id(x) not in done:
                done.add(id(x))
                x[:N] = x[:N] + total[0, :N] / torch.clamp_min(total[1, :N], 1.0)


def path_linear_sgd_sharded(
    graph: BidirectedGraph,
    params: PathSGDParams,
    mesh=None,
    pidx: Optional[PathIndex] = None,
    x0: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Multi-device 1D path SGD.  Returns final positions (host numpy
    f64) or None when no multi-step path exists.  ``mesh`` defaults to
    :func:`~.mesh.default_mesh` (every visible card)."""
    pidx = pidx or PathIndex.from_graph(graph)
    if pidx.num_nodes == 0:
        return np.zeros(0)
    if not pidx.has_multi_step_path():
        return None
    mesh = mesh or default_mesh()
    ndev = mesh.size
    dtype = _NP[params.dtype]
    fdt = _TORCH[dtype]
    sample_dtype = np.float64 if params.pow_mode == "fpp" else dtype

    sidx = ShardedIndex.build(pidx, ndev, dtype)
    zetas = zeta_table(
        params.space, params.space_max, params.space_quantization_step,
        params.theta,
    )
    B_total = effective_batch(params)
    B_local = max(1, -(-B_total // ndev))
    round_eta, round_cooling, _rpi, n_rounds = build_schedule(
        params, B_local * ndev)
    L, N = sidx.shard_len, sidx.num_nodes

    shards = []
    for g, dev in zip(mesh.shards, mesh.devices):
        di = sidx.device_index(g, dev)
        shards.append(dict(
            di=di, dev=dev, node=di.step_node.clamp_min(0),
            sampler=_make_sampler(di, params, zetas, sample_dtype, B_local),
            keys=_round_keys(fold_in(key_data(params.seed), g),
                             np.arange(n_rounds), 0, dev),
            etas=torch.from_numpy(round_eta.astype(dtype)).to(dev)))

    x_init = torch.from_numpy(np.asarray(
        x0 if x0 is not None else pidx.initial_positions(), dtype=dtype).copy())
    states = {}
    for s in shards:
        if s["dev"] not in states:
            states[s["dev"]] = torch.cat([x_init, x_init.new_zeros(1)]).to(s["dev"])
    xs = [states[s["dev"]] for s in shards]
    # one card and no process group: replay the round loop as a graph
    graphed = (mesh.group is None and len(states) == 1
               and xs[0].device.type == "cuda")
    k = len(shards)
    if graphed:
        loop = _ChunkGraphs(
            lambda x, *a: _rounds(mesh, N, [x] * k,
                                  [[t[:, j] for t in a] for j in range(k)]),
            xs[0], 2 * B_local)

    for r0, r1 in _chunks(round_cooling, B_local * k, 0, n_rounds):
        cooling = bool(round_cooling[r0])
        tabs = []
        for s in shards:
            sa, sb, valid = s["sampler"](s["keys"][r0:r1], cooling, 0, L)
            pos = s["di"].step_pos
            term_dist = torch.abs(pos[sa] - pos[sb])
            valid_r = valid & (term_dist != 0)
            safe = torch.where(valid_r, term_dist, 1.0)
            mu = torch.clamp_max(s["etas"][r0:r1, None] / safe, 1.0)
            ij = torch.cat([s["node"][sa], s["node"][sb]], dim=1)
            table, tgt, cnt = _fold_tables(
                ij, torch.cat([valid_r, valid_r], dim=1), N)
            tabs.append([table, ij, mu, safe, valid_r, tgt, cnt.to(fdt)])
        if graphed:
            # one table width for every shard: pad with the zero term
            M = max(t[0].shape[-1] for t in tabs)
            for t in tabs:
                t[0] = torch.nn.functional.pad(t[0], (0, M - t[0].shape[-1]),
                                               value=2 * B_local)
            loop(*(torch.stack([t[c] for t in tabs], dim=1)
                   for c in range(7)))
        else:
            _rounds(mesh, N, xs, tabs)
    return xs[0][:N].cpu().numpy().astype(np.float64)


def path_sgd_sort_sharded(graph: BidirectedGraph, params: PathSGDParams,
                          mesh=None):
    """Handle ordering from the sharded batched engine (stable sort by
    final position)."""
    pidx = PathIndex.from_graph(graph)
    x = path_linear_sgd_sharded(graph, params, mesh, pidx)
    if x is None or len(x) == 0:
        return []
    order = np.argsort(x, kind="stable")
    return (np.asarray(pidx.node_ids)[order] << 1).tolist()
