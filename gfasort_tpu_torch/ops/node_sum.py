"""Node consensus of the sweep engine: per-node mean of step positions,
written back to every step of the node.

Counterpart of both JAX forms — the gather-sum consensus
(``gfasort_tpu/ops/node_sum.py``) and the grid consensus
(``ops/grid_consensus.py``, an MXU one-hot design); neither is a Pallas
kernel.  The step->node map is static, so the class tables are built
once on the host: live nodes are grouped by degree into power-of-two
width classes (1, 2, 4, ... up to the largest degree), each node's step
list padded to its class width with a sentinel that points at an
appended zero.  A consensus is then one gather-sum per class, with no
scatter and no float atomics, so it is deterministic on CUDA.

Each node's steps are added in step order, as the JAX engines add them
on the CPU: the nD engine's scatter-add takes them one by one; the 1D
engine's gather consensus reduces a row of up to 128 terms by XLA's row
reduction, which adds runs of 32 terms in order and then the runs' sums
in order (``run=JAX_ROW_RUN``), and scatters the steps of larger nodes.
A ``torch.sum`` would add them in its own, vectorised order.

The same tables serve the 1D engine's ``[S]`` positions and the layout
engine's ``[R, S]`` coordinate rows (R = 2D, one row per node end and
dimension): every row is averaged over the same step->node map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import trace

__all__ = ["JAX_ROW_RUN", "GatherConsensus", "build_gather_consensus"]

JAX_ROW_RUN = 32     # terms per run of XLA:CPU's row reduction
_JAX_GATHER_CAP = 128  # widest row of the JAX gather consensus
# the counter of the kernel launches that ``GatherConsensus.sums`` issues
LAUNCHES = "consensus.launches"


def _row_sums(g: torch.Tensor, run: Optional[int]) -> torch.Tensor:
    """Sums of g [..., w, n] over its w terms, added in index order; with
    ``run``, in runs of ``run`` terms whose sums are then added in order."""
    w = g.shape[-2]
    run = run or w
    total = None
    for c0 in range(0, w, run):
        s = g[..., c0, :]
        for c in range(c0 + 1, min(c0 + run, w)):
            s = s + g[..., c, :]
        total = s if total is None else total + s
    return total


@dataclass
class GatherConsensus:
    class_idx: tuple            # int64 [n_c, width] step indices, sentinel S
    node_slot: torch.Tensor     # int64 [S] step -> slot in degree-sorted order
    inv_cnt: torch.Tensor       # [NL] 1 / degree of each slot's node
    slot_node: torch.Tensor     # int64 [NL] node index of each slot
    run: Optional[int] = None   # terms per summed run; None: one run

    def sums(self, xs: torch.Tensor) -> torch.Tensor:
        """xs [S] or [R, S] -> each slot's node's sum of its steps' values
        ([NL] or [R, NL]), added in the order described above.  Counts
        its launches under ``LAUNCHES``: the zero fill and the two cats,
        and per class of width w one gather and w - 1 adds."""
        x_ext = torch.cat([xs, xs.new_zeros(xs.shape[:-1] + (1,))], dim=-1)
        parts = []
        for ix in self.class_idx:
            parts.append(_row_sums(
                x_ext[..., ix.t()],
                self.run if ix.shape[1] <= _JAX_GATHER_CAP else None))
            trace.count(LAUNCHES, ix.shape[1])
        out = torch.cat(parts, dim=-1)
        trace.count(LAUNCHES, 3)
        return out

    def __call__(self, xs: torch.Tensor):
        """xs [S] or [R, S] -> (xs_new, same shape; xn_sorted [NL] or
        [R, NL] per-node means)."""
        xn = self.sums(xs) * self.inv_cnt
        return xn[..., self.node_slot], xn

    def to_node_order(self, xn_sorted, x_node_init):
        """Means in node order ([N] or [R, N]); nodes with no steps keep
        ``x_node_init`` (the reference leaves their positions
        untouched)."""
        x_node = x_node_init.clone()
        x_node[..., self.slot_node] = xn_sorted
        return x_node


def build_gather_consensus(step_node: np.ndarray, n_nodes: int, device,
                           run: Optional[int] = None,
                           dtype=np.float32) -> GatherConsensus:
    """Class tables for a static step->node map, uploaded to ``device``;
    ``run`` as in :class:`GatherConsensus`; ``dtype``: that of the
    positions (f32 or f64), in which ``1 / degree`` is rounded."""
    step_node = np.asarray(step_node, dtype=np.int64)
    S = int(step_node.shape[0])
    cnt = np.bincount(step_node, minlength=n_nodes)
    order = np.argsort(step_node, kind="stable")
    live = np.flatnonzero(cnt > 0)
    deg = cnt[live]
    starts = (np.cumsum(cnt) - cnt)[live]
    width = np.left_shift(1, np.ceil(np.log2(deg)).astype(np.int64))

    class_idx, slot_node = [], []
    for w in np.unique(width).tolist():
        sel = np.flatnonzero(width == w)
        dg = deg[sel]
        idx = np.full((len(sel), w), S, np.int64)
        rows = np.repeat(np.arange(len(sel)), dg)
        cols = np.arange(int(dg.sum())) - np.repeat(np.cumsum(dg) - dg, dg)
        idx[rows, cols] = order[np.repeat(starts[sel], dg) + cols]
        class_idx.append(idx)
        slot_node.append(live[sel])
    slot_node = (np.concatenate(slot_node) if slot_node
                 else np.zeros(0, np.int64))
    slot_of_node = np.full(n_nodes, -1, np.int64)
    slot_of_node[slot_node] = np.arange(len(slot_node))

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return GatherConsensus(
        class_idx=tuple(up(ix) for ix in class_idx),
        node_slot=up(slot_of_node[step_node]),
        inv_cnt=up((1.0 / np.maximum(cnt[slot_node], 1)).astype(dtype)),
        slot_node=up(slot_node),
        run=run,
    )
