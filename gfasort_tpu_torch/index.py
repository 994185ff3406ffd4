"""Flattened path-step index — the device-resident SoA for the SGD kernels.

Rebuild of the reference ``PathIndex`` (gfasort ``src/sgd.rs:14-108``) as
numpy arrays.  The reference already stores exactly the right
struct-of-arrays layout for a TPU kernel (SURVEY.md §2 row 10); here it
is materialized as dense int arrays that upload to HBM unchanged:

* ``step_handle[s]``   — handle of step ``s``
* ``step_pos[s]``      — cumulative bp offset of step ``s`` in its path
* ``step_path[s]``     — owning path index
* ``step_rank[s]``     — 0-based rank within the path
* ``path_first[p]``, ``path_count[p]``, ``path_len[p]`` — per-path info
* ``step_node_idx[s]`` — dense SGD node index of the step's node
  (precomputed ``handle_to_idx[forward(node)]`` gather so the device
  kernel never touches a hash map; reference looks this up per term at
  ``src/sgd.rs:525-538``)
* ``step_count_of_step[s]`` — ``path_count[step_path[s]]`` (prefetched)

Node-index conventions follow ``src/sgd.rs:275-294``: nodes are indexed
by their order of first insertion (``node_order``, i.e. GFA file order)
when available, else by sorted id; the initial 1D position of node
``idx`` is the cumulative sequence length of all earlier nodes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from .graph import BidirectedGraph
from .trace import spanned

__all__ = ["PathIndex", "sgd_node_ids"]


def sgd_node_ids(graph: BidirectedGraph) -> List[int]:
    """Node iteration order used for SGD position seeding: ``node_order``
    (GFA file order) if it still covers every live node, else sorted
    live ids (src/sgd.rs:276-284).

    Deviation from the reference, on purpose: ``node_order`` is never
    rewritten by renumbering (src/graph_ops.rs keeps it stale), and on
    gapped-id inputs a renumbering step leaves it covering only part of
    the graph.  The reference then silently drops every uncovered node
    from the SGD ordering — ``apply_ordering`` deletes them from the
    graph (and its workers skip their terms with a warning,
    src/sgd.rs:525-538).  We fall back to sorted live ids instead,
    which is bit-identical on dense-id inputs (where node_order always
    covers everything) and non-destructive otherwise."""
    nlen = graph.node_len_array()
    live = np.flatnonzero(nlen >= 0)
    if graph.node_order and len(nlen):
        order = np.asarray(graph.node_order, dtype=np.int64)
        covered = order[(order < len(nlen)) & (nlen[np.minimum(order, len(nlen) - 1)] >= 0)]
        if len(covered) == len(live):
            return covered.tolist()
    return live.tolist()


@dataclass
class PathIndex:
    # step arrays, all shape [S]
    step_handle: np.ndarray
    step_pos: np.ndarray
    step_path: np.ndarray
    step_rank: np.ndarray
    # per-path arrays, all shape [P]
    path_first: np.ndarray
    path_count: np.ndarray
    path_len: np.ndarray
    # node indexing (SGD convention)
    node_ids: np.ndarray          # [N] node id of dense index idx
    node_len: np.ndarray          # [N] sequence length
    handle_to_idx: Dict[int, int]  # node_id -> dense idx (live nodes only)
    step_node_idx: np.ndarray     # [S] dense idx of each step's node
    step_count_of_step: np.ndarray  # [S] step count of the step's path

    @classmethod
    @spanned("index.build")
    def from_graph(cls, graph: BidirectedGraph) -> "PathIndex":
        handles, poss, pths, rnks = [], [], [], []
        counts, lens = [], []

        # node length lookup by id (dead slots clamp to 0)
        nlen_raw = graph.node_len_array()
        nlen = np.maximum(nlen_raw, 0)
        if len(nlen) == 0:
            nlen = np.zeros(1, dtype=np.int64)

        for p, path in enumerate(graph.paths):
            steps = path.steps
            ids = (steps >> 1).astype(np.int64)
            # cumulative bp offset: position of step k = sum of node
            # lengths of steps 0..k-1 (src/sgd.rs:45-55)
            lengths = nlen[np.clip(ids, 0, len(nlen) - 1)]
            pos = np.concatenate([[0], np.cumsum(lengths)[:-1]]) if len(steps) else np.zeros(0, dtype=np.int64)
            handles.append(steps.astype(np.int64))
            poss.append(pos.astype(np.int64))
            pths.append(np.full(len(steps), p, dtype=np.int32))
            rnks.append(np.arange(len(steps), dtype=np.int64))
            counts.append(len(steps))
            lens.append(int(lengths.sum()) if len(steps) else 0)

        step_handle = np.concatenate(handles) if handles else np.zeros(0, dtype=np.int64)
        step_pos = np.concatenate(poss) if poss else np.zeros(0, dtype=np.int64)
        step_path = np.concatenate(pths) if pths else np.zeros(0, dtype=np.int32)
        step_rank = np.concatenate(rnks) if rnks else np.zeros(0, dtype=np.int64)
        path_count = np.asarray(counts, dtype=np.int64)
        path_first = np.concatenate([[0], np.cumsum(path_count)[:-1]]).astype(np.int64) if len(counts) else np.zeros(0, dtype=np.int64)
        path_len = np.asarray(lens, dtype=np.int64)

        # SGD node indexing (src/sgd.rs:275-294); sgd_node_ids already
        # returns live nodes only
        node_ids = np.asarray(sgd_node_ids(graph), dtype=np.int64)
        node_len = nlen[node_ids] if len(node_ids) else np.zeros(0, dtype=np.int64)
        handle_to_idx = dict(
            zip(node_ids.tolist(), range(len(node_ids)))
        )

        if len(step_handle):
            lut = np.full(len(graph.nodes) + 1, -1, dtype=np.int64)
            lut[node_ids] = np.arange(len(node_ids), dtype=np.int64)
            step_node_idx = lut[step_handle >> 1]
        else:
            step_node_idx = np.zeros(0, dtype=np.int64)
        step_count_of_step = (
            path_count[step_path] if len(step_handle) else np.zeros(0, dtype=np.int64)
        )

        return cls(
            step_handle=step_handle,
            step_pos=step_pos,
            step_path=step_path,
            step_rank=step_rank,
            path_first=path_first,
            path_count=path_count,
            path_len=path_len,
            node_ids=node_ids,
            node_len=node_len,
            handle_to_idx=handle_to_idx,
            step_node_idx=step_node_idx,
            step_count_of_step=step_count_of_step,
        )

    # -- accessors mirroring src/sgd.rs:73-107 -------------------------
    @property
    def total_steps(self) -> int:
        return int(self.step_handle.shape[0])

    @property
    def num_paths(self) -> int:
        return int(self.path_count.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.node_ids.shape[0])

    def step_at(self, path_idx: int, rank: int) -> int:
        return int(self.path_first[path_idx]) + rank

    # -- graph-derived hyperparameter stats (src/ygs.rs:61-79,
    #    src/sgd.rs:739-743) -------------------------------------------
    @property
    def sum_path_step_count(self) -> int:
        return int(self.path_count.sum())

    @property
    def max_path_step_count(self) -> int:
        return int(self.path_count.max()) if self.num_paths else 0

    @property
    def max_path_length(self) -> int:
        return int(self.path_len.max()) if self.num_paths else 0

    def has_multi_step_path(self) -> bool:
        return bool((self.path_count > 1).any())

    def initial_positions(self) -> np.ndarray:
        """x0[idx] = cumulative bp length in node-order (src/sgd.rs:286-294)."""
        if self.num_nodes == 0:
            return np.zeros(0, dtype=np.float64)
        return np.concatenate([[0], np.cumsum(self.node_len)[:-1]]).astype(np.float64)
