"""Unchop: merge linear handle-chains into single nodes.

Reproduces the reference compaction (gfasort
``src/graph_ops.rs:104-498``): ``compact`` loops to fixpoint; each round
finds simple components — maximal handle chains where every step has
out-degree 1 / in-degree 1 in the doubled (direct + implied-reverse)
adjacency AND passes the perfect-neighbor path test in both orientations
— then merges each chain into a fresh node (id = ``len(nodes)``),
validating that every path contains chain handles only as complete
forward or reverse runs before mutating.

The reference's ``are_perfect_neighbors`` rescans every path per
candidate pair (O(chains · steps)); here the path-successor structure is
precomputed once per round: ``succ_ok[h]`` is the unique handle that
always follows ``h`` across all paths (absent if ``h`` never occurs;
None if occurrences conflict or any occurrence ends a path), which gives
the same predicate in O(1) per pair.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import handle as H

__all__ = [
    "compact",
    "find_simple_components",
    "merge_component",
    "merge_components",
]

_CONFLICT = object()


def _path_successor_map(graph) -> Dict[int, object]:
    """h -> unique successor handle across all path occurrences, or
    _CONFLICT if occurrences disagree / any occurrence is path-final.

    Encodes exactly the reference predicate (src/graph_ops.rs:155-214):
    ``are_perfect_neighbors(from, to)`` is
    ``succ.get(from) in (absent, to) and succ.get(flip(to)) in (absent,
    flip(from))`` where absent = never occurs.
    """
    succ: Dict[int, object] = {}
    for path in graph.paths:
        steps = path.steps.tolist()
        for i, h in enumerate(steps):
            nxt = steps[i + 1] if i + 1 < len(steps) else _CONFLICT
            cur = succ.get(h)
            if cur is None:
                succ[h] = nxt
            elif cur is not nxt and cur != nxt:
                succ[h] = _CONFLICT
    return succ


def find_simple_components(graph) -> List[List[int]]:
    """Maximal mergeable chains (src/graph_ops.rs:128-287).  Scans
    handles in id order (forward then reverse per node), extending a
    chain while the doubled adjacency stays 1-in/1-out and the path
    test passes."""
    if len(graph.edges) >= 2048:
        from .native_dispatch import native_simple_components

        out = native_simple_components(graph)
        if out is not None:
            return out

    # Doubled adjacency (direct + implied reverse) (:139-152).
    fwd: Dict[int, List[int]] = {}
    bwd: Dict[int, List[int]] = {}
    for f, t in graph.edges:
        fwd.setdefault(f, []).append(t)
        bwd.setdefault(t, []).append(f)
        fwd.setdefault(H.flip(t), []).append(H.flip(f))
        bwd.setdefault(H.flip(f), []).append(H.flip(t))

    succ = _path_successor_map(graph)

    def perfect(a: int, b: int) -> bool:
        sa = succ.get(a)
        if sa is _CONFLICT or (sa is not None and sa != b):
            return False
        sb = succ.get(H.flip(b))
        if sb is _CONFLICT or (sb is not None and sb != H.flip(a)):
            return False
        return True

    components: List[List[int]] = []
    visited = set()
    merged_nodes = set()

    for nid in graph.live_node_ids():
        for handle in (H.forward(nid), H.reverse(nid)):
            if handle in visited:
                continue
            nexts = fwd.get(handle, ())
            if len(nexts) != 1:
                continue
            chain = [handle]
            visited.add(handle)
            current = handle
            while True:
                nexts = fwd.get(current, ())
                if len(nexts) != 1:
                    break
                nxt = nexts[0]
                if len(bwd.get(nxt, ())) != 1 or nxt in visited:
                    break
                if not perfect(current, nxt):
                    break
                chain.append(nxt)
                visited.add(nxt)
                current = nxt
                if len(fwd.get(nxt, ())) != 1:
                    break
            if len(chain) >= 2:
                if not any(H.node_id(h) in merged_nodes for h in chain):
                    merged_nodes.update(H.node_id(h) for h in chain)
                    components.append(chain)
    return components


def _match_starts(steps: np.ndarray, chain: np.ndarray) -> np.ndarray:
    """Start indices where ``chain`` occurs completely in ``steps``."""
    k, n = len(chain), len(steps)
    starts = np.flatnonzero(steps == chain[0])
    starts = starts[starts + k <= n]
    ok = np.ones(len(starts), dtype=bool)
    for j in range(1, k):
        ok &= steps[starts + j] == chain[j]
    return starts[ok]


def _plan_path_rewrite(
    steps: np.ndarray, chain: np.ndarray, rev_chain: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Validate + plan the rewrite of one path: returns
    (forward_run_starts, reverse_run_starts) of the reference's greedy
    left-to-right scan (src/graph_ops.rs:330-427, forward preferred),
    or None if a chain handle occurs outside a complete run."""
    member = np.isin(steps, chain) | np.isin(steps, rev_chain)
    if not member.any():
        z = np.zeros(0, dtype=np.int64)
        return z, z
    f_starts = _match_starts(steps, chain)
    r_starts = _match_starts(steps, rev_chain)
    k = len(chain)
    if not set(chain.tolist()) & set(rev_chain.tolist()):
        # Disjoint handle sets: runs cannot overlap (chain handles are
        # unique), the vectorized result equals the greedy scan.
        covered = np.zeros(len(steps), dtype=bool)
        for s in np.concatenate([f_starts, r_starts]).tolist():
            covered[s : s + k] = True
        if (member & ~covered).any():
            return None
        return f_starts, r_starts
    # Hairpin chain (contains both orientations of some node): runs may
    # overlap — replay the reference's greedy scan over the candidate
    # positions only.
    fset, rset = set(f_starts.tolist()), set(r_starts.tolist())
    cand = sorted(set(np.flatnonzero(member).tolist()))
    f_sel, r_sel = [], []
    i = 0
    n = len(steps)
    ci = 0
    while i < n:
        while ci < len(cand) and cand[ci] < i:
            ci += 1
        if ci >= len(cand):
            break
        i = cand[ci]
        if i in fset:
            f_sel.append(i)
            i += k
        elif i in rset:
            r_sel.append(i)
            i += k
        else:
            return None
    return (
        np.asarray(f_sel, dtype=np.int64),
        np.asarray(r_sel, dtype=np.int64),
    )


def merge_component(graph, handles: List[int]) -> bool:
    """Merge a chain into one node (src/graph_ops.rs:291-498).  Returns
    False (graph untouched) if any path uses a chain handle outside a
    complete forward or reverse run."""
    if len(handles) < 2:
        return False

    chain = np.asarray(handles, dtype=np.int64)
    rev_chain = (chain ^ 1)[::-1].copy()

    # Validate every path first (:330-377).
    fwd_runs, rev_runs = [], []
    for path in graph.paths:
        plan = _plan_path_rewrite(path.steps, chain, rev_chain)
        if plan is None:
            return False
        fwd_runs.append(plan[0])
        rev_runs.append(plan[1])

    # Concatenate oriented sequences (:302-311).
    parts = []
    for h in handles:
        seq = graph.get_sequence(int(h))
        if seq is not None:
            parts.append(seq)
    new_seq = b"".join(parts)

    new_id = len(graph.nodes)  # next_node_id (:500-502)
    new_fwd = H.forward(new_id)
    new_rev = H.reverse(new_id)
    graph.add_node(new_id, new_seq)

    # Rewrite paths (:383-427): replace each complete run by one handle.
    k = len(chain)
    for path, f_starts, r_starts in zip(graph.paths, fwd_runs, rev_runs):
        if len(f_starts) == 0 and len(r_starts) == 0:
            continue
        steps = path.steps
        repl = np.full(len(steps), -1, dtype=np.int64)
        drop = np.zeros(len(steps), dtype=bool)
        for s in f_starts.tolist():
            repl[s] = new_fwd
            drop[s + 1 : s + k] = True
        for s in r_starts.tolist():
            repl[s] = new_rev
            drop[s + 1 : s + k] = True
        out = np.where(repl >= 0, repl, steps)
        path.steps = out[~drop]

    # Reroute boundary edges (:429-487).
    first, last = handles[0], handles[-1]
    merged_ids = {H.node_id(h) for h in handles}
    new_edges = set()
    for f, t in graph.edges:
        f_in = H.node_id(f) in merged_ids
        t_in = H.node_id(t) in merged_ids
        if f_in and t_in:
            continue  # internal edge
        if not f_in and not t_in:
            new_edges.add((f, t))
        elif f_in:
            if f == last:
                new_edges.add((new_fwd, t))
            if f == H.flip(first):
                new_edges.add((new_rev, t))
        else:
            if t == first:
                new_edges.add((f, new_fwd))
            if t == H.flip(last):
                new_edges.add((f, new_rev))
    graph.edges = new_edges

    # Delete old nodes (:489-495).
    for h in handles:
        nid = H.node_id(h)
        if nid < len(graph.nodes):
            graph.nodes[nid] = None
            graph.ranks.pop(nid, None)
    return True


def merge_components(graph, comps: List[List[int]]) -> int:
    """Batched merge of node-disjoint, repetition-free chains — the
    state after this equals applying :func:`merge_component` to each
    chain in order (chains are node-disjoint by construction, so one
    chain's path/edge rewrites never affect another's validation, and
    new ids are assigned to the successful merges in order).  Replaces
    the reference's per-component full path+edge rewrite
    (src/graph_ops.rs:291-498), which is quadratic when a graph has many
    chains.  Returns the number of chains merged."""
    if not comps:
        return 0
    C = len(comps)
    k_of = np.asarray([len(c) for c in comps], dtype=np.int64)
    chains_flat = np.concatenate([np.asarray(c, dtype=np.int64) for c in comps])
    chain_ids = chains_flat >> 1
    chain_cid = np.repeat(np.arange(C, dtype=np.int64), k_of)
    chain_pos = np.concatenate([np.arange(k, dtype=np.int64) for k in k_of])

    max_id = int(chain_ids.max())
    for path in graph.paths:
        if len(path):
            max_id = max(max_id, int(path.steps.max() >> 1))
    if graph.edges:
        ef, et = graph.edges_to_arrays()
        if len(ef):
            max_id = max(max_id, int(ef.max() >> 1), int(et.max() >> 1))
    else:
        ef = et = np.zeros(0, np.int64)

    # per-node tables (each node occurs in at most one chain, once)
    cid_of = np.full(max_id + 1, -1, dtype=np.int64)
    pos_of = np.zeros(max_id + 1, dtype=np.int64)
    ori_of = np.zeros(max_id + 1, dtype=np.int64)
    cid_of[chain_ids] = chain_cid
    pos_of[chain_ids] = chain_pos
    ori_of[chain_ids] = chains_flat & 1

    # ---- validation: every occurrence of a chain node must sit inside
    # a complete forward or reverse run (src/graph_ops.rs:330-377) ----
    valid = np.ones(C, dtype=bool)

    def _analyze(steps):
        ids = steps >> 1
        cid = cid_of[ids]
        member = cid >= 0
        j = pos_of[ids]
        ori = (steps & 1) ^ ori_of[ids]
        kk = k_of[np.maximum(cid, 0)]
        n = len(steps)
        same_prev = np.zeros(n, dtype=bool)
        same_prev[1:] = cid[1:] == cid[:-1]
        same_next = np.zeros(n, dtype=bool)
        same_next[:-1] = cid[:-1] == cid[1:]
        jp = np.empty(n, dtype=np.int64)
        jp[1:] = j[:-1]
        jp[0] = -9
        jn = np.empty(n, dtype=np.int64)
        jn[:-1] = j[1:]
        jn[-1] = -9
        op = np.empty(n, dtype=np.int64)
        op[1:] = ori[:-1]
        op[0] = -9
        on = np.empty(n, dtype=np.int64)
        on[:-1] = ori[1:]
        on[-1] = -9
        fwd = member & (ori == 0)
        rev = member & (ori == 1)
        f_ok = (
            ((j == 0) | (same_prev & (op == 0) & (jp == j - 1)))
            & ((j == kk - 1) | (same_next & (on == 0) & (jn == j + 1)))
        )
        r_ok = (
            ((j == kk - 1) | (same_prev & (op == 1) & (jp == j + 1)))
            & ((j == 0) | (same_next & (on == 1) & (jn == j - 1)))
        )
        bad = (fwd & ~f_ok) | (rev & ~r_ok)
        return cid, member, j, ori, kk, bad

    analyses = []
    for path in graph.paths:
        if not len(path):
            analyses.append(None)
            continue
        a = _analyze(path.steps)
        analyses.append(a)
        bad_cids = a[0][a[5]]
        if len(bad_cids):
            valid[np.unique(bad_cids)] = False

    n_merged = int(valid.sum())
    if n_merged == 0:
        return 0

    # new node ids, in chain order over the successful merges
    base = len(graph.nodes)
    new_id = np.full(C, -1, dtype=np.int64)
    new_id[valid] = base + np.arange(n_merged, dtype=np.int64)

    # ---- create merged nodes (concat oriented sequences, :302-311).
    # Lean loop (r5): direct node-list access + a local RC instead of
    # get_sequence's per-call dispatch; bulk-extend the node list and
    # node_order once instead of per-add_node bookkeeping (this loop
    # visits every merged-away node and dominated genome-scale unchop
    # wall time).  Equivalent to add_node on fresh ids past the end.
    nodes_l = graph.nodes
    rc = H.reverse_complement
    valid_cs = np.flatnonzero(valid).tolist()
    nodes_l.extend([None] * (base + n_merged - len(nodes_l)))
    for c in valid_cs:
        parts = []
        for h in comps[c]:
            s = nodes_l[h >> 1]
            if s is not None:
                parts.append(rc(s) if (h & 1) else s)
        nodes_l[int(new_id[c])] = b"".join(parts)
    graph.node_order.extend(int(new_id[c]) for c in valid_cs)

    # ---- rewrite paths: replace each complete run by one handle ----
    for path, a in zip(graph.paths, analyses):
        if a is None:
            continue
        cid, member, j, ori, kk, _bad = a
        hit = member & valid[np.maximum(cid, 0)]
        if not hit.any():
            continue
        f_start = hit & (ori == 0) & (j == 0)
        r_start = hit & (ori == 1) & (j == kk - 1)
        steps = path.steps.copy()
        steps[f_start] = new_id[cid[f_start]] << 1
        steps[r_start] = (new_id[cid[r_start]] << 1) | 1
        path.steps = steps[~(hit & ~f_start & ~r_start)]

    # ---- rewrite edges (boundary rerouting, :429-487) ----
    first = np.asarray([c[0] for c in comps], dtype=np.int64)
    last = np.asarray([c[-1] for c in comps], dtype=np.int64)

    def _side(h, is_from):
        """Per-endpoint candidate handles + mask of which exist:
        returns (keep_mask, cand1, m1, cand2, m2, cid)."""
        nid = h >> 1
        c = cid_of[nid]
        merged = (c >= 0) & valid[np.maximum(c, 0)]
        cs = np.maximum(c, 0)
        if is_from:
            m1 = merged & (h == last[cs])          # -> new_fwd
            m2 = merged & (h == (first[cs] ^ 1))   # -> new_rev
        else:
            m1 = merged & (h == first[cs])         # -> new_fwd
            m2 = merged & (h == (last[cs] ^ 1))    # -> new_rev
        cand1 = new_id[cs] << 1
        cand2 = (new_id[cs] << 1) | 1
        return ~merged, cand1, m1, cand2, m2, cs, merged

    if len(ef):
        fk, f1, fm1, f2, fm2, fc, fmerged = _side(ef, True)
        tk, t1, tm1, t2, tm2, tc, tmerged = _side(et, False)
        internal = fmerged & tmerged & (fc == tc)
        outs_f = []
        outs_t = []
        # from-side options x to-side options (sequential composition of
        # the two chains' reroutes; up to 4 results per edge)
        for f_opt, f_m in ((ef, fk), (f1, fm1), (f2, fm2)):
            for t_opt, t_m in ((et, tk), (t1, tm1), (t2, tm2)):
                m = f_m & t_m & ~internal
                if m.any():
                    outs_f.append(f_opt[m])
                    outs_t.append(t_opt[m])
        nef = np.concatenate(outs_f) if outs_f else np.zeros(0, np.int64)
        net = np.concatenate(outs_t) if outs_t else np.zeros(0, np.int64)
        from ..graph import EdgeSet

        if (len(nef) >= 4096
                and max(int(nef.max()), int(net.max())) < (1 << 32)):
            # array-mode rebuild with packed-u64 dedup (r5): the C
            # set build still churned ~3 PyObjects per edge
            key = np.unique(
                (nef.astype(np.uint64) << np.uint64(32))
                | net.astype(np.uint64)
            )
            graph.edges = EdgeSet.from_arrays(
                (key >> np.uint64(32)).astype(np.int64),
                (key & np.uint64(0xFFFFFFFF)).astype(np.int64),
            )
        else:
            graph.edges = set(zip(nef.tolist(), net.tolist()))

    # ---- delete merged-away nodes (:489-495) ----
    dead = chain_ids[valid[chain_cid]]
    for nid in dead.tolist():
        if nid < len(graph.nodes):
            graph.nodes[nid] = None
            graph.ranks.pop(nid, None)
    return n_merged


def compact(graph) -> None:
    """Loop find+merge to fixpoint (src/graph_ops.rs:104-125).

    Chains from one round are node-disjoint and (bar hairpins) free of
    within-chain node repeats, so they are merged in one batched pass;
    hairpin chains (both orientations of a node in one chain) fall back
    to the sequential per-component merge, flushed in discovery order so
    new-id assignment matches the sequential semantics exactly."""
    while True:
        compacted = False
        batch: List[List[int]] = []
        comps = find_simple_components(graph)
        for component in comps + [None]:
            hairpin = component is not None and len(
                {h >> 1 for h in component}
            ) < len(component)
            if component is not None and not hairpin:
                if len(component) >= 2:
                    batch.append(component)
                continue
            if batch:
                if merge_components(graph, batch) > 0:
                    compacted = True
                batch = []
            if component is not None and len(component) >= 2:
                if merge_component(graph, component):
                    compacted = True
        if not compacted:
            break
