"""The batched-synchronous path SGD engines (1D sort and nD layout) in
PyTorch.

Counterpart of ``gfasort_tpu/ops/sgd.py`` (same names, signatures and
return contracts, plus ``device=``), reached by ``--engine batched``.
Each round samples B terms, computes their updates against the round's
snapshot of the positions, and applies the mean of each node's updates:
``x + dsum / max(cnt, 1)``.  R = (iter_max + 1) x ceil(mtu / B) rounds;
round ``r`` draws from ``fold_in(seed_key, r)``.

What the round draws never depends on the positions: the sampled pairs,
their validity, term distances and learning rates are a function of the
key, the round's eta and cooling flag, and the static path index.  So
the engine draws them for a chunk of rounds at once (one
``[rounds, B]`` tensor per draw, the ``jax.random`` threefry draws of
:mod:`.jrandom`), and the round loop only gathers positions, computes
the updates and applies them.  The JAX ``lax.cond(cooling, ...)`` is a
branch on the host: chunks never straddle the first cooling round.

**Summing order.**  The JAX engine scatters ``-r`` at the first nodes
and then ``+r`` at the second ones (``zeros.at[i].add(...).at[j]
.add(...)``); XLA:CPU adds each node's terms one by one in that order.
A CUDA ``index_add_`` adds in atomic order, which changes from run to
run.  The port sorts the round's 2B destinations stably (first nodes
before second ones, each in draw order) once per chunk, and adds each
node's terms in that order from a ``[2B, M]`` gather table (M: the
chunk's largest number of valid terms on one node), so every run on
every device sums alike.  Invalid terms add a zero and are left out:
an exact zero never changes a sum that starts at +0.  Rounds past the
schedule (eta 0, the checkpoint runner's padding) change nothing and
are skipped.

**Launches.**  Eager torch launches ~25 kernels per round, whose host
cost bounds the loop.  On the card the round loop is captured once per
run as a CUDA graph of 64 rounds and replayed over the chunks' rounds
(:class:`_ChunkGraphs`): the same kernels on the same inputs, so the
same result.  The loop has no host sync; each chunk has one (its table
width M).

Draws in f64 (``pow_mode="fpp"``, the default) use no transcendental
function, so the engine reproduces the JAX engine bit for bit; in
``"fast"`` mode the f32/f64 ``exp``/``log`` of torch and XLA differ in
the last place.  The JAX engine turns ``jax_enable_x64`` on for
``"fpp"``; its Bernoulli coins are then f64 draws, and the port always
draws them so (:func:`.keys.bernoulli`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..graph import BidirectedGraph
from ..index import PathIndex
from ..io.layout_tsv import Layout
from ..params import LayoutSGDParams, PathSGDParams
from . import jrandom
from .fastpow import fast_precise_pow_np, fast_precise_pow_torch, zeta_table
from .keys import fold_in, key_data, split
from .schedule import eta_schedule
from .sweep_dense import sqrt_rn

__all__ = [
    "DeviceIndex",
    "build_1d_runner",
    "build_layout_runner",
    "build_schedule",
    "effective_batch",
    "path_linear_sgd_batched",
    "path_sgd_sort_batched",
    "path_linear_sgd_layout_batched",
]

_NP = {"float32": np.float32, "float64": np.float64}
_TORCH = {np.float32: torch.float32, np.float64: torch.float64}
# terms drawn per chunk of rounds (2B destinations per round)
_CHUNK_TERMS = 1 << 22
# rounds per CUDA-graph replay of the round loop (on the card)
_GRAPH_ROUNDS = 64


@dataclass(frozen=True)
class DeviceIndex:
    """Path index arrays on the device."""

    step_path: torch.Tensor     # [S] int64
    step_rank: torch.Tensor     # [S] int32
    step_pos: torch.Tensor      # [S] float (bp offset)
    step_node: torch.Tensor     # [S] int64 (dense SGD node index)
    step_rev: torch.Tensor      # [S] int64 (orientation bit; nD only)
    path_first: torch.Tensor    # [P] int32
    path_count: torch.Tensor    # [P] int32
    node_len: torch.Tensor      # [N] float (nD only)
    total_steps: int
    num_nodes: int

    @classmethod
    def from_path_index(cls, pidx: PathIndex, dtype=np.float32,
                        device="cpu") -> "DeviceIndex":
        dev = resolve_device(device)

        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a.astype(dt))).to(dev)

        return cls(
            step_path=up(pidx.step_path, np.int64),
            step_rank=up(pidx.step_rank, np.int32),
            step_pos=up(pidx.step_pos, dtype),
            step_node=up(pidx.step_node_idx, np.int64),
            step_rev=up(pidx.step_handle & 1, np.int64),
            path_first=up(pidx.path_first, np.int32),
            path_count=up(pidx.path_count, np.int32),
            node_len=up(pidx.node_len, dtype),
            total_steps=pidx.total_steps,
            num_nodes=pidx.num_nodes,
        )


def build_schedule(params, batch: int):
    """Per-round eta/cooling arrays.  Returns (etas_r, cooling_r,
    rounds_per_iter, n_rounds)."""
    etas = eta_schedule(
        1.0 / params.eta_max, 1.0, params.iter_max,
        params.iter_with_max_learning_rate, params.eps,
    )
    rpi = max(1, -(-params.min_term_updates // batch))  # ceil
    fci = params.first_cooling_iteration
    round_eta = np.repeat(etas, rpi)
    round_cooling = np.repeat(
        np.arange(params.iter_max + 1) > fci, rpi
    )
    return round_eta, round_cooling, rpi, len(round_eta)


def effective_batch(params) -> int:
    """Clamp the round width to min_term_updates so small graphs keep
    the reference's per-iteration work (a round never attempts more
    than one iteration's worth of terms)."""
    return max(1, min(int(params.batch), int(params.min_term_updates)))


def _pow_builder(pow_mode: str, sample_dtype):
    """Returns (powf(a, b, e_static) on tensors, the same on host
    scalars) honoring the parity mode; ``b`` is a host scalar of
    ``sample_dtype``."""
    if pow_mode == "fpp":
        def powf(a, b, e):
            return fast_precise_pow_torch(a, float(b), e).to(a.dtype)

        def powf_host(a, b, e):  # noqa: ARG001 (e is trunc(b))
            return sample_dtype(fast_precise_pow_np(np.float64(a), float(b)))

        return powf, powf_host

    def powf(a, b, e):  # noqa: ARG001 (e unused in fast mode)
        return torch.where(
            a > 0, torch.exp(float(b) * torch.log(torch.clamp_min(a, 1e-30))),
            0.0)

    def powf_host(a, b, e):  # noqa: ARG001
        a = sample_dtype(a)
        return sample_dtype(np.exp(b * np.log(max(a, sample_dtype(1e-30))))
                            if a > 0 else 0.0)

    return powf, powf_host


def _make_sampler(di: DeviceIndex, params, zetas: np.ndarray, sample_dtype,
                  batch: Optional[int] = None):
    """Builds sample_pairs(keys, cooling, lo, span) -> (sa, sb, valid),
    each [R, B]: the shared Zipfian second-step sampler
    (src/sgd.rs:442-516 semantics, vectorized over R rounds).  ``keys``:
    int64 [R, 5, 2] on the device, the round keys' ``split(key, 5)``;
    ``cooling`` is the rounds' common cooling flag (a host bool)."""
    powf, powf_host = _pow_builder(params.pow_mode, sample_dtype)
    sd = sample_dtype
    tsd = _TORCH[sd]
    theta0 = float(params.theta)
    theta_cool = 0.001
    alpha_e0 = int(1.0 / (1.0 - theta0)) if theta0 != 1.0 else 0
    alpha_e1 = int(1.0 / (1.0 - theta_cool))
    space = int(params.space)
    space_max = int(params.space_max)
    quant = int(params.space_quantization_step)
    B = int(batch) if batch is not None else effective_batch(params)
    dev = di.step_pos.device
    zetas_t = torch.from_numpy(np.asarray(zetas, dtype=sd)).to(dev)

    def zipf_ranks(u, jump_space, theta, alpha_e):
        """Vectorized DirtyZipfian over [1, jump_space]
        (src/sgd.rs:110-151); the scalar constants on the host in the
        sample dtype."""
        theta = sd(theta)
        n = torch.clamp_min(jump_space, 1).to(tsd)
        si = torch.clamp_max(
            torch.where(
                jump_space > space_max,
                space_max + torch.div(jump_space - space_max, quant,
                                      rounding_mode="floor") + 1,
                jump_space,
            ),
            len(zetas) - 1,
        ).long()
        zeta = zetas_t[si]
        zeta2theta = sd(1.0) + powf_host(sd(0.5), theta, 0)
        one_m_theta = sd(1.0) - theta
        alpha = sd(1.0) / one_m_theta
        eta_z = (1.0 - powf(2.0 / n, one_m_theta, 0)) / (
            1.0 - float(zeta2theta) / zeta)
        uz = u * zeta
        general = 1.0 + n * powf(eta_z * u - eta_z + 1.0, alpha, alpha_e)
        general = torch.where(torch.isnan(general), 0.0, general)
        g = torch.minimum(torch.clamp_min(general, 0.0), n).to(torch.int32)
        z = torch.where(uz < 1.0, 1, torch.where(uz < float(zeta2theta), 2, g))
        return torch.minimum(z, jump_space).to(torch.int32)

    def sample_pairs(keys, cooling: bool, lo, span):
        """Sample B (step_a, step_b) pairs per round from steps
        [lo, lo+span)."""
        sa = lo + jrandom.randint(keys[:, 0], (B,), 0, span)
        sa_l = sa.long()
        p = di.step_path[sa_l]
        cnt = di.path_count[p]
        rank_a = di.step_rank[sa_l]

        backward = (rank_a > 0) & (jrandom.bernoulli(keys[:, 2], 0.5, (B,))
                                   | (rank_a == cnt - 1))
        forward = (~backward) & (rank_a < cnt - 1)
        avail = torch.where(backward, rank_a, cnt - 1 - rank_a)
        jump_space = torch.clamp_max(avail, space)

        u = jrandom.uniform(keys[:, 3], (B,), tsd)
        z = (zipf_ranks(u, jump_space, theta_cool, alpha_e1) if cooling
             else zipf_ranks(u, jump_space, theta0, alpha_e0))
        rank_b = torch.where(
            backward,
            rank_a - torch.minimum(z, rank_a),
            torch.where(forward, torch.minimum(rank_a + z, cnt - 1), rank_a),
        )
        if not cooling:
            # a cooling round always takes the Zipf rank (cooling | coin1)
            coin1 = jrandom.bernoulli(keys[:, 1], 0.5, (B,))
            rank_b_unif = jrandom.randint(keys[:, 4], (B,), 0,
                                          torch.clamp_min(cnt, 1))
            rank_b = torch.where(coin1, rank_b, rank_b_unif)

        valid = (cnt != 1) & (rank_a != rank_b)
        sb = di.path_first[p] + rank_b
        return sa_l, sb.long(), valid

    return sample_pairs


def _round_keys(base_key, rounds: np.ndarray, extra: int, device):
    """int64 [R, 5 + extra, 2] on ``device``: per round, the sampler's
    ``split(key, 5)`` and ``extra`` more keys, where ``key`` is
    ``fold_in(base_key, r)`` (1D, extra 0) or the first of its
    ``split(., 1 + extra)`` (nD: kmain, ka, kb)."""
    keys = fold_in(np.asarray(base_key, np.uint32), rounds)
    if extra:
        sub = split(keys, 1 + extra)
        keys, rest = sub[:, 0], sub[:, 1:]
        table = np.concatenate([split(keys, 5), rest], axis=1)
    else:
        table = split(keys, 5)
    return torch.from_numpy(table.astype(np.int64)).to(device)


def _fold_tables(dest: torch.Tensor, valid2: torch.Tensor, n_rows: int):
    """Per round, the order in which the JAX scatter-add sums each
    destination row's terms.  ``dest``: int64 [R, 2B] destination rows
    (first nodes, then second nodes); ``valid2``: bool [R, 2B].  Returns
    (table int64 [R, 2B, M] of term indices, 2B for "add nothing";
    tgt int64 [R, 2B] rows, ``n_rows`` (a dummy row) where a slot holds
    no segment; cnt int64 [R, 2B] valid terms per slot, 1 where none).
    Slot ``p`` of a round holds the segment that starts at sorted
    position ``p``; its c-th term is the c-th of that row's valid terms
    in draw order."""
    R, T = dest.shape
    key = torch.where(valid2, dest, n_rows)
    skey, order = torch.sort(key, dim=1, stable=True)
    head = torch.ones_like(valid2)
    head[:, 1:] = skey[:, 1:] != skey[:, :-1]
    posn = torch.arange(T, device=dest.device).expand(R, T)
    start = torch.cummax(torch.where(head, posn, 0), dim=1).values
    seglen = torch.zeros_like(start).scatter_add_(1, start,
                                                  torch.ones_like(start))
    live = head & (skey != n_rows)
    M = int(torch.where(live, seglen, 0).max()) if T else 0   # one sync
    cols = []
    for c in range(max(M, 1)):
        take = order.gather(1, torch.clamp_max(posn + c, T - 1))
        cols.append(torch.where(live & (seglen > c), take, T))
    table = torch.stack(cols, dim=-1)
    tgt = torch.where(live, skey, n_rows)
    cnt = torch.where(live, seglen, 1)
    return table, tgt, cnt


def _row_sums(g: torch.Tensor) -> torch.Tensor:
    """g [T, M, ...] -> the sums over M, added in index order to +0, as
    the scatter-add adds to its zeros (``t + 0.0`` is ``0.0 + t``): a
    sum is never -0, so trailing zero terms change nothing."""
    s = g[:, 0] + 0.0
    for c in range(1, g.shape[1]):
        s = s + g[:, c]
    return s


class _ChunkGraphs:
    """The round loop as a CUDA graph of ``_GRAPH_ROUNDS`` rounds.
    ``loop(state, table, *rest)`` runs rounds in place on ``state`` from
    their [R, ...] tensors; ``table`` [R, T, M] holds term indices,
    ``pad`` (the zero term) where a slot has fewer than M terms.  The
    first block of a run runs eagerly, then the loop is captured over
    static copies of its inputs; every later whole block fills the
    copies (``table`` padded with ``pad`` to the captured width) and
    replays the graph; a chunk's remainder runs eagerly.  A block wider
    than the captured M runs eagerly and is captured anew.  The same
    kernels on the same inputs: the result is the eager loop's, bit for
    bit."""

    def __init__(self, loop, state, pad: int):
        self.loop, self.state, self.pad = loop, state, pad
        self.graph, self.statics = None, None

    def __call__(self, table, *rest):
        G = _GRAPH_ROUNDS
        R = table.shape[0]
        for r in range(0, R - R % G, G):
            block = [t[r:r + G] for t in (table,) + rest]
            M = table.shape[-1]
            if self.graph is None or self.statics[0].shape[-1] < M:
                self.loop(self.state, *block)
                self.statics = [t.clone() for t in block]
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    self.loop(self.state, *self.statics)
                continue
            self.statics[0][..., :M].copy_(block[0])
            self.statics[0][..., M:].fill_(self.pad)
            for dst, src in zip(self.statics[1:], block[1:]):
                dst.copy_(src)
            self.graph.replay()
        if R % G:
            self.loop(self.state, *(t[R - R % G:] for t in (table,) + rest))


def _chunk_runner(loop, state, pad: int):
    """``run(table, *rest)`` for one run: CUDA graphs on the card
    (:class:`_ChunkGraphs`), the eager loop elsewhere."""
    if state.device.type == "cuda":
        return _ChunkGraphs(loop, state, pad)
    return lambda table, *rest: loop(state, table, *rest)


def _rounds_1d(xe, table, ij, mu, safe, valid_r, tgt, cnt):
    """The 1D round body over a chunk, in place on ``xe`` [N + 1] (the
    last row a dummy target): per round, the B terms' updates against
    the round's snapshot, then each node's terms summed in the JAX
    scatter-add's order and applied as their mean."""
    B = ij.shape[1] // 2
    zero = xe.new_zeros(1)
    for k in range(ij.shape[0]):
        g = xe[ij[k]]
        dx = g[:B] - g[B:]
        dx = torch.where(dx == 0, 1e-9, dx)
        mag = torch.abs(dx)
        sgn = torch.where(dx >= 0, 1.0, -1.0).to(xe.dtype)
        delta = mu[k] * (mag - safe[k]) / 2.0
        r_x = torch.where(valid_r[k], delta * sgn, 0.0)
        vals = torch.cat([-r_x, r_x, zero])
        dsum = _row_sums(vals[table[k]])
        t = tgt[k]
        xe[t] = xe[t] + dsum / cnt[k]


def _rounds_nd(st, table, idx, mu, safe, valid_r, tgt, cnt):
    """The nD round body over a chunk, in place on ``st`` [2N + 1, D]
    (the last row a dummy target), as :func:`_rounds_1d` with the
    end-row updates of the JAX layout engine."""
    B = idx.shape[1] // 2
    D = st.shape[1]
    zero = st.new_zeros((1, D))
    for k in range(idx.shape[0]):
        c = st[idx[k]]
        deltas = c[:B] - c[B:]
        # summed in dimension order, as XLA:CPU reduces the minor axis
        # of [B, D]
        mag_sq = deltas[:, 0] * deltas[:, 0]
        for d in range(1, D):
            mag_sq = mag_sq + deltas[:, d] * deltas[:, d]
        zero_m = mag_sq == 0
        deltas[:, 0] = torch.where(zero_m, 1e-9, deltas[:, 0])
        mag_sq = torch.where(zero_m, 1e-18, mag_sq)
        # 1 / sqrt for the JAX rsqrt, as in the sweep engines
        inv = 1.0 / sqrt_rn(mag_sq)
        mag = mag_sq * inv
        delta = mu[k] * (mag - safe[k]) / 2.0
        r_scale = torch.where(valid_r[k], delta * inv, 0.0)
        upd = r_scale[:, None] * deltas
        vals = torch.cat([-upd, upd, zero])
        dsum = _row_sums(vals[table[k]])
        t = tgt[k]
        st[t] = st[t] + dsum / cnt[k]


def _chunks(cool_r: np.ndarray, B: int, start: int, stop: int):
    """[r0, r1) chunks of rounds covering [start, stop), each drawing at
    most ``_CHUNK_TERMS`` terms and split where the cooling flag
    changes."""
    per = max(1, _CHUNK_TERMS // (2 * B))
    r0 = start
    while r0 < stop:
        r1 = min(stop, r0 + per)
        flip = np.flatnonzero(cool_r[r0:r1] != cool_r[r0])
        if len(flip):
            r1 = r0 + int(flip[0])
        yield r0, r1
        r0 = r1


def build_1d_runner(
    pidx: PathIndex, params: PathSGDParams,
    segment_rounds: Optional[int] = None, *, device="cuda",
):
    """Construct the full-run function for the 1D engine.  Returns
    (run, make_x0, n_rounds): ``run(x, base_key[, start])`` executes the
    round loop on the device where ``x`` lies and returns the new
    positions; ``base_key`` is the u32 [2] key data
    (``ops.keys.key_data(seed)``); ``make_x0()`` builds a fresh
    initial-position tensor.  With ``segment_rounds`` set,
    ``run(x, key, start)`` executes rounds [start, start+segment_rounds)
    — rounds past the schedule are no-ops — enabling checkpoint/resume
    between segments."""
    dev = resolve_device(device)
    dtype = _NP[params.dtype]
    fdt = _TORCH[dtype]
    sample_dtype = np.float64 if params.pow_mode == "fpp" else dtype

    di = DeviceIndex.from_path_index(pidx, dtype, dev)
    zetas = zeta_table(
        params.space, params.space_max, params.space_quantization_step,
        params.theta,
    )
    B = effective_batch(params)
    round_eta, round_cooling, rpi, n_rounds = build_schedule(params, B)
    sample_pairs = _make_sampler(di, params, zetas, sample_dtype, B)
    etas_r = torch.from_numpy(round_eta.astype(dtype)).to(dev)
    N = di.num_nodes
    tables = {}

    def run(x, base_key, start=0):
        kb = np.asarray(base_key, np.uint32).tobytes()
        if kb not in tables:
            tables.clear()
            tables[kb] = _round_keys(base_key, np.arange(n_rounds), 0, dev)
        keys = tables[kb]
        stop = (n_rounds if segment_rounds is None
                else min(n_rounds, start + segment_rounds))
        xe = torch.cat([x.to(fdt), x.new_zeros(1, dtype=fdt)])
        rounds = _chunk_runner(_rounds_1d, xe, 2 * B)
        for r0, r1 in _chunks(round_cooling, B, int(start), stop):
            sa, sb, valid = sample_pairs(keys[r0:r1], bool(round_cooling[r0]),
                                         0, di.total_steps)
            term_dist = torch.abs(di.step_pos[sa] - di.step_pos[sb])
            valid_r = valid & (term_dist != 0)
            safe = torch.where(valid_r, term_dist, 1.0)
            mu = torch.clamp_max(etas_r[r0:r1, None] / safe, 1.0)
            i, j = di.step_node[sa], di.step_node[sb]
            ij = torch.cat([i, j], dim=1)
            table, tgt, cnt = _fold_tables(
                ij, torch.cat([valid_r, valid_r], dim=1), N)
            rounds(table, ij, mu, safe, valid_r, tgt, cnt.to(fdt))
        return xe[:N].clone()

    def make_x0(x0=None):
        return torch.from_numpy(np.asarray(
            x0 if x0 is not None else pidx.initial_positions(),
            dtype=dtype).copy()).to(dev)

    return run, make_x0, n_rounds


def path_linear_sgd_batched(
    graph: BidirectedGraph,
    params: PathSGDParams,
    pidx: Optional[PathIndex] = None,
    x0: Optional[np.ndarray] = None,
    *,
    device="cuda",
) -> Optional[np.ndarray]:
    """1D path SGD on ``device``; returns final positions x[idx] (host
    numpy f64) or None when no multi-step path exists."""
    pidx = pidx or PathIndex.from_graph(graph)
    if pidx.num_nodes == 0:
        return np.zeros(0)
    if not pidx.has_multi_step_path():
        return None
    run, make_x0, _n = build_1d_runner(pidx, params, device=device)
    x_final = run(make_x0(x0), key_data(params.seed))
    return x_final.cpu().numpy().astype(np.float64)


def path_sgd_sort_batched(graph: BidirectedGraph, params: PathSGDParams,
                          *, device="cuda"):
    """Handle ordering from the batched engine (stable sort by final
    position, src/sgd.rs:641-672 semantics)."""
    pidx = PathIndex.from_graph(graph)
    x = path_linear_sgd_batched(graph, params, pidx, device=device)
    if x is None or len(x) == 0:
        return []
    order = np.argsort(x, kind="stable")
    return (np.asarray(pidx.node_ids)[order] << 1).tolist()


def build_layout_runner(pidx: PathIndex, params: LayoutSGDParams, *,
                        device="cuda"):
    """The nD engine's round loop (the body of the JAX
    ``path_linear_sgd_layout_batched``): returns (run, n_rounds);
    ``run(state, base_key)`` takes the [2N, D] node-end state (row
    ``2n + e``) on the device and returns the new one."""
    dev = resolve_device(device)
    dtype = _NP[params.dtype]
    fdt = _TORCH[dtype]
    sample_dtype = np.float64 if params.pow_mode == "fpp" else dtype

    di = DeviceIndex.from_path_index(pidx, dtype, dev)
    zetas = zeta_table(
        params.space, params.space_max, params.space_quantization_step,
        params.theta,
    )
    B = effective_batch(params)
    round_eta, round_cooling, rpi, n_rounds = build_schedule(params, B)
    sample_pairs = _make_sampler(di, params, zetas, sample_dtype, B)
    etas_r = torch.from_numpy(round_eta.astype(dtype)).to(dev)
    n_rows = 2 * di.num_nodes

    def run(state, base_key):
        keys = _round_keys(base_key, np.arange(n_rounds), 2, dev)
        D = state.shape[1]
        st = torch.cat([state.to(fdt), state.new_zeros((1, D), dtype=fdt)])
        rounds = _chunk_runner(_rounds_nd, st, 2 * B)
        for r0, r1 in _chunks(round_cooling, B, 0, n_rounds):
            kc = keys[r0:r1]
            sa, sb, valid = sample_pairs(kc, bool(round_cooling[r0]), 0,
                                         di.total_steps)
            i, j = di.step_node[sa], di.step_node[sb]
            # random end choice per term (rs:1060-1077)
            other_a = jrandom.bernoulli(kc[:, 5], 0.5, (B,))
            other_b = jrandom.bernoulli(kc[:, 6], 0.5, (B,))
            pos_a = torch.where(other_a, di.step_pos[sa] + di.node_len[i],
                                di.step_pos[sa])
            pos_b = torch.where(other_b, di.step_pos[sb] + di.node_len[j],
                                di.step_pos[sb])
            end_a = torch.where(other_a, 1 - di.step_rev[sa], di.step_rev[sa])
            end_b = torch.where(other_b, 1 - di.step_rev[sb], di.step_rev[sb])
            term_dist = torch.abs(pos_a - pos_b)
            valid_r = valid & (term_dist != 0)
            safe = torch.where(valid_r, term_dist, 1.0)
            mu = torch.clamp_max(etas_r[r0:r1, None] / safe, 1.0)
            idx = torch.cat([i * 2 + end_a, j * 2 + end_b], dim=1)
            table, tgt, cnt = _fold_tables(
                idx, torch.cat([valid_r, valid_r], dim=1), n_rows)
            rounds(table, idx, mu, safe, valid_r, tgt,
                   cnt.to(fdt)[..., None])
        return st[:n_rows].clone()

    return run, n_rounds


def path_linear_sgd_layout_batched(
    graph: BidirectedGraph,
    params: LayoutSGDParams,
    pidx: Optional[PathIndex] = None,
    init_coords: Optional[np.ndarray] = None,
    *,
    device="cuda",
) -> Layout:
    """nD layout SGD on ``device``: state [2N, D], two ends per node
    (src/sgd.rs:773-1188 semantics, batched)."""
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
    run, _n = build_layout_runner(pidx, params, device=device)
    dev = resolve_device(device)
    state = torch.from_numpy(np.asarray(
        init_coords, dtype=_NP[params.dtype]).copy()).to(dev)
    final = run(state, key_data(params.seed))
    return Layout.from_state(final.cpu().numpy().astype(np.float64))
