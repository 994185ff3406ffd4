"""Sequential oracle: bit-exact replica of the reference SGD semantics.

This engine replays the reference's single-worker update stream
(gfasort ``src/sgd.rs:237-614`` for 1D, ``:773-1188`` for nD) —
identical RNG draws (Xoshiro256Plus seeded ``seed + tid``), identical
Zipf sampling through ``fast_precise_pow``, identical f64 update
arithmetic — under the deterministic iteration contract: exactly
``min_term_updates`` *successful* updates per iteration, using
``etas[k]`` and cooling for iteration ``k``.

The reference's own iteration boundaries are timing-dependent (a checker
thread polls a racy counter every 1 ms and workers overshoot,
``src/sgd.rs:366-408``; SURVEY.md §8.1), so "exact" here means: the
deterministic schedule the reference *specifies*, with the reference's
per-update semantics reproduced bit-for-bit.  This is the parity oracle
the TPU engine is validated against, and the same contract the C++
native engine implements.

Python implementation — slow but dependency-free; the C++ twin in
:mod:`gfasort_tpu_torch.native` is used for big runs and cross-checked
against this one in tests.
"""

from __future__ import annotations

import math
import struct
from typing import Optional

import numpy as np

from ..graph import BidirectedGraph
from ..index import PathIndex
from ..io.layout_tsv import Layout
from ..params import LayoutSGDParams, PathSGDParams
from ..trace import spanned
from .rng import UniformInt, Xoshiro256Plus
from .schedule import eta_schedule
from .fastpow import zeta_table

__all__ = [
    "path_linear_sgd_exact",
    "path_sgd_sort_exact",
    "path_linear_sgd_layout_exact",
    "calculate_layout_stress",
    "calculate_layout_stress_pidx",
]

_pack = struct.Struct("<d").pack
_unpack_q = struct.Struct("<Q").unpack
_pack_q = struct.Struct("<Q").pack
_unpack_d = struct.Struct("<d").unpack


def _fpp(a: float, b: float) -> float:
    """Scalar fast_precise_pow (src/sgd.rs:155-182), struct-based bit
    manipulation (fast in pure Python)."""
    e = int(b)
    (bits,) = _unpack_q(_pack(a))
    high = (bits >> 32) & 0xFFFFFFFF
    if high >= 0x80000000:
        high -= 1 << 32  # as i32
    new_high = int((b - e) * (high - 1072632447) + 1072632447.0)
    new_high &= 0xFFFFFFFF
    if new_high >= 0x80000000:
        new_high_i = new_high - (1 << 32)
    else:
        new_high_i = new_high
    # (new_high as u64) << 32 with sign extension
    frac_bits = (new_high_i & 0xFFFFFFFFFFFFFFFF) << 32 & 0xFFFFFFFFFFFFFFFF
    (frac,) = _unpack_d(_pack_q(frac_bits))
    r = 1.0
    base = a
    exp = e
    while exp != 0:
        if exp & 1:
            r *= base
        base *= base
        exp >>= 1
    return r * frac


def _zipf_sample(
    rng: Xoshiro256Plus,
    jump_space: int,
    theta: float,
    zeta: float,
    zeta2theta: float,
) -> int:
    """DirtyZipfian O(1) inverse-CDF sample over [1, jump_space]
    (src/sgd.rs:110-151)."""
    n = jump_space  # max - min + 1 with min=1
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - _fpp(2.0 / n, 1.0 - theta)) / (1.0 - zeta2theta / zeta)
    u = rng.random_f64()
    uz = u * zeta
    if uz < 1.0:
        return 1
    if uz < 1.0 + _fpp(0.5, theta):
        return 2
    result = 1.0 + n * _fpp(eta * u - eta + 1.0, alpha)
    # Rust `as u64` saturating cast
    if result < 0.0 or math.isnan(result):
        r = 0
    elif result >= 2**64:
        r = 2**64 - 1
    else:
        r = int(result)
    return min(r, jump_space)


def _space_idx(jump_space: int, space_max: int, quant: int, table_len: int) -> int:
    if jump_space > space_max:
        idx = space_max + (jump_space - space_max) // quant + 1
    else:
        idx = jump_space
    return min(idx, table_len - 1)


def _sample_rank_b(
    rng, flip_dist, cooling, cur_theta, rank_a, count_p, space,
    space_max, quant, zetas,
) -> int:
    """Second-step sampling shared by 1D and nD (src/sgd.rs:456-495)."""
    rank_b = rank_a
    if cooling or flip_dist.sample(rng) == 1:
        if rank_a > 0 and (flip_dist.sample(rng) == 1 or rank_a == count_p - 1):
            jump_space = min(space, rank_a)
            si = _space_idx(jump_space, space_max, quant, len(zetas))
            z2t = 1.0 + _fpp(0.5, cur_theta)
            z = _zipf_sample(rng, jump_space, cur_theta, zetas[si], z2t)
            rank_b = rank_a - min(z, rank_a)  # saturating_sub
        elif rank_a < count_p - 1:
            jump_space = min(space, count_p - rank_a - 1)
            si = _space_idx(jump_space, space_max, quant, len(zetas))
            z2t = 1.0 + _fpp(0.5, cur_theta)
            z = _zipf_sample(rng, jump_space, cur_theta, zetas[si], z2t)
            rank_b = min(rank_a + z, count_p - 1)
    else:
        rank_b = UniformInt(0, count_p).sample(rng)
    return rank_b


def path_linear_sgd_exact(
    graph: BidirectedGraph,
    params: PathSGDParams,
    pidx: Optional[PathIndex] = None,
    nthreads: int = 1,
) -> Optional[np.ndarray]:
    """1D path-SGD positions (src/sgd.rs:237-614), sequential oracle.
    Returns x[idx] over the SGD node indexing, or None when no path has
    more than one step (the reference returns an empty map).

    ``nthreads > 1`` emulates the reference's ``-t N`` mode with N
    per-worker RNG streams seeded ``seed + tid`` (rs:429-432) applied
    in a DETERMINISTIC round-robin interleaving (one sample attempt per
    worker per turn, shared positions and update counter).  The real
    reference interleaving is timing-dependent (SURVEY §8.1), so this
    is a canonical representative of its schedule family, not a
    bit-parity target; ``nthreads=1`` is the bit-parity contract."""
    pidx = pidx or PathIndex.from_graph(graph)
    if pidx.num_nodes == 0:
        return np.zeros(0)
    if not pidx.has_multi_step_path():
        return None

    x = pidx.initial_positions().tolist()
    etas = eta_schedule(
        1.0 / params.eta_max, 1.0, params.iter_max,
        params.iter_with_max_learning_rate, params.eps,
    )
    zetas = zeta_table(
        params.space, params.space_max, params.space_quantization_step,
        params.theta,
    ).tolist()
    fci = params.first_cooling_iteration

    step_path = pidx.step_path.tolist()
    step_rank = pidx.step_rank.tolist()
    step_pos = pidx.step_pos.tolist()
    step_node = pidx.step_node_idx.tolist()
    path_first = pidx.path_first.tolist()
    path_count = pidx.path_count.tolist()

    # per-worker streams seeded seed + tid (rs:431); tid 0 alone is the
    # bit-parity stream
    rngs = [Xoshiro256Plus(params.seed + t) for t in range(max(nthreads, 1))]
    step_dist = UniformInt(0, pidx.total_steps)
    flip_dist = UniformInt(0, 2)
    space = params.space
    space_max = params.space_max
    quant = params.space_quantization_step
    turn = 0

    for k in range(params.iter_max + 1):
        eta = float(etas[k])
        cooling = k > fci
        cur_theta = 0.001 if cooling else params.theta
        done = 0
        while done < params.min_term_updates:
            rng = rngs[turn]
            turn = (turn + 1) % len(rngs)
            step_idx = step_dist.sample(rng)
            p = step_path[step_idx]
            count_p = path_count[p]
            if count_p == 1:
                continue
            rank_a = step_rank[step_idx]
            rank_b = _sample_rank_b(
                rng, flip_dist, cooling, cur_theta, rank_a, count_p,
                space, space_max, quant, zetas,
            )
            if rank_a == rank_b:
                continue
            sa = path_first[p] + rank_a
            sb = path_first[p] + rank_b
            pos_a = float(step_pos[sa])
            pos_b = float(step_pos[sb])
            term_dist = abs(pos_a - pos_b)
            if term_dist == 0.0:
                continue
            mu = eta * (1.0 / term_dist)
            if mu > 1.0:
                mu = 1.0
            i = step_node[sa]
            j = step_node[sb]
            if i < 0 or j < 0:
                # node missing from the SGD index (stale node_order on
                # gapped-id inputs): the reference warns and skips
                # (src/sgd.rs:525-538)
                continue
            dx = x[i] - x[j]
            if dx == 0.0:
                dx = 1e-9
            mag = abs(dx)
            delta = mu * (mag - term_dist) / 2.0
            r_x = (delta / mag) * dx
            x[i] = x[i] - r_x
            x[j] = x[j] + r_x
            done += 1

    return np.asarray(x, dtype=np.float64)


def path_sgd_sort_exact(graph: BidirectedGraph, params: PathSGDParams,
                        nthreads: int = 1):
    """Sorted handle ordering from 1D SGD (src/sgd.rs:641-672): stable
    sort of node indices by final position, mapped back through the
    same node-order indexing used for seeding."""
    from .. import handle as H

    pidx = PathIndex.from_graph(graph)
    x = path_linear_sgd_exact(graph, params, pidx, nthreads=nthreads)
    if x is None or len(x) == 0:
        # reference returns empty positions map -> empty ordering
        return []
    order = np.argsort(x, kind="stable")
    return [H.forward(int(pidx.node_ids[idx])) for idx in order]


@spanned("layout.init")
def layout_initial_coords(pidx: PathIndex, dims: int, seed: int) -> np.ndarray:
    """Initial nD layout state, shape [2N, D] (src/sgd.rs:828-854):
    dim 0 = cumulative bp offset for the + end (row 2i) and + node_len
    for the - end (row 2i+1); dims 1.. = N(0,1)·sqrt(2·num_nodes) drawn
    sequentially from a seed-seeded stream.

    The reference draws its noise via rand_distr's ziggurat; we use
    Box–Muller on the same Xoshiro stream — layout parity is
    stress-tolerance-based, not bit-based (BASELINE.md metric 3), and
    nothing downstream shares this stream.
    """
    n = pidx.num_nodes
    init_rng = Xoshiro256Plus(seed)
    sqrt_n = math.sqrt(n * 2.0)
    spare: list = [None]

    def gauss():
        if spare[0] is not None:
            v = spare[0]
            spare[0] = None
            return v
        while True:
            u1 = init_rng.random_f64()
            if u1 > 0.0:
                break
        u2 = init_rng.random_f64()
        r = math.sqrt(-2.0 * math.log(u1))
        spare[0] = r * math.sin(2.0 * math.pi * u2)
        return r * math.cos(2.0 * math.pi * u2)

    coords = np.zeros((2 * n, dims), dtype=np.float64)
    length = 0
    node_len = pidx.node_len.tolist()
    for idx in range(n):
        coords[idx * 2, 0] = float(length)
        for d in range(1, dims):
            coords[idx * 2, d] = gauss() * sqrt_n
        coords[idx * 2 + 1, 0] = float(length + node_len[idx])
        for d in range(1, dims):
            coords[idx * 2 + 1, d] = gauss() * sqrt_n
        length += node_len[idx]
    return coords


def path_linear_sgd_layout_exact(
    graph: BidirectedGraph,
    params: LayoutSGDParams,
    pidx: Optional[PathIndex] = None,
    init_coords: Optional[np.ndarray] = None,
) -> Layout:
    """nD layout SGD (src/sgd.rs:773-1188), sequential oracle."""
    pidx = pidx or PathIndex.from_graph(graph)
    n = pidx.num_nodes
    dims = params.dimensions
    if n == 0:
        return Layout(dims, 0)
    if not pidx.has_multi_step_path():
        return Layout(dims, n)

    if init_coords is None:
        init_coords = layout_initial_coords(pidx, dims, params.seed)
    # coords[d][entry] layout for the inner loop
    coords = [init_coords[:, d].tolist() for d in range(dims)]
    node_len = pidx.node_len.tolist()

    etas = eta_schedule(
        1.0 / params.eta_max, 1.0, params.iter_max,
        params.iter_with_max_learning_rate, params.eps,
    )
    zetas = zeta_table(
        params.space, params.space_max, params.space_quantization_step,
        params.theta,
    ).tolist()
    fci = params.first_cooling_iteration

    step_path = pidx.step_path.tolist()
    step_rank = pidx.step_rank.tolist()
    step_pos = pidx.step_pos.tolist()
    step_node = pidx.step_node_idx.tolist()
    step_handle = pidx.step_handle.tolist()
    path_first = pidx.path_first.tolist()
    path_count = pidx.path_count.tolist()

    rng = Xoshiro256Plus(params.seed)
    step_dist = UniformInt(0, pidx.total_steps)
    flip_dist = UniformInt(0, 2)
    space = params.space
    space_max = params.space_max
    quant = params.space_quantization_step

    for k in range(params.iter_max + 1):
        eta = float(etas[k])
        cooling = k > fci
        cur_theta = 0.001 if cooling else params.theta
        done = 0
        while done < params.min_term_updates:
            step_idx = step_dist.sample(rng)
            p = step_path[step_idx]
            count_p = path_count[p]
            if count_p == 1:
                continue
            rank_a = step_rank[step_idx]
            rank_b = _sample_rank_b(
                rng, flip_dist, cooling, cur_theta, rank_a, count_p,
                space, space_max, quant, zetas,
            )
            if rank_a == rank_b:
                continue
            sa = path_first[p] + rank_a
            sb = path_first[p] + rank_b
            pos_a = float(step_pos[sa])
            pos_b = float(step_pos[sb])
            i = step_node[sa]
            j = step_node[sb]

            # random end choice per term (rs:1060-1077).  The reference
            # draws BOTH end coins before the handle-lookup skip
            # (rs:1089-1096) and uses length 0 for a node missing from
            # the graph (rs:1051-1058 unwrap_or(0)); keep that exact
            # stream order so a gapped-id input cannot desync the RNG.
            hi = step_handle[sa]
            hj = step_handle[sb]
            i_rev = hi & 1
            j_rev = hj & 1
            use_other_a = flip_dist.sample(rng) == 1
            if use_other_a:
                pos_a += float(node_len[i]) if i >= 0 else 0.0
                end_a = 0 if i_rev else 1  # !is_rev
            else:
                end_a = 1 if i_rev else 0  # is_rev
            use_other_b = flip_dist.sample(rng) == 1
            if use_other_b:
                pos_b += float(node_len[j]) if j >= 0 else 0.0
                end_b = 0 if j_rev else 1
            else:
                end_b = 1 if j_rev else 0

            term_dist = abs(pos_a - pos_b)
            if term_dist == 0.0:
                continue
            mu = eta * (1.0 / term_dist)
            if mu > 1.0:
                mu = 1.0
            if i < 0 or j < 0:
                continue

            idx_i = i * 2 + end_a
            idx_j = j * 2 + end_b
            mag_sq = 0.0
            deltas = [0.0] * dims
            for d in range(dims):
                dd = coords[d][idx_i] - coords[d][idx_j]
                deltas[d] = dd
                mag_sq += dd * dd
            if mag_sq == 0.0:
                deltas[0] = 1e-9
                mag_sq = 1e-18
            mag = math.sqrt(mag_sq)
            delta = mu * (mag - term_dist) / 2.0
            r = delta / mag
            for d in range(dims):
                r_d = r * deltas[d]
                coords[d][idx_i] -= r_d
                coords[d][idx_j] += r_d
            done += 1

    return Layout.from_vectors([np.asarray(c) for c in coords])


def calculate_layout_stress(
    graph: BidirectedGraph, layout: Layout, sample_count: int
) -> float:
    """Sampled normalized stress (src/sgd.rs:1196-1283): random step
    pairs within paths, fixed seed 12345, + ends only."""
    return calculate_layout_stress_pidx(
        PathIndex.from_graph(graph), layout, sample_count
    )


@spanned("layout.stress")
def calculate_layout_stress_pidx(
    pidx: PathIndex, layout: Layout, sample_count: int
) -> float:
    """Stress from a prebuilt PathIndex (the ``L`` step's own, or a
    synthetic bench's).  The step columns are read per sample, in place:
    the work scales with ``sample_count``, not with the step count."""
    if pidx.total_steps < 2:
        return 0.0
    rng = Xoshiro256Plus(12345)
    step_dist = UniformInt(0, pidx.total_steps)

    step_path, step_rank = pidx.step_path, pidx.step_rank
    step_pos, step_node = pidx.step_pos, pidx.step_node_idx
    path_first = pidx.path_first.tolist()
    path_count = pidx.path_count.tolist()

    stress_sum = 0.0
    count = 0
    for _ in range(sample_count):
        sa0 = step_dist.sample(rng)
        p = int(step_path[sa0])
        count_p = path_count[p]
        if count_p < 2:
            continue
        rank_a = int(step_rank[sa0])
        rank_b = UniformInt(0, count_p).sample(rng)
        if rank_a == rank_b:
            continue
        sa = path_first[p] + rank_a
        sb = path_first[p] + rank_b
        path_dist = abs(float(step_pos[sa]) - float(step_pos[sb]))
        if path_dist == 0.0:
            continue
        d = layout.distance(int(step_node[sa]), 0, int(step_node[sb]), 0)
        err = d - path_dist
        stress_sum += (err * err) / (path_dist * path_dist)
        count += 1
    return math.sqrt(stress_sum / count) if count else 0.0
