"""The least time the card could take for the sweep kernels of one job:
the yardstick of the ``sweep_roofline_pct.*`` metrics.

A frozen copy of ``chip_smoke.py::bound_ms`` and of the operation and
byte counts it is fed with (``chip_smoke.py:295-395``: ``n_words``,
``match_ops``, ``ops_1d``, ``ops_nd``; ``:622-659``: ``ops_sampler``; the
words per step of each kernel from ``chip_smoke.py:455``, ``:497``,
``:745`` and ``gfasort_tpu_torch/bench_util.py:1016-1039``), with the
published H100 SXM peaks of ``gfasort_tpu_torch/bench_util.py:55-69``.
The counts follow from the job's input (S, N, the paths) and the sweep
plan that the reference (:mod:`gfabench.reference`) works out from it,
never from the program's plan at run time.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["HBM_BYTES_S", "F32_OPS_S", "F64_OPS_S", "MAX_SM_CLOCK_MHZ",
           "bound_ms", "n_words", "match_ops", "ops_1d", "ops_nd",
           "ops_sampler", "GraphShape", "sort_step_bound_ms",
           "layout_step_bound_ms"]

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates, at
# the 700 W power limit): HBM bytes/s, f32 and f64 operations/s outside
# the tensor cores; the per-clock int32 and conversion rates of the 132
# SMs (CUDA C++ Programming Guide, compute capability 9.0) at the
# published maximum SM clock.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
F64_OPS_S = 34e12
H100_SMS = 132
MAX_SM_CLOCK_MHZ = 1980.0
INT32_OPS_PER_CLOCK = H100_SMS * 64
CVT_OPS_PER_CLOCK = H100_SMS * 16


def bound_ms(S: int, words_in, words_out, f32=0, int32=0, cvt=0, f64=0,
             clock_mhz: float = MAX_SM_CLOCK_MHZ) -> float:
    """The largest of five times: the bytes (each input word read once,
    each output word written once; a word is 4 bytes) over the HBM rate,
    the f32 and f64 operations over their peaks, the int32 operations
    and the conversions, transcendentals and popcounts over their rates
    at ``clock_mhz``.  ``f32``, ``int32``, ``cvt`` and ``f64`` count per
    step.  Milliseconds."""
    hz = clock_mhz * 1e6
    return 1e3 * max(4.0 * S * (words_in + words_out) / HBM_BYTES_S,
                     float(S) * f32 / F32_OPS_S,
                     float(S) * f64 / F64_OPS_S,
                     float(S) * int32 / (INT32_OPS_PER_CLOCK * hz),
                     float(S) * cvt / (CVT_OPS_PER_CLOCK * hz))


def n_words(P: int) -> int:
    return 1 if P == 1 else -(-P // 4)


def match_ops(P: int) -> tuple:
    """(int32, cvt) of one pair's weight: per 4-byte word of choices the
    XOR with the broadcast byte, the carry-free zero-byte test, the same
    for the partner's word, the guard's AND, the shift and the OR (11),
    then a popcount and its conversion (cvt 2); P = 1: two compares and
    the guarded OR (3).  Both plus the partner's index and guard (3)."""
    if P == 1:
        return 3 + 3, 0
    return 11 * n_words(P) + 3, 2


def ops_1d(P: int, n_buckets: int) -> tuple:
    """(f32, int32, cvt) per step of the 1D pair update, per bucket: the
    pair once (f32 8; the weight's match; the divide's reciprocal), then
    at each end dsum += and csum += (f32 4)."""
    m_int, m_cvt = match_ops(P)
    return n_buckets * 12, n_buckets * m_int, n_buckets * (m_cvt + 1)


def ops_nd(D: int, P: int, n_buckets: int) -> tuple:
    """(f32, int32, cvt) per step of the nD pair update, per bucket: the
    pair once (f32 4D + 11; the match; two reciprocals and a square root,
    cvt 3), then at each end acc += (D) and wacc += (f32 2D + 2)."""
    m_int, m_cvt = match_ops(P)
    return n_buckets * (6 * D + 13), n_buckets * m_int, n_buckets * (m_cvt + 3)


def ops_sampler(P: int, K: int, coin: bool, frac: float) -> tuple:
    """(f32, int32, cvt) per step of the hash-route sampler at f32, d =
    ceil(log2(K + 1)) compares per search of the K offsets: per proposal
    int32 the hash (31), coins and flags (9), draws (3), snap (5 + d),
    activity (4, and 2 where frac < 1) and packing (4; P = 1: 1), f32 19,
    cvt 8; per step int32 the two chains' searches (2d), avail (2), the
    clamps (4), the flags (4), the end coin (2); cvt 4."""
    d = max(1, K.bit_length())
    per_p = 31 + 9 + 3 + 5 + d + 4 + (2 if frac < 1.0 else 0) + (
        1 if P == 1 else 4)
    int32 = P * per_p + 2 * d + 10 + (2 if coin else 0)
    return 19 * P, int32, 8 * P + 4


@dataclass(frozen=True)
class GraphShape:
    """What a sweep plan reads of a graph's path index: a stand-in for
    ``reference.index.PathIndex`` built from a GFA's summary."""

    total_steps: int
    num_nodes: int
    max_path_step_count: int
    sum_path_step_count: int
    max_path_length: int

    @classmethod
    def of(cls, summary) -> "GraphShape":
        """From a :class:`gfabench.gfa_check.GfaSummary` whose every node
        has an S line (as every generated graph has)."""
        steps = list(summary.path_steps.values())
        return cls(total_steps=sum(steps), num_nodes=summary.nodes,
                   max_path_step_count=max(steps),
                   sum_path_step_count=sum(steps),
                   max_path_length=max(summary.path_bp.values()))


def _sort_plan(shape: GraphShape, iter_max: int):
    from dataclasses import replace

    from .reference.ops.sweep_plan import make_sweep_plan
    from .reference.params import PathSGDParams

    params = replace(PathSGDParams(), iter_max=iter_max,
                     min_term_updates=shape.sum_path_step_count,
                     eta_max=float(shape.max_path_step_count ** 2),
                     space=shape.max_path_length)
    return make_sweep_plan(shape, params)


def _layout_plan(shape: GraphShape, dims: int, iter_max: int):
    from dataclasses import replace

    from .reference.ops.sweep_plan import make_layout_plan
    from .reference.params import LayoutSGDParams

    params = replace(LayoutSGDParams(), dimensions=dims, iter_max=iter_max,
                     min_term_updates=10 * shape.sum_path_step_count,
                     eta_max=float(shape.max_path_step_count ** 2),
                     space=shape.max_path_step_count)
    return make_layout_plan(shape, params)


def sort_step_bound_ms(shape: GraphShape, iter_max: int,
                       clock_mhz: float = MAX_SM_CLOCK_MHZ) -> float:
    """The bound of one ``Y`` step's sweep kernels, summed over its
    executed sweeps: per sweep the sampler (rank and cnt in, the words
    out), the bucket pass over the phase's buckets with k <= KMAX (xs,
    pos and the words in; dsum and csum out) and the roll pass with the
    combine (xs, pos, dsum, csum and the words in; xs out)."""
    plan = _sort_plan(shape, iter_max)
    S, P, nw = shape.total_steps, plan.proposals, n_words(plan.proposals)
    total = 0.0
    for e in range(plan.n_exec):
        ph = plan.phases[e % len(plan.phases)]
        kb, rb = len(ph.kernel_buckets), len(ph.roll_buckets)
        total += bound_ms(S, 2, nw, *ops_sampler(P, len(ph.offs), False,
                                                 plan.active_frac),
                          clock_mhz=clock_mhz)
        if kb:
            total += bound_ms(S, 2 + nw, 2, *ops_1d(P, kb),
                              clock_mhz=clock_mhz)
        f32, i32, cvt = ops_1d(P, rb)
        total += bound_ms(S, 2 + 2 * bool(kb) + nw, 1, f32 + 3, i32,
                          cvt + 1, clock_mhz=clock_mhz)
    return total


def layout_step_bound_ms(shape: GraphShape, dims: int, iter_max: int,
                         clock_mhz: float = MAX_SM_CLOCK_MHZ) -> float:
    """The bound of one ``L`` step's sweep kernels, summed over its
    executed sweeps: per sweep the sampler with its end coin, the nD
    bucket pass (my_pos, the words and my_c in; acc and wacc out) and the
    nD roll pass with the per-end combine (my_pos, my_c, the coin's byte,
    cs, acc, wacc and the words in; cs out)."""
    plan = _layout_plan(shape, dims, iter_max)
    S, P, nw, D = shape.total_steps, plan.proposals, n_words(
        plan.proposals), dims
    total = 0.0
    for e in range(plan.n_exec):
        ph = plan.phases[e % len(plan.phases)]
        kb, rb = len(ph.kernel_buckets), len(ph.roll_buckets)
        total += bound_ms(S, 2, nw + 0.25,
                          *ops_sampler(P, len(ph.offs), True,
                                       plan.active_frac),
                          clock_mhz=clock_mhz)
        if kb:
            total += bound_ms(S, 1 + nw + D, D + 1, *ops_nd(D, P, kb),
                              clock_mhz=clock_mhz)
        f32, i32, cvt = ops_nd(D, P, rb)
        total += bound_ms(S, 1 + D + 2 * D + (D + 1) * bool(kb) + 0.25 + nw,
                          2 * D, f32 + 4 * D + 1, i32, cvt + D,
                          clock_mhz=clock_mhz)
    return total
