"""Roll passes and combine: the pair updates of the offsets the bucket
kernels do not serve, and the sweep's final combine, in one pass.

Counterparts of the roll passes and the combine of
``gfasort_tpu/ops/sweep.py`` (1D, ``:328-380``) and
``gfasort_tpu/ops/sweep_nd.py`` (nD, ``:105-185``), which XLA fuses.  On
a CUDA tensor :func:`roll_apply` and :func:`roll_apply_nd` launch the
hand-written Hopper kernel ``csrc/roll_apply.cu`` (float32, or float64
on the f64 route); on a CPU tensor they run :func:`roll_apply_ref` and
:func:`roll_apply_nd_ref`, the plain PyTorch versions (one
``torch.roll`` pass per bucket and side, then the combine).  A CUDA
tensor never reaches a plain version, and a failed launch raises.

Semantics (as in the JAX package): step t's partner for the bucket
(k, ki) is read at (t + k) mod S and (t - k) mod S; the wrap-around of
the roll is guarded on the partner's choice only (a step's own choice is
in-path by the sampler's construction).  The choices come as the
bucket kernels take them: the raw choice array for one proposal, else
the packed 8-bit fields (``sweep_common.pack_words``).
"""

from __future__ import annotations

import torch

from .sweep_dense import MAX_BUCKETS, MAX_DIMS, _fields, _n_words, sqrt_rn

__all__ = ["roll_apply", "roll_apply_nd", "roll_apply_nd_ref",
           "roll_apply_ref"]


def _roll_half(xs, pos, eta_t, shift: int, pairs, iota):
    """Contribution received at each step from the pair (t, t - shift)
    for an offset above KMAX.  ``pairs``: per proposal, (my mask, the
    rolled partner mask); the wrap-around of the roll is guarded on the
    partner mask only — my own choice is in-path by construction."""
    S = xs.shape[0]
    xs_o = torch.roll(xs, shift)
    guard = iota < S + shift if shift < 0 else iota >= shift
    w = None
    for w_mine, w_theirs in pairs:
        wb = (w_mine | (w_theirs & guard)).to(xs.dtype)
        w = wb if w is None else w + wb
    d = torch.abs(pos - torch.roll(pos, shift))
    valid = d != 0
    w = torch.where(valid, w, 0.0)
    safe = torch.where(valid, d, 1.0)
    mu = torch.clamp_max(eta_t / safe, 1.0)
    dx = xs - xs_o
    dx = torch.where(dx == 0, 1e-9, dx)
    mag = torch.abs(dx)
    half_sgn = torch.where(dx >= 0, 0.5, -0.5).to(xs.dtype)
    r_x = mu * (mag - safe) * half_sgn
    return -w * r_x, w


def _roll_half_nd(my_pos, my_c, eta_t, shift: int, pairs, iota):
    """(acc [D, S], w [S]) received at each step from the pair
    (t, t - shift) for an offset above KMAX; the nD twin of
    :func:`_roll_half` (the wrap-around of the roll is guarded on the
    partner mask only)."""
    S = my_pos.shape[0]
    pos_o = torch.roll(my_pos, shift)
    c_o = torch.roll(my_c, shift, dims=1)
    guard = iota < S + shift if shift < 0 else iota >= shift
    w = None
    for w_mine, w_theirs in pairs:
        wb = (w_mine | (w_theirs & guard)).to(my_pos.dtype)
        w = wb if w is None else w + wb
    d = torch.abs(my_pos - pos_o)
    valid = d != 0
    w = torch.where(valid, w, 0.0)
    safe = torch.where(valid, d, 1.0)
    mu = torch.clamp_max(eta_t / safe, 1.0)
    deltas = my_c - c_o
    mag_sq = deltas[0] * deltas[0]
    for dim in range(1, my_c.shape[0]):
        mag_sq = mag_sq + deltas[dim] * deltas[dim]
    zero = mag_sq == 0
    deltas[0] = torch.where(zero, 1e-9, deltas[0])
    mag_sq = torch.where(zero, 1e-18, mag_sq)
    # 1 / sqrt for the JAX rsqrt, as in ops/sweep_dense.dense_apply_nd_ref
    inv = 1.0 / sqrt_rn(mag_sq)
    mag = mag_sq * inv
    r = torch.clamp_max(mu * (mag - safe) * 0.5 * inv, 1e30)
    return -(w * r) * deltas, w


def _roll_sums(half, a, b, sidxs, eta: float, buckets, acc, w_acc):
    """``acc``/``w_acc`` plus both sides of every roll bucket, in bucket
    order (``acc + d1 + d2``), as the engines sum them; ``half`` is
    :func:`_roll_half` (a, b = xs, pos) or :func:`_roll_half_nd`
    (my_pos, my_c)."""
    iota = torch.arange(a.shape[0], device=a.device)
    eta_t = torch.full((), eta, dtype=a.dtype, device=a.device)
    for k, ki in buckets:
        # partner ahead (t+k): I chose +k, or they chose -k
        d1, w1 = half(a, b, eta_t, -k, [
            (s == ki, torch.roll(s, -k) == ~ki) for s in sidxs], iota)
        # partner behind (t-k): I chose -k, or they chose +k
        d2, w2 = half(a, b, eta_t, +k, [
            (s == ~ki, torch.roll(s, k) == ki) for s in sidxs], iota)
        acc = acc + d1 + d2
        w_acc = w_acc + w1 + w2
    return acc, w_acc


def roll_apply_ref(xs, pos, words, eta: float, buckets, proposals: int,
                   dsum=None, csum=None):
    """Plain PyTorch roll passes and combine (the spec of the 1D kernel):
    ``xs + (dsum + roll updates) / max(csum + roll weights, 1)``; ``dsum``
    and ``csum`` default to zeros (a phase with no kernel bucket)."""
    words = list(words) if isinstance(words, (list, tuple)) else [words]
    dsum = torch.zeros_like(xs) if dsum is None else dsum
    csum = torch.zeros_like(xs) if csum is None else csum
    dsum, csum = _roll_sums(_roll_half, xs, pos, _fields(words, proposals),
                            eta, buckets, dsum, csum)
    return xs + dsum / torch.clamp_min(csum, 1.0)


def roll_apply_nd_ref(my_pos, my_c, lane0, cs, words, eta: float, buckets,
                      proposals: int, acc=None, wacc=None):
    """Plain PyTorch nD roll passes and per-end combine (the spec of the
    nD kernel): ``upd = (acc + roll updates) / max(wacc + roll weights,
    1)``; the chosen end's rows (``lane0``: end 0) of ``cs [2D, S]`` take
    ``upd``, the other end's ``+ 0``.  Returns the new cs."""
    words = list(words) if isinstance(words, (list, tuple)) else [words]
    D = my_c.shape[0]
    acc = torch.zeros_like(my_c) if acc is None else acc
    wacc = torch.zeros_like(my_pos) if wacc is None else wacc
    acc, wacc = _roll_sums(_roll_half_nd, my_pos, my_c,
                           _fields(words, proposals), eta, buckets, acc, wacc)
    # the chosen end is fixed for the whole sweep: its rows take the
    # mean update, the other end's rows are unchanged
    upd = acc / torch.clamp_min(wacc, 1.0)
    return torch.cat([cs[:D] + torch.where(lane0, upd, 0.0),
                      cs[D:] + torch.where(lane0, 0.0, upd)])


def _check(ref, words, buckets, proposals, sums):
    S = ref.shape[0]
    if S >= 1 << 31:
        raise ValueError(f"{S} steps exceed the kernel's int32 indexing")
    if proposals < 1 or proposals > 16:
        raise ValueError("proposals must be in [1, 16]")
    if len(words) != _n_words(proposals):
        raise ValueError(f"{proposals} proposals need {_n_words(proposals)} "
                         f"choice words, got {len(words)}")
    if len(buckets) > MAX_BUCKETS:
        raise ValueError(f"at most {MAX_BUCKETS} buckets, got {len(buckets)}")
    for k, ki in buckets:
        if k < 1 or ki < 0 or (proposals > 1 and ki >= 64):
            raise ValueError(f"bad bucket (k={k}, ki={ki}) for P={proposals}")
    for name, t, dt, shape in [
            *[(f"words[{j}]", w, torch.int32, (S,)) for j, w in enumerate(words)],
            *[(n, t, ref.dtype, sh) for n, t, sh in sums if t is not None]]:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dt} {list(shape)}, got "
                             f"{t.dtype} {list(t.shape)}")
        if t.device != ref.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {ref.device}")


def roll_apply(xs, pos, words, eta: float, buckets, proposals: int,
               dsum=None, csum=None):
    """The new xs [S] of one 1D sweep: the roll buckets ``buckets``
    ((k, ki) pairs) added to the bucket kernel's ``dsum``/``csum`` (None:
    zeros) and the combine.  ``words`` as in ``sweep_dense.bucket_apply``.
    CUDA tensors launch the kernel and count one launch in
    ``roll_apply.launches``; CPU tensors run the plain version."""
    words = list(words) if isinstance(words, (list, tuple)) else [words]
    S = xs.shape[0]
    _check(xs, words, buckets, proposals,
           [("xs", xs, (S,)), ("pos", pos, (S,)), ("dsum", dsum, (S,)),
            ("csum", csum, (S,))])
    if (dsum is None) != (csum is None):
        raise ValueError("dsum and csum come together")
    if xs.device.type == "cpu":
        return roll_apply_ref(xs, pos, words, eta, buckets, proposals, dsum,
                              csum)
    if xs.device.type != "cuda":
        raise ValueError(f"roll_apply runs on cpu or cuda, not {xs.device}")
    if xs.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the roll kernel is float32 or float64, not "
                         f"{xs.dtype}")
    from ..kernels import roll_apply_cuda

    out = roll_apply_cuda(xs, pos, words, eta, buckets, proposals, dsum, csum)
    roll_apply.launches += 1
    return out


roll_apply.launches = 0


def roll_apply_nd(my_pos, my_c, lane0, cs, words, eta: float, buckets,
                  proposals: int, acc=None, wacc=None):
    """The new cs [2D, S] of one nD sweep: the roll buckets added to the
    nD bucket kernel's ``acc [D, S]``/``wacc [S]`` (None: zeros) and the
    per-end combine.  ``my_pos`` [S] and ``my_c`` [D, S] are the chosen
    end's position and coordinates, ``lane0`` bool [S] whether that end
    is end 0.  CUDA tensors launch the kernel and count one launch in
    ``roll_apply_nd.launches``; CPU tensors run the plain version."""
    words = list(words) if isinstance(words, (list, tuple)) else [words]
    S = my_pos.shape[0]
    if my_c.dim() != 2 or my_c.shape[0] < 1:
        raise ValueError(f"my_c must be [D, {S}], got {list(my_c.shape)}")
    D = my_c.shape[0]
    _check(my_pos, words, buckets, proposals,
           [("my_pos", my_pos, (S,)), ("my_c", my_c, (D, S)),
            ("cs", cs, (2 * D, S)), ("acc", acc, (D, S)),
            ("wacc", wacc, (S,))])
    if (acc is None) != (wacc is None):
        raise ValueError("acc and wacc come together")
    if lane0.dtype != torch.bool or tuple(lane0.shape) != (S,) or (
            lane0.device != my_pos.device) or not lane0.is_contiguous():
        raise ValueError(f"lane0 must be contiguous bool [{S}] on "
                         f"{my_pos.device}")
    if my_pos.device.type == "cpu":
        return roll_apply_nd_ref(my_pos, my_c, lane0, cs, words, eta,
                                 buckets, proposals, acc, wacc)
    if my_pos.device.type != "cuda":
        raise ValueError(f"roll_apply_nd runs on cpu or cuda, not "
                         f"{my_pos.device}")
    if my_pos.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the roll kernel is float32 or float64, not "
                         f"{my_pos.dtype}")
    if D > MAX_DIMS:
        raise ValueError(f"the nD kernel is built for at most {MAX_DIMS} "
                         f"dimensions, got {D}")
    from ..kernels import roll_apply_nd_cuda

    out = roll_apply_nd_cuda(my_pos, my_c, lane0, cs, words, eta, buckets,
                             proposals, acc, wacc)
    roll_apply_nd.launches += 1
    return out


roll_apply_nd.launches = 0
