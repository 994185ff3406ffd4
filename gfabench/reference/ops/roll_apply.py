"""Roll passes and combine, plain PyTorch: the pair updates of the offsets
above KMAX (one ``torch.roll`` pass per bucket and side) and the sweep's
final combine, 1D and nD.  A frozen copy of the plain versions of
``gfasort_tpu_torch/ops/roll_apply.py``, which the port's roll kernels
equal bit for bit.

Step t's partner for the bucket (k, ki) is read at (t + k) mod S and
(t - k) mod S; the wrap-around of the roll is guarded on the partner's
choice only.
"""

from __future__ import annotations

import torch

from .sweep_dense import _fields, sqrt_rn

__all__ = ["roll_apply_nd_ref", "roll_apply_ref"]


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
