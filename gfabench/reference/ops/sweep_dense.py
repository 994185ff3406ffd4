"""Bucket apply, plain PyTorch: the pair updates of every offset bucket
with k <= KMAX, 1D (:func:`bucket_apply_ref`) and nD
(:func:`dense_apply_nd_ref`).  A frozen copy of the plain versions of
``gfasort_tpu_torch/ops/sweep_dense.py``, which the port's bucket kernels
equal bit for bit.

No end guards: a ``+k``/``-k`` choice is in-path by the sampler's
construction, and reads past either end of the arrays give xs = pos = 0
and the INACTIVE (P == 1) or PACKED_INACTIVE (P > 1) choice word.
"""

from __future__ import annotations

import numpy as np
import torch

from .sweep_common import INACTIVE, PACKED_INACTIVE, unpack_choice

__all__ = ["bucket_apply_ref", "dense_apply_nd_ref", "sqrt_rn"]


def _n_words(proposals: int) -> int:
    return 1 if proposals == 1 else -(-proposals // 4)


def _fields(words, proposals: int):
    """Per-proposal signed choice views of the choice word list."""
    if proposals == 1:
        return [words[0]]
    return [unpack_choice(words[p // 4], p % 4) for p in range(proposals)]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of an f32 or f64 tensor, on
    every device.  CUDA's sqrt is the IEEE one; PyTorch's vectorised
    sqrt on the CPU is not (1 ulp off for some inputs, in f32 and in
    f64), so there numpy's IEEE sqrt computes it."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.contiguous().numpy()))


def _shift(a: torch.Tensor, k: int, fill) -> torch.Tensor:
    """out[s] = a[s + k] inside the array, ``fill`` outside."""
    out = torch.full_like(a, fill)
    S = a.shape[0]
    if k >= 0:
        out[: max(S - k, 0)] = a[k:]
    else:
        out[-k:] = a[: max(S + k, 0)]
    return out


def bucket_apply_ref(xs, pos, words, eta: float, buckets, proposals: int = 1):
    """Plain PyTorch bucket apply (the spec of the kernel)."""
    fill = int(INACTIVE) if proposals == 1 else int(PACKED_INACTIVE)
    sidxs = _fields(words, proposals)
    one = torch.ones((), dtype=xs.dtype, device=xs.device)
    eta_t = torch.full((), eta, dtype=xs.dtype, device=xs.device)
    dsum = torch.zeros_like(xs)
    csum = torch.zeros_like(xs)
    for k, ki in buckets:
        for sgn in (+1, -1):
            kk = sgn * k
            xs_o = _shift(xs, kk, 0.0)
            pos_o = _shift(pos, kk, 0.0)
            sidxs_o = _fields([_shift(w, kk, fill) for w in words], proposals)
            w = torch.zeros_like(xs)
            for s, s_o in zip(sidxs, sidxs_o):
                if sgn > 0:
                    wb = (s == ki) | (s_o == ~ki)
                else:
                    wb = (s == ~ki) | (s_o == ki)
                w = w + wb.to(xs.dtype)
            d = torch.abs(pos - pos_o)
            valid = d != 0
            w = torch.where(valid, w, 0.0)
            safe = torch.where(valid, d, one)
            mu = torch.minimum(eta_t / safe, one)
            dx = xs - xs_o
            dx = torch.where(dx == 0, 1e-9, dx)
            mag = torch.abs(dx)
            half_sgn = torch.where(dx >= 0, 0.5, -0.5).to(xs.dtype)
            r_x = mu * (mag - safe) * half_sgn
            dsum = dsum - w * r_x
            csum = csum + w
    return dsum, csum


def dense_apply_nd_ref(my_pos, words, my_c, eta: float, buckets,
                       proposals: int = 1):
    """Plain PyTorch nD bucket apply (the spec of the nD kernel): the
    Euclidean pair update over the D rows of ``my_c``, with the
    zero-distance guard on dimension 0 and the r clamp.  ``1 / sqrt``
    stands for the JAX ``rsqrt``: both factors are correctly rounded
    (:func:`sqrt_rn`)."""
    fill = int(INACTIVE) if proposals == 1 else int(PACKED_INACTIVE)
    sidxs = _fields(words, proposals)
    D = my_c.shape[0]
    one = torch.ones((), dtype=my_pos.dtype, device=my_pos.device)
    eta_t = torch.full((), eta, dtype=my_pos.dtype, device=my_pos.device)
    acc = torch.zeros_like(my_c)
    wacc = torch.zeros_like(my_pos)
    for k, ki in buckets:
        for sgn in (+1, -1):
            kk = sgn * k
            pos_o = _shift(my_pos, kk, 0.0)
            c_o = torch.stack([_shift(c, kk, 0.0) for c in my_c])
            sidxs_o = _fields([_shift(w, kk, fill) for w in words], proposals)
            w = torch.zeros_like(my_pos)
            for s, s_o in zip(sidxs, sidxs_o):
                if sgn > 0:
                    wb = (s == ki) | (s_o == ~ki)
                else:
                    wb = (s == ~ki) | (s_o == ki)
                w = w + wb.to(my_pos.dtype)
            d = torch.abs(my_pos - pos_o)
            valid = d != 0
            w = torch.where(valid, w, 0.0)
            safe = torch.where(valid, d, one)
            mu = torch.minimum(eta_t / safe, one)
            deltas = my_c - c_o
            # summed in dimension order, as the JAX ``sum`` does
            mag_sq = deltas[0] * deltas[0]
            for dim in range(1, D):
                mag_sq = mag_sq + deltas[dim] * deltas[dim]
            zero = mag_sq == 0
            deltas[0] = torch.where(zero, 1e-9, deltas[0])
            mag_sq = torch.where(zero, 1e-18, mag_sq)
            inv = 1.0 / sqrt_rn(mag_sq)
            mag = mag_sq * inv
            r = torch.clamp_max(mu * (mag - safe) * 0.5 * inv, 1e30)
            wr = w * r
            acc = acc - wr * deltas
            wacc = wacc + w
    return acc, wacc
