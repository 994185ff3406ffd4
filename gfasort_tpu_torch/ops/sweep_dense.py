"""Bucket apply: every offset bucket with k <= KMAX in one pass.

Counterparts of ``gfasort_tpu/ops/sweep_dense.py::build_bucket_apply``
(the 1D sort) and ``::build_dense_apply_nd`` (the nD layout).  On a CUDA
tensor :func:`bucket_apply` and :func:`dense_apply_nd` launch the
hand-written Hopper kernels (``csrc/bucket_apply.cu``,
``csrc/dense_apply_nd.cu``); on a CPU tensor they run
:func:`bucket_apply_ref` and :func:`dense_apply_nd_ref`, the plain
PyTorch versions that mirror the JAX package's ``apply_ref``.  A CUDA
tensor never reaches a plain version, and a failed launch raises.

Contract (as in the JAX package): no end guards — a ``+k``/``-k``
choice is in-path by the sampler's construction, and reads past either
end of the arrays give xs = pos = 0 and the INACTIVE (P == 1) or
PACKED_INACTIVE (P > 1) choice word.
"""

from __future__ import annotations

import numpy as np
import torch

from .sweep_common import INACTIVE, PACKED_INACTIVE, unpack_choice

__all__ = ["MAX_BUCKETS", "MAX_DIMS", "bucket_apply", "bucket_apply_ref",
           "dense_apply", "dense_apply_nd", "dense_apply_nd_ref", "sqrt_rn"]

MAX_BUCKETS = 64   # the kernels' bucket table (csrc/*.cu)
MAX_WORDS = 4      # P <= 16 proposals
MAX_DIMS = 8       # layout dimensions the nD kernel is built for


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


def _check(xs, pos, words, buckets, proposals):
    S = xs.shape[0]
    if S >= 1 << 31:
        raise ValueError(f"{S} steps exceed the kernel's int32 indexing")
    if proposals < 1 or proposals > 4 * MAX_WORDS:
        raise ValueError(f"proposals must be in [1, {4 * MAX_WORDS}]")
    if len(words) != _n_words(proposals):
        raise ValueError(f"{proposals} proposals need {_n_words(proposals)} "
                         f"choice words, got {len(words)}")
    if not 1 <= len(buckets) <= MAX_BUCKETS:
        raise ValueError(f"1 to {MAX_BUCKETS} buckets, got {len(buckets)}")
    for k, ki in buckets:
        if k < 1 or ki < 0 or (proposals > 1 and ki >= 64):
            raise ValueError(f"bad bucket (k={k}, ki={ki}) for P={proposals}")
    for name, t, dt in [("xs", xs, torch.float32), ("pos", pos, torch.float32)] + [
            (f"words[{j}]", w, torch.int32) for j, w in enumerate(words)]:
        if t.dtype != dt or t.dim() != 1 or t.shape[0] != S:
            raise ValueError(f"{name} must be {dt} [{S}], got {t.dtype} "
                             f"{list(t.shape)}")
        if t.device != xs.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {xs.device}")


def bucket_apply(xs, pos, words, eta: float, buckets, proposals: int = 1):
    """(dsum, csum) [S] f32 of the given ``buckets`` — (k, ki) pairs,
    ``ki`` the bucket's index in its phase's offset set.

    ``words``: one int32 [S] choice array (P == 1) or the ceil(P/4)
    packed words of :func:`.sweep_common.pack_choices_words`; ``eta``:
    the sweep's learning rate (an f32 value).  CUDA tensors launch the
    kernel and count one launch in ``bucket_apply.launches``; CPU
    tensors run the plain version."""
    words = list(words) if isinstance(words, (list, tuple)) else [words]
    _check(xs, pos, words, buckets, proposals)
    if xs.device.type == "cpu":
        return bucket_apply_ref(xs, pos, words, eta, buckets, proposals)
    if xs.device.type != "cuda":
        raise ValueError(f"bucket_apply runs on cpu or cuda, not {xs.device}")
    from ..kernels import bucket_apply_cuda

    out = bucket_apply_cuda(xs, pos, words, eta, buckets, proposals)
    bucket_apply.launches += 1
    return out


bucket_apply.launches = 0


def dense_apply(xs, pos, sidx, eta: float, n_dense: int):
    """Dense-only buckets (k = 1..n_dense, ki = k - 1), one proposal."""
    buckets = [(k, k - 1) for k in range(1, n_dense + 1)]
    return bucket_apply(xs, pos, sidx, eta, buckets)


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


def dense_apply_nd(my_pos, words, my_c, eta: float, buckets,
                   proposals: int = 1):
    """(acc f32 [D, S], wacc f32 [S]) of the given ``buckets`` for the
    nD layout: ``my_pos`` f32 [S] (the chosen end's path position),
    ``my_c`` f32 [D, S] (the chosen end's coordinates), ``words`` as in
    :func:`bucket_apply`.  CUDA tensors launch the kernel and count one
    launch in ``dense_apply_nd.launches``; CPU tensors run the plain
    version."""
    words = list(words) if isinstance(words, (list, tuple)) else [words]
    _check(my_pos, my_pos, words, buckets, proposals)
    if my_c.dtype != torch.float32 or my_c.dim() != 2 or (
            my_c.shape[1] != my_pos.shape[0]) or my_c.shape[0] < 1:
        raise ValueError(f"my_c must be float32 [D, {my_pos.shape[0]}], got "
                         f"{my_c.dtype} {list(my_c.shape)}")
    if my_c.device != my_pos.device or not my_c.is_contiguous():
        raise ValueError(f"my_c must be contiguous on {my_pos.device}")
    if my_pos.device.type == "cpu":
        return dense_apply_nd_ref(my_pos, words, my_c, eta, buckets, proposals)
    if my_pos.device.type != "cuda":
        raise ValueError(f"dense_apply_nd runs on cpu or cuda, not {my_pos.device}")
    if my_c.shape[0] > MAX_DIMS:
        raise ValueError(f"the nD kernel is built for at most {MAX_DIMS} "
                         f"dimensions, got {my_c.shape[0]}")
    from ..kernels import dense_apply_nd_cuda

    out = dense_apply_nd_cuda(my_pos, words, my_c, eta, buckets, proposals)
    dense_apply_nd.launches += 1
    return out


dense_apply_nd.launches = 0
