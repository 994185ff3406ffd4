"""``jax.random`` draws in torch, on the device.

The device half of the draws in :mod:`.keys` (numpy, on the host):
:func:`split`, :func:`bits`, :func:`uniform`, :func:`randint` and
:func:`bernoulli`, bit-identical to JAX 0.9's defaults (threefry2x32
with ``jax_threefry_partitionable`` on).  Keys stay small: they are
derived on the host (``keys.fold_in``, ``keys.split``) and passed here
either as a pair of Python ints or as an int64 tensor ``[..., 2]``
already on the device, whose leading axes broadcast before the draw's
shape.  Only the ``[..., *shape]`` counters and their outputs live on
the device, so no draw copies anything from the host.

Unsigned 32-bit words live in int64 tensors masked to 32 bits, as in
``sweep_common``: torch's uint32 supports few ops, and a right shift of
an int32 is arithmetic.  A 64-bit draw is returned as the int64 with the
same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .keys import MANT_SHIFT, ONE_BITS
from .keys import split as split_np

__all__ = ["threefry2x32", "split", "bits", "uniform", "randint", "bernoulli"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, on int64 tensors of u32 values; ``k0``
    and ``k1`` are ints or tensors broadcast against the counters.
    Returns the two output words (new int64 tensors)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.contiguous(), x1.contiguous()
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            t = torch.bitwise_left_shift(x1, r).bitwise_and_(_M32)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_M32)
    return x0, x1


def _key_words(key, n_shape: int):
    """(k0, k1): ints, or int64 tensors shaped to broadcast over
    ``n_shape`` trailing draw axes."""
    if isinstance(key, torch.Tensor):
        lead = key.shape[:-1]
        return tuple(key[..., w].reshape(lead + (1,) * n_shape)
                     for w in (0, 1))
    k0, k1 = (int(w) for w in key)     # one key: a pair of words
    return k0, k1


def _draw(key, shape, device):
    """threefry2x32 of every counter of ``shape`` (the 64-bit iota as
    (hi, lo) words) under ``key``: (bits1, bits2)."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    if isinstance(key, torch.Tensor):
        device = key.device
    i = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    k0, k1 = _key_words(key, len(shape))
    return threefry2x32(k0, k1, i >> 32, i & _M32)


def split(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.split(key, n)``: int64 ``[..., n, 2]``."""
    b1, b2 = _draw(key, (n,), device)
    return torch.stack([b1, b2], dim=-1)


def bits(key, shape, device=None, width: int = 32) -> torch.Tensor:
    """``jax.random.bits``: ``bits1 ^ bits2`` (width 32, u32 values), or
    ``bits1 << 32 | bits2`` as the int64 with those bits (width 64)."""
    b1, b2 = _draw(key, shape, device)
    if width == 32:
        return b1.bitwise_xor_(b2)
    if width == 64:
        # b1 as a signed word times 2^32 cannot overflow int64
        return (b1 - (b1 >> 31 << 32)) * (1 << 32) + b2
    raise ValueError(f"width must be 32 or 64, got {width}")


def uniform(key, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1): the
    mantissa from the top bits of a draw of the float's width, OR-ed
    with 1.0, minus 1."""
    if dtype == torch.float32:
        b = bits(key, shape, device)
        f = (b >> MANT_SHIFT[np.float32]) | ONE_BITS[np.float32]
        return f.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        b1, b2 = _draw(key, shape, device)
        # the top 52 of the 64 bits b1 << 32 | b2
        f = (b1 << (32 - MANT_SHIFT[np.float64])) | (b2 >> MANT_SHIFT[np.float64])
        return (f | ONE_BITS[np.float64]).view(torch.float64) - 1.0
    raise ValueError(f"uniform draws float32 or float64, not {dtype}")


def randint(key, shape, minval, maxval, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``:
    ``key`` is split on the host (a pair of ints) or on the device (a
    tensor); ``minval``/``maxval`` are ints or int tensors broadcast
    against the result, int32 values.  Returns int32."""
    if isinstance(key, torch.Tensor):
        ks = split(key, 2)
        k_hi, k_lo = ks[..., 0, :], ks[..., 1, :]
    else:
        k_hi, k_lo = split_np(key, 2)
    hi = bits(k_hi, shape, device)
    lo = bits(k_lo, shape, device)
    if isinstance(minval, int) and isinstance(maxval, int):
        # scalar bounds stay on the host: no copy to the device
        span = 1 if maxval <= minval else (maxval - minval) & _M32
    else:
        minval, maxval = (v.long() if isinstance(v, torch.Tensor) else int(v)
                          for v in (minval, maxval))
        span = torch.where(maxval <= minval, 1, (maxval - minval) & _M32)
    mult = ((((1 << 16) % span) ** 2) & _M32) % span
    off = (((hi % span) * mult) & _M32) + lo % span
    off = (off & _M32) % span
    out = (off + minval) & _M32
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def bernoulli(key, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` with a Python-float ``p``
    under ``jax_enable_x64`` (``keys.bernoulli``): an f64 uniform
    ``< p``."""
    return uniform(key, shape, torch.float64, device) < p
