"""Host-side key schedule of the sweep engine: Threefry-2x32 in numpy.

The JAX engine derives one key per executed sweep with
``jax.random.fold_in(base_key, sweep_index)`` and, when a sweep draws
P > 1 proposals, one more per proposal with ``fold_in(key, p)``
(``gfasort_tpu/ops/sweep.py``).  The hash RNG then reads only the two
32-bit words of each key (``sweep_common.sweep_rng``).  Every key of a
schedule is known before the run starts, so the port computes them all
here on the host and hands the sweep loop a small u32 table.

``fold_in(key, d)`` is ``threefry2x32(key, (0, d))`` (JAX's
``_threefry_fold_in`` seeds the counter pair with the 64-bit split of
``d``); ``jax.random.key(seed)`` holds ``(seed >> 32, seed & 0xFFFFFFFF)``.

The draws the engines take from ``jax.random`` are here too, in numpy,
bit-identical to JAX 0.9's defaults (threefry2x32 with
``jax_threefry_partitionable`` on): :func:`split`, :func:`bits`,
:func:`uniform`, :func:`randint` and :func:`bernoulli`.  Each counter
of a draw of shape ``shape`` is the 64-bit iota over the shape as a
(hi, lo) pair of words; :mod:`.jrandom` computes the same draws with
torch on the device.  Keys are u32 ``[..., 2]`` arrays; the leading
axes of a key broadcast before the draw's own shape.
"""

from __future__ import annotations

import numpy as np

__all__ = ["threefry2x32", "key_data", "fold_in", "sweep_key_table",
           "split", "bits", "uniform", "randint", "bernoulli",
           "MANT_SHIFT", "ONE_BITS"]

# uniform: the float's mantissa from the top bits of a draw of the
# float's width, OR-ed with 1.0 (``jax.random.uniform``)
MANT_SHIFT = {np.float32: 32 - 23, np.float64: 64 - 52}
ONE_BITS = {np.float32: 0x3F800000, np.float64: 0x3FF0000000000000}

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, vectorised over numpy u32 arrays
    (broadcasting).  Returns the two output words."""
    args = [np.asarray(a, dtype=np.uint32) for a in (k0, k1, x0, x1)]
    shape = np.broadcast_shapes(*(a.shape for a in args))
    # flat 1-d arrays: numpy wraps u32 array arithmetic silently, while
    # 0-d operands would become scalars that warn on overflow
    k0, k1, x0, x1 = (np.broadcast_to(a, shape).reshape(-1) for a in args)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0.reshape(shape), x1.reshape(shape)


def key_data(seed: int) -> np.ndarray:
    """The words of ``jax.random.key(seed)`` for a non-negative seed."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``key_data(fold_in(key, d))`` for every ``d`` in ``data``.

    ``key``: u32 [..., 2]; ``data``: non-negative ints, broadcast
    against the key's leading shape.  Returns u32 [..., 2]."""
    key = np.asarray(key, dtype=np.uint32)
    d = np.asarray(data, dtype=np.int64)
    if (d < 0).any() or (d >= 1 << 32).any():
        raise ValueError("fold_in data must be in [0, 2**32)")
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          np.zeros(d.shape, np.uint32), d.astype(np.uint32))
    return np.stack([y0, y1], axis=-1)


def sweep_key_table(base_key: np.ndarray, n_exec: int, proposals: int) -> np.ndarray:
    """u32 [n_exec, P, 2] table of ``(b2, b1)`` hash-RNG words.

    Row ``e`` holds the key of executed sweep ``e`` — the UNCLAMPED
    index ``p_idx * consensus_every + j * n_phase + rr`` of the JAX
    engine, which is ``e`` itself.  With P == 1 there is no
    per-proposal fold; with P > 1 proposal ``p`` uses
    ``fold_in(sweep_key, p)``.  ``sweep_rng`` reads ``b1 = kd[-1]`` and
    ``b2 = kd[-2]``, so ``(b2, b1)`` is the key's word order."""
    sweep_keys = fold_in(np.asarray(base_key, np.uint32), np.arange(n_exec))
    if proposals == 1:
        return sweep_keys[:, None, :]
    return fold_in(sweep_keys[:, None, :], np.arange(proposals)[None, :])


def _counter_words(shape):
    """(hi, lo) u32 words of the 64-bit iota over ``shape``."""
    i = np.arange(int(np.prod(shape, dtype=np.int64)),
                  dtype=np.uint64).reshape(shape)
    return (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)


def _draw(key, shape):
    """threefry2x32 of every counter of ``shape`` under each key:
    (bits1, bits2), u32 ``[*key.shape[:-1], *shape]``."""
    key = np.asarray(key, dtype=np.uint32)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,) * len(shape))
    k1 = key[..., 1].reshape(lead + (1,) * len(shape))
    hi, lo = _counter_words(tuple(shape))
    return threefry2x32(k0, k1, hi, lo)


def split(key, n: int) -> np.ndarray:
    """``jax.random.split(key, n)``: u32 ``[..., n, 2]``; key ``i`` is
    the two output words of counter ``i``."""
    b1, b2 = _draw(key, (int(n),))
    return np.stack([b1, b2], axis=-1)


def bits(key, shape, width: int = 32) -> np.ndarray:
    """``jax.random.bits``: u32 ``bits1 ^ bits2`` (width 32), or u64
    ``bits1 << 32 | bits2`` (width 64)."""
    b1, b2 = _draw(key, tuple(shape))
    if width == 32:
        return b1 ^ b2
    if width == 64:
        return (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    raise ValueError(f"width must be 32 or 64, got {width}")


def uniform(key, shape, dtype=np.float32) -> np.ndarray:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1): f32 or f64."""
    dtype = np.dtype(dtype).type
    width = 32 if dtype == np.float32 else 64
    ut = np.uint32 if width == 32 else np.uint64
    b = bits(key, shape, width)
    f = (b >> ut(MANT_SHIFT[dtype])) | ut(ONE_BITS[dtype])
    return f.view(dtype) - dtype(1.0)


def randint(key, shape, minval, maxval) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``:
    two draws from ``split(key, 2)``, ``higher % span * multiplier +
    lower % span`` in wrapping u32 arithmetic, then ``% span`` and
    ``minval +``; ``span`` is 1 where ``maxval <= minval``.  ``minval``
    and ``maxval`` are int32 values broadcast against the result."""
    ks = split(key, 2)
    hi = bits(ks[..., 0, :], shape).astype(np.uint64)
    lo = bits(ks[..., 1, :], shape).astype(np.uint64)
    lo_v = np.asarray(minval, dtype=np.int64)
    hi_v = np.asarray(maxval, dtype=np.int64)
    span = np.where(hi_v <= lo_v, 1, (hi_v - lo_v) & 0xFFFFFFFF).astype(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    mult = np.uint64(1 << 16) % span
    mult = ((mult * mult) & m32) % span
    off = (((hi % span) * mult) & m32) + lo % span
    off = (off & m32) % span
    return ((lo_v + off.astype(np.int64)) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def bernoulli(key, p: float, shape) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` with a Python-float ``p``
    under ``jax_enable_x64``: ``p``'s dtype is f64, so the draw is
    ``uniform(key, shape, f64) < p``.  (Without x64 JAX would draw an
    f32 uniform; the batched engine turns x64 on whenever it samples in
    f64.)"""
    return uniform(key, shape, np.float64) < p
