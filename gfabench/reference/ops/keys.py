"""Host-side key schedule of the sweep engine, Threefry-2x32 in numpy: one
key per executed sweep, ``fold_in(base_key, e)``, and with P > 1 one per
proposal, ``fold_in(key, p)``; the hash RNG reads the two 32-bit words of
each key.  A frozen copy of the hash route's part of
``gfasort_tpu_torch/ops/keys.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["threefry2x32", "key_data", "fold_in", "sweep_key_table"]

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
