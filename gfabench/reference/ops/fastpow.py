"""ODGI's ``fast_precise_pow`` (gfasort ``src/sgd.rs:153-182``) and the Zipf
zeta tables, bit-exact and vectorized; a frozen copy of the numpy side of
``gfasort_tpu_torch/ops/fastpow.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fast_precise_pow", "fast_precise_pow_np", "zeta_table"]


def fast_precise_pow_np(a, b: float):
    """Vectorized over ``a`` (float64 array or scalar); ``b`` scalar ≥ 0."""
    a = np.asarray(a, dtype=np.float64)
    e = int(b)  # trunc toward zero (Rust `as i32`)
    if e < 0:
        raise ValueError("fast_precise_pow requires b >= 0 (reference loops forever otherwise)")

    bits = a.view(np.uint64) if a.shape else np.float64(a).view(np.uint64)
    high = (bits >> np.uint64(32)).astype(np.int64).astype(np.int32)
    new_high = ((b - e) * (high.astype(np.float64) - 1072632447.0) + 1072632447.0).astype(np.int32)
    # Rust: (new_high as u64) << 32 — i32→u64 sign-extends.
    frac_bits = (new_high.astype(np.int64).view(np.uint64)) << np.uint64(32)
    frac = frac_bits.view(np.float64)

    # Exponentiation by squaring with the integer part.
    base = a.copy() if a.shape else np.float64(a)
    r = np.ones_like(a) if a.shape else np.float64(1.0)
    exp = e
    while exp != 0:
        if exp & 1:
            r = r * base
        base = base * base
        exp >>= 1
    return r * frac


def fast_precise_pow(a: float, b: float) -> float:
    """Scalar convenience wrapper."""
    return float(fast_precise_pow_np(np.float64(a), b))


def zeta_table(space: int, space_max: int, quant_step: int, theta: float) -> np.ndarray:
    """Zipf zeta prefix table (src/sgd.rs:311-331 / :871-890).

    ``zetas[i] = Σ_{k=1..i} fpp(1/k, theta)`` for ``i ≤ space_max``;
    beyond that, one quantized entry every ``quant_step``.
    """
    if space <= space_max:
        size = space + 1
    else:
        size = space_max + (space - space_max) // quant_step + 2

    zetas = np.zeros(size, dtype=np.float64)
    if space <= 0:
        return zetas

    ks = np.arange(1, space + 1, dtype=np.float64)
    terms = fast_precise_pow_np(1.0 / ks, theta)
    prefix = np.cumsum(terms)  # sequential accumulation, same order

    upto = min(space, space_max)
    zetas[1 : upto + 1] = prefix[:upto]
    if space >= space_max:
        # entries at i = space_max, space_max+quant, ... (rs:325-330)
        i_vals = np.arange(space_max, space + 1, quant_step, dtype=np.int64)
        idx = space_max + 1 + (i_vals - space_max) // quant_step
        keep = idx < size
        zetas[idx[keep]] = prefix[i_vals[keep] - 1]
    return zetas
