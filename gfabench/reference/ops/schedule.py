"""Learning-rate schedule (gfasort ``src/sgd.rs:617-638``).

``eta_max = 1/w_min``, ``eta_min = eps/w_max``,
``lambda = ln(eta_max/eta_min)/(iter_max-1)``, and for t = 0..=iter_max
(inclusive — iter_max+1 values)::

    eta_t = eta_max * exp(-lambda * |t - iter_with_max_learning_rate|)
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["eta_schedule"]


def eta_schedule(
    w_min: float,
    w_max: float,
    iter_max: int,
    iter_with_max_learning_rate: int,
    eps: float,
) -> np.ndarray:
    eta_max = 1.0 / w_min
    eta_min = eps / w_max
    # IEEE float division like the reference (iter_max=1 -> lam=inf,
    # not a Python ZeroDivisionError)
    lam = float(np.float64(math.log(eta_max / eta_min)) / np.float64(iter_max - 1.0))
    # scalar libm exp per entry, matching the reference's per-t f64 ops
    # bit-for-bit (numpy's SIMD exp can differ in the last ulp)
    return np.asarray(
        [
            eta_max * math.exp(-lam * abs(t - iter_with_max_learning_rate))
            for t in range(iter_max + 1)
        ],
        dtype=np.float64,
    )
