"""The ``L`` step's initial coordinates and the layout's node-end state.

:func:`layout_initial_coords` is a frozen copy of
``gfasort_tpu_torch/ops/exact.py::layout_initial_coords`` with the
xoshiro256+ stream of ``gfasort_tpu_torch/ops/rng.py`` it draws from.
"""

from __future__ import annotations

import math

import numpy as np

from ..index import PathIndex

__all__ = ["Xoshiro256Plus", "layout_initial_coords"]

MASK64 = (1 << 64) - 1


def splitmix64_stream(state: int):
    """SplitMix64 generator (rand_core's ``seed_from_u64`` filler)."""
    while True:
        state = (state + 0x9E3779B97F4A7C15) & MASK64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        yield (z ^ (z >> 31)) & MASK64


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & MASK64


class Xoshiro256Plus:
    """xoshiro256+ with rand_core's seed_from_u64 seeding."""

    __slots__ = ("s0", "s1", "s2", "s3")

    def __init__(self, seed: int):
        gen = splitmix64_stream(seed & MASK64)
        self.s0 = next(gen)
        self.s1 = next(gen)
        self.s2 = next(gen)
        self.s3 = next(gen)

    def next_u64(self) -> int:
        result = (self.s0 + self.s3) & MASK64
        t = (self.s1 << 17) & MASK64
        self.s2 ^= self.s0
        self.s3 ^= self.s1
        self.s1 ^= self.s2
        self.s0 ^= self.s3
        self.s2 ^= t
        self.s3 = _rotl(self.s3, 45)
        return result

    def random_f64(self) -> float:
        """rand's StandardUniform for f64: 53 bits in [0, 1)."""
        return (self.next_u64() >> 11) * (1.0 / (1 << 53))



def layout_initial_coords(pidx: PathIndex, dims: int, seed: int) -> np.ndarray:
    """Initial nD layout state, shape [2N, D] (src/sgd.rs:828-854):
    dim 0 = cumulative bp offset for the + end (row 2i) and + node_len
    for the - end (row 2i+1); dims 1.. = N(0,1)·sqrt(2·num_nodes) drawn
    sequentially from a seed-seeded stream.

    The reference draws its noise via rand_distr's ziggurat; we use
    Box–Muller on the same Xoshiro stream — layout parity is
    stress-tolerance-based, not bit-based (BASELINE.md metric 3), and
    nothing downstream shares this stream.
    """
    n = pidx.num_nodes
    init_rng = Xoshiro256Plus(seed)
    sqrt_n = math.sqrt(n * 2.0)
    spare: list = [None]

    def gauss():
        if spare[0] is not None:
            v = spare[0]
            spare[0] = None
            return v
        while True:
            u1 = init_rng.random_f64()
            if u1 > 0.0:
                break
        u2 = init_rng.random_f64()
        r = math.sqrt(-2.0 * math.log(u1))
        spare[0] = r * math.sin(2.0 * math.pi * u2)
        return r * math.cos(2.0 * math.pi * u2)

    coords = np.zeros((2 * n, dims), dtype=np.float64)
    length = 0
    node_len = pidx.node_len.tolist()
    for idx in range(n):
        coords[idx * 2, 0] = float(length)
        for d in range(1, dims):
            coords[idx * 2, d] = gauss() * sqrt_n
        coords[idx * 2 + 1, 0] = float(length + node_len[idx])
        for d in range(1, dims):
            coords[idx * 2 + 1, d] = gauss() * sqrt_n
        length += node_len[idx]
    return coords
