"""Bit-exact replica of the reference's RNG stack.

The reference samples from ``rand_xoshiro::Xoshiro256Plus`` seeded with
``rand_core``'s SplitMix64-based ``seed_from_u64`` (gfasort
``src/sgd.rs:429-432``), draws f64s via the 53-bit multiply convention,
and integer ranges via ``rand``'s Lemire widening-multiply rejection
sampler.  Reproducing these exactly is what makes the sequential oracle
(:mod:`gfasort_tpu_torch.ops.exact`) bit-compatible with the Rust tool's
sampling stream (SURVEY.md §8.4).

Pure Python; the C++ native engine implements the same primitives for
speed and the test suite cross-checks the two.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1

__all__ = ["splitmix64_stream", "Xoshiro256Plus", "UniformInt"]


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

    @classmethod
    def from_raw_state(cls, s0: int, s1: int, s2: int, s3: int):
        """Bypass seed_from_u64 (for canonical-vector tests that pin
        the xoshiro256+ core against the published reference outputs)."""
        rng = cls.__new__(cls)
        rng.s0, rng.s1, rng.s2, rng.s3 = (
            s0 & MASK64, s1 & MASK64, s2 & MASK64, s3 & MASK64,
        )
        return rng

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


class UniformInt:
    """rand 0.9 ``Uniform::new(low, high)`` over 64-bit ints: Lemire
    widening-multiply with threshold rejection."""

    __slots__ = ("low", "range", "thresh")

    def __init__(self, low: int, high: int):
        if high <= low:
            raise ValueError("Uniform::new requires low < high")
        self.low = low
        self.range = (high - low) & MASK64
        self.thresh = ((1 << 64) - self.range) % self.range if self.range else 0

    def sample(self, rng: Xoshiro256Plus) -> int:
        rng_range = self.range
        if rng_range == 0:
            return rng.next_u64()
        while True:
            x = rng.next_u64()
            m = x * rng_range
            lo = m & MASK64
            if lo >= self.thresh:
                return self.low + (m >> 64)
