"""The sweep engines' environment knobs, read in one place.

The JAX engines read six ``GFASORT_*`` variables while they build a
runner.  The port reads the same ones here, once per runner build, and
hands the values to both runners (1D and nD) through their plan.  A knob
that changes results is honoured, or refused by name:

* ``GFASORT_SWEEP_RNG`` — ``hash`` (default) or ``threefry``: the
  per-sweep draws (``sweep_common.sweep_rng``).  The float64 sweep always
  draws threefry, as in the JAX engines.
* ``GFASORT_SNAP`` — ``stoch`` (default) or ``down``: the sampler's snap
  of a drawn jump to the offset set, in both runners.
* ``GFASORT_KERNEL_KMAX`` — the largest offset handed to the bucket-apply
  kernel (default 1024, clamped to [0, 8192]); larger offsets run as
  roll passes.  0 serves no bucket by the kernel.
* ``GFASORT_DENSE_KERNEL`` — ``pallas`` serves the offsets up to KMAX by
  the kernel (when the offset set has two offsets <= 8, as the JAX gate
  asks); ``xla`` serves every offset by roll passes.  ``auto`` (default)
  is ``pallas`` in the port: the JAX engine's ``auto`` turns the kernel
  on only on a TPU backend (and above 2^18 steps), which makes it
  ``xla`` on the JAX CPU backend; the card is the port's accelerator,
  and the port keeps the kernel at every size.  A parity run against the
  JAX package on the CPU therefore sets ``pallas`` or ``xla`` in both.
* ``GFASORT_CONSENSUS`` — ``gather`` and ``auto`` (default) both run the
  gather-sum consensus, which adds each node's steps in the JAX engines'
  order.  The JAX ``auto`` may pick the grid consensus, an MXU one-hot
  design whose f32 dots are a TPU workaround that the port does not
  carry; ``grid`` is refused.
* ``GFASORT_SWEEP_DISPATCH_ELEMS`` — the element budget of one dispatch
  of the JAX engines (default 5e8; half of it in nD).  The port runs no
  dispatches, but the JAX engines execute whole dispatches of
  consensus periods, so the budget sets how many sweeps run
  (``SweepPlan.n_exec``).

Ignored on purpose, since they change no result: ``GFASORT_DK_BUDGET``
(whether the JAX engine precomputes term-distance tables) and
``GFASORT_ROT_UNROLL`` (how it unrolls a rotation block).  The TPU-only
knobs ``GFASORT_KERNEL_VMEM_BUDGET`` and ``GFASORT_GC_*`` have no
counterpart either.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = ["KMAX_DEFAULT", "KMAX_HW", "DISPATCH_ELEMS_DEFAULT", "SweepKnobs",
           "sweep_knobs"]

KMAX_DEFAULT = 1024
KMAX_HW = 8192              # the largest offset the kernels serve
DISPATCH_ELEMS_DEFAULT = int(5e8)


@dataclass(frozen=True)
class SweepKnobs:
    rng: str = "hash"               # "hash" | "threefry"
    snap: str = "stoch"             # "stoch" | "down"
    kmax: int = KMAX_DEFAULT
    dense_kernel: bool = True       # False under GFASORT_DENSE_KERNEL=xla
    dispatch_elems: int = DISPATCH_ELEMS_DEFAULT


def _choice(name: str, default: str, allowed) -> str:
    v = os.environ.get(name, default)
    if v not in allowed:
        raise ValueError(f"{name}={v!r}: expected one of {sorted(allowed)}")
    return v


def _int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected an integer") from None


def sweep_knobs() -> SweepKnobs:
    """The knobs as the environment sets them now."""
    consensus = _choice("GFASORT_CONSENSUS", "auto", {"auto", "gather", "grid"})
    if consensus == "grid":
        raise NotImplementedError(
            "GFASORT_CONSENSUS=grid: the grid (MXU one-hot) consensus is a "
            "TPU design the port does not carry; use gather or auto")
    dense = _choice("GFASORT_DENSE_KERNEL", "auto", {"auto", "pallas", "xla"})
    return SweepKnobs(
        rng=_choice("GFASORT_SWEEP_RNG", "hash", {"hash", "threefry"}),
        snap=_choice("GFASORT_SNAP", "stoch", {"stoch", "down"}),
        kmax=min(max(_int("GFASORT_KERNEL_KMAX", KMAX_DEFAULT), 0), KMAX_HW),
        dense_kernel=dense != "xla",
        dispatch_elems=_int("GFASORT_SWEEP_DISPATCH_ELEMS",
                            DISPATCH_ELEMS_DEFAULT),
    )
