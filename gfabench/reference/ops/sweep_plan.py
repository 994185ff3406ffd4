"""The sweep plans of the 1D engine (``Y``) and the nD layout engine
(``L``); a frozen copy of the single-card plans of
``gfasort_tpu_torch/ops/sweep_plan.py``, with every environment knob at
its default.

A plan holds what the engine decides on the host before its first
sweep: the shape-aware knobs, the offset set and its rotation phases, the
consensus period, the learning-rate schedule, the split of each phase's
buckets between the bucket pass (k <= KMAX) and the roll passes, and the
sampler's per-bucket Zipf constants.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..index import PathIndex
from ..params import LayoutSGDParams, PathSGDParams
from .fastpow import fast_precise_pow, zeta_table
from .schedule import eta_schedule
from .sweep_policy import (auto_sweep_config, fit_consensus_period,
                           offset_set, phase_structure)

__all__ = ["KMAX", "PhasePlan", "SweepPlan", "make_sweep_plan",
           "make_layout_plan", "bucket_consts", "executed_sweeps",
           "torch_dtype"]

# Largest offset handed to the bucket-apply kernel by default.  Bucket
# order and therefore the f32 summation order follow from it.
KMAX = 1024


@dataclass(frozen=True)
class SweepKnobs:
    """The ``GFASORT_*`` sweep knobs at their defaults (the benchmark sets
    none): hash draws, the stochastic snap, KMAX, the bucket kernel on,
    the dispatch budget of 5e8 elements."""

    rng: str = "hash"
    snap: str = "stoch"
    kmax: int = KMAX
    dense_kernel: bool = True
    dispatch_elems: int = int(5e8)

_DTYPES = {"float32": np.float32, "float64": np.float64}


def torch_dtype(name: str):
    """The torch dtype of a params ``dtype`` name."""
    import torch

    return {"float32": torch.float32, "float64": torch.float64}[name]

# The theta the sampler switches to in cooling sweeps (sweep_common).
COOL_THETA = 0.001


def bucket_consts(offs: np.ndarray, params: PathSGDParams, zetas: np.ndarray,
                  theta: float):
    """Per-bucket Zipf constants of one offset set, in f64 — the numpy
    form of ``_bucket_consts`` in ``make_offset_sampler``.  Returns
    (zeta [K], eta_z [K], zeta2theta)."""
    space_max = int(params.space_max)
    quant = int(params.space_quantization_step)
    K = len(offs)
    zeta_k = np.empty(K)
    etaz_k = np.empty(K)
    z2t = 1.0 + fast_precise_pow(0.5, theta)
    for kidx, n in enumerate(np.asarray(offs).tolist()):
        si = int(min(
            n if n <= space_max else space_max + (n - space_max) // quant + 1,
            len(zetas) - 1,
        ))
        zv = zetas[si] if zetas[si] > 0 else 1.0
        zeta_k[kidx] = zv
        etaz_k[kidx] = (1.0 - fast_precise_pow(2.0 / n, 1.0 - theta)) / (
            1.0 - z2t / zv
        )
    return zeta_k, etaz_k, z2t


@dataclass(frozen=True)
class PhasePlan:
    """One rotation phase: its offset set, bucket split and the sampler
    constants in f64, each indexed ``[cooling]`` (0 = warm, 1 = cool);
    ``sweep_common.sampler_consts`` rounds them to the run's dtype."""

    offs: np.ndarray            # i32 [K_p]
    kernel_buckets: tuple       # ((k, ki), ...) with k <= kmax
    roll_buckets: tuple         # ((k, ki), ...) the rest
    zeta: np.ndarray            # f64 [2, K_p]
    eta_z: np.ndarray           # f64 [2, K_p]
    zeta2theta: np.ndarray      # f64 [2]
    theta: np.ndarray           # f64 [2]
    space: int                  # params.space (jump spaces clamp to it)

    def alpha(self, cooling: bool, dtype) -> float:
        """1 / (1 - theta), computed in ``dtype`` as the JAX sampler does
        on the device."""
        one = dtype(1.0)
        return float(one / (one - dtype(self.theta[int(bool(cooling))])))


@dataclass(frozen=True)
class SweepPlan:
    proposals: int
    active_frac: float
    per_octave: int
    offs: np.ndarray            # the full offset set
    rotate: int
    consensus_every: int        # after the rotation round-up and the fit
    dense_kernel: bool          # the JAX engine's ``use_dense`` (1D)
    phases: tuple               # PhasePlan per rotation phase
    sweep_eta: np.ndarray       # [n_sweeps] in the run's dtype
    sweep_cool: np.ndarray      # bool [n_sweeps]
    updates_per_sweep: int
    n_exec: int                 # executed sweeps (:func:`executed_sweeps`)
    dtype: str = "float32"
    knobs: SweepKnobs = SweepKnobs()
    dims: int = 1               # coordinates per node end (1 = the 1D sort)

    @property
    def n_sweeps(self) -> int:
        return len(self.sweep_eta)

    def sweep(self, e: int):
        """(phase index, eta, cooling) of executed sweep ``e``.  The key
        of sweep ``e`` is folded from the unclamped ``e``; eta and the
        cooling flag come from the clamped index."""
        r = min(e, self.n_sweeps - 1)
        return (e % len(self.phases), float(self.sweep_eta[r]),
                bool(self.sweep_cool[r]))


def executed_sweeps(n_sweeps: int, ce: int, S: int, budget: int) -> int:
    """Sweeps the JAX engines execute: whole dispatches of
    ``chunk_periods`` consensus periods, ``chunk_periods`` the element
    ``budget`` over S x ce (at least 1, at most all periods).  The sweeps
    past the schedule run at the clamped (terminal) eta with their own
    keys, and each extra period ends in a consensus."""
    n_periods = -(-n_sweeps // ce)
    chunk = max(1, min(n_periods, budget // max(S * ce, 1)))
    return -(-n_periods // chunk) * chunk * ce


def _phase_plan(offs_p: np.ndarray, params: PathSGDParams, zetas: np.ndarray,
                dense: bool, kmax: int, proposals: int) -> PhasePlan:
    offs_p = np.asarray(offs_p, dtype=np.int32)
    kernel = tuple((int(k), ki) for ki, k in enumerate(offs_p.tolist())
                   if dense and k <= kmax)
    served = {ki for _, ki in kernel}
    roll = tuple((int(k), ki) for ki, k in enumerate(offs_p.tolist())
                 if ki not in served)
    if proposals > 1 and any(ki >= 64 for _, ki in kernel):
        raise ValueError("packed choices need bucket indices < 64")
    warm = bucket_consts(offs_p, params, zetas, float(params.theta))
    cool = bucket_consts(offs_p, params, zetas, COOL_THETA)
    return PhasePlan(
        offs=offs_p,
        kernel_buckets=kernel,
        roll_buckets=roll,
        zeta=np.array([warm[0], cool[0]]),
        eta_z=np.array([warm[1], cool[1]]),
        zeta2theta=np.array([warm[2], cool[2]]),
        theta=np.array([float(params.theta), COOL_THETA]),
        space=int(params.space),
    )


def _knobs(auto: dict, per_octave, consensus_every, active_frac, rotate,
           dense_upto, proposals):
    """Each knob, or its shape-aware default when None."""
    return (
        auto["per_octave"] if per_octave is None else per_octave,
        auto["consensus_every"] if consensus_every is None else consensus_every,
        auto["active_frac"] if active_frac is None else active_frac,
        auto["rotate"] if rotate is None else rotate,
        auto.get("dense_upto", 8) if dense_upto is None else dense_upto,
        max(1, int(auto.get("proposals", 1) if proposals is None
                   else proposals)),
    )


def _build_plan(pidx: PathIndex, params, per_octave, consensus_every,
                active_frac, rotate, dense_upto, P: int, dims: int,
                phase_gate, budget_div: int,
                exec_len: Optional[int] = None) -> SweepPlan:
    """The part both engines share.  ``phase_gate(offs, offs_p)``:
    whether a phase's buckets with k <= kmax go to the kernel, from the
    whole offset set and the phase's own; the JAX engines also keep the
    kernel to f32 and off under ``GFASORT_DENSE_KERNEL=xla``.
    ``budget_div``: the dispatch budget's divisor (1 in 1D, 2 in nD).
    ``exec_len``: the steps one dispatch element counts per sweep (S; a
    sharded engine's shard length L)."""
    if params.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {params.dtype!r}")
    knobs = SweepKnobs()
    S = pidx.total_steps
    max_jump = max(1, min(int(params.space), pidx.max_path_step_count - 1))
    offs = offset_set(max_jump, per_octave, dense_upto)
    phase_offsets, rotate, consensus_every = phase_structure(
        offs, rotate, consensus_every)

    updates_per_sweep = P * max(1, int(S * active_frac))
    etas = eta_schedule(
        1.0 / params.eta_max, 1.0, params.iter_max,
        params.iter_with_max_learning_rate, params.eps,
    )
    spi = max(1, -(-params.min_term_updates // updates_per_sweep))
    sweep_eta = np.repeat(etas, spi).astype(_DTYPES[params.dtype])
    sweep_cool = np.repeat(
        np.arange(params.iter_max + 1) > params.first_cooling_iteration, spi)
    consensus_every = fit_consensus_period(
        len(sweep_eta), consensus_every, len(phase_offsets))

    zetas = zeta_table(params.space, params.space_max,
                       params.space_quantization_step, params.theta)
    use_kernel = knobs.dense_kernel and params.dtype == "float32"
    phases = tuple(
        _phase_plan(po, params, zetas, use_kernel and phase_gate(offs, po),
                    knobs.kmax, P)
        for po in phase_offsets)
    return SweepPlan(
        proposals=P, active_frac=active_frac,
        per_octave=per_octave, offs=offs, rotate=rotate,
        consensus_every=consensus_every,
        dense_kernel=use_kernel and phase_gate(offs, offs), phases=phases,
        sweep_eta=sweep_eta, sweep_cool=sweep_cool,
        updates_per_sweep=updates_per_sweep,
        n_exec=executed_sweeps(len(sweep_eta), consensus_every,
                               S if exec_len is None else exec_len,
                               knobs.dispatch_elems // budget_div),
        dtype=params.dtype, knobs=knobs, dims=dims,
    )


def _whole_set_gate(offs, offs_p):
    """The 1D engines' ``dense_kernel_enabled`` under the forced kernel:
    at least two offsets <= 8 in the whole offset set, decided once for
    every phase."""
    return int((offs <= 8).sum()) >= 2


def _phase_gate(offs, offs_p):
    """The nD engines' gate: at least two offsets <= 8 in the phase's own
    offset set."""
    return int((offs_p <= 8).sum()) >= 2


def make_sweep_plan(
    pidx: PathIndex,
    params: PathSGDParams,
    per_octave=None,
    consensus_every=None,
    active_frac=None,
    rotate=None,
    dense_upto=None,
    proposals=None,
) -> SweepPlan:
    """Resolve the 1D engine's knobs exactly as ``build_sweep_runner``
    does (None = the shape-aware default of ``auto_sweep_config``)."""
    auto = auto_sweep_config(pidx.total_steps, pidx.num_nodes)
    *knobs, P = _knobs(auto, per_octave, consensus_every, active_frac,
                       rotate, dense_upto, proposals)
    return _build_plan(pidx, params, *knobs, P, 1, _whole_set_gate, 1)


def make_layout_plan(
    pidx: PathIndex,
    params: LayoutSGDParams,
    per_octave=None,
    consensus_every=None,
    active_frac=None,
    rotate=None,
    dense_upto=None,
    proposals=None,
) -> SweepPlan:
    """Resolve the nD layout engine's knobs exactly as
    ``build_sweep_nd_runner`` does: ``auto_sweep_config(layout=True)``,
    the proposal clamp to ``max(1, 4 - D)`` choice words, jumps in steps
    (``params.space``), and the kernel gate decided per phase (at least
    two offsets <= 8 in the phase's own offset set)."""
    D = int(params.dimensions)
    auto = auto_sweep_config(pidx.total_steps, pidx.num_nodes, layout=True)
    *knobs, P = _knobs(auto, per_octave, consensus_every, active_frac,
                       rotate, dense_upto, proposals)
    # the TPU kernel's input-window clamp, kept for parity
    P = min(P, 4 * max(1, 4 - D))
    return _build_plan(pidx, params, *knobs, P, D, _phase_gate, 2)
