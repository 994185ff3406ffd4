"""The sweep engines' host-side policy: the offset set, the rotation
phases, the consensus period and the shape-aware defaults.  A frozen copy
of ``gfasort_tpu_torch/ops/sweep_policy.py``, unchanged but for
``SweepResult``, which nothing here needs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["offset_set", "fit_consensus_period",
           "phase_structure", "LARGE_S", "auto_sweep_config", "auto_rotate"]


def offset_set(space: int, per_octave: int = 4, dense_upto: int = 8) -> np.ndarray:
    """Static log-spaced jump offsets: all of 1..dense_upto, then
    ``per_octave`` per factor-2 up to ``space``."""
    ks = set(range(1, min(dense_upto, space) + 1))
    k = float(dense_upto)
    ratio = 2.0 ** (1.0 / per_octave)
    while k < space:
        k *= ratio
        ks.add(min(int(round(k)), space))
    return np.asarray(sorted(ks), dtype=np.int32)


def fit_consensus_period(n_sweeps: int, ce: int, n_phase: int) -> int:
    """Shrink the consensus period so the EXECUTED schedule overshoots
    the nominal one minimally.  The engines run whole periods with the
    sweep index clamped (the terminal-eta padding convention), so a
    101-sweep CLI schedule at ce=96 would execute 2 x 96 = 192 sweeps
    (+90% device work); fitting ce to ceil(101/2) -> 60 (rounded up to
    whole rotations) executes 120 instead, with the same period count.
    More-frequent consensus has certified fine at every period probed,
    so this only trades padded terminal-eta work for an extra mid-run
    consensus or two."""
    ce = max(int(ce), 1)
    n_periods = -(-n_sweeps // ce)
    ce_fit = -(-n_sweeps // n_periods)
    ce_fit = -(-ce_fit // n_phase) * n_phase
    return min(ce, max(ce_fit, 1))


def phase_structure(offs: np.ndarray, rotate, consensus_every: int):
    """Resolve bucket rotation for an offset set (shared by the 1D, nD
    and sharded sweep engines; was four identical copies).

    Each sweep uses the dense offsets (1..8, most of the warm-phase
    Zipf mass) plus every ``rotate``-th large offset, with the phase
    advancing per sweep.  Sweep cost is proportional to the number of
    offset buckets (one fused pass per bucket), so rotation cuts the
    hot-loop cost ~(K/K_phase)x while the aggregate jump distribution
    over ``rotate`` consecutive sweeps matches the full offset set at
    its native resolution.  The global max offset is kept in every
    phase so the top of the jump space stays reachable.  The consensus
    period is rounded up to whole rotations so every phase runs equally
    often (and the phase of a sweep slot stays static in the engines'
    unrolled rotation blocks).

    Returns (phase_offsets, rotate, consensus_every).
    """
    K = len(offs)
    n_dense = int((offs <= 8).sum())
    if rotate == "auto":
        rotate = auto_rotate(K, n_dense)
    rotate = int(max(1, rotate))
    if rotate > 1 and (K - n_dense) < 2 * rotate:
        rotate = 1  # too few large buckets to be worth striding
    if rotate > 1:
        phase_offsets = [
            np.concatenate([offs[:n_dense], offs[n_dense + p :: rotate]])
            for p in range(rotate)
        ]
        phase_offsets = [
            po_ if po_[-1] == offs[-1] else np.append(po_, offs[-1])
            for po_ in phase_offsets
        ]
        consensus_every = -(-consensus_every // rotate) * rotate
    else:
        phase_offsets = [offs]
    return phase_offsets, rotate, int(consensus_every)

# Workloads with at least this many total steps are in the
# "amortization regime": sweep cost is large enough that consensus
# amortization and coarser jump quantization pay for themselves, and
# every quality certification so far has been flat-to-BETTER with the
# aggressive settings (see auto_sweep_config).  Matches the fused
# kernel's size floor (sweep_dense.dense_kernel_enabled).
LARGE_S = 1 << 18


def auto_sweep_config(S: int, N: int, *, layout: bool = False) -> dict:
    """Shape-aware zero-kwarg engine config (VERDICT r3 task 1).

    The r3 CLI default shipped conservative settings everywhere
    (derived frac ~= N/S, consensus_every=8, per_octave=4), measuring
    ~224M upd/s at the bench shape while the same engine certified
    as-well-or-better at 1,565M with the throughput settings.  The
    policy axes, each backed by a measurement:

    * ``active_frac`` — FULL activation when path redundancy S/N <= 5
      steps/node: at S/N=4 (chromosome/genome shapes) frac=1.0
      certifies BETTER than sparser activation (rank-MAE 3.2e-4 vs
      3.8e-4; layout stress ratio 0.88 vs 1.07 — ROUND3_NOTES).  Above
      that, the r2-validated ~1-update-per-node derivation
      ``clip(N/S, floor, 1)``: on the real DRB1 fixture (S/N=7.1)
      quality degrades MONOTONICALLY with frac (1D rank-MAE 0.88e-3 /
      1.07e-3 / 1.78e-3 at frac 0.141 / 0.286 / 0.565; layout stress
      ratio 1.08 / 1.09 / 1.13 — r4 measurement), because real
      pangenome paths overlap the same nodes heavily and full-width
      rounds average many pulls against one stale snapshot.  Synthetic
      many-path walks (scratch/auto_cfg_probe.py) tolerate any frac;
      real redundancy is what the S/N axis detects.
    * ``consensus_every`` — rarer consensus has certified
      flat-to-better at EVERY period probed on >=100k-step workloads
      (1D: identical certs at ce=48/96; layout: ratio 0.908 at ce=16 ->
      0.898 at ce=48), and the R=1 consensus call (~21 ms) dominates
      sweep cost when amortized too often.  Large regime: 96 (1D) / 48
      (layout); below LARGE_S total steps the engine keeps the
      conservative ce=8 that DRB1-scale fixtures were validated at.
    * ``per_octave`` — 2 in the large regime (the certs above are all
      po=2; halves the bucket count), 4 below it (finer jump grid,
      sweep cost negligible).
    * ``rotate`` — 12 in the large regime (measured fastest AND
      best-certifying period; 16 hits a Mosaic compile bug), else the
      measured auto_rotate default.
    * ``dense_upto`` (r5) — 4 in the large regime: the dense jump grid
      coarsens to {1,2,3,4,6,8} (2 fewer VPU-bound buckets/phase, +8%
      rate, 100k cert unchanged to 3 digits; scratch/r5_bucket_probe).
      Small regime keeps the exact 1..8 grid.
    * ``proposals`` (r5) — 12 (1D) / 8 (layout; the nD runner clamps
      by dimensionality) in the large regime: P independent partner
      draws per step per sweep (packed into ceil(P/4) i32 words)
      share ONE bucket-pass update evaluation (1,950 -> 6,210 M
      upd/s at the bench shape across P=1..12); certs are
      P-INVARIANT (1D iter30 3.57e-4, iter100 2.21e-4 at P=4/8/12
      alike; 2D stress ratio 0.98 at P=8, beats the oracle) and
      validated at the genome calibration shape (ROUND5_NOTES
      matrix).  P=16 (6 kernel input windows) blows Mosaic's
      scoped-VMEM stack.  Small regime keeps P=1 (DRB1-scale
      fixtures were certified there, and sweep cost is negligible
      anyway).
    """
    floor = 0.25 if layout else 1.0 / 16.0
    spn = S / max(N, 1)  # path redundancy: steps per node
    if spn <= 5.0:
        frac = 1.0
    else:
        frac = float(np.clip(N / max(S, 1), floor, 1.0))
    large = S >= LARGE_S
    if layout:
        # small-regime layout keeps the DRB1-validated (rotate=8, ce=8,
        # frac floor 1/4) defaults from r2/r3 (sweep_nd.py tuning note)
        return dict(
            active_frac=frac,
            consensus_every=48 if large else 8,
            per_octave=3,
            rotate=12 if large else 8,
            dense_upto=4 if large else 8,
            # the nD runner clamps by dimensionality (D=3 -> 4)
            proposals=8 if large else 1,
        )
    return dict(
        active_frac=frac,
        consensus_every=96 if large else 8,
        per_octave=2 if large else 4,
        rotate=12 if large else "auto",
        dense_upto=4 if large else 8,
        proposals=12 if large else 1,
    )


def auto_rotate(K: int, n_dense: int) -> int:
    """Default bucket-rotation period: target ~5 large offset buckets
    per sweep phase, capped at 12.

    Retuned from (K-n_dense)/7.5 cap 8: rarer large buckets keep
    certifying equal-or-BETTER against the bit-exact oracle while
    cutting the VPU-bound bucket passes — measured at rotate=12 vs 8
    (scratch/ce_rotate_probe.py, 100k cert workload):
    CLI-default config rank-MAE 1.69e-4 vs 1.78e-4 of N, Spearman
    0.99999971 vs 0.99999968, bench-shape rate +34% (168 -> 224 M/s
    at derived frac / ce=8); bench throughput config rank-MAE 2.76e-4
    vs 3.20e-4, rate +4.4%.  The cap stays at 12 (not 16): rotate=16
    phase bucket sets hit a Mosaic compile bug in the fused kernel's
    sublane-concat shifted views ("result/input offset mismatch on
    non-concat dimension")."""
    return int(np.clip(round((K - n_dense) / 5.0), 1, 12))
