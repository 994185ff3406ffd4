#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (they run in the order 1-4, 24-26, 28, 27, 5, 19, 6-8, 13's CLI run,
20-21, 9, 11-12, 29, 15-18, 22, 13-14, 10, 23); any failed check raises and
the script exits non-zero.  Every phase line carries ``t_s``, the
script's seconds so far:

1. build      — compile the hand-written CUDA kernels from ``csrc/``, one
                ``nvcc`` per source, all at once (timed).
2. kernel     — the 1D bucket-apply kernel against its plain PyTorch
                version on the card, at S = 4M steps with the bench-shape
                plan's phase-0 and phase-1 bucket lists, P = 12 (3 packed
                words) and P = 1: csum and dsum bit-identical; both timed.
3. kernel_nd  — the nD bucket-apply kernel against its plain version at
                S = 4M with the bench-shape layout plans' phase-0 and
                phase-1 kernel bucket lists: D = 2 with P = 8 (2 words),
                D = 3 with P = 4 (1 word), D = 3 with P = 8 (2 words, the
                sharded layout's unclamped case) and D = 2 with P = 1:
                wacc and acc bit-identical; both timed.
4. sweep_apply — the fused sweep apply (all buckets of an offset set in
                one pass, rank/cnt guards, the combine) on the bench
                index at S = 4M with its real rank and cnt, over the full
                offset sets of the bench plan's phases 0 and 1, each at
                the first and the last sweep's eta, P = 1: one launch
                per case counted, each bit-identical to its plain
                version; kernel, plain version and the port's split
                apply of the same offsets (bucket kernel + roll passes +
                combine) timed.
5. shift_probe — both shift-sum kernels (warp shuffles, a tile staged
                in shared memory) bit-identical to their plain version,
                on the probe's input and on every edge case of
                ``dense_probe.edge_cases`` (every halo, views 0-3
                elements past a 16-byte boundary, S = 0-3 mod 4, -0.0,
                +-inf and NaN; NaN compared bit for bit), conv1d within
                atol 1e-4, all timed (``tools/dense_probe.run``) at
                S = 4M and at S = 64M, past the 50 MB L2: back to back
                through the wrapper (``ms``) and on the device alone
                (``device_ms``, L2 cold; ``device_warm_ms``).
6. main       — write the bench-shape GFA (1M nodes, 16 paths x 250k
                steps) and run ``python -m gfasort_tpu_torch -p sYgs``
                (engine auto -> the sweep engine, N > 200k) through
                ``cli.main``; the sampler, bucket and roll kernels must
                each launch once per executed sweep, and
                every path hash, the node and the edge count must be
                preserved.  A direct engine run on the same graph checks
                that the positions are finite.
7. layout     — ``-p L --dimensions 2`` on the same GFA through
                ``cli.main`` (the nD sweep engine): the sampler, nD
                bucket and nD roll kernels launch once per executed
                sweep, the TSV holds finite coordinates
                for both ends of every node, the path hashes and the node
                and edge counts are unchanged.
8. layout_parts — the same 2D layout taken apart: the host set-up (path
                index, initial coordinates, plan, consensus tables,
                upload, each on the host clock) and one rotation of sweeps
                with CUDA events around the sampler kernel (with the
                chosen ends' rows), the nD bucket kernel and the roll
                kernel with the combine, and one consensus run.
9. quality    — the port's 1D sweep against the sequential oracle on the
                100k-node certificate workload: rank-MAE/N <= 2e-3 and
                Spearman >= 0.999.
10. quality_nd — the port's layout against the C++ oracle on the 20k-node
                layout certificate, 2D and 3D, and 2D at f64, with the
                bench's nD knobs: stress ratio <= 1.5.
11. sweep_f64 — the 1D sweep at float64 (threefry draws in the sampler
                kernel, every bucket in the f64 roll kernel: the plan's
                kernel buckets must be 0), timed on the bench index at
                full width, at SWEEP_MODE_ITER = 30 iterations (cut from
                the bench's 100) and at the plan's full depth (101 sweeps):
                the sampler and roll kernels launch once per executed
                sweep, the bucket kernel never, and the plain sampler and
                roll passes are never called (each wrapped with a call
                counter); its order certified on the 100k-node workload
                against the same oracle as ``quality``.
12. sweep_threefry — the same at float32 with ``GFASORT_SWEEP_RNG=
                threefry``: the sampler (threefry kernel), bucket and
                roll kernels each launch once per executed sweep, the
                plain versions never; the certificate as above.
13. batched   — the batched engine: ``-p Y --engine batched
                --iter-max 30`` (BATCHED_CLI_ITER, cut from the CLI's 100)
                on the bench GFA through ``cli.main`` (hashes and counts kept,
                rounds/s and pair-updates/s from the trace); its order
                certified on the 100k-node workload at f64 and f32
                (``pow_mode="fpp"``), the f64 run repeated and compared
                with ``torch.equal``; the 2D batched layout on the
                20k-node workload against the C++ oracle (stress ratio
                <= 1.5).
14. checkpoint — the checkpointed 1D batched run on the 100k-node
                workload, stopped after two segments and resumed, equal
                to the single-shot run; a checkpoint of another seed is
                refused.
15. sharded_sweep — the sharded 1D sweep (``parallel/sweep_shard.py``),
                at SWEEP_MODE_ITER = 30 iterations on the bench GFA and
                index: ``-p Y --engine sweep-sharded`` on the bench GFA through
                ``cli.main`` (a one-shard mesh of the card), a direct
                call on 4 shards of the card (L = 1M), each with its
                seconds, pair-updates/s, ce, executed sweeps and bucket
                kernel launches (one per shard and sweep); the
                single-card engine and a one-shard sharded call on the
                bench index timed in turns; the order on
                the 100k-node workload at 1 and 4 shards certified as in
                ``quality``.
16. sharded_layout — ``-p L --dimensions 2 --engine sweep-sharded`` on
                the bench GFA (nD kernel launches one per executed
                sweep), and the sharded layout on 4 shards of the card
                against the C++ oracle on the 20k-node workload with the
                bench's nD knobs, 2D and 3D (P = 8, unclamped): stress
                ratio <= 1.5.
17. sharded_batched — ``-p Y --engine sharded --iter-max 30`` on the
                bench GFA through
                ``cli.main`` (seconds, rounds/s), and the sharded batched
                engine's certificate (f32, ``pow_mode="fpp"``) at 1 and 4
                shards.
18. distributed — a one-rank NCCL process group started by
                ``init_distributed`` from the ``GFASORT_*`` variables on a
                free local port; the sharded sweep on the 100k-node
                workload through it equals the run with no group bit for
                bit.
19. entry     — ``gfasort_tpu_torch.entry``: ``entry("cuda")``'s batched
                SGD round on the card within rtol 1e-5 / atol 1e-4 of the
                same round on the CPU, and ``dryrun_multichip`` (sharded
                batched, sharded sweep, sharded 2D layout) on 4 shards of
                the card, all finite.
20. server    — ``-p Y --engine sweep --iter-max 30`` on the bench GFA
                twice through ``--server`` from fresh client processes
                (``tools/e2e_server_warm.py``: the first spawns the daemon
                on a temporary socket, the second is served warm, the
                daemon is stopped): one daemon pid, byte-identical
                outputs, both equal to the same job run in-process through
                ``cli.main`` (its bucket-kernel launches counted); each
                run's client wall, served wall and ``SGD`` step; in a
                fresh process, the torch import, the CUDA context and the
                kernel library's load, then the ``Y`` step taken apart
                twice on the host clock (path index, runner build and
                cache hit, state, run, order, renumbering) with the device
                bytes the cached runner keeps.
21. e2e       — ``sYgsuL`` as ``tools/e2e_chromosome.py`` runs it (iter 30,
                layout iter 10, 2D, the sweep engine) in-process on the
                bench GFA: path hashes kept, the node count not grown
                (unchop merges nodes), both bucket kernels launched, the
                TSV finite; each step's seconds from the trace.
22. scaling   — ``tools/bench_scaling.py`` on 1, 2 and 4 shards of the
                card at its strong-scaling workload (the bench index), one
                row per mesh size.  The shards share one card: this runs
                the code, it does not measure scaling.
23. bench     — ``ops.sweep.build_applied_counter`` (through
                ``bench_util.measure_applied_frac``, 24 rounds) on the card
                and on the CPU at the 100k-node certificate shape: the
                same integers; then the bench twin
                (``python -m gfasort_tpu_torch.tools.bench``) in a
                subprocess at BENCH_ENV (24 rounds, cut from 96), its
                kernel counters from 0: every stdout line parses, the last
                is complete with every certificate passing, a positive
                headline and a roofline, and both bucket kernels, the
                sampler and both roll kernels launched; the headline,
                vs_baseline, the applied fraction and the roofline
                fractions printed.
24. sampler   — the per-sweep sampler kernel (``csrc/sweep_sampler.cu``)
                against its plain version ``sample_words_ref`` on the
                card, on the bench index (S = 4M, its real rank and cnt)
                in every case of ``bench_util.sampler_cases``: the bench
                plans' phases 0 and 1 at the 1D plan's P (12), the 2D
                layout plan's (8) and the 3D one's (4), the last two with
                the end coin, and P = 1; warm and cooling, active
                fraction 1.0 and 0.6, snap stoch and down (64 cases);
                then the edges, warm and cooling with both snaps: P = 5
                with the coin, a 64-offset table and phase 0's offsets
                cut to their first half (z past the last offset: 12
                cases); all 76 again on the threefry f32 route and on the
                f64 route (the threefry kernel).  Every word
                ``torch.equal`` (else the differing
                choices and the worst bucket distance are raised); each
                plan's and edge's main case timed beside the plain
                version and the bound, with the registers and spills of
                the kernel it ran.
25. roll      — both roll-and-combine kernels (``csrc/roll_apply.cu``)
                against ``roll_apply_ref`` / ``roll_apply_nd_ref`` on the
                bench index, plan phases 0 and 1 with the sampler's words
                and the bucket kernels' sums, phase 0 with every bucket a
                roll bucket, the 1D, 2D and 3D edge (P = 5 words, buckets
                k > S / 2 at ki = 0, k > S, k > 2S) and 3D phase 1 at
                P = 8 (the sharded 3D layout's two words): 1D, 2D and
                3D; then the f64 route's 1D, 2D and 3D cases (every
                bucket a roll bucket: plan phases 0 and 1 and the P = 5
                edge with the far buckets, and phase 0 with its farthest
                bucket fifth: short buckets after a long one);
                ``torch.equal``; each timed beside the plain version and
                the bound, with the registers and spills.
26. whole_sweep — one consensus period of the 1D engine (the bench plan)
                and of the 2D engine (the layout plan) on the bench
                index: ``sweep_once`` / ``nd_sweep_once`` with the kernels
                against the same sweeps composed from the plain sampler
                and roll passes, then the consensus: ``torch.equal``;
                the device launches and device ms of one sweep of each
                (``torch.profiler``).
27. sweep_parts — one rotation of 1D sweeps on the bench index taken
                apart with CUDA events (the sampler, bucket and roll
                kernels), the whole sweep, the plain composition and the
                consensus; on the hash route, the threefry f32 route and
                the f64 route (its own plan: no bucket kernel).
28. whole_sweep_f64 — one consensus period of the 1D f64 engine and of
                the 2D f64 engine (the f64 plans) on the bench index,
                the kernels against the plain sweeps as in
                ``whole_sweep``, ``torch.equal``, with the kernels'
                launches in the period.
29. layout_f64 — the 2D layout engine at f64, a direct call on the bench
                index at ``layout``'s depth (iter 30): the sampler and the
                f64 nD roll kernel launch once per executed sweep, the nD
                bucket kernel never, the plain sampler and roll passes
                never (counted); the coordinates finite.

Every bound (``bound_ms``) is the largest of five times: the bytes over
the HBM rate, the f32 operations over the f32 peak, the f64 operations
over the f64 peak (34e12/s; the f64 routes), the int32 operations over
the int32 rate and the conversions and transcendentals over theirs,
the last two at the maximum SM clock the card reports (the ``clock``
line; the published 1,980 MHz unless it reports another); ``bound_pipe``
names the one that binds.  Then the ``nvidia-smi`` card line, one JSON
line describing every kernel, and ``{"ok": true, "device": {...}}`` as
the last line.  Exits non-zero
with no result when CUDA is not available.  Neither JAX nor the JAX
package ``gfasort_tpu`` is imported.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from gfasort_tpu_torch.bench_util import (BENCH_SHAPE, CVT_OPS_PER_CLOCK,
                                          F32_OPS_S, F64_OPS_S, HBM_BYTES_S,
                                          INT32_OPS_PER_CLOCK,
                                          MAX_SM_CLOCK_MHZ,
                                          bench_layout_coords,
                                          contract_choices, cuda_ms)

CERT = dict(n_nodes=100_000, n_paths=4, steps_per_path=100_000, seed=7,
            iter_max=30)
CERT_SMALL = dict(n_nodes=5_000, n_paths=4, steps_per_path=5_000, seed=7,
                  iter_max=30)
RANK_MAE_MAX = 2e-3
SPEARMAN_MIN = 0.999
STRESS_RATIO_MAX = 1.5
# shift-sum probe sizes: multiples of the TPU probes' 64k block; the
# larger one exceeds the card's 50 MB L2 cache
SHIFT_SIZES = (1 << 22, 1 << 26)
# the bench's nD knobs (ce 48, rotate 12, frac 1.0, dense_upto 4, P 8)
ND_CERT_KW = dict(consensus_every=48, rotate=12, active_frac=1.0,
                  dense_upto=4, proposals=8)
# iterations of the f64 and threefry sweeps and of the sharded sweep's
# runs on the bench index and GFA (cut from the bench's 100 to keep the
# script's time)
SWEEP_MODE_ITER = 30
# the batched engines' CLI runs on the bench GFA (cut from the CLI
# default of 100 to keep the script's time) and the checkpoint phase's
# segment
BATCHED_CLI_ITER = 30
CKPT_SEGMENT = 1000
# entry()'s round on the card against the CPU's: the sampler's f32
# exp / log may differ between the two in the last place
ENTRY_RTOL, ENTRY_ATOL = 1e-5, 1e-4
# the served job's, and the e2e pipeline's, iterations (as
# tools/e2e_server_warm.py and tools/e2e_chromosome.py run them)
SERVER_ITER = 30
E2E_ITER, E2E_LAYOUT_ITER = 30, 10
# timed runs per mesh size in the scaling phase
SCALING_REPS = 1
# the bench twin's protocol in the bench phase, cut through bench.py's
# own knobs to keep the script's time (24 rounds instead of 96; the
# certificate shapes at their defaults)
BENCH_ENV = dict(BENCH_ROUNDS="24")
BENCH_TIMEOUT_S = 420


# the SM clock of the int32 and conversion rates: the published maximum,
# or the maximum the card reports where it reports another (main sets it)
CLOCK_MHZ = MAX_SM_CLOCK_MHZ


def bound_ms(S: int, words_in, words_out, f32=0, int32=0, cvt=0, f64=0):
    """The least time the card could take: the largest of five times,
    the bytes (each input word read once, each output word written once;
    a word is 4 bytes) over the HBM rate, the f32 operations over the f32
    peak, the f64 operations over the f64 peak, the int32 operations over
    the int32 rate and the conversions, transcendentals and population
    counts over theirs (both at ``CLOCK_MHZ``).  ``f32``, ``int32``,
    ``cvt`` and ``f64`` count per step.  Returns (ms, "bytes" or
    "operations", the one that binds: "hbm", "f32", "f64", "int32" or
    "cvt")."""
    hz = CLOCK_MHZ * 1e6
    times = {"hbm": 4.0 * S * (words_in + words_out) / HBM_BYTES_S,
             "f32": float(S) * f32 / F32_OPS_S,
             "f64": float(S) * f64 / F64_OPS_S,
             "int32": float(S) * int32 / (INT32_OPS_PER_CLOCK * hz),
             "cvt": float(S) * cvt / (CVT_OPS_PER_CLOCK * hz)}
    pipe = max(times, key=times.get)
    return times[pipe] * 1e3, "bytes" if pipe == "hbm" else "operations", pipe


def bound_fields(S: int, words_in, words_out, ops) -> dict:
    """A phase line's bound keys for ``ops`` = (f32, int32, cvt) or (f32,
    int32, cvt, f64) per step:
    ``bound_ms``, ``bound_by``, ``bound_pipe``, the clock it assumed and,
    where the card reports another maximum clock than the published
    one, a note saying so."""
    ms, by, pipe = bound_ms(S, words_in, words_out, *ops)
    rec = dict(bound_ms=ms, bound_by=by, bound_pipe=pipe,
               bound_clock_mhz=CLOCK_MHZ)
    if CLOCK_MHZ != MAX_SM_CLOCK_MHZ:
        rec["bound_clock_note"] = (
            f"the card reports a maximum SM clock of {CLOCK_MHZ} MHz, not "
            f"the published {MAX_SM_CLOCK_MHZ}: the int32 and conversion "
            f"rates use the card's")
    return rec


def n_words(P: int) -> int:
    return 1 if P == 1 else -(-P // 4)


def match_ops(P: int) -> tuple:
    """(int32, cvt) of one pair's weight, its field match counted per
    4-byte word: per word the XOR with the broadcast byte of ki (or ~ki),
    the carry-free zero-byte test (and, add, or-not-and), the same for
    the partner's word, the guard's AND, the shift into distinct bits and
    the OR into the mask (11); then a popcount and the count's conversion
    to f32 (cvt 2).  P = 1: two compares and the guarded OR (3), the
    weight a select.  Both plus the partner's index and its guard (3)."""
    if P == 1:
        return 3 + 3, 0
    return 11 * n_words(P) + 3, 2


# The pair counts below take each pair (t, t + k) once per bucket and
# step: its weight and its update are the same for both ends (the update
# negated), so the least work evaluates it once and adds it at both ends.


def ops_1d(P: int, n_buckets: int) -> tuple:
    """(f32, int32, cvt) per step of the 1D spec, per bucket: the pair
    once (f32 |pos - pos_o|, eta / safe, min, xs - xs_o, mu * (|dx| -
    safe) * half_sgn (3), w * r: 8; the weight's field match,
    ``match_ops``; the divide's reciprocal, cvt 1), then at each end dsum
    += and csum += (f32 4)."""
    m_int, m_cvt = match_ops(P)
    return n_buckets * 12, n_buckets * m_int, n_buckets * (m_cvt + 1)


def ops_nd(D: int, P: int, n_buckets: int) -> tuple:
    """(f32, int32, cvt) per step of the nD spec, per bucket: the pair
    once (f32 |pos - pos_o|, eta / safe, min, D deltas, mag^2 (2D - 1),
    sqrt, 1 / sqrt, mag, r (sub, 3 muls, min), w * r, wr * delta (D):
    4D + 11; the field match, ``match_ops``; eta / safe's and 1 / sqrt's
    reciprocals and the square root, cvt 3), then at each end acc +=
    (D) and wacc += (f32 2D + 2)."""
    m_int, m_cvt = match_ops(P)
    return n_buckets * (6 * D + 13), n_buckets * m_int, n_buckets * (m_cvt + 3)


def as_f64(ops, P: int, n_buckets: int) -> tuple:
    """``ops_1d`` / ``ops_nd`` (plus the combine) of the f64 route: every
    f32 operation, the divides' reciprocals and the square roots become
    f64 operations (each counted once, a lower bound: the IEEE double
    divide and square root are longer sequences); the field match's
    popcounts and conversions stay.  Returns (f32, int32, cvt, f64)."""
    f32, i32, cvt = ops
    m_cvt = match_ops(P)[1] * n_buckets
    return 0, i32, m_cvt, f32 + cvt - m_cvt


def ops_fused(K: int) -> tuple:
    """(f32, int32, cvt) per padded step of the fused spec (P = 1), per
    bucket: the pair once (f32 |pos - pos_o|, eta / safe, min, xs - xs_o,
    mag - safe, mu * (.), / 2, / mag, * dx, -w * r: 10; int32 the raw
    choices' two compares and guarded OR and the rank / cnt guards, add,
    two compares and an and: 7; cvt the two divides' reciprocals), then
    at each end the update's and the weight's sums (f32 4); per step
    max, divide and add (f32 3, cvt 1)."""
    return 14 * K + 3, 7 * K, 2 * K + 1


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock in MHz, as ``nvidia-smi`` reports it
    (``clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


_T0 = time.perf_counter()


def say(phase: str, card_line: str | None = None, **nums) -> None:
    """One JSON line per result, with the script's seconds so far."""
    rec = {"phase": phase, **nums,
           "t_s": round(time.perf_counter() - _T0, 1)}
    if card_line is not None:
        rec["card"] = card_line
    print(json.dumps(rec), flush=True)


def phase_kernel(plan, pidx, card_line):
    from gfasort_tpu_torch.ops.sweep_dense import bucket_apply, bucket_apply_ref

    dev = torch.device("cuda")
    S = pidx.total_steps
    rng = np.random.default_rng(0)
    xs = torch.from_numpy((rng.standard_normal(S) * 100).astype(np.float32)).to(dev)
    pos = torch.from_numpy(pidx.step_pos.astype(np.float32)).to(dev)
    eta = float(plan.sweep_eta[0])
    results = {}
    for ph_i in (0, 1):
        buckets = plan.phases[ph_i].kernel_buckets
        for P in (12, 1):
            words = [w.to(dev) for w in contract_choices(rng, S, buckets, P)]
            d_k, c_k = bucket_apply(xs, pos, words, eta, buckets, P)
            d_r, c_r = bucket_apply_ref(xs, pos, words, eta, buckets, P)
            torch.cuda.synchronize()
            if not torch.equal(c_k, c_r):
                raise AssertionError(f"csum differs (phase {ph_i}, P={P})")
            err = (d_k - d_r).abs()
            # the kernel follows the spec's f32 ops in order: bit for bit
            if not torch.equal(d_k, d_r):
                raise AssertionError(
                    f"dsum off by {float(err.max())} (phase {ph_i}, P={P})")
            ms = cuda_ms(lambda: bucket_apply(xs, pos, words, eta, buckets, P))
            plain_ms = cuda_ms(
                lambda: bucket_apply_ref(xs, pos, words, eta, buckets, P), 5)
            rec = dict(S=S, P=P, buckets=[list(b) for b in buckets],
                       max_abs_err=float(err.max()),
                       bit_identical=bool(torch.equal(d_k, d_r)),
                       ms=ms, plain_ms=plain_ms,
                       **bound_fields(S, 2 + n_words(P), 2,
                                      ops_1d(P, len(buckets))))
            results[(ph_i, P)] = rec
            say("kernel", card_line, phase_of_plan=ph_i, **rec)
    return results


def phase_kernel_nd(plans, S, pos_np, card_line):
    """``plans``: {D: bench-shape layout plan}."""
    from gfasort_tpu_torch.ops.sweep_dense import (dense_apply_nd,
                                                   dense_apply_nd_ref)

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(pos_np).to(dev)
    results = {}
    for D, P in ((2, 8), (3, 4), (3, 8), (2, 1)):
        plan = plans[D]
        my_c = torch.from_numpy(bench_layout_coords(rng, pos_np, D)).to(dev)
        eta = float(plan.sweep_eta[0])
        for ph_i in (0, 1):
            buckets = plan.phases[ph_i].kernel_buckets
            words = [w.to(dev) for w in contract_choices(rng, S, buckets, P)]
            a_k, w_k = dense_apply_nd(pos, words, my_c, eta, buckets, P)
            a_r, w_r = dense_apply_nd_ref(pos, words, my_c, eta, buckets, P)
            torch.cuda.synchronize()
            if not torch.equal(w_k, w_r):
                raise AssertionError(f"wacc differs (D={D}, P={P}, phase {ph_i})")
            err = (a_k - a_r).abs()
            if not torch.equal(a_k, a_r):
                raise AssertionError(f"acc off by {float(err.max())} "
                                     f"(D={D}, P={P}, phase {ph_i})")
            ms = cuda_ms(lambda: dense_apply_nd(pos, words, my_c, eta,
                                                buckets, P))
            plain_ms = cuda_ms(lambda: dense_apply_nd_ref(
                pos, words, my_c, eta, buckets, P), 3)
            rec = dict(S=S, D=D, P=P, buckets=[list(b) for b in buckets],
                       max_abs_err=float(err.max()),
                       bit_identical=bool(torch.equal(a_k, a_r)),
                       ms=ms, plain_ms=plain_ms,
                       **bound_fields(S, 1 + n_words(P) + D, D + 1,
                                      ops_nd(D, P, len(buckets))))
            results[(D, P, ph_i)] = rec
            say("kernel_nd", card_line, phase_of_plan=ph_i, **rec)
            del words, a_k, w_k, a_r, w_r, err
        del my_c
    torch.cuda.empty_cache()
    return results


def reset_launches() -> None:
    from gfasort_tpu_torch.ops import (roll_apply, shift_sum, sweep_common,
                                       sweep_dense, sweep_fused)

    sweep_dense.bucket_apply.launches = 0
    sweep_dense.dense_apply_nd.launches = 0
    sweep_fused.sweep_apply.launches = 0
    sweep_common.sample_words.launches = 0
    roll_apply.roll_apply.launches = 0
    roll_apply.roll_apply_nd.launches = 0
    for v in shift_sum.VARIANTS:
        shift_sum.shift_sum.launches[v] = 0


def read_launches() -> dict:
    from gfasort_tpu_torch.ops import (roll_apply, shift_sum, sweep_common,
                                       sweep_dense, sweep_fused)

    return {"bucket_apply": sweep_dense.bucket_apply.launches,
            "dense_apply_nd": sweep_dense.dense_apply_nd.launches,
            "sweep_apply": sweep_fused.sweep_apply.launches,
            "sweep_sampler": sweep_common.sample_words.launches,
            "roll_apply": roll_apply.roll_apply.launches,
            "roll_apply_nd": roll_apply.roll_apply_nd.launches,
            **{f"shift_sum_{v}": n
               for v, n in shift_sum.shift_sum.launches.items()}}


def phase_sweep_apply(plan, pidx, card_line):
    """The fused apply over the full offset sets of plan phases 0 and 1
    (P = 1, the index's real rank and cnt), each at the first and the
    last sweep's eta: one launch per case counted, each equal to its
    plain version bit for bit, then timed beside the plain version and
    the port's split apply of the same offsets."""
    from gfasort_tpu_torch.bench_util import fused_cases
    from gfasort_tpu_torch.ops.sweep import apply_choices
    from gfasort_tpu_torch.ops.sweep_fused import sweep_apply, sweep_apply_ref

    cases = fused_cases(pidx, plan, torch.device("cuda"))

    def run(c):
        return sweep_apply(*c["args"], c["eta"], c["offs"], c["layout"]["H"])

    # the kernel's own path: one fused apply per case
    reset_launches()
    outs = [run(c) for c in cases]
    torch.cuda.synchronize()
    launches = read_launches()["sweep_apply"]
    if launches != len(cases):
        raise AssertionError(f"{launches} fused apply launches, expected "
                             f"{len(cases)}")

    results = {}
    for c, out in zip(cases, outs):
        lay, offs, eta = c["layout"], c["offs"], c["eta"]
        where = f"phase {c['phase_of_plan']}, {c['eta_of']} eta"
        flat = [a.reshape(-1) for a in c["args"]]
        ref = sweep_apply_ref(*flat, eta, offs, lay["H"])
        torch.cuda.synchronize()
        if out.shape != (lay["S_pad"],) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"fused apply output not finite [S_pad] "
                                 f"({where})")
        err = (out - ref).abs()
        # the kernel follows the spec's f32 ops in order: bit for bit
        if not torch.equal(out, ref):
            raise AssertionError(f"fused apply off by {float(err.max())} "
                                 f"({where})")
        ms = cuda_ms(lambda: run(c))
        plain_ms = cuda_ms(lambda: sweep_apply_ref(*flat, eta, offs,
                                                   lay["H"]), 3)
        split_ms = cuda_ms(lambda: apply_choices(c["xs"], c["pos"], [c["sidx"]],
                                                 c["phase"], eta, 1))
        S_pad, L = lay["S_pad"], lay["L"]
        # each input read once (xs, pos, sidx padded to L; rank, cnt),
        # the output written once
        rec = dict(S=lay["S"], S_pad=S_pad, H=lay["H"], K=len(offs),
                   offs=list(offs), eta_of=c["eta_of"], eta=eta,
                   kernel_buckets=len(c["phase"].kernel_buckets),
                   roll_buckets=len(c["phase"].roll_buckets),
                   max_abs_err=float(err.max()), bit_identical=True,
                   ms=ms, plain_ms=plain_ms,
                   **bound_fields(S_pad, (3 * L + 2 * S_pad) / S_pad, 1,
                                  ops_fused(len(offs))),
                   split_ms=split_ms)
        results[(c["phase_of_plan"], c["eta_of"])] = rec
        say("sweep_apply", card_line, phase_of_plan=c["phase_of_plan"], **rec)
        del ref, err
    del cases, outs
    torch.cuda.empty_cache()
    return results, launches


def phase_shift_probe(card_line):
    """Both shift-sum kernels checked (the probe's input and its edge
    cases) and timed by the probe tool at each of ``SHIFT_SIZES``; the
    launches are those of the first size's checked calls.  Each
    variant's share of the bound is taken from its device-only time."""
    from gfasort_tpu_torch.tools import dense_probe

    results = {}
    for S in SHIFT_SIZES:
        reset_launches()
        res = dense_probe.run(S, "cuda", edges=True)
        res.update(bound_fields(S, 1, 1, (2 * res["halo"], 0, 0)))
        for r in res["variants"].values():
            r["device_share"] = res["bound_ms"] / r["device_ms"]
        if any(n < 1 for n in res["launches"].values()):
            raise AssertionError(f"a shift-sum kernel never launched: "
                                 f"{res['launches']}")
        results[S] = res
        say("shift_probe", card_line, **res)
        torch.cuda.empty_cache()
    return results


def ops_sampler(P: int, K: int, coin: bool, frac: float,
                route: str = "hash") -> tuple:
    """(f32, int32, cvt, f64) per step of the sampler, d = ceil(log2(K + 1))
    the compares of one search of the offsets.  Per proposal: int32 the
    hash (three murmur mixes of nine ops, the counter's add, the two
    XORs and u's shift: 31), the coins and flags (bit 31; bit 30 and its
    mask; backward, forward, use_zipf; u2's field: 9), the draws (min(z,
    js), the uniform draw's + 1, the select: 3), the snap (max(z, 1), d
    compares, the promotion's compare, and, add and select: 5 + d), the
    activity (off_sel <= avail, direction, has_path, and: 4; the coin's
    mask and compare where the fraction is below 1: 2) and the packing
    (the sign's select, the field or INACTIVE8, shift, or: 4; P = 1 the
    select: 1); f32 u's scale, the Zipf draw (u * zeta, eta_z * u - eta_z
    + 1, the clamp, alpha *, n *, 1 +, the NaN test, two clamps, two
    compares: 13), the uniform draw's product and the stochastic snap
    (u2's scale, z - lo, the divide, the compare: 4): 19; cvt u's, u2's
    and z's conversions, the two truncations, logf, expf and the divide's
    reciprocal (8).  Per step: int32 the two chains' searches (2d),
    avail_f (2), their clamps to the space and to 1 (4) and the step's
    flags (4), the end coin's shift and mask (2); cvt n and max(avail, 1)
    as f32 for both chains (4).
    ``route`` "threefry" (threefry draws at f32) replaces the hash's 31
    int32 ops by two threefry2x32 calls (20 rounds of add, rotate and xor:
    60; the key injections' 15 adds and the counter's add: 76 each), the
    bits' xor and u's xor, shift and or (156), and needs no conversion
    for u (cvt 7).  ``route`` "f64" adds u's 64-bit assembly (4 int32),
    moves the 19 float operations to f64 and counts log, exp and the
    divide as f64 operations, once each (a lower bound: each is a
    sequence of double operations), leaving cvt the conversions of u2
    and z and the two truncations (4)."""
    d = max(1, (K).bit_length())   # ceil(log2(K + 1))
    draw = {"hash": 31, "threefry": 156, "f64": 160}[route]
    per_p = draw + 9 + 3 + 5 + d + 4 + (2 if frac < 1.0 else 0) + (
        1 if P == 1 else 4)
    int32 = P * per_p + 2 * d + 10 + (2 if coin else 0)
    if route == "f64":
        return 0, int32, 4 * P + 4, 22 * P
    return 19 * P, int32, (8 if route == "hash" else 7) * P + 4, 0


def field_distance(words_a, words_b, P: int):
    """(differing choices, the largest bucket distance among them) of
    two word lists, for a report that never loosens the comparison."""
    from gfasort_tpu_torch.ops.sweep_common import INACTIVE8, unpack_choice

    def fields(words):
        return ([words[0]] if P == 1 else
                [unpack_choice(words[p // 4], p % 4) for p in range(P)])

    n, worst = 0, 0
    for a, b in zip(fields(words_a), fields(words_b)):
        d = a != b
        n += int(d.sum())
        if d.any():
            ai, bi = a[d].long(), b[d].long()
            inactive = (ai == int(INACTIVE8)) | (bi == int(INACTIVE8)) | (
                ai == 0x7FFFFFF) | (bi == 0x7FFFFFF) | ((ai < 0) != (bi < 0))
            ki_a = torch.where(ai < 0, ~ai, ai)
            ki_b = torch.where(bi < 0, ~bi, bi)
            dist = torch.where(inactive, 1 << 20, (ki_a - ki_b).abs())
            worst = max(worst, int(dist.max()))
    return n, worst


def ptxas_row(ptxas, name: str) -> dict:
    """registers and spill_bytes of the compiled kernel ``name`` (a
    demangled name's prefix, template arguments included) in the build's
    ptxas report."""
    for row in ptxas:
        if name in row["kernel"]:
            return {"kernel": name, "registers": row.get("registers"),
                    "spill_bytes": row.get("spill_bytes")}
    return {"kernel": name, "registers": None, "spill_bytes": None}


def phase_sampler(bench, plans, card_line, ptxas):
    """The sampler kernel against its plain version on the card, on the
    bench index (its real rank and cnt), in every case of
    ``bench_util.sampler_cases`` (the 1D, 2D and 3D plans' P and P = 1 on
    plan phases 0 and 1, every cooling state, activity fraction and
    snap, the nD cases with their end coin; the edges P = 5, a 64-offset
    table and a cut table past whose last offset z lies), on the hash
    route and on the threefry routes (threefry draws at f32, and f64;
    the names suffixed "_threefry" and "_f64"): ``torch.equal``, else
    the count of differing choices and the worst bucket distance are
    raised.  Each case name's main case (its first phase, warm, fraction
    1, stochastic snap) is timed beside the plain version and the bound,
    with the registers and spills of the kernel it ran."""
    from gfasort_tpu_torch.bench_util import sampler_cases
    from gfasort_tpu_torch.ops.sweep_common import (sample_words,
                                                    sample_words_ref)

    dev = torch.device("cuda")
    S = bench.total_steps
    results, checked = {}, {}
    for c in sampler_cases(bench, plans, dev):
        name, P, coin, args = c["name"], c["P"], c["coin"], c["args"]
        w_k, c_k = sample_words(*args, coin=coin)
        w_r, c_r = sample_words_ref(*args, coin=coin)
        torch.cuda.synchronize()
        where = (f"{name}, phase {c['phase_of_plan']}, cooling "
                 f"{c['cooling']}, frac {c['frac']}, snap {c['snap']}")
        if not all(torch.equal(a, b) for a, b in zip(w_k, w_r)):
            n, worst = field_distance(w_k, w_r, P)
            raise AssertionError(f"sampler words differ ({where}): {n} "
                                 f"choices, worst bucket distance {worst}")
        if coin and not torch.equal(c_k, c_r):
            raise AssertionError(f"end coin differs ({where})")
        checked[name] = checked.get(name, 0) + 1
        del w_k, w_r, c_k, c_r
        if c["main"]:
            ms = cuda_ms(lambda: sample_words(*args, coin=coin))
            plain_ms = cuda_ms(lambda: sample_words_ref(*args, coin=coin), 3)
            K, route = c["K"], c["route"]
            depth = 4 if K < 16 else 7
            kname = (f"sweep_sampler_kernel<(int){P}, (int){depth}>"
                     if route == "hash" else
                     f"sweep_sampler_tf_kernel<"
                     f"{'double' if route == 'f64' else 'float'}, "
                     f"(int){depth}>")
            # rank and cnt in, the words (and the coin's byte) out
            rec = dict(S=S, P=P, K=K, route=route, end_coin=coin,
                       max_abs_err=0.0, bit_identical=True, ms=ms,
                       plain_ms=plain_ms,
                       **bound_fields(S, 2, n_words(P) + (0.25 if coin else 0),
                                      ops_sampler(P, K, coin, c["frac"],
                                                  route)),
                       **ptxas_row(ptxas, kname))
            results[name] = rec
    for name, rec in results.items():
        rec["cases_checked"] = checked[name]
        say("sampler", card_line, plan=name, **rec)
    torch.cuda.empty_cache()
    return results


def phase_roll(bench, plans, card_line, ptxas):
    """Both roll kernels against their plain versions on the card, in
    every case of ``bench_util.roll_cases`` (the bench index with the
    sampler's words and the bucket kernels' sums; plan phases 0 and 1 at
    the 1D plan's P and the 2D and 3D layout plans', phase 0 with every
    bucket a roll bucket, the 1D, 2D and 3D edge: P = 5 words with
    buckets k > S / 2 at ki = 0, k > S and k > 2S, and 3D phase 1 at
    P = 8; then the f64 route's cases, 1D, 2D and 3D, every bucket a roll
    bucket: plan phases 0 and 1 and the P = 5 edge): ``torch.equal``;
    each timed beside the plain version and the bound, with the registers
    and spills of the kernel it ran."""
    from gfasort_tpu_torch.bench_util import roll_cases
    from gfasort_tpu_torch.ops.roll_apply import (roll_apply, roll_apply_nd,
                                                  roll_apply_nd_ref,
                                                  roll_apply_ref)

    dev = torch.device("cuda")
    S = bench.total_steps
    results = {}
    for c in roll_cases(bench, plans, dev):
        D, P, kb, rb, args = c["dims"], c["P"], c["kb"], c["rb"], c["args"]
        run, ref_fn = ((roll_apply, roll_apply_ref) if D == 1
                       else (roll_apply_nd, roll_apply_nd_ref))
        out = run(*args)
        ref = ref_fn(*args)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            err = float((out - ref).abs().max())
            raise AssertionError(f"{c['kernel']} off by {err} (dims {D}, "
                                 f"phase {c['phase_of_plan']})")
        del out, ref
        ms = cuda_ms(lambda: run(*args))
        plain_ms = cuda_ms(lambda: ref_fn(*args), 3)
        f64 = c["dtype"] == "float64"
        nw = 0 if P == 1 else n_words(P)
        if D == 1:
            f32, i32, cvt = ops_1d(P, len(rb))
            # the combine: max, divide, add
            ops = (f32 + 3, i32, cvt + 1)
            kname = (f"roll_apply_kernel_tiled<(int){nw}>" if f64
                     else f"roll_apply_kernel<(int){nw}>")
        else:
            f32, i32, cvt = ops_nd(D, P, len(rb))
            # the per-end combine: max, D divides, 2D adds and selects
            ops = (f32 + 4 * D + 1, i32, cvt + D)
            kname = (f"roll_apply_nd_kernel_tiled<(int){D}, (int){nw}>"
                     if f64 else f"roll_apply_nd_kernel<(int){D}, (int){nw}>")
        if f64:
            ops = as_f64(ops, P, len(rb))
        rec = dict(S=S, P=P, dtype=c["dtype"],
                   roll_buckets=[list(b) for b in rb],
                   kernel_buckets=len(kb), max_abs_err=0.0,
                   bit_identical=True, ms=ms, plain_ms=plain_ms,
                   **bound_fields(S, c["words_in"], c["words_out"], ops),
                   **ptxas_row(ptxas, kname))
        if D > 1:
            rec["D"] = D
        results[("1d" if D == 1 else f"{D}d", c["phase_of_plan"])] = rec
        say("roll", card_line, dims=D, phase_of_plan=c["phase_of_plan"], **rec)
        del args, c
    torch.cuda.empty_cache()
    return results


def plain_sweep_1d(xs, pos, rank, cnt, phase, consts, key_words, eta,
                   cooling, P, frac, rng="hash"):
    """One 1D sweep composed from the plain versions of the sampler and
    the roll passes (the bucket kernel between them, where the phase has
    kernel buckets: the kernel phase holds it to its plain version)."""
    from gfasort_tpu_torch.ops.roll_apply import roll_apply_ref
    from gfasort_tpu_torch.ops.sweep_common import sample_words_ref
    from gfasort_tpu_torch.ops.sweep_dense import bucket_apply

    words, _ = sample_words_ref(consts, key_words, cooling, rank, cnt, frac,
                                "stoch", rng)
    sums = (bucket_apply(xs, pos, words, eta, phase.kernel_buckets, P)
            if phase.kernel_buckets else (None, None))
    return roll_apply_ref(xs, pos, words, eta, phase.roll_buckets, P, *sums)


def plain_sweep_nd(cs, pos, rank, cnt, rev, length, phase, consts, key_words,
                   eta, cooling, P, frac, rng="hash"):
    """One nD sweep composed from the plain versions (the nD bucket
    kernel between them, where the phase has kernel buckets)."""
    from gfasort_tpu_torch.ops.roll_apply import roll_apply_nd_ref
    from gfasort_tpu_torch.ops.sweep_common import sample_words_ref
    from gfasort_tpu_torch.ops.sweep_dense import dense_apply_nd
    from gfasort_tpu_torch.ops.sweep_nd import chosen_ends

    words, coin = sample_words_ref(consts, key_words, cooling, rank, cnt,
                                   frac, "stoch", rng, coin=True)
    my_pos, lane0, my_c = chosen_ends(cs, pos, length, rev, coin)
    sums = (dense_apply_nd(my_pos, words, my_c, eta, phase.kernel_buckets, P)
            if phase.kernel_buckets else (None, None))
    return roll_apply_nd_ref(my_pos, my_c, lane0, cs, words, eta,
                             phase.roll_buckets, P, *sums)


def device_launches(fn, tries: int = 2):
    """(device kernels and copies, their device ms) of one call of
    ``fn`` as ``torch.profiler`` records them; (None, None) where the
    profiler records no device activity in ``tries`` calls.  The
    profiler can lose a session's first device activities: after a long
    run of unprofiled launches it does (the f64 1D sweep's sampler kernel
    was lost after the plain f64 period, its roll kernel kept), while it
    requests its activity buffer.  So each session first runs one fill
    on the card, and counts only the device activities that start after
    ``fn``'s own range opens (not the range itself, which the profiler
    also lays on the device's timeline)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev_events = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            with record_function("device_launches"):
                fn()
                torch.cuda.synchronize()
        events = prof.events()
        start = min(e.time_range.start for e in events
                    if e.name == "device_launches")
        dev_events = [e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.time_range.start >= start
                      and e.name != "device_launches"]
        if dev_events:
            break
    if not dev_events:
        return None, None
    us = sum(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
             for e in dev_events)
    return len(dev_events), us / 1e3


def phase_whole_sweep(bench, plans, card_line, dtype="float32"):
    """One consensus period of the 1D engine (``plans[1]``, the bench
    plan) and of the 2D engine (``plans[2]``, the layout plan) on the
    bench index at ``dtype``: the engines' ``sweep_once`` /
    ``nd_sweep_once`` with the kernels against the same sweeps composed
    from the plain versions, then the consensus; ``torch.equal`` on the
    state and the node positions.  At f64 the sampler draws threefry
    bits (from the run's ``threefry_key_table``) and every bucket is a
    roll bucket; the phase line is ``whole_sweep_f64`` and carries the
    kernels' launches in the period.  Both timed on the host clock from
    one synchronisation to the next; the device launches and device ms
    of one sweep of each (``torch.profiler``)."""
    from gfasort_tpu_torch.convert import (initial_state, layout_static_arrays)
    from gfasort_tpu_torch.ops.keys import key_data
    from gfasort_tpu_torch.ops.node_sum import (JAX_ROW_RUN,
                                                build_gather_consensus)
    from gfasort_tpu_torch.ops.sweep import sweep_once
    from gfasort_tpu_torch.ops.sweep_common import route_keys, sampler_consts
    from gfasort_tpu_torch.ops.sweep_nd import nd_sweep_once

    dev = torch.device("cuda")
    npd = np.dtype(dtype).type
    tdt = getattr(torch, dtype)
    name = "whole_sweep" if dtype == "float32" else "whole_sweep_f64"
    pos, rank, cnt, rev, length = layout_static_arrays(bench, dev, npd)

    def period(fn, state, gc):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in range(ce):
            state = fn(e, state)
        state, xn = gc(state)
        torch.cuda.synchronize()
        return state, xn, time.perf_counter() - t0

    out = {}
    for dims in (1, 2):
        plan = plans[dims]
        P, ce = plan.proposals, plan.consensus_every
        keys = route_keys(key_data(11), ce, P, "hash", tdt)
        consts = [[sampler_consts(ph, c, dev, tdt) for c in (False, True)]
                  for ph in plan.phases]
        if dims == 1:
            gc = build_gather_consensus(bench.step_node_idx, bench.num_nodes,
                                        dev, run=JAX_ROW_RUN, dtype=npd)
            state0, _ = initial_state(bench, None, dev, npd)

            def kernel(e, xs):
                i, eta, cool = plan.sweep(e)
                return sweep_once(xs, pos, rank, cnt, plan.phases[i],
                                  consts[i][cool], keys[e], eta, cool, P,
                                  plan.active_frac)

            def plain(e, xs):
                i, eta, cool = plan.sweep(e)
                return plain_sweep_1d(xs, pos, rank, cnt, plan.phases[i],
                                      consts[i][cool], keys[e], eta, cool, P,
                                      plan.active_frac)
        else:
            gc = build_gather_consensus(bench.step_node_idx, bench.num_nodes,
                                        dev, dtype=npd)
            rng = np.random.default_rng(8)
            state0 = torch.from_numpy(np.concatenate([
                bench_layout_coords(rng, bench.step_pos.astype(np.float32), 2)
                for _ in range(2)])).to(tdt).to(dev)

            def kernel(e, cs):
                i, eta, cool = plan.sweep(e)
                return nd_sweep_once(cs, pos, rank, cnt, rev, length,
                                     plan.phases[i], consts[i][cool], keys[e],
                                     eta, cool, P, plan.active_frac)

            def plain(e, cs):
                i, eta, cool = plan.sweep(e)
                return plain_sweep_nd(cs, pos, rank, cnt, rev, length,
                                      plan.phases[i], consts[i][cool],
                                      keys[e], eta, cool, P, plan.active_frac)

        reset_launches()
        s_k, xn_k, secs_k = period(kernel, state0, gc)
        launches = {k: n for k, n in read_launches().items() if n}
        s_p, xn_p, secs_p = period(plain, state0, gc)
        same = torch.equal(s_k, s_p) and torch.equal(xn_k, xn_p)
        if not same:
            err = float((s_k - s_p).abs().max())
            raise AssertionError(f"{dims}D {dtype}: one consensus period with "
                                 f"the kernels differs from the plain sweeps "
                                 f"by {err}")
        if not bool(torch.isfinite(s_k).all()):
            raise AssertionError(f"{dims}D {dtype}: the period's state is not "
                                 f"finite")
        n_dev, dev_ms = device_launches(lambda: kernel(0, state0))
        n_plain, plain_ms = device_launches(lambda: plain(0, state0))
        say(name, card_line, dims=dims, dtype=dtype, proposals=P,
            sweeps=ce, steps=bench.total_steps, kernels_s=secs_k,
            plain_s=secs_p, equal=True, kernel_launches=launches,
            device_launches_per_sweep=n_dev, device_ms_per_sweep=dev_ms,
            plain_device_launches_per_sweep=n_plain,
            plain_device_ms_per_sweep=plain_ms,
            launch_count_source="torch.profiler" if n_dev is not None
            else "not measured: the profiler recorded no device activity")
        out[dims] = launches
        del s_k, s_p, xn_k, xn_p, state0, gc, consts
    torch.cuda.empty_cache()
    return out


def phase_sweep_parts(bench, bench_plan, card_line, n_sweeps: int = 12,
                      dtype: str = "float32", rng: str = "hash"):
    """``n_sweeps`` sweeps of the 1D engine on the bench index taken
    apart with CUDA events (the sampler kernel, the bucket kernel, the
    roll kernel with the combine, as ``sweep_once`` calls them), the
    whole sweep, the plain composition and the consensus; at ``dtype``
    with the draws of ``rng`` (the threefry routes: ``rng`` "threefry",
    or f64 with ``bench_plan`` the f64 plan)."""
    from gfasort_tpu_torch.convert import initial_state, static_arrays
    from gfasort_tpu_torch.ops.keys import key_data
    from gfasort_tpu_torch.ops.node_sum import (JAX_ROW_RUN,
                                                build_gather_consensus)
    from gfasort_tpu_torch.ops.roll_apply import roll_apply
    from gfasort_tpu_torch.ops.sweep import sweep_once
    from gfasort_tpu_torch.ops.sweep_common import (route_keys, sample_words,
                                                    sampler_consts)
    from gfasort_tpu_torch.ops.sweep_dense import bucket_apply

    dev = torch.device("cuda")
    plan = bench_plan
    P = plan.proposals
    npd = np.dtype(dtype).type
    tdt = getattr(torch, dtype)
    pos, rank, cnt = static_arrays(bench, dev, npd)
    xs0, _ = initial_state(bench, None, dev, npd)
    consts = [[sampler_consts(ph, c, dev, tdt) for c in (False, True)]
              for ph in plan.phases]
    keys = route_keys(key_data(12), n_sweeps, P, rng, tdt)

    def run_parts(e, xs, ev):
        i, eta, cool = plan.sweep(e)
        phase = plan.phases[i]
        ev[0].record()
        words, _ = sample_words(consts[i][cool], keys[e], cool, rank, cnt,
                                plan.active_frac, "stoch", rng)
        ev[1].record()
        sums = (bucket_apply(xs, pos, words, eta, phase.kernel_buckets, P)
                if phase.kernel_buckets else (None, None))
        ev[2].record()
        out = roll_apply(xs, pos, words, eta, phase.roll_buckets, P, *sums)
        ev[3].record()
        return out

    def whole(e, xs):
        i, eta, cool = plan.sweep(e)
        return sweep_once(xs, pos, rank, cnt, plan.phases[i], consts[i][cool],
                          keys[e], eta, cool, P, plan.active_frac, "stoch",
                          rng)

    def plain(e, xs):
        i, eta, cool = plan.sweep(e)
        return plain_sweep_1d(xs, pos, rank, cnt, plan.phases[i],
                              consts[i][cool], keys[e], eta, cool, P,
                              plan.active_frac, rng)

    names = ("sampler", "kernel", "roll_combine")
    parts = dict.fromkeys(names, 0.0)
    x_p = x_w = xs0
    whole(0, xs0)   # warm-up
    for e in range(n_sweeps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        x_p = run_parts(e, x_p, ev)
        torch.cuda.synchronize()
        for j, name in enumerate(names):
            parts[name] += ev[j].elapsed_time(ev[j + 1])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for e in range(n_sweeps):
        x_w = whole(e, x_w)
    end.record()
    torch.cuda.synchronize()
    whole_ms = start.elapsed_time(end) / n_sweeps
    if not torch.equal(x_p, x_w):
        raise AssertionError("the timed parts differ from sweep_once")
    plain_ms = cuda_ms(lambda: plain(0, xs0), 3)
    gc = build_gather_consensus(bench.step_node_idx, bench.num_nodes, dev,
                                run=JAX_ROW_RUN, dtype=npd)
    cons_ms = cuda_ms(lambda: gc(x_w), 5)
    say("sweep_parts", card_line, dims=1, dtype=dtype, rng=rng, proposals=P,
        steps=bench.total_steps, sweeps_timed=n_sweeps,
        kernel_buckets=sum(len(ph.kernel_buckets) for ph in plan.phases),
        ms_per_sweep={k: v / n_sweeps for k, v in parts.items()},
        whole_sweep_ms=whole_ms, plain_sweep_ms=plain_ms,
        consensus_ms=cons_ms, consensus_every=plan.consensus_every)
    del x_p, x_w, xs0, gc
    torch.cuda.empty_cache()


@functools.lru_cache(maxsize=None)
def input_graph(gfa_in):
    """The GFA at ``gfa_in``, loaded once: the phases only read it (a
    1M-node load takes ~10 s)."""
    from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast

    return load_gfa_numeric_fast(gfa_in)


@functools.lru_cache(maxsize=None)
def input_index(gfa_in):
    """(PathIndex, the 1D params ``YgsParams.from_graph`` derives) of
    the GFA at ``gfa_in``, built once."""
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.params import YgsParams

    g = input_graph(gfa_in)
    return PathIndex.from_graph(g), YgsParams.from_graph(g).path_sgd


@functools.lru_cache(maxsize=None)
def gfa_truth(gfa_in):
    """(path hashes, (nodes, edges)) of the GFA at ``gfa_in``."""
    g = input_graph(gfa_in)
    return g.compute_all_path_hashes(), (g.node_count(), len(g.edges))


def cli_step(gfa_in, tmp, name, argv, counts_kept: bool = True):
    """``cli.main`` on ``gfa_in`` with every kernel counter from 0; the
    path hashes must be kept, and the node and edge counts too (with
    ``counts_kept=False``, for a pipeline that unchops: the node count
    must not grow).  Writes ``<tmp>/<name>.gfa``.  Returns (the call's
    seconds, its trace events, the launches, the CLI's log)."""
    from gfasort_tpu_torch import cli
    from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast

    hashes0, counts0 = gfa_truth(gfa_in)
    out = os.path.join(tmp, name + ".gfa")
    trace = os.path.join(tmp, name + ".jsonl")
    log = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        rc = cli.main(["-i", gfa_in, "-o", out, *argv, "--trace-out", trace,
                       "-v", "1"])
    secs = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}:\n{log.getvalue()}")
    with open(trace) as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    g1 = load_gfa_numeric_fast(out)
    if g1.compute_all_path_hashes() != hashes0:
        raise AssertionError(f"{name}: path hashes changed")
    if counts_kept and (g1.node_count(), len(g1.edges)) != counts0:
        raise AssertionError(f"{name}: node or edge count changed")
    if g1.node_count() > counts0[0]:
        raise AssertionError(f"{name}: the node count grew")
    return secs, events, launches, log.getvalue()


def step_seconds(events, name: str) -> float:
    return next(e["seconds"] for e in events if e["event"] == name)


def layout_stress(log: str) -> float:
    """The sampled stress the CLI printed; positive and finite."""
    m = re.search(r"layout stress: ([0-9.eE+-]+|nan|inf)", log)
    if m is None:
        raise AssertionError("the CLI printed no layout stress")
    stress = float(m.group(1))
    if not np.isfinite(stress) or stress <= 0:
        raise AssertionError(f"layout stress {stress}")
    return stress


def phase_main(gfa_in, tmp, card_line):
    from gfasort_tpu_torch.ops.sweep import path_linear_sgd_sweep
    from gfasort_tpu_torch.ops.sweep_plan import make_sweep_plan

    _, (nodes0, edges0) = gfa_truth(gfa_in)
    pidx, p = input_index(gfa_in)
    params = replace(p, iter_max=100)
    plan = make_sweep_plan(pidx, params)

    t_cli, events, launches, _ = cli_step(gfa_in, tmp, "sorted",
                                          ["-p", "sYgs"])
    for k in ("sweep_sampler", "bucket_apply", "roll_apply"):
        if launches[k] != plan.n_exec:
            raise AssertionError(f"the main path launched {k} {launches[k]} "
                                 f"times, expected one per executed sweep "
                                 f"({plan.n_exec})")
    y_s = step_seconds(events, "SGD")

    # positions of the same engine on the same graph, read back
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = path_linear_sgd_sweep(None, params, pidx, device="cuda")
    t_engine = time.perf_counter() - t0
    if x.shape != (nodes0,) or not np.isfinite(x).all():
        raise AssertionError("sweep positions are not finite [N]")

    updates = plan.n_sweeps * plan.updates_per_sweep
    say("main", card_line, nodes=nodes0, edges=edges0, steps=pidx.total_steps,
        cli_s=t_cli, y_step_s=y_s,
        steps_s={e["event"] + f"#{e['step']}": e["seconds"] for e in events},
        engine_s=t_engine, n_sweeps=plan.n_sweeps, exec_sweeps=plan.n_exec,
        proposals=plan.proposals, updates=updates,
        pair_updates_per_s_y=updates / y_s,
        pair_updates_per_s_engine=updates / t_engine,
        kernel_launches=launches, path_hashes_preserved=True)
    return launches


def check_tsv(tsv, nodes: int) -> None:
    """The 2D layout TSV holds finite coordinates for both ends of every
    one of ``nodes`` nodes, in order."""
    with open(tsv) as fh:
        vals = np.array(fh.read().split()[5:], dtype=np.float64).reshape(-1, 5)
    if vals.shape[0] != nodes or not np.array_equal(vals[:, 0],
                                                    np.arange(nodes)):
        raise AssertionError(f"the TSV holds {vals.shape[0]} rows, "
                             f"expected {nodes}")
    if not np.isfinite(vals[:, 1:]).all():
        raise AssertionError("the TSV holds non-finite coordinates")


def phase_layout(gfa_in, tmp, card_line):
    """``-p L --dimensions 2`` through the CLI on the bench GFA."""
    from gfasort_tpu_torch.ops.sweep_plan import make_layout_plan
    from gfasort_tpu_torch.params import LayoutSGDParams

    tsv = os.path.join(tmp, "layout.tsv")
    pidx, _ = input_index(gfa_in)
    nodes0 = pidx.num_nodes
    lp = replace(LayoutSGDParams().derive_from_graph(pidx, 2), iter_max=30)
    plan = make_layout_plan(pidx, lp)

    t_cli, events, launches, log = cli_step(
        gfa_in, tmp, "layout",
        ["-p", "L", "--dimensions", "2", "--layout-out", tsv])
    for k in ("sweep_sampler", "dense_apply_nd", "roll_apply_nd"):
        if launches[k] != plan.n_exec:
            raise AssertionError(f"{launches[k]} {k} launches, expected one "
                                 f"per executed sweep ({plan.n_exec})")
    stress = layout_stress(log)
    l_s = step_seconds(events, "2D layout")
    check_tsv(tsv, nodes0)
    updates = plan.n_sweeps * plan.updates_per_sweep
    say("layout", card_line, dims=2, nodes=nodes0, cli_s=t_cli,
        layout_step_s=l_s, stress=stress, n_sweeps=plan.n_sweeps,
        exec_sweeps=plan.n_exec, proposals=plan.proposals,
        consensus_every=plan.consensus_every, updates=updates,
        pair_updates_per_s_step=updates / l_s, kernel_launches=launches,
        tsv_rows=nodes0, path_hashes_preserved=True)
    return launches


def phase_layout_parts(gfa_in, card_line, n_sweeps: int = 12):
    """The 2D layout's host set-up on the host clock, and ``n_sweeps``
    sweeps (one rotation) taken apart with CUDA events: the same calls
    in the same order as ``ops.sweep_nd.nd_sweep_once`` (the sampler
    kernel and the chosen ends' rows, the nD bucket kernel, the roll
    kernel with the combine) and the consensus."""
    from gfasort_tpu_torch.convert import layout_state, layout_static_arrays
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.ops.exact import layout_initial_coords
    from gfasort_tpu_torch.ops.keys import key_data, sweep_key_table
    from gfasort_tpu_torch.ops.node_sum import build_gather_consensus
    from gfasort_tpu_torch.ops.roll_apply import roll_apply_nd
    from gfasort_tpu_torch.ops.sweep_common import sample_words, sampler_consts
    from gfasort_tpu_torch.ops.sweep_dense import dense_apply_nd
    from gfasort_tpu_torch.ops.sweep_nd import chosen_ends, nd_sweep_once
    from gfasort_tpu_torch.ops.sweep_plan import make_layout_plan
    from gfasort_tpu_torch.params import LayoutSGDParams

    dev = torch.device("cuda")
    host = {}
    g = input_graph(gfa_in)
    t0 = time.perf_counter()
    pidx = PathIndex.from_graph(g)
    host["path_index_s"] = time.perf_counter() - t0
    lp = replace(LayoutSGDParams().derive_from_graph(pidx, 2), iter_max=30)
    t0 = time.perf_counter()
    init = layout_initial_coords(pidx, 2, lp.seed)
    host["initial_coords_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = make_layout_plan(pidx, lp)
    consts = [[sampler_consts(ph, c, dev) for c in (False, True)]
              for ph in plan.phases]
    host["plan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gc = build_gather_consensus(pidx.step_node_idx, pidx.num_nodes, dev)
    torch.cuda.synchronize()
    host["consensus_tables_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pos, rank, cnt, rev, length = layout_static_arrays(pidx, dev)
    cs, _ = layout_state(pidx, init, 2, dev)
    torch.cuda.synchronize()
    host["upload_s"] = time.perf_counter() - t0
    host["total_s"] = sum(host.values())
    keys = sweep_key_table(key_data(lp.seed), plan.n_exec, plan.proposals)
    S, D, P = pos.shape[0], 2, plan.proposals

    def run_parts(e, cs, ev):
        i, eta, cooling = plan.sweep(e)
        phase = plan.phases[i]
        ev[0].record()
        words, coin = sample_words(consts[i][cooling], keys[e], cooling, rank,
                                   cnt, plan.active_frac, coin=True)
        my_pos, lane0, my_c = chosen_ends(cs, pos, length, rev, coin)
        ev[1].record()
        sums = (dense_apply_nd(my_pos, words, my_c, eta, phase.kernel_buckets,
                               P) if phase.kernel_buckets else (None, None))
        ev[2].record()
        out = roll_apply_nd(my_pos, my_c, lane0, cs, words, eta,
                            phase.roll_buckets, P, *sums)
        ev[3].record()
        return out

    def whole(e, cs):
        i, eta, cooling = plan.sweep(e)
        return nd_sweep_once(cs, pos, rank, cnt, rev, length, plan.phases[i],
                             consts[i][cooling], keys[e], eta, cooling, P,
                             plan.active_frac)

    # warm-up, then the parts and the whole sweep on the same sweeps
    cs_a = whole(0, cs)
    cs_b = run_parts(0, cs, [torch.cuda.Event(enable_timing=True)
                             for _ in range(4)])
    torch.cuda.synchronize()
    if not torch.equal(cs_a, cs_b):
        raise AssertionError("the timed parts differ from nd_sweep_once")
    names = ("sampler", "kernel", "roll_combine")
    parts = dict.fromkeys(names, 0.0)
    cs_p = cs
    for e in range(n_sweeps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        cs_p = run_parts(e, cs_p, ev)
        torch.cuda.synchronize()
        for j, name in enumerate(names):
            parts[name] += ev[j].elapsed_time(ev[j + 1])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    cs_w = cs
    torch.cuda.synchronize()
    start.record()
    for e in range(n_sweeps):
        cs_w = whole(e, cs_w)
    end.record()
    torch.cuda.synchronize()
    whole_ms = start.elapsed_time(end) / n_sweeps
    if not torch.equal(cs_p, cs_w):
        raise AssertionError("the timed parts differ from nd_sweep_once")
    cons_ms = cuda_ms(lambda: gc(cs_w), 5)
    per_sweep = {k: v / n_sweeps for k, v in parts.items()}
    updates = plan.n_sweeps * plan.updates_per_sweep
    loop_s = (plan.n_exec * whole_ms
              + plan.n_exec // plan.consensus_every * cons_ms) / 1e3
    say("layout_parts", card_line, dims=2, host_setup_s=host,
        sweeps_timed=n_sweeps, ms_per_sweep=per_sweep,
        whole_sweep_ms=whole_ms, consensus_ms=cons_ms,
        consensus_runs=plan.n_exec // plan.consensus_every,
        device_loop_s_est=loop_s,
        pair_updates_per_s_device_loop=updates / loop_s,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del cs, cs_a, cs_b, cs_p, cs_w, gc, pos, rank, cnt, rev, length, consts
    torch.cuda.empty_cache()


def phase_quality(card_line):
    from gfasort_tpu_torch import native
    from gfasort_tpu_torch.bench_util import rank_quality, synthetic_path_index
    from gfasort_tpu_torch.ops.sweep import path_linear_sgd_sweep
    from gfasort_tpu_torch.params import PathSGDParams

    use_native = native.available()
    if not use_native:
        print("quality: the C++ oracle cannot be built here; certifying "
              "the smaller workload against the Python oracle", flush=True)
    cfg = CERT if use_native else CERT_SMALL
    pidx = synthetic_path_index(cfg["n_nodes"], cfg["n_paths"],
                                cfg["steps_per_path"], seed=cfg["seed"])
    p = replace(PathSGDParams().derive_from_graph(pidx),
                iter_max=cfg["iter_max"], dtype="float32", pow_mode="fast")
    t0 = time.perf_counter()
    x_sweep = path_linear_sgd_sweep(None, p, pidx, device="cuda")
    t_sweep = time.perf_counter() - t0
    po = replace(p, dtype="float64", pow_mode="fpp")
    t0 = time.perf_counter()
    if use_native:
        x_oracle = native.path_linear_sgd_native(None, po, pidx)
    else:
        from gfasort_tpu_torch.ops.exact import path_linear_sgd_exact

        x_oracle = path_linear_sgd_exact(None, po, pidx)
    t_oracle = time.perf_counter() - t0
    q = rank_quality(np.argsort(x_sweep, kind="stable"),
                     np.argsort(x_oracle, kind="stable"))
    ok = q["rank_mae_frac"] <= RANK_MAE_MAX and q["spearman"] >= SPEARMAN_MIN
    say("quality", card_line, oracle="native" if use_native else "python",
        sweep_s=t_sweep, oracle_s=t_oracle, passed=ok, **cfg, **q)
    if not ok:
        raise AssertionError(f"quality certificate failed: {q}")
    return dict(pidx=pidx, params=p, x_oracle=x_oracle, cfg=cfg)


def certify(phase, card_line, cert, x, seconds, **extra):
    """Rank-MAE/N and Spearman of ``x``'s order against the certificate
    workload's oracle order, held to ``bench.py``'s thresholds."""
    q = rank_quality_of(x, cert["x_oracle"])
    ok = q["rank_mae_frac"] <= RANK_MAE_MAX and q["spearman"] >= SPEARMAN_MIN
    say(phase, card_line, part="certificate", seconds=seconds, passed=ok,
        **extra, **cert["cfg"], **q)
    if not ok:
        raise AssertionError(f"{phase} certificate failed: {q}")
    return q


def rank_quality_of(x, x_ref):
    from gfasort_tpu_torch.bench_util import rank_quality

    return rank_quality(np.argsort(x, kind="stable"),
                        np.argsort(x_ref, kind="stable"))


@contextlib.contextmanager
def plain_call_counter():
    """Count the calls of the sampler's and the roll passes' plain
    versions while the block runs: each is wrapped wherever a module of
    the port holds it.  Yields the counts ({name: calls})."""
    from gfasort_tpu_torch.ops import roll_apply, sweep_common

    originals = {"sample_words_ref": sweep_common.sample_words_ref,
                 "roll_apply_ref": roll_apply.roll_apply_ref,
                 "roll_apply_nd_ref": roll_apply.roll_apply_nd_ref}
    counts = dict.fromkeys(originals, 0)

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return counted

    patched = []
    for mod in [m for k, m in sys.modules.items()
                if k.startswith("gfasort_tpu_torch") and m is not None]:
        for name, fn in originals.items():
            if getattr(mod, name, None) is fn:
                setattr(mod, name, wrap(name, fn))
                patched.append((mod, name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def phase_sweep_mode(phase, bench, cert, card_line, dtype, rng):
    """The 1D sweep engine at ``dtype`` with ``GFASORT_SWEEP_RNG=rng``
    (the threefry routes: f32 threefry draws, and f64): timed on the
    bench index (a direct engine call, host set-up included) at
    SWEEP_MODE_ITER iterations and at the plan's full depth, each with
    the kernels' launches counted from 0 around it (the sampler and the
    roll kernel once per executed sweep, the bucket kernel as often at
    f32 and never at f64) and the plain versions' calls counted (none),
    then certified on the certificate workload.  Returns the full-depth
    run's launches and seconds."""
    from gfasort_tpu_torch.ops.sweep import path_linear_sgd_sweep
    from gfasort_tpu_torch.ops.sweep_plan import make_sweep_plan
    from gfasort_tpu_torch.params import PathSGDParams

    old = os.environ.get("GFASORT_SWEEP_RNG")
    os.environ["GFASORT_SWEEP_RNG"] = rng
    try:
        full = replace(PathSGDParams().derive_from_graph(bench), dtype=dtype)
        for depth, p in (("cut", replace(full, iter_max=SWEEP_MODE_ITER)),
                         ("full", full)):
            plan = make_sweep_plan(bench, p)
            kernel_buckets = sum(len(ph.kernel_buckets) for ph in plan.phases)
            roll_buckets = sum(len(ph.roll_buckets) for ph in plan.phases)
            if dtype == "float64" and kernel_buckets:
                raise AssertionError(f"{phase}: {kernel_buckets} kernel "
                                     f"buckets at f64")
            reset_launches()
            with plain_call_counter() as plain_calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = path_linear_sgd_sweep(None, p, bench, device="cuda")
                secs = time.perf_counter() - t0
            launches = read_launches()
            if x.shape != (bench.num_nodes,) or not np.isfinite(x).all():
                raise AssertionError(f"{phase}: positions not finite [N]")
            want = {"sweep_sampler": plan.n_exec, "roll_apply": plan.n_exec,
                    "bucket_apply": 0 if dtype == "float64" else plan.n_exec}
            for k, n in want.items():
                if launches[k] != n:
                    raise AssertionError(f"{phase}: {launches[k]} {k} "
                                         f"launches, expected {n}")
            if any(plain_calls.values()):
                raise AssertionError(f"{phase}: the plain versions ran on "
                                     f"the card: {plain_calls}")
            updates = plan.n_sweeps * plan.updates_per_sweep
            say(phase, card_line, part="bench", depth=depth, dtype=dtype,
                rng=plan.knobs.rng, iter_max=p.iter_max,
                nodes=bench.num_nodes, steps=bench.total_steps,
                engine_s=secs, n_sweeps=plan.n_sweeps,
                exec_sweeps=plan.n_exec, proposals=plan.proposals,
                kernel_buckets=kernel_buckets, roll_buckets=roll_buckets,
                updates=updates, pair_updates_per_s_engine=updates / secs,
                kernel_launches=launches, plain_calls=plain_calls)
        pc = replace(cert["params"], dtype=dtype)
        t0 = time.perf_counter()
        xc = path_linear_sgd_sweep(None, pc, cert["pidx"], device="cuda")
        certify(phase, card_line, cert, xc, time.perf_counter() - t0,
                dtype=dtype, rng=rng)
    finally:
        if old is None:
            os.environ.pop("GFASORT_SWEEP_RNG", None)
        else:
            os.environ["GFASORT_SWEEP_RNG"] = old
    return dict(launches=launches, engine_s=secs, exec_sweeps=plan.n_exec)


def phase_batched_cli(gfa_in, tmp, card_line):
    """``-p Y --engine batched`` on the bench GFA through the CLI at its
    default schedule; every kernel counter read from 0 around it (the
    batched path runs no hand-written kernel)."""
    from gfasort_tpu_torch.ops.sgd import (build_schedule, effective_batch,
                                           path_linear_sgd_batched)

    _, (nodes0, _) = gfa_truth(gfa_in)
    pidx, p = input_index(gfa_in)
    params = replace(p, iter_max=BATCHED_CLI_ITER)
    B = effective_batch(params)
    n_rounds = build_schedule(params, B)[3]

    t_cli, events, launches, _ = cli_step(
        gfa_in, tmp, "batched",
        ["-p", "Y", "--engine", "batched", "--iter-max", str(BATCHED_CLI_ITER)])
    y_s = step_seconds(events, "SGD")

    # the same engine on the same index, called directly
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = path_linear_sgd_batched(None, params, pidx, device="cuda")
    t_engine = time.perf_counter() - t0
    if x.shape != (nodes0,) or not np.isfinite(x).all():
        raise AssertionError("batched positions are not finite [N]")
    say("batched", card_line, part="cli", nodes=nodes0,
        iter_max=BATCHED_CLI_ITER, batch=B, rounds=n_rounds, cli_s=t_cli,
        y_step_s=y_s, rounds_per_s=n_rounds / y_s,
        pair_updates_per_s=n_rounds * B / y_s, engine_s=t_engine,
        pair_updates_per_s_engine=n_rounds * B / t_engine,
        kernel_launches=launches, path_hashes_preserved=True)


def phase_batched(cert, card_line):
    """The batched engine's order certificates at f64 and f32, the f64
    run repeated on the card (``torch.equal``), and the 2D batched
    layout certificate.  Returns the f64 positions."""
    from gfasort_tpu_torch.bench_util import layout_quality_vs_oracle
    from gfasort_tpu_torch.ops.keys import key_data
    from gfasort_tpu_torch.ops.sgd import build_1d_runner, effective_batch

    pidx = cert["pidx"]
    out = {}
    for dtype in ("float64", "float32"):
        p = replace(cert["params"], dtype=dtype, pow_mode="fpp")
        runs = []
        for rep in range(2 if dtype == "float64" else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run, make_x0, n_rounds = build_1d_runner(pidx, p, device="cuda")
            x = run(make_x0(), key_data(p.seed))
            torch.cuda.synchronize()
            runs.append((x, time.perf_counter() - t0))
        x, secs = runs[-1]
        same = None
        if len(runs) == 2:
            same = bool(torch.equal(runs[0][0], runs[1][0]))
            if not same:
                raise AssertionError("two batched runs on the card differ")
        B = effective_batch(p)
        certify("batched", card_line, cert, x.cpu().numpy(), secs,
                dtype=dtype, pow_mode="fpp", batch=B, rounds=n_rounds,
                rounds_per_s=n_rounds / secs,
                pair_updates_per_s=n_rounds * B / secs,
                repeat_torch_equal=same)
        out[dtype] = x.cpu().numpy().astype(np.float64)
    t0 = time.perf_counter()
    q = layout_quality_vs_oracle(dims=2, device="cuda", engine="batched")
    if q is None:
        raise AssertionError("the C++ layout oracle cannot be built")
    ok = q["ratio"] <= STRESS_RATIO_MAX
    say("batched", card_line, part="layout", seconds=time.perf_counter() - t0,
        passed=ok, **q)
    if not ok:
        raise AssertionError(f"batched layout certificate failed: {q}")
    return out["float64"]


def phase_checkpoint(cert, x_single, tmp, card_line):
    """The checkpointed batched run (f64) stopped after two segments,
    resumed, and compared with the single-shot run; then a checkpoint
    of another seed is refused."""
    from gfasort_tpu_torch.checkpoint import (fingerprint, load_checkpoint,
                                              path_linear_sgd_checkpointed,
                                              save_checkpoint)

    pidx = cert["pidx"]
    p = replace(cert["params"], dtype="float64", pow_mode="fpp")
    ck = os.path.join(tmp, "batched.ckpt")
    seen = []

    class Stop(Exception):
        pass

    def stop_after_two(nxt, total):
        seen.append((nxt, total))
        if len(seen) == 2:
            raise Stop()

    t0 = time.perf_counter()
    try:
        path_linear_sgd_checkpointed(None, p, ck, pidx, CKPT_SEGMENT,
                                     stop_after_two, device="cuda")
        raise AssertionError("the checkpointed run did not stop")
    except Stop:
        pass
    saved = load_checkpoint(ck, fingerprint(p, pidx))
    if saved is None or saved[1] != 2 * CKPT_SEGMENT:
        raise AssertionError(f"no checkpoint at round {2 * CKPT_SEGMENT}")
    x = path_linear_sgd_checkpointed(None, p, ck, pidx, CKPT_SEGMENT,
                                     device="cuda")
    secs = time.perf_counter() - t0
    if not np.array_equal(x, x_single):
        raise AssertionError("the resumed run differs from the single shot")
    if os.path.exists(ck):
        raise AssertionError("the checkpoint was not removed")
    save_checkpoint(ck, x, 2 * CKPT_SEGMENT, fingerprint(p, pidx))
    try:
        load_checkpoint(ck, fingerprint(replace(p, seed=p.seed + 1), pidx))
        raise AssertionError("a checkpoint of another run was accepted")
    except ValueError:
        pass
    os.unlink(ck)
    say("checkpoint", card_line, segment_rounds=CKPT_SEGMENT,
        progress=seen, seconds=secs, equals_single_shot=True,
        other_run_refused=True)


def phase_quality_nd(card_line):
    """The layout certificates: 2D and 3D at f32, and 2D at f64 (the
    threefry sampler and the f64 nD roll kernel, every bucket rolled)."""
    from gfasort_tpu_torch.bench_util import layout_quality_vs_oracle

    for dims, dtype in ((2, "float32"), (3, "float32"), (2, "float64")):
        t0 = time.perf_counter()
        q = layout_quality_vs_oracle(dims=dims, device="cuda", dtype=dtype,
                                     **ND_CERT_KW)
        if q is None:
            raise AssertionError("the C++ layout oracle cannot be built")
        ok = q["ratio"] <= STRESS_RATIO_MAX
        say("quality_nd", card_line, seconds=time.perf_counter() - t0,
            passed=ok, dtype=dtype, **ND_CERT_KW, **q)
        if not ok:
            raise AssertionError(f"layout certificate failed: {q}")


def phase_layout_f64(bench, card_line):
    """The 2D layout engine at f64, a direct call on the bench index at
    ``layout``'s depth (iter 30): the sampler and the nD roll kernel
    launch once per executed sweep, the nD bucket kernel never, and the
    plain sampler and roll passes are never called; the coordinates are
    finite.  Returns the kernels' launches."""
    from gfasort_tpu_torch.ops.sweep_nd import path_linear_sgd_layout_sweep
    from gfasort_tpu_torch.ops.sweep_plan import make_layout_plan
    from gfasort_tpu_torch.params import LayoutSGDParams

    lp = replace(LayoutSGDParams().derive_from_graph(bench, 2), iter_max=30,
                 dtype="float64")
    plan = make_layout_plan(bench, lp)
    reset_launches()
    with plain_call_counter() as plain_calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lay = path_linear_sgd_layout_sweep(None, lp, bench, device="cuda")
        secs = time.perf_counter() - t0
    launches = read_launches()
    want = {"sweep_sampler": plan.n_exec, "roll_apply_nd": plan.n_exec,
            "dense_apply_nd": 0}
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"layout_f64: {launches[k]} {k} launches, "
                                 f"expected {n}")
    if any(plain_calls.values()):
        raise AssertionError(f"layout_f64: the plain versions ran on the "
                             f"card: {plain_calls}")
    if lay.num_nodes != bench.num_nodes or not np.isfinite(lay.coords).all():
        raise AssertionError("layout_f64: coordinates not finite [N, 2, 2]")
    say("layout_f64", card_line, dims=2, dtype="float64", iter_max=30,
        nodes=bench.num_nodes, steps=bench.total_steps, engine_s=secs,
        n_sweeps=plan.n_sweeps, exec_sweeps=plan.n_exec,
        proposals=plan.proposals,
        kernel_buckets=sum(len(ph.kernel_buckets) for ph in plan.phases),
        kernel_launches={k: n for k, n in launches.items() if n},
        plain_calls=plain_calls)
    return launches


# shards of the one card in the direct runs of the sharded phases
SHARDS = 4


def shard_len(pidx, n_shards: int) -> int:
    """The sharded engines' shard length L: the largest shard of the
    path partition."""
    from gfasort_tpu_torch.parallel.mesh import partition_paths

    return max(max(int(pidx.path_count[p].sum()) if len(p) else 0
                   for p in partition_paths(pidx.path_count.tolist(),
                                            n_shards)), 1)


def phase_sharded_sweep(gfa_in, tmp, bench, cert, card_line):
    """The sharded 1D sweep: the CLI on a one-shard card mesh, a direct
    call on ``SHARDS`` shards of the card, and the certificate at 1 and
    ``SHARDS`` shards.  Returns the one-shard certificate positions."""
    from gfasort_tpu_torch.ops.sweep_plan import make_sharded_sweep_plan
    from gfasort_tpu_torch.parallel import (default_mesh,
                                            path_linear_sgd_sweep_sharded)
    from gfasort_tpu_torch.params import PathSGDParams

    pidx, p = input_index(gfa_in)
    params = replace(p, iter_max=SWEEP_MODE_ITER)
    n_cards = default_mesh(device="cuda").size
    plan = make_sharded_sweep_plan(pidx, params, shard_len(pidx, n_cards))
    secs, events, launches, _ = cli_step(
        gfa_in, tmp, "sharded_sweep", ["-p", "Y", "--engine", "sweep-sharded",
                                       "--iter-max", str(SWEEP_MODE_ITER)])
    y_s = step_seconds(events, "SGD")
    if launches["bucket_apply"] != plan.n_exec * n_cards:
        raise AssertionError(f"{launches['bucket_apply']} bucket kernel "
                             f"launches, expected {plan.n_exec * n_cards}")
    updates = plan.n_sweeps * plan.updates_per_sweep
    say("sharded_sweep", card_line, part="cli", shards=n_cards,
        steps=pidx.total_steps, shard_len=shard_len(pidx, n_cards),
        cli_s=secs, y_step_s=y_s, consensus_every=plan.consensus_every,
        n_sweeps=plan.n_sweeps, exec_sweeps=plan.n_exec,
        proposals=plan.proposals, updates=updates,
        pair_updates_per_s_y=updates / y_s, kernel_launches=launches,
        path_hashes_preserved=True)
    del pidx

    p = replace(PathSGDParams().derive_from_graph(bench),
                iter_max=SWEEP_MODE_ITER)
    L = shard_len(bench, SHARDS)
    plan = make_sharded_sweep_plan(bench, p, L)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = path_linear_sgd_sweep_sharded(None, p, default_mesh(SHARDS, "cuda"),
                                      bench)
    secs = time.perf_counter() - t0
    launches = read_launches()
    if x.shape != (bench.num_nodes,) or not np.isfinite(x).all():
        raise AssertionError("sharded sweep positions are not finite [N]")
    if launches["bucket_apply"] != plan.n_exec * SHARDS:
        raise AssertionError(f"{launches['bucket_apply']} bucket kernel "
                             f"launches, expected {plan.n_exec * SHARDS}")
    updates = plan.n_sweeps * plan.updates_per_sweep
    say("sharded_sweep", card_line, part="direct", shards=SHARDS,
        steps=bench.total_steps, shard_len=L, engine_s=secs,
        consensus_every=plan.consensus_every, n_sweeps=plan.n_sweeps,
        exec_sweeps=plan.n_exec, proposals=plan.proposals, updates=updates,
        pair_updates_per_s_engine=updates / secs, kernel_launches=launches)

    # the single-card engine and the one-shard sharded engine on the bench
    # index, in turns (single, sharded, sharded, single)
    from gfasort_tpu_torch.ops.sweep import path_linear_sgd_sweep

    runs = {"single": [], "sharded_1": []}
    for name in ("single", "sharded_1", "sharded_1", "single"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "single":
            path_linear_sgd_sweep(None, p, bench, device="cuda")
        else:
            path_linear_sgd_sweep_sharded(None, p, default_mesh(1, "cuda"),
                                          bench)
        runs[name].append(time.perf_counter() - t0)
    say("sharded_sweep", card_line, part="vs_single", engine_s=runs)

    out = {}
    for n in (1, SHARDS):
        t0 = time.perf_counter()
        x = path_linear_sgd_sweep_sharded(None, cert["params"],
                                          default_mesh(n, "cuda"),
                                          cert["pidx"])
        certify("sharded_sweep", card_line, cert, x, time.perf_counter() - t0,
                shards=n, shard_len=shard_len(cert["pidx"], n))
        out[n] = x
    return out[1]


def phase_sharded_layout(gfa_in, tmp, card_line):
    """``-p L --dimensions 2 --engine sweep-sharded`` through the CLI,
    and the sharded layout certificate on ``SHARDS`` shards of the card,
    2D and 3D."""
    from gfasort_tpu_torch.bench_util import layout_quality_vs_oracle
    from gfasort_tpu_torch.ops.sweep_plan import make_sharded_layout_plan
    from gfasort_tpu_torch.parallel import default_mesh
    from gfasort_tpu_torch.params import LayoutSGDParams

    pidx, _ = input_index(gfa_in)
    lp = replace(LayoutSGDParams().derive_from_graph(pidx, 2), iter_max=30)
    n_cards = default_mesh(device="cuda").size
    plan = make_sharded_layout_plan(pidx, lp, shard_len(pidx, n_cards))
    del pidx
    secs, events, launches, log = cli_step(
        gfa_in, tmp, "sharded_layout",
        ["-p", "L", "--dimensions", "2", "--engine", "sweep-sharded",
         "--layout-out", os.path.join(tmp, "sharded_layout.tsv")])
    l_s = step_seconds(events, "2D layout")
    if launches["dense_apply_nd"] != plan.n_exec * n_cards:
        raise AssertionError(f"{launches['dense_apply_nd']} nD kernel "
                             f"launches, expected {plan.n_exec * n_cards}")
    stress = layout_stress(log)
    say("sharded_layout", card_line, part="cli", dims=2, shards=n_cards,
        cli_s=secs, layout_step_s=l_s, stress=stress,
        consensus_every=plan.consensus_every, n_sweeps=plan.n_sweeps,
        exec_sweeps=plan.n_exec, proposals=plan.proposals,
        kernel_launches=launches, path_hashes_preserved=True)
    for dims in (2, 3):
        reset_launches()
        t0 = time.perf_counter()
        q = layout_quality_vs_oracle(dims=dims, device="cuda",
                                     engine="sweep-sharded",
                                     mesh=default_mesh(SHARDS, "cuda"),
                                     **ND_CERT_KW)
        if q is None:
            raise AssertionError("the C++ layout oracle cannot be built")
        ok = q["ratio"] <= STRESS_RATIO_MAX
        say("sharded_layout", card_line, part="certificate", shards=SHARDS,
            seconds=time.perf_counter() - t0, passed=ok,
            kernel_launches=read_launches(), **ND_CERT_KW, **q)
        if not ok:
            raise AssertionError(f"sharded layout certificate failed: {q}")


def phase_sharded_batched(gfa_in, tmp, cert, card_line):
    """``-p Y --engine sharded`` through the CLI, and the sharded batched
    certificate at 1 and ``SHARDS`` shards of the card."""
    from gfasort_tpu_torch.ops.sgd import build_schedule, effective_batch
    from gfasort_tpu_torch.parallel import default_mesh, path_linear_sgd_sharded

    params = replace(input_index(gfa_in)[1], iter_max=BATCHED_CLI_ITER)
    n_cards = default_mesh(device="cuda").size
    b_local = -(-effective_batch(params) // n_cards)
    n_rounds = build_schedule(params, b_local * n_cards)[3]
    secs, events, launches, _ = cli_step(
        gfa_in, tmp, "sharded_batched",
        ["-p", "Y", "--engine", "sharded", "--iter-max", str(BATCHED_CLI_ITER)])
    y_s = step_seconds(events, "SGD")
    say("sharded_batched", card_line, part="cli", shards=n_cards,
        iter_max=BATCHED_CLI_ITER, batch_local=b_local, rounds=n_rounds,
        cli_s=secs, y_step_s=y_s, rounds_per_s=n_rounds / y_s,
        pair_updates_per_s=n_rounds * b_local * n_cards / y_s,
        kernel_launches=launches, path_hashes_preserved=True)
    p = replace(cert["params"], pow_mode="fpp")
    for n in (1, SHARDS):
        b_local = -(-effective_batch(p) // n)
        n_rounds = build_schedule(p, b_local * n)[3]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = path_linear_sgd_sharded(None, p, default_mesh(n, "cuda"),
                                    cert["pidx"])
        secs = time.perf_counter() - t0
        certify("sharded_batched", card_line, cert, x, secs, shards=n,
                dtype=p.dtype, pow_mode="fpp", batch_local=b_local,
                rounds=n_rounds, rounds_per_s=n_rounds / secs)


def phase_distributed(cert, x_no_group, card_line):
    """A one-rank NCCL group from the ``GFASORT_*`` variables; the sharded
    sweep on the certificate workload through it equals the run with no
    group bit for bit."""
    import socket

    import torch.distributed as dist

    from gfasort_tpu_torch.parallel import path_linear_sgd_sweep_sharded
    from gfasort_tpu_torch.parallel.mesh import default_mesh, init_distributed

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {"GFASORT_COORDINATOR": f"127.0.0.1:{port}",
           "GFASORT_NUM_PROCESSES": "1", "GFASORT_PROCESS_ID": "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        init_distributed(device="cuda")
        init_s = time.perf_counter() - t0
        mesh = default_mesh(device="cuda")
        if mesh.group is None or dist.get_backend() != "nccl":
            raise AssertionError("no NCCL process group")
        reset_launches()
        t0 = time.perf_counter()
        x = path_linear_sgd_sweep_sharded(None, cert["params"], mesh,
                                          cert["pidx"])
        secs = time.perf_counter() - t0
        launches = read_launches()
        same = bool(np.array_equal(x, x_no_group))
        say("distributed", card_line, backend=dist.get_backend(),
            world=dist.get_world_size(), shards=mesh.size, init_s=init_s,
            engine_s=secs, equals_no_group=same, kernel_launches=launches)
        if not same:
            raise AssertionError("the NCCL run differs from the run with no "
                                 "process group")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_entry(card_line):
    """``entry("cuda")``'s round on the card against the same round on
    the CPU, and ``dryrun_multichip`` on ``SHARDS`` shards of the card."""
    from gfasort_tpu_torch.entry import dryrun_multichip, entry

    fn, args = entry("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    fn_cpu, args_cpu = entry("cpu")
    ref = fn_cpu(*args_cpu)
    torch.testing.assert_close(out.cpu(), ref, rtol=ENTRY_RTOL,
                               atol=ENTRY_ATOL)
    t0 = time.perf_counter()
    summary = dryrun_multichip(SHARDS, "cuda")
    say("entry", card_line, round_s=round_s, nodes=int(out.shape[0]),
        max_abs_err_vs_cpu=float((out.cpu() - ref).abs().max()),
        equal_to_cpu=bool(torch.equal(out.cpu(), ref)), rtol=ENTRY_RTOL,
        atol=ENTRY_ATOL, dryrun_s=time.perf_counter() - t0, dryrun=summary)


def y_step_parts(graph, params) -> dict:
    """The 1D sweep ``Y`` step as a served job runs it (the runner cache
    on), taken apart on the host clock: the path index, the runner's
    cold build and its cache hit (the fingerprint), the initial state,
    the run read back, the order and its application to ``graph``; and
    the device bytes the cached runner keeps alive."""
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.ops import runner_cache
    from gfasort_tpu_torch.ops.keys import key_data
    from gfasort_tpu_torch.ops.sweep import build_sweep_runner

    def lap(name, t0):
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0

    secs = {}
    old = os.environ.get("GFASORT_RUNNER_CACHE")
    os.environ["GFASORT_RUNNER_CACHE"] = "1"
    try:
        t0 = time.perf_counter()
        pidx = PathIndex.from_graph(graph)
        lap("path_index_s", t0)
        m0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        built = build_sweep_runner(pidx, params, device="cuda")
        lap("build_s", t0)
        device_bytes = torch.cuda.memory_allocated() - m0
        t0 = time.perf_counter()
        hit = build_sweep_runner(pidx, params, device="cuda")
        lap("hit_s", t0)
        if hit is not built:
            raise AssertionError("the second build missed the runner cache")
        run, arrays, make_state, _ = hit
        t0 = time.perf_counter()
        xs0, xn0 = make_state()
        lap("state_s", t0)
        t0 = time.perf_counter()
        x = run(xs0, xn0, key_data(params.seed), *arrays).cpu().numpy()
        lap("run_s", t0)
        t0 = time.perf_counter()
        order = (np.asarray(pidx.node_ids)[np.argsort(
            x.astype(np.float64), kind="stable")] << 1).tolist()
        lap("order_s", t0)
        t0 = time.perf_counter()
        graph.apply_ordering(order)
        lap("apply_ordering_s", t0)
        del built, hit, run, arrays, make_state
        runner_cache._CACHE.clear()
    finally:
        if old is None:
            os.environ.pop("GFASORT_RUNNER_CACHE")
        else:
            os.environ["GFASORT_RUNNER_CACHE"] = old
    return {"cached_runner_device_bytes": device_bytes, **secs}


# run in a fresh process by fresh_process_y_parts: the first-use costs
# of a process, then the 1D `Y` step taken apart twice
_FRESH_PROCESS = """
import json, sys, time
t0 = time.perf_counter()
import torch
import_s = time.perf_counter() - t0
t0 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
context_s = time.perf_counter() - t0
t0 = time.perf_counter()
from gfasort_tpu_torch import kernels
kernels.library()
library_s = time.perf_counter() - t0
from dataclasses import replace
import chip_smoke
from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast
from gfasort_tpu_torch.params import YgsParams
g = load_gfa_numeric_fast(sys.argv[1])
p = replace(YgsParams.from_graph(g).path_sgd, iter_max=int(sys.argv[2]))
first = chip_smoke.y_step_parts(g, p)
second = chip_smoke.y_step_parts(g, p)
print(json.dumps({"import_torch_s": import_s, "cuda_context_s": context_s,
                  "kernel_library_s": library_s, "first_y": first,
                  "second_y": second}))
"""


def fresh_process_y_parts(gfa_in) -> dict:
    """In a new process: the torch import, the CUDA context and the
    kernel library's load, then ``y_step_parts`` twice on ``gfa_in``
    (the second on the renumbered graph, a cold build in a warm
    process): where a served job's first-use cost goes."""
    out = subprocess.run(
        [sys.executable, "-c", _FRESH_PROCESS, gfa_in, str(SERVER_ITER)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"the fresh-process Y parts failed:\n"
                             f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_server(gfa_in, tmp, card_line):
    """``-p Y --engine sweep --iter-max SERVER_ITER`` twice through
    ``--server`` from fresh clients (``tools/e2e_server_warm.py``): one
    daemon pid, byte-identical outputs, both equal to the same job run
    in-process (whose bucket-kernel launches are counted); then, in a
    fresh process, its first-use costs and the ``Y`` step taken apart
    twice, with the cached runner's device bytes."""
    from gfasort_tpu_torch.tools.e2e_server_warm import serve_twice

    job = ["-p", "Y", "--engine", "sweep", "--iter-max", str(SERVER_ITER),
           "--device", "cuda"]
    runs = serve_twice(gfa_in, tmp, job, os.path.join(tmp, "s.sock"),
                       timeout=900)
    if runs[0]["pid"] != runs[1]["pid"]:
        raise AssertionError(f"two daemons served the jobs: {runs}")
    served = [open(r["output"], "rb").read() for r in runs]
    if served[0] != served[1]:
        raise AssertionError("the two served outputs differ")
    secs, events, launches, _ = cli_step(gfa_in, tmp, "served_ref", job)
    with open(os.path.join(tmp, "served_ref.gfa"), "rb") as fh:
        if fh.read() != served[0]:
            raise AssertionError("the served output differs from the "
                                 "in-process run's")
    if launches["bucket_apply"] <= 0:
        raise AssertionError("the in-process Y launched no bucket kernel")
    fresh = fresh_process_y_parts(gfa_in)
    say("server", card_line, iter_max=SERVER_ITER, pid=runs[0]["pid"],
        served={r["run"]: {"client_wall_s": r["client_wall_s"],
                           "served_wall_s": r["served_wall_s"],
                           "y_step_s": r["step_walls_s"]["SGD"]}
                for r in runs},
        in_process_cli_s=secs, in_process_y_step_s=step_seconds(events, "SGD"),
        outputs_identical=True, fresh_process=fresh, kernel_launches=launches)


def phase_e2e(gfa_in, tmp, card_line):
    """``sYgsuL`` as ``tools/e2e_chromosome.py`` runs it, in-process so
    that the kernels' launches are counted: path hashes kept, the node
    count not grown, both bucket kernels launched, the TSV finite."""
    from gfasort_tpu_torch.tools.e2e_chromosome import job_argv

    tsv = os.path.join(tmp, "e2e.tsv")
    secs, events, launches, log = cli_step(
        gfa_in, tmp, "e2e", job_argv(E2E_ITER, E2E_LAYOUT_ITER, tsv, "cuda"),
        counts_kept=False)
    for k in ("bucket_apply", "dense_apply_nd", "sweep_sampler",
              "roll_apply", "roll_apply_nd"):
        if launches[k] <= 0:
            raise AssertionError(f"sYgsuL launched no {k} kernel")
    nodes_in = events[0]["nodes"]
    nodes_out = next(e["nodes"] for e in events if e["event"] == "2D layout")
    check_tsv(tsv, nodes_out)
    say("e2e", card_line, pipeline="sYgsuL", iter_max=E2E_ITER,
        layout_iter=E2E_LAYOUT_ITER, nodes_in=nodes_in, nodes_out=nodes_out,
        cli_s=secs, stress=layout_stress(log),
        steps_s={e["event"] + f"#{e['step']}": e["seconds"] for e in events},
        kernel_launches=launches, path_hashes_preserved=True)


def phase_scaling(bench, card_line):
    """``tools/bench_scaling.py`` on 1, 2 and ``SHARDS`` shards of the
    card at its strong-scaling workload (the bench index): one row per
    mesh size.  The shards share one card, so this runs the code; it
    does not measure scaling."""
    from gfasort_tpu_torch.tools.bench_scaling import run_scaling

    rows = run_scaling(SHARDS, device="cuda", workload=lambda nd: bench,
                       reps=SCALING_REPS, part_reps=SCALING_REPS,
                       emit=lambda line: None)
    for row in rows:
        say("scaling", card_line,
            note="shards of one card: exercises the code, not a scaling "
                 "measurement", **row)


# run in a fresh process by phase_bench: the bench twin as
# ``python -m gfasort_tpu_torch.tools.bench --device cuda`` runs it, with
# every kernel counter from 0, then the counts on stderr
_BENCH_PROCESS = """
import json, runpy, sys
import chip_smoke
sys.argv = ["bench", "--device", "cuda"]
chip_smoke.reset_launches()
try:
    runpy.run_module("gfasort_tpu_torch.tools.bench", run_name="__main__")
    rc = 0
except SystemExit as e:
    rc = e.code
print("LAUNCHES " + json.dumps(chip_smoke.read_launches()), file=sys.stderr,
      flush=True)
sys.exit(rc)
"""

# the bench twin's certificates, each with its "ok"
BENCH_CERTS = ("quality", "cli_default", "quality_mode_cert", "nd_layout",
               "nd_layout_3d", "quality_full_schedule")


def phase_bench(card_line):
    """The applied-update counter on the card against the CPU's at the
    100k-node certificate shape, then the bench twin in a subprocess at
    ``BENCH_ENV``: every stdout line parses, the last is complete, every
    certificate passes, the headline is positive and the roofline is
    there; both bucket kernels launched in the twin's run."""
    from gfasort_tpu_torch.bench_util import (measure_applied_frac,
                                              synthetic_path_index)

    pidx = synthetic_path_index(CERT["n_nodes"], CERT["n_paths"],
                                CERT["steps_per_path"], seed=CERT["seed"])
    counts = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        counts[dev] = measure_applied_frac(pidx, rounds=24, device=dev)
        counts[dev + "_s"] = time.perf_counter() - t0
    if counts["cuda"] != counts["cpu"]:
        raise AssertionError(f"the applied-update counter differs: {counts}")
    say("bench", card_line, part="counter", nodes=CERT["n_nodes"],
        steps=pidx.total_steps, counter=counts["cuda"],
        cuda_s=counts["cuda_s"], cpu_s=counts["cpu_s"], equals_cpu=True)
    del pidx

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", _BENCH_PROCESS],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, **BENCH_ENV), capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"the bench twin exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    last = lines[-1]
    bad = [k for k in BENCH_CERTS if not (last[k] or {}).get("ok")]
    if last["partial"] or bad or not last["value"] > 0 or not last["roofline"]:
        raise AssertionError(f"the bench twin's result failed {bad}: {last}")
    tag = [line for line in out.stderr.splitlines()
           if line.startswith("LAUNCHES ")]
    launches = json.loads(tag[-1].split(" ", 1)[1])
    for k in ("bucket_apply", "dense_apply_nd", "sweep_sampler",
              "roll_apply", "roll_apply_nd"):
        if launches[k] <= 0:
            raise AssertionError(f"the bench twin launched no {k} kernel")
    roof = last["roofline"]
    say("bench", card_line, part="twin", knobs=BENCH_ENV, wall_s=secs,
        value=last["value"], vs_baseline=last["vs_baseline"],
        vs_baseline_mt=last["vs_baseline_mt"],
        applied_frac_exact=roof["applied_frac_exact"],
        achieved_bw_frac=roof["achieved_bw_frac"],
        vpu_frac=roof["vpu_frac"], binding=roof["binding"],
        consensus_ms=roof["consensus_ms"], lines=len(lines),
        kernel_launches=launches, result=last)


def kernel_entry(name, source, replaces, launches, cases, main_case,
                 library_ms=None, note=None, routes=None):
    """One entry of the kernels line: the path's launch count and the
    main case's times and bound; the worst error of all cases.
    ``library_ms`` stays None where no single PyTorch call computes the
    function.  ``routes``: the entries of the kernel's other routes (the
    threefry and f64 configurations), each with its own launches."""
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": library_ms, "bound_pipe": main_case["bound_pipe"],
    }
    if note:
        entry["note"] = note
    if routes:
        entry["routes"] = routes
    return entry


def shift_entry(variant, probe):
    """The kernels-line entry of one shift-sum kernel, at the first
    probe size."""
    res = probe[SHIFT_SIZES[0]]
    case = dict(res["variants"][variant], plain_ms=res["plain_ms"],
                bound_ms=res["bound_ms"], bound_by=res["bound_by"],
                bound_pipe=res["bound_pipe"])
    entry = kernel_entry(
        f"shift_sum_{variant}", "gfasort_tpu_torch/csrc/shift_sum.cu",
        "scratch/dense_probe.py:81, scratch/dense_probe.py:116, "
        "scratch/dense_probe.py:152",
        res["launches"][variant],
        {S: r["variants"][variant] for S, r in probe.items()}, case,
        library_ms=res["library_ms"],
        note="no main path runs it: launches counted in the shift_probe "
             "phase's checked calls (the probe's input and its edge "
             "cases); ms: back to back through the wrapper, the host's "
             "launch path at this size; device_ms: the device alone, L2 "
             "cold; library_ms is conv1d with a ones filter, TF32 off")
    entry["device_ms"] = case["device_ms"]
    entry["library_device_ms"] = res["library_device_ms"]
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from gfasort_tpu_torch import kernels
    from gfasort_tpu_torch.bench_util import synthetic_path_index
    from gfasort_tpu_torch.ops.sweep_plan import (make_layout_plan,
                                                  make_sweep_plan)
    from gfasort_tpu_torch.params import LayoutSGDParams, PathSGDParams
    from gfasort_tpu_torch.tools.make_synthetic_gfa import write_synthetic_gfa

    global CLOCK_MHZ
    t_start = time.perf_counter()
    card_line = card()
    CLOCK_MHZ = max_sm_clock_mhz()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    say("clock", card_line, max_sm_clock_mhz=CLOCK_MHZ,
        published_max_sm_clock_mhz=MAX_SM_CLOCK_MHZ,
        bounds_use_mhz=CLOCK_MHZ)

    t0 = time.perf_counter()
    lib_path, log = kernels.build()
    t_build = time.perf_counter() - t0
    kernels.library()
    ptxas = kernels.ptxas_report(log)
    say("build", card_line, seconds=t_build, library=lib_path.name,
        source_seconds=kernels.source_seconds(log), ptxas=ptxas)

    bench = synthetic_path_index(*BENCH_SHAPE, seed=0)
    bench_plan = make_sweep_plan(bench, PathSGDParams().derive_from_graph(bench))
    kres = phase_kernel(bench_plan, bench, card_line)
    nd_plans = {D: make_layout_plan(bench, replace(
        LayoutSGDParams().derive_from_graph(bench, D), iter_max=30))
        for D in (2, 3)}
    kres_nd = phase_kernel_nd(nd_plans, bench.total_steps,
                              bench.step_pos.astype(np.float32), card_line)
    sres, sweep_launches = phase_sweep_apply(bench_plan, bench, card_line)
    plans = {"1d": bench_plan, **nd_plans}
    # the f64 route's plans: every bucket a roll bucket
    plans64 = {1: make_sweep_plan(bench, replace(
        PathSGDParams().derive_from_graph(bench), dtype="float64")),
        2: make_layout_plan(bench, replace(
            LayoutSGDParams().derive_from_graph(bench, 2), iter_max=30,
            dtype="float64"))}
    samp = phase_sampler(bench, plans, card_line, ptxas)
    rres = phase_roll(bench, plans, card_line, ptxas)
    phase_whole_sweep(bench, {1: bench_plan, 2: nd_plans[2]}, card_line)
    phase_whole_sweep(bench, plans64, card_line, "float64")
    phase_sweep_parts(bench, bench_plan, card_line)
    phase_sweep_parts(bench, bench_plan, card_line, rng="threefry")
    phase_sweep_parts(bench, plans64[1], card_line, dtype="float64")
    probe = phase_shift_probe(card_line)
    phase_entry(card_line)

    n, paths, steps = BENCH_SHAPE
    with tempfile.TemporaryDirectory() as tmp:
        gfa_in = os.path.join(tmp, "bench.gfa")
        t0 = time.perf_counter()
        write_synthetic_gfa(gfa_in, n_nodes=n, n_paths=paths,
                            steps_per_path=steps, seed=0)
        say("gen_gfa", card_line, seconds=time.perf_counter() - t0)
        launches = phase_main(gfa_in, tmp, card_line)
        launches_nd = phase_layout(gfa_in, tmp, card_line)
        phase_layout_parts(gfa_in, card_line)
        phase_batched_cli(gfa_in, tmp, card_line)
        phase_server(gfa_in, tmp, card_line)
        phase_e2e(gfa_in, tmp, card_line)
        cert = phase_quality(card_line)
        mode64 = phase_sweep_mode("sweep_f64", bench, cert, card_line,
                                  "float64", "hash")
        mode_tf = phase_sweep_mode("sweep_threefry", bench, cert, card_line,
                                   "float32", "threefry")
        launches_nd64 = phase_layout_f64(bench, card_line)
        x_sharded = phase_sharded_sweep(gfa_in, tmp, bench, cert, card_line)
        phase_sharded_layout(gfa_in, tmp, card_line)
        phase_sharded_batched(gfa_in, tmp, cert, card_line)
        phase_distributed(cert, x_sharded, card_line)
        phase_scaling(bench, card_line)
        del bench
        x_batched = phase_batched(cert, card_line)
        phase_checkpoint(cert, x_batched, tmp, card_line)
    phase_quality_nd(card_line)
    phase_bench(card_line)

    bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
                 or k == "gfasort_tpu" or k.startswith("gfasort_tpu."))
    if bad:
        raise AssertionError(f"the port imported {bad}")
    say("done", card_line, seconds=time.perf_counter() - t_start)
    print(card_line, flush=True)
    print(json.dumps({"kernels": [
        kernel_entry("bucket_apply", "gfasort_tpu_torch/csrc/bucket_apply.cu",
                     "gfasort_tpu/ops/sweep_dense.py:136",
                     launches["bucket_apply"], kres, kres[(0, 12)]),
        kernel_entry("dense_apply_nd",
                     "gfasort_tpu_torch/csrc/dense_apply_nd.cu",
                     "gfasort_tpu/ops/sweep_dense.py:405",
                     launches_nd["dense_apply_nd"], kres_nd,
                     kres_nd[(2, 8, 0)]),
        kernel_entry("sweep_apply", "gfasort_tpu_torch/csrc/sweep_apply.cu",
                     "gfasort_tpu/ops/sweep_pallas.py:52", sweep_launches,
                     sres, sres[(0, "first")],
                     note="no main path runs it: launches counted in the "
                          "sweep_apply phase, one per case (plan phases 0 "
                          "and 1 at the first and the last sweep's eta); "
                          "the times are phase 0's at the first eta"),
        shift_entry("global", probe),
        shift_entry("smem", probe),
        kernel_entry("sweep_sampler",
                     "gfasort_tpu_torch/csrc/sweep_sampler.cu",
                     "gfasort_tpu/ops/sweep_common.py:34-85, "
                     "gfasort_tpu/ops/sweep_common.py:491-566, "
                     "gfasort_tpu/ops/sweep_common.py:249-269",
                     launches["sweep_sampler"] + launches_nd["sweep_sampler"],
                     {k: v for k, v in samp.items() if v["route"] == "hash"},
                     samp["1d"],
                     note=f"XLA fusions, no pallas_call; launches: "
                          f"{launches['sweep_sampler']} in sYgs's Y, "
                          f"{launches_nd['sweep_sampler']} in the 2D L; the "
                          f"times are the 1D plan's (phase 0, P = "
                          f"{samp['1d']['P']}); max_abs_err of int32 words",
                     routes=[
                         kernel_entry(
                             "sweep_sampler:threefry_f32",
                             "gfasort_tpu_torch/csrc/sweep_sampler.cu",
                             "gfasort_tpu/ops/sweep_common.py:62-67",
                             mode_tf["launches"]["sweep_sampler"],
                             {k: v for k, v in samp.items()
                              if v["route"] == "threefry"},
                             samp["1d_threefry"],
                             note="sweep_sampler_tf_kernel<float>; launches "
                                  "in sweep_threefry's full-depth run"),
                         kernel_entry(
                             "sweep_sampler:f64",
                             "gfasort_tpu_torch/csrc/sweep_sampler.cu",
                             "gfasort_tpu/ops/sweep_common.py:62-67",
                             mode64["launches"]["sweep_sampler"],
                             {k: v for k, v in samp.items()
                              if v["route"] == "f64"},
                             samp["1d_f64"],
                             note="sweep_sampler_tf_kernel<double>; launches "
                                  "in sweep_f64's full-depth run")]),
        kernel_entry("roll_apply", "gfasort_tpu_torch/csrc/roll_apply.cu",
                     "gfasort_tpu/ops/sweep.py:328-380",
                     launches["roll_apply"],
                     {k: v for k, v in rres.items()
                      if k[0] == "1d" and v["dtype"] == "float32"},
                     rres[("1d", 0)],
                     note="XLA fusion, no pallas_call; the times are plan "
                          "phase 0's",
                     routes=[kernel_entry(
                         "roll_apply:f64",
                         "gfasort_tpu_torch/csrc/roll_apply.cu",
                         "gfasort_tpu/ops/sweep.py:328-380",
                         mode64["launches"]["roll_apply"],
                         {k: v for k, v in rres.items()
                          if k[0] == "1d" and v["dtype"] == "float64"},
                         rres[("1d", "f64_0")],
                         note="roll_apply_kernel_tiled<NW>; launches in "
                              "sweep_f64's full-depth run; the times are "
                              "plan phase 0's, every bucket rolled")]),
        kernel_entry("roll_apply_nd", "gfasort_tpu_torch/csrc/roll_apply.cu",
                     "gfasort_tpu/ops/sweep_nd.py:105-185",
                     launches_nd["roll_apply_nd"],
                     {k: v for k, v in rres.items()
                      if k[0] != "1d" and v["dtype"] == "float32"},
                     rres[("2d", 0)],
                     note="XLA fusion, no pallas_call; the times are the 2D "
                          "plan's phase 0",
                     routes=[kernel_entry(
                         "roll_apply_nd:f64",
                         "gfasort_tpu_torch/csrc/roll_apply.cu",
                         "gfasort_tpu/ops/sweep_nd.py:105-185",
                         launches_nd64["roll_apply_nd"],
                         {k: v for k, v in rres.items()
                          if k[0] != "1d" and v["dtype"] == "float64"},
                         rres[("2d", "f64_0")],
                         note="roll_apply_nd_kernel_tiled<D, NW>; launches "
                              "in layout_f64's 2D run (iter 30); the times "
                              "are the 2D plan's phase 0, every bucket "
                              "rolled")]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
