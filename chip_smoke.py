#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (they run in the order 1-5, 19, 6-8, 13's CLI run, 20-21, 9,
11-12, 15-18, 22, 13-14, 10); any failed check raises and the script
exits non-zero:

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
5. shift_probe — both shift-sum kernels (global reads, shared-memory
                halo) bit-identical to their plain version, conv1d within
                atol 1e-4, all timed (``tools/dense_probe.run``) at
                S = 4M and at S = 64M, past the 50 MB L2.
6. main       — write the bench-shape GFA (1M nodes, 16 paths x 250k
                steps) and run ``python -m gfasort_tpu_torch -p sYgs``
                (engine auto -> the sweep engine, N > 200k) through
                ``cli.main``; the 1D kernel's launch counter must move,
                every path hash, the node and the edge count must be
                preserved.  A direct engine run on the same graph checks
                that the positions are finite.
7. layout     — ``-p L --dimensions 2`` on the same GFA through
                ``cli.main`` (the nD sweep engine): the nD kernel launches
                once per executed sweep, the TSV holds finite coordinates
                for both ends of every node, the path hashes and the node
                and edge counts are unchanged.
8. layout_parts — the same 2D layout taken apart: the host set-up (path
                index, initial coordinates, plan, consensus tables,
                upload, each on the host clock) and one rotation of sweeps
                with CUDA events around the sampler, the kernel, the roll
                passes and the combine, and one consensus run.
9. quality    — the port's 1D sweep against the sequential oracle on the
                100k-node certificate workload: rank-MAE/N <= 2e-3 and
                Spearman >= 0.999.
10. quality_nd — the port's layout against the C++ oracle on the 20k-node
                layout certificate, 2D and 3D, with the bench's nD knobs:
                stress ratio <= 1.5.
11. sweep_f64 — the 1D sweep at float64 (threefry draws, every bucket a
                roll pass: the plan's kernel buckets must be 0 and the
                bucket kernel must not launch), timed on the bench index
                at full width and SWEEP_MODE_ITER = 30 iterations (cut
                from the bench's 100 to keep the script's time), and its
                order certified on the 100k-node workload against the
                same oracle as ``quality``.
12. sweep_threefry — the same at float32 with ``GFASORT_SWEEP_RNG=
                threefry``: the bucket kernel launches once per executed
                sweep on the bench index; the certificate as above.
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

Then the ``nvidia-smi`` card line, one JSON line describing every kernel,
and ``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero
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

from gfasort_tpu_torch.bench_util import (BENCH_SHAPE, bench_layout_coords,
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
# published H100 SXM peaks: HBM bytes/s and f32 operations/s (no tensor
# cores)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def bound_ms(S: int, words_in: int, words_out: int, f32_ops_per_step: int):
    """The least time the card could take: the larger of the bytes
    (each input word read once, each output word written once) over the
    HBM rate and the f32 operations over the f32 peak.  Returns
    (ms, "bytes" or "operations")."""
    t_bytes = 4.0 * S * (words_in + words_out) / HBM_BYTES_S
    t_ops = float(S) * f32_ops_per_step / F32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def n_words(P: int) -> int:
    return 1 if P == 1 else -(-P // 4)


def ops_1d(P: int, n_buckets: int) -> int:
    """f32 arithmetic ops per step of the 1D spec, per bucket and sign:
    P weight adds, |pos - pos_o|, eta / safe, min, xs - xs_o,
    mu * (mag - safe) * half_sgn (3), dsum -= w * r (2), csum += w;
    selects and integer compares are not counted."""
    return 2 * n_buckets * (P + 10)


def ops_nd(D: int, P: int, n_buckets: int) -> int:
    """f32 arithmetic ops per step of the nD spec, per bucket and sign:
    P weight adds, |pos - pos_o|, eta / safe, min, D deltas, mag^2
    (2D - 1), sqrt, 1 / sqrt, mag, r (sub, 3 muls, min), w * r,
    acc -= wr * delta (2D), wacc += w."""
    return 2 * n_buckets * (P + 5 * D + 13)


def ops_fused(K: int) -> int:
    """f32 arithmetic ops per padded step of the fused spec: per bucket
    and sign |pos - pos_o|, eta / safe, min, xs - xs_o, mag - safe,
    mu * (.), / 2, / mag, * dx, -w * r (10); per bucket the two pair
    sums and the two accumulations (4); then max, divide and add (3)."""
    return 24 * K + 3


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def say(phase: str, card_line: str | None = None, **nums) -> None:
    rec = {"phase": phase, **nums}
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
            bms, by = bound_ms(S, 2 + n_words(P), 2, ops_1d(P, len(buckets)))
            rec = dict(S=S, P=P, buckets=[list(b) for b in buckets],
                       max_abs_err=float(err.max()),
                       bit_identical=bool(torch.equal(d_k, d_r)),
                       ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
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
            bms, by = bound_ms(S, 1 + n_words(P) + D, D + 1,
                               ops_nd(D, P, len(buckets)))
            rec = dict(S=S, D=D, P=P, buckets=[list(b) for b in buckets],
                       max_abs_err=float(err.max()),
                       bit_identical=bool(torch.equal(a_k, a_r)),
                       ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            results[(D, P, ph_i)] = rec
            say("kernel_nd", card_line, phase_of_plan=ph_i, **rec)
            del words, a_k, w_k, a_r, w_r, err
        del my_c
    torch.cuda.empty_cache()
    return results


def reset_launches() -> None:
    from gfasort_tpu_torch.ops import shift_sum, sweep_dense, sweep_fused

    sweep_dense.bucket_apply.launches = 0
    sweep_dense.dense_apply_nd.launches = 0
    sweep_fused.sweep_apply.launches = 0
    for v in shift_sum.VARIANTS:
        shift_sum.shift_sum.launches[v] = 0


def read_launches() -> dict:
    from gfasort_tpu_torch.ops import shift_sum, sweep_dense, sweep_fused

    return {"bucket_apply": sweep_dense.bucket_apply.launches,
            "dense_apply_nd": sweep_dense.dense_apply_nd.launches,
            "sweep_apply": sweep_fused.sweep_apply.launches,
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
        bms, by = bound_ms(S_pad, (3 * L + 2 * S_pad) / S_pad, 1,
                           ops_fused(len(offs)))
        rec = dict(S=lay["S"], S_pad=S_pad, H=lay["H"], K=len(offs),
                   offs=list(offs), eta_of=c["eta_of"], eta=eta,
                   kernel_buckets=len(c["phase"].kernel_buckets),
                   roll_buckets=len(c["phase"].roll_buckets),
                   max_abs_err=float(err.max()), bit_identical=True,
                   ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   split_ms=split_ms)
        results[(c["phase_of_plan"], c["eta_of"])] = rec
        say("sweep_apply", card_line, phase_of_plan=c["phase_of_plan"], **rec)
        del ref, err
    del cases, outs
    torch.cuda.empty_cache()
    return results, launches


def phase_shift_probe(card_line):
    """Both shift-sum kernels checked and timed by the probe tool at each
    of ``SHIFT_SIZES``; the launches are those of the first size's
    checked calls."""
    from gfasort_tpu_torch.tools import dense_probe

    results = {}
    for S in SHIFT_SIZES:
        reset_launches()
        res = dense_probe.run(S, "cuda")
        bms, by = bound_ms(S, 1, 1, 2 * res["halo"])
        res.update(bound_ms=bms, bound_by=by)
        if any(n < 1 for n in res["launches"].values()):
            raise AssertionError(f"a shift-sum kernel never launched: "
                                 f"{res['launches']}")
        results[S] = res
        say("shift_probe", card_line, **res)
        torch.cuda.empty_cache()
    return results


@functools.lru_cache(maxsize=None)
def gfa_truth(gfa_in):
    """(path hashes, (nodes, edges)) of the GFA at ``gfa_in``."""
    from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast

    g = load_gfa_numeric_fast(gfa_in)
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
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast
    from gfasort_tpu_torch.ops.sweep import path_linear_sgd_sweep
    from gfasort_tpu_torch.ops.sweep_plan import make_sweep_plan
    from gfasort_tpu_torch.params import YgsParams

    g0 = load_gfa_numeric_fast(gfa_in)
    nodes0, edges0 = g0.node_count(), len(g0.edges)
    pidx = PathIndex.from_graph(g0)
    params = replace(YgsParams.from_graph(g0).path_sgd, iter_max=100)
    plan = make_sweep_plan(pidx, params)

    t_cli, events, launches, _ = cli_step(gfa_in, tmp, "sorted",
                                          ["-p", "sYgs"])
    if launches["bucket_apply"] <= 0:
        raise AssertionError("the main path launched no bucket-apply kernel")
    y_s = step_seconds(events, "SGD")

    # positions of the same engine on the same graph, read back
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = path_linear_sgd_sweep(g0, params, pidx, device="cuda")
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
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast
    from gfasort_tpu_torch.ops.sweep_plan import make_layout_plan
    from gfasort_tpu_torch.params import LayoutSGDParams

    tsv = os.path.join(tmp, "layout.tsv")
    pidx = PathIndex.from_graph(load_gfa_numeric_fast(gfa_in))
    nodes0 = pidx.num_nodes
    lp = replace(LayoutSGDParams().derive_from_graph(pidx, 2), iter_max=30)
    plan = make_layout_plan(pidx, lp)
    del pidx

    t_cli, events, launches, log = cli_step(
        gfa_in, tmp, "layout",
        ["-p", "L", "--dimensions", "2", "--layout-out", tsv])
    if launches["dense_apply_nd"] != plan.n_exec:
        raise AssertionError(f"{launches['dense_apply_nd']} nD kernel launches, "
                             f"expected one per executed sweep ({plan.n_exec})")
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
    in the same order as ``ops.sweep_nd.nd_sweep_once``."""
    import itertools

    from gfasort_tpu_torch.convert import layout_state, layout_static_arrays
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast
    from gfasort_tpu_torch.ops.exact import layout_initial_coords
    from gfasort_tpu_torch.ops.keys import key_data, sweep_key_table
    from gfasort_tpu_torch.ops.node_sum import build_gather_consensus
    from gfasort_tpu_torch.ops.sweep_common import (pack_choices_words,
                                                    sample_blocks,
                                                    sampler_consts, sweep_rng)
    from gfasort_tpu_torch.ops.sweep_dense import dense_apply_nd
    from gfasort_tpu_torch.ops.sweep_nd import _roll_half_nd, nd_sweep_once
    from gfasort_tpu_torch.ops.sweep_plan import make_layout_plan
    from gfasort_tpu_torch.params import LayoutSGDParams

    dev = torch.device("cuda")
    host = {}
    g = load_gfa_numeric_fast(gfa_in)
    t0 = time.perf_counter()
    pidx = PathIndex.from_graph(g)
    host["path_index_s"] = time.perf_counter() - t0
    del g
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
        first = sweep_rng(keys[e][0], S, dev)
        rest = (sweep_rng(w, S, dev) for w in keys[e][1:])
        sidxs = sample_blocks(consts[i][cooling], itertools.chain([first], rest),
                              cooling, rank, cnt, plan.active_frac)
        other_end = ((first[0] >> 29) & 1) == 1
        my_pos = torch.where(other_end, pos + length, pos)
        lane0 = torch.where(other_end, 1 - rev, rev) == 0
        my_c = torch.where(lane0, cs[:D], cs[D:])
        words = sidxs[:1] if P == 1 else pack_choices_words(sidxs)
        ev[1].record()
        acc, wacc = dense_apply_nd(my_pos, words, my_c, eta,
                                   phase.kernel_buckets, P)
        ev[2].record()
        iota = torch.arange(S, device=dev)
        eta_t = torch.full((), eta, dtype=cs.dtype, device=dev)
        for k, ki in phase.roll_buckets:
            d1, w1 = _roll_half_nd(my_pos, my_c, eta_t, -k, [
                (s == ki, torch.roll(s, -k) == ~ki) for s in sidxs], iota)
            d2, w2 = _roll_half_nd(my_pos, my_c, eta_t, +k, [
                (s == ~ki, torch.roll(s, k) == ki) for s in sidxs], iota)
            acc = acc + d1 + d2
            wacc = wacc + w1 + w2
        ev[3].record()
        upd = acc / torch.clamp_min(wacc, 1.0)
        out = torch.cat([cs[:D] + torch.where(lane0, upd, 0.0),
                         cs[D:] + torch.where(lane0, 0.0, upd)])
        ev[4].record()
        return out

    def whole(e, cs):
        i, eta, cooling = plan.sweep(e)
        return nd_sweep_once(cs, pos, rank, cnt, rev, length, plan.phases[i],
                             consts[i][cooling], keys[e], eta, cooling, P,
                             plan.active_frac)

    # warm-up, then the parts and the whole sweep on the same sweeps
    cs_a = whole(0, cs)
    cs_b = run_parts(0, cs, [torch.cuda.Event(enable_timing=True)
                             for _ in range(5)])
    torch.cuda.synchronize()
    if not torch.equal(cs_a, cs_b):
        raise AssertionError("the timed parts differ from nd_sweep_once")
    names = ("sampler", "kernel", "roll_passes", "combine")
    parts = dict.fromkeys(names, 0.0)
    cs_p = cs
    for e in range(n_sweeps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
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


def phase_sweep_mode(phase, bench, cert, card_line, dtype, rng):
    """The 1D sweep engine at ``dtype`` with ``GFASORT_SWEEP_RNG=rng``:
    timed on the bench index (a direct engine call, host set-up
    included), with the bucket kernel's launches counted from 0 around
    it, then certified on the certificate workload."""
    from gfasort_tpu_torch.ops.sweep import path_linear_sgd_sweep
    from gfasort_tpu_torch.ops.sweep_plan import make_sweep_plan
    from gfasort_tpu_torch.params import PathSGDParams

    old = os.environ.get("GFASORT_SWEEP_RNG")
    os.environ["GFASORT_SWEEP_RNG"] = rng
    try:
        p = replace(PathSGDParams().derive_from_graph(bench), dtype=dtype,
                    iter_max=SWEEP_MODE_ITER)
        plan = make_sweep_plan(bench, p)
        kernel_buckets = sum(len(ph.kernel_buckets) for ph in plan.phases)
        roll_buckets = sum(len(ph.roll_buckets) for ph in plan.phases)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = path_linear_sgd_sweep(None, p, bench, device="cuda")
        secs = time.perf_counter() - t0
        launches = read_launches()
        if x.shape != (bench.num_nodes,) or not np.isfinite(x).all():
            raise AssertionError(f"{phase}: positions not finite [N]")
        want = 0 if dtype == "float64" else plan.n_exec
        if dtype == "float64" and kernel_buckets:
            raise AssertionError(f"{phase}: {kernel_buckets} kernel buckets")
        if launches["bucket_apply"] != want:
            raise AssertionError(f"{phase}: {launches['bucket_apply']} bucket "
                                 f"kernel launches, expected {want}")
        updates = plan.n_sweeps * plan.updates_per_sweep
        say(phase, card_line, part="bench", dtype=dtype, rng=plan.knobs.rng,
            iter_max=SWEEP_MODE_ITER, nodes=bench.num_nodes, steps=bench.total_steps, engine_s=secs,
            n_sweeps=plan.n_sweeps, exec_sweeps=plan.n_exec,
            proposals=plan.proposals, kernel_buckets=kernel_buckets,
            roll_buckets=roll_buckets, updates=updates,
            pair_updates_per_s_engine=updates / secs,
            kernel_launches=launches)
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


def phase_batched_cli(gfa_in, tmp, card_line):
    """``-p Y --engine batched`` on the bench GFA through the CLI at its
    default schedule; every kernel counter read from 0 around it (the
    batched path runs no hand-written kernel)."""
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast
    from gfasort_tpu_torch.ops.sgd import (build_schedule, effective_batch,
                                           path_linear_sgd_batched)
    from gfasort_tpu_torch.params import YgsParams

    g0 = load_gfa_numeric_fast(gfa_in)
    nodes0 = g0.node_count()
    pidx = PathIndex.from_graph(g0)
    params = replace(YgsParams.from_graph(g0).path_sgd,
                     iter_max=BATCHED_CLI_ITER)
    B = effective_batch(params)
    n_rounds = build_schedule(params, B)[3]
    del g0

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
    from gfasort_tpu_torch.bench_util import layout_quality_vs_oracle

    for dims in (2, 3):
        t0 = time.perf_counter()
        q = layout_quality_vs_oracle(dims=dims, device="cuda", **ND_CERT_KW)
        if q is None:
            raise AssertionError("the C++ layout oracle cannot be built")
        ok = q["ratio"] <= STRESS_RATIO_MAX
        say("quality_nd", card_line, seconds=time.perf_counter() - t0,
            passed=ok, **ND_CERT_KW, **q)
        if not ok:
            raise AssertionError(f"layout certificate failed: {q}")


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
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast
    from gfasort_tpu_torch.ops.sweep_plan import make_sharded_sweep_plan
    from gfasort_tpu_torch.parallel import (default_mesh,
                                            path_linear_sgd_sweep_sharded)
    from gfasort_tpu_torch.params import PathSGDParams, YgsParams

    g0 = load_gfa_numeric_fast(gfa_in)
    pidx = PathIndex.from_graph(g0)
    params = replace(YgsParams.from_graph(g0).path_sgd,
                     iter_max=SWEEP_MODE_ITER)
    del g0
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
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast
    from gfasort_tpu_torch.ops.sweep_plan import make_sharded_layout_plan
    from gfasort_tpu_torch.parallel import default_mesh
    from gfasort_tpu_torch.params import LayoutSGDParams

    pidx = PathIndex.from_graph(load_gfa_numeric_fast(gfa_in))
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
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast
    from gfasort_tpu_torch.ops.sgd import build_schedule, effective_batch
    from gfasort_tpu_torch.parallel import default_mesh, path_linear_sgd_sharded
    from gfasort_tpu_torch.params import YgsParams

    g0 = load_gfa_numeric_fast(gfa_in)
    params = replace(YgsParams.from_graph(g0).path_sgd,
                     iter_max=BATCHED_CLI_ITER)
    del g0
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
    for k in ("bucket_apply", "dense_apply_nd"):
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


def kernel_entry(name, source, replaces, launches, cases, main_case,
                 library_ms=None, note=None):
    """One entry of the kernels line: the path's launch count and the
    main case's times and bound; the worst error of all cases.
    ``library_ms`` stays None where no single PyTorch call computes the
    function."""
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": library_ms,
    }
    if note:
        entry["note"] = note
    return entry


def shift_entry(variant, probe):
    """The kernels-line entry of one shift-sum kernel, at the first
    probe size."""
    res = probe[SHIFT_SIZES[0]]
    case = dict(res["variants"][variant], plain_ms=res["plain_ms"],
                bound_ms=res["bound_ms"], bound_by=res["bound_by"])
    return kernel_entry(
        f"shift_sum_{variant}", "gfasort_tpu_torch/csrc/shift_sum.cu",
        "scratch/dense_probe.py:81, scratch/dense_probe.py:116, "
        "scratch/dense_probe.py:152",
        res["launches"][variant],
        {S: r["variants"][variant] for S, r in probe.items()}, case,
        library_ms=res["library_ms"],
        note="no main path runs it: launches counted in the shift_probe "
             "phase's checked calls; library_ms is conv1d with a ones "
             "filter, TF32 off")


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

    t_start = time.perf_counter()
    card_line = card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    lib_path, log = kernels.build()
    t_build = time.perf_counter() - t0
    kernels.library()
    say("build", card_line, seconds=t_build, library=lib_path.name,
        ptxas=kernels.ptxas_report(log))

    bench = synthetic_path_index(*BENCH_SHAPE, seed=0)
    bench_plan = make_sweep_plan(bench, PathSGDParams().derive_from_graph(bench))
    kres = phase_kernel(bench_plan, bench, card_line)
    nd_plans = {D: make_layout_plan(bench, replace(
        LayoutSGDParams().derive_from_graph(bench, D), iter_max=30))
        for D in (2, 3)}
    kres_nd = phase_kernel_nd(nd_plans, bench.total_steps,
                              bench.step_pos.astype(np.float32), card_line)
    sres, sweep_launches = phase_sweep_apply(bench_plan, bench, card_line)
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
        phase_sweep_mode("sweep_f64", bench, cert, card_line, "float64",
                         "hash")
        phase_sweep_mode("sweep_threefry", bench, cert, card_line, "float32",
                         "threefry")
        x_sharded = phase_sharded_sweep(gfa_in, tmp, bench, cert, card_line)
        phase_sharded_layout(gfa_in, tmp, card_line)
        phase_sharded_batched(gfa_in, tmp, cert, card_line)
        phase_distributed(cert, x_sharded, card_line)
        phase_scaling(bench, card_line)
        del bench
        x_batched = phase_batched(cert, card_line)
        phase_checkpoint(cert, x_batched, tmp, card_line)
    phase_quality_nd(card_line)

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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
