#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. build      — compile the hand-written CUDA kernels from ``csrc/``, one
                ``nvcc`` per source, all at once (timed).
2. kernel     — the 1D bucket-apply kernel against its plain PyTorch
                version on the card, at S = 4M steps with the bench-shape
                plan's phase-0 and phase-1 bucket lists, P = 12 (3 packed
                words) and P = 1: csum exact, dsum within rtol 2e-5 /
                atol 1e-4; both timed.
3. kernel_nd  — the nD bucket-apply kernel against its plain version at
                S = 4M with the bench-shape layout plans' phase-0 and
                phase-1 kernel bucket lists: D = 2 with P = 8 (2 words),
                D = 3 with P = 4 (1 word) and D = 2 with P = 1: wacc
                exact, acc within rtol 2e-5 / atol 1e-4; both timed.
4. sweep_apply — the fused sweep apply (all buckets of an offset set in
                one pass, rank/cnt guards, the combine) on the bench
                index at S = 4M with its real rank and cnt, over the full
                offset sets of the bench plan's phases 0 and 1, P = 1:
                one launch per phase counted, each held within rtol 2e-5
                / atol 1e-4 of its plain version; kernel, plain version
                and the port's split apply of the same offsets (bucket
                kernel + roll passes + combine) timed.
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

Then the ``nvidia-smi`` card line, one JSON line describing every kernel,
and ``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero
with no result when CUDA is not available.  Neither JAX nor the JAX
package ``gfasort_tpu`` is imported.
"""

from __future__ import annotations

import contextlib
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

from gfasort_tpu_torch.bench_util import cuda_ms

S_BENCH = (1_000_000, 16, 250_000)       # nodes, paths, steps per path
CERT = dict(n_nodes=100_000, n_paths=4, steps_per_path=100_000, seed=7,
            iter_max=30)
CERT_SMALL = dict(n_nodes=5_000, n_paths=4, steps_per_path=5_000, seed=7,
                  iter_max=30)
RANK_MAE_MAX = 2e-3
SPEARMAN_MIN = 0.999
STRESS_RATIO_MAX = 1.5
DSUM_RTOL, DSUM_ATOL = 2e-5, 1e-4
# shift-sum probe sizes: multiples of the TPU probes' 64k block; the
# larger one exceeds the card's 50 MB L2 cache
SHIFT_SIZES = (1 << 22, 1 << 26)
# the bench's nD knobs (ce 48, rotate 12, frac 1.0, dense_upto 4, P 8)
ND_CERT_KW = dict(consensus_every=48, rotate=12, active_frac=1.0,
                  dense_upto=4, proposals=8)
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


def contract_choices(rng, S, buckets, P):
    """Random choice words that obey the sampler contract: every +k / -k
    choice stays inside the array (as in tests/test_sweep_dense.py)."""
    from gfasort_tpu_torch.ops.sweep_common import INACTIVE, pack_choices_words

    kis = [ki for _, ki in buckets]
    iota = np.arange(S)
    pool = np.array(kis + [~ki for ki in kis] + [int(INACTIVE)], np.int32)

    def draw():
        s = pool[rng.integers(0, len(pool), S)]
        for k, ki in buckets:
            s = np.where((s == ki) & (iota + k >= S), INACTIVE, s)
            s = np.where((s == ~ki) & (iota - k < 0), INACTIVE, s)
        return torch.from_numpy(s.astype(np.int32))

    if P == 1:
        return [draw()]
    return pack_choices_words([draw() for _ in range(P)])


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
            bound = DSUM_ATOL + DSUM_RTOL * d_r.abs()
            if not bool((err <= bound).all()):
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
    for D, P in ((2, 8), (3, 4), (2, 1)):
        plan = plans[D]
        # layout coordinates at the bench's scale (x ~ path position,
        # the other dimensions ~ N(0, 2N)); a few coincident ones hit
        # the zero guard
        c_np = (rng.standard_normal((D, S)) * 1414.0).astype(np.float32)
        c_np[0] = pos_np + rng.standard_normal(S).astype(np.float32)
        c_np[:, 7::1001] = c_np[:, 8::1001][:, :c_np[:, 7::1001].shape[1]]
        my_c = torch.from_numpy(c_np).to(dev)
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
            bound = DSUM_ATOL + DSUM_RTOL * a_r.abs()
            if not bool((err <= bound).all()):
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
            del words, a_k, w_k, a_r, w_r, err, bound
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
    (P = 1, the index's real rank and cnt): one launch per phase counted,
    each held against its plain version, then timed beside the plain
    version and the port's split apply of the same offsets."""
    import torch.nn.functional as F

    from gfasort_tpu_torch.ops.sweep import apply_choices
    from gfasort_tpu_torch.ops.sweep_fused import (build_sweep_apply,
                                                   pad_sidx, pad_state,
                                                   pad_static,
                                                   sweep_apply_ref)

    dev = torch.device("cuda")
    S = pidx.total_steps
    rng = np.random.default_rng(2)
    xs = torch.from_numpy((rng.standard_normal(S) * 100).astype(np.float32)).to(dev)
    pos_np = pidx.step_pos.astype(np.float32)
    pos = torch.from_numpy(pos_np).to(dev)
    rank = torch.from_numpy(pidx.step_rank.astype(np.int32)).to(dev)
    cnt = torch.from_numpy(pidx.step_count_of_step.astype(np.int32)).to(dev)
    eta = float(plan.sweep_eta[0])
    cases = []
    for ph_i in (0, 1):
        phase = plan.phases[ph_i]
        buckets = [(int(k), ki) for ki, k in enumerate(phase.offs)]
        sidx = contract_choices(rng, S, buckets, 1)[0].to(dev)
        apply_fn, lay = build_sweep_apply(phase.offs, S)
        tail = (0, lay["S_pad"] - S)
        args = (pad_state(xs, lay),
                torch.from_numpy(pad_static(pos_np, lay)).to(dev),
                pad_sidx(sidx, lay), F.pad(rank, tail), F.pad(cnt, tail), eta)
        cases.append((ph_i, phase, sidx, apply_fn, lay, args))

    # the kernel's own path: one fused apply per plan phase
    reset_launches()
    outs = [apply_fn(*args) for _, _, _, apply_fn, _, args in cases]
    torch.cuda.synchronize()
    launches = read_launches()["sweep_apply"]
    if launches != len(cases):
        raise AssertionError(f"{launches} fused apply launches, expected "
                             f"{len(cases)}")

    results = {}
    for (ph_i, phase, sidx, apply_fn, lay, args), out in zip(cases, outs):
        offs = tuple(int(k) for k in phase.offs)
        flat = [a.reshape(-1) for a in args[:5]]
        ref = sweep_apply_ref(*flat, eta, offs, lay["H"])
        torch.cuda.synchronize()
        if out.shape != (lay["S_pad"],) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"fused apply output not finite [S_pad] "
                                 f"(phase {ph_i})")
        err = (out - ref).abs()
        bound = DSUM_ATOL + DSUM_RTOL * ref.abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"fused apply off by {float(err.max())} "
                                 f"(phase {ph_i})")
        ms = cuda_ms(lambda: apply_fn(*args))
        plain_ms = cuda_ms(lambda: sweep_apply_ref(*flat, eta, offs,
                                                   lay["H"]), 3)
        split_ms = cuda_ms(lambda: apply_choices(xs, pos, [sidx], phase,
                                                 eta, 1))
        S_pad, L = lay["S_pad"], lay["L"]
        # each input read once (xs, pos, sidx padded to L; rank, cnt),
        # the output written once
        bms, by = bound_ms(S_pad, (3 * L + 2 * S_pad) / S_pad, 1,
                           ops_fused(len(offs)))
        rec = dict(S=S, S_pad=S_pad, H=lay["H"], K=len(offs), offs=list(offs),
                   kernel_buckets=len(phase.kernel_buckets),
                   roll_buckets=len(phase.roll_buckets),
                   max_abs_err=float(err.max()),
                   bit_identical=bool(torch.equal(out, ref)),
                   ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   split_ms=split_ms)
        results[ph_i] = rec
        say("sweep_apply", card_line, phase_of_plan=ph_i, **rec)
        del ref, err, bound
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


def phase_main(gfa_in, tmp, card_line):
    from gfasort_tpu_torch import cli
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast
    from gfasort_tpu_torch.ops.sweep import path_linear_sgd_sweep
    from gfasort_tpu_torch.ops.sweep_plan import make_sweep_plan
    from gfasort_tpu_torch.params import YgsParams

    gfa_out = os.path.join(tmp, "sorted.gfa")
    trace = os.path.join(tmp, "steps.jsonl")
    g0 = load_gfa_numeric_fast(gfa_in)
    hashes0 = g0.compute_all_path_hashes()
    nodes0, edges0 = g0.node_count(), len(g0.edges)
    pidx = PathIndex.from_graph(g0)
    params = replace(YgsParams.from_graph(g0).path_sgd, iter_max=100)
    plan = make_sweep_plan(pidx, params)

    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["-i", gfa_in, "-o", gfa_out, "-p", "sYgs",
                   "--trace-out", trace, "-v", "0"])
    t_cli = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    if launches["bucket_apply"] <= 0:
        raise AssertionError("the main path launched no bucket-apply kernel")
    with open(trace) as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    y_s = next(e["seconds"] for e in events if e["event"] == "SGD")
    g1 = load_gfa_numeric_fast(gfa_out)
    if g1.compute_all_path_hashes() != hashes0:
        raise AssertionError("path hashes changed")
    if (g1.node_count(), len(g1.edges)) != (nodes0, edges0):
        raise AssertionError("node or edge count changed")

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


def phase_layout(gfa_in, tmp, card_line):
    """``-p L --dimensions 2`` through the CLI on the bench GFA."""
    from gfasort_tpu_torch import cli
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.io.fast_gfa import load_gfa_numeric_fast
    from gfasort_tpu_torch.ops.sweep_plan import make_layout_plan
    from gfasort_tpu_torch.params import LayoutSGDParams

    gfa_out = os.path.join(tmp, "layout.gfa")
    tsv = os.path.join(tmp, "layout.tsv")
    trace = os.path.join(tmp, "layout_steps.jsonl")
    g0 = load_gfa_numeric_fast(gfa_in)
    hashes0 = g0.compute_all_path_hashes()
    nodes0, edges0 = g0.node_count(), len(g0.edges)
    pidx = PathIndex.from_graph(g0)
    lp = replace(LayoutSGDParams().derive_from_graph(pidx, 2), iter_max=30)
    plan = make_layout_plan(pidx, lp)
    del g0, pidx

    log = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        rc = cli.main(["-i", gfa_in, "-o", gfa_out, "-p", "L",
                       "--dimensions", "2", "--layout-out", tsv,
                       "--trace-out", trace, "-v", "1"])
    t_cli = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}:\n{log.getvalue()}")
    if launches["dense_apply_nd"] != plan.n_exec:
        raise AssertionError(f"{launches['dense_apply_nd']} nD kernel launches, "
                             f"expected one per executed sweep ({plan.n_exec})")
    m = re.search(r"layout stress: ([0-9.eE+-]+|nan|inf)", log.getvalue())
    if m is None:
        raise AssertionError("the CLI printed no layout stress")
    stress = float(m.group(1))
    with open(trace) as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    l_s = next(e["seconds"] for e in events if e["event"] == "2D layout")
    with open(tsv) as fh:
        vals = np.array(fh.read().split()[5:], dtype=np.float64).reshape(-1, 5)
    if vals.shape[0] != nodes0 or not np.array_equal(vals[:, 0],
                                                     np.arange(nodes0)):
        raise AssertionError(f"the TSV holds {vals.shape[0]} rows, "
                             f"expected {nodes0}")
    if not np.isfinite(vals[:, 1:]).all():
        raise AssertionError("the TSV holds non-finite coordinates")
    g1 = load_gfa_numeric_fast(gfa_out)
    if g1.compute_all_path_hashes() != hashes0:
        raise AssertionError("path hashes changed")
    if (g1.node_count(), len(g1.edges)) != (nodes0, edges0):
        raise AssertionError("node or edge count changed")
    if not np.isfinite(stress) or stress <= 0:
        raise AssertionError(f"layout stress {stress}")
    updates = plan.n_sweeps * plan.updates_per_sweep
    say("layout", card_line, dims=2, nodes=nodes0, cli_s=t_cli,
        layout_step_s=l_s, stress=stress, n_sweeps=plan.n_sweeps,
        exec_sweeps=plan.n_exec, proposals=plan.proposals,
        consensus_every=plan.consensus_every, updates=updates,
        pair_updates_per_s_step=updates / l_s, kernel_launches=launches,
        tsv_rows=int(vals.shape[0]), path_hashes_preserved=True)
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
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", card_line, seconds=t_build, library=lib_path.name,
        ptxas=ptxas)

    bench = synthetic_path_index(*S_BENCH, seed=0)
    bench_plan = make_sweep_plan(bench, PathSGDParams().derive_from_graph(bench))
    kres = phase_kernel(bench_plan, bench, card_line)
    nd_plans = {D: make_layout_plan(bench, replace(
        LayoutSGDParams().derive_from_graph(bench, D), iter_max=30))
        for D in (2, 3)}
    kres_nd = phase_kernel_nd(nd_plans, bench.total_steps,
                              bench.step_pos.astype(np.float32), card_line)
    sres, sweep_launches = phase_sweep_apply(bench_plan, bench, card_line)
    del bench
    probe = phase_shift_probe(card_line)

    n, paths, steps = S_BENCH
    with tempfile.TemporaryDirectory() as tmp:
        gfa_in = os.path.join(tmp, "bench.gfa")
        t0 = time.perf_counter()
        write_synthetic_gfa(gfa_in, n_nodes=n, n_paths=paths,
                            steps_per_path=steps, seed=0)
        say("gen_gfa", card_line, seconds=time.perf_counter() - t0)
        launches = phase_main(gfa_in, tmp, card_line)
        launches_nd = phase_layout(gfa_in, tmp, card_line)
        phase_layout_parts(gfa_in, card_line)
    phase_quality(card_line)
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
                     sres, sres[0],
                     note="no main path runs it: launches counted in the "
                          "sweep_apply phase, one per plan phase"),
        shift_entry("global", probe),
        shift_entry("smem", probe),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
