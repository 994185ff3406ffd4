"""Headline benchmark of the port (counterpart of ``bench.py``): SGD
pair-updates/s on one device, self-certifying, emitting the full result
JSON after every section so that the last stdout line is always the most
complete parsable artifact (fields not yet measured are null).

    python -m gfasort_tpu_torch.tools.bench [--device cuda|cpu]

Sections, in ``bench.py``'s order:

  1. CPU oracle baselines (the C++ loop, one thread and all cores)
  2. sweep 1D throughput mode (``THROUGHPUT_CFG``): the headline
  3. its certificate against the C++ oracle (rank-MAE / Spearman)
  4. the CLI default (no knobs): certificate and rate at the bench shape
  5. sweep 1D quality mode (``QUALITY_CFG``, ce 8): rate and certificate
  6. 2D layout sweep rate  7. 3D layout sweep rate
  8. layout stress certificates against the oracle, 2D and 3D
  9. roofline: modelled HBM bytes and f32 operations per update against
     the H100 peaks, the gather consensus's measured time, and the
     exact applied-update fraction
 10. the gather consensus forced, and the shuffled-id workload: the port
     has only the gather consensus, so ``gather_rate`` is the engine
     under ``GFASORT_CONSENSUS=gather``, ``auto_selected`` is
     ``"gather"`` and ``shuffled_coverage`` is null
 11. the full-schedule (iter_max 100) certificate of the CLI default

The same environment knobs as ``bench.py``: ``BENCH_NODES``,
``BENCH_PATHS``, ``BENCH_STEPS_PER_PATH``, ``BENCH_ROUNDS``,
``BENCH_FULL``, ``BENCH_CERT_NODES``, ``BENCH_CERT_LAYOUT_NODES``,
``BENCH_QFS_NODES``.  Timed sections report ``warmup_s`` (the first run,
set-up included) apart from the steady rate.  Log lines go to stderr.
Exits 1 only when a 1D certificate's Spearman is below 0.99.  No
section catches an exception and goes on; ``--device cuda`` without a
card raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Workload: 1M nodes, 16 paths x 250k steps = 4M steps
N_NODES = int(os.environ.get("BENCH_NODES", 1_000_000))
N_PATHS = int(os.environ.get("BENCH_PATHS", 16))
STEPS = int(os.environ.get("BENCH_STEPS_PER_PATH", 250_000))
ROUNDS = int(os.environ.get("BENCH_ROUNDS", 96))
FULL = os.environ.get("BENCH_FULL", "0") == "1"

# The sweep configurations of bench.py: quality mode runs the consensus
# every 8 sweeps, throughput mode every 96.
QUALITY_CFG = dict(consensus_every=8, per_octave=2, active_frac=1.0,
                   rotate=8, dense_upto=4, proposals=12)
THROUGHPUT_CFG = dict(consensus_every=96, per_octave=2, active_frac=1.0,
                      rotate=12, dense_upto=4, proposals=12)

# nD layout knobs of bench.py (ce fitted to ROUNDS // 2 in main)
ND_ROT = 12
ND_FRAC = 1.0
ND_DU = 4
ND_P = 8


def _fit_ce(rounds: int, ce: int) -> int:
    """Largest ce' <= ce that divides ``rounds``: the runner pads the
    schedule to whole consensus periods, so a period that does not
    divide the timed sweeps would make the displayed rate undercount."""
    ce = max(1, min(ce, rounds))
    while rounds % ce:
        ce -= 1
    return ce


# certificate thresholds (bench.py)
MAE_FRAC_MAX = 0.002
SPEARMAN_MIN = 0.999
STRESS_RATIO_MAX = 1.5


def _cert(q, finite: bool, digits: int = 6) -> dict:
    """A 1D certificate's rounded fields and its verdict."""
    return {
        "rank_mae_frac": round(q["rank_mae_frac"], 6) if q else None,
        "spearman": round(q["spearman"], digits) if q else None,
        "ok": bool(q is not None and q["rank_mae_frac"] <= MAE_FRAC_MAX
                   and q["spearman"] >= SPEARMAN_MIN and finite),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gfasort_tpu_torch.tools.bench",
        description="the port's headline benchmark (twin of bench.py)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from ..bench_util import (bench_native_1d, bench_native_1d_mt,
                              bench_sweep_1d, bench_sweep_nd,
                              gather_consensus_ms, layout_quality_vs_oracle,
                              measure_applied_frac, roofline_model,
                              shuffled_path_index, sweep_quality_vs_oracle,
                              synthetic_path_index)
    from ..device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import torch

        device_name = torch.cuda.get_device_name(dev)
    else:
        device_name = "cpu"

    def err(*a):
        print(*a, file=sys.stderr, flush=True)

    t_start = time.perf_counter()
    result = {
        "metric": "sgd_pair_updates_per_s_per_chip",
        "value": None,
        "unit": "pair-updates/s",
        "vs_baseline": None,
        "vs_baseline_mt": None,
        "quality_mode_value": None,
        "quality_mode_cert": None,
        "quality": None,
        "cli_default": None,
        "nd_layout": None,
        "nd_layout_3d": None,
        "roofline": None,
        "fallback": None,
        "quality_full_schedule": None,
        "oracle_1t": None,
        "oracle_mt": None,
        "elapsed_s": None,
        "partial": True,
    }

    def emit():
        result["elapsed_s"] = round(time.perf_counter() - t_start, 1)
        print(json.dumps(result), flush=True)

    pidx = synthetic_path_index(N_NODES, N_PATHS, STEPS, seed=0)
    err(f"[bench] workload: {pidx.num_nodes} nodes, {pidx.total_steps} steps, "
        f"{pidx.num_paths} paths; rounds={ROUNDS} full={FULL}; "
        f"device: {device_name}")

    # the consensus periods fitted to the (possibly overridden) protocol
    throughput = dict(THROUGHPUT_CFG)
    quality = dict(QUALITY_CFG)
    for cfg in (throughput, quality):
        fitted = _fit_ce(ROUNDS, cfg["consensus_every"])
        if fitted != cfg["consensus_every"]:
            err(f"[bench] WARNING: consensus_every {cfg['consensus_every']} "
                f"does not divide rounds={ROUNDS}; using {fitted}")
            cfg["consensus_every"] = fitted
    nd_ce = _fit_ce(ROUNDS // 2, 48)
    if nd_ce != 48:
        err(f"[bench] WARNING: nd consensus_every 48 does not divide "
            f"rounds//2={ROUNDS // 2}; using {nd_ce}")
    nd_kw = dict(consensus_every=nd_ce, rotate=ND_ROT, active_frac=ND_FRAC,
                 dense_upto=ND_DU, proposals=ND_P)

    # ---- 1. CPU oracle baselines ----
    cpu = bench_native_1d(pidx, n_updates=2_000_000)
    err(f"[bench] oracle 1-thread baseline: {cpu}")
    cpu_mt = bench_native_1d_mt(workload=(100_000, 4, 100_000),
                                n_updates_each=4_000_000)
    err(f"[bench] oracle all-core baseline: {cpu_mt}")
    rate_1t = cpu["updates_per_s"] if cpu else None
    rate_mt = cpu_mt["updates_per_s"] if cpu_mt else None
    if cpu:
        result["oracle_1t"] = round(rate_1t, 1)
    if cpu_mt:
        result["oracle_mt"] = {"updates_per_s": round(rate_mt, 1),
                               "n_workers": cpu_mt["n_workers"]}

    # ---- 2. headline: sweep 1D throughput mode ----
    head = bench_sweep_1d(pidx, rounds=ROUNDS, repeats=3 if FULL else 2,
                          device=dev, **throughput)
    err(f"[bench] sweep throughput mode "
        f"(ce={throughput['consensus_every']}): {head}")
    result["value"] = round(head["updates_per_s"], 1)
    result["warmup_s"] = round(head["warmup_s"], 1)
    if rate_1t:
        result["vs_baseline"] = round(head["updates_per_s"] / rate_1t, 3)
    if rate_mt:
        result["vs_baseline_mt"] = round(head["updates_per_s"] / rate_mt, 3)
    emit()

    # ---- 3. certificate of the timed throughput config ----
    cn = int(os.environ.get("BENCH_CERT_NODES", 100_000))
    q1 = sweep_quality_vs_oracle(n_nodes=cn, steps_per_path=cn, device=dev,
                                 **throughput)
    err(f"[bench] 1D certification (throughput cfg vs oracle): {q1}")
    result["quality"] = _cert(q1, head["final_finite"])
    if not result["quality"]["ok"]:
        err("[bench] WARNING: 1D throughput-cfg certification FAILED")
    emit()

    # ---- 4. the CLI default: certificate at the cert shape, rate at the
    # bench shape ----
    q_cli = sweep_quality_vs_oracle(n_nodes=cn, steps_per_path=cn, device=dev)
    err(f"[bench] 1D certification (CLI-default auto-config): {q_cli}")
    cli_rate = bench_sweep_1d(pidx, rounds=ROUNDS, repeats=1, device=dev)
    err(f"[bench] CLI-default rate at bench shape: {cli_rate}")
    cli = _cert(q_cli, cli_rate["final_finite"])
    result["cli_default"] = {
        "rank_mae_frac": cli["rank_mae_frac"],
        "spearman": cli["spearman"],
        "rate": round(cli_rate["updates_per_s"], 1),
        "config": {
            "active_frac": cli_rate["active_frac"],
            "consensus_every": cli_rate["consensus_every_eff"],
            "rotate": cli_rate["rotate_eff"],
        },
        "ok": cli["ok"],
    }
    if not cli["ok"]:
        err("[bench] WARNING: CLI-default certification FAILED")
    emit()

    # ---- 5. quality mode (ce 8): rate and its own certificate ----
    qm = bench_sweep_1d(pidx, rounds=ROUNDS, repeats=3 if FULL else 1,
                        device=dev, **quality)
    err(f"[bench] sweep quality mode (ce={quality['consensus_every']}): {qm}")
    result["quality_mode_value"] = round(qm["updates_per_s"], 1)
    qq = sweep_quality_vs_oracle(n_nodes=cn, steps_per_path=cn, device=dev,
                                 **quality)
    err(f"[bench] quality-mode certification: {qq}")
    result["quality_mode_cert"] = _cert(qq, qm["final_finite"])
    emit()

    # ---- 6-7. nD layout rates ----
    nds = {}
    for dims, key in ((2, "nd_layout"), (3, "nd_layout_3d")):
        nd = bench_sweep_nd(pidx, dims=dims, rounds=ROUNDS // 2,
                            repeats=2 if FULL else 1, device=dev, **nd_kw)
        err(f"[bench] {dims}D layout sweep: {nd}")
        nds[dims] = nd
        result[key] = {
            "value": round(nd["updates_per_s"], 1),
            "dims": dims,
            "warmup_s": round(nd["warmup_s"], 1),
            "ok": bool(nd["final_finite"]),
        }
        emit()

    # ---- 8. layout stress certificates, 2D and 3D ----
    ln = int(os.environ.get("BENCH_CERT_LAYOUT_NODES", 20_000))
    for dims, key in ((2, "nd_layout"), (3, "nd_layout_3d")):
        qn = layout_quality_vs_oracle(n_nodes=ln, steps_per_path=ln,
                                      dims=dims, device=dev, **nd_kw)
        err(f"[bench] {dims}D layout certification (vs oracle): {qn}")
        ok = bool(qn is not None and nds[dims]["final_finite"]
                  and qn["ratio"] <= STRESS_RATIO_MAX)
        result[key].update(
            stress=round(qn["stress"], 5) if qn else None,
            oracle_stress=round(qn["oracle_stress"], 5) if qn else None,
            ratio=round(qn["ratio"], 4) if qn else None,
            ok=ok,
        )
        if not ok:
            err(f"[bench] WARNING: {dims}D layout certification FAILED")
        emit()

    # ---- 9. roofline: the exact applied-update count (a replay of the
    # sampler) and the modelled bytes / operations per update ----
    af = measure_applied_frac(pidx, rounds=ROUNDS, device=dev, **throughput)
    err(f"[bench] applied-updates fraction (throughput cfg): {af}")
    cons_ms = gather_consensus_ms(pidx, device=dev)
    result["roofline"] = roofline_model(
        rate=head["updates_per_s"], info=head,
        applied_frac=af["applied_vs_scheduled"], consensus_ms=cons_ms)
    result["roofline"].update(applied_frac_exact=round(af["applied_frac"], 6),
                              consensus_ms=round(cons_ms, 4),
                              device=device_name)
    err(f"[bench] roofline: {result['roofline']}")
    emit()

    # ---- 10. the gather consensus forced, and the shuffled-id
    # workload through the default policy ----
    fb = {}
    old = os.environ.get("GFASORT_CONSENSUS")
    os.environ["GFASORT_CONSENSUS"] = "gather"
    try:
        g_r = bench_sweep_1d(pidx, rounds=ROUNDS, repeats=1, device=dev,
                             **throughput)
    finally:
        if old is None:
            os.environ.pop("GFASORT_CONSENSUS", None)
        else:
            os.environ["GFASORT_CONSENSUS"] = old
    err(f"[bench] forced-gather consensus rate: {g_r}")
    fb["gather_rate"] = round(g_r["updates_per_s"], 1)
    fb["gather_vs_grid"] = round(g_r["updates_per_s"] / head["updates_per_s"],
                                 3)
    sh_pidx = shuffled_path_index(N_NODES, N_PATHS, STEPS, seed=0)
    s_r = bench_sweep_1d(sh_pidx, rounds=ROUNDS, repeats=1, device=dev,
                         **throughput)
    del sh_pidx
    err(f"[bench] shuffled-id workload (auto consensus policy): {s_r}")
    fb["shuffled_rate"] = round(s_r["updates_per_s"], 1)
    fb["auto_selected"] = s_r["consensus"]
    fb["shuffled_coverage"] = s_r["consensus_coverage"]
    result["fallback"] = fb
    emit()

    # ---- 11. full-schedule (iter_max 100) certificate of the CLI
    # default ----
    cn_f = cn if FULL else int(os.environ.get("BENCH_QFS_NODES", 50_000))
    qf = sweep_quality_vs_oracle(n_nodes=cn_f, steps_per_path=cn_f,
                                 iter_max=100, device=dev)
    err(f"[bench] full-schedule (iter_max=100) certification: {qf}")
    result["quality_full_schedule"] = dict(
        _cert(qf, True, digits=7), iter_max=100, n_nodes=cn_f)

    result["partial"] = False
    emit()
    for q in (q1, q_cli):
        if q is not None and q["spearman"] < 0.99:
            return 1  # egregious quality regression: fail loudly
    return 0


if __name__ == "__main__":
    sys.exit(main())
