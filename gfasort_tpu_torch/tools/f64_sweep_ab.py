"""Time the f64 sweeps of several checkouts of the port, in turns.

    python -m gfasort_tpu_torch.tools.f64_sweep_ab TREE [TREE ...]

Each ``TREE`` is a directory holding a ``gfasort_tpu_torch`` package (this
checkout, or a parent commit's unpacked with ``git archive REV
gfasort_tpu_torch | tar -x -C TREE``).  For each tree in the order given,
one subprocess imports that tree's package (its kernels built into its
own ``_build/``) and runs, on the bench index (S = 4M), the 1D sweep
engine's f64 sweep (the bench plan at f64) and the 2D layout engine's
(the layout plan at iter 30, f64) through ``sweep_once`` /
``nd_sweep_once``: CUDA-event ms per sweep over 12 sweeps, and the
device launches and device ms of one sweep, as this checkout's
``chip_smoke.device_launches`` reads them with ``torch.profiler``.
Prints one JSON line per tree and the card line; needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

_ROOT = pathlib.Path(__file__).resolve().parents[2]


def one(tree: str) -> dict:
    """The f64 sweeps of the package in ``tree`` (this process imports
    it first)."""
    sys.path.insert(0, tree)
    from dataclasses import replace

    import numpy as np
    import torch

    import gfasort_tpu_torch
    from gfasort_tpu_torch.bench_util import (BENCH_SHAPE, bench_layout_coords,
                                              synthetic_path_index)
    from gfasort_tpu_torch.convert import initial_state, layout_static_arrays
    from gfasort_tpu_torch.ops.keys import key_data
    from gfasort_tpu_torch.ops.sweep import sweep_once
    from gfasort_tpu_torch.ops.sweep_common import route_keys, sampler_consts
    from gfasort_tpu_torch.ops.sweep_nd import nd_sweep_once
    from gfasort_tpu_torch.ops.sweep_plan import (make_layout_plan,
                                                  make_sweep_plan)
    from gfasort_tpu_torch.params import LayoutSGDParams, PathSGDParams

    pkg = pathlib.Path(gfasort_tpu_torch.__file__).resolve()
    if pathlib.Path(tree).resolve() not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the package in {tree}")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  _ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    bench = synthetic_path_index(*BENCH_SHAPE, seed=0)
    pos, rank, cnt, rev, length = layout_static_arrays(bench, dev, np.float64)
    out = {"tree": tree}
    for dims in (1, 2):
        if dims == 1:
            plan = make_sweep_plan(bench, replace(
                PathSGDParams().derive_from_graph(bench), dtype="float64"))
            state0, _ = initial_state(bench, None, dev, np.float64)
        else:
            plan = make_layout_plan(bench, replace(
                LayoutSGDParams().derive_from_graph(bench, 2), iter_max=30,
                dtype="float64"))
            rng = np.random.default_rng(8)
            state0 = torch.from_numpy(np.concatenate([
                bench_layout_coords(rng, bench.step_pos.astype(np.float32), 2)
                for _ in range(2)])).to(torch.float64).to(dev)
        P = plan.proposals
        keys = route_keys(key_data(12), 12, P, "hash", torch.float64)
        consts = [[sampler_consts(ph, c, dev, torch.float64)
                   for c in (False, True)] for ph in plan.phases]

        def sweep(e, s):
            i, eta, cool = plan.sweep(e)
            if dims == 1:
                return sweep_once(s, pos, rank, cnt, plan.phases[i],
                                  consts[i][cool], keys[e], eta, cool, P,
                                  plan.active_frac)
            return nd_sweep_once(s, pos, rank, cnt, rev, length,
                                 plan.phases[i], consts[i][cool], keys[e],
                                 eta, cool, P, plan.active_frac)

        sweep(0, state0)   # warm-up
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s = state0
        torch.cuda.synchronize()
        start.record()
        for e in range(12):
            s = sweep(e, s)
        end.record()
        torch.cuda.synchronize()
        n_dev, dev_ms = smoke.device_launches(lambda: sweep(0, state0))
        out[f"{dims}d"] = dict(proposals=P, sweep_ms=start.elapsed_time(end) / 12,
                              device_launches=n_dev, device_ms=dev_ms)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    import torch

    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    for tree in argv:
        # run as a file, so that the child imports no package before
        # the tree's
        res = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--one",
             str(pathlib.Path(tree).resolve())],
            capture_output=True, text=True, cwd=_ROOT)
        if res.returncode != 0:
            raise RuntimeError(f"{tree}: {res.stderr[-2000:]}")
        print(res.stdout.strip().splitlines()[-1], flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
