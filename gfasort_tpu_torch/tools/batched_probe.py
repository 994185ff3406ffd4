"""Time the batched engine's round loop replayed as CUDA graphs against
the same loop run eagerly, on the card, and check that both give the
same result bit for bit.

    python -m gfasort_tpu_torch.tools.batched_probe

Workloads: the 1D certificate graph of ``chip_smoke.py`` (100k nodes,
f64, iter 30: 3,038 rounds), the bench index (1M nodes, f32, iter 100:
98,677 rounds) and the 20k-node 2D layout certificate graph (f32, iter
30: 6,076 rounds), all at B = 4096 and ``pow_mode="fpp"``.  Each runs
with graphs, eagerly, and with graphs again (the first graph run of the
process pays the graph set-up once); one JSON line per run.  Raises if
any two runs of a workload differ.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from ..bench_util import BENCH_SHAPE, synthetic_path_index
from ..ops import sgd
from ..ops.exact import layout_initial_coords
from ..ops.keys import key_data
from ..params import LayoutSGDParams, PathSGDParams


@contextlib.contextmanager
def eager_loop():
    """The engine's round loop without CUDA graphs."""
    graphs = sgd._chunk_runner
    sgd._chunk_runner = lambda loop, state, pad: (
        lambda table, *rest: loop(state, table, *rest))
    try:
        yield
    finally:
        sgd._chunk_runner = graphs


def _run_1d(pidx, p):
    torch.cuda.synchronize()
    run, make_x0, n_rounds = sgd.build_1d_runner(pidx, p, device="cuda")
    t0 = time.perf_counter()
    x = run(make_x0(), key_data(p.seed))
    torch.cuda.synchronize()
    return x.cpu().numpy(), time.perf_counter() - t0, n_rounds


def _run_layout(pidx, lp, init):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lay = sgd.path_linear_sgd_layout_batched(None, lp, pidx, init,
                                             device="cuda")
    torch.cuda.synchronize()
    return lay.coords, time.perf_counter() - t0, None


def main() -> int:
    if not torch.cuda.is_available():
        print("batched_probe: CUDA is not available", file=sys.stderr)
        return 1
    cert = synthetic_path_index(100_000, 4, 100_000, seed=7)
    bench = synthetic_path_index(*BENCH_SHAPE, seed=0)
    lay = synthetic_path_index(20_000, 4, 20_000, seed=11)
    lp = replace(LayoutSGDParams().derive_from_graph(lay, 2), dtype="float32")
    init = layout_initial_coords(lay, 2, lp.seed)
    cases = {
        "cert_1d_f64": lambda: _run_1d(cert, replace(
            PathSGDParams().derive_from_graph(cert), iter_max=30,
            dtype="float64")),
        "bench_1d_f32": lambda: _run_1d(bench, replace(
            PathSGDParams().derive_from_graph(bench), iter_max=100,
            dtype="float32")),
        "layout_2d_f32": lambda: _run_layout(lay, lp, init),
    }
    for name, case in cases.items():
        outs = []
        for mode in ("graph", "eager", "graph"):
            with eager_loop() if mode == "eager" else contextlib.nullcontext():
                out, secs, n_rounds = case()
            outs.append(out)
            rec = {"case": name, "mode": mode, "seconds": secs}
            if n_rounds is not None:
                rec.update(rounds=n_rounds, rounds_per_s=n_rounds / secs)
            print(json.dumps(rec), flush=True)
        if not all(np.array_equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"{name}: the graph and eager runs differ")
        print(json.dumps({"case": name, "bit_identical": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
