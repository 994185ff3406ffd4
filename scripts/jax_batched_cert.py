#!/usr/bin/env python
"""Order certificate of the JAX batched engine (``gfasort_tpu/ops/sgd.py``)
on the CPU, the reference beside which the PyTorch port's batched
certificate is reported.

The workload is the 1D certificate of ``chip_smoke.py``: 100k nodes,
4 paths x 100k steps, seed 7, iter_max 30, the engine's default batch
(4096): rank-MAE/N and Spearman of the engine's order against the C++
oracle (f64, ``fpp``), at ``dtype`` float64 and float32 (``pow_mode``
``fpp``, the engine's default).  One JSON line per dtype.

Usage:
    JAX_PLATFORMS=cpu python scripts/jax_batched_cert.py
"""

import json
import pathlib
import sys
import time
from dataclasses import replace

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CERT = dict(n_nodes=100_000, n_paths=4, steps_per_path=100_000, seed=7,
            iter_max=30)


def main() -> int:
    import jax
    import numpy as np

    from gfasort_tpu import native
    from gfasort_tpu.bench_util import rank_quality, synthetic_path_index
    from gfasort_tpu.ops.sgd import path_linear_sgd_batched
    from gfasort_tpu.params import PathSGDParams

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if not native.available():
        print("the C++ oracle cannot be built", file=sys.stderr)
        return 1
    pidx = synthetic_path_index(CERT["n_nodes"], CERT["n_paths"],
                                CERT["steps_per_path"], seed=CERT["seed"])
    p = replace(PathSGDParams().derive_from_graph(pidx),
                iter_max=CERT["iter_max"])
    t0 = time.perf_counter()
    x_oracle = native.path_linear_sgd_native(
        None, replace(p, dtype="float64", pow_mode="fpp"), pidx)
    t_oracle = time.perf_counter() - t0
    for dtype in ("float64", "float32"):
        pb = replace(p, dtype=dtype, pow_mode="fpp")
        t0 = time.perf_counter()
        x = path_linear_sgd_batched(None, pb, pidx)
        secs = time.perf_counter() - t0
        q = rank_quality(np.argsort(x, kind="stable"),
                         np.argsort(x_oracle, kind="stable"))
        print(json.dumps({"engine": "jax batched", "backend": "cpu",
                          "dtype": dtype, "pow_mode": "fpp", "batch": pb.batch,
                          "seconds": secs, "oracle_s": t_oracle,
                          "jax": jax.__version__, **CERT, **q}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
