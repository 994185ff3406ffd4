"""Time the two bucket kernels beside an earlier build of their sources.

    python -m gfasort_tpu_torch.tools.kernel_ab OLD_DIR

``OLD_DIR`` holds earlier versions of ``bucket_apply.cu`` and
``dense_apply_nd.cu`` with the same C interfaces, for example a parent
commit's (``git show REV:gfasort_tpu_torch/csrc/bucket_apply.cu``).  nvcc
builds them with the port's flags into ``OLD_DIR/_build``, their C entry
points renamed so that both builds load into one process.  The cases are
those of ``chip_smoke.py``'s ``kernel`` and ``kernel_nd`` phases, from the
same seeds in the same order: S = 4M steps of the bench index, the bench
plans' phases 0 and 1, P = 12 and 1 in 1D, D = 2 with P = 8, D = 3 with
P = 4 and D = 2 with P = 1 in nD.  In every case both builds must equal
the plain version bit for bit; each is then timed in turns (old, new,
new, old) with CUDA events.  Prints the old build's ptxas report, one
JSON line per case and the card line; needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import subprocess
import sys
from dataclasses import replace

import numpy as np
import torch

from .. import kernels
from ..bench_util import (BENCH_SHAPE, bench_layout_coords, contract_choices,
                          cuda_ms, synthetic_path_index)
from ..ops.sweep_dense import bucket_apply_ref, dense_apply_nd_ref
from ..ops.sweep_plan import make_layout_plan, make_sweep_plan
from ..params import LayoutSGDParams, PathSGDParams

__all__ = ["build_old", "cases", "main"]

SOURCES = ("bucket_apply.cu", "dense_apply_nd.cu")
SUFFIX = "_old"


def build_old(src_dir: pathlib.Path):
    """Build the earlier sources into one library with renamed entry
    points.  Returns (the 1D and nD entry points, the ptxas report)."""
    nvcc = kernels.nvcc_path()
    out = src_dir / "_build"
    out.mkdir(exist_ok=True)
    rename = [f"-D{name}={name}{SUFFIX}"
              for name in ("gfasort_bucket_apply", "gfasort_dense_apply_nd")]
    objs, procs = [], []
    for name in SOURCES:
        obj = str(out / (name[:-3] + ".o"))
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, *rename, "-c", "-o", obj,
             str(src_dir / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate()[0] for proc in procs]
    for name, proc, log in zip(SOURCES, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    lib_path = out / "libold_bucket_kernels.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", str(lib_path), *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    return (kernels.bind_bucket_kernels(lib, SUFFIX),
            kernels.ptxas_report("".join(logs)))


def cases(dev):
    """(description, kernel, inputs) of every case, one at a time."""
    bench = synthetic_path_index(*BENCH_SHAPE, seed=0)
    S = bench.total_steps
    pos_np = bench.step_pos.astype(np.float32)
    plan = make_sweep_plan(bench, PathSGDParams().derive_from_graph(bench))
    rng = np.random.default_rng(0)
    xs = torch.from_numpy((rng.standard_normal(S) * 100).astype(np.float32)).to(dev)
    pos = torch.from_numpy(pos_np).to(dev)
    eta = float(plan.sweep_eta[0])
    for ph_i in (0, 1):
        buckets = plan.phases[ph_i].kernel_buckets
        for P in (12, 1):
            words = [w.to(dev) for w in contract_choices(rng, S, buckets, P)]
            yield (dict(kernel="bucket_apply", phase_of_plan=ph_i, S=S, P=P),
                   "1d", (xs, pos, words, eta, buckets, P))
    nd_plans = {D: make_layout_plan(bench, replace(
        LayoutSGDParams().derive_from_graph(bench, D), iter_max=30))
        for D in (2, 3)}
    rng = np.random.default_rng(1)
    for D, P in ((2, 8), (3, 4), (2, 1)):
        nd_plan = nd_plans[D]
        my_c = torch.from_numpy(bench_layout_coords(rng, pos_np, D)).to(dev)
        eta = float(nd_plan.sweep_eta[0])
        for ph_i in (0, 1):
            buckets = nd_plan.phases[ph_i].kernel_buckets
            words = [w.to(dev) for w in contract_choices(rng, S, buckets, P)]
            yield (dict(kernel="dense_apply_nd", phase_of_plan=ph_i, S=S, D=D,
                        P=P),
                   "nd", (pos, words, my_c, eta, buckets, P))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    src_dir = pathlib.Path(argv[0]).resolve()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kernels.library()
    (old_1d, old_nd), report = build_old(src_dir)
    print(json.dumps({"old_build": os.fspath(src_dir), "ptxas": report}),
          flush=True)
    launch = {"1d": (kernels.bucket_apply_cuda, bucket_apply_ref, old_1d),
              "nd": (kernels.dense_apply_nd_cuda, dense_apply_nd_ref, old_nd)}
    for desc, kind, args in cases(dev):
        run, ref, old_entry = launch[kind]
        outs = {"new": run(*args), "old": run(*args, entry=old_entry),
                "plain": ref(*args)}
        torch.cuda.synchronize()
        for name in ("new", "old"):
            for got, want in zip(outs[name], outs["plain"]):
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} kernel differs from the "
                                         f"plain version: {desc}")
        times = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            entry = old_entry if name == "old" else None
            times[name].append(cuda_ms(lambda: run(*args, entry=entry), 50))
        old_ms, new_ms = np.mean(times["old"]), np.mean(times["new"])
        print(json.dumps(dict(desc, buckets=[list(b) for b in args[4]],
                              old_ms=times["old"], new_ms=times["new"],
                              speedup=float(old_ms / new_ms),
                              bit_identical=True, card=card)), flush=True)
        del outs, args
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
