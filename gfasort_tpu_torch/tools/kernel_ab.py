"""Time the port's kernels beside earlier builds of their sources.

    python -m gfasort_tpu_torch.tools.kernel_ab OLD_DIR [OLD_DIR ...]

Each ``OLD_DIR`` holds earlier versions of some of ``bucket_apply.cu``,
``dense_apply_nd.cu`` and ``sweep_apply.cu`` with the same C interfaces,
for example a parent commit's (``git show
REV:gfasort_tpu_torch/csrc/sweep_apply.cu``) or a variant of the current
source.  nvcc builds the sources each one holds with the port's flags
into ``OLD_DIR/_build``, their C entry points renamed so that every
build loads into one process.  A kernel is run only where some
``OLD_DIR`` holds its source.  The cases are those of ``chip_smoke.py``'s
``kernel``, ``kernel_nd`` and ``sweep_apply`` phases, from the same seeds
in the same order: S = 4M steps of the bench index, the bench plans'
phases 0 and 1; P = 12 and 1 in 1D; D = 2 with P = 8, D = 3 with P = 4
and D = 2 with P = 1 in nD; the fused apply over the full offset sets at
the first and the last sweep's eta.  In every case every build must
equal the plain version bit for bit; each is then timed in turns (the
old builds in order, the current one twice, the old ones in reverse)
with CUDA events.  Prints each old build's ptxas report, one JSON line
per case and the card line; needs a CUDA device.
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
                          cuda_ms, fused_cases, synthetic_path_index)
from ..ops.sweep_dense import bucket_apply_ref, dense_apply_nd_ref
from ..ops.sweep_fused import sweep_apply_ref
from ..ops.sweep_plan import make_layout_plan, make_sweep_plan
from ..params import LayoutSGDParams, PathSGDParams

__all__ = ["SOURCES", "build_old", "cases", "main"]

# kind of case -> (source, C entry point)
SOURCES = {"1d": ("bucket_apply.cu", "gfasort_bucket_apply"),
           "nd": ("dense_apply_nd.cu", "gfasort_dense_apply_nd"),
           "fused": ("sweep_apply.cu", "gfasort_sweep_apply")}


def build_old(src_dir: pathlib.Path, suffix: str):
    """Build the sources ``src_dir`` holds into one library with their
    entry points renamed by ``suffix``.  Returns ({kind: entry point},
    the ptxas report)."""
    kinds = [kind for kind, (src, _) in SOURCES.items()
             if (src_dir / src).exists()]
    if not kinds:
        raise FileNotFoundError(f"{src_dir} holds none of "
                                f"{[src for src, _ in SOURCES.values()]}")
    nvcc = kernels.nvcc_path()
    out = src_dir / "_build"
    out.mkdir(exist_ok=True)
    rename = [f"-D{name}={name}{suffix}" for _, name in SOURCES.values()]
    objs, procs = [], []
    for kind in kinds:
        src = SOURCES[kind][0]
        obj = str(out / (src[:-3] + ".o"))
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, *rename, "-c", "-o", obj,
             str(src_dir / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate()[0] for proc in procs]
    for kind, proc, log in zip(kinds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[kind][0]}:\n{log}")
    lib_path = out / f"libold_kernels{suffix}.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", str(lib_path), *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    return ({kind: kernels.bind_entry(lib, SOURCES[kind][1], suffix)
             for kind in kinds},
            kernels.ptxas_report("".join(logs)))


def cases(dev, kinds):
    """(description, kind, inputs) of every case of the given kinds, one
    at a time."""
    bench = synthetic_path_index(*BENCH_SHAPE, seed=0)
    S = bench.total_steps
    pos_np = bench.step_pos.astype(np.float32)
    plan = make_sweep_plan(bench, PathSGDParams().derive_from_graph(bench))
    if "1d" in kinds:
        rng = np.random.default_rng(0)
        xs = torch.from_numpy((rng.standard_normal(S) * 100).astype(np.float32)).to(dev)
        pos = torch.from_numpy(pos_np).to(dev)
        eta = float(plan.sweep_eta[0])
        for ph_i in (0, 1):
            buckets = plan.phases[ph_i].kernel_buckets
            for P in (12, 1):
                words = [w.to(dev) for w in contract_choices(rng, S, buckets, P)]
                yield (dict(kernel="bucket_apply", phase_of_plan=ph_i, S=S, P=P,
                            buckets=[list(b) for b in buckets]),
                       "1d", (xs, pos, words, eta, buckets, P))
    if "nd" in kinds:
        nd_plans = {D: make_layout_plan(bench, replace(
            LayoutSGDParams().derive_from_graph(bench, D), iter_max=30))
            for D in (2, 3)}
        rng = np.random.default_rng(1)
        pos = torch.from_numpy(pos_np).to(dev)
        for D, P in ((2, 8), (3, 4), (2, 1)):
            nd_plan = nd_plans[D]
            my_c = torch.from_numpy(bench_layout_coords(rng, pos_np, D)).to(dev)
            eta = float(nd_plan.sweep_eta[0])
            for ph_i in (0, 1):
                buckets = nd_plan.phases[ph_i].kernel_buckets
                words = [w.to(dev) for w in contract_choices(rng, S, buckets, P)]
                yield (dict(kernel="dense_apply_nd", phase_of_plan=ph_i, S=S,
                            D=D, P=P, buckets=[list(b) for b in buckets]),
                       "nd", (pos, words, my_c, eta, buckets, P))
    if "fused" in kinds:
        for c in fused_cases(bench, plan, dev):
            flat = [a.reshape(-1) for a in c["args"]]
            yield (dict(kernel="sweep_apply", phase_of_plan=c["phase_of_plan"],
                        eta_of=c["eta_of"], eta=c["eta"],
                        S_pad=c["layout"]["S_pad"], offs=list(c["offs"])),
                   "fused", (*flat, c["eta"], c["offs"], c["layout"]["H"]))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _, log = kernels.build()
    kernels.library()
    print(json.dumps({"new_build": "csrc", "ptxas": kernels.ptxas_report(log)}),
          flush=True)
    olds = {}   # label -> {kind: entry point}
    for i, arg in enumerate(argv):
        src_dir = pathlib.Path(arg).resolve()
        label = f"old{i}:{src_dir.name}"
        olds[label], report = build_old(src_dir, f"_old{i}")
        print(json.dumps({"old_build": label, "path": os.fspath(src_dir),
                          "kernels": sorted(olds[label]), "ptxas": report}),
              flush=True)
    launch = {"1d": (kernels.bucket_apply_cuda, bucket_apply_ref),
              "nd": (kernels.dense_apply_nd_cuda, dense_apply_nd_ref),
              "fused": (kernels.sweep_apply_cuda, sweep_apply_ref)}
    kinds = {kind for entries in olds.values() for kind in entries}
    for desc, kind, args in cases(dev, kinds):
        run, ref = launch[kind]
        builds = {label: entries[kind] for label, entries in olds.items()
                  if kind in entries}
        builds["new"] = None
        want = ref(*args)
        want = want if isinstance(want, tuple) else (want,)
        for label, entry in builds.items():
            got = run(*args, entry=entry)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{label} kernel differs from the plain "
                                     f"version: {desc}")
            del got
        del want
        order = list(builds) + list(reversed(builds))
        times = {label: [] for label in builds}
        for label in order:
            entry = builds[label]
            times[label].append(cuda_ms(lambda: run(*args, entry=entry), 50))
        new_ms = np.mean(times["new"])
        print(json.dumps(dict(
            desc, ms=times,
            speedup={label: float(np.mean(t) / new_ms)
                     for label, t in times.items() if label != "new"},
            bit_identical=True, card=card)), flush=True)
        del args
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
