"""Time the port's kernels beside earlier builds of their sources.

    python -m gfasort_tpu_torch.tools.kernel_ab [--split K] OLD_DIR [OLD_DIR ...]

Each ``OLD_DIR`` holds earlier versions of some of ``bucket_apply.cu``,
``dense_apply_nd.cu``, ``sweep_apply.cu``, ``sweep_sampler.cu``,
``roll_apply.cu`` and ``shift_sum.cu`` with the same C interfaces, for
example a parent commit's (``git show REV:gfasort_tpu_torch/csrc/sweep_sampler.cu``) or a
variant of the current source.  nvcc builds the sources each one holds
with the port's flags into ``OLD_DIR/_build``, their C entry points
renamed so that every build loads into one process.  A kernel is run
only where some ``OLD_DIR`` holds its source.  The cases are those of
``chip_smoke.py``'s ``kernel``, ``kernel_nd``, ``sweep_apply``,
``sampler`` and ``roll`` phases, from the same seeds in the same order:
S = 4M steps of the bench index, the bench plans' phases 0 and 1; P = 12
and 1 in 1D; D = 2 with P = 8, D = 3 with P = 4 and D = 2 with P = 1 in
nD; the fused apply over the full offset sets at the first and the last
sweep's eta; the sampler's cases of ``bench_util.sampler_cases`` (every
one checked, each plan's and edge's main case timed; the hash kernel's
and, where a build holds ``gfasort_sweep_sampler_tf``, the threefry
kernel's at f32 and f64); the roll kernels' of ``bench_util.roll_cases``
(1D at P = 12, 2D at P = 8 and 3D at P = 4 on plan phases 0 and 1 and
on phase 0 all rolled; the P = 5 edge with far buckets at ki = 0 in 1D,
2D and 3D; 3D phase 1 at P = 8; and, where a build holds the f64 entry
points, the f64 cases; with ``--split K`` each f64 roll case also on its
buckets with k <= K alone and on the rest alone, then on no bucket: the
cost of the short and the long buckets and of the loads and the
combine); and the shift sums' (``shift``: both variants at halo 8 on
S = 2^22 and 2^26 timed, and untimed every case of
``dense_probe.edge_cases`` at S = 1, 3, 1000, 70,001, 196,608 and
2^22, held bit for bit, NaN included).  A kind whose C entry point a
build lacks is not run for that build.  In every
case every build must equal the plain version bit for bit; each is then
timed in turns (the old builds in order, the current one twice, the old
ones in reverse) with CUDA events around back-to-back calls
(``cuda_ms``); the shift sums also on the device alone, L2 cold
(``device_ms``, the times compared), and warm.  Prints each build's
seconds, its ptxas report and the static SASS opcode mix of the kernels
it runs (:func:`sass_mix`; for the shift sums also per output), one JSON
line per timed case and the card line; needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from .. import kernels
from ..bench_util import (BENCH_SHAPE, SAMPLER_ROUTES, bench_layout_coords,
                          contract_choices, cuda_ms, device_ms, fused_cases,
                          roll_cases, sampler_cases, synthetic_path_index)
from ..ops.roll_apply import roll_apply_nd_ref, roll_apply_ref
from ..ops.shift_sum import VARIANTS as SHIFT_VARIANTS
from ..ops.shift_sum import shift_sum_ref
from ..ops.sweep_common import sample_words_ref, threefry_route
from ..ops.sweep_dense import bucket_apply_ref, dense_apply_nd_ref
from ..ops.sweep_fused import sweep_apply_ref
from ..ops.sweep_plan import make_layout_plan, make_sweep_plan
from ..params import LayoutSGDParams, PathSGDParams
from . import dense_probe

__all__ = ["SOURCES", "SASS_CLASSES", "build_old", "sass_mix", "cases",
           "main"]

# kind of case -> (source, C entry point, its kernel's name in the SASS)
SOURCES = {"1d": ("bucket_apply.cu", "gfasort_bucket_apply",
                  "bucket_apply_kernel"),
           "nd": ("dense_apply_nd.cu", "gfasort_dense_apply_nd",
                  "dense_apply_nd_kernel"),
           "fused": ("sweep_apply.cu", "gfasort_sweep_apply",
                     "sweep_apply_kernel"),
           "sampler": ("sweep_sampler.cu", "gfasort_sweep_sampler",
                       "sweep_sampler_kernel"),
           "sampler_tf": ("sweep_sampler.cu", "gfasort_sweep_sampler_tf",
                          "sweep_sampler_tf_kernel"),
           "roll": ("roll_apply.cu", "gfasort_roll_apply",
                    "roll_apply_kernel"),
           "roll_nd": ("roll_apply.cu", "gfasort_roll_apply_nd",
                       "roll_apply_nd_kernel"),
           "roll_f64": ("roll_apply.cu", "gfasort_roll_apply_f64",
                        "roll_apply_kernel"),
           "roll_nd_f64": ("roll_apply.cu", "gfasort_roll_apply_nd_f64",
                           "roll_apply_nd_kernel"),
           "shift": ("shift_sum.cu", "gfasort_shift_sum", "shift_sum_")}
# the shift sums' C entry point that gives a kernel's outputs per pass of
# its body; a build without it holds the first design: one output per
# thread (global), four (smem)
SHIFT_PASS_ENTRY = "gfasort_shift_sum_outputs_per_pass"
FIRST_SHIFT_PASS = {"global": 1, "smem": 4}
# the timed shift-sum sizes, and the sizes of their untimed edge cases
SHIFT_TIMED = (1 << 22, 1 << 26)
SHIFT_EDGES = (1, 3, 1000, 70_001, 196_608, 1 << 22)


def build_old(src_dir: pathlib.Path, suffix: str):
    """Build the sources ``src_dir`` holds into one library with their
    entry points renamed by ``suffix`` (one nvcc per source, all started
    together, as ``kernels.build`` does).  Returns ({kind: entry point}
    for the kinds whose entry point the build holds, the ptxas report,
    the library's path, the build's seconds)."""
    kinds = [kind for kind, (src, _, _) in SOURCES.items()
             if (src_dir / src).exists()]
    if not kinds:
        raise FileNotFoundError(f"{src_dir} holds none of "
                                f"{sorted({v[0] for v in SOURCES.values()})}")
    srcs = sorted({SOURCES[kind][0] for kind in kinds})
    t0 = time.perf_counter()
    nvcc = kernels.nvcc_path()
    out = src_dir / "_build"
    out.mkdir(exist_ok=True)
    names = {name for _, name, _ in SOURCES.values()} | {SHIFT_PASS_ENTRY}
    rename = [f"-D{name}={name}{suffix}" for name in sorted(names)]
    objs, procs = [], []
    for src in srcs:
        obj = str(out / (src[:-3] + ".o"))
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, *rename, "-c", "-o", obj,
             str(src_dir / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate()[0] for proc in procs]
    for src, proc, log in zip(srcs, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    lib_path = out / f"libold_kernels{suffix}.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", str(lib_path), *objs], check=True)
    seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    return ({kind: kernels.bind_entry(lib, SOURCES[kind][1], suffix)
             for kind in kinds if hasattr(lib, SOURCES[kind][1] + suffix)},
            kernels.ptxas_report("".join(logs)), lib_path, seconds)


# SASS opcode classes of :func:`sass_mix`, by the opcode's first word
SASS_CLASSES = {
    "IMAD": ("IMAD",),
    "LOP3/SHF/IADD": ("LOP3", "SHF", "IADD3", "LEA", "ISETP", "SEL", "IMNMX",
                      "PRMT", "SGXT", "VIMNMX", "IABS"),
    "I2F/F2I": ("I2F", "F2I", "I2FP", "F2IP", "FRND", "I2I"),
    "MUFU": ("MUFU",),
    "POPC/FLO": ("POPC", "FLO", "BREV"),
    "FFMA/FMUL/FADD": ("FFMA", "FMUL", "FADD", "FSETP", "FMNMX", "FSEL",
                       "FCHK", "FSET"),
    "LDS": ("LDS",),
    "LDG/STG": ("LDG", "STG", "LD", "ST", "LDC", "ULDC"),
    "LDG": ("LDG", "LD"),
    "STG": ("STG", "ST"),
    "LDGSTS/UBLKCP": ("LDGSTS", "UBLKCP"),
    "STS": ("STS",),
    "SHFL": ("SHFL",),
    "BRA": ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "WARPSYNC"),
}


def _cuobjdump() -> str:
    """The toolkit's ``cuobjdump`` (beside ``nvcc``), else the copy in
    Triton's wheel.  Raises when there is none."""
    try:
        found = pathlib.Path(kernels.nvcc_path()).with_name("cuobjdump")
        if found.exists():
            return str(found)
    except RuntimeError:
        pass
    import importlib.util

    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        found = (pathlib.Path(spec.origin).parent / "backends" / "nvidia" /
                 "bin" / "cuobjdump")
        if found.exists():
            return str(found)
    raise RuntimeError("cuobjdump not found: no SASS to count")


def sass_mix(lib_path, pattern: str = "") -> dict:
    """Static SASS opcode counts of the kernels in ``lib_path`` whose
    mangled name contains ``pattern``: {kernel: {"total": n, class: n,
    ..., "opcodes": {opcode: n}}}, classes as in ``SASS_CLASSES``
    (``NOP`` padding left out).  Counts are per compiled instruction,
    not per executed one: a loop body counts once."""
    out = subprocess.run([_cuobjdump(), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    mixes, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = None
            if pattern in m.group(1):
                cur = mixes.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if cur is None or not m:
            continue
        op = m.group(1).split(".")[0]
        if op != "NOP":
            cur[op] = cur.get(op, 0) + 1
    rows = {}
    for name, ops in mixes.items():
        row = {"total": sum(ops.values())}
        for cls, members in SASS_CLASSES.items():
            row[cls] = sum(n for op, n in ops.items() if op in members)
        row["opcodes"] = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
        rows[name] = row
    try:
        cufilt = pathlib.Path(kernels.nvcc_path()).with_name("cu++filt")
        names = subprocess.run([str(cufilt)] + list(rows), capture_output=True,
                               text=True, check=True).stdout.splitlines()
        if len(names) == len(rows):
            rows = {n.replace("(anonymous namespace)::", ""): r
                    for n, r in zip(names, rows.values())}
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        pass   # keep the mangled names
    return rows


def sass_rows(lib_path, kinds) -> dict:
    """The static SASS mix (classes and totals, :func:`sass_mix`) of
    the kernels of ``kinds`` in the library at ``lib_path``."""
    rows = {}
    for kind in sorted(kinds):
        rows.update(sass_mix(lib_path, SOURCES[kind][2]))
    return rows


def shift_per_output(rows: dict, lib_path, suffix: str = "") -> dict:
    """The shift-sum kernels' rows of ``rows`` (:func:`sass_rows`) with
    ``per_output``: the static counts of the load, store, copy and
    shuffle classes over the outputs one pass of the kernel's body
    computes (the library's ``SHIFT_PASS_ENTRY`` where it has one, else
    ``FIRST_SHIFT_PASS``)."""
    lib = ctypes.CDLL(str(lib_path))
    entry = getattr(lib, SHIFT_PASS_ENTRY + suffix, None)
    out = {}
    for name, row in rows.items():
        variant = next((v for v in SHIFT_VARIANTS
                        if f"shift_sum_{v}" in name), None)
        if variant is None:
            continue
        n = (entry(SHIFT_VARIANTS.index(variant)) if entry is not None
             else FIRST_SHIFT_PASS[variant])
        out[name] = dict(outputs_per_pass=n, per_output={
            cls: row[cls] / n for cls in ("LDG", "STG", "LDGSTS/UBLKCP",
                                          "LDS", "STS", "SHFL")})
    return out


def cases(dev, kinds, split=None):
    """(description, kind, inputs, timed) of every case of the given
    kinds, one at a time; ``split`` as ``--split``."""
    bench = synthetic_path_index(*BENCH_SHAPE, seed=0)
    S = bench.total_steps
    pos_np = bench.step_pos.astype(np.float32)
    plan = make_sweep_plan(bench, PathSGDParams().derive_from_graph(bench))
    nd_plans = {D: make_layout_plan(bench, replace(
        LayoutSGDParams().derive_from_graph(bench, D), iter_max=30))
        for D in (2, 3)}
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
                       "1d", (xs, pos, words, eta, buckets, P), True)
    if "nd" in kinds:
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
                       "nd", (pos, words, my_c, eta, buckets, P), True)
    if "fused" in kinds:
        for c in fused_cases(bench, plan, dev):
            flat = [a.reshape(-1) for a in c["args"]]
            yield (dict(kernel="sweep_apply", phase_of_plan=c["phase_of_plan"],
                        eta_of=c["eta_of"], eta=c["eta"],
                        S_pad=c["layout"]["S_pad"], offs=list(c["offs"])),
                   "fused", (*flat, c["eta"], c["offs"], c["layout"]["H"]),
                   True)
    plans = {"1d": plan, **nd_plans}
    routes = [r for r in SAMPLER_ROUTES
              if ("sampler" if r[1:] == ("hash", "float32") else "sampler_tf")
              in kinds]
    if routes:
        for c in sampler_cases(bench, plans, dev, routes):
            yield (dict(kernel="sweep_sampler", S=S,
                        **{k: c[k] for k in ("name", "route", "phase_of_plan",
                                             "P", "K", "coin", "cooling",
                                             "frac", "snap")}),
                   "sampler" if c["route"] == "hash" else "sampler_tf",
                   (*c["args"], c["coin"]), c["main"])
    if "shift" in kinds:
        yield from _shift_cases(dev)
    if kinds & {"roll", "roll_nd", "roll_f64", "roll_nd_f64"}:
        for c in roll_cases(bench, plans, dev,
                            f64=bool(kinds & {"roll_f64", "roll_nd_f64"})):
            kind = (("roll" if c["dims"] == 1 else "roll_nd")
                    + ("_f64" if c["dtype"] == "float64" else ""))
            if kind not in kinds:
                continue
            subsets = [("", c["rb"])]
            if split is not None and c["dtype"] == "float64":
                subsets += [(":short", tuple(b for b in c["rb"]
                                             if b[0] <= split)),
                            (":long", tuple(b for b in c["rb"]
                                            if b[0] > split)),
                            (":none", ())]
            at = 4 if c["dims"] == 1 else 6   # the buckets in args
            for tag, rb in subsets:
                args = c["args"][:at] + (rb,) + c["args"][at + 1:]
                yield (dict(kernel=c["kernel"], dims=c["dims"], S=S,
                            dtype=c["dtype"],
                            phase_of_plan=f"{c['phase_of_plan']}{tag}",
                            P=c["P"], kernel_buckets=len(c["kb"]),
                            roll_buckets=[list(b) for b in rb]),
                       kind, args, True)


def _shift_ref(x, halo, variant):
    return shift_sum_ref(x, halo)


def _shift_cases(dev):
    """The shift sums' timed cases, then their edge cases."""
    for S in SHIFT_TIMED:
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(S)
                             .astype(np.float32)).to(dev)
        for v in SHIFT_VARIANTS:
            yield (dict(kernel=f"shift_sum_{v}", S=S, halo=8), "shift",
                   (x, 8, v), True)
        del x
    for S in SHIFT_EDGES:
        for name, x, halo in dense_probe.edge_cases(S, dev):
            for v in SHIFT_VARIANTS:
                yield (dict(kernel=f"shift_sum_{v}", S=x.shape[0], halo=halo,
                            edge=name), "shift", (x, halo, v), False)


def _sampler_cuda(consts, key_words, cooling, rank, cnt, frac, snap, rng,
                  coin, entry=None):
    return kernels.sweep_sampler_cuda(
        consts, key_words, cooling, rank, cnt, frac, snap, coin, entry=entry,
        threefry=threefry_route(rng, consts.zeta.dtype))


def _sampler_ref(consts, key_words, cooling, rank, cnt, frac, snap, rng,
                 coin):
    return sample_words_ref(consts, key_words, cooling, rank, cnt, frac, snap,
                            rng, coin=coin)


def _flat(out) -> list:
    """A kernel's outputs as a flat list of tensors (the sampler's words
    and coin, the bucket kernels' pair of sums, one tensor)."""
    if isinstance(out, torch.Tensor):
        return [out]
    flat = []
    for o in out:
        if isinstance(o, (list, tuple)):
            flat.extend(o)
        elif o is not None:
            flat.append(o)
    return flat


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    split = None
    if argv[:1] == ["--split"]:
        split, argv = int(argv[1]), argv[2:]
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    new_lib, log = kernels.build()
    # the current sources' build; None where the library was already built
    new_s = time.perf_counter() - t0 if log else None
    kernels.library()
    olds, old_libs = {}, {}   # label -> {kind: entry point}, library
    for i, arg in enumerate(argv):
        src_dir = pathlib.Path(arg).resolve()
        label = f"old{i}:{src_dir.name}"
        olds[label], report, old_libs[label], secs = build_old(src_dir,
                                                               f"_old{i}")
        print(json.dumps({"old_build": label, "path": os.fspath(src_dir),
                          "kernels": sorted(olds[label]), "seconds": secs,
                          "ptxas": report}), flush=True)
    kinds = {kind for entries in olds.values() for kind in entries}
    print(json.dumps({"new_build": "csrc", "seconds": new_s,
                      "source_seconds": kernels.source_seconds(log),
                      "ptxas": kernels.ptxas_report(log)}), flush=True)
    suffixes = {label: f"_old{i}" for i, label in enumerate(olds)}
    for label, lib_path in [("new", new_lib), *old_libs.items()]:
        rows = sass_rows(lib_path, kinds)
        line = {"sass_mix": label, "static_counts": True, "kernels": rows}
        if "shift" in kinds:
            line["shift_per_output"] = shift_per_output(
                rows, lib_path, suffixes.get(label, ""))
        print(json.dumps(line), flush=True)
    launch = {"1d": (kernels.bucket_apply_cuda, bucket_apply_ref),
              "nd": (kernels.dense_apply_nd_cuda, dense_apply_nd_ref),
              "fused": (kernels.sweep_apply_cuda, sweep_apply_ref),
              "sampler": (_sampler_cuda, _sampler_ref),
              "sampler_tf": (_sampler_cuda, _sampler_ref),
              "roll": (kernels.roll_apply_cuda, roll_apply_ref),
              "roll_nd": (kernels.roll_apply_nd_cuda, roll_apply_nd_ref),
              "roll_f64": (kernels.roll_apply_cuda, roll_apply_ref),
              "roll_nd_f64": (kernels.roll_apply_nd_cuda, roll_apply_nd_ref),
              "shift": (kernels.shift_sum_cuda, _shift_ref)}
    for desc, kind, args, timed in cases(dev, kinds, split):
        run, ref = launch[kind]
        builds = {label: entries[kind] for label, entries in olds.items()
                  if kind in entries}
        builds["new"] = None
        want = _flat(ref(*args))
        for label, entry in builds.items():
            got = _flat(run(*args, entry=entry))
            torch.cuda.synchronize()
            # the shift sums' edge cases hold NaN: compared bit for bit
            same = dense_probe.same_bits if kind == "shift" else torch.equal
            if len(got) != len(want) or not all(
                    same(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{label} kernel differs from the plain "
                                     f"version: {desc}")
            del got
        del want
        if not timed:
            continue
        order = list(builds) + list(reversed(builds))
        times = {label: [] for label in builds}
        extra = {}
        if kind == "shift":
            # the device alone, L2 cold (compared), warm, and back to back
            extra = {"wrapper_ms": {label: [] for label in builds},
                     "device_warm_ms": {label: [] for label in builds}}
        for label in order:
            entry = builds[label]
            call = (lambda: run(*args, entry=entry))
            if kind == "shift":
                times[label].append(device_ms(call))
                extra["device_warm_ms"][label].append(device_ms(call, warm=True))
                extra["wrapper_ms"][label].append(cuda_ms(call, 50))
            else:
                times[label].append(cuda_ms(call, 50))
        new_ms = np.mean(times["new"])
        print(json.dumps(dict(
            desc, **{"device_ms" if kind == "shift" else "ms": times}, **extra,
            speedup={label: float(np.mean(t) / new_ms)
                     for label, t in times.items() if label != "new"},
            bit_identical=True, card=card)), flush=True)
        del args
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
