"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python -m gfabench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process: set-up (glibc's malloc told to keep freed memory, torch and
the program imported, the warm-up job's input made from the seed and the
whole warm-up job run, which loads or builds the program's kernel and
host libraries and maps the memory that the jobs re-use), then the
window: CLI
jobs through ``gfasort_tpu_torch.cli.main``, one after another, each on a
new input made between jobs off the job clock, until the jobs' summed
time reaches ``--seconds`` (the last job runs to its end).  Then the
invariants of every job, the comparison of one job drawn from the seed
with the plain reference (:mod:`gfabench.reference`), the metrics (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``, read by ``metrics/<name>.py``) and, last, a check that
neither JAX nor the JAX package was imported.  The last lines on stderr
are the numbers compared, each beside its limit; the last line on
stdout is the result, as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


def _process_start() -> float:
    """The perf_counter reading of this process's start (Linux), or of
    now where /proc cannot say."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


START = _process_start()

from .spec import ROOT, Cell, load_cell, metric_reader  # noqa: E402

# top-level module names that no run may hold once its window has closed:
# the JAX stack and the JAX package (compared whole: the program's
# top-level name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "gfasort_tpu")

# the numbers that decide ``correct``, each with its limit: exact
# comparisons (PERF.md gives the readings they were set from)
LIMITS = {"failed_jobs": 0, "gfa_lines_differing": 0,
          "tsv_values_differing": 0}


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclass
class Run:
    """What a metric reader reads: the cell, the set-up seconds, the
    window's jobs (:class:`gfabench.jobs.Job`), the device trace of a
    ``--trace 1`` run on the card (else None), the SM clock of the bounds
    and the device memory peak in bytes (0 without a card)."""

    cell: Cell
    setup_s: float
    jobs: list
    trace: Optional[object]
    clock_mhz: float
    memory_peak_bytes: int = 0


def forbidden_modules(names) -> list:
    """The FORBIDDEN top-level names among module names."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def keep_freed_memory() -> bool:
    """Have glibc's malloc serve every block from its heap and never hand
    freed memory back to the kernel (``M_MMAP_MAX`` 0, ``M_TRIM_THRESHOLD``
    at its largest), so that the window's jobs re-use the pages that the
    warm-up job faulted in.  Otherwise every large array of a job is
    mapped and unmapped anew, and the page faults, 1.2-2.0 s of system
    time in a 9-11 s job on the card's host, whose cost swings with the
    host's load, land in the window.  False where the C library has no
    ``mallopt`` or refuses a setting."""
    import ctypes

    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    m_trim_threshold, m_mmap_max = -1, -4
    # -1 reads as the largest size_t: no trim
    return (mallopt(m_mmap_max, 0) == 1
            and mallopt(m_trim_threshold, -1) == 1)


def _say(*parts) -> None:
    print("[gfabench]", *parts, file=sys.stderr, flush=True)


def judge(numbers: dict) -> tuple:
    """(checks, ok): each number beside its limit, and whether every
    number is within its limit."""
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def host_state() -> str:
    """What may make the host's speed differ between runs: the CPUs this
    process may run on, their clock now, torch's thread count, the NUMA
    nodes and the load average."""
    import torch

    try:
        with open("/proc/cpuinfo") as fh:
            mhz = [float(line.split(":")[1]) for line in fh
                   if line.startswith("cpu MHz")]
    except OSError:
        mhz = []
    try:
        with open("/proc/loadavg") as fh:
            load = " ".join(fh.read().split()[:3])
    except OSError:
        load = "?"
    nodes = len(list(Path("/sys/devices/system/node").glob("node[0-9]*")))
    cpus = sorted(os.sched_getaffinity(0))
    return (f"cpus {cpus} ({len(cpus)}), MHz "
            f"{min(mhz, default=0):.0f}-{max(mhz, default=0):.0f}, torch "
            f"threads {torch.get_num_threads()}, NUMA nodes {nodes}, load "
            f"{load}")


def _card() -> tuple:
    """(name and power limit as nvidia-smi gives them, the maximum SM clock
    in MHz)."""
    from .bounds import MAX_SM_CLOCK_MHZ

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60)
        name, watts, mhz = (f.strip() for f in
                            out.stdout.strip().splitlines()[0].split(","))
        return f"{name}, {watts} W", float(mhz)
    except (OSError, subprocess.SubprocessError, ValueError):
        return "unknown card", MAX_SM_CLOCK_MHZ


def _sample(seed: int, jobs: list):
    """The job that the reference checks: drawn from the seed among the
    jobs that finished, None where none did."""
    import numpy as np

    done = [j for j in jobs if j.rc == 0]
    if not done:
        return None
    return done[int(np.random.default_rng([seed, 1]).integers(len(done)))]


def compare(job, device: str, round_state=None, ref=None) -> dict:
    """The numbers that decide ``correct`` for ``job``: the lines of its
    GFA that differ from the reference's, and for a layout job the
    coordinates of its TSV that differ.  ``round_state`` puts the
    reference's control (its state in a lower precision) in the program's
    place: the control's files are compared as the program's are.
    ``ref``: the reference's result for the job, where it is already
    worked out."""
    from .gfa_check import lines_differing, read_tsv, tsv_values_differing
    from .reference.pipeline import run_job as reference_job

    if ref is None:
        ref = reference_job(job.argv, device)
    if round_state is None:
        with open(job.output, "rb") as fh:
            got_gfa = fh.read()
        got_layout = (read_tsv(job.layout_out, job.dims)
                      if job.layout_out is not None else None)
    else:
        ctl = reference_job(job.argv, device, round_state)
        got_gfa, got_layout = ctl.gfa.encode(), ctl.layout
    out = {"gfa_lines_differing": lines_differing(got_gfa, ref.gfa.encode())}
    if job.layout_out is not None:
        out["tsv_values_differing"] = tsv_values_differing(got_layout,
                                                           ref.layout)
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             root: Path = ROOT, chip: bool = True,
             work: Optional[Path] = None) -> dict:
    """One run of the cell; returns the result line's object.  ``chip``
    False (the CPU tests) skips the look for a card, runs the reference on
    the CPU and reads no device trace.  ``work``: the directory of the
    jobs' files, by default ``$TMPDIR/gfabench/<cell>``; it is emptied
    first and removed at the end."""
    cell = load_cell(workload, root)
    seed = int(seed) % (1 << 62)
    import torch

    if chip and not (torch.cuda.is_available()
                     and torch.cuda.device_count() >= cell.chips):
        raise NoChip(f"{workload} needs {cell.chips} CUDA device(s); "
                     f"torch sees {torch.cuda.device_count()}")
    from .device_trace import read_trace, silent_layers, traced, wrap_layers
    from .jobs import check_job, make_job, run_job

    card, clock = _card() if chip else ("cpu", 0.0)
    _say(f"cell {workload} seed {seed} card {card}")
    _say(f"host: {host_state()}")
    work = work or Path(tempfile.gettempdir()) / "gfabench" / workload
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        import gfasort_tpu_torch.cli  # noqa: F401

        warm = make_job(cell.config, cell.traffic, work, seed, 0)
        run_job(warm)
        if warm.rc != 0:
            raise RuntimeError(f"the warm-up job failed:\n{warm.error}")
        setup_s = time.perf_counter() - START
        _say(f"set-up {setup_s:.3f} s (warm-up input {warm.gen_s:.3f} s, "
             f"warm-up job {warm.wall_s:.3f} s)")
        for p in (warm.input, warm.output, warm.layout_out):
            if p is not None and p.exists():
                p.unlink()

        jobs, total = [], 0.0
        prof = (traced(work / "trace.json") if trace and chip
                else contextlib.nullcontext(contextlib.nullcontext))
        with prof as span, (wrap_layers(_say) if trace
                            else contextlib.nullcontext()):
            while total < seconds:
                job = make_job(cell.config, cell.traffic, work, seed,
                               len(jobs) + 1)
                run_job(job, span)
                total += job.wall_s
                check_job(job)
                jobs.append(job)
                _say(f"job {job.index}: input {job.gen_s:.3f} s (text "
                     f"{job.text_s:.3f} s, write "
                     f"{job.gen_s - job.text_s:.3f} s), job "
                     f"{job.wall_s:.3f} s, rc {job.rc}"
                     + (f", broke {job.breaks}" if job.breaks else ""))
                if job.error:
                    _say(job.error)
        _say(f"host: {host_state()}")
        tr = read_trace(work / "trace.json") if trace and chip else None
        silent = silent_layers(tr, cell.traffic["pipeline"]) if tr else []
        if silent:
            _say(f"trace: no span of {silent}; their time reads as their "
                 f"parent's")
        device = {"platform": "gpu" if chip else "cpu",
                  "kind": torch.cuda.get_device_name(0) if chip else "cpu",
                  "count": cell.chips,
                  "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                        if chip else 0)}
        if tr is not None:
            device.update(busy_s=tr.busy_s(), window_s=tr.window_s())
        if chip:
            torch.cuda.empty_cache()

        run = Run(cell=cell, setup_s=setup_s, jobs=jobs, trace=tr,
                  clock_mhz=clock,
                  memory_peak_bytes=device["memory_peak_bytes"])
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = metric_reader(m["name"], root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        failed = sum(j.failed for j in jobs)
        numbers = {"failed_jobs": failed}
        sampled = _sample(seed, jobs)
        if sampled is not None:
            t0 = time.perf_counter()
            numbers.update(compare(sampled, "cuda" if chip else "cpu"))
            _say(f"reference of job {sampled.index}: "
                 f"{time.perf_counter() - t0:.3f} s")
        checks, ok = judge(numbers)
        correct = bool(jobs) and sampled is not None and ok
        result = {"correct": correct, "attempted": len(jobs),
                  "failed": failed, "metrics": metrics, "device": device,
                  "card": card}
        if tr is not None:
            result["breakdown"] = {"device_ops": tr.device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoChip as e:
        _say(f"no result: {e}")
        return 2
    bad = forbidden_modules(list(sys.modules))
    if bad:
        _say(f"no result: the process imported {bad}")
        return 3
    for name, c in result["checks"].items():
        _say(f"check {name} = {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    _say(f"malloc keeps freed memory: {keep_freed_memory()}")
    sys.exit(main())
