"""One CLI job of a cell: its input made from the seed, its argv, the call
of ``gfasort_tpu_torch.cli.main`` in this process (the warm-process path
of ``gfasort_tpu_torch/server.py::_run_job``), timed on the host clock,
and the invariants of what it wrote."""

from __future__ import annotations

import contextlib
import io
import json
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .bounds import GraphShape
from .gfa_check import (GfaSummary, invariant_breaks, read_tsv, summarize)
from .generator import job_seed, write_pangenome_gfa

__all__ = ["Job", "make_job", "run_job", "check_job"]


@dataclass
class Job:
    index: int
    argv: list
    input: Path
    output: Path
    trace_out: Path
    layout_out: Optional[Path]
    dims: int
    gen_s: float = 0.0               # making the input, off the job clock
    text_s: float = 0.0              # of gen_s, making its text
    wall_s: Optional[float] = None   # cli.main's call to its return
    rc: Optional[int] = None
    error: str = ""                  # the end of the job's log on failure
    steps: list = field(default_factory=list)   # the --trace-out events
    before: Optional[GfaSummary] = None
    breaks: list = field(default_factory=list)

    @property
    def failed(self) -> bool:
        return self.rc != 0 or bool(self.breaks)

    @property
    def shape(self) -> GraphShape:
        return GraphShape.of(self.before)


def make_job(config: dict, traffic: dict, work: Path, seed: int,
             index: int) -> Job:
    """Write job ``index``'s input (the configuration's graph for the pair
    (seed, index)) and return the job, not yet run."""
    t0 = time.perf_counter()
    inp = work / f"in-{index}.gfa"
    text_s = write_pangenome_gfa(inp, config, job_seed(seed, index))
    out = work / f"out-{index}.gfa"
    steps = work / f"steps-{index}.jsonl"
    argv = ["-i", str(inp), "-o", str(out), "-p", traffic["pipeline"]]
    argv += list(traffic.get("argv", []))
    layout = None
    if traffic.get("layout_out"):
        layout = work / f"layout-{index}.tsv"
        argv += ["--layout-out", str(layout)]
    argv += ["--trace-out", str(steps)]
    return Job(index=index, argv=argv, input=inp, output=out,
               trace_out=steps, layout_out=layout,
               dims=int(config["dimensions"]),
               gen_s=time.perf_counter() - t0, text_s=text_s)


def run_job(job: Job, span=contextlib.nullcontext) -> None:
    """Run the job through the CLI entry, its log captured as the warm
    process captures it; ``span()`` wraps the timed call (the device
    trace's job span in a traced run)."""
    from gfasort_tpu_torch import cli

    log = io.StringIO()
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        t0 = time.perf_counter()
        try:
            with span():
                job.rc = cli.main(job.argv)
        except SystemExit as e:
            job.rc = int(e.code or 0) if isinstance(e.code, int) else 1
        except Exception:  # noqa: BLE001 - a failed job is counted, not fatal
            job.rc = 1
            log.write(traceback.format_exc())
        job.wall_s = time.perf_counter() - t0
    if job.rc != 0:
        job.error = log.getvalue()[-2000:]
    if job.trace_out.exists():
        with open(job.trace_out) as fh:
            job.steps = [json.loads(line) for line in fh if line.strip()]


def check_job(job: Job) -> None:
    """The invariants of the job's files against its input: node and edge
    counts, every path's SHA-256, and for a layout both ends of every node
    finite."""
    job.before = summarize(job.input)
    if job.rc != 0:
        return
    try:
        job.breaks = invariant_breaks(job.before, summarize(job.output))
        if job.layout_out is not None:
            coords = read_tsv(job.layout_out, job.dims)
            if len(coords) != 2 * job.before.nodes:
                job.breaks.append(f"{len(coords) // 2} layout rows for "
                                  f"{job.before.nodes} nodes")
            elif not (abs(coords) < float("inf")).all():
                job.breaks.append("a layout coordinate is not finite")
    except (OSError, ValueError) as e:
        job.breaks.append(f"unreadable output: {e}")
