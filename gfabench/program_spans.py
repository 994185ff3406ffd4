"""The program's own spans in the device trace of a ``--trace 1`` run.

While the profiler runs, the program opens ``record_function("gfasort."
+ name)`` for each span it records (``gfasort_tpu_torch/trace.py``): the
GFA read and writes, its parameters, the pipeline's steps and the work
inside them.  This module reads those spans and the device activity from
the run's Chrome trace (``trace.json`` in the run's work directory, which
holds each job's files), parsed once per run, and gives what the
per-layer metrics under ``metrics/`` read: the seconds the named spans
cover, their count, and the device's idle share inside them, per job
(inside each job span) and averaged over the window's jobs.  Each
returns None where the run has no trace or the program left no such span.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from statistics import fmean
from typing import Optional

from .device_trace import _DEVICE_CATS, JOB_SPAN

__all__ = ["PREFIX", "JobSpans", "parse", "job_spans", "spans_s",
           "span_count", "idle_pct_in", "layout_step"]

PREFIX = "gfasort."

# a child may end this many microseconds past its parent in the trace's
# rounding
_EPS_US = 1.0


@dataclass
class JobSpans:
    """One job's program spans, [(name, start_us, end_us, names of the
    spans around it)], and the device's busy intervals inside the job,
    [(start_us, end_us)], disjoint and sorted."""

    spans: list
    busy: list


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(busy, a, b) -> float:
    return sum(min(e, b) - max(s, a) for s, e in busy if s < b and e > a)


def parse(path: Path) -> list:
    """The :class:`JobSpans` of each job span of the Chrome trace at
    ``path``, in job order."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    jobs, prog, device = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0))
        name = ev.get("name", "")
        cat = ev.get("cat")
        if cat in _DEVICE_CATS:
            device.append((s, e))
        elif cat != "user_annotation":
            continue
        elif name == JOB_SPAN:
            jobs.append((s, e))
        elif name.startswith(PREFIX):
            prog.append((name[len(PREFIX):], s, e))
    busy = _union(device)
    out = []
    for j0, j1 in sorted(jobs):
        stack, spans = [], []
        for n, s, e in sorted((p for p in prog if j0 <= p[1] and p[2] <= j1),
                              key=lambda p: (p[1], -p[2])):
            while stack and e > stack[-1][2] + _EPS_US:
                stack.pop()
            spans.append((n, s, e, frozenset(p[0] for p in stack)))
            stack.append((n, s, e))
        out.append(JobSpans(spans, [(max(a, j0), min(b, j1))
                                    for a, b in busy if a < j1 and b > j0]))
    return out


@lru_cache(maxsize=1)
def _parsed(path: str, stamp: tuple) -> list:
    return parse(Path(path))


def job_spans(run) -> Optional[list]:
    """The window's :class:`JobSpans` from the run's trace; None without
    a trace."""
    if run.trace is None or not run.jobs:
        return None
    path = run.jobs[0].trace_out.parent / "trace.json"
    try:
        st = path.stat()
    except OSError:
        return None
    return _parsed(str(path), (st.st_mtime_ns, st.st_size))


def _select(job: JobSpans, names, inside, outside) -> list:
    return [(s, e) for n, s, e, around in job.spans
            if n in names and (inside is None or inside in around)
            and (outside is None or outside not in around)]


def spans_s(run, names, inside=None, outside=None):
    """Per job, the seconds that the spans named in ``names`` cover (each
    instant once, where one such span lies inside another), counting
    only spans inside a span named ``inside`` and inside no span named
    ``outside``, where given; averaged over the jobs.  None where no job
    has such a span."""
    jobs = job_spans(run)
    if jobs is None:
        return None
    picked = [_select(j, names, inside, outside) for j in jobs]
    if not any(picked):
        return None
    return fmean(sum(b - a for a, b in _union(p)) * 1e-6 for p in picked)


def span_count(run, name):
    """Per job, the number of spans named ``name``, averaged over the
    jobs; None where no job has one."""
    jobs = job_spans(run)
    if jobs is None:
        return None
    counts = [sum(n == name for n, *_ in j.spans) for j in jobs]
    return fmean(counts) if any(counts) else None


def idle_pct_in(run, name, inside=None):
    """100 x the share of the time of the spans named ``name`` (inside a
    span named ``inside``, where given) with nothing on the device, over
    the window's jobs; None where there is no such span."""
    jobs = job_spans(run)
    if jobs is None:
        return None
    total = idle = 0.0
    for j in jobs:
        for a, b in _union(_select(j, (name,), inside, None)):
            total += b - a
            idle += b - a - _overlap(j.busy, a, b)
    return 100.0 * idle / total if total > 0 else None


def layout_step(run) -> str:
    """The name of the cell's ``L`` step span, by its dimensions."""
    return f"{int(run.cell.config['dimensions'])}D layout"
