"""What the metric readers under ``metrics/`` share: each reader is a file
of its own that calls one of these on the finished run
(:class:`gfabench.run.Run`) and returns a number, or None where the run
holds nothing to read."""

from __future__ import annotations

from statistics import fmean

from .bounds import layout_step_bound_ms, sort_step_bound_ms
from .device_trace import KERNEL_FAMILIES

__all__ = ["mean_job_s", "mean_cli_io_s", "mean_step_s", "roofline_pct",
           "idle_pct"]


def mean_job_s(run):
    """The window's summed job seconds over its job count (host clock,
    from the call of ``cli.main`` to its return)."""
    return fmean(j.wall_s for j in run.jobs) if run.jobs else None


def mean_cli_io_s(run):
    """Per job, its seconds outside the steps of its ``--trace-out`` log
    (the GFA read, the writes, the CLI's own work), averaged."""
    vals = [j.wall_s - sum(e["seconds"] for e in j.steps)
            for j in run.jobs if j.steps]
    return fmean(vals) if vals else None


def mean_step_s(run, match):
    """Per job, the summed seconds of its logged steps whose event name
    ``match`` accepts, averaged; None where no job logged such a step."""
    vals = [sum(e["seconds"] for e in j.steps if match(e["event"]))
            for j in run.jobs
            if any(match(e["event"]) for e in j.steps)]
    return fmean(vals) if vals else None


def roofline_pct(run, kind: str):
    """100 x the bound of the window's sweep kernels (``bounds``, from
    each job's input and the reference's plan) over the device seconds of
    the launches of those kernels inside the jobs; ``kind`` "sort" or
    "layout".  None without a device trace or where no such kernel ran."""
    if run.trace is None:
        return None
    busy = run.trace.kernel_s(KERNEL_FAMILIES[kind])
    if busy <= 0:
        return None
    cfg, steps = run.cell.config, run.cell.traffic["pipeline"]
    if kind == "sort":
        bound = steps.count("Y") * sum(
            sort_step_bound_ms(j.shape, cfg["iter_max"], run.clock_mhz)
            for j in run.jobs)
    else:
        bound = steps.count("L") * sum(
            layout_step_bound_ms(j.shape, cfg["dimensions"],
                                 cfg["layout_iter"], run.clock_mhz)
            for j in run.jobs)
    return 100.0 * bound * 1e-3 / busy


def idle_pct(run):
    """100 x the share of the window's job time with nothing on the
    device.  None without a device trace."""
    if run.trace is None or run.trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
