"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
window, spans that the harness records around the calls into the
program's layers, and what the per-layer metrics read from them.

Spans come from this package, never from inside the program: the job
(the call of ``cli.main``) and, where the program still has them under
these names, the GFA read (``io.fast_gfa.load_gfa_numeric_fast``), the
pipeline's steps (``pipeline.topological_sort_only``, ``groom_only``,
``sgd_sort_only``, ``layout_step``) and the writes (``io.gfa.write_gfa``,
``io.layout_tsv.Layout.write_tsv_file``), and ``pipeline.run_pipeline``
around the steps (the parameters and indexes it derives first).  They
are wrapped only in a traced run.  Device activity (kernels, copies,
sets) and the spans are read from the profiler's Chrome trace, on one
clock.
"""

from __future__ import annotations

import contextlib
import json
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path

__all__ = ["KERNEL_FAMILIES", "TraceData", "traced", "wrap_layers",
           "silent_layers", "read_trace"]

JOB_SPAN = "gfabench.job"
STEP_PREFIX = "gfabench.layer."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# The sweep kernels of the roofline metrics, by the name the profiler
# gives their launches (csrc/sweep_sampler.cu, bucket_apply.cu,
# dense_apply_nd.cu, roll_apply.cu)
KERNEL_FAMILIES = {
    "sort": ("sweep_sampler_kernel", "bucket_apply_kernel",
             "roll_apply_kernel"),
    "layout": ("sweep_sampler_kernel", "dense_apply_nd_kernel",
               "roll_apply_nd_kernel"),
}

_LAYERS = (
    ("gfasort_tpu_torch.io.fast_gfa", "load_gfa_numeric_fast", "gfa read"),
    ("gfasort_tpu_torch.pipeline", "run_pipeline", "pipeline"),
    ("gfasort_tpu_torch.pipeline", "topological_sort_only", "topo-sort"),
    ("gfasort_tpu_torch.pipeline", "groom_only", "groom"),
    ("gfasort_tpu_torch.pipeline", "sgd_sort_only", "SGD"),
    ("gfasort_tpu_torch.pipeline", "layout_step", "layout"),
    ("gfasort_tpu_torch.io.gfa", "write_gfa", "gfa write"),
)


@dataclass
class TraceData:
    jobs: list          # [(start_us, end_us)] of the window's jobs
    spans: list         # [(label, start_us, end_us)] of the layer spans
    device: list        # [(name, start_us, end_us)] device activity

    def window_s(self) -> float:
        return sum(b - a for a, b in self.jobs) * 1e-6

    def _busy(self):
        """Union of device activity inside the jobs: [(start, end)]."""
        out = []
        for a, b in sorted((max(s, j0), min(e, j1))
                           for _, s, e in self.device
                           for j0, j1 in self.jobs if s < j1 and e > j0):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def kernel_s(self, families) -> float:
        """Device seconds of the launches whose names hold one of
        ``families``, inside the jobs."""
        return sum(min(e, j1) - max(s, j0)
                   for n, s, e in self.device if any(f in n for f in families)
                   for j0, j1 in self.jobs if s < j1 and e > j0) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time
        inside the jobs."""
        tot = defaultdict(float)
        for n, s, e in self.device:
            for j0, j1 in self.jobs:
                if s < j1 and e > j0:
                    tot[n] += (min(e, j1) - max(s, j0)) * 1e-6
        return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])
                ][:top]

    def idle_gaps(self, top: int = 10) -> list:
        """[[label, seconds]]: the seconds of the jobs with nothing on the
        device, by what the host was doing then (the innermost layer span;
        ``cli`` outside every span), the largest first."""
        busy = self._busy()
        cuts = sorted({t for _, s, e in self.spans for t in (s, e)})
        tot = defaultdict(float)
        for j0, j1 in self.jobs:
            t, gaps = j0, []
            for a, b in busy:
                if b <= j0 or a >= j1:
                    continue
                if a > t:
                    gaps.append((t, a))
                t = max(t, b)
            if t < j1:
                gaps.append((t, j1))
            for a, b in gaps:
                # split each gap where a span starts or ends
                edges = [a] + [c for c in cuts if a < c < b] + [b]
                for p, q in zip(edges, edges[1:]):
                    mid = (p + q) / 2
                    inner = [(e - s, lab) for lab, s, e in self.spans
                             if s <= mid <= e]
                    tot[min(inner)[1] if inner else "cli"] += (q - p) * 1e-6
        return [[lab, t] for lab, t in sorted(tot.items(),
                                               key=lambda kv: -kv[1])][:top]


@contextlib.contextmanager
def traced(path: Path):
    """Profile the device and the host spans inside the block into the
    Chrome trace ``path``; yields the job-span factory."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        # a fill first: after a long unprofiled run the profiler can drop
        # a session's first device activity
        torch.zeros(1 << 20, device="cuda").add_(1)
        torch.cuda.synchronize()
        yield lambda: record_function(JOB_SPAN)
    prof.export_chrome_trace(str(path))


@contextlib.contextmanager
def wrap_layers(warn=print):
    """Wrap the program's layer entry points named in ``_LAYERS`` in
    profiler spans; restore them on exit.  ``warn(text)`` is told of each
    name the program no longer has: its layer goes unlabelled."""
    import importlib

    from torch.profiler import record_function

    def wrapped(fn, label):
        def call(*a, **kw):
            with record_function(STEP_PREFIX + label):
                return fn(*a, **kw)
        return call

    saved = []
    targets = [(importlib.import_module(m), name, label)
               for m, name, label in _LAYERS]
    layout_tsv = importlib.import_module("gfasort_tpu_torch.io.layout_tsv")
    layout_cls = getattr(layout_tsv, "Layout", None)
    if layout_cls is None:
        warn("trace: no Layout in gfasort_tpu_torch.io.layout_tsv; the "
             "'tsv write' layer goes unlabelled")
    else:
        targets.append((layout_cls, "write_tsv_file", "tsv write"))
    try:
        for owner, name, label in targets:
            fn = getattr(owner, name, None)
            if fn is None:
                warn(f"trace: no {name} in {getattr(owner, '__name__', owner)}"
                     f"; the {label!r} layer goes unlabelled")
                continue
            saved.append((owner, name, fn))
            setattr(owner, name, wrapped(fn, label))
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def silent_layers(trace: TraceData, steps: str) -> list:
    """The labels of ``_LAYERS`` that a job of pipeline ``steps`` runs
    but that left no span in ``trace``: a wrapped name the program no
    longer calls (it calls another name, or a copy bound by import)."""
    want = {"gfa read", "pipeline", "gfa write"}
    want |= {lab for c, lab in (("s", "topo-sort"), ("g", "groom"),
                                ("Y", "SGD"), ("L", "layout")) if c in steps}
    return sorted(want - {lab for lab, _, _ in trace.spans})


def read_trace(path: Path) -> TraceData:
    """The job spans, layer spans and device activity of a Chrome trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    jobs, spans, device = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0))
        name = ev.get("name", "")
        cat = ev.get("cat")
        if cat in _DEVICE_CATS:
            device.append((name, s, e))
        elif cat != "user_annotation":
            continue
        elif name == JOB_SPAN:
            jobs.append((s, e))
        elif name.startswith(STEP_PREFIX):
            spans.append((name[len(STEP_PREFIX):], s, e))
    return TraceData(jobs=sorted(jobs), spans=spans, device=device)
