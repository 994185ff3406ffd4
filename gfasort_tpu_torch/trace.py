"""Tracing of a job: nested spans on one clock, counters, and the
``--trace-out`` step log.

A :class:`Tracer` belongs to one job.  It records spans: each has a
name, its start and end in seconds on ``time.perf_counter`` from the
tracer's origin, and its parent span.  ``Tracer.step`` opens the span of
a pipeline step and also records a :class:`TraceEvent` for it.  Code
deep in the program opens spans with the module-level :func:`span` (or
the :func:`spanned` decorator) and adds to named counters with
:func:`count` without being handed the tracer: both find the job's
active tracer (``Tracer.active``) through a context variable, so jobs on
other threads stay apart, and do nothing when no tracer is active.  A
counter counts what the host issues, as it issues it: ``GatherConsensus
.sums`` adds its kernel launches to ``consensus.launches``.  Spans can
be counted too: the number of ``index.build`` spans of a job is the
number of path indexes it built.

While a ``torch.profiler`` session runs, and only then, each span also
opens ``record_function("gfasort." + name)``: the spans then land in the
profiler's Chrome trace, on its clock, beside the device activity.

Spans and counts stay in memory.  ``--trace-out`` writes one JSON line
per step::

    {"event": "SGD", "seconds": 5.1, "step": 2, "nodes": ..., "edges": ...,
     "start": 1.9, "end": 7.0, "counts": {"consensus.launches": 765},
     "spans": [{"name": "index.build", "start": ..., "end": ...,
                "parent": null}, ...]}

``start`` and ``end`` are seconds from the tracer's origin; ``counts``
holds what each counter gained while the step ran (empty where none
did); ``spans`` lists the step's descendants in the order they opened,
each ``parent`` the index in that list of its parent span (null for a
child of the step itself).  Spans outside every step (the GFA read, the
parameters, the writes) add no line.
"""

from __future__ import annotations

import contextlib
import functools
import json
import sys
import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["Tracer", "TraceEvent", "Span", "span", "spanned", "count",
           "PROFILER_PREFIX"]

# the prefix of the spans' names in a profiler trace
PROFILER_PREFIX = "gfasort."

_ACTIVE: ContextVar[Optional["Tracer"]] = ContextVar("gfasort_tracer",
                                                     default=None)
_NOOP = contextlib.nullcontext()


def _profiling() -> bool:
    """Whether a torch profiler session is running (no profiler can run
    before torch is imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


@dataclass
class Span:
    name: str
    start: float                  # seconds from the tracer's origin
    end: Optional[float] = None   # None while open
    parent: Optional[int] = None  # index in Tracer.spans

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class TraceEvent:
    """A pipeline step: its span's name and seconds, the step's meta, the
    span's start and end, what the counters gained inside it, and its
    descendants (``--trace-out``'s ``spans``)."""

    name: str
    seconds: float
    meta: dict = field(default_factory=dict)
    start: float = 0.0
    end: float = 0.0
    spans: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {"event": self.name, "seconds": round(self.seconds, 6),
             **self.meta, "start": round(self.start, 6),
             "end": round(self.end, 6), "counts": self.counts,
             "spans": self.spans}
        )


@dataclass
class Tracer:
    events: List[TraceEvent] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)
    counts: Dict[str, int] = field(default_factory=dict)
    origin: float = field(default_factory=time.perf_counter)
    _open: list = field(default_factory=list, repr=False)

    def now(self) -> float:
        """Seconds from the tracer's origin."""
        return time.perf_counter() - self.origin

    @contextmanager
    def active(self):
        """Make this the tracer that :func:`span` records into, in this
        thread, inside the block."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    @contextmanager
    def span(self, name: str):
        """Record the block as a span named ``name``, a child of the
        innermost open span."""
        rf = None
        if _profiling():
            from torch.autograd.profiler import record_function

            rf = record_function(PROFILER_PREFIX + name)
            rf.__enter__()
        sp = Span(name, self.now(),
                  parent=self._open[-1] if self._open else None)
        self._open.append(len(self.spans))
        self.spans.append(sp)
        try:
            yield sp
        finally:
            sp.end = self.now()
            self._open.pop()
            if rf is not None:
                rf.__exit__(None, None, None)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        self.counts[name] = self.counts.get(name, 0) + n

    @contextmanager
    def step(self, name: str, **meta):
        """A pipeline step: a span, and a :class:`TraceEvent` once it
        ends."""
        i = len(self.spans)
        before = dict(self.counts)
        try:
            with self.span(name):
                yield
        finally:
            sp, inner = self.spans[i], self.spans[i + 1:]
            self.events.append(TraceEvent(
                name, sp.seconds, dict(meta), sp.start, sp.end,
                [{"name": s.name, "start": round(s.start, 6),
                  "end": round(s.end, 6),
                  "parent": None if s.parent == i else s.parent - i - 1}
                 for s in inner],
                {k: v - before.get(k, 0) for k, v in self.counts.items()
                 if v != before.get(k, 0)}))

    def to_json_lines(self) -> str:
        return "\n".join(e.to_json() for e in self.events) + "\n"

    def write(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json_lines())

    def summary(self) -> str:
        lines = [f"{e.name}: {e.seconds * 1e3:.1f} ms" for e in self.events]
        return "; ".join(lines)


def span(name: str):
    """A span named ``name`` in the active tracer; a shared no-op context
    where no tracer is active."""
    tracer = _ACTIVE.get()
    return _NOOP if tracer is None else tracer.span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the active tracer; nothing
    where no tracer is active."""
    tracer = _ACTIVE.get()
    if tracer is not None:
        tracer.count(name, n)


def spanned(name: str):
    """Decorator: each call of the function is a :func:`span`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
