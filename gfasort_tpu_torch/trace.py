"""Lightweight tracing/observability for pipeline runs.

The reference's only observability is verbosity-gated ``eprintln!``
(SURVEY.md §6); this module adds structured timing: a :class:`Tracer`
records per-step events (name, wall seconds, graph stats) and can emit
them as JSON lines for tooling.  Used by the pipeline runner and CLI
(``--trace-out``).
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List

__all__ = ["Tracer", "TraceEvent"]


@dataclass
class TraceEvent:
    name: str
    seconds: float
    meta: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {"event": self.name, "seconds": round(self.seconds, 6), **self.meta}
        )


@dataclass
class Tracer:
    events: List[TraceEvent] = field(default_factory=list)

    @contextmanager
    def step(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.events.append(
                TraceEvent(name, time.perf_counter() - t0, dict(meta))
            )

    def record(self, name: str, seconds: float = 0.0, **meta) -> None:
        self.events.append(TraceEvent(name, seconds, dict(meta)))

    @property
    def total_seconds(self) -> float:
        return sum(e.seconds for e in self.events)

    def to_json_lines(self) -> str:
        return "\n".join(e.to_json() for e in self.events) + "\n"

    def write(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json_lines())

    def summary(self) -> str:
        lines = [f"{e.name}: {e.seconds * 1e3:.1f} ms" for e in self.events]
        return "; ".join(lines)
