"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``traffic/<traffic>.json`` and
one reader per metric, ``metrics/<metric>.py``.  A later cell, mix or
metric is a new file; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["ROOT", "Cell", "load_cell", "metric_reader", "metrics_of"]

# the root of the checkout: BENCHMARK.json, and this package as gfabench/
ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    end_to_end: list    # the BENCHMARK.json entries this cell reports
    per_layer: list


def _read(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def metrics_of(entries: list, cell: str) -> list:
    """The entries that ``cell`` reports: those whose ``workloads`` name
    it, and those without the key."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration
    and traffic mix (files under ``root/gfabench``, found by name)."""
    bench = _read(root / "BENCHMARK.json")
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_read(root / "gfabench" / "configs" / f"{w['config']}.json"),
        traffic=_read(root / "gfabench" / "traffic" / f"{w['traffic']}.json"),
        end_to_end=metrics_of(bench["end_to_end"], name),
        per_layer=metrics_of(bench["per_layer"], name))


def metric_reader(name: str, root: Path = ROOT):
    """``read(run)`` of ``gfabench/metrics/<name>.py`` under ``root``: the
    metric's value from a finished run, or None where the run holds
    nothing to read."""
    path = root / "gfabench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gfabench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
