"""Fixtures of the benchmark's CPU tests: a checkout root in a temporary
directory that holds a copy of ``gfabench/`` and a ``BENCHMARK.json`` of
small cells on the CPU (``--engine sweep --device cpu``, the plain
versions of the program's kernels), and the ``cuda`` marker."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from gfabench.generator import GRAPH_KEYS

REPO = Path(__file__).resolve().parents[2]

CPU_ARGV = ["--engine", "sweep", "--device", "cpu"]


def graph_config(paths: int, haplotype_bp: int, **over) -> dict:
    """``hprc-chr-sort``'s graph keys at a test's size: ``paths``
    haplotypes of ``haplotype_bp`` bases, with inversions frequent enough
    to occur at that size."""
    cfg = json.loads((REPO / "gfabench" / "configs" /
                      "hprc-chr-sort.json").read_text())
    cfg.update(paths=paths, haplotype_bp=haplotype_bp,
               inversions_per_mbp=8.0, inversion_bp=[2000, 20000])
    cfg.update(over)
    return {k: cfg[k] for k in GRAPH_KEYS}


# a graph that runs a job in about a second on the CPU (2,850 nodes)
TINY = graph_config(paths=4, haplotype_bp=700_000)
# the engines' large regime (S >= 2**18: P = 12, 12 rotation phases, the
# bucket pass and the roll passes): 48,000 nodes, 290,000 steps
LARGE = graph_config(paths=9, haplotype_bp=8_000_000)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda_card():
    """Skip unless a CUDA card is there (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def make_root(tmp: Path, sizes=TINY, argv=CPU_ARGV) -> Path:
    """A checkout root under ``tmp``: this package copied, with the
    configuration ``tiny`` (``hprc-chr-sort`` at ``sizes``), every traffic
    mix with ``argv`` added, and a ``BENCHMARK.json`` whose cells are the
    repository's on ``tiny``."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "gfabench", root / "gfabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = root / "gfabench"
    cfg = json.loads((data / "configs" / "hprc-chr-sort.json").read_text())
    cfg.update(name="tiny", **sizes)
    (data / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for f in (data / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t["argv"] = list(t.get("argv", [])) + list(argv)
        f.write_text(json.dumps(t))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="gfabench/configs/tiny.json")]
    bench["workloads"] = [dict(w, config="tiny") for w in bench["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
