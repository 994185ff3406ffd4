"""The harness on the CPU: a short window of tiny jobs, the no-JAX check,
cells, mixes and metrics found by name, and the refusal without a card."""

from __future__ import annotations

import json
import sys
import types

import pytest

import numpy as np

from gfabench import run as R
from gfabench.generator import job_seed, write_pangenome_gfa
from gfabench.gfa_tokens import parse_steps
from gfabench.spec import load_cell, metric_reader
from gfabench.tests.conftest import graph_config, make_root


def test_two_job_window_on_the_cpu(tmp_path, monkeypatch):
    """A traced run: the step metrics are read, the device metrics (CUDA
    only) are left out, and the jobs agree with the reference.  Each job's
    time is read as 1 s, so a 1.5 s window holds two."""
    import gfabench.jobs as J

    run_job = J.run_job

    def one_second(job, *a, **k):
        run_job(job, *a, **k)
        job.wall_s = 1.0
    monkeypatch.setattr(J, "run_job", one_second)
    root = make_root(tmp_path, graph_config(paths=3, haplotype_bp=90_000))
    res = R.run_cell("chr-sort.sYgs", 2**31 + 99, 1.5, True, root=root,
                       chip=False, work=tmp_path / "work")
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] == 2
    assert set(res["metrics"]) == {"cli_io_s.sort", "host_steps_s",
                                   "sgd_step_s", "job_s.sort"}
    # cli_io_s.sort and job_s.sort read the job time, set to 1 s here
    assert res["metrics"]["job_s.sort"] == {"value": 1.0, "unit": "s"}
    assert res["metrics"]["host_steps_s"]["value"] > 0
    assert res["metrics"]["sgd_step_s"]["value"] > 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["gfa_lines_differing"] == {"value": 0, "limit": 0}


def test_end_to_end_metrics_of_a_layout_cell(tiny_root, tmp_path):
    """An untraced run on the CPU: the set-up time, which holds the whole
    warm-up job, and no device memory peak, since there is no card."""
    res = R.run_cell("chr-layout.L2d", 5, 0.1, False, root=tiny_root,
                       chip=False, work=tmp_path / "work")
    assert res["correct"] and res["attempted"] == 1
    assert set(res["metrics"]) == {"setup_s"}
    assert res["metrics"]["setup_s"]["value"] > 0
    assert res["device"]["memory_peak_bytes"] == 0
    assert res["checks"]["tsv_values_differing"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("peak,want", [(0, None), (3 * 2**29, 1.5)])
def test_device_peak_in_gib_and_none_without_a_card(peak, want):
    read = metric_reader("device_peak_gib")
    run = R.Run(cell=None, setup_s=1.0, jobs=[], trace=None, clock_mhz=0.0,
                memory_peak_bytes=peak)
    assert read(run) == want


@pytest.mark.parametrize("names,found", [
    (["gfasort_tpu_torch", "gfasort_tpu_torch.cli", "numpy"], []),
    (["gfasort_tpu.cli"], ["gfasort_tpu"]),
    (["gfasort_tpu"], ["gfasort_tpu"]),
    (["jax.numpy", "torch"], ["jax"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib"]),
    (["jaxtyping", "flaxen", "gfasort_tpu_x"], []),
])
def test_forbidden_modules_by_whole_top_level_name(names, found):
    assert R.forbidden_modules(names) == found


def test_no_result_once_the_jax_package_is_loaded(monkeypatch, capsys):
    monkeypatch.setattr(R, "run_cell", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "gfasort_tpu.fake",
                        types.ModuleType("gfasort_tpu.fake"))
    rc = R.main(["--workload", "x", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "gfasort_tpu" in out.err


def test_no_result_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = R.main(["--workload", "chr-sort.sYgs", "--seed", "1",
                 "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_new_files_are_found_by_name(tiny_root, tmp_path):
    """A configuration, a traffic mix and a metric added as files, and the
    cell naming them in BENCHMARK.json, run with no file edited."""
    data = tiny_root / "gfabench"
    cfg = json.loads((data / "configs" / "tiny.json").read_text())
    cfg.update(name="tinier", haplotype_bp=350_000)
    (data / "configs" / "tinier.json").write_text(json.dumps(cfg))
    (data / "traffic" / "gY.json").write_text(json.dumps({
        "pipeline": "gY", "argv": ["--engine", "sweep", "--device", "cpu"]}))
    (data / "metrics" / "jobs_run.py").write_text(
        '"""jobs_run: the window\'s job count."""\n\n\n'
        "def read(run):\n    return len(run.jobs)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tinier",
                                 file="gfabench/configs/tinier.json"))
    bench["workloads"].append({"name": "tinier.gY", "config": "tinier",
                               "traffic": "gY", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "jobs_run", "unit": "jobs",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["tinier.gY"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("tinier.gY", tiny_root)
    assert cell.config["haplotype_bp"] == 350_000
    assert cell.traffic["pipeline"] == "gY"
    res = R.run_cell("tinier.gY", 3, 0.1, False, root=tiny_root,
                       chip=False, work=tmp_path / "work")
    assert res["correct"]
    assert res["metrics"]["jobs_run"] == {"value": 1, "unit": "jobs"}
    assert "setup_s" in res["metrics"]


# a graph with a collapsed satellite: 4 of 5 paths walk a 100 bp unit (2
# SNV sites) 33-40 times, so its first node has 132 steps or more
SATELLITE = dict(graph_config(paths=5, haplotype_bp=120_000),
                 repeat_arrays=[{"at": 0.43, "unit_bp": 100,
                                 "unit_theta": 0.01, "copies": [33, 40],
                                 "absent_share": 0.2}])


@pytest.mark.parametrize("cell", ["chr-sort.sYgs", "chr-layout.L2d"])
def test_a_looped_graph_runs_through_the_cells(tmp_path, cell):
    """A configuration with a repeat array, in a cell as its files give
    it: the jobs pass their invariants and equal the reference, with a
    node wider than the 128 steps of the consensus's widest run class."""
    root = make_root(tmp_path, SATELLITE)
    seed = 2**31 + 41
    res = R.run_cell(cell, seed, 0.1, False, root=root, chip=False,
                     work=tmp_path / "work")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 1
    assert all(c["value"] == 0 for c in res["checks"].values())
    write_pangenome_gfa(tmp_path / "job1.gfa",
                        load_cell(cell, root).config, job_seed(seed, 1))
    deg = np.zeros(1, dtype=np.int64)
    for line in (tmp_path / "job1.gfa").read_bytes().split(b"\n"):
        if line.startswith(b"P\t"):
            ids, _ = parse_steps(line.split(b"\t")[2])
            deg = np.pad(deg, (0, max(0, int(ids.max()) + 1 - len(deg))))
            np.add.at(deg, ids, 1)
    assert deg.max() > 128


def test_freed_memory_is_kept_for_the_next_job():
    """Once ``keep_freed_memory`` has run, an array of a freed one's size
    takes its pages without faulting them in again; without it, it faults
    them anew.  Each side in a process of its own: the setting holds for
    the whole process."""
    import subprocess
    from pathlib import Path

    code = (
        "import resource, sys, numpy as np\n"
        "from gfabench.run import keep_freed_memory\n"
        "kept = keep_freed_memory() if sys.argv[1] == '1' else False\n"
        "def faults():\n"
        "    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt\n"
        "x = np.ones(1 << 25); del x\n"
        "before = faults(); x = np.ones(1 << 25); del x\n"
        "print(kept, faults() - before)\n")
    root = Path(R.__file__).resolve().parents[1]
    got = {}
    for keep in ("1", "0"):
        out = subprocess.run([sys.executable, "-c", code, keep], cwd=root,
                             capture_output=True, text=True, check=True)
        kept, faults = out.stdout.split()
        got[keep] = (kept, int(faults))
    assert got["1"][0] == "True" and got["0"][0] == "False"
    assert got["1"][1] * 10 < got["0"][1]
