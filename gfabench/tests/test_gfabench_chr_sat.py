"""The cell ``chr-sat.sYgs`` and its configuration ``hprc-chr-sat`` (a
chromosome graph whose alpha-satellite array is collapsed into a loop): it
loads by name, its copy range fixes the widest consensus class on every
seed, a graph of its shape at a test's size runs through the cell as
``correct`` with the consensus's launches counted, and its eight readers
read a synthetic run, or give None where the run holds nothing to read
(as a run of a program without the consensus span and counter does)."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

from gfabench import run as R
from gfabench.bounds import GraphShape, _sort_plan, sort_step_bound_ms
from gfabench.generator import job_seed, pangenome_gfa, write_pangenome_gfa
from gfabench.gfa_check import summarize
from gfabench.gfa_tokens import parse_steps
from gfabench.spec import load_cell, metric_reader
from gfabench.tests.conftest import graph_config, make_root

CELL = "chr-sat.sYgs"
SAT = ("job_s.sat", "sgd_sweeps_s.sat", "consensus_s.sat",
       "consensus_idle_pct.sat", "consensus_launches.sat",
       "host_steps_s.sat", "sweep_roofline_pct.sat", "device_idle_pct.sat")


def _degrees(gfa: bytes) -> tuple:
    """(steps per node id, the set of paths that visit each node id) of a
    generated GFA."""
    deg, visits = np.zeros(1, dtype=np.int64), []
    for line in gfa.split(b"\n"):
        if line.startswith(b"P\t"):
            ids, _ = parse_steps(line.split(b"\t")[2])
            deg = np.pad(deg, (0, max(0, int(ids.max()) + 1 - len(deg))))
            np.add.at(deg, ids, 1)
            visits.append(ids)
    return deg, visits


def test_the_cell_loads_by_name():
    cell = load_cell(CELL)
    assert cell.chips == 1
    assert cell.config["name"] == "hprc-chr-sat"
    assert cell.traffic["pipeline"] == "sYgs"
    (arr,) = cell.config["repeat_arrays"]
    assert arr["copies"] == [940, 1040] and arr["unit_bp"] == 2052
    assert {m["name"] for m in cell.end_to_end} == {"device_peak_gib",
                                                    "setup_s"}
    assert [m["name"] for m in cell.per_layer] == list(SAT)
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    (cfg,) = [c for c in bench["configs"] if c["name"] == "hprc-chr-sat"]
    assert cfg["reduced"] == ["haplotype_bp", "copies"]
    assert set(cfg["reduced"]) <= set(cell.config["reduced"])


def test_the_copy_range_fixes_the_widest_class():
    """The carriers are paths - round(absent_share x paths) = 63; a unit
    node's degree is their copy sum, which lies in (32,768, 65,536) for
    every draw: the widest class is 65,536 on every seed.  The generator
    at a test's length and copy count makes that many carriers."""
    cfg = load_cell(CELL).config
    (arr,) = cfg["repeat_arrays"]
    carriers = cfg["paths"] - round(arr["absent_share"] * cfg["paths"])
    lo, hi = arr["copies"]
    assert carriers == 63
    assert carriers * hi < 65_536 and carriers * lo > 32_768
    small = dict({k: cfg[k] for k in ("paths", "theta", "indel_share",
                                      "max_indel_bp", "inversions_per_mbp",
                                      "inversion_bp", "reversed_share",
                                      "chrom")},
                 haplotype_bp=20_000,
                 repeat_arrays=[dict(arr, copies=[2, 3])])
    deg, visits = _degrees(pangenome_gfa(seed=job_seed(2**33 + 5, 1),
                                         **small))
    top = int(np.argmax(deg))
    assert sum(bool((ids == top).any()) for ids in visits) == carriers
    assert 2 * carriers <= deg[top] <= 3 * carriers


# the configuration at a test's size on the CPU: its array's unit, sites
# and shares kept, 4 paths (3 carriers) with 50-60 copies each, so a unit
# node has 150-180 steps (a class of 256, above the JAX row cap of 128)
def _small_sat():
    (arr,) = load_cell(CELL).config["repeat_arrays"]
    return dict(graph_config(paths=4, haplotype_bp=700_000),
                repeat_arrays=[dict(arr, copies=[50, 60])])


def test_a_small_graph_of_the_shape_runs_through_the_cell(tmp_path):
    """A traced run on the CPU: the jobs equal the reference, and the SGD
    line counts as many consensus launches as the graph's width classes
    and the plan's consensus periods give; the readers of the device
    trace (CUDA only) are left out."""
    root = make_root(tmp_path, _small_sat())
    seed = 2**33 + 17
    res = R.run_cell(CELL, seed, 0.1, True, root=root, chip=False,
                     work=tmp_path / "work")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 1
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) == {"job_s.sat", "host_steps_s.sat",
                                   "consensus_launches.sat"}

    cfg = load_cell(CELL, root).config
    path = tmp_path / "job1.gfa"
    write_pangenome_gfa(path, cfg, job_seed(seed, 1))
    deg, _ = _degrees(path.read_bytes())
    assert deg.max() > 128
    widths = {1 << (int(d) - 1).bit_length() for d in deg if d > 0}
    plan = _sort_plan(GraphShape.of(summarize(path)), cfg["iter_max"])
    periods = plan.n_exec // plan.consensus_every
    assert periods >= 1
    assert res["metrics"]["consensus_launches.sat"]["value"] == (
        periods * (3 + sum(widths)))


def _x(name, ts, end, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
            "pid": 1, "tid": 1}


def _g(name, ts, end):
    return _x("gfasort." + name, ts, end)


# two sort jobs, times in microseconds: consensus spans inside sweep.run
EVENTS = [
    _x("gfabench.job", 0, 1000),
    _g("topo-sort", 50, 100),
    _g("SGD", 100, 800),
    _g("sweep.run", 200, 700),
    _g("sweep.consensus", 300, 400), _g("sweep.consensus", 500, 600),
    _g("groom", 800, 900),
    # device: 50 us in the first consensus, 100 us around the second
    _x("kernel_a", 350, 400, "kernel"), _x("kernel_b", 450, 550, "kernel"),

    _x("gfabench.job", 2000, 3000),
    _g("SGD", 2100, 2900),
    _g("sweep.run", 2200, 2800),
    _g("sweep.consensus", 2300, 2500),
    _x("kernel_c", 2300, 2350, "kernel"),
]


def _steps(launches):
    counts = {} if launches is None else {"consensus.launches": launches}
    return [{"event": "topo-sort", "seconds": 1.0, "counts": {}},
            {"event": "SGD", "seconds": 5.0, "counts": counts},
            {"event": "groom", "seconds": 0.5, "counts": {}},
            {"event": "topo-sort", "seconds": 1.5, "counts": {}}]


def _run(tmp_path, events, launches=(1000, 3000), with_trace=True):
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    shape = GraphShape(total_steps=400_000, num_nodes=5_000,
                       max_path_step_count=100_000,
                       sum_path_step_count=400_000, max_path_length=400_000)
    jobs = [SimpleNamespace(trace_out=tmp_path / f"steps-{i}.jsonl",
                            wall_s=w, steps=_steps(n), shape=shape)
            for i, (w, n) in enumerate(zip((10.0, 14.0), launches), 1)]
    trace = SimpleNamespace(kernel_s=lambda families: 0.25,
                            busy_s=lambda: 1.0, window_s=lambda: 4.0)
    cell = SimpleNamespace(config={"iter_max": 100, "dimensions": 2},
                           traffic={"pipeline": "sYgs"})
    return SimpleNamespace(cell=cell, jobs=jobs, clock_mhz=1980.0,
                           trace=trace if with_trace else None)


def test_each_reader_reads_a_synthetic_run(tmp_path):
    run = _run(tmp_path, EVENTS)
    bound_s = 1e-3 * 2 * sort_step_bound_ms(run.jobs[0].shape, 100, 1980.0)
    want = {
        "job_s.sat": 12.0,
        "host_steps_s.sat": 3.0,
        "consensus_launches.sat": 2000,
        # job 1: 500 us of sweep.run, 200 of consensus; job 2: 600, 200
        "sgd_sweeps_s.sat": 550e-6,
        "consensus_s.sat": 200e-6,
        # idle in the consensus: 50 + 50 us of 200 (job 1), 150 of 200
        "consensus_idle_pct.sat": 100 * 250 / 400,
        "sweep_roofline_pct.sat": 100 * bound_s / 0.25,
        "device_idle_pct.sat": 75.0,
    }
    assert set(want) == set(SAT)
    for name, value in want.items():
        assert metric_reader(name)(run) == pytest.approx(value), name


@pytest.mark.parametrize("name", SAT)
def test_none_with_no_trace_or_no_span(name, tmp_path):
    """No jobs; and no trace with no counter.  The consensus readers give
    None too on a traced run of a program that opens no consensus span and
    keeps no counter, the other readers their number."""
    empty = _run(tmp_path, EVENTS)
    empty.jobs, empty.trace = [], None
    assert metric_reader(name)(empty) is None
    bare = _run(tmp_path, EVENTS, launches=(None, None), with_trace=False)
    if name not in ("job_s.sat", "host_steps_s.sat"):
        assert metric_reader(name)(bare) is None
    older = _run(tmp_path, [e for e in EVENTS
                            if e["name"] != "gfasort.sweep.consensus"],
                 launches=(None, None))
    got = metric_reader(name)(older)
    if name.startswith("consensus_"):
        assert got is None
    else:
        assert got is not None
