"""The readers of the program's own spans (``program_spans.py`` and the
metrics that call it) on small hand-written Chrome traces: seconds per job
averaged over the jobs, a span inside another counted once, the inside
and outside filters, the device's idle share inside a span, the span
count, None without a trace or a span, and every per-layer entry with its
reader and its one cell."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from gfabench import program_spans as P
from gfabench.spec import ROOT, metric_reader


def _x(name, ts, end, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
            "pid": 1, "tid": 1}


def _run(tmp_path, events):
    """A finished traced run whose work directory holds ``events`` as its
    Chrome trace."""
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    job = SimpleNamespace(trace_out=tmp_path / "steps-1.jsonl")
    return SimpleNamespace(trace=object(), jobs=[job],
                           cell=SimpleNamespace(config={"dimensions": 2}))


def _g(name, ts, end):
    return _x("gfasort." + name, ts, end)


# two sort jobs, times in microseconds
SORT = [
    _x("gfabench.job", 0, 1000),
    _g("gfa.read", 0, 100),
    _g("pipeline.params", 100, 200),
    _g("index.build", 110, 150), _g("index.build", 150, 190),
    _g("SGD", 200, 900),
    _g("index.build", 200, 250),
    _g("sweep.build", 250, 400), _g("sweep.plan", 260, 300),
    _g("sweep.run", 400, 800),
    _g("sgd.order", 800, 850), _g("graph.reorder", 850, 900),
    _g("gfa.write", 900, 1000),
    # device: 100 us and (clipped to the span) 100 us of the 400 us run
    _x("kernel_a", 450, 550, "kernel"), _x("memcpy", 700, 900, "gpu_memcpy"),
    _x("gfasort.SGD", 200, 900, "gpu_user_annotation"),
    _x("aten::add", 410, 420, "cpu_op"),

    _x("gfabench.job", 2000, 3000),
    _g("gfa.read", 2000, 2200),
    _g("pipeline.params", 2200, 2300),
    _g("index.build", 2210, 2250), _g("index.build", 2250, 2290),
    _g("SGD", 2300, 2900),
    _g("index.build", 2300, 2400), _g("index.build", 2400, 2450),
    _g("sweep.build", 2450, 2600), _g("sweep.plan", 2460, 2500),
    _g("sweep.run", 2600, 2800),
    _g("graph.reorder", 2800, 2900),
    _g("gfa.write", 2900, 3000),
    _x("kernel_b", 2600, 2750, "kernel"),
    # outside every job: not counted
    _g("index.build", 5000, 5100),
    _x("kernel_c", 5000, 5100, "kernel"),
]


def test_seconds_per_job_averaged_with_nested_spans_once(tmp_path):
    run = _run(tmp_path, SORT)
    # job 1: 50 + 150 (sweep.plan inside sweep.build); job 2: 150 + 150
    assert P.spans_s(run, ("index.build", "sweep.plan", "sweep.build"),
                     inside="SGD") == pytest.approx(250e-6)
    assert P.spans_s(run, ("pipeline.params",)) == pytest.approx(100e-6)
    assert P.spans_s(run, ("gfa.read", "gfa.write")) == pytest.approx(250e-6)
    assert P.spans_s(run, ("sweep.run",), inside="SGD") == pytest.approx(
        300e-6)
    assert P.spans_s(run, ("index.build",), outside="SGD") == pytest.approx(
        80e-6)
    for name, want in (("sgd_setup_s", 250e-6), ("sgd_sweeps_s", 300e-6),
                       ("sgd_order_s", 100e-6), ("params_s.sort", 100e-6),
                       ("gfa_io_s.sort", 250e-6)):
        assert metric_reader(name)(run) == pytest.approx(want), name


def test_idle_share_inside_spans_partly_covered(tmp_path):
    run = _run(tmp_path, SORT)
    # idle 200 of 400 us in job 1, 50 of 200 us in job 2
    assert P.idle_pct_in(run, "sweep.run", inside="SGD") == pytest.approx(
        100 * 250 / 600)
    assert metric_reader("sweeps_idle_pct.sort")(run) == pytest.approx(
        100 * 250 / 600)
    assert P.idle_pct_in(run, "sweep.run", inside="2D layout") is None


def test_span_count_per_job(tmp_path):
    run = _run(tmp_path, SORT)
    assert P.span_count(run, "index.build") == pytest.approx(3.5)
    assert metric_reader("index_builds.sort")(run) == pytest.approx(3.5)
    assert P.span_count(run, "layout.stress") is None


def test_layout_spans_inside_the_step_and_outside_the_stress(tmp_path):
    run = _run(tmp_path, [
        _x("gfabench.job", 0, 1000),
        _g("gfa.read", 0, 100), _g("pipeline.params", 100, 150),
        _g("2D layout", 150, 850),
        _g("index.build", 150, 200), _g("layout.init", 200, 300),
        _g("sweep.build", 300, 350), _g("sweep.plan", 300, 320),
        _g("sweep.build", 350, 360), _g("sweep.run", 360, 700),
        _g("layout.stress", 700, 850), _g("index.build", 710, 760),
        _g("tsv.write", 850, 950), _g("gfa.write", 950, 1000),
        _x("kernel", 360, 700, "kernel"),
    ])
    assert metric_reader("layout_setup_s")(run) == pytest.approx(210e-6)
    assert metric_reader("layout_sweeps_s")(run) == pytest.approx(340e-6)
    assert metric_reader("layout_stress_s")(run) == pytest.approx(150e-6)
    assert metric_reader("gfa_io_s.layout")(run) == pytest.approx(250e-6)
    assert metric_reader("params_s.layout")(run) == pytest.approx(50e-6)
    assert metric_reader("index_builds.layout")(run) == 2
    assert metric_reader("sweeps_idle_pct.layout")(run) == 0
    # a 3D cell reads its own step's name
    run.cell.config["dimensions"] = 3
    assert metric_reader("layout_sweeps_s")(run) is None


NEW = ("params_s.sort", "gfa_io_s.sort", "sgd_setup_s", "sgd_sweeps_s",
       "sgd_order_s", "index_builds.sort", "sweeps_idle_pct.sort",
       "params_s.layout", "gfa_io_s.layout", "layout_setup_s",
       "layout_sweeps_s", "layout_stress_s", "index_builds.layout",
       "sweeps_idle_pct.layout")


@pytest.mark.parametrize("name", NEW)
def test_none_without_a_trace_or_a_span(name, tmp_path):
    """No trace (a CPU run, or ``--trace 0``), a trace file gone, and a
    trace of a program that opens no spans of its own."""
    run = _run(tmp_path, [_x("gfabench.job", 0, 1000),
                          _x("gfabench.layer.SGD", 10, 900),
                          _x("kernel", 10, 20, "kernel")])
    assert metric_reader(name)(run) is None
    (tmp_path / "trace.json").unlink()
    assert metric_reader(name)(run) is None
    run.trace = None
    assert metric_reader(name)(run) is None
    no_jobs = SimpleNamespace(trace=object(), jobs=[], cell=run.cell)
    assert metric_reader(name)(no_jobs) is None


def test_every_per_layer_entry_has_a_reader_and_one_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in bench["workloads"]}
    names = {m["name"] for m in bench["per_layer"]}
    assert set(NEW) <= names
    for m in bench["per_layer"]:
        assert (ROOT / "gfabench" / "metrics" / f"{m['name']}.py").is_file()
        assert len(m["workloads"]) == 1 and m["workloads"][0] in cells, m
