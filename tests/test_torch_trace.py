"""The port's tracer (``gfasort_tpu_torch/trace.py``): nested spans with
parents and start times, the active tracer found per thread, the spans in
a torch profiler trace beside the tracer's own records, the
``--trace-out`` step log of a CLI job and the path-index builds a job
counts."""

import json
import threading

import pytest

torch = pytest.importorskip("torch")

from gfasort_tpu_torch import cli, trace  # noqa: E402
from gfasort_tpu_torch.io import gfa  # noqa: E402
from gfasort_tpu_torch.pipeline import run_pipeline  # noqa: E402
from gfasort_tpu_torch.tools.make_synthetic_gfa import synthetic_gfa_lines  # noqa: E402
from gfasort_tpu_torch.trace import Tracer, span  # noqa: E402

CPU_SWEEP = ["--engine", "sweep", "--device", "cpu", "-v", "0",
             "--iter-max", "2", "--layout-iter", "2"]


def _text(nodes=600, paths=3, steps=600, seed=4):
    return "\n".join(synthetic_gfa_lines(nodes, paths, steps, seed=seed)) + "\n"


def test_spans_nest_with_parents_and_start_times():
    t = Tracer()
    with t.active():
        with span("a"):
            with span("b"):
                pass
            with span("c"):
                with span("d"):
                    pass
        with span("e"):
            pass
    assert [s.name for s in t.spans] == list("abcde")
    assert [s.parent for s in t.spans] == [None, 0, 0, 2, None]
    a, b, c, d, e = t.spans
    assert 0 <= a.start <= b.start <= b.end <= c.start <= d.start
    assert d.start <= d.end <= c.end <= a.end <= e.start <= e.end
    assert t.events == []


def test_a_step_event_holds_its_descendants():
    t = Tracer()
    with t.active():
        with span("before"):
            pass
        with t.step("SGD", step=1):
            with span("x"):
                with span("y"):
                    pass
            with span("z"):
                pass
    (ev,) = t.events
    line = json.loads(ev.to_json())
    assert (line["event"], line["step"]) == ("SGD", 1)
    assert [s["name"] for s in line["spans"]] == ["x", "y", "z"]
    assert [s["parent"] for s in line["spans"]] == [None, 0, None]
    assert line["start"] <= line["spans"][0]["start"]
    assert line["spans"][-1]["end"] <= line["end"]
    assert ev.seconds == t.spans[1].seconds


def test_span_is_a_noop_without_an_active_tracer():
    assert span("x") is span("y")
    t = Tracer()
    with span("x"):
        pass
    with t.active():
        with span("inside"):
            pass
    with span("after"):
        pass
    assert [s.name for s in t.spans] == ["inside"]


def test_tracers_in_two_threads_stay_apart():
    """Two threads, each with its own active tracer, open spans in turns
    (a barrier inside every span): each tracer holds only its own."""
    rounds = 40
    meet = threading.Barrier(2, timeout=30)
    tracers = {}

    def job(name):
        t = tracers[name] = Tracer()
        with t.active():
            for i in range(rounds):
                with span(f"{name}.{i}"):
                    meet.wait()
                    with span(f"{name}.inner"):
                        pass

    threads = [threading.Thread(target=job, args=(n,)) for n in "pq"]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    for name, t in tracers.items():
        assert len(t.spans) == 2 * rounds
        assert all(s.name.startswith(name + ".") for s in t.spans)
        assert [s.parent for s in t.spans[1::2]] == list(range(0, 2 * rounds, 2))


def test_spans_land_in_the_profiler_trace_inside_the_steps(tmp_path):
    """Under a CPU-only profiler session, each span of a sweep-engine
    pipeline is a ``gfasort.`` user annotation, in the tracer's order, as
    long as the tracer's record (within 5% or 1 ms), inside the
    annotation of its parent span; every span but the parameters' lies
    inside a step's."""
    from torch.profiler import ProfilerActivity, profile

    g = gfa.parse_gfa_numeric(_text())
    t = Tracer()
    # one torch thread: on a loaded host the idle intra-op workers, spinning
    # beside the main thread, can delay an annotation's enter or exit by
    # milliseconds, outside the span's own clock reads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            # the first annotation of a process pays the profiler's
            # one-time set-up (~2 ms)
            with torch.profiler.record_function("warm-up"):
                pass
            run_pipeline(g, "sYL", iter_max=2, layout_iter=2,
                         engine="sweep", device="cpu", tracer=t)
    finally:
        torch.set_num_threads(threads)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ann = sorted(((e["name"][len(trace.PROFILER_PREFIX):], float(e["ts"]),
                   float(e["ts"]) + float(e["dur"]))
                  for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(trace.PROFILER_PREFIX)),
                 key=lambda a: (a[1], -a[2]))
    assert [a[0] for a in ann] == [s.name for s in t.spans]
    for (name, a, b), s in zip(ann, t.spans):
        assert abs((b - a) * 1e-6 - s.seconds) <= max(0.05 * s.seconds,
                                                       1e-3), name
        if s.parent is not None:
            _, pa, pb = ann[s.parent]
            assert pa <= a and b <= pb + 1.0, name
    steps = {e.name for e in t.events}
    assert steps == {"topo-sort", "SGD", "2D layout"}
    for i, s in enumerate(t.spans):
        top = i
        while t.spans[top].parent is not None:
            top = t.spans[top].parent
        assert t.spans[top].name in steps | {"pipeline.params"}
    names = [s.name for s in t.spans]
    for inner in ("sweep.plan", "sweep.build", "sweep.run", "sgd.order",
                  "graph.reorder", "layout.init", "layout.stress"):
        assert inner in names


def test_trace_out_of_a_sygs_job_keeps_one_line_per_step(tmp_path):
    src, out = tmp_path / "in.gfa", tmp_path / "steps.jsonl"
    src.write_text(_text())
    assert cli.main(["-i", str(src), "-o", str(tmp_path / "out.gfa"),
                     "-p", "sYgs", "--trace-out", str(out), *CPU_SWEEP]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["event"] for x in lines] == ["topo-sort", "SGD", "groom",
                                          "topo-sort"]
    for x in lines:
        assert {"event", "seconds", "step", "nodes", "edges"} <= set(x)
        assert x["end"] - x["start"] == pytest.approx(x["seconds"], abs=1e-5)
    sgd = [s["name"] for s in lines[1]["spans"]]
    assert "sweep.run" in sgd and "gfa.read" not in sgd


@pytest.mark.parametrize("pipeline", ["sYgs", "L"])
def test_a_job_builds_the_path_index_four_or_three_times(pipeline, tmp_path,
                                                         monkeypatch):
    """The count of ``index.build`` spans of one CLI job.  Pinned at 4 for
    ``sYgs`` and 3 for ``L``: the parameters build two
    (``YgsParams.from_graph`` and ``run_pipeline``'s own), the step one
    more to pick its engine, and the sweep engine (``Y``) a fourth; the
    stress (``L``) reads the step's own.  A change that removes a rebuild
    lowers this number."""
    made = []
    make = trace.Tracer

    def recording():
        made.append(make())
        return made[-1]

    monkeypatch.setattr(trace, "Tracer", recording)
    src = tmp_path / "in.gfa"
    src.write_text(_text())
    assert cli.main(["-i", str(src), "-o", str(tmp_path / "out.gfa"),
                     "-p", pipeline, "--layout-out",
                     str(tmp_path / "l.tsv"), *CPU_SWEEP]) == 0
    (t,) = made

    def top(s):
        while s.parent is not None:
            s = t.spans[s.parent]
        return s.name

    builds = [top(s) for s in t.spans if s.name == "index.build"]
    step = {"sYgs": ["SGD"] * 2, "L": ["2D layout"]}[pipeline]
    assert sorted(builds) == sorted(["pipeline.params"] * 2 + step)
    assert (t.spans[0].name, t.spans[-1].name) == ("gfa.read", "gfa.write")
