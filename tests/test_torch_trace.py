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


def test_count_is_a_noop_without_an_active_tracer():
    t = Tracer()
    trace.count("x", 5)
    with t.active():
        trace.count("x", 2)
        trace.count("x")
        trace.count("y", 0)
    trace.count("x", 7)
    assert t.counts == {"x": 3, "y": 0}


def test_a_step_event_holds_what_its_counters_gained():
    t = Tracer()
    with t.active():
        trace.count("c", 4)
        with t.step("SGD"):
            trace.count("c", 3)
            trace.count("d", 1)
        with t.step("groom"):
            pass
    sgd, groom = (json.loads(e.to_json()) for e in t.events)
    assert sgd["counts"] == {"c": 3, "d": 1}
    assert groom["counts"] == {}
    assert t.counts == {"c": 7, "d": 1}


def test_counts_of_two_threads_stay_apart():
    """Two threads, each with its own active tracer, add to the same
    counter in turns (a barrier between adds): each tracer holds only its
    own adds."""
    rounds = 40
    meet = threading.Barrier(2, timeout=30)
    tracers = {}

    def job(name, n):
        t = tracers[name] = Tracer()
        with t.active():
            for _ in range(rounds):
                trace.count("consensus.launches", n)
                meet.wait()

    threads = [threading.Thread(target=job, args=a)
               for a in (("p", 1), ("q", 10))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert tracers["p"].counts == {"consensus.launches": rounds}
    assert tracers["q"].counts == {"consensus.launches": 10 * rounds}


def _looped_text(copies=(60, 50, 40)):
    """``_text()``'s graph with a collapsed tandem repeat after it: path
    p walks a chain of three new nodes ``copies[p]`` times, with an edge
    from the chain's end back to its start, so each chain node has
    sum(copies) steps (150: a class wider than 128)."""
    lines = _text().splitlines()
    n = sum(1 for x in lines if x.startswith("S\t"))
    loop = [n + 1, n + 2, n + 3]
    out = [x for x in lines if not x.startswith("P\t")]
    out += [f"S\t{i}\t{'ACGTTGCA'[: 3 + i % 5]}" for i in loop]
    out += [f"L\t{a}\t+\t{b}\t+\t0M"
            for a, b in zip(loop, loop[1:] + loop[:1])]
    for x, k in zip((x for x in lines if x.startswith("P\t")), copies):
        _, name, steps, rest = x.split("\t")
        last = steps.rsplit(",", 1)[-1]
        out.append(f"L\t{last[:-1]}\t{last[-1]}\t{loop[0]}\t+\t0M")
        steps += "," + ",".join(f"{i}+" for i in loop * k)
        out.append(f"P\t{name}\t{steps}\t{rest}")
    return "\n".join(out) + "\n"


def _consensus_launches(text):
    """The launches of one consensus on the graph of ``text``, from its
    steps alone: the zero fill and two cats, and per width class w (each
    live node's degree rounded up to a power of two) one gather and
    w - 1 adds."""
    from collections import Counter

    deg = Counter(s[:-1] for x in text.splitlines() if x.startswith("P\t")
                  for s in x.split("\t")[2].split(","))
    widths = {1 << (d - 1).bit_length() for d in deg.values()}
    return 3 + sum(widths)


@pytest.mark.parametrize("pipeline,runner,plan_fn,step", [
    ("sYgs", "gfasort_tpu_torch.ops.sweep", "make_sweep_plan", "SGD"),
    ("L", "gfasort_tpu_torch.ops.sweep_nd", "make_layout_plan", "2D layout"),
])
def test_consensus_spans_and_launches_on_a_looped_graph(
        pipeline, runner, plan_fn, step, tmp_path, monkeypatch):
    """A CLI job on a graph with a collapsed repeat (a node of 150 steps):
    one ``sweep.consensus`` span per consensus period of the runner's
    plan, each inside ``sweep.run``, and the step's line counts as many
    consensus launches as the graph's width classes give per period."""
    import importlib

    mod = importlib.import_module(runner)
    plans = []
    make = getattr(mod, plan_fn)

    def recording(*a, **k):
        plans.append(make(*a, **k))
        return plans[-1]

    monkeypatch.setattr(mod, plan_fn, recording)
    text = _looped_text()
    src, out = tmp_path / "in.gfa", tmp_path / "steps.jsonl"
    src.write_text(text)
    assert cli.main(["-i", str(src), "-o", str(tmp_path / "out.gfa"),
                     "-p", pipeline, "--trace-out", str(out),
                     *CPU_SWEEP]) == 0
    (plan,) = plans
    periods = plan.n_exec // plan.consensus_every
    assert periods >= 1
    (line,) = [json.loads(x) for x in out.read_text().splitlines()
               if json.loads(x)["event"] == step]
    spans = line["spans"]
    cons = [s for s in spans if s["name"] == "sweep.consensus"]
    assert len(cons) == periods
    for s in cons:
        assert spans[s["parent"]]["name"] == "sweep.run"
    assert _consensus_launches(text) > 3 + 256
    assert line["counts"] == {
        "consensus.launches": periods * _consensus_launches(text)}
