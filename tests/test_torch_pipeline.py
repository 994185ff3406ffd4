"""The port's pipeline and CLI: path hashes preserved through sYgs and L
with the sweep engines, engine dispatch, and no import of JAX or of the
JAX package anywhere in the port or its smoke script."""

import pathlib
import subprocess
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gfasort_tpu.io import gfa as jax_gfa  # noqa: E402
from gfasort_tpu.pipeline import run_pipeline as jax_run_pipeline  # noqa: E402
from gfasort_tpu_torch import cli  # noqa: E402
from gfasort_tpu_torch.index import PathIndex  # noqa: E402
from gfasort_tpu_torch.io import gfa  # noqa: E402
from gfasort_tpu_torch.pipeline import run_pipeline  # noqa: E402
from gfasort_tpu_torch.tools.make_synthetic_gfa import synthetic_gfa_lines  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def _graph(nodes=1500, paths=3, steps=1500, seed=4):
    text = "\n".join(synthetic_gfa_lines(nodes, paths, steps, seed=seed)) + "\n"
    return gfa.parse_gfa_numeric(text), text


def test_sygs_sweep_engine_preserves_path_hashes():
    g, _ = _graph()
    hashes, nodes, edges = g.compute_all_path_hashes(), g.node_count(), len(g.edges)
    res = run_pipeline(g, "sYgs", iter_max=5, engine="sweep", device="cpu")
    assert res.graph is g
    assert g.compute_all_path_hashes() == hashes
    assert (g.node_count(), len(g.edges)) == (nodes, edges)
    assert [e.name for e in res.tracer.events] == [
        "topo-sort", "SGD", "groom", "topo-sort"]


def test_auto_engine_small_graph_matches_jax_pipeline():
    """At <= 200k nodes 'auto' runs the host oracle in both packages."""
    g1, text = _graph(seed=6)
    g2 = jax_gfa.parse_gfa_numeric(text)
    run_pipeline(g1, "sYgs", iter_max=3, device="cpu")
    jax_run_pipeline(g2, "sYgs", iter_max=3)
    assert gfa.write_gfa(g1) == jax_gfa.write_gfa(g2)


@pytest.mark.parametrize("engine", ["batched", "sharded", "sweep-sharded"])
def test_every_engine_runs_y_and_unknown_names_raise(engine):
    """Every engine name is ported now: the batched and both multi-device
    engines run ``Y`` on the CPU (one shard by default) and keep every
    path; an unknown name still raises."""
    g, _ = _graph(nodes=200, steps=200)
    hashes = g.compute_all_path_hashes()
    run_pipeline(g, "Y", iter_max=2, engine=engine, device="cpu")
    assert g.compute_all_path_hashes() == hashes
    with pytest.raises(ValueError, match="unknown engine"):
        run_pipeline(g, "Y", iter_max=2, engine=engine + "-x", device="cpu")


def test_every_layout_engine_runs_on_the_cpu():
    """The engines of ``L`` run: the oracle, and the device engines (nD
    sweep, batched, and the sharded layout that both sharded names run)
    here on the CPU; none changes the graph."""
    g, _ = _graph(nodes=300, steps=300)
    hashes = g.compute_all_path_hashes()
    res = run_pipeline(g, "L", layout_iter=2, engine="exact", device="cpu")
    assert res.layout is not None and res.layout_stress >= 0
    for dims in (2, 3):
        res = run_pipeline(g, "L", layout_iter=2, engine="sweep",
                           dimensions=dims, device="cpu")
        assert res.layout.dimensions == dims
        assert res.layout.num_nodes == g.node_count()
        assert np.isfinite(res.layout.coords).all()
        assert np.isfinite(res.layout_stress) and res.layout_stress > 0
        assert g.compute_all_path_hashes() == hashes
    assert [e.name for e in res.tracer.events] == ["3D layout"]
    res = run_pipeline(g, "L", layout_iter=2, engine="batched", device="cpu")
    assert res.layout.num_nodes == g.node_count()
    assert np.isfinite(res.layout.coords).all() and res.layout_stress > 0
    a = run_pipeline(g, "L", layout_iter=2, engine="sharded", device="cpu")
    b = run_pipeline(g, "L", layout_iter=2, engine="sweep-sharded",
                     device="cpu")
    assert np.isfinite(a.layout.coords).all() and a.layout_stress > 0
    np.testing.assert_array_equal(a.layout.coords, b.layout.coords)
    assert g.compute_all_path_hashes() == hashes


def test_layout_step_sends_other_engine_names_to_batched():
    """As the JAX ``layout_step``: an engine name other than exact,
    sweep, auto and the multi-device ones runs the batched engine in
    ``L``; ``Y`` refuses it."""
    from gfasort_tpu_torch.params import LayoutSGDParams
    from gfasort_tpu_torch.pipeline import layout_step

    g, _ = _graph(nodes=200, steps=200)
    lp = replace(LayoutSGDParams().derive_from_graph(
        PathIndex.from_graph(g), 2), iter_max=2)
    a, _ = layout_step(g, lp, engine="batched", device="cpu")
    b, _ = layout_step(g, lp, engine="hogwild", device="cpu")
    np.testing.assert_array_equal(a.coords, b.coords)
    with pytest.raises(ValueError, match="unknown engine"):
        run_pipeline(g, "Y", iter_max=2, engine="hogwild", device="cpu")


@pytest.mark.parametrize("engine", ["sweep", "exact"])
def test_layout_step_stress_reads_the_steps_own_index(engine):
    """``layout_step`` hands the stress the path index it built for its
    engine: the stress it returns equals the one computed from a fresh
    index of the graph after the step."""
    from gfasort_tpu_torch.ops.exact import calculate_layout_stress
    from gfasort_tpu_torch.params import LayoutSGDParams
    from gfasort_tpu_torch.pipeline import layout_step

    g, _ = _graph(nodes=300, steps=300)
    lp = replace(LayoutSGDParams().derive_from_graph(
        PathIndex.from_graph(g), 2), iter_max=2)
    layout, stress = layout_step(g, lp, engine=engine, device="cpu")
    assert stress > 0
    assert stress == calculate_layout_stress(g, layout, 10_000)


def test_cli_sweep_on_cpu_writes_sorted_gfa(tmp_path):
    g, text = _graph(seed=8)
    src, dst = tmp_path / "in.gfa", tmp_path / "out.gfa"
    src.write_text(text)
    rc = cli.main(["-i", str(src), "-o", str(dst), "-p", "sYgs", "-v", "0",
                   "--iter-max", "4", "--engine", "sweep", "--device", "cpu",
                   "--trace-out", str(tmp_path / "t.jsonl")])
    assert rc == 0
    out = gfa.parse_gfa_numeric(dst.read_text())
    assert out.compute_all_path_hashes() == g.compute_all_path_hashes()
    assert (tmp_path / "t.jsonl").read_text().count("\n") == 4
    assert cli.main(["-i", str(src), "-o", str(dst), "-p", "sYx"]) == 1


def test_sweep_on_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g, _ = _graph(nodes=200, steps=200)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_pipeline(g, "Y", iter_max=2, engine="sweep")


def test_port_never_imports_jax():
    """Every module of the port and the smoke script, then the 1D sweep
    (f32 and f64), ``sYgsL``, the batched engines, the multi-device
    engines (``parallel/``), the checkpointed runner, the native oracle,
    the ``entry`` round and a runner-cache hit on the CPU: neither ``jax`` nor any module of the JAX package
    ``gfasort_tpu`` is ever imported."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        from dataclasses import replace
        import gfasort_tpu_torch
        for m in pkgutil.walk_packages(gfasort_tpu_torch.__path__,
                                       "gfasort_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        from gfasort_tpu_torch import native, pipeline
        from gfasort_tpu_torch.ops import sweep
        from gfasort_tpu_torch.bench_util import synthetic_path_index
        from gfasort_tpu_torch.io import gfa
        from gfasort_tpu_torch.params import PathSGDParams
        from gfasort_tpu_torch.tools.make_synthetic_gfa import synthetic_gfa_lines

        pidx = synthetic_path_index(1000, 2, 1500, seed=1)
        p = replace(PathSGDParams().derive_from_graph(pidx), iter_max=3)
        x = sweep.path_linear_sgd_sweep(None, p, pidx, device="cpu",
                                        proposals=12, rotate=2)
        assert x.shape == (1000,)
        assert native.path_linear_sgd_native(None, p, pidx).shape == (1000,)
        g = gfa.parse_gfa_numeric("\\n".join(synthetic_gfa_lines(500, 2, 500)))
        pipeline.run_pipeline(g, "sYgsL", iter_max=3, layout_iter=2,
                              engine="sweep", device="cpu")
        # the f64 sweep, the batched engines and the checkpointed runner
        sweep.path_linear_sgd_sweep(None, replace(p, dtype="float64"), pidx,
                                    device="cpu")
        pipeline.run_pipeline(g, "YL", iter_max=2, layout_iter=2,
                              engine="batched", device="cpu")
        # the multi-device engines on a CPU mesh of two shards
        from gfasort_tpu_torch import parallel
        mesh = parallel.default_mesh(2, "cpu")
        pipeline.run_pipeline(g, "YL", iter_max=2, layout_iter=2,
                              engine="sweep-sharded", device="cpu", mesh=mesh)
        pipeline.run_pipeline(g, "Y", iter_max=2, engine="sharded",
                              device="cpu", mesh=mesh)
        import os, tempfile
        from gfasort_tpu_torch.checkpoint import path_linear_sgd_checkpointed
        with tempfile.TemporaryDirectory() as d:
            path_linear_sgd_checkpointed(None, p, os.path.join(d, "c"), pidx,
                                         segment_rounds=2, device="cpu")
        # the entry round and a runner-cache hit
        from gfasort_tpu_torch.entry import entry
        fn, args = entry("cpu")
        assert fn(*args).shape == (64,)
        os.environ["GFASORT_RUNNER_CACHE"] = "1"
        built = sweep.build_sweep_runner(pidx, p, device="cpu")
        assert sweep.build_sweep_runner(pidx, p, device="cpu") is built
        bad = sorted(k for k in sys.modules if k == "jax"
                     or k.startswith("jax.") or k == "gfasort_tpu"
                     or k.startswith("gfasort_tpu."))
        print(bad)
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
