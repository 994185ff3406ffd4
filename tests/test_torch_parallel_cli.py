"""The sharded engines through the port's CLI and pipeline on the CPU:
``-p Y --engine sweep-sharded``, ``-p Y --engine sharded`` and
``-p L --engine sweep-sharded --dimensions 2`` with ``--device cpu``
keep every path, the node and the edge count, and give the JAX
pipeline's output on a mesh of the same size (the JAX engines run op by
op, ``test_torch_spmd.spmd_shard_map``, with the layout's ``rsqrt`` read
as the port's ``1 / sqrt``, as in ``test_torch_parallel_nd.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gfasort_tpu.io import gfa as jax_gfa  # noqa: E402
from gfasort_tpu.parallel import mesh as jax_mesh  # noqa: E402
from gfasort_tpu.parallel import sgd_shard as jax_sgd  # noqa: E402
from gfasort_tpu.parallel import sweep_nd_shard as jax_nd  # noqa: E402
from gfasort_tpu.parallel import sweep_shard as jax_shard  # noqa: E402
from gfasort_tpu.pipeline import run_pipeline as jax_run_pipeline  # noqa: E402
from gfasort_tpu_torch import cli  # noqa: E402
from gfasort_tpu_torch.io import gfa  # noqa: E402
from gfasort_tpu_torch.parallel import default_mesh  # noqa: E402
from gfasort_tpu_torch.pipeline import run_pipeline  # noqa: E402
from test_torch_spmd import gfa_text, spmd_shard_map  # noqa: E402

# longest path 60 steps: few offsets, so the JAX runs stay short
LENS = (60, 25, 20, 15)


@pytest.fixture
def env(monkeypatch):
    # the JAX "auto" picks the grid consensus and no kernel on the CPU
    monkeypatch.setenv("GFASORT_CONSENSUS", "gather")
    monkeypatch.setenv("GFASORT_DENSE_KERNEL", "pallas")
    return monkeypatch


def _jax_pipeline(text, pipeline, n_shards, monkeypatch, **kw):
    """The JAX pipeline with its sharded engines on ``n_shards`` devices."""
    real = jax_mesh.default_mesh
    for mod in (jax_shard, jax_nd, jax_sgd):
        monkeypatch.setattr(mod, "default_mesh", lambda *a, **k: real(n_shards))
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    g = jax_gfa.parse_gfa_numeric(text)
    with spmd_shard_map(monkeypatch):
        res = jax_run_pipeline(g, pipeline, **kw)
    return jax_gfa.write_gfa(g), res


@pytest.mark.parametrize("pipeline,engine", [
    ("Y", "sweep-sharded"), ("Y", "sharded"), ("L", "sweep-sharded")])
def test_cli_sharded_engine_on_cpu_equals_jax_pipeline(tmp_path, env,
                                                       pipeline, engine):
    text = gfa_text(seed=3, n_nodes=60, lens=LENS)
    src, dst, tsv = tmp_path / "in.gfa", tmp_path / "out.gfa", tmp_path / "l.tsv"
    src.write_text(text)
    g0 = gfa.parse_gfa_numeric(text)
    rc = cli.main(["-i", str(src), "-o", str(dst), "-p", pipeline,
                   "--engine", engine, "--device", "cpu", "--iter-max", "2",
                   "--layout-iter", "2", "--dimensions", "2",
                   "--layout-out", str(tsv), "-v", "0"])
    assert rc == 0
    out = gfa.parse_gfa_numeric(dst.read_text())
    assert out.compute_all_path_hashes() == g0.compute_all_path_hashes()
    assert (out.node_count(), len(out.edges)) == (g0.node_count(), len(g0.edges))

    want, res = _jax_pipeline(text, pipeline, 1, env, iter_max=2,
                              layout_iter=2, dimensions=2, engine=engine)
    assert dst.read_text() == want
    if pipeline == "L":
        jtsv = tmp_path / "jax.tsv"
        res.layout.write_tsv_file(str(jtsv))
        assert tsv.read_text() == jtsv.read_text()
        coords = np.loadtxt(tsv, skiprows=1, usecols=(1, 2, 3, 4))
        assert coords.shape == (60, 4) and np.isfinite(coords).all()


def test_pipeline_on_four_shards_equals_jax(env):
    """``run_pipeline`` on a CPU mesh of 4 shards, as the JAX pipeline on
    4 devices."""
    text = gfa_text(seed=3, n_nodes=60, lens=LENS)
    g = gfa.parse_gfa_numeric(text)
    run_pipeline(g, "Y", iter_max=2, engine="sweep-sharded", device="cpu",
                 mesh=default_mesh(4, "cpu"))
    want, _ = _jax_pipeline(text, "Y", 4, env, iter_max=2,
                            engine="sweep-sharded")
    assert gfa.write_gfa(g) == want
