"""Port parity: the batched-synchronous engines (``ops/sgd.py``) against
the JAX package's ``gfasort_tpu/ops/sgd.py`` from one numpy state.

* Bit for bit against the JAX engines run op by op (``jax.disable_jit``)
  over a few rounds: the 1D runner at f64 / ``fpp`` (the default) on two
  graphs, one where every round lands dozens of terms on each node (the
  scatter-add's summing order), and at f32 with both ``pow_mode``s; the
  nD runner at D = 2 and 3, with the JAX ``rsqrt`` read as the port's
  ``1 / sqrt``.
* Close over a whole short schedule against the jitted JAX engines.
* The parts: ``fast_precise_pow_torch``, the sampler's draws, the
  schedule, ``DeviceIndex`` and ``convert.batched_inputs``.
* The entry points: the segmented runner, the handle order, and
  ``--engine batched`` / ``--batch`` through the CLI.
"""

import contextlib
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gfasort_tpu.bench_util import synthetic_path_index  # noqa: E402
from gfasort_tpu.ops import fastpow as j_fastpow  # noqa: E402
from gfasort_tpu.ops import sgd as jsgd  # noqa: E402
from gfasort_tpu.ops.exact import layout_initial_coords  # noqa: E402
from gfasort_tpu.params import LayoutSGDParams, PathSGDParams  # noqa: E402
from gfasort_tpu_torch import cli  # noqa: E402
from gfasort_tpu_torch.bench_util import rank_quality  # noqa: E402
from gfasort_tpu_torch.convert import batched_inputs  # noqa: E402
from gfasort_tpu_torch.io import gfa  # noqa: E402
from gfasort_tpu_torch.ops import fastpow as t_fastpow  # noqa: E402
from gfasort_tpu_torch.ops import sgd as tsgd  # noqa: E402
from gfasort_tpu_torch.ops.keys import fold_in, key_data, split  # noqa: E402
from gfasort_tpu_torch.tools.make_synthetic_gfa import synthetic_gfa_lines  # noqa: E402

GRAPHS = {
    # S = 2400 steps over 300 nodes
    "paths": (300, 3, 800, 4),
    # 40 nodes under 900 steps: ~25 terms per node and round at B = 512
    "hub": (40, 3, 300, 2),
}


@pytest.fixture(scope="module")
def graphs():
    return {k: synthetic_path_index(*v[:3], seed=v[3]) for k, v in GRAPHS.items()}


def _p1d(pidx, dtype="float64", pow_mode="fpp", iter_max=2, batch=1024):
    # iter_max 2: iterations 0 and 1 warm, 2 cooling
    return replace(PathSGDParams().derive_from_graph(pidx), dtype=dtype,
                   pow_mode=pow_mode, iter_max=iter_max, batch=batch)


def _pnd(pidx, D, dtype="float64", pow_mode="fpp", iter_max=2, batch=1024):
    return replace(LayoutSGDParams().derive_from_graph(pidx, D), dtype=dtype,
                   pow_mode=pow_mode, iter_max=iter_max, batch=batch,
                   min_term_updates=pidx.total_steps)


def _jax_1d(pidx, p, jit):
    with contextlib.nullcontext() if jit else jax.disable_jit():
        run, make_x0, n = jsgd.build_1d_runner(pidx, p)
        return np.asarray(run(make_x0(), jax.random.key(p.seed))), n


def _port_1d(pidx, p, device="cpu"):
    run, make_x0, n = tsgd.build_1d_runner(pidx, p, device=device)
    return run(make_x0(), key_data(p.seed)).cpu().numpy(), n


def _jax_nd(pidx, lp, init, jit, monkeypatch=None):
    if jit:
        return jsgd.path_linear_sgd_layout_batched(
            None, lp, pidx, init_coords=init).coords
    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
        return jsgd.path_linear_sgd_layout_batched(
            None, lp, pidx, init_coords=init).coords


def _port_nd(pidx, lp, init):
    return tsgd.path_linear_sgd_layout_batched(
        None, lp, pidx, init_coords=init, device="cpu").coords


# ---- the round loop, op by op -------------------------------------------

@pytest.mark.parametrize("graph,dtype,pow_mode,batch", [
    ("paths", "float64", "fpp", 1024),
    ("hub", "float64", "fpp", 512),
    ("hub", "float32", "fpp", 512),
    # "fast": exp/log differ between torch and XLA in the last place,
    # which the integer Zipf rank absorbs on these draws
    ("hub", "float32", "fast", 512),
])
def test_1d_runner_equals_unjitted_jax(graphs, graph, dtype, pow_mode, batch):
    pidx = graphs[graph]
    p = _p1d(pidx, dtype, pow_mode, batch=batch)
    x_j, n_j = _jax_1d(pidx, p, jit=False)
    x_t, n_t = _port_1d(pidx, p)
    assert n_t == n_j == 3 * tsgd.build_schedule(p, batch)[2]
    assert x_t.dtype == np.dtype(dtype) and np.isfinite(x_t).all()
    np.testing.assert_array_equal(x_t, x_j)
    assert not np.array_equal(x_t, pidx.initial_positions().astype(dtype))


@pytest.mark.parametrize("D", [2, 3])
def test_nd_runner_equals_unjitted_jax(graphs, monkeypatch, D):
    """f64 / ``fpp``, with the JAX ``rsqrt`` read as the port's
    ``1 / sqrt`` (``sweep_dense.sqrt_rn``): bit for bit."""
    pidx = graphs["hub"]
    lp = _pnd(pidx, D, batch=512)
    init = layout_initial_coords(pidx, D, lp.seed)
    c_j = _jax_nd(pidx, lp, init, jit=False, monkeypatch=monkeypatch)
    c_t = _port_nd(pidx, lp, init)
    assert c_t.shape == (pidx.num_nodes, 2, D) and np.isfinite(c_t).all()
    np.testing.assert_array_equal(c_t, c_j)


# ---- a whole short schedule, jitted ---------------------------------------

def test_1d_whole_run_is_close_to_jitted_jax(graphs):
    """iter_max 10 at the default batch clamp (one round per iteration
    here, 11 rounds), f64 / ``fpp``: XLA may fuse the round's float ops,
    so within rtol 1e-9; the order certifies."""
    pidx = graphs["paths"]
    p = _p1d(pidx, iter_max=10, batch=4096)
    x_j, _ = _jax_1d(pidx, p, jit=True)
    x_t, _ = _port_1d(pidx, p)
    np.testing.assert_allclose(x_t, x_j, rtol=1e-9, atol=1e-6)
    q = rank_quality(np.argsort(x_t, kind="stable"),
                     np.argsort(x_j, kind="stable"))
    assert q["rank_mae_frac"] <= 2e-3 and q["spearman"] >= 0.999, q


def test_nd_whole_run_is_close_to_jitted_jax(graphs):
    """D = 2, iter_max 5, f64 / ``fpp``: XLA's fusion and its ``rsqrt``
    (1 ulp from the exact root, as the port's ``1 / sqrt``) within rtol
    1e-6 of the coordinates' scale."""
    pidx = graphs["paths"]
    lp = _pnd(pidx, 2, iter_max=5, batch=4096)
    init = layout_initial_coords(pidx, 2, lp.seed)
    c_j = _jax_nd(pidx, lp, init, jit=True)
    c_t = _port_nd(pidx, lp, init)
    scale = float(np.abs(c_j).max())
    np.testing.assert_allclose(c_t, c_j, rtol=1e-6, atol=1e-6 * scale)


def test_port_runs_are_bit_identical(graphs):
    pidx = graphs["hub"]
    p = _p1d(pidx, batch=512)
    np.testing.assert_array_equal(_port_1d(pidx, p)[0], _port_1d(pidx, p)[0])


# ---- the parts ------------------------------------------------------------

@pytest.mark.parametrize("b,e", [(0.99, 0), (0.01, 0), (100.0, 100),
                                 (1.001001001, 1), (3.75, 3)])
def test_fast_precise_pow_torch_equals_jax(b, e):
    rng = np.random.default_rng(int(b * 1000))
    a = np.concatenate([rng.uniform(1e-6, 1.0, 2000), rng.uniform(1, 50, 200),
                        [0.5, 1.0, 2.0 / 3.0]])
    want = np.asarray(j_fastpow.fast_precise_pow_jax(jnp.asarray(a), b, e))
    got = t_fastpow.fast_precise_pow_torch(torch.from_numpy(a), b, e).numpy()
    np.testing.assert_array_equal(got, want)
    if e == 0:
        np.testing.assert_array_equal(got, t_fastpow.fast_precise_pow_np(a, b))


@pytest.mark.parametrize("dtype,pow_mode", [("float64", "fpp"),
                                            ("float32", "fast")])
@pytest.mark.parametrize("cooling", [False, True])
def test_sampler_draws_equal_jax(graphs, dtype, pow_mode, cooling):
    """The sampled (step_a, step_b, valid) of one round, jitted JAX
    against the port's [R, B] form on two rounds' keys."""
    pidx = graphs["paths"]
    p = _p1d(pidx, dtype, pow_mode)
    zetas = j_fastpow.zeta_table(p.space, p.space_max,
                                 p.space_quantization_step, p.theta)
    sdt = np.float64 if pow_mode == "fpp" else np.dtype(dtype).type
    B = 777
    j_sample = jsgd._make_sampler(jsgd.DeviceIndex.from_path_index(pidx, sdt),
                                  p, zetas, jnp.dtype(sdt).type, B)
    t_sample = tsgd._make_sampler(
        tsgd.DeviceIndex.from_path_index(pidx, sdt, "cpu"), p, zetas, sdt, B)
    base = key_data(p.seed)
    rounds = np.array([3, 11])
    keys = torch.from_numpy(split(fold_in(base, rounds), 5).astype(np.int64))
    sa, sb, valid = t_sample(keys, cooling, 0, pidx.total_steps)
    for r_i, r in enumerate(rounds):
        key = jax.random.fold_in(jax.random.key(p.seed), int(r))
        want = jax.jit(j_sample, static_argnums=(2, 3))(
            key, jnp.asarray(cooling), 0, pidx.total_steps)
        for got, w in zip((sa, sb, valid), want):
            np.testing.assert_array_equal(got[r_i].numpy(), np.asarray(w))


def test_schedule_and_batch_equal_jax(graphs):
    pidx = graphs["paths"]
    for batch in (1, 700, 10**6):
        p = _p1d(pidx, batch=batch, iter_max=7)
        assert tsgd.effective_batch(p) == jsgd.effective_batch(p)
        B = tsgd.effective_batch(p)
        for a, b in zip(tsgd.build_schedule(p, B), jsgd.build_schedule(p, B)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_index_and_batched_inputs_equal_jax(graphs, dtype):
    pidx = graphs["paths"]
    dj = jsgd.DeviceIndex.from_path_index(pidx, dtype)
    p = _p1d(pidx, np.dtype(dtype).name)
    dt, x0, kw = batched_inputs(pidx, p, device="cpu")
    for f in ("step_path", "step_rank", "step_pos", "step_node", "step_rev",
              "path_first", "path_count", "node_len"):
        got, want = getattr(dt, f).numpy(), getattr(dj, f)
        assert got.dtype.kind == want.dtype.kind, f
        np.testing.assert_array_equal(got, want, err_msg=f)
        if want.dtype.kind == "f":
            assert got.dtype == want.dtype, f
    assert (dt.total_steps, dt.num_nodes) == (dj.total_steps, dj.num_nodes)
    run, make_x0, _ = jsgd.build_1d_runner(pidx, p)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(make_x0()))
    np.testing.assert_array_equal(
        kw, np.asarray(jax.random.key_data(jax.random.key(p.seed))))
    lp = _pnd(pidx, 2, np.dtype(dtype).name)
    init = layout_initial_coords(pidx, 2, lp.seed)
    _, st, _ = batched_inputs(pidx, lp, init, device="cpu")
    np.testing.assert_array_equal(st.numpy(), init.astype(dtype))
    with pytest.raises(ValueError, match="start coordinates"):
        batched_inputs(pidx, lp, device="cpu")


# ---- the entry points -----------------------------------------------------

def test_segmented_runner_equals_one_shot(graphs):
    """``segment_rounds``: segments of 4 rounds, the last one running
    past the schedule (those rounds change nothing)."""
    pidx = graphs["hub"]
    p = _p1d(pidx, batch=512)
    x_one, n = _port_1d(pidx, p)
    run, make_x0, n_seg = tsgd.build_1d_runner(pidx, p, segment_rounds=4,
                                               device="cpu")
    assert n_seg == n and n % 4 != 0
    x, key = make_x0(), key_data(p.seed)
    for start in range(0, n, 4):
        x = run(x, key, start)
    np.testing.assert_array_equal(x.numpy(), x_one)


def test_sort_order_equals_jax_and_contract_edges(graphs):
    from gfasort_tpu import BidirectedGraph as JGraph
    from gfasort_tpu_torch.graph import BidirectedGraph

    lines = synthetic_gfa_lines(200, 2, 300, seed=3)
    from gfasort_tpu.io import gfa as jgfa

    text = "\n".join(lines) + "\n"
    p = replace(PathSGDParams(), iter_max=3, dtype="float64", pow_mode="fpp")
    g_t, g_j = gfa.parse_gfa_numeric(text), jgfa.parse_gfa_numeric(text)
    from gfasort_tpu_torch.index import PathIndex

    p = p.derive_from_graph(PathIndex.from_graph(g_t))
    with jax.disable_jit():
        want = jsgd.path_sgd_sort_batched(g_j, p)
    assert tsgd.path_sgd_sort_batched(g_t, p, device="cpu") == want
    # no node: empty; no path with two steps: None
    assert tsgd.path_linear_sgd_batched(BidirectedGraph(), p,
                                        device="cpu").shape == (0,)
    lone = BidirectedGraph()
    lone.add_node(1, b"A")
    assert tsgd.path_linear_sgd_batched(lone, p, device="cpu") is None
    jlone = JGraph()
    jlone.add_node(1, b"A")
    assert jsgd.path_linear_sgd_batched(jlone, p) is None
    lay = tsgd.path_linear_sgd_layout_batched(lone, LayoutSGDParams(),
                                              device="cpu")
    assert lay.num_nodes == 1


def test_cli_batched_engine_and_batch_flag(tmp_path):
    """``--engine batched`` sorts ``Y`` and lays out ``L``; ``--batch``
    sets the round width (a different width, a different order)."""
    text = "\n".join(synthetic_gfa_lines(300, 2, 400, seed=8)) + "\n"
    src = tmp_path / "in.gfa"
    src.write_text(text)
    hashes = gfa.parse_gfa_numeric(text).compute_all_path_hashes()
    outs = []
    for batch in ("64", "256"):
        dst = tmp_path / f"out{batch}.gfa"
        rc = cli.main(["-i", str(src), "-o", str(dst), "-p", "Y", "-v", "0",
                       "--iter-max", "3", "--engine", "batched", "--batch",
                       batch, "--device", "cpu"])
        assert rc == 0
        g = gfa.parse_gfa_numeric(dst.read_text())
        assert g.compute_all_path_hashes() == hashes
        outs.append(dst.read_text())
    assert outs[0] != outs[1]
    tsv = tmp_path / "l.tsv"
    rc = cli.main(["-i", str(src), "-o", str(tmp_path / "l.gfa"), "-p", "L",
                   "-v", "0", "--layout-iter", "2", "--dimensions", "2",
                   "--engine", "batched", "--device", "cpu",
                   "--layout-out", str(tsv)])
    assert rc == 0
    vals = np.array(tsv.read_text().split()[5:], dtype=np.float64)
    assert vals.size == 300 * 5 and np.isfinite(vals).all()


def test_padded_term_tables_change_nothing(graphs, monkeypatch):
    """The CUDA-graph replay pads a chunk's term table with the zero
    term up to the captured width; the eager loop with padded tables
    gives the same positions, bit for bit (sums start at +0, so a
    trailing +0 changes none)."""
    pidx = graphs["hub"]
    p = _p1d(pidx, batch=512)
    x_one, _ = _port_1d(pidx, p)

    def padded(loop, state, pad):
        def run(table, *rest):
            extra = table.new_full(table.shape[:-1] + (3,), pad)
            loop(state, torch.cat([table, extra], dim=-1), *rest)
        return run

    monkeypatch.setattr(tsgd, "_chunk_runner", padded)
    np.testing.assert_array_equal(_port_1d(pidx, p)[0], x_one)
    lp = _pnd(pidx, 2, batch=512)
    init = layout_initial_coords(pidx, 2, lp.seed)
    c_pad = _port_nd(pidx, lp, init)
    monkeypatch.undo()
    np.testing.assert_array_equal(c_pad, _port_nd(pidx, lp, init))
