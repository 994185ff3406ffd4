"""Port parity: the whole 1D sweep runner against the JAX runner from one
numpy state, in two configurations (the small-regime defaults, P = 1;
the large-regime knobs forced at a test size, P = 12 with offsets above
KMAX served by roll passes)."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from gfasort_tpu import BidirectedGraph, PathIndex, YgsParams  # noqa: E402
from gfasort_tpu.bench_util import rank_quality, synthetic_path_index  # noqa: E402
from gfasort_tpu.ops import sweep as jax_sweep  # noqa: E402
from gfasort_tpu.params import PathSGDParams  # noqa: E402
from gfasort_tpu_torch.convert import (key_words_from_jax,  # noqa: E402
                                       sweep_state_from_numpy)
from gfasort_tpu_torch.ops import sweep as port_sweep  # noqa: E402
from gfasort_tpu_torch.ops.sweep_plan import make_sweep_plan  # noqa: E402

CONFIGS = {
    # S/N = 3 -> active_frac 1, rotate "auto" -> 3 phases, all k <= KMAX
    "small_p1": ((2000, 3, 2000, 3), {}),
    "large_p12": ((3000, 2, 6000, 3), dict(
        proposals=12, per_octave=2, dense_upto=4, rotate=2,
        consensus_every=4)),
}


def _params(pidx, iter_max):
    return replace(PathSGDParams().derive_from_graph(pidx),
                   dtype="float32", pow_mode="fast", iter_max=iter_max)


def _run_jax(pidx, params, kw):
    run, arrays, make_state, info = jax_sweep.build_sweep_runner(pidx, params, **kw)
    xs0, xn0 = make_state()
    x = np.asarray(run(xs0, xn0, jax.random.key(params.seed), *arrays))
    return x, info


def _run_port(pidx, params, kw):
    run, arrays, make_state, info = port_sweep.build_sweep_runner(
        pidx, params, **kw, device="cpu")
    # what the JAX build_sweep_runner uploads, from the same numpy state
    pos, rank, cnt, xs0, xn0 = sweep_state_from_numpy(pidx, None, "cpu")
    for a, b in zip((pos, rank, cnt), arrays):
        assert torch.equal(a, b)
    key = key_words_from_jax(np.asarray(
        jax.random.key_data(jax.random.key(params.seed))))
    x = run(xs0, xn0, key, pos, rank, cnt)
    return x.numpy(), info


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request):
    mp = pytest.MonkeyPatch()
    # the JAX reference sums kernel buckets first, then the roll buckets,
    # only with the kernel forced; the port's consensus is the gather form
    mp.setenv("GFASORT_DENSE_KERNEL", "pallas")
    mp.setenv("GFASORT_CONSENSUS", "gather")
    try:
        shape, kw = CONFIGS[request.param]
        pidx = synthetic_path_index(*shape[:3], seed=shape[3])
        out = {"name": request.param, "pidx": pidx, "kw": kw}
        # 4 sweeps (one per iteration): one consensus period in both
        p1 = _params(pidx, 3)
        out["period"] = (_run_jax(pidx, p1, kw), _run_port(pidx, p1, kw),
                         _run_port(pidx, p1, kw))
        # the same JAX runner op by op: XLA fuses nothing, so it contracts
        # no multiply-add and keeps each op's own rounding
        with jax.disable_jit():
            out["unjitted"] = _run_jax(pidx, p1, kw)
        p10 = _params(pidx, 10)
        out["iter10"] = (_run_jax(pidx, p10, kw), _run_port(pidx, p10, kw))
        yield out
    finally:
        mp.undo()


def test_runner_info_equals_jax(runs):
    (_, info_j), (_, info_t), _ = runs["period"]
    assert info_t == info_j
    if runs["name"] == "large_p12":
        assert info_t["proposals"] == 12 and info_t["xla_buckets_per_phase"] > 0


def test_one_consensus_period_matches_jax(runs):
    (x_j, info), (x_t, _), _ = runs["period"]
    assert info["n_sweeps"] <= info["consensus_every"]
    assert x_t.dtype == np.float32 and np.isfinite(x_t).all()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-5, atol=1e-3)


def test_one_consensus_period_equals_unjitted_jax(runs):
    """Bit for bit against the JAX runner run op by op.  What remains
    against the jitted runner (``test_one_consensus_period_matches_jax``)
    is XLA's fusion of the sweep's ops; the consensus sums each node's
    steps in the JAX engine's order (``ops/node_sum.py``)."""
    (x_u, _), (x_t, _) = runs["unjitted"], runs["period"][1]
    np.testing.assert_array_equal(x_t, x_u)


def test_port_runs_are_bit_identical(runs):
    _, (x_a, _), (x_b, _) = runs["period"]
    np.testing.assert_array_equal(x_a, x_b)


def test_iter10_order_certifies_against_jax(runs):
    (x_j, _), (x_t, _) = runs["iter10"]
    q = rank_quality(np.argsort(x_t, kind="stable"),
                     np.argsort(x_j, kind="stable"))
    assert q["rank_mae_frac"] <= 2e-3 and q["spearman"] >= 0.999, q


def test_plan_info_equals_jax_at_large_auto_regime(monkeypatch):
    """Zero-knob plan above LARGE_S (P = 12, rotate 12, dense_upto 4) —
    the bench's regime — without running either engine."""
    monkeypatch.setenv("GFASORT_DENSE_KERNEL", "pallas")
    monkeypatch.setenv("GFASORT_CONSENSUS", "gather")
    pidx = synthetic_path_index(80_000, 4, 80_000, seed=2)
    p = _params(pidx, 100)
    _, _, _, info_j = jax_sweep.build_sweep_runner(pidx, p)
    plan = make_sweep_plan(pidx, p)
    assert dict(plan.info(), consensus="gather",
                consensus_coverage=None) == info_j
    assert plan.proposals == 12 and plan.rotate == 12
    assert plan.n_exec % plan.consensus_every == 0
    assert all(k <= 1024 for ph in plan.phases for k, _ in ph.kernel_buckets)
    assert all(k > 1024 for ph in plan.phases for k, _ in ph.roll_buckets)


def test_sweep_contract_edges():
    g = BidirectedGraph()
    for i in (1, 2, 3, 4):
        g.add_node(i, b"ACGT")
    g.build_path("p", [(1, False), (2, False)])
    p = replace(YgsParams.from_graph(g).path_sgd, iter_max=3)
    pidx = PathIndex.from_graph(g)
    x = port_sweep.path_linear_sgd_sweep(g, p, pidx, device="cpu")
    # nodes on no path keep their initial positions
    np.testing.assert_allclose(x[2:], pidx.initial_positions()[2:])
    res = port_sweep.path_linear_sgd_sweep(g, p, pidx, device="cpu",
                                           return_info=True)
    np.testing.assert_array_equal(res.x, x)
    order = port_sweep.path_sgd_sort_sweep(g, p, device="cpu")
    assert sorted(h >> 1 for h in order) == [1, 2, 3, 4]

    lone = BidirectedGraph()
    lone.add_node(1, b"A")
    assert port_sweep.path_linear_sgd_sweep(lone, p, device="cpu") is None
    # the float64 engine runs too (threefry draws, roll passes only)
    x64 = port_sweep.path_linear_sgd_sweep(g, replace(p, dtype="float64"),
                                           pidx, device="cpu")
    assert x64.shape == x.shape and np.isfinite(x64).all()
    np.testing.assert_allclose(x64[2:], pidx.initial_positions()[2:])


# ---- the threefry draws at f32 and the f64 route -------------------------

# GFASORT_SWEEP_RNG=threefry at f32 (kernel and roll buckets), and f64
# under the default knob: the f64 engine always draws threefry, serves
# every bucket by roll passes and sums the consensus in f64
MODES = {"threefry_f32": ("float32", "threefry"), "f64": ("float64", "hash")}
MODE_KW = dict(proposals=2, per_octave=2, dense_upto=4, rotate=2,
               consensus_every=4)


@pytest.fixture(scope="module", params=sorted(MODES))
def mode_runs(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("GFASORT_DENSE_KERNEL", "pallas")
    mp.setenv("GFASORT_CONSENSUS", "gather")
    dtype, rng = MODES[request.param]
    mp.setenv("GFASORT_SWEEP_RNG", rng)
    try:
        pidx = synthetic_path_index(3000, 2, 6000, seed=3)
        # 3 sweeps: one consensus period
        p = replace(_params(pidx, 2), dtype=dtype)
        npd = np.dtype(dtype).type
        key = key_words_from_jax(np.asarray(
            jax.random.key_data(jax.random.key(p.seed))))

        def port():
            run, arrays, _, info = port_sweep.build_sweep_runner(
                pidx, p, **MODE_KW, device="cpu")
            pos, rank, cnt, xs0, xn0 = sweep_state_from_numpy(
                pidx, None, "cpu", npd)
            for a, b in zip((pos, rank, cnt), arrays):
                assert torch.equal(a, b)
            return run(xs0, xn0, key, pos, rank, cnt).numpy(), info

        with jax.disable_jit():
            unjitted = _run_jax(pidx, p, MODE_KW)
        yield {"name": request.param, "dtype": dtype, "pidx": pidx,
               "unjitted": unjitted, "port": (port(), port())}
    finally:
        mp.undo()


def test_mode_runner_info_equals_jax(mode_runs):
    (_, info_j), ((_, info_t), _) = mode_runs["unjitted"], mode_runs["port"]
    assert info_t == info_j
    assert info_t["n_sweeps"] <= info_t["consensus_every"]
    if mode_runs["dtype"] == "float64":
        assert not info_t["dense_kernel"] and info_t["xla_buckets_per_phase"] > 0
    else:
        assert info_t["dense_kernel"]


def test_mode_one_consensus_period_equals_unjitted_jax(mode_runs):
    (x_u, _), ((x_t, _), _) = mode_runs["unjitted"], mode_runs["port"]
    assert x_t.dtype == np.dtype(mode_runs["dtype"]) and np.isfinite(x_t).all()
    np.testing.assert_array_equal(x_t, x_u)


def test_mode_port_runs_are_bit_identical(mode_runs):
    (x_a, _), (x_b, _) = mode_runs["port"]
    np.testing.assert_array_equal(x_a, x_b)
