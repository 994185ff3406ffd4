"""The sweep engines' executed-sweep count and environment knobs, held
to the JAX engines.

* The executed sweeps: whole dispatches of consensus periods, as the
  JAX engines' dispatch chunking runs them (``SweepPlan.n_exec``), on
  the shapes where the chunk does not divide the periods, and the
  chunked 1D and nD runners against the unjitted JAX runners.
* Each ``GFASORT_*`` knob that changes results, under ``monkeypatch``:
  honoured (against the unjitted JAX runner) or refused by name; the
  knobs that change nothing leave the port's result as it is.

Bit for bit in 1D and in nD, with the JAX nD ``rsqrt`` read as the
port's ``1 / sqrt`` (``test_torch_sweep_nd.py``)."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gfasort_tpu.bench_util import synthetic_path_index  # noqa: E402
from gfasort_tpu.ops import sweep as jax_sweep  # noqa: E402
from gfasort_tpu.ops import sweep_nd as jax_nd  # noqa: E402
from gfasort_tpu.ops.exact import layout_initial_coords  # noqa: E402
from gfasort_tpu.params import LayoutSGDParams, PathSGDParams  # noqa: E402
from gfasort_tpu_torch.bench_util import (  # noqa: E402
    synthetic_path_index as port_synthetic_path_index)
from gfasort_tpu_torch.convert import sweep_state_from_numpy  # noqa: E402
from gfasort_tpu_torch.ops import sweep as port_sweep  # noqa: E402
from gfasort_tpu_torch.ops import sweep_nd as port_nd  # noqa: E402
from gfasort_tpu_torch.ops.env import sweep_knobs  # noqa: E402
from gfasort_tpu_torch.ops.keys import key_data  # noqa: E402
from gfasort_tpu_torch.ops.sweep_plan import (executed_sweeps,  # noqa: E402
                                              make_layout_plan,
                                              make_sweep_plan)
from gfasort_tpu_torch.params import (  # noqa: E402
    LayoutSGDParams as PortLayoutParams, PathSGDParams as PortPathParams)

# tiny schedules: 5 sweeps, consensus every 2 -> 3 periods
KW_1D = dict(consensus_every=2, rotate=1, per_octave=1, dense_upto=2,
             proposals=1)
KW_ND = dict(KW_1D, active_frac=1.0)
KNOBS = ("GFASORT_SWEEP_RNG", "GFASORT_SNAP", "GFASORT_KERNEL_KMAX",
         "GFASORT_DENSE_KERNEL", "GFASORT_CONSENSUS",
         "GFASORT_SWEEP_DISPATCH_ELEMS", "GFASORT_DK_BUDGET",
         "GFASORT_ROT_UNROLL")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    # the JAX reference sums kernel buckets first only with the kernel
    # forced (its auto means no kernel on the CPU backend)
    monkeypatch.setenv("GFASORT_DENSE_KERNEL", "pallas")
    monkeypatch.setenv("GFASORT_CONSENSUS", "gather")


@pytest.fixture(scope="module")
def pidx():
    return synthetic_path_index(300, 2, 400, seed=9)


def _p1d(pidx, iter_max=4):
    return replace(PathSGDParams().derive_from_graph(pidx), dtype="float32",
                   pow_mode="fast", iter_max=iter_max)


def _pnd(pidx, iter_max=4):
    return replace(LayoutSGDParams().derive_from_graph(pidx, 2),
                   dtype="float32", pow_mode="fast", iter_max=iter_max,
                   min_term_updates=pidx.total_steps)


def _unjitted_1d(pidx, p, kw):
    with jax.disable_jit():
        run, arrays, make_state, info = jax_sweep.build_sweep_runner(
            pidx, p, **kw)
        xs0, xn0 = make_state()
        return np.asarray(run(xs0, xn0, jax.random.key(p.seed), *arrays)), info


def _port_1d(pidx, p, kw):
    run, arrays, make_state, info = port_sweep.build_sweep_runner(
        pidx, p, **kw, device="cpu")
    _, _, _, xs0, xn0 = sweep_state_from_numpy(pidx, None, "cpu")
    return run(xs0, xn0, key_data(p.seed), *arrays).numpy(), info


def _unjitted_nd(pidx, lp, kw, init, monkeypatch):
    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
        run, arrays, make_state, info = jax_nd.build_sweep_nd_runner(
            pidx, lp, **kw)
        cs0, csn0 = make_state(init)
        return np.asarray(run(cs0, csn0, jax.random.key(lp.seed), *arrays)), info


def _port_nd(pidx, lp, kw, init):
    run, arrays, make_state, info = port_nd.build_sweep_nd_runner(
        pidx, lp, **kw, device="cpu")
    cs0, csn0 = make_state(init)
    return run(cs0, csn0, key_data(lp.seed), *arrays).numpy(), info


# ---- the executed-sweep count ------------------------------------------

@pytest.mark.parametrize("shape,kind,dims,want", [
    ((210_000, 30, 100_000), "1d", 1, 288),
    ((250_000, 6, 250_000), "nd", 2, 288),
    ((250_000, 6, 250_000), "nd", 3, 432),
])
def test_n_exec_equals_the_jax_count(shape, kind, dims, want):
    """Plans only: the JAX engines' ``n_dispatch x chunk_periods x ce``
    (``gfasort_tpu/ops/sweep.py``, ``sweep_nd.py``) on three shapes that
    ``auto`` sends to the sweep engine, where the chunk does not divide
    the periods."""
    px = port_synthetic_path_index(*shape, seed=0)
    if kind == "1d":
        plan = make_sweep_plan(px, PortPathParams().derive_from_graph(px))
        budget = int(5e8)
    else:
        plan = make_layout_plan(
            px, PortLayoutParams().derive_from_graph(px, dims))
        budget = int(5e8) // 2
    S, ce = px.total_steps, plan.consensus_every
    n_periods = -(-plan.n_sweeps // ce)
    chunk = max(1, min(n_periods, budget // max(S * ce, 1)))
    jax_count = -(-n_periods // chunk) * chunk * ce
    assert plan.n_exec == jax_count == want
    assert plan.n_exec > n_periods * ce   # more than whole periods
    assert executed_sweeps(plan.n_sweeps, ce, S, budget) == want


def test_bench_shape_counts_stay(monkeypatch):
    """The bench shape's chunk covers all its periods: 120 executed
    sweeps of ``Y`` and 72 of the 2D layout, as before the count was
    repaired."""
    px = port_synthetic_path_index(1_000_000, 16, 250_000, seed=0)
    assert make_sweep_plan(px, PortPathParams().derive_from_graph(
        px)).n_exec == 120
    lp = replace(PortLayoutParams().derive_from_graph(px, 2), iter_max=30)
    assert make_layout_plan(px, lp).n_exec == 72


def test_chunked_1d_runner_equals_unjitted_jax(pidx, monkeypatch):
    p = _p1d(pidx)
    plan = make_sweep_plan(pidx, p, **KW_1D)
    S, ce = pidx.total_steps, plan.consensus_every
    assert (plan.n_sweeps, ce, plan.n_exec) == (5, 2, 6)
    # two periods per dispatch: 2 dispatches, 4 periods, 8 sweeps
    monkeypatch.setenv("GFASORT_SWEEP_DISPATCH_ELEMS", str(2 * S * ce))
    assert make_sweep_plan(pidx, p, **KW_1D).n_exec == 8
    x_j, info_j = _unjitted_1d(pidx, p, KW_1D)
    x_t, info_t = _port_1d(pidx, p, KW_1D)
    assert info_t == info_j
    np.testing.assert_array_equal(x_t, x_j)
    # the extra sweeps change the result
    monkeypatch.delenv("GFASORT_SWEEP_DISPATCH_ELEMS")
    assert not np.array_equal(_port_1d(pidx, p, KW_1D)[0], x_t)


def test_chunked_nd_runner_equals_unjitted_jax(pidx, monkeypatch):
    lp = _pnd(pidx)
    init = layout_initial_coords(pidx, 2, lp.seed)
    plan = make_layout_plan(pidx, lp, **KW_ND)
    S, ce = pidx.total_steps, plan.consensus_every
    assert (plan.n_sweeps, ce, plan.n_exec) == (5, 2, 6)
    # the nD budget is half the knob's
    monkeypatch.setenv("GFASORT_SWEEP_DISPATCH_ELEMS", str(4 * S * ce))
    assert make_layout_plan(pidx, lp, **KW_ND).n_exec == 8
    x_j, info_j = _unjitted_nd(pidx, lp, KW_ND, init, monkeypatch)
    x_t, info_t = _port_nd(pidx, lp, KW_ND, init)
    assert info_t == info_j
    np.testing.assert_array_equal(x_t, x_j)


# ---- the knobs that change results --------------------------------------

def test_snap_down_1d_equals_unjitted_jax(pidx, monkeypatch):
    monkeypatch.setenv("GFASORT_SNAP", "down")
    p = _p1d(pidx, 2)
    x_t = _port_1d(pidx, p, KW_1D)[0]
    np.testing.assert_array_equal(x_t, _unjitted_1d(pidx, p, KW_1D)[0])
    monkeypatch.setenv("GFASORT_SNAP", "stoch")
    assert not np.array_equal(_port_1d(pidx, p, KW_1D)[0], x_t)


def test_snap_down_nd_equals_unjitted_jax(pidx, monkeypatch):
    monkeypatch.setenv("GFASORT_SNAP", "down")
    lp = _pnd(pidx, 2)
    init = layout_initial_coords(pidx, 2, lp.seed)
    x_t = _port_nd(pidx, lp, KW_ND, init)[0]
    np.testing.assert_array_equal(
        x_t, _unjitted_nd(pidx, lp, KW_ND, init, monkeypatch)[0])
    monkeypatch.setenv("GFASORT_SNAP", "stoch")
    assert not np.array_equal(_port_nd(pidx, lp, KW_ND, init)[0], x_t)


def test_kernel_kmax_moves_buckets_and_equals_unjitted_jax(pidx, monkeypatch):
    p = _p1d(pidx, 2)
    full = make_sweep_plan(pidx, p, **KW_1D).phases[0]
    assert not full.roll_buckets
    monkeypatch.setenv("GFASORT_KERNEL_KMAX", "2")
    ph = make_sweep_plan(pidx, p, **KW_1D).phases[0]
    assert [k for k, _ in ph.kernel_buckets] == [1, 2]
    assert all(k > 2 for k, _ in ph.roll_buckets) and ph.roll_buckets
    x_j, info_j = _unjitted_1d(pidx, p, KW_1D)
    x_t, info_t = _port_1d(pidx, p, KW_1D)
    assert info_t == info_j
    np.testing.assert_array_equal(x_t, x_j)


@pytest.mark.parametrize("value,want", [("0", 0), ("-5", 0), ("4096", 4096),
                                        ("99999", 8192)])
def test_kernel_kmax_is_clamped(monkeypatch, value, want):
    monkeypatch.setenv("GFASORT_KERNEL_KMAX", value)
    assert sweep_knobs().kmax == want


def test_dense_kernel_xla_serves_every_bucket_by_roll_passes(pidx, monkeypatch):
    monkeypatch.setenv("GFASORT_DENSE_KERNEL", "xla")
    p = _p1d(pidx, 2)
    plan = make_sweep_plan(pidx, p, **KW_1D)
    assert not plan.dense_kernel
    assert all(not ph.kernel_buckets for ph in plan.phases)
    x_j, info_j = _unjitted_1d(pidx, p, KW_1D)
    x_t, info_t = _port_1d(pidx, p, KW_1D)
    assert info_t == info_j
    np.testing.assert_array_equal(x_t, x_j)
    # auto is pallas in the port (the kernel on at every size)
    monkeypatch.setenv("GFASORT_DENSE_KERNEL", "auto")
    assert make_sweep_plan(pidx, p, **KW_1D).dense_kernel


@pytest.mark.parametrize("value", ["gather", "auto"])
def test_consensus_gather_and_auto_run_the_gather_consensus(pidx, monkeypatch,
                                                            value):
    monkeypatch.setenv("GFASORT_CONSENSUS", value)
    x, info = _port_1d(pidx, _p1d(pidx, 2), KW_1D)
    assert info["consensus"] == "gather" and np.isfinite(x).all()


def test_consensus_grid_is_refused(pidx, monkeypatch):
    monkeypatch.setenv("GFASORT_CONSENSUS", "grid")
    with pytest.raises(NotImplementedError, match="GFASORT_CONSENSUS"):
        make_sweep_plan(pidx, _p1d(pidx))
    with pytest.raises(NotImplementedError, match="GFASORT_CONSENSUS"):
        make_layout_plan(pidx, _pnd(pidx))


@pytest.mark.parametrize("knob,value", [
    ("GFASORT_SWEEP_RNG", "philox"), ("GFASORT_SNAP", "up"),
    ("GFASORT_DENSE_KERNEL", "mosaic"), ("GFASORT_CONSENSUS", "mxu"),
    ("GFASORT_KERNEL_KMAX", "many"), ("GFASORT_SWEEP_DISPATCH_ELEMS", "5e8")])
def test_unknown_knob_values_are_refused_by_name(pidx, monkeypatch, knob,
                                                 value):
    monkeypatch.setenv(knob, value)
    with pytest.raises(ValueError, match=knob):
        make_sweep_plan(pidx, _p1d(pidx))


def test_sweep_rng_knob_reaches_both_plans(pidx, monkeypatch):
    assert make_sweep_plan(pidx, _p1d(pidx)).knobs.rng == "hash"
    monkeypatch.setenv("GFASORT_SWEEP_RNG", "threefry")
    assert make_sweep_plan(pidx, _p1d(pidx)).knobs.rng == "threefry"
    assert make_layout_plan(pidx, _pnd(pidx)).knobs.rng == "threefry"


def test_ignored_knobs_change_nothing(pidx, monkeypatch):
    """``GFASORT_DK_BUDGET`` and ``GFASORT_ROT_UNROLL`` only change how
    the JAX engine computes, not what."""
    p = _p1d(pidx, 2)
    x0 = _port_1d(pidx, p, KW_1D)[0]
    monkeypatch.setenv("GFASORT_DK_BUDGET", "0")
    monkeypatch.setenv("GFASORT_ROT_UNROLL", "1")
    np.testing.assert_array_equal(_port_1d(pidx, p, KW_1D)[0], x0)
