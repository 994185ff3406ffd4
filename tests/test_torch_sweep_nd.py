"""Port parity for the nD layout sweep (the ``L`` step): the nD bucket
apply's plain version against the JAX ``build_dense_apply_nd`` (its
interpret-mode reference on the CPU), the layout plan against the JAX
runner's ``info``, and the whole nD runner against the JAX runner from
one numpy state and key.  The hand-written CUDA kernel is tested
against the plain version in tests/test_torch_cuda.py."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gfasort_tpu.bench_util import synthetic_path_index  # noqa: E402
from gfasort_tpu.ops import sweep_common as jsc  # noqa: E402
from gfasort_tpu.ops import sweep_nd as jax_nd  # noqa: E402
from gfasort_tpu.ops.exact import (calculate_layout_stress_pidx,  # noqa: E402
                                   layout_initial_coords)
from gfasort_tpu.ops.sweep_dense import build_dense_apply_nd  # noqa: E402
from gfasort_tpu.params import LayoutSGDParams  # noqa: E402
from gfasort_tpu_torch.convert import (key_words_from_jax,  # noqa: E402
                                       layout_state, layout_static_arrays)
from gfasort_tpu_torch.ops import sweep_nd as port_nd  # noqa: E402
from gfasort_tpu_torch.ops.sweep_common import INACTIVE  # noqa: E402
from gfasort_tpu_torch.ops.sweep_dense import (dense_apply_nd,  # noqa: E402
                                               dense_apply_nd_ref, sqrt_rn)
from gfasort_tpu_torch.ops.sweep_plan import make_layout_plan  # noqa: E402

# the TPU kernel test's precedent (tests/test_sweep_dense.py)
ACC_RTOL, ACC_ATOL = 2e-5, 1e-4

DENSE = [(k, k - 1) for k in range(1, 9)]
MID = [(1, 0), (2, 1), (3, 2), (4, 3), (6, 4), (8, 5), (181, 9), (1024, 11)]


def _contract_sidx(rng, S, buckets):
    """Random choices that never cross the array ends (the sampler
    contract), plus INACTIVE and choices of buckets not in the list."""
    kis = [ki for _, ki in buckets]
    s = rng.choice(kis + [~ki for ki in kis] + [int(INACTIVE), 3, ~2],
                   S).astype(np.int32)
    iota = np.arange(S)
    for k, ki in buckets:
        s = np.where((s == ki) & (iota + k >= S), INACTIVE, s)
        s = np.where((s == ~ki) & (iota - k < 0), INACTIVE, s)
    return s


def _nd_inputs(S, D, buckets, P, seed):
    rng = np.random.default_rng(seed)
    # repeated positions (d == 0 pairs) and coincident coordinates
    # (the mag^2 == 0 guard) are part of the contract
    my_pos = np.cumsum(rng.integers(0, 4, S)).astype(np.float32)
    my_c = rng.integers(-3, 4, (D, S)).astype(np.float32)
    my_c[:, ::3] += rng.standard_normal((D, len(my_c[0, ::3]))).astype(
        np.float32) * 50
    sidxs = [_contract_sidx(rng, S, buckets) for _ in range(P)]
    if P == 1:
        words = sidxs
    else:
        words = [np.array(w) for w in jsc.pack_choices_words(
            [jnp.asarray(s) for s in sidxs])]
    return my_pos, words, my_c, np.float32(0.9)


@pytest.mark.parametrize("buckets_name", ["dense", "mid"])
@pytest.mark.parametrize("D,P", [(2, 1), (2, 4), (2, 8), (3, 1), (3, 4),
                                 (3, 8)])
def test_dense_apply_nd_ref_matches_jax(D, P, buckets_name):
    buckets = DENSE if buckets_name == "dense" else MID
    S = 3001
    my_pos, words, my_c, eta = _nd_inputs(S, D, buckets, P, seed=10 * D + P)
    ref = build_dense_apply_nd(len(buckets), S, D, jnp.float32,
                               interpret=True, buckets=buckets, proposals=P)
    acc_j, wacc_j = ref(jnp.asarray(my_pos),
                        [jnp.asarray(w) for w in words],
                        [jnp.asarray(c) for c in my_c], eta)
    tw = [torch.from_numpy(w) for w in words]
    acc_t, wacc_t = dense_apply_nd(torch.from_numpy(my_pos), tw,
                                   torch.from_numpy(my_c), float(eta),
                                   buckets, P)
    assert acc_t.shape == (D, S) and acc_t.dtype == torch.float32
    np.testing.assert_array_equal(wacc_t.numpy(), np.asarray(wacc_j))
    assert float(wacc_t.sum()) > 0
    np.testing.assert_allclose(acc_t.numpy(), np.stack(acc_j),
                               rtol=ACC_RTOL, atol=ACC_ATOL)
    # the wrapper's CPU path is the plain version itself
    acc_r, wacc_r = dense_apply_nd_ref(torch.from_numpy(my_pos), tw,
                                       torch.from_numpy(my_c), float(eta),
                                       buckets, P)
    assert torch.equal(acc_r, acc_t) and torch.equal(wacc_r, wacc_t)


def test_dense_apply_nd_checks_inputs():
    my_pos, words, my_c, eta = _nd_inputs(100, 2, DENSE, 1, seed=1)
    pos, w = torch.from_numpy(my_pos), [torch.from_numpy(words[0])]
    with pytest.raises(ValueError, match="my_c"):
        dense_apply_nd(pos, w, torch.from_numpy(my_c[:, :50]), 0.9, DENSE)
    with pytest.raises(ValueError, match="my_c"):
        dense_apply_nd(pos, w, torch.from_numpy(my_c).double(), 0.9, DENSE)
    with pytest.raises(ValueError, match="choice words"):
        dense_apply_nd(pos, w, torch.from_numpy(my_c), 0.9, DENSE, 8)
    before = dense_apply_nd.launches
    dense_apply_nd(pos, w, torch.from_numpy(my_c), 0.9, DENSE)
    assert dense_apply_nd.launches == before   # the CPU counts no launch


def _lparams(pidx, D, iter_max, **kw):
    return replace(LayoutSGDParams().derive_from_graph(pidx, D),
                   dtype="float32", pow_mode="fast", iter_max=iter_max, **kw)


CONFIGS = {
    # small regime, P = 1, every offset served by the kernel
    "small_d2_p1": ((2000, 3, 2000, 3), 2, {}),
    # the large-regime knobs at a test size: P = 8 (2 words), offsets
    # above KMAX served by roll passes
    "large_d2_p8": ((3000, 2, 6000, 5), 2, dict(
        proposals=8, per_octave=3, dense_upto=4, rotate=2,
        consensus_every=4, active_frac=1.0)),
    # D = 3 clamps P = 8 to 4 (1 word)
    "large_d3_p8": ((3000, 2, 6000, 6), 3, dict(
        proposals=8, per_octave=3, dense_upto=4, rotate=2,
        consensus_every=4, active_frac=1.0)),
}


def _run_jax(pidx, lp, kw, init):
    run, arrays, make_state, info = jax_nd.build_sweep_nd_runner(pidx, lp, **kw)
    cs0, csn0 = make_state(init)
    x = np.asarray(run(cs0, csn0, jax.random.key(lp.seed), *arrays))
    return x, info, arrays


def _run_port(pidx, lp, kw, init, jax_arrays=None):
    run, arrays, make_state, info = port_nd.build_sweep_nd_runner(
        pidx, lp, **kw, device="cpu")
    # what the JAX build_sweep_nd_runner uploads, from the same numpy state
    assert all(torch.equal(a, b) for a, b in zip(
        layout_static_arrays(pidx, "cpu"), arrays))
    if jax_arrays is not None:
        for a, b in zip(arrays, jax_arrays):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cs0, csn0 = make_state(init)
    key = key_words_from_jax(np.asarray(
        jax.random.key_data(jax.random.key(lp.seed))))
    x = run(cs0, csn0, key, *arrays)
    return x.numpy(), info


def _layout(x, D):
    n = x.shape[1]
    from gfasort_tpu_torch.io.layout_tsv import Layout

    return Layout.from_state(np.ascontiguousarray(
        x.astype(np.float64).reshape(2, D, n).transpose(2, 0, 1)
        .reshape(2 * n, D)))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request):
    mp = pytest.MonkeyPatch()
    # the JAX reference sums kernel buckets first, then the roll buckets,
    # only with the kernel forced; the port's consensus is the gather form
    mp.setenv("GFASORT_DENSE_KERNEL", "pallas")
    mp.setenv("GFASORT_CONSENSUS", "gather")
    try:
        shape, D, kw = CONFIGS[request.param]
        pidx = synthetic_path_index(*shape[:3], seed=shape[3])
        out = {"name": request.param, "pidx": pidx, "D": D}
        # a whole short schedule (4 iterations, one term update per step
        # each) inside one consensus period
        lp = _lparams(pidx, D, 3, min_term_updates=pidx.total_steps)
        init = layout_initial_coords(pidx, D, lp.seed)
        x_j, info_j, arr_j = _run_jax(pidx, lp, kw, init)
        out["period"] = ((x_j, info_j), _run_port(pidx, lp, kw, init, arr_j),
                         _run_port(pidx, lp, kw, init))
        # the same JAX runner op by op (no fusion), with its rsqrt read as
        # the port's 1 / sqrt
        with mp.context() as m, jax.disable_jit():
            m.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
            out["unjitted"] = _run_jax(pidx, lp, kw, init)[0]
        yield out
    finally:
        mp.undo()


def test_layout_runner_info_equals_jax(runs):
    (_, info_j), (_, info_t), _ = runs["period"]
    assert info_t == info_j
    if runs["name"] == "large_d3_p8":
        assert info_t["proposals"] == 4


def test_one_consensus_period_matches_jax(runs):
    (x_j, info), (x_t, _), _ = runs["period"]
    assert info["n_sweeps"] <= info["consensus_every"]
    assert x_t.shape == (2 * runs["D"], runs["pidx"].num_nodes)
    assert x_t.dtype == np.float32 and np.isfinite(x_t).all()
    # XLA's fusion of the jitted sweep and its approximate rsqrt
    # (test_one_consensus_period_equals_unjitted_jax_with_exact_rsqrt)
    np.testing.assert_allclose(x_t, x_j, rtol=1e-4, atol=0.2)


def test_one_consensus_period_equals_unjitted_jax_with_exact_rsqrt(runs):
    """Bit for bit against the JAX runner run op by op with ``rsqrt``
    as 1 / sqrt: the consensus sums each node's steps in the scatter-add's
    order and the square roots are correctly rounded on the CPU
    (``sqrt_rn``), as in the kernel."""
    (_, _), (x_t, _), _ = runs["period"]
    np.testing.assert_array_equal(x_t, runs["unjitted"])


def test_port_layout_runs_are_bit_identical(runs):
    _, (x_a, _), (x_b, _) = runs["period"]
    np.testing.assert_array_equal(x_a, x_b)


def test_schedule_stress_certifies_against_jax(runs):
    (x_j, _), (x_t, _), _ = runs["period"]
    D, pidx = runs["D"], runs["pidx"]
    s_j = calculate_layout_stress_pidx(pidx, _layout(x_j, D), 3000)
    s_t = calculate_layout_stress_pidx(pidx, _layout(x_t, D), 3000)
    assert np.isfinite(x_t).all() and s_t > 0
    assert s_t / s_j <= 1.5, (s_t, s_j)


@pytest.mark.parametrize("D", [2, 3])
def test_layout_plan_info_equals_jax_at_large_auto_regime(monkeypatch, D):
    """Zero-knob layout plan above LARGE_S (P = 8 clamped by D, rotate
    12, dense_upto 4) — the bench's regime — without running either
    engine; the kernel gate holds in every phase."""
    monkeypatch.setenv("GFASORT_DENSE_KERNEL", "pallas")
    monkeypatch.setenv("GFASORT_CONSENSUS", "gather")
    pidx = synthetic_path_index(80_000, 4, 80_000, seed=2)
    lp = _lparams(pidx, D, 30)
    _, _, _, info_j = jax_nd.build_sweep_nd_runner(pidx, lp)
    plan = make_layout_plan(pidx, lp)
    assert plan.layout_info() == info_j
    assert plan.proposals == (8 if D == 2 else 4) and plan.rotate == 12
    assert plan.n_exec % plan.consensus_every == 0
    assert all(ph.kernel_buckets for ph in plan.phases)
    assert all(k <= 1024 for ph in plan.phases for k, _ in ph.kernel_buckets)
    assert all(k > 1024 for ph in plan.phases for k, _ in ph.roll_buckets)


def test_layout_state_matches_jax_make_state():
    pidx = synthetic_path_index(500, 2, 600, seed=4)
    lp = _lparams(pidx, 3, 2)
    init = layout_initial_coords(pidx, 3, lp.seed)
    _, _, make_state, _ = jax_nd.build_sweep_nd_runner(pidx, lp)
    cs_j, csn_j = make_state(init)
    cs_t, csn_t = layout_state(pidx, init, 3, "cpu")
    np.testing.assert_array_equal(cs_t.numpy(), np.asarray(cs_j))
    np.testing.assert_array_equal(csn_t.numpy(), np.asarray(csn_j))


def test_layout_sweep_contract_edges():
    from gfasort_tpu_torch.graph import BidirectedGraph
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.params import LayoutSGDParams as PortParams

    g = BidirectedGraph()
    for i in (1, 2, 3, 4):
        g.add_node(i, b"ACGT")
    g.build_path("p", [(1, False), (2, True), (3, False)])
    pidx = PathIndex.from_graph(g)
    lp = replace(PortParams().derive_from_graph(pidx, 2), iter_max=3)
    lay = port_nd.path_linear_sgd_layout_sweep(g, lp, pidx, device="cpu")
    assert lay.num_nodes == 4 and np.isfinite(lay.coords).all()
    # node 4 is on no path: it keeps its initial coordinates
    from gfasort_tpu_torch.ops.exact import layout_initial_coords as init_of

    init = init_of(pidx, 2, lp.seed).reshape(4, 2, 2)
    np.testing.assert_allclose(lay.coords[3], init[3].astype(np.float32))
    assert port_nd.path_linear_sgd_layout_sweep(
        BidirectedGraph(), lp, device="cpu").num_nodes == 0
    # the float64 engine runs too (threefry draws, roll passes only)
    lay64 = port_nd.path_linear_sgd_layout_sweep(
        g, replace(lp, dtype="float64"), pidx, device="cpu")
    assert lay64.num_nodes == 4 and np.isfinite(lay64.coords).all()
    np.testing.assert_array_equal(lay64.coords[3], init[3])


def test_sqrt_rn_is_correctly_rounded():
    """``sqrt_rn`` (the plain versions' square root) equals numpy's f32
    sqrt, the IEEE root, over several ranges."""
    rng = np.random.default_rng(3)
    x = np.concatenate([np.abs(rng.standard_normal(200_000)) * 1e5,
                        rng.random(200_000) * 1e-30, rng.random(1000) * 1e30,
                        [0.0, 1e-18, 1.0, 2.0, 3e38]]).astype(np.float32)
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def test_rsqrt_spec_is_within_one_ulp_of_exact_as_xla_rsqrt():
    """The port computes the JAX spec's ``rsqrt`` as ``1 / sqrt`` (two
    correctly rounded ops, the same on the CPU and in the CUDA kernel).
    XLA:CPU's ``jax.lax.rsqrt`` is not bit-equal to it: each lies within
    1 ulp of the exactly rounded value, so they differ by up to 2 ulp."""
    rng = np.random.default_rng(0)
    x = np.concatenate([np.abs(rng.standard_normal(20_000)),
                        rng.random(20_000) * 1e8, rng.random(20_000) * 1e-6,
                        [1e-18, 1.0, 4.0]]).astype(np.float32)
    port = (1.0 / sqrt_rn(torch.from_numpy(x))).numpy()
    xla = np.asarray(jax.lax.rsqrt(jnp.asarray(x)))
    exact = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)

    def ulps(a, b):
        return np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64))

    assert ulps(port, exact).max() <= 1
    assert ulps(xla, exact).max() <= 1
    assert 0 < ulps(port, xla).max() <= 2


def test_sqrt_rn_is_correctly_rounded_f64():
    """``sqrt_rn`` at f64 equals numpy's f64 sqrt, the IEEE root (the
    f64 route's plain square root)."""
    rng = np.random.default_rng(4)
    x = np.concatenate([np.abs(rng.standard_normal(200_000)) * 1e5,
                        rng.random(200_000) * 1e-200, rng.random(1000) * 1e300,
                        [0.0, 1e-18, 1.0, 2.0]])
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def test_rsqrt_spec_f64_is_within_one_ulp_of_exact_as_xla_rsqrt():
    """At f64 as at f32: the port's ``1 / sqrt`` and XLA:CPU's f64
    ``rsqrt`` each lie within 1 ulp of the exactly rounded value
    (computed in the 80-bit long double), so they differ by up to 2
    ulp."""
    rng = np.random.default_rng(1)
    x = np.concatenate([np.abs(rng.standard_normal(20_000)),
                        rng.random(20_000) * 1e12, rng.random(20_000) * 1e-18,
                        [1e-18, 1.0, 4.0]])
    port = (1.0 / sqrt_rn(torch.from_numpy(x))).numpy()
    xla = np.asarray(jax.lax.rsqrt(jnp.asarray(x)))
    exact = (1.0 / np.sqrt(x.astype(np.longdouble))).astype(np.float64)

    def ulps(a, b):
        return np.abs(a.view(np.int64) - b.view(np.int64))

    assert np.finfo(np.longdouble).nmant > 52
    assert ulps(port, exact).max() <= 1
    assert ulps(xla, exact).max() <= 1
    assert 0 < ulps(port, xla).max() <= 2


# ---- the threefry draws at f32 and the f64 route -------------------------

# GFASORT_SWEEP_RNG=threefry at f32 (D = 3, kernel and roll buckets), and
# f64 under the default knob (D = 2): the f64 engine always draws
# threefry and serves every bucket by roll passes
MODES = {"threefry_f32_d3": ("float32", "threefry", 3),
         "f64_d2": ("float64", "hash", 2)}
MODE_KW = dict(proposals=2, per_octave=2, dense_upto=4, rotate=2,
               consensus_every=4, active_frac=1.0)


@pytest.fixture(scope="module", params=sorted(MODES))
def mode_runs(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("GFASORT_DENSE_KERNEL", "pallas")
    mp.setenv("GFASORT_CONSENSUS", "gather")
    dtype, rng, D = MODES[request.param]
    mp.setenv("GFASORT_SWEEP_RNG", rng)
    try:
        pidx = synthetic_path_index(3000, 2, 6000, seed=5)
        # 3 sweeps: one consensus period
        lp = replace(_lparams(pidx, D, 2, min_term_updates=pidx.total_steps),
                     dtype=dtype)
        init = layout_initial_coords(pidx, D, lp.seed)
        key = key_words_from_jax(np.asarray(
            jax.random.key_data(jax.random.key(lp.seed))))

        def port():
            run, arrays, make_state, info = port_nd.build_sweep_nd_runner(
                pidx, lp, **MODE_KW, device="cpu")
            cs0, csn0 = make_state(init)
            return run(cs0, csn0, key, *arrays).numpy(), info

        out = {"name": request.param, "dtype": dtype, "D": D, "pidx": pidx,
               "port": (port(), port())}
        with jax.disable_jit():
            out["unjitted_rsqrt"] = _run_jax(pidx, lp, MODE_KW, init)[:2]
            with mp.context() as m:
                m.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
                out["unjitted"] = _run_jax(pidx, lp, MODE_KW, init)[0]
        yield out
    finally:
        mp.undo()


def test_mode_layout_runner_info_equals_jax(mode_runs):
    (_, info_j), ((_, info_t), _) = mode_runs["unjitted_rsqrt"], mode_runs["port"]
    assert info_t == info_j
    assert info_t["n_sweeps"] <= info_t["consensus_every"]


def test_mode_one_consensus_period_equals_unjitted_jax(mode_runs):
    """Bit for bit with the JAX ``rsqrt`` read as ``1 / sqrt``; with
    XLA:CPU's own ``rsqrt`` (up to 2 ulp from the port's, in f32 and in
    f64) within rtol 1e-4 / atol 0.2 at f32, as the f32 configs against
    the jitted runner, and rtol 1e-9 / atol 1e-6 at f64."""
    x_u = mode_runs["unjitted"]
    (x_r, _), ((x_t, _), _) = mode_runs["unjitted_rsqrt"], mode_runs["port"]
    assert x_t.shape == (2 * mode_runs["D"], mode_runs["pidx"].num_nodes)
    assert x_t.dtype == np.dtype(mode_runs["dtype"]) and np.isfinite(x_t).all()
    np.testing.assert_array_equal(x_t, x_u)
    if mode_runs["dtype"] == "float64":
        np.testing.assert_allclose(x_t, x_r, rtol=1e-9, atol=1e-6)
    else:
        np.testing.assert_allclose(x_t, x_r, rtol=1e-4, atol=0.2)


def test_mode_port_layout_runs_are_bit_identical(mode_runs):
    (x_a, _), (x_b, _) = mode_runs["port"]
    np.testing.assert_array_equal(x_a, x_b)
