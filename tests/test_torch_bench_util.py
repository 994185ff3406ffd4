"""The port's measurement layer against the JAX package's, on the CPU:
the exact applied-update counter (``ops/sweep.py::build_applied_counter``)
integer for integer and ``info`` key for key, ``measure_applied_frac``,
``roofline_model`` (at the v5e peaks it equals the JAX model; at the H100
peaks its fractions are the JAX ones scaled by the ratio of peaks),
``shuffled_path_index``, the timed bench functions' keys and counts, and
the sweep certificate.  Inputs are made from seeds with numpy; the JAX
counters run jitted on the CPU."""

import ast
import pathlib
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import gfasort_tpu.bench_util as j_bench  # noqa: E402
import gfasort_tpu.ops.sgd as j_sgd  # noqa: E402
import gfasort_tpu.ops.sweep as j_sweep  # noqa: E402
import gfasort_tpu.ops.sweep_nd as j_sweep_nd  # noqa: E402
from gfasort_tpu.params import LayoutSGDParams as JLayoutParams  # noqa: E402
from gfasort_tpu.params import PathSGDParams as JParams  # noqa: E402

import gfasort_tpu_torch.bench_util as t_bench  # noqa: E402
import gfasort_tpu_torch.ops.sweep as t_sweep  # noqa: E402
from gfasort_tpu_torch.ops.keys import fold_in, key_data  # noqa: E402
from gfasort_tpu_torch.ops.sweep_common import (INACTIVE,  # noqa: E402
                                                sample_blocks,
                                                sampler_consts, sweep_rng)
from gfasort_tpu_torch.ops.sweep_plan import make_sweep_plan  # noqa: E402
from gfasort_tpu_torch.params import PathSGDParams  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

# the shape of tests/test_sweep.py::test_applied_counter_matches_manual_count
SHAPE = (2000, 3, 4000)
SEED = 5

V5E = dict(HBM_BYTES_S=819e9, F32_OPS_S=3.85e12)


def _pidx(coarse: int = 1):
    """The seed-5 workload; ``coarse`` > 1 divides the step positions so
    that neighbouring steps share one and some pairs have term distance
    0 (the counter must skip them)."""
    pidx = t_bench.synthetic_path_index(*SHAPE, seed=SEED)
    if coarse > 1:
        pidx = replace(pidx, step_pos=pidx.step_pos // coarse)
    return pidx


def _params(pidx, **over):
    p = replace(PathSGDParams().derive_from_graph(pidx), dtype="float32",
                pow_mode="fast")
    return replace(p, **over)


def _jparams(p):
    return JParams(**vars(p))


# case -> (position coarsening, params overrides, counter knobs, env)
COUNTER_CASES = {
    # tests/test_sweep.py's case: one sweep, P = 1, half the steps active
    "p1_frac_half": (1, dict(iter_max=0, min_term_updates=6000),
                     dict(per_octave=3, consensus_every=1, active_frac=0.5,
                          rotate=1), {}),
    # 7 sweeps in periods of 4: one period-padding sweep, P = 12
    "p12_period_padding": (1, dict(iter_max=6),
                           dict(per_octave=1, consensus_every=4, rotate=1,
                                dense_upto=2, proposals=12, active_frac=1.0),
                           {}),
    # f64: the threefry draws and the f64 sampler, P = 2 over 2 phases
    "f64": (1, dict(iter_max=4, dtype="float64"),
            dict(per_octave=2, consensus_every=4, rotate=2, proposals=2,
                 active_frac=0.7), {}),
    # 3 periods of 2 sweeps, dispatches of 2 periods: the engines execute
    # 8 sweeps, the counter (as the JAX one) replays 6
    "dispatch_padding": (1, dict(iter_max=5, min_term_updates=12000),
                         dict(per_octave=2, consensus_every=2, rotate=1,
                              active_frac=1.0),
                         {"GFASORT_SWEEP_DISPATCH_ELEMS": str(2 * 2 * 12000)}),
    # term distance 0 between some neighbours: applied < proposed
    "zero_distance_pairs": (8, dict(iter_max=2, min_term_updates=12000),
                            dict(per_octave=3, consensus_every=3, rotate=1,
                                 active_frac=1.0), {}),
}


@pytest.fixture(scope="module", params=sorted(COUNTER_CASES))
def counters(request):
    coarse, over, cfg, env = COUNTER_CASES[request.param]
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    try:
        pidx = _pidx(coarse)
        p = _params(pidx, **over)
        fn_t, arrays_t, info_t = t_sweep.build_applied_counter(
            pidx, p, **cfg, device="cpu")
        res_t = fn_t(key_data(p.seed), *arrays_t)
        fn_j, arrays_j, info_j = j_sweep.build_applied_counter(
            pidx, _jparams(p), **cfg)
        res_j = fn_j(jax.random.key(p.seed), *arrays_j)
        plan = make_sweep_plan(pidx, p, **cfg)
        yield dict(name=request.param, port=(res_t, info_t),
                   jax=(res_j, info_j), plan=plan)
    finally:
        mp.undo()


def test_applied_counter_equals_jax(counters):
    (res_t, info_t), (res_j, info_j) = counters["port"], counters["jax"]
    assert res_t == res_j
    assert all(type(v) is int for v in res_t.values())
    assert info_t == info_j
    assert 0 < res_t["applied"] <= res_t["proposed_actual"]
    if counters["name"] == "zero_distance_pairs":
        assert res_t["applied"] < res_t["proposed_actual"]
    else:
        assert res_t["applied"] == res_t["proposed_actual"]


def test_applied_counter_replays_the_counter_schedule(counters):
    """``total_exec_sweeps`` is the JAX counter's whole consensus periods;
    under a dispatch budget that does not divide the periods the engines
    execute more (``SweepPlan.n_exec``), and the counter, like the JAX
    one, leaves those sweeps out."""
    _, info = counters["port"]
    plan = counters["plan"]
    ce = plan.consensus_every
    assert info["total_exec_sweeps"] == -(-plan.n_sweeps // ce) * ce
    assert info["n_sweeps"] == plan.n_sweeps
    if counters["name"] == "dispatch_padding":
        assert (info["total_exec_sweeps"], plan.n_exec) == (6, 8)
    else:
        assert info["total_exec_sweeps"] == plan.n_exec
    if counters["name"] == "p12_period_padding":
        assert (info["n_sweeps"], info["total_exec_sweeps"]) == (7, 8)


def test_applied_counter_equals_manual_count():
    """One sweep counted by hand from the port's sampler output, as
    tests/test_sweep.py counts the JAX sampler's (the case
    ``p1_frac_half``, whose JAX count the test above holds equal)."""
    _, over, cfg, _ = COUNTER_CASES["p1_frac_half"]
    pidx = _pidx()
    p = _params(pidx, **over)
    fn, (pos_t, rank, cnt), info = t_sweep.build_applied_counter(
        pidx, p, **cfg, device="cpu")
    res = fn(key_data(p.seed), pos_t, rank, cnt)
    plan = make_sweep_plan(pidx, p, **cfg)
    S = pidx.total_steps
    words = fold_in(key_data(p.seed), 0)
    sidx = sample_blocks(
        sampler_consts(plan.phases[0], False, "cpu"),
        [sweep_rng(words, S, "cpu")], False, rank, cnt, 0.5)[0].numpy()
    pos = pidx.step_pos
    manual = 0
    for ki, k in enumerate(plan.phases[0].offs.tolist()):
        fwd = np.flatnonzero(sidx == ki)
        manual += int(np.sum(pos[fwd] != pos[fwd + k]))
        bwd = np.flatnonzero(sidx == ~np.int32(ki))
        manual += int(np.sum(pos[bwd] != pos[bwd - k]))
    assert info["total_exec_sweeps"] == 1
    assert res["applied"] == manual
    assert res["proposed_actual"] == int(np.sum(sidx != INACTIVE))
    assert abs(res["applied"] - info["proposed"]) < 6 * (S * 0.25) ** 0.5


def test_measure_applied_frac_equals_jax():
    pidx = _pidx()
    cfg = dict(per_octave=2, consensus_every=3, rotate=1, active_frac=0.6)
    got = t_bench.measure_applied_frac(pidx, rounds=5, device="cpu", **cfg)
    want = j_bench.measure_applied_frac(pidx, rounds=5, **cfg)
    assert got == want
    assert (got["n_sweeps"], got["total_exec_sweeps"]) == (5, 6)
    assert got["applied"] == got["proposed_actual"] != got["proposed_scheduled"]


# roofline inputs: a bench result (updates / sweeps), and runner infos
# with kernel and roll buckets, P = 1 and P = 12, frac < 1
ROOFLINE_CASES = {
    "bench_p12": (6.0e9, dict(kernel_buckets_per_phase=6.0,
                              xla_buckets_per_phase=0.0,
                              consensus_every_eff=96, active_frac=1.0,
                              proposals=12, updates=4_608_000_000,
                              sweeps=96), 0.9987),
    "p1_roll": (8.0e8, dict(kernel_buckets_per_phase=6.0,
                            xla_buckets_per_phase=2.25, consensus_every=8,
                            active_frac=0.25, proposals=1,
                            updates_per_sweep=1_000_000), 0.75),
    "p4_no_kernel": (2.0e9, dict(kernel_buckets_per_phase=0.0,
                                 xla_buckets_per_phase=5.5,
                                 consensus_every=12, active_frac=0.5,
                                 proposals=4, updates_per_sweep=8_000_000),
                     1.0),
}


@pytest.mark.parametrize("case", sorted(ROOFLINE_CASES))
def test_roofline_equals_jax_at_v5e_peaks(case, monkeypatch):
    rate, info, applied = ROOFLINE_CASES[case]
    for k, v in V5E.items():
        monkeypatch.setattr(t_bench, k, v)
    got = t_bench.roofline_model(rate, info, applied, consensus_ms=12.5)
    want = j_bench.roofline_model(rate, info, applied, consensus_ms=12.5)
    assert got.pop("model") == "gfasort_tpu_torch.bench_util.roofline_model"
    assert want.pop("model") == "docs/DESIGN.md#roofline"
    assert got == want


@pytest.mark.parametrize("case", sorted(ROOFLINE_CASES))
def test_roofline_h100_fractions_are_jax_scaled_by_the_peaks(case):
    rate, info, applied = ROOFLINE_CASES[case]
    got = t_bench.roofline_model(rate, info, applied, consensus_ms=3.0)
    want = j_bench.roofline_model(rate, info, applied, consensus_ms=3.0)
    assert (t_bench.HBM_BYTES_S, t_bench.F32_OPS_S) == (3.35e12, 67e12)
    for key, peak in (("achieved_bw_frac", "HBM_BYTES_S"),
                      ("vpu_frac", "F32_OPS_S")):
        scale = V5E[peak] / getattr(t_bench, peak)
        # both sides are rounded to 4 places
        assert got[key] == pytest.approx(want[key] * scale, abs=1e-4)
    for key in ("bytes_per_update", "vpu_ops_per_update",
                "consensus_time_frac", "applied_updates_frac"):
        assert got[key] == want[key]
    assert got["binding"] == ("vpu" if got["vpu_frac"] >= got["achieved_bw_frac"]
                              else "hbm")


def test_roofline_consensus_ms_has_no_default():
    with pytest.raises(TypeError):
        t_bench.roofline_model(1e9, {}, 1.0)


def test_shuffled_path_index_equals_jax():
    got = t_bench.shuffled_path_index(3000, 3, 2000, seed=4)
    want = j_bench.shuffled_path_index(3000, 3, 2000, seed=4)
    for name in ("step_handle", "step_pos", "step_path", "step_rank",
                 "path_first", "path_count", "path_len", "node_ids",
                 "node_len", "step_node_idx", "step_count_of_step"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.handle_to_idx == want.handle_to_idx
    # the ids are scrambled: consecutive steps rarely share a neighbourhood
    plain = t_bench.synthetic_path_index(3000, 3, 2000, seed=4)
    assert not np.array_equal(got.step_node_idx, plain.step_node_idx)
    np.testing.assert_array_equal(np.sort(got.node_len), np.sort(plain.node_len))


def _jax_return_keys(name: str) -> set:
    """The keys of the dict literal the JAX function ``name`` of
    ``gfasort_tpu/bench_util.py`` returns, read from its source."""
    tree = ast.parse((REPO / "gfasort_tpu" / "bench_util.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ret = [n.value for n in ast.walk(fn)
           if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return {k.value for k in ret[-1].keys}


@pytest.fixture
def jax_runner_env(monkeypatch):
    """The kernel split and the consensus the JAX runners on the CPU
    share with the port (the JAX ``auto`` differs on its CPU backend)."""
    monkeypatch.setenv("GFASORT_DENSE_KERNEL", "pallas")
    monkeypatch.setenv("GFASORT_CONSENSUS", "gather")


BENCH_PIDX = (1500, 4, 1500)


def test_bench_sweep_1d_keys_and_counts(jax_runner_env):
    pidx = t_bench.synthetic_path_index(*BENCH_PIDX, seed=0)
    cfg = dict(per_octave=2, consensus_every=3, rotate=2, dense_upto=4,
               proposals=12, active_frac=1.0)
    got = t_bench.bench_sweep_1d(pidx, rounds=6, repeats=1, device="cpu",
                                 **cfg)
    assert set(got) == _jax_return_keys("bench_sweep_1d")
    # the JAX runner's info for the same schedule, built but not run
    p = replace(j_bench.bench_params(pidx, 1, 1), iter_max=5,
                min_term_updates=pidx.total_steps)
    *_, info = j_sweep.build_sweep_runner(pidx, p, **cfg)
    assert got["updates"] == info["n_sweeps"] * info["updates_per_sweep"]
    assert (got["sweeps"], got["consensus_every_eff"], got["rotate_eff"],
            got["proposals"]) == (info["n_sweeps"], info["consensus_every"],
                                  info["rotate"], info["proposals"])
    assert (got["kernel_buckets_per_phase"], got["xla_buckets_per_phase"]) == (
        info["kernel_buckets_per_phase"], info["xla_buckets_per_phase"])
    assert (got["consensus"], got["consensus_coverage"]) == ("gather", None)
    assert got["consensus"] == info["consensus"]
    assert got["final_finite"] and got["seconds"] > 0 and got["warmup_s"] > 0
    assert got["updates_per_s"] == got["updates"] / got["seconds"]


def test_bench_sweep_nd_keys_and_counts(jax_runner_env):
    pidx = t_bench.synthetic_path_index(*BENCH_PIDX, seed=0)
    cfg = dict(consensus_every=2, rotate=2, active_frac=1.0, dense_upto=4,
               proposals=8)
    got = t_bench.bench_sweep_nd(pidx, dims=3, rounds=4, repeats=1,
                                 device="cpu", **cfg)
    assert set(got) == _jax_return_keys("bench_sweep_nd")
    lp = replace(JLayoutParams().derive_from_graph(pidx, 3), iter_max=3,
                 min_term_updates=pidx.total_steps, dtype="float32",
                 pow_mode="fast")
    *_, info = j_sweep_nd.build_sweep_nd_runner(pidx, lp, **cfg)
    assert got["updates"] == info["n_sweeps"] * info["updates_per_sweep"]
    assert (got["sweeps"], got["consensus_every_eff"], got["rotate_eff"],
            got["proposals"], got["dims"]) == (
        info["n_sweeps"], info["consensus_every"], info["rotate"],
        info["proposals"], 3)
    assert got["proposals"] == 4  # the 3D proposal clamp
    assert got["final_finite"] and got["warmup_s"] > 0


def test_bench_batched_1d_keys_and_counts():
    pidx = t_bench.synthetic_path_index(*BENCH_PIDX, seed=0)
    got = t_bench.bench_batched_1d(pidx, batch=512, rounds=5, repeats=1,
                                   device="cpu")
    # the JAX function reports no warm-up; the port times it like the
    # sweep benches
    assert set(got) == _jax_return_keys("bench_batched_1d") | {"warmup_s"}
    _run, _make_x0, n_rounds = j_sgd.build_1d_runner(
        pidx, j_bench.bench_params(pidx, 512, 5))
    assert (got["rounds"], got["batch"], got["updates"]) == (
        n_rounds, 512, 512 * n_rounds)
    assert got["final_finite"] and got["warmup_s"] > 0


def test_sweep_quality_vs_oracle_close_to_jax(monkeypatch):
    """The same certificate through both engines (roll passes only and
    the gather consensus in both): the port's runner equals the unjitted
    JAX runner bit for bit, and XLA's fusion moves the jitted one within
    rtol 1e-5, so the rank measures agree to within a few swapped
    neighbours."""
    monkeypatch.setenv("GFASORT_DENSE_KERNEL", "xla")
    monkeypatch.setenv("GFASORT_CONSENSUS", "gather")
    kw = dict(n_nodes=1500, n_paths=4, steps_per_path=1500, iter_max=4,
              per_octave=2, consensus_every=5, rotate=1, proposals=1,
              active_frac=1.0)
    got = t_bench.sweep_quality_vs_oracle(device="cpu", **kw)
    want = j_bench.sweep_quality_vs_oracle(**kw)
    if got is None or want is None:
        pytest.skip("the C++ oracle cannot be built here")
    assert (got["n_nodes"], got["iter_max"]) == (1500, 4)
    assert got["rank_mae_frac"] == pytest.approx(want["rank_mae_frac"],
                                                 abs=1e-4)
    assert got["spearman"] == pytest.approx(want["spearman"], abs=1e-6)
