"""Port parity of the sharded nD layout engine
(``parallel/sweep_nd_shard.py``): the plan's integers against the JAX
``build_sharded_sweep_nd`` for 1, 2, 4 and 8 shards (3D at P = 8: the
sharded engine has no proposal clamp), the rev and length rows, and
whole 2D and 3D runs on a CPU mesh against the JAX engine run op by op
(``test_torch_spmd.spmd_shard_map``), with the nD kernel
(``GFASORT_DENSE_KERNEL=pallas``) and with roll passes only (``xla``).

The port computes the JAX ``rsqrt`` as ``1 / sqrt``; XLA:CPU's own
``rsqrt`` differs from it by up to 2 ulp (``test_torch_sweep_nd.py``).
With the JAX ``rsqrt`` read as ``1 / sqrt`` the runs are equal bit for
bit; with XLA's own, within the single-card nD bound (rtol 1e-4,
atol 0.2)."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gfasort_tpu.bench_util import synthetic_path_index  # noqa: E402
from gfasort_tpu.index import PathIndex  # noqa: E402
from gfasort_tpu.io import gfa as jax_gfa  # noqa: E402
from gfasort_tpu.ops.exact import layout_initial_coords  # noqa: E402
from gfasort_tpu.ops.sweep import offset_set  # noqa: E402
from gfasort_tpu.ops.sweep_common import auto_sweep_config  # noqa: E402
from gfasort_tpu.parallel import default_mesh  # noqa: E402
from gfasort_tpu.parallel import sweep_nd_shard as jax_nd  # noqa: E402
from gfasort_tpu.params import LayoutSGDParams  # noqa: E402
from gfasort_tpu_torch.bench_util import (  # noqa: E402
    synthetic_path_index as port_synth)
from gfasort_tpu_torch.index import PathIndex as PortIndex  # noqa: E402
from gfasort_tpu_torch.io import gfa as port_gfa  # noqa: E402
from gfasort_tpu_torch.ops.keys import key_data  # noqa: E402
from gfasort_tpu_torch.ops.sweep_plan import (make_layout_plan,  # noqa: E402
                                              make_sharded_layout_plan)
from gfasort_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from gfasort_tpu_torch.parallel import sweep_nd_shard as port_nd  # noqa: E402
from gfasort_tpu_torch.params import LayoutSGDParams as PortLayout  # noqa: E402
from test_torch_spmd import gfa_text, spmd_shard_map  # noqa: E402

SHARDS = (1, 2, 4, 8)
# 9 offsets in 2 phases, P = 8 (2 choice words); with KMAX 16 the nD
# kernel serves the offsets up to 16 and roll passes the rest
KW = dict(per_octave=1, dense_upto=2, rotate=2, consensus_every=2, proposals=8)


def _lp(pidx, cls, dims, iter_max):
    return replace(cls().derive_from_graph(pidx, dims), dtype="float32",
                   pow_mode="fast", iter_max=iter_max)


@pytest.fixture(scope="module")
def large():
    # S = 300,000 >= 2^18: the large regime, P = 8
    return (synthetic_path_index(80_000, 6, 50_000, seed=2),
            port_synth(80_000, 6, 50_000, seed=2))


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("k", SHARDS)
def test_sharded_layout_plan_equals_jax(large, monkeypatch, k, dims):
    """ce, n_sweeps, P (8 in 3D, where the single-card plan clamps to
    4), the executed sweeps at L steps per sweep and half the budget,
    and the kernel gate per phase; plans only, no run."""
    monkeypatch.setenv("GFASORT_CONSENSUS", "gather")
    monkeypatch.setenv("GFASORT_DENSE_KERNEL", "pallas")
    pj, pt = large
    lp = _lp(pj, LayoutSGDParams, dims, 30)
    _, _, _, info = jax_nd.build_sharded_sweep_nd(pj, lp, default_mesh(k))
    L = info["shard_len"]
    lt = _lp(pt, PortLayout, dims, 30)
    plan = make_sharded_layout_plan(pt, lt, L)
    assert {"n_sweeps": plan.n_sweeps,
            "updates_per_sweep": plan.updates_per_sweep,
            "proposals": plan.proposals, "active_frac": plan.active_frac,
            "n_offsets": len(plan.offs), "shard_len": L,
            "rotate": plan.rotate, "consensus_every": plan.consensus_every,
            "grid_consensus": False} == info
    assert plan.proposals == 8
    assert make_layout_plan(pt, lt).proposals == (8 if dims == 2 else 4)
    ce = plan.consensus_every
    n_periods = -(-plan.n_sweeps // ce)
    chunk = max(1, min(n_periods, int(5e8) // 2 // (L * ce)))
    assert plan.n_exec == -(-n_periods // chunk) * chunk * ce
    auto = auto_sweep_config(pj.total_steps, pj.num_nodes, layout=True)
    offs = offset_set(max(1, min(int(lp.space), pj.max_path_step_count - 1)),
                      auto["per_octave"], auto.get("dense_upto", 8))
    np.testing.assert_array_equal(plan.offs, offs)
    for ph in plan.phases:
        served = int((ph.offs <= 8).sum()) >= 2
        assert [ki for _, ki in ph.kernel_buckets] == [
            ki for ki, o in enumerate(ph.offs.tolist())
            if served and o <= 1024]


def _pair():
    text = gfa_text(seed=1)
    return (PathIndex.from_graph(jax_gfa.parse_gfa_numeric(text)),
            PortIndex.from_graph(port_gfa.parse_gfa_numeric(text)))


def _jax_layout(pj, lp, k, init):
    run, arrays, make_state, info = jax_nd.build_sharded_sweep_nd(
        pj, lp, default_mesh(k), **KW)
    cs0, cn0 = make_state(init)
    return np.asarray(run(cs0, cn0, jax.random.key(lp.seed), *arrays)), info, arrays


def _port_layout(pt, lp, k, init):
    run, arrays, make_state, info = port_nd.build_sharded_sweep_nd(
        pt, lp, port_mesh.default_mesh(k, "cpu"), **KW)
    cs0, cn0 = make_state(init)
    return run(cs0, cn0, key_data(lp.seed), *arrays).numpy(), info, arrays


@pytest.fixture(scope="module", params=[(2, "pallas"), (3, "pallas"),
                                        (2, "xla"), (3, "xla")],
                ids=lambda p: f"{p[0]}d-{p[1]}")
def runs(request):
    """Both engines at D dimensions on k shards for each k (6 sweeps in
    periods of 2), with the kernel (``pallas``, KMAX 16: the kernel serves
    offsets up to 16, roll passes the rest) or roll passes only (``xla``);
    the JAX ``rsqrt`` read as ``1 / sqrt``; on 2 shards also with XLA's
    own ``rsqrt``.  One module, so JAX compiles the ops both modes share
    once."""
    dims, mode = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("GFASORT_CONSENSUS", "gather")
    mp.setenv("GFASORT_DENSE_KERNEL", mode)
    mp.setenv("GFASORT_KERNEL_KMAX", "16")
    pj, pt = _pair()
    lj, lt = _lp(pj, LayoutSGDParams, dims, 2), _lp(pt, PortLayout, dims, 2)
    init = layout_initial_coords(pj, dims, lj.seed)
    out = {"dims": dims, "mode": mode}
    try:
        with spmd_shard_map(mp):
            out["xla_rsqrt"] = _jax_layout(pj, lj, 2, init)[0]
            mp.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
            for k in SHARDS:
                out[k] = (_jax_layout(pj, lj, k, init),
                          _port_layout(pt, lt, k, init))
        yield out
    finally:
        mp.undo()


@pytest.mark.parametrize("k", SHARDS)
def test_sharded_layout_equals_jax(runs, k):
    (x_j, info_j, arr_j), (x_t, info_t, arr_t) = runs[k]
    assert info_t == info_j
    assert info_t["proposals"] == 8
    # the rev and length rows of the shards
    for a_j, a_t in zip(np.asarray(arr_j[3]), arr_t[3]):
        np.testing.assert_array_equal(a_t.numpy(), a_j)
    for a_j, a_t in zip(np.asarray(arr_j[4]), arr_t[4]):
        np.testing.assert_array_equal(a_t.numpy(), a_j)
    assert x_t.shape == (2 * runs["dims"], 160) and np.isfinite(x_t).all()
    np.testing.assert_array_equal(x_t, x_j)


def test_sharded_layout_with_xla_rsqrt_within_bound(runs):
    (x_t, _, _) = runs[2][1]
    np.testing.assert_allclose(x_t, runs["xla_rsqrt"], rtol=1e-4, atol=0.2)
