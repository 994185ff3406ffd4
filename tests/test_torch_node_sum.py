"""Port parity: the node consensus against both JAX forms (gather-sum
and grid)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from gfasort_tpu.bench_util import synthetic_path_index  # noqa: E402
from gfasort_tpu.ops.grid_consensus import build_grid_consensus  # noqa: E402
from gfasort_tpu.ops.node_sum import build_gather_consensus as jax_gather  # noqa: E402
from gfasort_tpu_torch.ops.node_sum import (JAX_ROW_RUN,  # noqa: E402
                                            build_gather_consensus)


def _step_map(rng, n_nodes, S, hub_degree):
    """Steps over nodes [0, n_nodes) with some nodes never visited and
    one hub node above the JAX gather form's 128-step class cap."""
    step_node = rng.integers(0, n_nodes - 10, S)   # the last 10 have no steps
    step_node[rng.choice(S, hub_degree, replace=False)] = 3
    return step_node


def test_consensus_matches_jax_gather():
    rng = np.random.default_rng(0)
    N, S = 3000, 12_000
    step_node = _step_map(rng, N, S, hub_degree=300)
    xs = (rng.random(S) * 1e5).astype(np.float32)
    x_init = (rng.random(N) * 1e5).astype(np.float32)

    gj = jax_gather(step_node, N, np.float32)
    xs_j, xn_j = gj.fn(jnp.asarray(xs), *gj.arrays)
    node_j = np.asarray(gj.to_node_order(xn_j, jnp.asarray(x_init), *gj.arrays))

    gt = build_gather_consensus(step_node, N, "cpu")
    xs_t, xn_t = gt(torch.from_numpy(xs))
    node_t = gt.to_node_order(xn_t, torch.from_numpy(x_init)).numpy()

    assert gt.inv_cnt.shape[0] == gj.n_sorted   # one slot per live node
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-6)
    np.testing.assert_allclose(node_t, node_j, rtol=1e-6)
    # nodes with no steps keep their initial positions exactly
    np.testing.assert_array_equal(node_t[-10:], x_init[-10:])
    # every step holds its node's mean
    np.testing.assert_array_equal(xs_t.numpy(), node_t[step_node])


@pytest.mark.parametrize("rows", [1, 4])
def test_consensus_sums_in_the_jax_order(rows):
    """Bit for bit against both JAX engines' consensus on the CPU: with
    ``run=JAX_ROW_RUN`` the 1D engine's gather form (XLA's row reduction
    adds runs of 32 terms; nodes above 128 steps are scattered), in one
    run the nD engine's scatter-add.  Degrees reach past 32 and 128."""
    rng = np.random.default_rng(3)
    N, S = 3000, 12_000
    step_node = _step_map(rng, N, S, hub_degree=300)
    step_node[rng.choice(np.flatnonzero(step_node != 3), 60,
                         replace=False)] = 7
    cs = (rng.standard_normal((rows, S)) * 1e4).astype(np.float32)
    cnt = np.bincount(step_node, minlength=N)
    assert cnt.max() > 128 and ((cnt > 32) & (cnt <= 128)).any()

    gj = jax_gather(step_node, N, np.float32)
    g1 = build_gather_consensus(step_node, N, "cpu", run=JAX_ROW_RUN)
    for r in range(rows):
        xs_j, _ = gj.fn(jnp.asarray(cs[r]), *gj.arrays)
        xs_t, _ = g1(torch.from_numpy(cs[r]))
        np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_j))

    inv_cnt = jnp.asarray((1.0 / np.maximum(cnt, 1)).astype(np.float32))
    node_j = np.stack([np.asarray(
        jnp.zeros((N,), jnp.float32).at[step_node].add(cs[r]) * inv_cnt)
        for r in range(rows)])
    gs = build_gather_consensus(step_node, N, "cpu")
    _, xn_t = gs(torch.from_numpy(cs))
    node_t = gs.to_node_order(xn_t, torch.zeros(rows, N)).numpy()
    has = cnt > 0
    np.testing.assert_array_equal(node_t[:, has], node_j[:, has])


def test_consensus_matches_jax_grid():
    pidx = synthetic_path_index(20_000, 4, 20_000, seed=5)
    N, S = pidx.num_nodes, pidx.total_steps
    rng = np.random.default_rng(1)
    xs = (pidx.initial_positions()[pidx.step_node_idx]
          + rng.standard_normal(S) * 50).astype(np.float32)

    gx = build_grid_consensus(pidx.step_node_idx, N,
                              path_of_step=pidx.step_path, dtype=np.float32)
    xs_j, xn_j = gx.fn(jnp.asarray(xs), *gx.arrays)

    gt = build_gather_consensus(pidx.step_node_idx, N, "cpu")
    xs_t, xn_t = gt(torch.from_numpy(xs))
    node_t = gt.to_node_order(xn_t, torch.zeros(N)).numpy()
    has = np.bincount(pidx.step_node_idx, minlength=N) > 0
    # the grid's one-hot dots agree with an exact mean to ~1.5e-7 relerr
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-5)
    np.testing.assert_allclose(node_t[has], np.asarray(xn_j)[has], rtol=1e-5)


def test_consensus_is_deterministic():
    rng = np.random.default_rng(2)
    step_node = _step_map(rng, 500, 5000, hub_degree=700)
    gt = build_gather_consensus(step_node, 500, "cpu")
    xs = torch.from_numpy((rng.random(5000) * 1e4).astype(np.float32))
    a, b = gt(xs), gt(xs)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # power-of-two classes up to the largest degree, no scatter
    widths = [ix.shape[1] for ix in gt.class_idx]
    assert widths == sorted(widths) and widths[-1] >= 700
    assert all(w & (w - 1) == 0 for w in widths)


@pytest.mark.parametrize("rows", [4, 6])
def test_multi_row_consensus_matches_rows_and_jax_scatter(rows):
    """The layout engine's [R, S] call (R = 2D rows): each row as the 1D
    call computes it, and within f32 reassociation of the JAX nD
    runner's scatter-add consensus (gfasort_tpu/ops/sweep_nd.py)."""
    rng = np.random.default_rng(rows)
    N, S = 2000, 9000
    step_node = _step_map(rng, N, S, hub_degree=200)
    cs = (rng.standard_normal((rows, S)) * 1e4).astype(np.float32)
    init = (rng.standard_normal((rows, N)) * 1e4).astype(np.float32)

    gt = build_gather_consensus(step_node, N, "cpu")
    cs_t, xn_t = gt(torch.from_numpy(cs))
    node_t = gt.to_node_order(xn_t, torch.from_numpy(init)).numpy()
    assert cs_t.shape == (rows, S) and node_t.shape == (rows, N)
    for r in range(rows):
        xs_r, xn_r = gt(torch.from_numpy(cs[r]))
        assert torch.equal(cs_t[r], xs_r) and torch.equal(xn_t[r], xn_r)

    cnt = np.bincount(step_node, minlength=N)
    inv_cnt = jnp.asarray((1.0 / np.maximum(cnt, 1)).astype(np.float32))
    node_j = np.stack([np.asarray(
        jnp.zeros((N,), jnp.float32).at[step_node].add(cs[r]) * inv_cnt)
        for r in range(rows)])
    has = cnt > 0
    np.testing.assert_allclose(node_t[:, has], node_j[:, has], rtol=1e-5,
                               atol=1e-2)
    np.testing.assert_array_equal(node_t[:, ~has], init[:, ~has])
    np.testing.assert_array_equal(cs_t.numpy(), node_t[:, step_node])
