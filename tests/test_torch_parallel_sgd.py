"""Port parity of the sharded batched engine (``parallel/sgd_shard.py``):
whole runs on a CPU mesh of 1, 2 and 4 shards against the JAX
``path_linear_sgd_sharded`` run op by op
(``test_torch_spmd.spmd_shard_map``), at f64 and at f32, both with
``pow_mode="fpp"`` (no transcendental function in the draws), bit for
bit."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gfasort_tpu.index import PathIndex  # noqa: E402
from gfasort_tpu.io import gfa as jax_gfa  # noqa: E402
from gfasort_tpu.parallel import default_mesh  # noqa: E402
from gfasort_tpu.parallel import sgd_shard as jax_sgd  # noqa: E402
from gfasort_tpu.params import PathSGDParams  # noqa: E402
from gfasort_tpu_torch.index import PathIndex as PortIndex  # noqa: E402
from gfasort_tpu_torch.io import gfa as port_gfa  # noqa: E402
from gfasort_tpu_torch.ops.sgd import build_schedule  # noqa: E402
from gfasort_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from gfasort_tpu_torch.parallel import sgd_shard as port_sgd  # noqa: E402
from gfasort_tpu_torch.params import PathSGDParams as PortParams  # noqa: E402
from test_torch_spmd import gfa_text, spmd_shard_map  # noqa: E402

SHARDS = (1, 2, 4)


def _params(pidx, cls, dtype):
    # B = 150 of 480 terms per iteration; iterations 0-2 warm, 3 cooling
    return replace(cls().derive_from_graph(pidx), dtype=dtype,
                   pow_mode="fpp", iter_max=3, batch=150)


@pytest.fixture(scope="module", params=["float64", "float32"])
def runs(request):
    text = gfa_text(seed=2)
    pj = PathIndex.from_graph(jax_gfa.parse_gfa_numeric(text))
    pt = PortIndex.from_graph(port_gfa.parse_gfa_numeric(text))
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        with spmd_shard_map(mp):
            for k in SHARDS:
                out[k] = (
                    jax_sgd.path_linear_sgd_sharded(
                        None, _params(pj, PathSGDParams, request.param),
                        default_mesh(k), pj),
                    port_sgd.path_linear_sgd_sharded(
                        None, _params(pt, PortParams, request.param),
                        port_mesh.default_mesh(k, "cpu"), pt))
        yield request.param, pt, out
    finally:
        mp.undo()


@pytest.mark.parametrize("k", SHARDS)
def test_sharded_batched_equals_jax(runs, k):
    dtype, pt, out = runs
    x_j, x_t = out[k]
    assert x_t.shape == (pt.num_nodes,) and np.isfinite(x_t).all()
    np.testing.assert_array_equal(x_t, x_j)


def test_sharded_batched_schedule(runs):
    """B_local = ceil(B / k) slots per shard and round; the schedule is
    built for B_local x k terms per round, so 3 shards round 150 up to
    153 (4 rounds per iteration either way), and the runs on different
    shard counts differ."""
    _, pt, out = runs
    p = _params(pt, PortParams, "float64")
    for k in SHARDS + (3,):
        b_local = -(-150 // k)
        assert build_schedule(p, b_local * k)[2:] == (4, 16)
    assert not np.array_equal(out[1][1], out[2][1])
    assert not np.array_equal(out[2][1], out[4][1])


def test_sharded_index_pads_are_one_step_paths():
    """A shard's pad slots form one extra path of one step at slot 0 in
    the sampler's index: never a valid term."""
    pt = PortIndex.from_graph(port_gfa.parse_gfa_numeric(gfa_text()))
    si = port_sgd.ShardedIndex.build(pt, 4)
    for g in range(4):
        di = si.device_index(g, "cpu")
        live = si.step_node[g] >= 0
        path = di.step_path.numpy()
        assert (path[~live] == len(di.path_count) - 1).all()
        assert di.path_count[-1].item() == 1 and di.path_first[-1].item() == 0
        np.testing.assert_array_equal(
            di.path_first.numpy()[path[live]], si.step_first[g][live])
        np.testing.assert_array_equal(
            di.path_count.numpy()[path[live]], si.step_count[g][live])
