"""Port parity of the sharded 1D sweep engine (``parallel/``): the mesh's
host integers against the JAX package's for 1, 2, 4 and 8 shards, and
whole runs on a CPU mesh against the JAX ``build_sharded_sweep`` run op
by op (``test_torch_spmd.spmd_shard_map``), bit for bit."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from gfasort_tpu.bench_util import synthetic_path_index  # noqa: E402
from gfasort_tpu.index import PathIndex  # noqa: E402
from gfasort_tpu.io import gfa as jax_gfa  # noqa: E402
from gfasort_tpu.ops import sweep_common as jax_sweep_common  # noqa: E402
from gfasort_tpu.ops.sweep import offset_set  # noqa: E402
from gfasort_tpu.ops.sweep_dense import (dense_kernel_enabled,  # noqa: E402
                                         kernel_kmax)
from gfasort_tpu.parallel import ShardedIndex, default_mesh, mesh as jax_mesh  # noqa: E402
from gfasort_tpu.parallel import sweep_shard as jax_shard  # noqa: E402
from gfasort_tpu.params import PathSGDParams  # noqa: E402
from gfasort_tpu_torch.index import PathIndex as PortIndex  # noqa: E402
from gfasort_tpu_torch.io import gfa as port_gfa  # noqa: E402
from gfasort_tpu_torch.ops.keys import key_data  # noqa: E402
from gfasort_tpu_torch.ops.sweep_plan import make_sharded_sweep_plan  # noqa: E402
from gfasort_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from gfasort_tpu_torch.parallel import sgd_shard as port_sgd_shard  # noqa: E402
from gfasort_tpu_torch.parallel import sweep_shard as port_shard  # noqa: E402
from gfasort_tpu_torch.params import PathSGDParams as PortParams  # noqa: E402
from test_torch_spmd import gfa_text, spmd_shard_map  # noqa: E402

SHARDS = (1, 2, 4, 8)
# small knobs: 9 offsets in 2 phases, P = 4; with KMAX 16 the kernel
# serves the offsets up to 16 and roll passes the rest
KW = dict(per_octave=1, dense_upto=2, rotate=2, consensus_every=2, proposals=4)


def _pair(text):
    return (PathIndex.from_graph(jax_gfa.parse_gfa_numeric(text)),
            PortIndex.from_graph(port_gfa.parse_gfa_numeric(text)))


def _params(pidx, cls, iter_max):
    return replace(cls().derive_from_graph(pidx), dtype="float32",
                   pow_mode="fast", iter_max=iter_max)


@pytest.fixture(scope="module")
def graphs():
    from gfasort_tpu_torch.bench_util import synthetic_path_index as port_synth

    return {"small": _pair(gfa_text()),
            # S = 300,000 >= 2^18: the large regime
            "large": (synthetic_path_index(80_000, 6, 50_000, seed=2),
                      port_synth(80_000, 6, 50_000, seed=2))}


@pytest.mark.parametrize("k", SHARDS)
def test_partition_and_shard_arrays_equal_jax(graphs, k):
    """``partition_paths`` (unstable argsort on ties included),
    ``_shard_arrays`` and ``ShardedIndex.build``, on the test graph and
    on a large-regime index."""
    counts = [5, 3, 5, 1, 3, 5, 2]
    assert port_mesh.partition_paths(counts, k) == jax_mesh.partition_paths(counts, k)
    for a, b in graphs.values():
        assert (port_mesh.partition_paths(b.path_count.tolist(), k)
                == jax_mesh.partition_paths(a.path_count.tolist(), k))
        for x, y in zip(port_shard._shard_arrays(b, k, np.float32),
                        jax_shard._shard_arrays(a, k, np.float32)):
            np.testing.assert_array_equal(x, y)
        si_t = port_sgd_shard.ShardedIndex.build(b, k)
        si_j = ShardedIndex.build(a, k)
        for f in ("step_rank", "step_pos", "step_node", "step_first",
                  "step_count", "num_nodes", "shard_len"):
            np.testing.assert_array_equal(getattr(si_t, f), getattr(si_j, f))


def test_shard_consensus_every_equals_jax():
    for S in (1000, 1 << 18, 4_000_000):
        for L in (1, 5000, 10_417, 250_000, 4_000_000):
            for base in (1, 8, 12):
                assert (port_shard.shard_consensus_every(L, base, S)
                        == jax_shard.shard_consensus_every(L, base, S))
    assert (port_shard.PSUM_AMORT_STEPS, port_shard.CE_CAP) == (
        jax_shard.PSUM_AMORT_STEPS, jax_shard.CE_CAP)


def _jax_exec(n_sweeps, ce, L, budget):
    """The JAX sharded engine's executed sweeps
    (``sweep_shard.py``: ``n_dispatch x chunk_periods x ce`` at L)."""
    n_periods = -(-n_sweeps // ce)
    chunk = max(1, min(n_periods, budget // max(L * ce, 1)))
    return -(-n_periods // chunk) * chunk * ce


@pytest.mark.parametrize("kmode", ["pallas", "xla"])
@pytest.mark.parametrize("regime", ["small", "large"])
@pytest.mark.parametrize("k", SHARDS)
def test_sharded_plan_equals_jax(graphs, monkeypatch, k, regime, kmode):
    """ce (raised by shard length in the large regime), n_sweeps, P, the
    executed-sweep count at L steps per sweep, and the kernel gate over
    the whole offset set; plans only, no run."""
    monkeypatch.setenv("GFASORT_CONSENSUS", "gather")
    monkeypatch.setenv("GFASORT_DENSE_KERNEL", kmode)
    pj, pt = graphs[regime]
    p = _params(pj, PathSGDParams, 100 if regime == "large" else 4)
    _, _, _, info = jax_shard.build_sharded_sweep(pj, p, default_mesh(k))
    L = info["shard_len"]
    plan = make_sharded_sweep_plan(pt, _params(pt, PortParams, p.iter_max), L)
    got = {"n_sweeps": plan.n_sweeps,
           "updates_per_sweep": plan.updates_per_sweep,
           "proposals": plan.proposals, "active_frac": plan.active_frac,
           "n_offsets": len(plan.offs), "shard_len": L,
           "rotate": plan.rotate, "consensus_every": plan.consensus_every,
           "grid_consensus": False, "grid_coverage": None}
    assert got == info
    assert plan.n_exec == _jax_exec(plan.n_sweeps, plan.consensus_every, L,
                                    int(5e8))
    if regime == "large":
        assert plan.proposals == 12 and plan.consensus_every >= 12
    auto = jax_sweep_common.auto_sweep_config(pj.total_steps, pj.num_nodes)
    offs = offset_set(max(1, min(int(p.space), pj.max_path_step_count - 1)),
                      auto["per_octave"], auto.get("dense_upto", 8))
    np.testing.assert_array_equal(plan.offs, offs)
    gate = dense_kernel_enabled(np.float32, L, int((offs <= 8).sum()))
    assert plan.dense_kernel == gate
    for ph in plan.phases:
        want = [(int(o), ki) for ki, o in enumerate(ph.offs.tolist())
                if gate and o <= kernel_kmax()]
        assert list(ph.kernel_buckets) == want


def test_port_mesh_defaults():
    """A CPU mesh repeats its device; shard g of a one-process mesh is
    its g-th device; the all-reduce adds shards in order from shard 0's
    own array (a lone -0 stays -0)."""
    m = port_mesh.default_mesh(3, "cpu")
    assert m.size == 3 and list(m.shards) == [0, 1, 2] and m.world == 1
    assert all(d.type == "cpu" for d in m.devices)
    assert port_mesh.default_mesh(device="cpu").size == 1
    a = [torch.tensor([1e8, -0.0]), torch.tensor([1.0, -0.0]),
         torch.tensor([-1e8, -0.0])]
    out = m.all_reduce(a)
    assert len(out) == 3 and all(torch.equal(o, (a[0] + a[1]) + a[2])
                                 for o in out)
    assert torch.signbit(out[0][1]).item()
    assert port_mesh.is_distributed() is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_mesh.default_mesh()


def _count_sweeps(monkeypatch):
    """Counts the JAX engine's ``sweep_rng`` calls (P per sweep and
    shard)."""
    calls = []
    real = jax_sweep_common.sweep_rng

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jax_sweep_common, "sweep_rng", counting)
    return calls


def _jax_sharded(pj, p, k, monkeypatch):
    calls = _count_sweeps(monkeypatch)
    run, arrays, make_state, info = jax_shard.build_sharded_sweep(
        pj, p, default_mesh(k), expose_parts=True, **KW)
    xs0, xn0 = make_state()
    x = np.asarray(run(xs0, xn0, jax.random.key(p.seed), *arrays))
    n_run = len(calls)
    parts = info["parts"]["sweeps_fn"](xs0, jax.random.key(p.seed), *arrays)
    return x, np.asarray(parts), n_run // (k * KW["proposals"]), info


def _port_sharded(pt, p, k):
    run, arrays, make_state, info = port_shard.build_sharded_sweep(
        pt, p, port_mesh.default_mesh(k, "cpu"), expose_parts=True, **KW)
    xs0, xn0 = make_state()
    x = run(xs0, xn0, key_data(p.seed), *arrays)
    xs0, _ = make_state()
    parts = info["parts"]["sweeps_fn"](xs0, key_data(p.seed), *arrays)
    plan = make_sharded_sweep_plan(pt, p, info["shard_len"], **KW)
    return x.numpy(), np.stack([t.numpy() for t in parts]), plan, info


@pytest.fixture(scope="module", params=["pallas", "xla"])
def runs(request, graphs):
    """Both engines on k shards for each k: 5 sweeps in periods of 2 at
    iter_max 4, and a dispatch budget of two periods at L = 240 steps, so
    that 8 sweeps run on 2, 4 and 8 shards and 6 on one."""
    mp = pytest.MonkeyPatch()
    mp.setenv("GFASORT_CONSENSUS", "gather")
    mp.setenv("GFASORT_DENSE_KERNEL", request.param)
    mp.setenv("GFASORT_KERNEL_KMAX", "16")
    mp.setenv("GFASORT_SWEEP_DISPATCH_ELEMS", str(2 * 240 * 2))
    pj, pt = graphs["small"]
    out = {}
    try:
        with spmd_shard_map(mp):
            for k in SHARDS:
                out[k] = (_jax_sharded(pj, _params(pj, PathSGDParams, 4), k, mp),
                          _port_sharded(pt, _params(pt, PortParams, 4), k))
        yield request.param, out
    finally:
        mp.undo()


@pytest.mark.parametrize("k", SHARDS)
def test_sharded_sweep_equals_jax(runs, k):
    """The whole run, and the consensus-free first period
    (``sweeps_fn``), bit for bit; the info dicts equal, and the JAX run
    executed the plan's sweep count."""
    kmode, out = runs
    (x_j, parts_j, n_exec_j, info_j), (x_t, parts_t, plan, info_t) = out[k]
    assert {a: b for a, b in info_t.items() if a != "parts"} == {
        a: b for a, b in info_j.items() if a != "parts"}
    assert plan.n_exec == n_exec_j == (6 if k == 1 else 8)
    assert plan.dense_kernel == (kmode == "pallas")
    assert x_t.dtype == np.float32 and np.isfinite(x_t).all()
    np.testing.assert_array_equal(parts_t, parts_j)
    np.testing.assert_array_equal(x_t, x_j)


def test_shard_counts_move_the_result(runs):
    """The runs on different shard counts differ (each shard draws its
    own keys), so the equalities above are not one run compared k
    times."""
    _, out = runs
    xs = [out[k][1][0] for k in SHARDS]
    assert not np.array_equal(xs[0], xs[1])
    assert not np.array_equal(xs[1], xs[2])
