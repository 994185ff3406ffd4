"""The port on an NVIDIA GPU: the hand-written kernels (the 1D and nD
bucket apply, the fused sweep apply, the two shift sums) against their
plain versions, and the sweep engines on CUDA against the same code on
the CPU.  Every test needs a GPU (the CUDA
kernels have no CPU mode) and skips without one.  The file imports
neither JAX nor the JAX package, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gfasort_tpu_torch.bench_util import (rank_quality,  # noqa: E402
                                          synthetic_path_index)
from gfasort_tpu_torch.ops import sweep_common as sc  # noqa: E402
from gfasort_tpu_torch.ops.keys import fold_in, key_data  # noqa: E402
from gfasort_tpu_torch.ops.node_sum import build_gather_consensus  # noqa: E402
from gfasort_tpu_torch.ops.sweep import path_linear_sgd_sweep  # noqa: E402
from gfasort_tpu_torch.ops.sweep_dense import (bucket_apply,  # noqa: E402
                                               bucket_apply_ref,
                                               dense_apply_nd,
                                               dense_apply_nd_ref)
from gfasort_tpu_torch.ops.sweep_nd import (  # noqa: E402
    path_linear_sgd_layout_sweep)
from gfasort_tpu_torch.ops.exact import calculate_layout_stress_pidx  # noqa: E402
from gfasort_tpu_torch.ops import sweep_fused as sf  # noqa: E402
from gfasort_tpu_torch.ops.shift_sum import (VARIANTS, shift_sum,  # noqa: E402
                                             shift_sum_ref)
from gfasort_tpu_torch.tools import dense_probe  # noqa: E402
from gfasort_tpu_torch.ops.sweep_plan import make_sweep_plan  # noqa: E402
from gfasort_tpu_torch.params import LayoutSGDParams, PathSGDParams  # noqa: E402

pytestmark = pytest.mark.cuda

# the TPU kernel test's precedent (tests/test_sweep_dense.py)
DSUM_RTOL, DSUM_ATOL = 2e-5, 1e-4

PHASE = [(1, 0), (2, 1), (3, 2), (4, 3), (6, 4), (8, 5), (181, 9), (1024, 11)]
# steps per block (kTile) of csrc/bucket_apply.cu and csrc/dense_apply_nd.cu
TILE, TILE_ND = 1024, 512
CASES = {
    "dense": (7000, [(k, k - 1) for k in range(1, 9)], 1),
    "mid": (70_000, [(1, 0), (5, 4), (181, 9), (1449, 11), (8192, 13)], 1),
    "p4": (70_001, PHASE, 4),
    "p12": (30_000, PHASE, 12),
    "offset_past_end": (300, [(1, 0), (512, 1)], 12),
    # one step short of a tile, one tile, one step into the next
    "tile_m1": (TILE - 1, PHASE, 12),
    "tile": (TILE, PHASE, 12),
    "tile_p1": (TILE + 1, PHASE, 12),
    # a bucket past the tile: every -k pair evaluated by its own step
    "p12_k8192": (30_000, PHASE + [(8192, 13)], 12),
    # P = 5: three unused fields of the last word are 0, which is ki = 0
    "p5_ki0": (5000, PHASE, 5),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(case, seed=7):
    return _contract_inputs(*CASES[case], seed)


def _contract_inputs(S, buckets, P, seed):
    """Random inputs under the sampler contract: no choice crosses the
    array ends; INACTIVE and foreign bucket indices mixed in."""
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy((rng.standard_normal(S) * 10).astype(np.float32))
    pos = torch.from_numpy(np.cumsum(rng.integers(0, 4, S)).astype(np.float32))
    kis = [ki for _, ki in buckets]
    pool = np.array(kis + [~ki for ki in kis] + [int(sc.INACTIVE), 3, ~2],
                    np.int32)
    iota = np.arange(S)
    sidxs = []
    for _ in range(P):
        s = pool[rng.integers(0, len(pool), S)]
        for k, ki in buckets:
            s = np.where((s == ki) & (iota + k >= S), sc.INACTIVE, s)
            s = np.where((s == ~ki) & (iota - k < 0), sc.INACTIVE, s)
        sidxs.append(torch.from_numpy(s.astype(np.int32)))
    words = sidxs if P == 1 else sc.pack_choices_words(sidxs)
    return xs, pos, words, 0.9, buckets, P


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(cuda, case):
    xs, pos, words, eta, buckets, P = _inputs(case)
    xs, pos, words = xs.to(cuda), pos.to(cuda), [w.to(cuda) for w in words]
    before = bucket_apply.launches
    dk, ck = bucket_apply(xs, pos, words, eta, buckets, P)
    dr, cr = bucket_apply_ref(xs, pos, words, eta, buckets, P)
    torch.cuda.synchronize()
    assert bucket_apply.launches == before + 1
    assert dk.device.type == "cuda" and dk.dtype == torch.float32
    assert torch.equal(ck, cr)
    assert torch.equal(dk, dr)


def test_kernel_matches_cpu_plain_version(cuda):
    """The kernel on the card against the plain version on the CPU."""
    xs, pos, words, eta, buckets, P = _inputs("p12", seed=3)
    dk, ck = bucket_apply(xs.to(cuda), pos.to(cuda),
                          [w.to(cuda) for w in words], eta, buckets, P)
    dr, cr = bucket_apply(xs, pos, words, eta, buckets, P)
    assert torch.equal(ck.cpu(), cr)
    torch.testing.assert_close(dk.cpu(), dr, rtol=DSUM_RTOL, atol=DSUM_ATOL)


def test_sampler_on_cuda_matches_cpu(cuda):
    """CUDA's f32 exp/log may round differently from the CPU's; a choice
    may then differ only by a neighbouring bucket of the same sign."""
    pidx = synthetic_path_index(20_000, 4, 20_000, seed=11)
    p = replace(PathSGDParams().derive_from_graph(pidx), dtype="float32")
    plan = make_sweep_plan(pidx, p, per_octave=2, dense_upto=4, rotate=4,
                           proposals=12, active_frac=1.0)
    S = pidx.total_steps
    rank = torch.from_numpy(pidx.step_rank.astype(np.int32))
    cnt = torch.from_numpy(pidx.step_count_of_step.astype(np.int32))
    words = fold_in(key_data(7), np.arange(12))
    mism = total = 0
    for phase in plan.phases:
        for cooling in (False, True):
            got = {}
            for dev in ("cpu", cuda):
                bu = [sc.sweep_rng(w, S, dev) for w in words]
                got[str(dev)] = [x.cpu().numpy() for x in sc.sample_blocks(
                    sc.sampler_consts(phase, cooling, dev), bu, cooling,
                    rank.to(dev), cnt.to(dev), 1.0)]
            for a, b in zip(got["cpu"], got[str(cuda)]):
                d = a != b
                total += a.size
                mism += int(d.sum())
                if d.any():
                    assert ((a[d] >= 0) == (b[d] >= 0)).all()
                    ai = np.where(a[d] >= 0, a[d], ~a[d])
                    bi = np.where(b[d] >= 0, b[d], ~b[d])
                    assert (np.abs(ai - bi) == 1).all()
    assert mism <= 1e-4 * total, (mism, total)


def test_consensus_on_cuda_matches_cpu(cuda):
    pidx = synthetic_path_index(20_000, 4, 20_000, seed=5)
    rng = np.random.default_rng(1)
    xs = torch.from_numpy((rng.random(pidx.total_steps) * 1e5).astype(np.float32))
    x_init = torch.zeros(pidx.num_nodes)
    out = {}
    for dev in ("cpu", cuda):
        gc = build_gather_consensus(pidx.step_node_idx, pidx.num_nodes, dev)
        xs_new, xn = gc(xs.to(dev))
        out[str(dev)] = (xs_new.cpu(), gc.to_node_order(xn, x_init.to(dev)).cpu())
    for a, b in zip(out["cpu"], out[str(cuda)]):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=0)


def test_sweep_engine_on_cuda_certifies_against_cpu(cuda):
    pidx = synthetic_path_index(3000, 2, 6000, seed=3)
    p = replace(PathSGDParams().derive_from_graph(pidx), dtype="float32",
                iter_max=10)
    kw = dict(proposals=12, per_octave=2, dense_upto=4, rotate=2,
              consensus_every=4)
    before = bucket_apply.launches
    x_gpu = path_linear_sgd_sweep(None, p, pidx, device=cuda, **kw)
    assert bucket_apply.launches > before
    x_gpu2 = path_linear_sgd_sweep(None, p, pidx, device=cuda, **kw)
    np.testing.assert_array_equal(x_gpu, x_gpu2)   # deterministic on CUDA
    x_cpu = path_linear_sgd_sweep(None, p, pidx, device="cpu", **kw)
    assert np.isfinite(x_gpu).all()
    q = rank_quality(np.argsort(x_gpu, kind="stable"),
                     np.argsort(x_cpu, kind="stable"))
    assert q["rank_mae_frac"] <= 2e-3 and q["spearman"] >= 0.999, q


ND_CASES = {
    "d2_p1_dense": (7000, 2, [(k, k - 1) for k in range(1, 9)], 1),
    "d2_p8_phase": (70_001, 2, PHASE, 8),
    "d3_p4_phase": (30_000, 3, PHASE, 4),
    # the sharded 3D layout's unclamped P = 8 (2 words)
    "d3_p8_phase": (30_000, 3, PHASE, 8),
    "d3_p1_mid": (70_000, 3, [(1, 0), (5, 4), (181, 9), (1449, 11),
                              (8192, 13)], 1),
    "d8_p12_past_end": (300, 8, [(1, 0), (512, 1)], 12),
    "d2_p8_tile_m1": (TILE_ND - 1, 2, PHASE, 8),
    "d2_p8_tile": (TILE_ND, 2, PHASE, 8),
    "d2_p8_tile_p1": (TILE_ND + 1, 2, PHASE, 8),
    "d2_p12_k8192": (30_000, 2, PHASE + [(8192, 13)], 12),
    "d3_p5_ki0": (5000, 3, PHASE, 5),
}


def _nd_inputs(case, seed=5):
    """nD inputs under the sampler contract; coincident coordinates and
    repeated positions hit the zero guards."""
    S, D, buckets, P = ND_CASES[case]
    _, pos, words, eta, _, _ = _contract_inputs(S, buckets, P, seed)
    rng = np.random.default_rng(seed + 1)
    my_c = rng.integers(-3, 4, (D, S)).astype(np.float32)
    my_c[:, ::3] += (rng.standard_normal((D, len(my_c[0, ::3]))) * 50).astype(
        np.float32)
    return pos, words, torch.from_numpy(my_c), eta, buckets, P


@pytest.mark.parametrize("case", sorted(ND_CASES))
def test_nd_kernel_matches_plain_version(cuda, case):
    pos, words, my_c, eta, buckets, P = _nd_inputs(case)
    pos, my_c = pos.to(cuda), my_c.to(cuda)
    words = [w.to(cuda) for w in words]
    before = dense_apply_nd.launches
    acc_k, w_k = dense_apply_nd(pos, words, my_c, eta, buckets, P)
    acc_r, w_r = dense_apply_nd_ref(pos, words, my_c, eta, buckets, P)
    torch.cuda.synchronize()
    assert dense_apply_nd.launches == before + 1
    assert acc_k.shape == my_c.shape and acc_k.device.type == "cuda"
    assert torch.equal(w_k, w_r)
    assert torch.equal(acc_k, acc_r)
    # the card's plain version against the CPU's, same inputs
    acc_c, w_c = dense_apply_nd(pos.cpu(), [w.cpu() for w in words],
                                my_c.cpu(), eta, buckets, P)
    assert torch.equal(w_k.cpu(), w_c)
    torch.testing.assert_close(acc_k.cpu(), acc_c, rtol=DSUM_RTOL,
                               atol=DSUM_ATOL)


def test_nd_kernel_refuses_too_many_dims(cuda):
    pos, words, my_c, eta, buckets, P = _nd_inputs("d2_p1_dense")
    wide = torch.zeros((9, pos.shape[0]), device=cuda)
    with pytest.raises(ValueError, match="at most 8"):
        dense_apply_nd(pos.to(cuda), [w.to(cuda) for w in words], wide, eta,
                       buckets, P)


@pytest.mark.parametrize("dims", [2, 3])
def test_layout_engine_on_cuda_certifies_against_cpu(cuda, dims):
    pidx = synthetic_path_index(3000, 2, 6000, seed=3)
    lp = replace(LayoutSGDParams().derive_from_graph(pidx, dims),
                 dtype="float32", pow_mode="fast", iter_max=5)
    kw = dict(proposals=8, per_octave=3, dense_upto=4, rotate=2,
              consensus_every=4, active_frac=1.0)
    before = dense_apply_nd.launches
    lay_gpu = path_linear_sgd_layout_sweep(None, lp, pidx, device=cuda, **kw)
    assert dense_apply_nd.launches > before
    lay_gpu2 = path_linear_sgd_layout_sweep(None, lp, pidx, device=cuda, **kw)
    np.testing.assert_array_equal(lay_gpu.coords, lay_gpu2.coords)
    lay_cpu = path_linear_sgd_layout_sweep(None, lp, pidx, device="cpu", **kw)
    assert np.isfinite(lay_gpu.coords).all()
    s_gpu = calculate_layout_stress_pidx(pidx, lay_gpu, 3000)
    s_cpu = calculate_layout_stress_pidx(pidx, lay_cpu, 3000)
    assert s_gpu / s_cpu <= 1.5, (s_gpu, s_cpu)


FUSED_CASES = {
    # the JAX kernel test's offsets, two paths
    "k_offs": (3000, [1, 2, 3, 4, 6, 9, 13, 19, 40, 100, 300], 1800, 1024),
    # large offsets, unaligned S, many paths
    "large": (70_001, [1, 2, 3, 5, 181, 1449, 8192, 30_000], 9000, 64 * 1024),
    # the kernel's full offset table
    "k64": (20_000, list(range(1, 65)), 5000, 4096),
    # around the kernel's tile of 256 steps: near and far buckets
    "tile_edges": (5000, [1, 3, 255, 256, 257, 512], 3000, 1024),
}


def _fused_inputs(case, seed=4, guards="path"):
    """Padded inputs on the CPU: paths of ``path_len`` steps (the last
    one shorter), or with ``guards="arbitrary"`` random rank and cnt, so
    that the two guards of a pair disagree; choices of every bucket and
    sign plus INACTIVE, with repeated positions and equal xs hitting both
    zero guards."""
    S, offs, path_len, tile = FUSED_CASES[case]
    rng = np.random.default_rng(seed)
    apply_fn, lay = sf.build_sweep_apply(offs, S, tile=tile)
    if guards == "path":
        rank = (np.arange(S) % path_len).astype(np.int32)
        cnt = np.minimum(path_len, S - (np.arange(S) // path_len) * path_len)
    else:
        rank = rng.integers(0, 2 * max(offs), S).astype(np.int32)
        cnt = rng.integers(0, 3 * max(offs), S)
    xs = (rng.standard_normal(S) * 100).astype(np.float32)
    xs[5::7] = xs[6::7][:len(xs[5::7])]
    pos = np.cumsum(rng.integers(0, 4, S)).astype(np.float32)
    K = len(offs)
    choice = rng.integers(-K, K + 2, size=S)
    sidx = np.where(choice >= K, int(sc.INACTIVE), choice).astype(np.int32)
    tail = (0, lay["S_pad"] - S)
    args = (sf.pad_state(torch.from_numpy(xs), lay),
            torch.from_numpy(sf.pad_static(pos, lay)),
            sf.pad_sidx(torch.from_numpy(sidx), lay),
            torch.nn.functional.pad(torch.from_numpy(rank), tail),
            torch.nn.functional.pad(torch.from_numpy(cnt.astype(np.int32)), tail))
    return apply_fn, lay, offs, args, 0.37


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_kernel_matches_plain_version(cuda, case):
    apply_fn, lay, offs, args, eta = _fused_inputs(case)
    dargs = [a.to(cuda) for a in args]
    before = sf.sweep_apply.launches
    out = apply_fn(*dargs, eta)
    ref = sf.sweep_apply_ref(*[a.reshape(-1) for a in dargs], eta, offs,
                             lay["H"])
    torch.cuda.synchronize()
    assert sf.sweep_apply.launches == before + 1
    assert out.shape == (lay["S_pad"],) and out.device.type == "cuda"
    assert torch.equal(out, ref)
    # the card's plain version against the CPU's, same inputs
    torch.testing.assert_close(out.cpu(), apply_fn(*args, eta), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("eta", [0.01, 1e4])
@pytest.mark.parametrize("guards", ["path", "arbitrary"])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_kernel_matches_plain_version_at_any_eta(cuda, case, guards, eta):
    """The last sweeps' eta (below every d: the divide eta / safe runs
    everywhere) and a large one (skipped where safe <= eta), on
    path-contiguous and on arbitrary rank/cnt."""
    apply_fn, lay, offs, args, _ = _fused_inputs(case, guards=guards)
    dargs = [a.to(cuda) for a in args]
    before = sf.sweep_apply.launches
    out = apply_fn(*dargs, eta)
    ref = sf.sweep_apply_ref(*[a.reshape(-1) for a in dargs], eta, offs,
                             lay["H"])
    torch.cuda.synchronize()
    assert sf.sweep_apply.launches == before + 1
    assert torch.isfinite(ref).all()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("case", ["k_offs", "tile_edges"])
def test_fused_kernel_without_the_staged_window(cuda, case):
    """Inputs that start 4 bytes past a 16-byte boundary cannot be staged
    by the bulk copies: the kernel reads the near partners from global
    memory instead, with the same result."""
    apply_fn, lay, offs, args, eta = _fused_inputs(case, guards="arbitrary")
    dargs = []
    for a in args[:3]:
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda)
        view = buf[1:]
        view.copy_(a.reshape(-1))
        assert view.data_ptr() % 16 != 0
        dargs.append(view)
    dargs += [a.to(cuda) for a in args[3:]]
    out = sf.sweep_apply(*dargs, eta, offs, lay["H"])
    ref = sf.sweep_apply_ref(*dargs, eta, offs, lay["H"])
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("S,halo", [(1, 8), (1000, 1), (70_001, 8),
                                    (65_536 * 3, 16)])
def test_shift_sum_kernel_matches_plain_version(cuda, variant, S, halo):
    x = torch.from_numpy(np.random.default_rng(S).standard_normal(S).astype(
        np.float32)).to(cuda)
    before = shift_sum.launches[variant]
    out = shift_sum(x, halo, variant)
    torch.cuda.synchronize()
    assert shift_sum.launches[variant] == before + 1
    assert torch.equal(out, shift_sum_ref(x, halo))


def test_dense_probe_runs_on_the_card(cuda):
    res = dense_probe.run(2 * dense_probe.BLOCK, cuda)
    assert res["launches"] == dict.fromkeys(VARIANTS, 1)
    for v in VARIANTS:
        assert res["variants"][v]["bit_identical"]
        assert res["variants"][v]["ms"] > 0
    assert res["library_max_abs_err"] <= dense_probe.LIBRARY_ATOL


# ---- the jax.random draws, the f64 / threefry sweeps, the batched engine ---

def test_jrandom_draws_on_cuda_equal_cpu(cuda):
    """Integer and bit-manipulation ops only: bit for bit."""
    from gfasort_tpu_torch.ops import jrandom

    kd = key_data(9399220)
    for dev_key in (kd, torch.from_numpy(kd.astype(np.int64)).to(cuda)):
        cpu_key = (kd if isinstance(dev_key, np.ndarray)
                   else torch.from_numpy(kd.astype(np.int64)))
        for shape in ((1,), (70_001,), (3, 4097)):
            pairs = [
                (jrandom.split(dev_key, 5, cuda), jrandom.split(cpu_key, 5, "cpu")),
                (jrandom.bits(dev_key, shape, cuda), jrandom.bits(cpu_key, shape, "cpu")),
                (jrandom.bits(dev_key, shape, cuda, 64),
                 jrandom.bits(cpu_key, shape, "cpu", 64)),
                (jrandom.uniform(dev_key, shape, torch.float32, cuda),
                 jrandom.uniform(cpu_key, shape, torch.float32, "cpu")),
                (jrandom.uniform(dev_key, shape, torch.float64, cuda),
                 jrandom.uniform(cpu_key, shape, torch.float64, "cpu")),
                (jrandom.randint(dev_key, shape, 3, 2**31 - 1, cuda),
                 jrandom.randint(cpu_key, shape, 3, 2**31 - 1, "cpu")),
                (jrandom.bernoulli(dev_key, 0.5, shape, cuda),
                 jrandom.bernoulli(cpu_key, 0.5, shape, "cpu")),
            ]
            for got, want in pairs:
                assert got.device.type == "cuda"
                assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mode", ["f64", "threefry_f32"])
def test_sweep_f64_and_threefry_on_cuda_certify_against_cpu(cuda, mode,
                                                            monkeypatch):
    """The f64 route (roll passes only, no kernel launch) and the
    threefry draws at f32 (the bucket kernel): identical run to run on
    the card; against the CPU run the order certifies (the sampler's
    exp/log differ between the devices in the last place)."""
    pidx = synthetic_path_index(3000, 2, 6000, seed=3)
    dtype = "float64" if mode == "f64" else "float32"
    if mode == "threefry_f32":
        monkeypatch.setenv("GFASORT_SWEEP_RNG", "threefry")
    p = replace(PathSGDParams().derive_from_graph(pidx), dtype=dtype,
                iter_max=10)
    kw = dict(proposals=12, per_octave=2, dense_upto=4, rotate=2,
              consensus_every=4)
    plan = make_sweep_plan(pidx, p, **kw)
    assert plan.knobs.rng == ("threefry" if mode == "threefry_f32" else "hash")
    before = bucket_apply.launches
    x_gpu = path_linear_sgd_sweep(None, p, pidx, device=cuda, **kw)
    launched = bucket_apply.launches - before
    if mode == "f64":
        assert launched == 0
        assert not any(ph.kernel_buckets for ph in plan.phases)
    else:
        assert launched == plan.n_exec
    x_gpu2 = path_linear_sgd_sweep(None, p, pidx, device=cuda, **kw)
    np.testing.assert_array_equal(x_gpu, x_gpu2)
    x_cpu = path_linear_sgd_sweep(None, p, pidx, device="cpu", **kw)
    assert np.isfinite(x_gpu).all()
    q = rank_quality(np.argsort(x_gpu, kind="stable"),
                     np.argsort(x_cpu, kind="stable"))
    assert q["rank_mae_frac"] <= 2e-3 and q["spearman"] >= 0.999, q


@pytest.mark.parametrize("dtype,pow_mode", [("float64", "fpp"),
                                            ("float32", "fpp"),
                                            ("float32", "fast")])
def test_batched_1d_on_cuda_equals_cpu(cuda, dtype, pow_mode):
    """``fpp`` draws and the round's updates are IEEE adds, multiplies
    and divides (no transcendental, no contraction in eager torch), and
    each node's terms are summed in one fixed order: bit for bit against
    the CPU, and run to run.  ``fast`` mode draws through exp/log, which
    differ between the devices in the last place: the order certifies."""
    from gfasort_tpu_torch.ops.sgd import path_linear_sgd_batched

    pidx = synthetic_path_index(2000, 3, 3000, seed=5)
    p = replace(PathSGDParams().derive_from_graph(pidx), dtype=dtype,
                pow_mode=pow_mode, iter_max=5, batch=1024)
    x_gpu = path_linear_sgd_batched(None, p, pidx, device=cuda)
    np.testing.assert_array_equal(
        x_gpu, path_linear_sgd_batched(None, p, pidx, device=cuda))
    x_cpu = path_linear_sgd_batched(None, p, pidx, device="cpu")
    if pow_mode == "fpp":
        np.testing.assert_array_equal(x_gpu, x_cpu)
    else:
        q = rank_quality(np.argsort(x_gpu, kind="stable"),
                         np.argsort(x_cpu, kind="stable"))
        assert q["rank_mae_frac"] <= 2e-3 and q["spearman"] >= 0.999, q


@pytest.mark.parametrize("dims", [2, 3])
def test_batched_layout_on_cuda_equals_cpu(cuda, dims):
    """f64 / ``fpp``: the square roots are IEEE on both devices
    (``sqrt_rn``), so bit for bit, and run to run."""
    from gfasort_tpu_torch.ops.exact import layout_initial_coords
    from gfasort_tpu_torch.ops.sgd import path_linear_sgd_layout_batched

    pidx = synthetic_path_index(1000, 3, 1500, seed=6)
    lp = replace(LayoutSGDParams().derive_from_graph(pidx, dims),
                 dtype="float64", pow_mode="fpp", iter_max=3, batch=2048)
    init = layout_initial_coords(pidx, dims, lp.seed)
    out = [path_linear_sgd_layout_batched(None, lp, pidx, init, device=d).coords
           for d in (cuda, cuda, "cpu")]
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_array_equal(out[0], out[2])


def test_checkpointed_run_on_cuda_equals_single_shot(cuda, tmp_path):
    from gfasort_tpu_torch.checkpoint import path_linear_sgd_checkpointed
    from gfasort_tpu_torch.ops.sgd import path_linear_sgd_batched

    pidx = synthetic_path_index(1000, 3, 1500, seed=8)
    p = replace(PathSGDParams().derive_from_graph(pidx), dtype="float64",
                pow_mode="fpp", iter_max=4, batch=512)
    x_one = path_linear_sgd_batched(None, p, pidx, device=cuda)
    x_seg = path_linear_sgd_checkpointed(None, p, str(tmp_path / "c"), pidx,
                                         segment_rounds=7, device=cuda)
    np.testing.assert_array_equal(x_seg, x_one)


def test_batched_graph_replay_equals_eager_loop(cuda, monkeypatch):
    """On the card the round loop is replayed as a CUDA graph in blocks
    of rounds; the eager loop gives the same positions and coordinates,
    bit for bit, across chunks of several round counts and table
    widths."""
    from gfasort_tpu_torch.ops import sgd
    from gfasort_tpu_torch.ops.exact import layout_initial_coords

    pidx = synthetic_path_index(2000, 3, 3000, seed=5)
    p = replace(PathSGDParams().derive_from_graph(pidx), dtype="float32",
                pow_mode="fpp", iter_max=20, batch=256)
    lp = replace(LayoutSGDParams().derive_from_graph(pidx, 2),
                 dtype="float32", pow_mode="fpp", iter_max=6, batch=256)
    init = layout_initial_coords(pidx, 2, lp.seed)
    # chunks of 40 rounds, split at the first cooling round, in graph
    # blocks of 16 rounds: captured, replayed, and eager remainders
    monkeypatch.setattr(sgd, "_CHUNK_TERMS", 40 * 2 * 256)
    monkeypatch.setattr(sgd, "_GRAPH_ROUNDS", 16)
    graphs = (sgd.path_linear_sgd_batched(None, p, pidx, device=cuda),
              sgd.path_linear_sgd_layout_batched(None, lp, pidx, init,
                                                 device=cuda).coords)
    monkeypatch.setattr(sgd, "_chunk_runner",
                        lambda loop, state, pad: (
                            lambda table, *rest: loop(state, table, *rest)))
    eager = (sgd.path_linear_sgd_batched(None, p, pidx, device=cuda),
             sgd.path_linear_sgd_layout_batched(None, lp, pidx, init,
                                                device=cuda).coords)
    for a, b in zip(graphs, eager):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_sharded_sweep_on_cuda_certifies_against_cpu_mesh(cuda, n_shards):
    """The sharded 1D sweep on a card mesh (the shards share the card)
    launches the bucket kernel once per shard and sweep, repeats itself
    bit for bit, and certifies against the same shards on the CPU (the
    sampler's f32 exp / log differ between the devices in the last
    place, as for the single-card engine)."""
    from gfasort_tpu_torch.ops.sweep_plan import make_sharded_sweep_plan
    from gfasort_tpu_torch.parallel import default_mesh
    from gfasort_tpu_torch.parallel.sweep_shard import (
        build_sharded_sweep, path_linear_sgd_sweep_sharded)

    pidx = synthetic_path_index(3000, 4, 3000, seed=3)
    p = replace(PathSGDParams().derive_from_graph(pidx), dtype="float32",
                iter_max=10)
    kw = dict(proposals=12, per_octave=2, dense_upto=4, rotate=2,
              consensus_every=4)
    mesh = default_mesh(n_shards, "cuda")
    L = build_sharded_sweep(pidx, p, mesh, **kw)[3]["shard_len"]
    plan = make_sharded_sweep_plan(pidx, p, L, **kw)
    before = bucket_apply.launches
    x_gpu = path_linear_sgd_sweep_sharded(None, p, mesh, pidx, **kw)
    assert bucket_apply.launches - before == plan.n_exec * n_shards
    np.testing.assert_array_equal(
        x_gpu, path_linear_sgd_sweep_sharded(None, p, mesh, pidx, **kw))
    x_cpu = path_linear_sgd_sweep_sharded(
        None, p, default_mesh(n_shards, "cpu"), pidx, **kw)
    assert np.isfinite(x_gpu).all()
    q = rank_quality(np.argsort(x_gpu, kind="stable"),
                     np.argsort(x_cpu, kind="stable"))
    assert q["rank_mae_frac"] <= 2e-3 and q["spearman"] >= 0.999, q


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_sharded_layout_on_cuda_certifies_against_cpu_mesh(cuda, n_shards,
                                                            dims):
    """The sharded layout at P = 8 (in 3D the unclamped 2 words) on a
    card mesh: the nD kernel launches, the run repeats bit for bit, and
    its stress certifies against the same shards on the CPU."""
    from gfasort_tpu_torch.parallel import (
        default_mesh, path_linear_sgd_layout_sweep_sharded)

    pidx = synthetic_path_index(3000, 4, 3000, seed=3)
    lp = replace(LayoutSGDParams().derive_from_graph(pidx, dims),
                 dtype="float32", pow_mode="fast", iter_max=5)
    kw = dict(proposals=8, per_octave=3, dense_upto=4, rotate=2,
              consensus_every=4, active_frac=1.0)
    mesh = default_mesh(n_shards, "cuda")
    before = dense_apply_nd.launches
    lay = path_linear_sgd_layout_sweep_sharded(None, lp, mesh, pidx, **kw)
    assert dense_apply_nd.launches > before
    np.testing.assert_array_equal(
        lay.coords,
        path_linear_sgd_layout_sweep_sharded(None, lp, mesh, pidx, **kw).coords)
    lay_cpu = path_linear_sgd_layout_sweep_sharded(
        None, lp, default_mesh(n_shards, "cpu"), pidx, **kw)
    assert np.isfinite(lay.coords).all()
    s_gpu = calculate_layout_stress_pidx(pidx, lay, 3000)
    s_cpu = calculate_layout_stress_pidx(pidx, lay_cpu, 3000)
    assert s_gpu / s_cpu <= 1.5, (s_gpu, s_cpu)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_sharded_batched_on_cuda_equals_cpu_mesh(cuda, n_shards):
    """f64 / ``fpp``: the sharded batched engine on a card mesh (its
    round loop replayed as a CUDA graph) equals the same shards on the
    CPU (the eager loop) bit for bit."""
    from gfasort_tpu_torch.parallel import default_mesh, path_linear_sgd_sharded

    pidx = synthetic_path_index(2000, 3, 3000, seed=5)
    p = replace(PathSGDParams().derive_from_graph(pidx), dtype="float64",
                pow_mode="fpp", iter_max=5, batch=1024)
    x_gpu = path_linear_sgd_sharded(None, p, default_mesh(n_shards, "cuda"), pidx)
    x_cpu = path_linear_sgd_sharded(None, p, default_mesh(n_shards, "cpu"), pidx)
    np.testing.assert_array_equal(x_gpu, x_cpu)


def test_runner_cache_keeps_cpu_and_cuda_runners_apart(cuda, monkeypatch):
    """The resolved device is part of the runner cache's key: a CPU
    runner and a CUDA runner never answer for each other."""
    from collections import OrderedDict

    from gfasort_tpu_torch.ops import runner_cache
    from gfasort_tpu_torch.ops.sweep import build_sweep_runner

    monkeypatch.setattr(runner_cache, "_CACHE", OrderedDict())
    monkeypatch.setenv("GFASORT_RUNNER_CACHE", "1")
    pidx = synthetic_path_index(600, 3, 800, seed=2)
    p = replace(PathSGDParams().derive_from_graph(pidx), iter_max=3)
    on_cpu = build_sweep_runner(pidx, p, device="cpu")
    on_card = build_sweep_runner(pidx, p, device="cuda")
    assert on_card is not on_cpu
    assert on_card[1][0].is_cuda and not on_cpu[1][0].is_cuda
    assert build_sweep_runner(pidx, p, device=cuda) is on_card
    assert build_sweep_runner(pidx, p, device="cpu") is on_cpu


def test_entry_round_on_cuda_close_to_cpu(cuda):
    """``entry("cuda")``'s round against the same round on the CPU
    (the sampler's f32 ``exp`` / ``log`` may differ in the last place)."""
    from gfasort_tpu_torch.entry import entry

    fn, args = entry("cuda")
    fn_cpu, args_cpu = entry("cpu")
    torch.testing.assert_close(fn(*args).cpu(), fn_cpu(*args_cpu),
                               rtol=1e-5, atol=1e-4)
