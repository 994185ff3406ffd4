"""Port parity: the fused sweep apply's plain version against the JAX
package's build_sweep_apply (its Pallas kernel in interpret mode on the
CPU), the layout dicts and the padding helpers.  The hand-written CUDA
kernel is tested against the plain version in tests/test_torch_cuda.py."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from gfasort_tpu.ops import sweep_pallas as jsp  # noqa: E402
from gfasort_tpu_torch import kernels  # noqa: E402
from gfasort_tpu_torch.bench_util import synthetic_path_index  # noqa: E402
from gfasort_tpu_torch.ops import sweep_common as sc  # noqa: E402
from gfasort_tpu_torch.ops import sweep_fused as sf  # noqa: E402
from gfasort_tpu_torch.ops.keys import fold_in, key_data  # noqa: E402
from gfasort_tpu_torch.ops.sweep_plan import make_sweep_plan  # noqa: E402
from gfasort_tpu_torch.params import PathSGDParams  # noqa: E402

# the JAX kernel test's tolerance and offsets (tests/test_sweep_pallas.py)
RTOL, ATOL = 1e-5, 1e-4
K_OFFS = np.array([1, 2, 3, 4, 6, 9, 13, 19, 40, 100, 300], np.int32)

LAYOUTS = {
    "k_offs_s3000_t1024": (K_OFFS, 3000, 1024, 4),
    "k_offs_s5000_default": (K_OFFS, 5000, 64 * 1024, 4),
    "one_offset_one_step": ([1], 1, 64 * 1024, 4),
    "bench_like": ([1, 2, 3, 181, 1449, 249_999], 4_000_000, 64 * 1024, 4),
    "group3_unaligned": ([1, 2, 3, 4, 6, 9, 128, 129], 70_001, 4096, 3),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_layout_matches_jax(case):
    offs, S, tile, group = LAYOUTS[case]
    _, lay_j = jsp.build_sweep_apply(offs, S, jnp.float32, tile=tile,
                                     group=group, interpret=True)
    _, lay_t = sf.build_sweep_apply(offs, S, tile=tile, group=group)
    assert lay_t == lay_j


def _padded(xs, pos, sidx, rank, cnt, lay):
    """(JAX inputs, port inputs) of the same padded arrays."""
    S, S_pad = lay["S"], lay["S_pad"]
    rank_pad = np.zeros(S_pad, np.int32)
    rank_pad[:S] = rank
    cnt_pad = np.zeros(S_pad, np.int32)
    cnt_pad[:S] = cnt
    pos2 = sf.pad_static(pos, lay)
    jax_in = (jsp.pad_state(jnp.asarray(xs), lay), jnp.asarray(pos2),
              jsp.pad_sidx(jnp.asarray(sidx), lay),
              jnp.asarray(rank_pad.reshape(-1, 128)),
              jnp.asarray(cnt_pad.reshape(-1, 128)))
    port_in = (sf.pad_state(torch.from_numpy(xs), lay), torch.from_numpy(pos2),
               sf.pad_sidx(torch.from_numpy(sidx), lay),
               torch.from_numpy(rank_pad.reshape(-1, 128)),
               torch.from_numpy(cnt_pad.reshape(-1, 128)))
    return jax_in, port_in


def _both(offs, xs, pos, sidx, rank, cnt, eta, tile):
    S = len(xs)
    fn_j, lay = jsp.build_sweep_apply(offs, S, jnp.float32, tile=tile,
                                      interpret=True)
    fn_t, lay_t = sf.build_sweep_apply(offs, S, tile=tile)
    assert lay_t == lay
    jax_in, port_in = _padded(xs, pos, sidx, rank, cnt, lay)
    before = sf.sweep_apply.launches
    out_t = fn_t(*port_in, eta)
    assert sf.sweep_apply.launches == before   # CPU tensors launch nothing
    out_j = np.asarray(fn_j(*jax_in, eta))
    assert out_t.dtype == torch.float32 and out_t.shape == (lay["S_pad"],)
    return out_t.numpy(), out_j, lay


@pytest.mark.parametrize("S,cnt1", [(3000, 1800), (1024, 1024), (5000, 100)])
def test_fused_apply_matches_jax_kernel(S, cnt1):
    """The JAX kernel test's inputs (tests/test_sweep_pallas.py)."""
    rng = np.random.default_rng(S)
    K = len(K_OFFS)
    rank = np.concatenate([np.arange(cnt1), np.arange(S - cnt1)]).astype(np.int32)
    cnt = np.concatenate([np.full(cnt1, cnt1),
                          np.full(S - cnt1, S - cnt1)]).astype(np.int32)
    xs = rng.normal(size=S).astype(np.float32) * 100
    pos = np.cumsum(rng.integers(1, 10, S)).astype(np.float32)
    choice = rng.integers(-K, K + 3, size=S)
    sidx = np.where(choice >= K, int(sf.INACTIVE), choice).astype(np.int32)
    out_t, out_j, lay = _both(K_OFFS, xs, pos, sidx, rank, cnt,
                              np.float32(0.37), tile=1024)
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=ATOL)
    assert (out_t[S:] == 0).all()   # padded steps stay inert


def test_fused_apply_matches_jax_on_synthetic_index():
    """A small synthetic index with its plan's phase-0 full offset set,
    the real rank and cnt, and sampler-drawn P = 1 choices."""
    pidx = synthetic_path_index(1500, 3, 1500, seed=5)
    S = pidx.total_steps
    p = replace(PathSGDParams().derive_from_graph(pidx), dtype="float32")
    plan = make_sweep_plan(pidx, p, proposals=1, active_frac=1.0)
    phase = plan.phases[0]
    assert len(phase.offs) >= 4 and phase.roll_buckets   # k > KMAX present
    rank = pidx.step_rank.astype(np.int32)
    cnt = pidx.step_count_of_step.astype(np.int32)
    bu = [sc.sweep_rng(w, S, "cpu") for w in fold_in(key_data(3), np.arange(1))]
    sidx = sc.sample_blocks(sc.sampler_consts(phase, False, "cpu"), bu, False,
                            torch.from_numpy(rank), torch.from_numpy(cnt),
                            1.0)[0].numpy()
    assert (sidx != sc.INACTIVE).mean() > 0.5
    rng = np.random.default_rng(9)
    xs = (pidx.step_pos + rng.normal(size=S) * 30).astype(np.float32)
    pos = pidx.step_pos.astype(np.float32)
    eta = np.float32(plan.sweep_eta[0])
    out_t, out_j, _ = _both(phase.offs, xs, pos, sidx, rank, cnt, eta,
                            tile=64 * 1024)
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=ATOL)
    assert not np.array_equal(out_t[:S], xs)   # the apply moved steps


def test_padding_helpers_match_jax():
    offs, S = K_OFFS, 3000
    _, lay = sf.build_sweep_apply(offs, S, tile=1024)
    rng = np.random.default_rng(1)
    xs = rng.normal(size=S).astype(np.float32)
    sidx = rng.integers(-5, 5, S).astype(np.int32)
    np.testing.assert_array_equal(sf.pad_static(xs, lay),
                                  jsp.pad_static(xs, lay))
    np.testing.assert_array_equal(sf.pad_state(torch.from_numpy(xs), lay).numpy(),
                                  np.asarray(jsp.pad_state(jnp.asarray(xs), lay)))
    np.testing.assert_array_equal(
        sf.pad_sidx(torch.from_numpy(sidx), lay).numpy(),
        np.asarray(jsp.pad_sidx(jnp.asarray(sidx), lay)))
    assert int(sf.INACTIVE) == int(jsp.INACTIVE)


def _small_inputs(dtype=torch.float32):
    offs = (1, 2, 5)
    apply_fn, lay = sf.build_sweep_apply(offs, 300)
    L, S_pad = lay["L"], lay["S_pad"]
    rank = torch.arange(S_pad, dtype=torch.int32)
    cnt = torch.full((S_pad,), S_pad, dtype=torch.int32)
    return (apply_fn, lay, offs, torch.zeros(L, dtype=dtype),
            torch.arange(L, dtype=dtype), torch.zeros(L, dtype=torch.int32),
            rank, cnt)


def test_fused_apply_refuses_float64():
    with pytest.raises(ValueError, match="float32"):
        sf.build_sweep_apply(K_OFFS, 3000, dtype=torch.float64)
    apply_fn, _, _, xs, pos, sidx, rank, cnt = _small_inputs(torch.float64)
    with pytest.raises(ValueError, match="float32"):
        apply_fn(xs, pos, sidx, rank, cnt, 0.5)


def test_fused_apply_validates_inputs():
    apply_fn, lay, offs, xs, pos, sidx, rank, cnt = _small_inputs()
    with pytest.raises(ValueError):   # wrong padded length
        apply_fn(xs[:-1], pos, sidx, rank, cnt, 0.5)
    with pytest.raises(ValueError):   # int64 ranks
        apply_fn(xs, pos, sidx, rank.long(), cnt, 0.5)
    with pytest.raises(ValueError):   # an offset beyond the halo
        sf.sweep_apply(xs, pos, sidx, rank, cnt, 0.5, (1, lay["H"] + 1),
                       lay["H"])
    with pytest.raises(ValueError):   # more offsets than the kernel's table
        sf.sweep_apply(xs, pos, sidx, rank, cnt, 0.5,
                       [1] * (sf.MAX_OFFSETS + 1), lay["H"])
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in (xs, pos, sidx, rank, cnt)]
    with pytest.raises(ValueError):   # no silent fallback off cpu/cuda
        apply_fn(*meta, 0.5)


def test_cpu_inputs_never_touch_the_kernel_library(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(kernels, "library", refuse)
    apply_fn, lay, offs, xs, pos, sidx, rank, cnt = _small_inputs()
    before = sf.sweep_apply.launches
    out = apply_fn(xs.reshape(-1, 128), pos.reshape(-1, 128),
                   sidx.reshape(-1, 128), rank, cnt, 0.5)
    assert sf.sweep_apply.launches == before
    torch.testing.assert_close(out, sf.sweep_apply_ref(
        xs, pos, sidx, rank, cnt, 0.5, offs, lay["H"]), rtol=0, atol=0)
