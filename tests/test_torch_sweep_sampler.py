"""The per-sweep sampler kernel (``csrc/sweep_sampler.cu``), modelled in
numpy step by step and held bit for bit to the JAX package's
``pack_choices_words(sample_blocks(...))`` on the CPU (its dispatcher
``sweep_common.sample_words`` is tested in tests/test_torch_roll_apply.py
with the roll kernels').

The model follows the kernel's per-step algorithm: the hash draws of
each proposal in u32 arithmetic from its ``(b2, b1)`` words (the step
index as the counter), the two direction chains computed once per step
(the jump space and its bucket's Zipf constants, found by the kernel's
binary search over the offsets), the Zipf or uniform draw in f32 in the
plain version's order of rounded ops, the stochastic or the downward
snap by the same search, the activity coin, and the packing (P = 1: the
raw choices).  It also gives proposal 0's end coin.  The kernel itself
runs only on the card (tests/test_torch_cuda.py)."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gfasort_tpu.bench_util import synthetic_path_index  # noqa: E402
from gfasort_tpu.ops import sweep_common as jsc  # noqa: E402
from gfasort_tpu.ops.fastpow import zeta_table  # noqa: E402
from gfasort_tpu.params import PathSGDParams  # noqa: E402
from gfasort_tpu_torch.ops import sweep_common as tsc  # noqa: E402
from gfasort_tpu_torch.ops.keys import fold_in, key_data  # noqa: E402
from gfasort_tpu_torch.ops.sweep_plan import make_sweep_plan  # noqa: E402

F32 = np.float32
U32 = np.uint32
SEED = 7
# the cases of chip_smoke.py's sampler phase: 1D P = 12, 2D P = 8,
# 3D P = 4 and P = 1, each at both cooling states, both activity
# fractions and both snaps
PROPOSALS = (12, 8, 4, 1)


def _mix(x):
    """sweep_common._mix in u32 (numpy's u32 products wrap mod 2^32)."""
    x = x * U32(0x9E3779B9)
    x = x ^ (x >> U32(16))
    x = x * U32(0x85EBCA6B)
    x = x ^ (x >> U32(13))
    x = x * U32(0xC2B2AE35)
    return x ^ (x >> U32(16))


def _snap_idx(offs, z):
    """The kernel's binary search: the index of the largest offset <= z
    (-1 where none is)."""
    K = len(offs)
    lo = np.zeros(z.shape, np.int64)
    hi = np.full(z.shape, K, np.int64)
    while (lo < hi).any():
        live = lo < hi
        mid = (lo + hi) >> 1
        go = live & (offs[np.minimum(mid, K - 1)] <= z)
        lo = np.where(go, mid + 1, lo)
        hi = np.where(live & ~go, mid, hi)
    return (lo - 1).astype(np.int32)


def _at(a, i):
    """a[i] with torch's negative-index wrap."""
    return a[np.where(i < 0, i + len(a), i)]


def _zipf_core(u, js, zeta, eta_z, z2t, alpha):
    n = np.maximum(js, 1).astype(F32)
    uz = u * zeta
    arg = (eta_z * u - eta_z) + F32(1.0)
    arg = np.where(arg < F32(1e-30), F32(1e-30), arg)
    with np.errstate(over="ignore"):   # inf, then clamped to n
        general = F32(1.0) + n * np.exp(alpha * np.log(arg))
    general = np.where(np.isnan(general), F32(0.0), general)
    general = np.minimum(np.maximum(general, F32(0.0)), n)
    g = np.trunc(general).astype(np.int32)
    z = np.where(uz < F32(1.0), 1, np.where(uz < z2t, 2, g)).astype(np.int32)
    return np.minimum(z, js)


def model_sample_words(offs, zeta, eta_z, z2t, alpha, space, key_words,
                       cooling, rank, cnt, frac, snap):
    """The kernel's words (and proposal 0's end coin) from numpy inputs:
    ``offs`` i32 [K]; ``zeta``/``eta_z`` f32 [K]; ``z2t``/``alpha`` f32;
    ``key_words`` [P, 2] u32 (b2, b1)."""
    S = len(rank)
    t = np.arange(S, dtype=U32)
    avail_b = rank
    avail_f = cnt - 1 - rank
    chains = []
    for avail in (avail_b, avail_f):
        js = np.minimum(avail, space)
        idx = _snap_idx(offs, np.maximum(js, 1))
        chains.append((js, _at(zeta, idx), _at(eta_z, idx)))
    has_path = cnt > 1
    back_base = rank > 0
    last = rank == cnt - 1
    not_last = rank < cnt - 1
    thresh = int(frac * (1 << 20)) if frac < 1.0 else -1
    P = len(key_words)
    packed = [np.zeros(S, U32) for _ in range(-(-P // 4))]
    raw = None
    coin = None
    for p, (b2, b1) in enumerate(np.asarray(key_words, U32)):
        h = _mix(t + b1)
        bits = _mix(h ^ b2)
        salt = U32((int(b2) * 0x9E3779B9 + 0x632BE59B) & 0xFFFFFFFF)
        u = (_mix(h ^ salt) >> U32(8)).astype(F32) * F32(2.0 ** -24)
        if p == 0:
            coin = ((bits >> U32(29)) & U32(1)) == 1
        use_zipf = ((bits >> U32(31)) == 1) | cooling
        backward = back_base & ((((bits >> U32(30)) & U32(1)) == 1) | last)
        forward = ~backward & not_last
        avail = np.where(backward, avail_b, avail_f)
        js, zt, ez = (np.where(backward, b, f)
                      for b, f in zip(chains[0], chains[1]))
        z_zipf = _zipf_core(u, js, zt, ez, z2t, alpha)
        z_unif = 1 + np.trunc(u * np.maximum(avail, 1).astype(F32)).astype(
            np.int32)
        z = np.where(use_zipf, z_zipf, z_unif)
        oidx = _snap_idx(offs, np.maximum(z, 1))
        off_sel = _at(offs, oidx)
        if snap == "stoch":
            off_hi = offs[np.minimum(oidx + 1, len(offs) - 1)]
            off_lo = off_sel.astype(F32)
            u2 = ((bits >> U32(20)) & U32(0x1FF)).astype(F32) * F32(1 / 512)
            qfrac = (z.astype(F32) - off_lo) / np.maximum(
                off_hi.astype(F32) - off_lo, F32(1.0))
            promote = (u2 < qfrac) & (off_hi <= avail)
            oidx = np.where(promote, oidx + 1, oidx)
            off_sel = np.where(promote, off_hi, off_sel)
        active = (forward | backward) & has_path & (off_sel <= avail)
        if thresh >= 0:
            active &= (bits & U32(0xFFFFF)).astype(np.int64) < thresh
        choice = np.where(active, np.where(backward, ~oidx, oidx),
                          int(tsc.INACTIVE)).astype(np.int32)
        if P == 1:
            raw = choice
        else:
            field = np.where(choice == int(tsc.INACTIVE), int(tsc.INACTIVE8),
                             choice).astype(U32) & U32(0xFF)
            packed[p // 4] |= field << U32(8 * (p % 4))
    words = [raw] if P == 1 else [w.view(np.int32) for w in packed]
    return words, coin


@pytest.fixture(scope="module")
def workload():
    pidx = synthetic_path_index(5000, 4, 5000, seed=11)
    p = replace(PathSGDParams().derive_from_graph(pidx), dtype="float32",
                pow_mode="fast")
    zetas = zeta_table(p.space, p.space_max, p.space_quantization_step,
                       p.theta)
    rank = pidx.step_rank.astype(np.int32)
    cnt = pidx.step_count_of_step.astype(np.int32)
    return pidx, p, zetas, rank, cnt


def _plan(pidx, p, P):
    # the large-regime knobs at a test size: rotation phase sets with
    # offsets above KMAX
    return make_sweep_plan(pidx, p, per_octave=2, dense_upto=4, rotate=4,
                           proposals=P, active_frac=1.0)


def _jax_words(phase, p, zetas, P, cooling, rank, cnt, frac):
    """The JAX package's words and end coin, as its engines draw them
    (P single proposals from ``fold_in(key, p)``)."""
    S = len(rank)
    _, _, sb = jsc.make_offset_sampler(phase.offs, p, zetas, jnp.float32)
    key = jax.random.key(SEED)
    bu = [jsc.sweep_rng(jax.random.fold_in(key, pi), S, jnp.float32)
          for pi in range(P)]
    rank_j, cnt_j = jnp.asarray(rank), jnp.asarray(cnt)
    if P == 1:
        sidxs = [sb(*bu[0], cooling, rank_j, cnt_j, frac)]
        return [np.asarray(sidxs[0])], np.asarray(((bu[0][0] >> 29) & 1) == 1)
    sidxs = sb.multi(bu, cooling, rank_j, cnt_j, frac)
    words = [np.asarray(w) for w in jsc.pack_choices_words(sidxs)]
    return words, np.asarray(((bu[0][0] >> 29) & 1) == 1)


def _consts_np(phase, cooling):
    c = tsc.sampler_consts(phase, cooling, "cpu")
    return (c.offs.numpy(), c.zeta.numpy(), c.eta_z.numpy(),
            c.zeta2theta.numpy()[()], c.alpha.numpy()[()], c.space), c


@pytest.mark.parametrize("snap", ["stoch", "down"])
@pytest.mark.parametrize("frac", [1.0, 0.6])
@pytest.mark.parametrize("cooling", [False, True])
@pytest.mark.parametrize("P", PROPOSALS)
def test_model_words_equal_jax(workload, monkeypatch, P, cooling, frac, snap):
    pidx, p, zetas, rank, cnt = workload
    monkeypatch.setenv("GFASORT_SNAP", snap)
    plan = _plan(pidx, p, P)
    key_words = fold_in(key_data(SEED), np.arange(P))
    for phase in plan.phases[:2]:
        (offs, zeta, eta_z, z2t, alpha, space), consts = _consts_np(
            phase, cooling)
        assert offs.dtype == np.int32 and zeta.dtype == F32
        got, coin = model_sample_words(offs, zeta, eta_z, z2t, alpha, space,
                                       key_words, cooling, rank, cnt, frac,
                                       snap)
        want, want_coin = _jax_words(phase, p, zetas, P, cooling, rank, cnt,
                                     frac)
        assert len(got) == (1 if P == 1 else -(-P // 4))
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(coin, want_coin)
        # the dispatcher on the CPU: the plain version, the same words
        words_t, coin_t = tsc.sample_words(
            consts, key_words, cooling, torch.from_numpy(rank),
            torch.from_numpy(cnt), frac, snap, coin=True)
        for g, w in zip(got, words_t):
            np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(coin, coin_t.numpy())


def test_model_covers_degenerate_promotion(workload):
    """A draw above the largest offset promotes past it (oidx = K) where
    the stochastic snap says so, in the model as in the plain version."""
    pidx, p, zetas, rank, cnt = workload
    phase = _plan(pidx, p, 12).phases[0]
    (offs, zeta, eta_z, z2t, alpha, space), consts = _consts_np(phase, False)
    K = len(offs)
    # a cut offset set whose largest offset lies below most jump spaces
    cut = offs[: K // 2]
    c_cut = replace(consts, offs=torch.from_numpy(cut),
                    zeta=consts.zeta[: K // 2], eta_z=consts.eta_z[: K // 2])
    key_words = fold_in(key_data(3), np.arange(12))
    got, _ = model_sample_words(cut, zeta[: K // 2], eta_z[: K // 2], z2t,
                                alpha, space, key_words, False, rank, cnt,
                                1.0, "stoch")
    ref, _ = tsc.sample_words_ref(c_cut, key_words, False,
                                  torch.from_numpy(rank),
                                  torch.from_numpy(cnt), 1.0, "stoch")
    fields = [tsc.unpack_choice(w, q).numpy() for w in ref for q in range(4)]
    assert any((f == K // 2).any() for f in fields), "no promotion past K - 1"
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g, w.numpy())
