"""The per-sweep sampler kernel (``csrc/sweep_sampler.cu``), modelled in
numpy step by step and held bit for bit to the JAX package's
``pack_choices_words(sample_blocks(...))`` on the CPU (its dispatcher
``sweep_common.sample_words`` is tested in tests/test_torch_roll_apply.py
with the roll kernels').

The model follows the kernel's per-step algorithm: the hash draws of
each proposal in u32 arithmetic from its ``(b2, b1)`` words (the step
index as the counter; the first mix's product split as t * golden +
b1 * golden), the two direction chains computed once per step (the jump
space and its bucket's Zipf constants, found by the kernel's search),
both the Zipf and the uniform draw in f32 in the plain version's order
of rounded ops and one selected, the snap through the kernel's tables
(a branch-free search of fixed depth over the offsets padded with
INT_MAX to 128 entries, then per count c = oidx + 1 the snapped offset,
the next one, the first as f32 and the span), the stochastic promotion
or none, the activity coin, and the packing (P = 1: the raw choices).
It also gives proposal 0's end coin.  The kernel itself runs only on
the card (tests/test_torch_cuda.py).

The threefry routes (``GFASORT_SWEEP_RNG=threefry`` at f32, and every
f64 run) are modelled the same way with the threefry kernel's draws:
per step, in u32 words, threefry2x32 of the counter (0, t) under each
proposal's (k1, k2) from ``keys.threefry_key_table``, ``bits`` and the
f32 or f64 ``u`` built from the words, then the same sampler in the
draws' dtype; the draws are held to ``jax.random`` under
``jax.random.split`` bit for bit, and the words to the JAX package's
sampler fed with its threefry draws."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gfasort_tpu.bench_util import synthetic_path_index  # noqa: E402
from gfasort_tpu_torch import bench_util as tbu  # noqa: E402
from gfasort_tpu.ops import sweep_common as jsc  # noqa: E402
from gfasort_tpu.ops.fastpow import zeta_table  # noqa: E402
from gfasort_tpu.params import PathSGDParams  # noqa: E402
from gfasort_tpu_torch.ops import sweep_common as tsc  # noqa: E402
from gfasort_tpu_torch.ops.keys import (fold_in, key_data,  # noqa: E402
                                        sweep_key_table, threefry_key_table)
from gfasort_tpu_torch.ops.sweep_plan import (make_layout_plan,  # noqa: E402
                                              make_sweep_plan)
from gfasort_tpu_torch.params import (LayoutSGDParams,  # noqa: E402
                                      PathSGDParams as TPathSGDParams)

F32 = np.float32
U32 = np.uint32
SEED = 7
# the cases of chip_smoke.py's sampler phase: 1D P = 12, 2D P = 8,
# 3D P = 4 and P = 1, each at both cooling states, both activity
# fractions and both snaps
PROPOSALS = (12, 8, 4, 1)


def _mix_tail(x):
    """sweep_common._mix after its first product, in u32 (numpy's u32
    products wrap mod 2^32)."""
    x = x ^ (x >> U32(16))
    x = x * U32(0x85EBCA6B)
    x = x ^ (x >> U32(13))
    x = x * U32(0xC2B2AE35)
    return x ^ (x >> U32(16))


def _mix(x):
    """sweep_common._mix: the golden-ratio product, then the tail."""
    return _mix_tail(x * U32(0x9E3779B9))


def _search(offs):
    """The kernel's search table (the offsets, then INT_MAX, 128
    entries) and depth (4 steps for K <= 15, else 7)."""
    tab = np.full(128, 0x7FFFFFFF, np.int64)
    tab[: len(offs)] = offs
    return tab, 4 if len(offs) < 16 else 7


def _count_le(tab, depth, z):
    """The kernel's branch-free search: the number of offsets <= z."""
    c = np.zeros(np.shape(z), np.int64)
    for s in (1 << i for i in range(depth - 1, -1, -1)):
        c += np.where(tab[c + s - 1] <= z, s, 0)
    return c


def _snap_table(offs, fdt=F32):
    """The kernel's per-count entries, c = oidx + 1 in [0, K]: the
    snapped offset offs[c - 1] (torch's wrap at c = 0), the next one
    offs[min(c, K - 1)], the first as a float of ``fdt`` and the span."""
    K = len(offs)
    c = np.arange(K + 1)
    i = np.where(c == 0, K - 1, c - 1)
    lo = offs[i]
    hi = offs[np.minimum(c, K - 1)]
    lo_f = lo.astype(fdt)
    span = np.maximum(hi.astype(fdt) - lo_f, fdt(1.0))
    return i, lo, hi, lo_f, span


def _zipf_core(u, js, n, zeta, eta_z, z2t, alpha):
    """n = max(js, 1) as a float, from the step's chain; the maths in
    ``u``'s dtype."""
    fdt = u.dtype.type
    uz = u * zeta
    arg = (eta_z * u - eta_z) + fdt(1.0)
    arg = np.where(arg < fdt(1e-30), fdt(1e-30), arg)
    with np.errstate(over="ignore"):   # inf, then clamped to n
        general = fdt(1.0) + n * np.exp(alpha * np.log(arg))
    # NaN -> 0 and the clamps to [0, n] in one: fmax returns the operand
    # that is not NaN
    general = np.fmin(np.fmax(general, fdt(0.0)), n)
    g = np.trunc(general).astype(np.int32)
    z = np.where(uz < fdt(1.0), 1, np.where(uz < z2t, 2, g)).astype(np.int32)
    return np.minimum(z, js)


_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    """The kernel's funnel shift of a word with itself."""
    return (x << U32(r)) | (x >> U32(32 - r))


def threefry_words(k0, k1, t):
    """The threefry kernel's threefry2x32 in registers: 20 rounds of the
    counter (0, t) under the key schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA),
    rotations (13, 15, 26, 6) / (17, 29, 16, 24), the schedule injected
    after every four rounds.  Returns the two output words, u32 [S]."""
    k0, k1 = U32(k0), U32(k1)
    ks = (k0, k1, k0 ^ k1 ^ U32(0x1BD11BDA))
    x0 = np.full(t.shape, k0, U32)
    x1 = t + k1
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + U32(i + 1)
    return x0, x1


def threefry_draws(keys, S, fdt):
    """One proposal's draws as the threefry kernel makes them from its
    (k1, k2) = ``keys`` (u32 [2, 2]): ``bits = b1 ^ b2`` under k1, and
    under k2 ``u = ((b1 ^ b2) >> 9 | 1.0f) - 1`` at f32, ``u = ((b1 <<
    20 | b2 >> 12) | 1.0) - 1`` at f64."""
    t = np.arange(S, dtype=U32)
    (a0, a1), (c0, c1) = np.asarray(keys, U32)
    b1, b2 = threefry_words(a0, a1, t)
    bits = b1 ^ b2
    b1, b2 = threefry_words(c0, c1, t)
    if fdt == F32:
        u = (((b1 ^ b2) >> U32(9)) | U32(0x3F800000)).view(F32) - F32(1.0)
    else:
        m = ((b1.astype(np.uint64) << np.uint64(20))
             | (b2 >> U32(12)).astype(np.uint64))
        u = (m | np.uint64(0x3FF0000000000000)).view(np.float64) - 1.0
    return bits, u


def model_sample_words(offs, zeta, eta_z, z2t, alpha, space, key_words,
                       cooling, rank, cnt, frac, snap, draw="hash"):
    """The kernel's words (and proposal 0's end coin) from numpy inputs:
    ``offs`` i32 [K]; ``zeta``/``eta_z`` f32 [K] (f64 [K] on the f64
    route); ``z2t``/``alpha`` of the same dtype; ``key_words`` [P, 2] u32
    (b2, b1) for ``draw`` "hash", [P, 2, 2] u32 (k1, k2) for
    "threefry"."""
    fdt = zeta.dtype.type
    S = len(rank)
    t = np.arange(S, dtype=U32)
    tab, depth = _search(offs)
    ci, lo_t, hi_t, lo_f_t, span_t = _snap_table(offs, fdt)
    avail_b = rank
    avail_f = cnt - 1 - rank
    chains = []
    for avail in (avail_b, avail_f):
        js = np.minimum(avail, space)
        js1 = np.maximum(js, 1)
        c = _count_le(tab, depth, js1)
        chains.append((js, zeta[ci[c]], eta_z[ci[c]], js1.astype(fdt),
                       np.maximum(avail, 1).astype(fdt)))
    has_path = cnt > 1
    back_base = rank > 0
    last = rank == cnt - 1
    not_last = rank < cnt - 1
    thresh = int(frac * (1 << 20)) if frac < 1.0 else -1
    P = len(key_words)
    packed = [np.zeros(S, U32) for _ in range(-(-P // 4))]
    raw = None
    coin = None
    t_g = t * U32(0x9E3779B9)
    for p, row in enumerate(np.asarray(key_words, U32)):
        if draw == "threefry":
            bits, u = threefry_draws(row, S, fdt)
            # u2 = field * 2^-9, exactly
            u2 = ((bits >> U32(20)) & U32(0x1FF)).astype(fdt) * fdt(1 / 512)
        else:
            b2, b1 = row
            h = _mix_tail(t_g + U32((int(b1) * 0x9E3779B9) & 0xFFFFFFFF))
            bits = _mix(h ^ b2)
            salt = U32((int(b2) * 0x9E3779B9 + 0x632BE59B) & 0xFFFFFFFF)
            u = (_mix(h ^ salt) >> U32(8)).astype(F32) * F32(2.0 ** -24)
            # u2 = field * 2^-9 exactly, as 1 + u2 - 1 from the field's bits
            u2 = ((((bits >> U32(6)) & U32(0x1FF << 14)) | U32(0x3F800000))
                  .view(F32) - F32(1.0))
        if p == 0:
            coin = ((bits >> U32(29)) & U32(1)) == 1
        use_zipf = ((bits >> U32(31)) == 1) | cooling
        backward = back_base & ((((bits >> U32(30)) & U32(1)) == 1) | last)
        forward = ~backward & not_last
        avail = np.where(backward, avail_b, avail_f)
        js, zt, ez, n, av = (np.where(backward, b, f)
                             for b, f in zip(chains[0], chains[1]))
        z_zipf = _zipf_core(u, js, n, zt, ez, z2t, alpha)
        z_unif = 1 + np.trunc(u * av).astype(np.int32)
        z = np.where(use_zipf, z_zipf, z_unif)
        c = _count_le(tab, depth, np.maximum(z, 1))
        qfrac = (z.astype(fdt) - lo_f_t[c]) / span_t[c]
        promote = (snap == "stoch") & (u2 < qfrac) & (hi_t[c] <= avail)
        oidx = c - 1 + promote
        off_sel = np.where(promote, hi_t[c], lo_t[c])
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


def _jax_words(phase, p, zetas, P, cooling, rank, cnt, frac,
               fdt=jnp.float32, mode=None):
    """The JAX package's words and end coin, as its engines draw them
    (P single proposals from ``fold_in(key, p)``), in ``fdt`` with the
    ``sweep_rng`` mode ``mode`` (None: the environment's)."""
    S = len(rank)
    _, _, sb = jsc.make_offset_sampler(phase.offs, p, zetas, fdt)
    key = jax.random.key(SEED)
    bu = [jsc.sweep_rng(jax.random.fold_in(key, pi), S, fdt, mode)
          for pi in range(P)]
    rank_j, cnt_j = jnp.asarray(rank), jnp.asarray(cnt)
    if P == 1:
        sidxs = [sb(*bu[0], cooling, rank_j, cnt_j, frac)]
        return [np.asarray(sidxs[0])], np.asarray(((bu[0][0] >> 29) & 1) == 1)
    sidxs = sb.multi(bu, cooling, rank_j, cnt_j, frac)
    words = [np.asarray(w) for w in jsc.pack_choices_words(sidxs)]
    return words, np.asarray(((bu[0][0] >> 29) & 1) == 1)


def _consts_np(phase, cooling, dtype=torch.float32):
    c = tsc.sampler_consts(phase, cooling, "cpu", dtype)
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


def _edge_phase(pidx, p, case):
    """The kernel's edge phases at the test size: K = 64 offsets over the
    whole jump range, or the first plan phase at P = 5."""
    if case == "k64":
        tp = TPathSGDParams().derive_from_graph(pidx)
        return tbu.edge_phase(pidx, tp, tbu.wide_offsets(pidx, tp)), 12
    return _plan(pidx, p, 5).phases[0], 5


@pytest.mark.parametrize("snap", ["stoch", "down"])
@pytest.mark.parametrize("cooling", [False, True])
@pytest.mark.parametrize("case", ["k64", "p5"])
def test_model_edges_equal_jax(workload, monkeypatch, case, cooling, snap):
    """The kernel's edges: a 64-offset table (the deep search) and P = 5
    (three unused fields of the last word), bit for bit against the plain
    version, and against JAX: P = 5 bit for bit; at K = 64 XLA's f32
    ``exp`` / ``log`` (which differ from torch's in the last place on
    10-16% of inputs) move a few Zipf draws across one of the many
    closely spaced offsets, so at most 1 choice in 10^4 may differ."""
    pidx, p, zetas, rank, cnt = workload
    monkeypatch.setenv("GFASORT_SNAP", snap)
    phase, P = _edge_phase(pidx, p, case)
    assert len(phase.offs) == (64 if case == "k64" else len(phase.offs))
    key_words = fold_in(key_data(SEED), np.arange(P))
    (offs, zeta, eta_z, z2t, alpha, space), consts = _consts_np(phase, cooling)
    got, coin = model_sample_words(offs, zeta, eta_z, z2t, alpha, space,
                                   key_words, cooling, rank, cnt, 1.0, snap)
    want, want_coin = _jax_words(phase, p, zetas, P, cooling, rank, cnt, 1.0)
    differ = sum(int((tsc.unpack_choice(torch.tensor(g), q)
                      != tsc.unpack_choice(torch.tensor(w), q)).sum())
                 for g, w in zip(got, want) for q in range(4))
    assert differ <= (P * len(rank) // 10_000 if case == "k64" else 0)
    np.testing.assert_array_equal(coin, want_coin)
    ref, _ = tsc.sample_words_ref(consts, key_words, cooling,
                                  torch.from_numpy(rank),
                                  torch.from_numpy(cnt), 1.0, snap)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.fixture(scope="module")
def bench_offsets():
    """Every offset set of the bench-shape plans (1D, 2D and 3D layout,
    each phase) and a 64-offset table over the bench's jump range, each
    with the largest z to search: the plan's jump space (the uniform
    draws reach avail + 1: twice that is searched too)."""
    bench = tbu.synthetic_path_index(*tbu.BENCH_SHAPE, seed=0)
    tp = TPathSGDParams().derive_from_graph(bench)
    plans = [make_sweep_plan(bench, tp)] + [
        make_layout_plan(bench, replace(
            LayoutSGDParams().derive_from_graph(bench, D), iter_max=30))
        for D in (2, 3)]
    sets = [(ph.offs, ph.space) for plan in plans for ph in plan.phases]
    sets.append((tbu.wide_offsets(bench, tp), tp.space))
    del bench
    return sets


def test_snap_search_equals_searchsorted(bench_offsets):
    """The kernel's search and per-count entries equal the plain
    version's ``snap_idx_track`` (torch.searchsorted(right=True) - 1,
    the negative index's wrap, offs[min(idx + 1, K - 1)]) for every z in
    [0, 2 * space]: the bench-shape plans' phases and a K = 64 table,
    including the degenerate promotion past the last offset (c = K)."""
    assert any(len(o) == 64 for o, _ in bench_offsets)
    for offs, space in bench_offsets:
        K = len(offs)
        z = np.arange(0, 2 * space + 1, dtype=np.int64)
        tab, depth = _search(offs)
        c = _count_le(tab, depth, np.maximum(z, 1))
        _, lo, hi, lo_f, span = _snap_table(offs)
        idx, lo_t, hi_t = tsc.snap_idx_track(
            torch.from_numpy(offs), torch.from_numpy(z).int(), True)
        np.testing.assert_array_equal(c - 1, idx.numpy())
        np.testing.assert_array_equal(lo[c], lo_t.numpy())
        np.testing.assert_array_equal(hi[c], hi_t.numpy())
        np.testing.assert_array_equal(lo_f[c], lo_t.float().numpy())
        span_t = torch.clamp_min(hi_t.float() - lo_t.float(), 1.0)
        np.testing.assert_array_equal(span[c], span_t.numpy())
        assert c.max() == K and (K >= 16) == (depth == 7)


# ---- the threefry routes: threefry draws at f32, and every f64 run -------

# route -> (the draws' dtype, GFASORT_SWEEP_RNG); f64 always draws threefry
ROUTES = {"threefry_f32": (F32, "threefry"), "f64": (np.float64, "hash")}


@pytest.mark.parametrize("fdt", [F32, np.float64])
@pytest.mark.parametrize("P", [12, 1])
def test_threefry_model_equals_jax_draws(fdt, P):
    """The kernel's in-register threefry draws from each proposal's (k1,
    k2) row of ``threefry_key_table`` equal JAX's ``sweep_rng`` (threefry
    mode: ``split(key, 2)``, then ``bits(k1)`` and ``uniform(k2, fdt)``)
    under the same sweep keys, bit for bit, and the port's plain draws."""
    S = 4099
    table = sweep_key_table(key_data(SEED), 3, P)
    tf = threefry_key_table(table)
    jdt = jnp.float32 if fdt == F32 else jnp.float64
    tdt = torch.float32 if fdt == F32 else torch.float64
    for e in (0, 2):
        for q in sorted({0, P - 1}):
            bits, u = threefry_draws(tf[e, q], S, fdt)
            assert bits.dtype == U32 and u.dtype == fdt
            key = jax.random.wrap_key_data(jnp.asarray(table[e, q]))
            jb, ju = jsc.sweep_rng(key, S, jdt, "threefry")
            np.testing.assert_array_equal(bits, np.asarray(jb))
            np.testing.assert_array_equal(u.view(np.uint8),
                                          np.asarray(ju).view(np.uint8))
            tb, tu = tsc.threefry_draws(tf[e, q], S, "cpu", tdt)
            np.testing.assert_array_equal(bits, tb.numpy().astype(U32))
            np.testing.assert_array_equal(u.view(np.uint8),
                                          tu.numpy().view(np.uint8))


@pytest.mark.parametrize("snap", ["stoch", "down"])
@pytest.mark.parametrize("cooling", [False, True])
@pytest.mark.parametrize("P", PROPOSALS)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_model_words_equal_jax_threefry(workload, monkeypatch, route, P,
                                        cooling, snap):
    """The threefry kernel's model against the JAX package's
    ``pack_choices_words(sample_blocks(...))`` fed with its threefry
    draws, on plan phases 0 and 1 (active fraction 0.6 at P = 8 and 1,
    else 1.0), and against the port's dispatcher on the CPU (the plain
    version, from the run's ``threefry_key_table`` rows): the words and
    the end coin bit for bit, at f32 and at f64."""
    pidx, p, zetas, rank, cnt = workload
    fdt, rng = ROUTES[route]
    frac = 0.6 if P in (8, 1) else 1.0
    monkeypatch.setenv("GFASORT_SNAP", snap)
    plan = _plan(pidx, p, P)
    rows = threefry_key_table(fold_in(key_data(SEED), np.arange(P)))
    tdt = torch.float32 if fdt == F32 else torch.float64
    jdt = jnp.float32 if fdt == F32 else jnp.float64
    for phase in plan.phases[:2]:
        (offs, zeta, eta_z, z2t, alpha, space), consts = _consts_np(
            phase, cooling, tdt)
        assert zeta.dtype == fdt and z2t.dtype == fdt
        got, coin = model_sample_words(offs, zeta, eta_z, z2t, alpha, space,
                                       rows, cooling, rank, cnt, frac, snap,
                                       draw="threefry")
        want, want_coin = _jax_words(phase, p, zetas, P, cooling, rank, cnt,
                                     frac, jdt, "threefry")
        assert len(got) == (1 if P == 1 else -(-P // 4))
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(coin, want_coin)
        words_t, coin_t = tsc.sample_words(
            consts, rows, cooling, torch.from_numpy(rank),
            torch.from_numpy(cnt), frac, snap, rng, coin=True)
        for g, w in zip(got, words_t):
            np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(coin, coin_t.numpy())
