"""The arithmetic order of the fused sweep-apply kernel
(``csrc/sweep_apply.cu``), modelled in numpy and held bit for bit to the
plain version ``sweep_apply_ref``.

Per near bucket (k < the tile) the kernel evaluates each pair (t, t + k)
once, in t's ahead reading, where t's ahead guard holds: t applies its
own update and leaves the partner's (its negation, or itself where
dx == 0) in a pair table.  t + k, where its behind guard holds, takes
that entry when t lies in its tile and t's guard held, and evaluates the
pair itself otherwise; a side whose guard fails adds a zero with w = 0.
Far buckets (k >= the tile) evaluate both sides per step.  Two exact cuts
change the ops: x / 2 is x * 0.5, and mu = 1 without the divide where
safe <= eta.  The model follows that order op for op, on path-contiguous
rank/cnt and on arbitrary ones where the two guards disagree.  The kernel
itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gfasort_tpu_torch.ops import sweep_fused as sf  # noqa: E402

F32 = np.float32
KERNEL_TILE = 256   # kTile of csrc/sweep_apply.cu
TILES = (16, KERNEL_TILE)
# eta equal to some pair's d (3: positions step by 0-2), below every
# safe (>= 1), above every d, and a middle value
ETAS = (3.0, 0.25, 1e6, 37.5)


def _pair(x, p, xo, po, w_bool, eta):
    """(w, the reading side's update, dx == 0) of the pair, its guard
    held: the kernel's ops, with mu = 1 where safe <= eta and * 0.5."""
    d = np.abs(p - po)
    valid = d != 0
    w = (valid & w_bool).astype(F32)
    safe = np.where(valid, d, F32(1))
    mu = np.where(safe <= eta, F32(1), np.minimum(eta / safe, F32(1)))
    dx = x - xo
    tie = dx == 0
    dx = np.where(tie, F32(1e-9), dx)
    mag = np.abs(dx)
    r = (mu * (mag - safe) * F32(0.5) / mag) * dx
    return w, -w * r, tie


def model_sweep_apply(xs_pad, pos_pad, sidx_pad, rank, cnt, eta, offs, H,
                      tile):
    """The kernel's bucket loop on flat padded numpy inputs."""
    eta = F32(eta)
    S_pad = len(rank)
    s = np.arange(S_pad)

    def at(a, k):
        return a[H + k + s]

    x, p, si = at(xs_pad, 0), at(pos_pad, 0), at(sidx_pad, 0)
    room = np.clip(cnt.astype(np.int64) - rank, 0, 2 ** 31 - 1)
    dsum = np.zeros(S_pad, F32)
    csum = np.zeros(S_pad, F32)
    zero = F32(0)
    for ki, k in enumerate(offs):
        ok_a = k < room
        w_a, u_a, tie = _pair(x, p, at(xs_pad, k), at(pos_pad, k),
                              (si == ki) | (at(sidx_pad, k) == ~ki), eta)
        w_a, u_a = np.where(ok_a, w_a, zero), np.where(ok_a, u_a, zero)
        w_b, u_b, _ = _pair(x, p, at(xs_pad, -k), at(pos_pad, -k),
                            (si == ~ki) | (at(sidx_pad, -k) == ki), eta)
        if k < tile:   # near: the table entry of s - k where it holds one
            prev = np.maximum(s - k, 0)
            table = (s % tile >= k) & ok_a[prev]
            u_o = np.where(tie, u_a, -u_a)
            w_b = np.where(table, w_a[prev], w_b)
            u_b = np.where(table, u_o[prev], u_b)
        ok_b = rank >= k
        w_b, u_b = np.where(ok_b, w_b, zero), np.where(ok_b, u_b, zero)
        dsum = dsum + (u_a + u_b)
        csum = csum + (w_a + w_b)
    return x + dsum / np.maximum(csum, F32(1))


def _offsets(tile):
    """Near offsets, tile - 1, tile, tile + 1, and k = H last."""
    H = -(-(tile + 40) // 128) * 128
    return [1, 2, 5, tile // 2 + 3, tile - 1, tile, tile + 1, H]


def _inputs(S, offs, guards, seed):
    """Flat padded numpy inputs and H.  ``guards``: "path" (rank/cnt of
    paths of random lengths) or "arbitrary" (random rank and cnt, so the
    ahead and behind guards of one pair disagree).  Equal xs at offsets
    1 and 5 give dx == 0, repeated positions d == 0; choices of every
    bucket and sign and INACTIVE.  The layout's tile of 128 leaves S_pad
    off the kernel's tile."""
    _, lay = sf.build_sweep_apply(offs, S, tile=128)
    rng = np.random.default_rng(seed)
    xs = (rng.standard_normal(S) * 10).astype(F32)
    xs[5::7] = xs[6::7][:len(xs[5::7])]          # dx == 0 at k = 1
    xs[9::11] = xs[14::11][:len(xs[9::11])]      # dx == 0 at k = 5
    pos = np.cumsum(rng.integers(0, 3, S)).astype(F32)   # d == 0 pairs
    K = len(offs)
    choice = rng.integers(-K, K + 2, size=S)
    sidx = np.where(choice >= K, int(sf.INACTIVE), choice).astype(np.int32)
    if guards == "path":
        lens = rng.integers(1, 2 * max(offs), size=S)
        ends = np.cumsum(lens)
        ends = np.concatenate([ends[ends < S], [S]])
        starts = np.concatenate([[0], ends[:-1]])
        rank = np.arange(S) - np.repeat(starts, ends - starts)
        cnt = np.repeat(ends - starts, ends - starts)
    else:
        rank = rng.integers(0, 2 * max(offs), size=S)
        cnt = rng.integers(0, 3 * max(offs), size=S)
    rank_pad = np.zeros(lay["S_pad"], np.int32)
    cnt_pad = np.zeros(lay["S_pad"], np.int32)
    rank_pad[:S], cnt_pad[:S] = rank, cnt
    pad = sf.pad_static(pos, lay).reshape(-1)
    return (sf.pad_static(xs, lay).reshape(-1), pad,
            sf.pad_static(sidx, lay, fill=int(sf.INACTIVE)).reshape(-1),
            rank_pad, cnt_pad), lay["H"]


def _check(args, eta, offs, H, tile):
    want = sf.sweep_apply_ref(*[torch.from_numpy(a) for a in args], eta,
                              tuple(offs), H)
    got = model_sweep_apply(*args, eta, offs, H, tile)
    assert torch.isfinite(want).all()
    assert torch.equal(torch.from_numpy(got), want)
    return want


@pytest.mark.parametrize("eta", ETAS)
@pytest.mark.parametrize("guards", ["path", "arbitrary"])
@pytest.mark.parametrize("tile", TILES)
def test_fused_pair_table_order_equals_plain_version(tile, guards, eta):
    offs = _offsets(tile)
    S = 301 if tile == 16 else 2900
    args, H = _inputs(S, offs, guards, seed=tile + len(guards))
    assert H == offs[-1]   # k = H is a case
    want = _check(args, eta, offs, H, tile)
    xs = args[0][H:H + len(want)]
    assert (want.numpy()[:S] != xs[:S]).sum() > S // 4   # the apply moved steps


@pytest.mark.parametrize("guards", ["path", "arbitrary"])
@pytest.mark.parametrize("tile", TILES)
def test_fused_pair_table_order_k64(tile, guards):
    """The kernel's full offset table, near and far buckets mixed."""
    offs = list(range(1, 61)) + _offsets(tile)[-4:]
    assert len(offs) == sf.MAX_OFFSETS
    args, H = _inputs(1900, offs, guards, seed=64 + tile)
    _check(args, 1.5, offs, H, tile)


def test_inputs_hit_every_guard():
    """The inputs hold dx == 0 and d == 0 pairs, pairs with safe == eta,
    and, with arbitrary rank/cnt, pairs whose guards disagree both ways."""
    offs = _offsets(16)
    (xs, pos, _, rank, cnt), H = _inputs(301, offs, "arbitrary", seed=3)
    S = 301
    x, p = xs[H:H + S], pos[H:H + S]
    assert (x[:-1] == x[1:]).any() and (x[:-5] == x[5:]).any()
    assert (p[:-1] == p[1:]).any() and (np.abs(p[:-2] - p[2:]) == 3).any()
    r, c = rank[:S].astype(np.int64), cnt[:S].astype(np.int64)
    for k in offs[:4]:
        ahead = r[:-k] + k < c[:-k]
        behind = r[k:] >= k
        assert (ahead & ~behind).any() and (~ahead & behind).any()
    (_, _, _, rank, cnt), _ = _inputs(301, offs, "path", seed=3)
    r, c = rank[:S].astype(np.int64), cnt[:S].astype(np.int64)
    for k in offs:
        np.testing.assert_array_equal(r[:-k] + k < c[:-k], r[k:] >= k)


def _f32_patterns(rng, n):
    """Random f32 bit patterns, subnormals and both zeros included, with
    the non-finite ones dropped."""
    bits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    sub = rng.integers(0, 1 << 23, n // 4, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 1 << 31, 1, 0x007FFFFF, 0x00800000, 0x7F7FFFFF,
                     0x3F800000, 0x3F000000, 0x80000001], np.uint32)
    v = np.concatenate([bits, sub, sub | np.uint32(1 << 31), edge]).view(F32)
    return v[np.isfinite(v)]


def test_halving_is_times_half_for_every_f32():
    x = _f32_patterns(np.random.default_rng(0), 1 << 20)
    np.testing.assert_array_equal((x / F32(2)).view(np.uint32),
                                  (x * F32(0.5)).view(np.uint32))
    t = torch.from_numpy(x)
    assert torch.equal((t / 2.0).view(torch.int32), (t * 0.5).view(torch.int32))


def test_mu_is_one_where_safe_is_at_most_eta():
    rng = np.random.default_rng(1)
    a = np.abs(_f32_patterns(rng, 1 << 20))
    b = np.abs(_f32_patterns(rng, 1 << 20))[:len(a)]
    a = a[:len(b)]
    eta, safe = np.maximum(a, b), np.minimum(a, b)
    keep = safe > 0   # safe is a nonzero d or 1
    eta, safe = np.concatenate([eta[keep], a[a > 0]]), np.concatenate(
        [safe[keep], a[a > 0]])                        # and safe == eta
    assert (safe <= eta).all() and len(eta) > 1 << 20
    with np.errstate(over="ignore"):
        q = eta / safe
    np.testing.assert_array_equal(np.minimum(q, F32(1)), F32(1))
    mu = torch.minimum(torch.from_numpy(eta) / torch.from_numpy(safe),
                       torch.ones(()))
    assert bool((mu == 1).all())
