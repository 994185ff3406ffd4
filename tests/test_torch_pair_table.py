"""The arithmetic order of the bucket kernels (``csrc/bucket_apply.cu``,
``csrc/dense_apply_nd.cu``), modelled in numpy and held bit for bit to
the plain versions ``bucket_apply_ref`` and ``dense_apply_nd_ref``.

The kernels evaluate each pair (t, t + k) once, in t's +k reading: t
applies its own update and leaves the partner's in a pair table, from
which t + k takes its -k update where t lies in its tile; the first k
steps of a tile (every step when k >= the tile) evaluate their -k pair
themselves.  The partner's update is the negation of t's, except where
dx == 0 (1D) or, in dimension 0, where mag^2 == 0 (nD): both readings
then take the 1e-9 guard.  Proposal counts are byte-SIMD: a per-byte
test on the packed words, masked to the first P fields, the per-byte
hits summed by a multiply and made an f32 by 2^23 arithmetic.  The
model follows that order op for op, with a small tile so that k > tile,
k >= S and S not a multiple of the tile all occur.  The kernels
themselves run only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gfasort_tpu_torch.ops.sweep_common import (INACTIVE,  # noqa: E402
                                                PACKED_INACTIVE,
                                                pack_choices_words)
from gfasort_tpu_torch.ops.sweep_dense import (bucket_apply_ref,  # noqa: E402
                                               dense_apply_nd_ref)

F32 = np.float32
TILES = (16, 512, 1024)   # a small tile and the kernels' kTile (nD, 1D)


def _byte_ne(x, y):
    """Bit 7 of each byte set unless the bytes of the uint32 words x and
    y agree (the kernels' test)."""
    v = x ^ y
    return ((v & 0x7F7F7F7F) + 0x7F7F7F7F) | v


def _weight(wa, wb, ki, P, mask=True):
    """The f32 weight of the pair (a, a + k): proposals with a's field
    == ki or b's field == ~ki, over the first P fields (``mask``),
    counted as the kernels count them."""
    if P == 1:
        return ((wa[0] == ki) | (wb[0] == ~ki)).astype(F32)
    want_a = np.uint32(0x01010101 * ki)
    want_b = np.uint32(0x01010101 * (~ki & 0xFF))
    hits = np.zeros(wa[0].shape, np.uint32)   # per-byte hit counts
    for j, (a, b) in enumerate(zip(wa, wb)):
        used = min(P - 4 * j, 4) if mask else 4
        keep = np.uint32(0x80808080 >> (8 * (4 - used)))
        miss = _byte_ne(a.view(np.uint32), want_a) & _byte_ne(
            b.view(np.uint32), want_b)
        hits += (~miss & keep) >> 7
    n = (hits * np.uint32(0x01010101)) >> 24
    # 2^23 + n minus 2^23
    return (n | np.uint32(0x4B000000)).view(F32) - F32(8388608)


def _loader(arrays, words, P):
    """Step values at the indices i: the float rows of ``arrays`` and
    the choice words, 0 and the fill outside [0, S)."""
    S = words[0].shape[0]
    fill = np.int32(INACTIVE if P == 1 else PACKED_INACTIVE)

    def at(i):
        ok = (i >= 0) & (i < S)
        ic = np.clip(i, 0, S - 1)
        return ([np.where(ok, a[..., ic], F32(0)) for a in arrays],
                [np.where(ok, w[ic], fill) for w in words])
    return at


def _model(pair, at, S, buckets, tile, shape):
    """The kernels' bucket loop: +k from the own pair, -k from the table
    inside the tile or from the own evaluation of (s - k, s)."""
    s = np.arange(S)
    own = at(s)
    acc = np.zeros(shape, F32)
    wacc = np.zeros(S, F32)
    for k, ki in buckets:
        w, upd, upd_o = pair(own, at(s + k), ki)
        acc = acc - upd
        wacc = wacc + w
        from_table = s % tile >= k
        w_d, _, upd_d = pair(at(s - k), own, ki)
        prev = np.maximum(s - k, 0)
        acc = acc - np.where(from_table, upd_o[..., prev], upd_d)
        wacc = wacc + np.where(from_table, w[prev], w_d)
    return acc, wacc


def model_bucket_apply(xs, pos, words, eta, buckets, P, tile, mask=True):
    eta = F32(eta)

    def pair(a, b, ki):
        """(w, a's update, b's update) of the pair (a, b) in a's +k
        reading."""
        (xa, pa), wa = a
        (xb, pb), wb = b
        d = np.abs(pa - pb)
        valid = d != 0
        w = np.where(valid, _weight(wa, wb, ki, P, mask), F32(0))
        safe = np.where(valid, d, F32(1))
        mu = np.minimum(eta / safe, F32(1))
        dx = xa - xb
        tie = dx == 0
        dx = np.where(tie, F32(1e-9), dx)
        half = np.where(dx >= 0, F32(0.5), F32(-0.5))
        upd = w * (mu * (np.abs(dx) - safe) * half)
        return w, upd, np.where(tie, upd, -upd)

    return _model(pair, _loader([xs, pos], words, P), len(xs), buckets,
                  tile, xs.shape)


def model_dense_apply_nd(my_pos, words, my_c, eta, buckets, P, tile,
                         mask=True):
    eta = F32(eta)
    D = my_c.shape[0]

    def pair(a, b, ki):
        (pa, ca), wa = a
        (pb, cb), wb = b
        dist = np.abs(pa - pb)
        valid = dist != 0
        w = np.where(valid, _weight(wa, wb, ki, P, mask), F32(0))
        safe = np.where(valid, dist, F32(1))
        mu = np.minimum(eta / safe, F32(1))
        delta = ca - cb
        mag2 = delta[0] * delta[0]
        for d in range(1, D):
            mag2 = mag2 + delta[d] * delta[d]
        tie = mag2 == 0
        delta[0] = np.where(tie, F32(1e-9), delta[0])
        mag2 = np.where(tie, F32(1e-18), mag2)
        inv = F32(1) / np.sqrt(mag2)
        r = np.minimum(mu * (mag2 * inv - safe) * F32(0.5) * inv, F32(1e30))
        upd = (w * r) * delta
        upd_o = -upd
        upd_o[0] = np.where(tie, upd[0], upd_o[0])
        return w, upd, upd_o

    return _model(pair, _loader([my_pos, my_c], words, P), len(my_pos),
                  buckets, tile, my_c.shape)


def _words(rng, S, buckets, P):
    """Choice words of P proposals: every bucket's ki and ~ki, INACTIVE
    and foreign buckets, with no sampler contract (the kernels read past
    either end as the plain versions do)."""
    kis = [ki for _, ki in buckets]
    pool = np.array(kis + [~ki for ki in kis] + [int(INACTIVE), 30, ~29],
                    np.int32)
    sidxs = [pool[rng.integers(0, len(pool), S)] for _ in range(P)]
    if P == 1:
        return sidxs
    return [w.numpy() for w in pack_choices_words(
        [torch.from_numpy(s) for s in sidxs])]


def _inputs_1d(S, buckets, P, seed):
    rng = np.random.default_rng(seed)
    xs = (rng.standard_normal(S) * 10).astype(F32)
    xs[5::7] = xs[6::7][:len(xs[5::7])]          # dx == 0 at k = 1
    xs[9::11] = xs[:S - 9:11][:len(xs[9::11])]   # dx == 0 at k = 9
    pos = np.cumsum(rng.integers(0, 3, S)).astype(F32)   # d == 0 pairs
    return xs, pos, _words(rng, S, buckets, P)


def _inputs_nd(S, D, buckets, P, seed):
    rng = np.random.default_rng(seed)
    my_pos = np.cumsum(rng.integers(0, 3, S)).astype(F32)
    # coincident coordinates (mag^2 == 0 with delta == 0), and deltas
    # whose squares underflow (mag^2 == 0 with delta != 0)
    my_c = rng.integers(-2, 3, (D, S)).astype(F32)
    my_c[:, ::3] += (rng.standard_normal((D, len(my_c[0, ::3]))) * 50).astype(F32)
    my_c[:, 4::5] = (rng.standard_normal((D, len(my_c[0, 4::5]))) * 1e-25).astype(F32)
    return my_pos, _words(rng, S, buckets, P), my_c


# k = 1 .. past the small tile, and one bucket past the end (k >= S)
BUCKETS = [(1, 0), (2, 1), (3, 2), (7, 5), (9, 6), (23, 9), (40, 11),
           (130, 12), (250, 13)]
S_MODEL = 201        # not a multiple of either tile


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("P", [1, 4, 5, 12, 16])
def test_bucket_pair_table_order_equals_plain_version(P, tile):
    xs, pos, words = _inputs_1d(S_MODEL, BUCKETS, P, seed=P)
    d_m, c_m = model_bucket_apply(xs, pos, words, 0.9, BUCKETS, P, tile)
    d_r, c_r = bucket_apply_ref(*_torch(xs, pos), _torch(*words), 0.9,
                                BUCKETS, P)
    assert c_r.sum() > 0 and (d_r != 0).sum() > S_MODEL // 2
    assert torch.equal(torch.from_numpy(c_m), c_r)
    assert torch.equal(torch.from_numpy(d_m), d_r)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("D,P", [(1, 1), (1, 12), (2, 1), (2, 8), (3, 4),
                                 (3, 5), (8, 16), (8, 1)])
def test_nd_pair_table_order_equals_plain_version(D, P, tile):
    my_pos, words, my_c = _inputs_nd(S_MODEL, D, BUCKETS, P, seed=10 * D + P)
    a_m, w_m = model_dense_apply_nd(my_pos, words, my_c, 0.9, BUCKETS, P,
                                    tile)
    a_r, w_r = dense_apply_nd_ref(*_torch(my_pos), _torch(*words),
                                  *_torch(my_c), 0.9, BUCKETS, P)
    assert w_r.sum() > 0
    assert torch.equal(torch.from_numpy(w_m), w_r)
    assert torch.equal(torch.from_numpy(a_m), a_r)


@pytest.mark.parametrize("P", [5, 9])
def test_unused_fields_are_masked(P):
    """pack_choices leaves the unused fields of the last word 0, which
    equals ki = 0: without the field mask the count is wrong."""
    buckets = [(1, 0), (3, 2), (12, 4)]
    xs, pos, words = _inputs_1d(S_MODEL, buckets, P, seed=100 + P)
    last = words[-1].view(np.uint32)
    assert ((last >> np.uint32(8 * (P % 4))) == 0).all()   # zero fields
    d_r, c_r = bucket_apply_ref(*_torch(xs, pos), _torch(*words), 0.9,
                                buckets, P)
    d_m, c_m = model_bucket_apply(xs, pos, words, 0.9, buckets, P, 16)
    assert torch.equal(torch.from_numpy(c_m), c_r)
    assert torch.equal(torch.from_numpy(d_m), d_r)
    _, c_x = model_bucket_apply(xs, pos, words, 0.9, buckets, P, 16,
                                mask=False)
    assert not np.array_equal(c_x, c_m)

    my_pos, words, my_c = _inputs_nd(S_MODEL, 2, buckets, P, seed=200 + P)
    a_r, w_r = dense_apply_nd_ref(*_torch(my_pos), _torch(*words),
                                  *_torch(my_c), 0.9, buckets, P)
    a_m, w_m = model_dense_apply_nd(my_pos, words, my_c, 0.9, buckets, P, 16)
    assert torch.equal(torch.from_numpy(w_m), w_r)
    assert torch.equal(torch.from_numpy(a_m), a_r)
    _, w_x = model_dense_apply_nd(my_pos, words, my_c, 0.9, buckets, P, 16,
                                  mask=False)
    assert not np.array_equal(w_x, w_m)


def test_inputs_hit_every_guard():
    """The model's inputs contain dx == 0, d == 0 and mag^2 == 0 pairs
    (with delta == 0 and with underflowing deltas) at a tabled k."""
    xs, pos, _ = _inputs_1d(S_MODEL, BUCKETS, 1, seed=1)
    assert (xs[:-1] == xs[1:]).any() and (xs[:-9] == xs[9:]).any()
    assert (pos[:-1] == pos[1:]).any()
    _, _, c = _inputs_nd(S_MODEL, 2, BUCKETS, 1, seed=21)
    delta = c[:, :-5] - c[:, 5:]
    mag2 = delta[0] * delta[0] + delta[1] * delta[1]
    assert ((mag2 == 0) & (delta == 0).all(0)).any()
    assert ((mag2 == 0) & (delta != 0).any(0)).any()


def test_byte_test_marks_exactly_the_unequal_fields():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 32, 100_000, dtype=np.uint64).astype(np.uint32)
    b = a.copy()
    flip = rng.integers(0, 4, a.shape)
    b ^= np.left_shift(np.uint32(1), (8 * flip + rng.integers(0, 8, a.shape))
                       .astype(np.uint32))
    b[::3] = a[::3]
    got = _byte_ne(a, b)
    for f in range(4):
        differ = ((a >> (8 * f)) & 0xFF) != ((b >> (8 * f)) & 0xFF)
        np.testing.assert_array_equal((got >> (8 * f + 7)) & 1, differ)


def test_weight_is_the_number_of_hits():
    """The byte-summed count and its 2^23 conversion, against a plain
    count of the hitting fields, for every P and both signs' fields."""
    rng = np.random.default_rng(1)
    for P in range(2, 17):
        n_words = -(-P // 4)
        fields = rng.choice(np.array([0, 5, ~5, 127, ~0, 3], np.int32),
                            (2, P, 5000))
        words = [[w.numpy() for w in pack_choices_words(
            [torch.from_numpy(f) for f in side])] for side in fields]
        assert len(words[0]) == n_words
        want = ((fields[0] == 5) | (fields[1] == ~5)).sum(0).astype(F32)
        np.testing.assert_array_equal(_weight(words[0], words[1], 5, P), want)
