"""The roll-pass-and-combine kernel (``csrc/roll_apply.cu``), modelled in
numpy step by step and held bit for bit to its plain versions
``roll_apply_ref`` / ``roll_apply_nd_ref``; and the dispatchers of the
sweep's kernels: ``roll_apply``, ``roll_apply_nd`` and the sampler's
``sweep_common.sample_words``.

The model follows the kernels: each step reads its partners directly at
(t + k) mod S and (t - k) mod S for every roll bucket, formed as the
kernels form them from k mod S (the ahead guard t + k < S as t < S - k,
never where k >= S), counts a pair's matching choices a packed word at
a time (a carry-free zero-byte test of the word XOR the broadcast byte
of ki or ~ki, the partner's mask where the guard holds, the unused
fields of the last word masked off, one popcount; the raw choice for
P = 1), guards the wrap-around on the partner's choice only, evaluates
every pair in full, sums per bucket ``acc + u1 + u2`` from the bucket
kernel's sums (or +0), and combines.  The plain versions are held to the
unjitted JAX sweeps by tests/test_torch_sweep.py and
tests/test_torch_sweep_nd.py.  The kernel itself runs only on the card
(tests/test_torch_cuda.py).

The same models run in double for the f64 route, where every bucket of
a phase is a roll bucket: the ops in the same order, the constants and
eta in f64, and the nD 1 / sqrt correctly rounded in f64.  The f64
kernels evaluate each pair of a short bucket once, from a staged tile:
``model_roll_1d_tiled`` / ``model_roll_nd_tiled`` model that order with
small tiles and short limits and are held to the plain versions through
an int64 view; ``test_pair_identities`` holds the identities it rests
on."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gfasort_tpu_torch import kernels  # noqa: E402
from gfasort_tpu_torch.bench_util import synthetic_path_index  # noqa: E402
from gfasort_tpu_torch.ops import sweep_common as tsc  # noqa: E402
from gfasort_tpu_torch.ops.keys import (fold_in, key_data,  # noqa: E402
                                        threefry_key_table)
from gfasort_tpu_torch.ops.roll_apply import (roll_apply,  # noqa: E402
                                              roll_apply_nd,
                                              roll_apply_nd_ref,
                                              roll_apply_ref)
from gfasort_tpu_torch.ops.sweep_dense import (bucket_apply_ref,  # noqa: E402
                                               dense_apply_nd_ref)
from gfasort_tpu_torch.ops.sweep_plan import make_sweep_plan  # noqa: E402
from gfasort_tpu_torch.params import PathSGDParams  # noqa: E402

F32 = np.float32
U32 = np.uint32
ETA = 0.9


def _fields(words, P):
    """Signed choice of each proposal, as the kernel reads it."""
    if P == 1:
        return [words[0].astype(np.int64)]
    return [((words[p // 4].view(np.uint32) >> np.uint32(8 * (p % 4)))
             & np.uint32(0xFF)).astype(np.int8).astype(np.int64)
            for p in range(P)]


def _weight(fields, t, j, mine, theirs, guard):
    """The plain count, field by field (field p of word p / 4)."""
    n = np.zeros(t.shape, np.int64)
    for f in fields:
        n += (f == mine) | (guard & (f[j] == theirs))
    return n.astype(F32)


def _eq_fields(w, b4, live):
    """0x80 in each 8-bit field of ``w`` equal to the broadcast byte
    ``b4``, within ``live`` (the kernels' carry-free zero-byte test)."""
    v = w ^ b4
    return ~(((v & U32(0x7F7F7F7F)) + U32(0x7F7F7F7F)) | v) & live


def _weight_words(words, P, j, mine, theirs, guard, fdt=F32):
    """The kernels' count, a packed word at a time (the raw choices
    for P = 1): ``mine`` / ``theirs`` are the signed choices compared
    with my own and the partner's; the count as a float of ``fdt``."""
    if P == 1:
        w = words[0]
        return ((w == mine) | (guard & (w[j] == theirs))).astype(fdt)
    nw = len(words)
    used = P - 4 * (nw - 1)
    last_live = U32(0x80808080) >> U32(8 * (4 - used))
    b_mine = U32((mine & 0xFF) * 0x01010101)
    b_theirs = U32((theirs & 0xFF) * 0x01010101)
    g = np.where(guard, U32(0xFFFFFFFF), U32(0))
    m = np.zeros(len(words[0]), U32)
    for i, w in enumerate(words):
        w = w.view(U32)
        live = last_live if i == nw - 1 else U32(0x80808080)
        m |= (_eq_fields(w, b_mine, live)
              | (_eq_fields(w[j], b_theirs, live) & g)) >> U32(i)
    return np.bitwise_count(m).astype(fdt)


def _base(pa, pb, weight):
    fdt = pa.dtype.type
    d = np.abs(pa - pb)
    valid = d != 0
    w = np.where(valid, weight, fdt(0.0))
    safe = np.where(valid, d, fdt(1.0))
    mu = np.minimum(fdt(ETA) / safe, fdt(1.0))
    return w, safe, mu


def _sides(S, k):
    """Per side: (partner index, wrap guard, my wanted field sign), as the
    kernels form them in 32 bits from the host's k mod S and ahead limit
    S - k (0 where k >= S: no step has its partner ahead in the array)."""
    t = np.arange(S, dtype=np.int32)
    km = np.int32(k % S)
    ahead = np.int32(S - k if k < S else 0)
    ja = t + km
    ja = np.where(ja >= S, ja - S, ja)
    jb = np.where(t >= km, t - km, t - km + S)
    assert (ja == (t + k) % S).all() and (jb == (t - k) % S).all()
    return [(ja, t < ahead, +1), (jb, t >= k, -1)]


def model_roll_1d(xs, pos, words, buckets, P, dsum=None, csum=None):
    """In the dtype of ``xs`` (f32, or f64 on the f64 route)."""
    fdt = xs.dtype.type
    S = len(xs)
    dsum = np.zeros(S, fdt) if dsum is None else dsum.copy()
    csum = np.zeros(S, fdt) if csum is None else csum.copy()
    for k, ki in buckets:
        sides = _sides(S, k)
        upd = []
        for j, guard, sgn in sides:
            mine, theirs = (ki, ~ki) if sgn > 0 else (~ki, ki)
            w, safe, mu = _base(pos, pos[j], _weight_words(
                words, P, j, mine, theirs, guard, fdt))
            dx = xs - xs[j]
            dx = np.where(dx == 0, fdt(1e-9), dx)
            r = (mu * (np.abs(dx) - safe)) * np.where(dx >= 0, fdt(0.5),
                                                      fdt(-0.5))
            upd.append(((-w) * r, w))
        dsum = (dsum + upd[0][0]) + upd[1][0]
        csum = (csum + upd[0][1]) + upd[1][1]
    return xs + dsum / np.maximum(csum, fdt(1.0))


def model_roll_nd(my_pos, my_c, lane0, cs, words, buckets, P, acc=None,
                  wacc=None):
    """In the dtype of ``my_pos`` (f32, or f64 on the f64 route)."""
    fdt = my_pos.dtype.type
    D, S = my_c.shape
    acc = np.zeros((D, S), fdt) if acc is None else acc.copy()
    wacc = np.zeros(S, fdt) if wacc is None else wacc.copy()
    for k, ki in buckets:
        sides = _sides(S, k)
        upd = []
        for j, guard, sgn in sides:
            mine, theirs = (ki, ~ki) if sgn > 0 else (~ki, ki)
            w, safe, mu = _base(my_pos, my_pos[j], _weight_words(
                words, P, j, mine, theirs, guard, fdt))
            delta = my_c - my_c[:, j]
            mag2 = delta[0] * delta[0]
            for d in range(1, D):
                mag2 = mag2 + delta[d] * delta[d]
            zero = mag2 == 0
            delta[0] = np.where(zero, fdt(1e-9), delta[0])
            mag2 = np.where(zero, fdt(1e-18), mag2)
            inv = fdt(1.0) / np.sqrt(mag2)
            r = ((mu * (mag2 * inv - safe)) * fdt(0.5)) * inv
            r = np.where(r > fdt(1e30), fdt(1e30), r)
            upd.append((-(w * r) * delta, w))
        acc = (acc + upd[0][0]) + upd[1][0]
        wacc = (wacc + upd[0][1]) + upd[1][1]
    u = acc / np.maximum(wacc, fdt(1.0))
    return np.concatenate([cs[:D] + np.where(lane0, u, fdt(0.0)),
                           cs[D:] + np.where(lane0, fdt(0.0), u)])


@pytest.fixture(scope="module")
def workload():
    pidx = synthetic_path_index(5000, 4, 5000, seed=13)
    p = replace(PathSGDParams().derive_from_graph(pidx), dtype="float32",
                pow_mode="fast")
    return pidx, p


def _real_words(pidx, phase, P, seed):
    """The sampler's words for ``phase`` (choices in-path)."""
    consts = tsc.sampler_consts(phase, False, "cpu")
    words, coin = tsc.sample_words(
        consts, fold_in(key_data(seed), np.arange(P)), False,
        torch.from_numpy(pidx.step_rank.astype(np.int32)),
        torch.from_numpy(pidx.step_count_of_step.astype(np.int32)), 1.0,
        coin=True)
    return [w.numpy() for w in words], coin.numpy()


def _random_words(rng, S, buckets, P):
    """Choices with no contract: every bucket's ki and ~ki, foreign
    indices and INACTIVE, also where the partner lies past an end, so
    that the wrap-around guard decides."""
    kis = [ki for _, ki in buckets]
    pool = np.array(kis + [~ki for ki in kis] + [int(tsc.INACTIVE), 3, ~2],
                    np.int32)
    sidxs = [torch.from_numpy(pool[rng.integers(0, len(pool), S)])
             for _ in range(P)]
    return [w.numpy() for w in tsc.pack_words(sidxs)]


def _state(rng, pidx, ties: bool):
    S = pidx.total_steps
    xs = (rng.standard_normal(S) * 100).astype(F32)
    if ties:   # dx == 0 and d == 0 guards
        xs[rng.integers(0, S, S // 8)] = F32(5.0)
        pos = np.cumsum(rng.integers(0, 3, S)).astype(F32)
    else:
        pos = pidx.step_pos.astype(F32)
    return xs, pos


def _case_buckets(pidx, p, P, kernel: bool):
    """(kernel buckets, roll buckets) of plan phases 0 and 1: the split
    at KMAX (with a kernel) or every bucket a roll bucket."""
    plan = make_sweep_plan(pidx, p, per_octave=2, dense_upto=4, rotate=4,
                           proposals=P, active_frac=1.0)
    out = []
    for phase in plan.phases[:2]:
        kb, rb = phase.kernel_buckets, phase.roll_buckets
        if not kernel:
            kb, rb = (), tuple(sorted(kb + rb, key=lambda b: b[1]))
        assert rb, "the phase has no roll bucket"
        out.append((phase, kb, rb))
    return out


CASES_1D = [(P, kernel, words)
            for P in (12, 1) for kernel in (True, False)
            for words in ("sampler", "random")]


@pytest.mark.parametrize("P,kernel,words", CASES_1D)
def test_model_equals_roll_apply_ref_1d(workload, P, kernel, words):
    pidx, p = workload
    rng = np.random.default_rng(P + 2 * kernel)
    S = pidx.total_steps
    for phase, kb, rb in _case_buckets(pidx, p, P, kernel):
        xs, pos = _state(rng, pidx, ties=words == "random")
        w = (_real_words(pidx, phase, P, 5)[0] if words == "sampler"
             else _random_words(rng, S, kb + rb, P))
        if words == "random":   # an offset past the array: k mod S
            rb = rb + ((S + 7, rb[0][1]),)
        xs_t, pos_t = torch.from_numpy(xs), torch.from_numpy(pos)
        w_t = [torch.from_numpy(x) for x in w]
        dsum = csum = None
        if kb:
            dsum, csum = bucket_apply_ref(xs_t, pos_t, w_t, ETA, kb, P)
        want = roll_apply(xs_t, pos_t, w_t, ETA, rb, P, dsum, csum)
        got = model_roll_1d(xs, pos, w, rb, P,
                            None if dsum is None else dsum.numpy(),
                            None if csum is None else csum.numpy())
        assert want.dtype == torch.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.numpy().view(np.int32))


@pytest.mark.parametrize("guard", ["on", "off", "mixed"])
@pytest.mark.parametrize("P", [1, 4, 5, 8, 12, 16])
def test_word_count_equals_field_count(P, guard):
    """The kernels' word-wise count equals the per-field count on
    random words: every bucket index 0-63 (ki = 0 among them, which the
    unused fields of a last word hold), INACTIVE8 and negative fields
    present, the guard on, off and mixed."""
    S = 4096
    rng = np.random.default_rng(100 + P)
    pool = np.array(list(range(64)) + [~ki for ki in range(64)]
                    + [int(tsc.INACTIVE)] * 16, np.int32)
    sidxs = [torch.from_numpy(pool[rng.integers(0, len(pool), S)])
             for _ in range(P)]
    words = [w.numpy() for w in tsc.pack_words(sidxs)]
    fields = _fields(words, P)
    if P > 1:
        flat = np.concatenate(fields)
        assert (flat == int(tsc.INACTIVE8)).any() and (flat < 0).any()
    t = np.arange(S)
    j = rng.permutation(S)
    g = {"on": np.ones(S, bool), "off": np.zeros(S, bool),
         "mixed": rng.integers(0, 2, S).astype(bool)}[guard]
    for ki in (0, 1, 7, 63) if P > 1 else (0, 1, 7, 63, 1000):
        for mine, theirs in ((ki, ~ki), (~ki, ki)):
            np.testing.assert_array_equal(
                _weight_words(words, P, j, mine, theirs, g),
                _weight(fields, t, j, mine, theirs, g))


# the layout plans' (2, 8) and (3, 4), P = 1, the sharded 3D layout's
# two words (3, 8), and P = 5: three unused fields of 0 in the last word
CASES_ND = [(D, P, kernel, words)
            for D, P in ((2, 8), (3, 4), (2, 1), (3, 8), (2, 5), (3, 5))
            for kernel in (True, False) for words in ("sampler", "random")]


@pytest.mark.parametrize("D,P,kernel,words", CASES_ND)
def test_model_equals_roll_apply_nd_ref(workload, D, P, kernel, words):
    pidx, p = workload
    rng = np.random.default_rng(10 * D + P + kernel)
    S = pidx.total_steps
    for phase, kb, rb in _case_buckets(pidx, p, P, kernel):
        if P == 5:   # ki = 0 meets the unused fields; partners read mod S
            rb = rb + ((S // 2 + 123, 0), (S + 7, 0), (2 * S + 3, 0))
        _, pos = _state(rng, pidx, ties=words == "random")
        cs = (rng.standard_normal((2 * D, S)) * 50).astype(F32)
        if words == "random":   # coincident ends: mag^2 == 0
            cs[:, rng.integers(0, S, S // 8)] = F32(2.0)
            w = _random_words(rng, S, kb + rb, P)
            lane0 = rng.integers(0, 2, S).astype(bool)
        else:
            w, coin = _real_words(pidx, phase, P, 9)
            lane0 = coin ^ (rng.integers(0, 2, S) == 1)
        my_pos = pos + np.where(lane0, F32(0.0), F32(3.0))
        my_c = np.ascontiguousarray(np.where(lane0, cs[:D], cs[D:]))
        t = {n: torch.from_numpy(a) for n, a in
             (("my_pos", my_pos), ("my_c", my_c), ("lane0", lane0),
              ("cs", cs))}
        w_t = [torch.from_numpy(x) for x in w]
        acc = wacc = None
        if kb:
            acc, wacc = dense_apply_nd_ref(t["my_pos"], w_t, t["my_c"], ETA,
                                           kb, P)
        want = roll_apply_nd(t["my_pos"], t["my_c"], t["lane0"], t["cs"],
                             w_t, ETA, rb, P, acc, wacc)
        got = model_roll_nd(my_pos, my_c, lane0, cs, w, rb, P,
                            None if acc is None else acc.numpy(),
                            None if wacc is None else wacc.numpy())
        assert want.shape == (2 * D, S)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.numpy().view(np.int32))


def test_no_roll_bucket_is_the_combine_alone():
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.standard_normal(300).astype(F32))
    pos = torch.arange(300, dtype=torch.float32)
    words = [torch.full((300,), int(tsc.PACKED_INACTIVE), dtype=torch.int32)]
    dsum = torch.from_numpy(rng.standard_normal(300).astype(F32))
    csum = torch.from_numpy(rng.integers(0, 3, 300).astype(F32))
    out = roll_apply(xs, pos, words, ETA, (), 4, dsum, csum)
    assert torch.equal(out, xs + dsum / torch.clamp_min(csum, 1.0))
    # no bucket at all: xs + 0 (a -0 becomes +0, as in the engines)
    xs[0] = -0.0
    out = roll_apply(xs, pos, words, ETA, (), 4)
    assert torch.equal(out, xs + 0.0) and not torch.signbit(out[0])


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it reaches a dispatcher's
    kernel branch without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _failing_build(monkeypatch, tmp_path):
    """Every kernel wrapper builds the library afresh, into an empty
    directory, with no CUDA compiler: the build raises."""
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(kernels, "_BUILD", tmp_path / "_build")
    monkeypatch.setattr(kernels, "nvcc_path", no_nvcc)
    monkeypatch.setattr(kernels, "library", lambda: kernels.build())


def test_roll_apply_dispatch(monkeypatch, tmp_path):
    S, P = 500, 4
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.standard_normal(S).astype(F32))
    pos = torch.arange(S, dtype=torch.float32)
    words = [torch.from_numpy(w) for w in
             _random_words(rng, S, [(3, 0), (40, 1)], P)]
    before = roll_apply.launches
    out = roll_apply(xs, pos, words, ETA, [(40, 1)], P)
    assert roll_apply.launches == before
    assert torch.equal(out, roll_apply_ref(xs, pos, words, ETA, [(40, 1)], P))
    with pytest.raises(ValueError):   # 4 proposals ride one word
        roll_apply(xs, pos, words * 2, ETA, [(40, 1)], P)
    with pytest.raises(ValueError):   # packed fields need ki < 64
        roll_apply(xs, pos, words, ETA, [(40, 64)], P)
    with pytest.raises(ValueError):
        roll_apply(xs, pos, words, ETA, [(40, 1)], P, dsum=xs)
    with pytest.raises(ValueError):
        roll_apply(xs, pos.double(), words, ETA, [(40, 1)], P)
    meta = torch.empty(S, device="meta")
    with pytest.raises(ValueError):   # no silent fallback off cpu/cuda
        roll_apply(meta, meta, [torch.empty(S, dtype=torch.int32,
                                            device="meta")], ETA, [(40, 1)], P)
    # on a CUDA tensor the kernel is built or the call raises
    _failing_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        roll_apply(xs.as_subclass(_FakeCuda), pos.as_subclass(_FakeCuda),
                   [w.as_subclass(_FakeCuda) for w in words], ETA, [(40, 1)],
                   P)
    assert roll_apply.launches == before


def test_roll_apply_nd_dispatch(monkeypatch, tmp_path):
    S, P, D = 500, 4, 2
    rng = np.random.default_rng(5)
    my_pos = torch.arange(S, dtype=torch.float32)
    cs = torch.from_numpy(rng.standard_normal((2 * D, S)).astype(F32))
    lane0 = torch.from_numpy(rng.integers(0, 2, S).astype(bool))
    my_c = torch.where(lane0, cs[:D], cs[D:]).contiguous()
    words = [torch.from_numpy(w) for w in
             _random_words(rng, S, [(3, 0), (40, 1)], P)]
    args = (my_pos, my_c, lane0, cs, words, ETA, [(40, 1)], P)
    before = roll_apply_nd.launches
    out = roll_apply_nd(*args)
    assert roll_apply_nd.launches == before
    assert torch.equal(out, roll_apply_nd_ref(*args))
    with pytest.raises(ValueError):
        roll_apply_nd(my_pos, my_c, lane0.int(), *args[3:])
    with pytest.raises(ValueError):
        roll_apply_nd(my_pos, my_c, lane0, cs[:D], *args[4:])
    with pytest.raises(ValueError):
        roll_apply_nd(*args, acc=my_c)
    meta = torch.empty(S, device="meta")
    with pytest.raises(ValueError):   # no silent fallback off cpu/cuda
        roll_apply_nd(meta, torch.empty(D, S, device="meta"),
                      torch.empty(S, dtype=torch.bool, device="meta"),
                      torch.empty(2 * D, S, device="meta"),
                      [torch.empty(S, dtype=torch.int32, device="meta")],
                      ETA, [(40, 1)], P)
    _failing_build(monkeypatch, tmp_path)
    fake = [a.as_subclass(_FakeCuda) for a in (my_pos, my_c, lane0, cs)]
    with pytest.raises(RuntimeError, match="nvcc"):
        roll_apply_nd(*fake, [w.as_subclass(_FakeCuda) for w in words], ETA,
                      [(40, 1)], P)
    assert roll_apply_nd.launches == before


def test_sample_words_dispatch(workload, monkeypatch, tmp_path):
    pidx, p = workload
    phase = make_sweep_plan(pidx, p, per_octave=2, dense_upto=4, rotate=4,
                            proposals=8, active_frac=1.0).phases[0]
    consts = tsc.sampler_consts(phase, False, "cpu")
    key_words = fold_in(key_data(7), np.arange(8))
    rank = torch.from_numpy(pidx.step_rank.astype(np.int32))
    cnt = torch.from_numpy(pidx.step_count_of_step.astype(np.int32))
    before = tsc.sample_words.launches
    words, coin = tsc.sample_words(consts, key_words, False, rank, cnt, 1.0)
    assert coin is None and tsc.sample_words.launches == before
    ref, _ = tsc.sample_words_ref(consts, key_words, False, rank, cnt, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(words, ref))
    with pytest.raises(ValueError):   # no silent fallback off cpu/cuda
        meta = torch.empty(len(rank), dtype=torch.int32, device="meta")
        tsc.sample_words(consts, key_words, False, meta, meta, 1.0)
    with pytest.raises(ValueError):
        tsc.sample_words(consts, key_words, False, rank.long(), cnt, 1.0)
    with pytest.raises(ValueError):
        tsc.sample_words(consts, key_words, False, rank, cnt, 1.0, snap="up")
    with pytest.raises(ValueError):   # the f64 route takes threefry keys
        c64 = tsc.sampler_consts(phase, False, "cpu", torch.float64)
        tsc.sample_words(c64, key_words, False, rank, cnt, 1.0)
    # on a CUDA tensor the kernel is built or the call raises: a failed
    # build is never answered by the plain version
    _failing_build(monkeypatch, tmp_path)
    fake = replace(consts, offs=consts.offs.as_subclass(_FakeCuda))
    with pytest.raises(RuntimeError, match="nvcc"):
        tsc.sample_words(fake, key_words, False, rank.as_subclass(_FakeCuda),
                         cnt.as_subclass(_FakeCuda), 1.0)
    assert tsc.sample_words.launches == before


# ---- the f64 route: every bucket a roll bucket ----------------------------

F64 = np.float64
# P = 5 with far buckets at ki = 0: the last word's three unused fields,
# partners read mod S
CASES_1D_F64 = [(P, words) for P in (12, 5, 1)
                for words in ("sampler", "random")]
CASES_ND_F64 = [(D, P, words)
                for D, P in ((2, 8), (3, 4), (2, 1), (3, 8), (2, 5), (3, 5))
                for words in ("sampler", "random")]


def _f64_phases(pidx, p, P):
    """Plan phases 0 and 1 of the f64 plan: every bucket a roll bucket."""
    plan = make_sweep_plan(pidx, replace(p, dtype="float64"), per_octave=2,
                           dense_upto=4, rotate=4, proposals=P,
                           active_frac=1.0)
    for phase in plan.phases[:2]:
        assert not phase.kernel_buckets and phase.roll_buckets
        yield phase


def _f64_words(pidx, phase, P, seed):
    """The f64 sampler's words (threefry draws) and end coin."""
    consts = tsc.sampler_consts(phase, False, "cpu", torch.float64)
    words, coin = tsc.sample_words(
        consts, threefry_key_table(fold_in(key_data(seed), np.arange(P))),
        False, torch.from_numpy(pidx.step_rank.astype(np.int32)),
        torch.from_numpy(pidx.step_count_of_step.astype(np.int32)), 1.0,
        coin=True)
    return [w.numpy() for w in words], coin.numpy()


def _edge_buckets(rb, S, P):
    return rb + ((S // 2 + 123, 0), (S + 7, 0), (2 * S + 3, 0)) if P == 5 else rb


@pytest.mark.parametrize("P,words", CASES_1D_F64)
def test_model_equals_roll_apply_ref_1d_f64(workload, P, words):
    pidx, p = workload
    rng = np.random.default_rng(50 + P)
    S = pidx.total_steps
    for phase in _f64_phases(pidx, p, P):
        rb = _edge_buckets(phase.roll_buckets, S, P)
        xs = rng.standard_normal(S) * 100
        if words == "random":   # dx == 0 and d == 0 guards
            xs[rng.integers(0, S, S // 8)] = 5.0
            pos = np.cumsum(rng.integers(0, 3, S)).astype(F64)
            w = _random_words(rng, S, rb, P)
        else:
            pos = pidx.step_pos.astype(F64)
            w = _f64_words(pidx, phase, P, 5)[0]
        w_t = [torch.from_numpy(x) for x in w]
        want = roll_apply(torch.from_numpy(xs), torch.from_numpy(pos), w_t,
                          ETA, rb, P)
        assert want.dtype == torch.float64
        got = model_roll_1d(xs, pos, w, rb, P)
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.numpy().view(np.int64))


@pytest.mark.parametrize("D,P,words", CASES_ND_F64)
def test_model_equals_roll_apply_nd_ref_f64(workload, D, P, words):
    pidx, p = workload
    rng = np.random.default_rng(60 + 10 * D + P)
    S = pidx.total_steps
    for phase in _f64_phases(pidx, p, P):
        rb = _edge_buckets(phase.roll_buckets, S, P)
        cs = rng.standard_normal((2 * D, S)) * 50
        if words == "random":   # coincident ends: mag^2 == 0
            cs[:, rng.integers(0, S, S // 8)] = 2.0
            pos = np.cumsum(rng.integers(0, 3, S)).astype(F64)
            w = _random_words(rng, S, rb, P)
            lane0 = rng.integers(0, 2, S).astype(bool)
        else:
            pos = pidx.step_pos.astype(F64)
            w, coin = _f64_words(pidx, phase, P, 9)
            lane0 = coin ^ (rng.integers(0, 2, S) == 1)
        my_pos = pos + np.where(lane0, 0.0, 3.0)
        my_c = np.ascontiguousarray(np.where(lane0, cs[:D], cs[D:]))
        w_t = [torch.from_numpy(x) for x in w]
        want = roll_apply_nd(*(torch.from_numpy(a) for a in
                               (my_pos, my_c, lane0, cs)), w_t, ETA, rb, P)
        assert want.shape == (2 * D, S) and want.dtype == torch.float64
        got = model_roll_nd(my_pos, my_c, lane0, cs, w, rb, P)
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.numpy().view(np.int64))


def test_roll_apply_dispatch_f64(monkeypatch, tmp_path):
    S, P = 500, 5
    rng = np.random.default_rng(14)
    xs = torch.from_numpy(rng.standard_normal(S))
    pos = torch.arange(S, dtype=torch.float64)
    words = [torch.from_numpy(w) for w in
             _random_words(rng, S, [(3, 0), (40, 1)], P)]
    before = roll_apply.launches
    out = roll_apply(xs, pos, words, ETA, [(3, 0), (40, 1)], P)
    assert roll_apply.launches == before and out.dtype == torch.float64
    assert torch.equal(out, roll_apply_ref(xs, pos, words, ETA,
                                           [(3, 0), (40, 1)], P))
    meta = torch.empty(S, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):   # no silent fallback off cpu/cuda
        roll_apply(meta, meta, [torch.empty(S, dtype=torch.int32,
                                            device="meta")] * 2, ETA,
                   [(40, 1)], P)
    _failing_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        roll_apply(xs.as_subclass(_FakeCuda), pos.as_subclass(_FakeCuda),
                   [w.as_subclass(_FakeCuda) for w in words], ETA, [(40, 1)],
                   P)
    assert roll_apply.launches == before


def test_roll_apply_nd_dispatch_f64(monkeypatch, tmp_path):
    S, P, D = 500, 8, 3
    rng = np.random.default_rng(15)
    my_pos = torch.arange(S, dtype=torch.float64)
    cs = torch.from_numpy(rng.standard_normal((2 * D, S)))
    lane0 = torch.from_numpy(rng.integers(0, 2, S).astype(bool))
    my_c = torch.where(lane0, cs[:D], cs[D:]).contiguous()
    words = [torch.from_numpy(w) for w in
             _random_words(rng, S, [(3, 0), (40, 1)], P)]
    args = (my_pos, my_c, lane0, cs, words, ETA, [(3, 0), (40, 1)], P)
    before = roll_apply_nd.launches
    out = roll_apply_nd(*args)
    assert roll_apply_nd.launches == before and out.dtype == torch.float64
    assert torch.equal(out, roll_apply_nd_ref(*args))
    with pytest.raises(ValueError):   # one dtype throughout
        roll_apply_nd(my_pos, my_c.float(), *args[2:])
    with pytest.raises(ValueError):   # no silent fallback off cpu/cuda
        roll_apply_nd(torch.empty(S, dtype=torch.float64, device="meta"),
                      torch.empty(D, S, dtype=torch.float64, device="meta"),
                      torch.empty(S, dtype=torch.bool, device="meta"),
                      torch.empty(2 * D, S, dtype=torch.float64,
                                  device="meta"),
                      [torch.empty(S, dtype=torch.int32, device="meta")] * 2,
                      ETA, [(40, 1)], P)
    _failing_build(monkeypatch, tmp_path)
    fake = [a.as_subclass(_FakeCuda) for a in (my_pos, my_c, lane0, cs)]
    with pytest.raises(RuntimeError, match="nvcc"):
        roll_apply_nd(*fake, [w.as_subclass(_FakeCuda) for w in words], ETA,
                      [(40, 1)], P)
    assert roll_apply_nd.launches == before


@pytest.mark.parametrize("route", ["threefry_f32", "f64"])
def test_sample_words_dispatch_threefry(workload, monkeypatch, tmp_path,
                                        route):
    """The threefry routes through the dispatcher: a CPU tensor runs the
    plain version (from the ``threefry_key_table`` rows), a hash key row
    or a ``meta`` tensor raises, and a CUDA tensor reaches the kernel's
    build, which raises with no ``nvcc``."""
    pidx, p = workload
    phase = make_sweep_plan(pidx, p, per_octave=2, dense_upto=4, rotate=4,
                            proposals=8, active_frac=1.0).phases[0]
    dtype, rng = ((torch.float32, "threefry") if route == "threefry_f32"
                  else (torch.float64, "hash"))
    consts = tsc.sampler_consts(phase, True, "cpu", dtype)
    hash_rows = fold_in(key_data(7), np.arange(8))
    rows = threefry_key_table(hash_rows)
    rank = torch.from_numpy(pidx.step_rank.astype(np.int32))
    cnt = torch.from_numpy(pidx.step_count_of_step.astype(np.int32))
    before = tsc.sample_words.launches
    words, coin = tsc.sample_words(consts, rows, True, rank, cnt, 0.6,
                                   "down", rng, coin=True)
    assert tsc.sample_words.launches == before
    ref, ref_coin = tsc.sample_words_ref(consts, rows, True, rank, cnt, 0.6,
                                         "down", rng, coin=True)
    assert all(torch.equal(a, b) for a, b in zip(words, ref))
    assert torch.equal(coin, ref_coin)
    # the plain route's per-sweep split gives the same draws
    draws = [tsc.sweep_rng(w, len(rank), "cpu", rng, dtype) for w in hash_rows]
    sidxs = tsc.sample_blocks(consts, draws, True, rank, cnt, 0.6, "down")
    assert all(torch.equal(a, b) for a, b in zip(words, tsc.pack_words(sidxs)))
    with pytest.raises(ValueError):   # threefry draws take (k1, k2) rows
        tsc.sample_words(consts, hash_rows, True, rank, cnt, 0.6, "down", rng)
    with pytest.raises(ValueError):
        tsc.sample_words(consts, rows, True, rank, cnt, 0.6, "down", "philox")
    with pytest.raises(ValueError):   # no silent fallback off cpu/cuda
        meta = torch.empty(len(rank), dtype=torch.int32, device="meta")
        tsc.sample_words(consts, rows, True, meta, meta, 0.6, "down", rng)
    _failing_build(monkeypatch, tmp_path)
    fake = replace(consts, offs=consts.offs.as_subclass(_FakeCuda))
    with pytest.raises(RuntimeError, match="nvcc"):
        tsc.sample_words(fake, rows, True, rank.as_subclass(_FakeCuda),
                         cnt.as_subclass(_FakeCuda), 0.6, "down", rng)
    assert tsc.sample_words.launches == before


# ---- the f64 kernels' tiles: each short-offset pair evaluated once --------
#
# The f64 kernels (roll_apply_kernel_tiled, roll_apply_nd_kernel_tiled)
# give a block the steps [t0, t0 + T) and run the leading buckets with
# k <= KT (the short prefix) from shared memory: the steps
# [t0 - h, t0 + T + h), each taken mod S (h: the prefix's largest k), are
# staged once; per short bucket, pair j in [0, T + k) (ends a = t0 + j - k
# and a + k, staged at h - k + j and h + j) is evaluated once into a
# table, both ends' weights (the wrap guard a mod S < S - k is the same at
# both ends) and, in 1D, both ends' updates; in nD its r and whether
# mag^2 == 0, step t then forming its own delta.  Step t takes pair
# t - t0 + k's first end and pair t - t0's second, and the long buckets
# follow as in the f32 kernels.  The kernels run T = 128, KT = 64; the
# model takes both as parameters.


def _short_prefix(buckets, KT):
    n = 0
    while n < len(buckets) and buckets[n][0] <= KT:
        n += 1
    return n, max((k for k, _ in buckets[:n]), default=0)


def _pair_weights(sw, la, lb, P, ki, guard):
    """Both ends' weights of the pairs (la, lb) from the staged words:
    end a counts the proposals whose field at a is ki or, where the
    guard holds, whose field at b is ~ki; end b the converse."""
    if P == 1:
        a, b = sw[0][la] == ki, sw[0][lb] == ~ki
        return (a | (guard & b)).astype(np.int64), (b | (guard & a)).astype(np.int64)
    nw = len(sw)
    last_live = U32(0x80808080) >> U32(8 * (4 - (P - 4 * (nw - 1))))
    plus, minus = U32((ki & 0xFF) * 0x01010101), U32((~ki & 0xFF) * 0x01010101)
    ma = np.zeros(len(la), U32)
    mb = np.zeros(len(la), U32)
    for i, w in enumerate(sw):
        w = w.view(U32)
        live = last_live if i == nw - 1 else U32(0x80808080)
        ma |= _eq_fields(w[la], plus, live) >> U32(i)
        mb |= _eq_fields(w[lb], minus, live) >> U32(i)
    g = np.where(guard, U32(0xFFFFFFFF), U32(0))
    return (np.bitwise_count(ma | (mb & g)).astype(np.int64),
            np.bitwise_count(mb | (ma & g)).astype(np.int64))


def _tile_pairs(S, t0, T, h, k, ki, sw, sp, P, fast):
    """The short bucket (k, ki)'s pairs of the tile at t0: staged ends,
    both ends' weights (0 where d == 0), valid, safe and mu.  The guard
    as the kernels take it: where S >= T + 2 KT (``fast``) the pair (a,
    a + k) wraps exactly where a < 0 or a + k >= S (a >= S only for
    pairs no step in [0, S) takes), else a mod S < S - k."""
    j = np.arange(T + k)
    la, lb = h - k + j, h + j
    a = t0 + j - k
    guard = ((a >= 0) & (a + k < S) if fast
             else np.mod(a, S) < (S - k if k < S else 0))
    na, nb = _pair_weights(sw, la, lb, P, ki, guard)
    d = np.abs(sp[la] - sp[lb])
    valid = d != 0
    safe = np.where(valid, d, 1.0)
    mu = np.minimum(F64(ETA) / safe, 1.0)
    return (la, lb, np.where(valid, na, 0).astype(F64),
            np.where(valid, nb, 0).astype(F64), safe, mu)


def model_roll_1d_tiled(xs, pos, words, buckets, P, T, KT):
    """The f64 1D kernel with tiles of T steps and short offsets
    k <= KT: the short prefix from the staged tiles, then the long
    buckets and the combine (``model_roll_1d``)."""
    S = len(xs)
    ns, h = _short_prefix(buckets, KT)
    dsum, csum = np.zeros(S), np.zeros(S)
    for t0 in range(0, S, T):
        g = np.mod(np.arange(t0 - h, t0 + T + h), S)
        sx, sp, sw = xs[g], pos[g], [w[g] for w in words]
        tl = np.arange(min(T, S - t0))   # the tile's steps in [0, S)
        ds, cs_ = dsum[t0:t0 + T], csum[t0:t0 + T]
        for k, ki in buckets[:ns]:
            la, lb, wa, wb, safe, mu = _tile_pairs(S, t0, T, h, k, ki, sw,
                                                   sp, P, S >= T + 2 * KT)
            dxa, dxb = sx[la] - sx[lb], sx[lb] - sx[la]
            dxa = np.where(dxa == 0, 1e-9, dxa)
            dxb = np.where(dxb == 0, 1e-9, dxb)
            q = mu * (np.abs(dxa) - safe)
            ua = (-wa) * (q * np.where(dxa >= 0, 0.5, -0.5))
            ub = (-wb) * (q * np.where(dxb >= 0, 0.5, -0.5))
            ds[:] = (ds + ua[tl + k]) + ub[tl]
            cs_[:] = (cs_ + wa[tl + k]) + wb[tl]
    return model_roll_1d(xs, pos, words, buckets[ns:], P, dsum, csum)


def model_roll_nd_tiled(my_pos, my_c, lane0, cs, words, buckets, P, T, KT):
    """The nD twin: the pair table holds r and mag^2 == 0; step t forms
    its own delta to the staged partner."""
    D, S = my_c.shape
    ns, h = _short_prefix(buckets, KT)
    acc, wacc = np.zeros((D, S)), np.zeros(S)
    for t0 in range(0, S, T):
        g = np.mod(np.arange(t0 - h, t0 + T + h), S)
        sc, sp, sw = my_c[:, g], my_pos[g], [w[g] for w in words]
        tl = np.arange(min(T, S - t0))
        c = sc[:, h + tl]
        ac, wc = acc[:, t0:t0 + T], wacc[t0:t0 + T]
        for k, ki in buckets[:ns]:
            la, lb, wa, wb, safe, mu = _tile_pairs(S, t0, T, h, k, ki, sw,
                                                   sp, P, S >= T + 2 * KT)
            delta = sc[:, la] - sc[:, lb]
            mag2 = delta[0] * delta[0]
            for d in range(1, D):
                mag2 = mag2 + delta[d] * delta[d]
            zero = mag2 == 0
            mag2 = np.where(zero, 1e-18, mag2)
            inv = 1.0 / np.sqrt(mag2)
            r = ((mu * (mag2 * inv - safe)) * 0.5) * inv
            r = np.where(r > 1e30, 1e30, r)
            d1 = c - sc[:, h + tl + k]
            d2 = c - sc[:, h + tl - k]
            d1[0] = np.where(zero[tl + k], 1e-9, d1[0])
            d2[0] = np.where(zero[tl], 1e-9, d2[0])
            w1, w2 = wa[tl + k], wb[tl]
            u1 = -(w1 * r[tl + k]) * d1
            u2 = -(w2 * r[tl]) * d2
            ac[:] = (ac + u1) + u2
            wc[:] = (wc + w1) + w2
    return model_roll_nd(my_pos, my_c, lane0, cs, words, buckets[ns:], P,
                         acc, wacc)


def _tiled_buckets(S, KT):
    """k < KT, k = KT and k > KT; a short bucket after a long one (it
    runs on the long path); k >= S, short where S <= KT."""
    return ((1, 0), (2, 1), (KT, 2), (KT - 1, 3), (KT + 1, 4), (3, 5),
            (S + 2, 6), (2 * S + 1, 7))


# (S, P): S not a multiple of T; S < T + 2 KT (and < KT: short k >= S);
# a multiple of T; the P = 1 raw choices and P = 5's unused fields
TILED_CASES = [(T, KT, S, P)
               for T, KT in ((8, 4), (16, 8), (8, 8), (16, 4))
               for S, P in ((37, 12), (5, 1), (23, 5), (64, 8))]


def _tiled_state(rng, S, D=None):
    """f64 state with repeated xs / coordinates (dx == 0, mag^2 == 0)
    and positions (d == 0)."""
    pos = np.cumsum(rng.integers(0, 3, S)).astype(F64)
    if D is None:
        xs = rng.standard_normal(S) * 100
        xs[rng.integers(0, S, max(S // 4, 1))] = 5.0
        return xs, pos
    cs = rng.standard_normal((2 * D, S)) * 50
    cs[:, rng.integers(0, S, max(S // 4, 1))] = 2.0
    return cs, pos


@pytest.mark.parametrize("T,KT,S,P", TILED_CASES)
def test_tiled_model_equals_roll_apply_ref_1d_f64(T, KT, S, P):
    rng = np.random.default_rng(S * T + KT + P)
    buckets = _tiled_buckets(S, KT)
    xs, pos = _tiled_state(rng, S)
    w = _random_words(rng, S, buckets, P)
    want = roll_apply_ref(torch.from_numpy(xs), torch.from_numpy(pos),
                          [torch.from_numpy(x) for x in w], ETA, buckets, P)
    got = model_roll_1d_tiled(xs, pos, w, buckets, P, T, KT)
    np.testing.assert_array_equal(got.view(np.int64),
                                  want.numpy().view(np.int64))


def _nd_tiled_case(rng, S, D, buckets, P, inf_at=None):
    cs, pos = _tiled_state(rng, S, D)
    if inf_at is not None:   # r is NaN there: it passes the 1e30 clamp
        cs[:, inf_at] = np.inf
    lane0 = rng.integers(0, 2, S).astype(bool)
    my_pos = pos + np.where(lane0, 0.0, 3.0)
    my_c = np.ascontiguousarray(np.where(lane0, cs[:D], cs[D:]))
    return my_pos, my_c, lane0, cs, _random_words(rng, S, buckets, P)


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("T,KT,S,P", TILED_CASES)
def test_tiled_model_equals_roll_apply_nd_ref_f64(T, KT, S, P, D):
    """In 2D and 3D; at S = 37 one step's coordinates are infinite, so
    that its pairs' r is NaN and passes the clamp at 1e30, as the plain
    version's ``clamp_max`` passes it (a finite r stays below 1)."""
    rng = np.random.default_rng(S * T + KT + P + D)
    buckets = _tiled_buckets(S, KT)
    args = _nd_tiled_case(rng, S, D, buckets, P,
                          inf_at=S // 2 if S == 37 else None)
    want = roll_apply_nd_ref(*(torch.from_numpy(a) for a in args[:4]),
                             [torch.from_numpy(x) for x in args[4]], ETA,
                             buckets, P)
    with np.errstate(invalid="ignore"):   # inf * 0 at the infinite step
        got = model_roll_nd_tiled(*args, buckets, P, T, KT)
    assert np.isnan(got).any() == (S == 37)
    np.testing.assert_array_equal(got.view(np.int64),
                                  want.numpy().view(np.int64))


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_pair_identities(dims):
    """Every pair (t, t + k mod S) of a random case, evaluated from each
    end as the f32 kernels and the plain versions evaluate it: 1D r' =
    -r except where dx == 0 (both ends 1e-9, r' = r); nD r' = r and
    delta' = -delta except delta[0] where mag^2 == 0 (both ends 1e-9),
    so that with equal weights upd' = -upd but for that component."""
    rng = np.random.default_rng(70 + dims)
    S = 2000
    state, pos = _tiled_state(rng, S, None if dims == 1 else dims)
    t = np.arange(S)
    seen_tie = False
    for k in (1, 2, 7, 150, S - 1, S + 3):
        b = (t + k) % S
        d = np.abs(pos[t] - pos[b])
        assert (d == np.abs(pos[b] - pos[t])).all()
        safe = np.where(d != 0, d, 1.0)
        mu = np.minimum(F64(ETA) / safe, 1.0)
        if dims == 1:
            def r_of(a, o):
                dx = state[a] - state[o]
                dx = np.where(dx == 0, 1e-9, dx)
                return (mu * (np.abs(dx) - safe)) * np.where(dx >= 0, 0.5,
                                                             -0.5)
            ra, rb = r_of(t, b), r_of(b, t)
            tie = state[t] == state[b]
            np.testing.assert_array_equal(rb[~tie], -ra[~tie])
            np.testing.assert_array_equal(rb[tie], ra[tie])
            seen_tie |= tie.any()
            continue
        c = state[:dims]

        def end(a, o):
            delta = c[:, a] - c[:, o]
            mag2 = delta[0] * delta[0]
            for i in range(1, dims):
                mag2 = mag2 + delta[i] * delta[i]
            zero = mag2 == 0
            delta[0] = np.where(zero, 1e-9, delta[0])
            mag2 = np.where(zero, 1e-18, mag2)
            inv = 1.0 / np.sqrt(mag2)
            r = ((mu * (mag2 * inv - safe)) * 0.5) * inv
            r = np.where(r > 1e30, 1e30, r)
            return r, delta, zero, (-(1.0 * r)) * delta
        ra, da, za, ua = end(t, b)
        rb, db, zb, ub = end(b, t)
        np.testing.assert_array_equal(ra.view(np.int64), rb.view(np.int64))
        np.testing.assert_array_equal(za, zb)
        np.testing.assert_array_equal(db[1:], -da[1:])
        np.testing.assert_array_equal(db[0][~za], -da[0][~za])
        np.testing.assert_array_equal(db[0][za], da[0][za])
        np.testing.assert_array_equal(ub[1:], -ua[1:])
        np.testing.assert_array_equal(ub[0][~za], -ua[0][~za])
        np.testing.assert_array_equal(ub[0][za], ua[0][za])
        seen_tie |= za.any()
    assert seen_tie
