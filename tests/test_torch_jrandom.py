"""Port parity: the ``jax.random`` draws the engines use — split, bits
(32 and 64), uniform (f32 and f64), randint and bernoulli — in numpy on
the host (``ops/keys.py``) and in torch on the CPU (``ops/jrandom.py``),
bit for bit against JAX's threefry defaults."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gfasort_tpu_torch.ops import jrandom  # noqa: E402
from gfasort_tpu_torch.ops import keys as K  # noqa: E402

SEEDS = [0, 42, 9399220, 2**31 - 1, 2**40 + 7]
SHAPES = [(1,), (1001,), (7, 33)]


def _keys(seed):
    """The same key as JAX's, as the port's numpy words and as a torch
    tensor: both forms are accepted by the torch draws."""
    kd = K.key_data(seed)
    return jax.random.key(seed), kd, torch.from_numpy(kd.astype(np.int64))


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_jax_defaults_are_the_ported_ones():
    """The port reproduces threefry2x32 with partitionable counters; a
    change of JAX's default would change every draw."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    # the test run has x64 on, as the batched engine turns it on
    assert jax.config.jax_enable_x64 is True


@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed):
    key, kd, kt = _keys(seed)
    for n in (2, 3, 5, 64):
        want = np.asarray(jax.random.key_data(jax.random.split(key, n)))
        np.testing.assert_array_equal(K.split(kd, n), want)
        np.testing.assert_array_equal(jrandom.split(kt, n).numpy(), want)
        np.testing.assert_array_equal(jrandom.split(kd, n, "cpu").numpy(),
                                      want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_32_and_64(seed, shape):
    key, kd, kt = _keys(seed)
    w32 = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    w64 = np.asarray(jax.random.bits(key, shape, jnp.uint64))
    _same_bits(K.bits(kd, shape), w32)
    _same_bits(K.bits(kd, shape, 64), w64)
    for k in (kd, kt):
        _same_bits(jrandom.bits(k, shape, "cpu").numpy().astype(np.uint32), w32)
        _same_bits(jrandom.bits(k, shape, "cpu", 64).numpy().view(np.uint64),
                   w64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed, dtype):
    key, kd, kt = _keys(seed)
    tdt = {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    for shape in SHAPES:
        want = np.asarray(jax.random.uniform(key, shape, dtype=dtype))
        _same_bits(K.uniform(kd, shape, dtype), want)
        for k in (kd, kt):
            _same_bits(jrandom.uniform(k, shape, tdt, "cpu").numpy(), want)


@pytest.mark.parametrize("span", [1, 2, 3, 1000, 2**31 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_spans(seed, span):
    key, kd, kt = _keys(seed)
    want = np.asarray(jax.random.randint(key, (2001,), 0, span,
                                         dtype=jnp.int32))
    _same_bits(K.randint(kd, (2001,), 0, span), want)
    for k in (kd, kt):
        _same_bits(jrandom.randint(k, (2001,), 0, span, "cpu").numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_minval_and_per_element_bounds(seed):
    """A ``minval`` is added after the draw; per-element bounds (the
    engine's ``randint(k, (B,), 0, max(cnt, 1))``) and empty spans
    (``maxval <= minval`` gives ``minval``)."""
    key, kd, kt = _keys(seed)
    want = np.asarray(jax.random.randint(key, (999,), 17, 1000,
                                         dtype=jnp.int32))
    _same_bits(K.randint(kd, (999,), 17, 1000), want)
    _same_bits(jrandom.randint(kt, (999,), 17, 1000).numpy(), want)
    hi = (np.arange(999, dtype=np.int32) * 7919) % 4099 - 3
    want = np.asarray(jax.random.randint(key, (999,), 0, jnp.asarray(hi),
                                         dtype=jnp.int32))
    _same_bits(K.randint(kd, (999,), 0, hi), want)
    for k in (kd, kt):
        _same_bits(jrandom.randint(k, (999,), 0, torch.from_numpy(hi),
                                   "cpu").numpy(), want)
    assert (want[hi <= 0] == 0).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_half(seed):
    """``bernoulli(k, 0.5, shape)``: a Python-float p is f64 under x64,
    so the coin is an f64 uniform < 0.5."""
    key, kd, kt = _keys(seed)
    want = np.asarray(jax.random.bernoulli(key, 0.5, (3001,)))
    np.testing.assert_array_equal(K.bernoulli(kd, 0.5, (3001,)), want)
    for k in (kd, kt):
        np.testing.assert_array_equal(
            jrandom.bernoulli(k, 0.5, (3001,), "cpu").numpy(), want)


def test_batched_keys_broadcast_before_the_shape():
    """A key table [R, 2] draws [R, *shape], row r under key r (the
    batched engine draws a chunk of rounds at once)."""
    ks = K.split(K.key_data(11), 6)
    kt = torch.from_numpy(ks.astype(np.int64))
    jk = [jax.random.wrap_key_data(jnp.asarray(k)) for k in ks]
    want_b = np.stack([np.asarray(jax.random.bits(k, (50,), jnp.uint32))
                       for k in jk])
    want_u = np.stack([np.asarray(jax.random.uniform(k, (50,),
                                                     dtype=jnp.float64))
                       for k in jk])
    want_r = np.stack([np.asarray(jax.random.randint(k, (50,), 0, 77,
                                                     dtype=jnp.int32))
                       for k in jk])
    want_s = np.stack([np.asarray(jax.random.key_data(jax.random.split(k, 5)))
                       for k in jk])
    np.testing.assert_array_equal(K.bits(ks, (50,)), want_b)
    np.testing.assert_array_equal(jrandom.bits(kt, (50,)).numpy(), want_b)
    _same_bits(jrandom.uniform(kt, (50,), torch.float64).numpy(), want_u)
    _same_bits(jrandom.randint(kt, (50,), 0, 77).numpy(), want_r)
    np.testing.assert_array_equal(K.split(ks, 5), want_s)
    np.testing.assert_array_equal(jrandom.split(kt, 5).numpy(), want_s)


def test_bad_arguments_raise():
    kd = K.key_data(1)
    with pytest.raises(ValueError):
        K.bits(kd, (3,), 16)
    with pytest.raises(ValueError):
        jrandom.bits(kd, (3,), "cpu", 16)
    with pytest.raises(ValueError):
        jrandom.uniform(kd, (3,), torch.float16, "cpu")
