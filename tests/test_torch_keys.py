"""Port parity: the host key schedule (numpy Threefry-2x32 fold_in)
against jax.random, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gfasort_tpu_torch.convert import key_words_from_jax  # noqa: E402
from gfasort_tpu_torch.ops.keys import (fold_in, key_data,  # noqa: E402
                                        split, sweep_key_table,
                                        threefry2x32, threefry_key_table)

SEEDS = [0, 42, 9399220, 2**31 - 1]


def _jax_fold_words(key, idx):
    return np.asarray(jax.vmap(
        lambda d: jax.random.key_data(jax.random.fold_in(key, d)))(
            jnp.asarray(idx, dtype=jnp.uint32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_matches_jax(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(key_data(seed), want)
    np.testing.assert_array_equal(key_words_from_jax(want), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_sweep_indices_bit_identical(seed):
    idx = np.arange(201)
    want = _jax_fold_words(jax.random.key(seed), idx)
    np.testing.assert_array_equal(fold_in(key_data(seed), idx), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_key_table_nested_proposal_fold(seed):
    """Row e, proposal p = key_data(fold_in(fold_in(key, e), p)); with
    P == 1 there is no per-proposal fold."""
    n_exec, P = 24, 12
    table = sweep_key_table(key_data(seed), n_exec, P)
    assert table.shape == (n_exec, P, 2) and table.dtype == np.uint32
    key = jax.random.key(seed)
    for e in (0, 5, 23):
        ke = jax.random.fold_in(key, e)
        np.testing.assert_array_equal(table[e], _jax_fold_words(ke, np.arange(P)))
    single = sweep_key_table(key_data(seed), n_exec, 1)
    assert single.shape == (n_exec, 1, 2)
    np.testing.assert_array_equal(single[:, 0], _jax_fold_words(key, np.arange(n_exec)))


def test_threefry_broadcasts_and_rejects_bad_input():
    y0, y1 = threefry2x32(np.uint32(1), np.uint32(2), np.zeros(3, np.uint32),
                          np.arange(3, dtype=np.uint32))
    assert y0.shape == y1.shape == (3,)
    # scalar inputs give 0-d outputs without overflow warnings
    with np.errstate(over="raise"):
        z0, z1 = threefry2x32(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF)
    assert z0.shape == () and z1.shape == ()
    with pytest.raises(ValueError):
        key_data(-1)
    with pytest.raises(ValueError):
        fold_in(key_data(0), [-1])


@pytest.mark.parametrize("P", [12, 1])
def test_threefry_key_table_is_the_per_sweep_split(P):
    """The threefry route's key table splits every key of the run's
    ``sweep_key_table`` in one call: row (e, p) is ``(k1, k2)`` of
    ``jax.random.split(key, 2)``, the per-sweep split that
    ``sweep_common.sweep_rng`` makes proposal by proposal."""
    n_exec = 9
    table = sweep_key_table(key_data(42), n_exec, P)
    tf = threefry_key_table(table)
    assert tf.shape == (n_exec, P, 2, 2) and tf.dtype == np.uint32
    for e in range(n_exec):
        for p in range(P):
            np.testing.assert_array_equal(tf[e, p], split(table[e, p], 2))
    for e, p in ((0, 0), (8, P - 1)):
        key = jax.random.wrap_key_data(jnp.asarray(table[e, p]))
        want = np.asarray(jax.random.key_data(jax.random.split(key, 2)))
        np.testing.assert_array_equal(tf[e, p], want)
