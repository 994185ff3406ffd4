"""An op-by-op stand-in for ``shard_map`` and the graphs of the sharded
parity tests.

The JAX sharded engines run their per-device program under
``shard_map``.  Run op by op (``jax.disable_jit``), a ``shard_map``
program takes minutes per sweep on the CPU, too slow for tier-1.
:func:`spmd_shard_map` runs the same per-device function in one thread
per shard, op by op, with ``jax.lax.axis_index`` giving the shard's
index and ``jax.lax.psum`` adding the shards' arrays in shard order from
shard 0's own array: the order in which XLA:CPU's ``psum`` adds its
devices (``test_psum_adds_devices_in_order`` holds the real ``psum`` to
it).  The sharded parity tests (``test_torch_parallel*.py``) hold the
port to the JAX engines run this way.

``gfa_text`` builds the graphs of those tests from a seed, with paths of
chosen lengths: one path as long as all the others together keeps the
shard length L the same on 2, 4 and 8 shards, so that JAX compiles each
op of those runs once.
"""

import contextlib
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

# 240 + (70 + 60 + 50 + 40 + 20) steps: L = 480 on one shard and 240 on
# 2, 4 and 8 shards
PATH_LENS = (240, 70, 60, 50, 40, 20)


def gfa_text(seed: int = 0, n_nodes: int = 160, lens=PATH_LENS) -> str:
    """A GFA of ``n_nodes`` nodes (lengths 1-4) and one noisy monotone
    walk per entry of ``lens``, 10% of its steps reversed; an L line for
    every adjacent step pair."""
    rng = np.random.default_rng(seed)
    lines = ["H\tVN:Z:1.0"] + [f"S\t{i + 1}\t{'ACGT'[: 1 + i % 4]}"
                               for i in range(n_nodes)]
    edges, paths = set(), []
    for p, n in enumerate(lens):
        ids = np.clip(np.sort(rng.integers(0, n_nodes, n))
                      + rng.integers(-5, 6, n), 0, n_nodes - 1) + 1
        rev = rng.random(n) < 0.1
        o = ["-" if r else "+" for r in rev]
        paths.append(f"P\tp{p}\t" + ",".join(f"{i}{s}" for i, s in zip(ids, o))
                     + "\t*")
        for a, b, oa, ob in zip(ids[:-1], ids[1:], o[:-1], o[1:]):
            edges.add(f"L\t{a}\t{oa}\t{b}\t{ob}\t0M")
    return "\n".join(lines + sorted(edges) + paths) + "\n"


@contextlib.contextmanager
def spmd_shard_map(monkeypatch):
    """Within the context, ``shard_map`` programs built by the JAX
    package run op by op, one thread per shard (see the module doc).
    The shards take turns: one runs at a time, from one ``psum`` to the
    next."""
    import jax.experimental.shard_map as sm

    state = threading.local()

    def axis_index(axis):
        return jnp.int32(state.g)

    def take_turn(box, g):
        with box["cv"]:
            box["cv"].wait_for(lambda: box["turn"] == g or box["err"])
            if box["err"]:
                raise RuntimeError("another shard failed")

    def pass_turn(box, g):
        with box["cv"]:
            box["turn"] = (g + 1) % box["n"]
            box["cv"].notify_all()

    def psum(x, axis):
        # the shards take turns: each deposits its array and passes on;
        # when the turn comes back, every shard's array of this round is in
        box, g = state.box, state.g
        t = state.round = state.round + 1
        slots = box["rounds"].setdefault(t, [None] * box["n"])
        slots[g] = x
        pass_turn(box, g)
        take_turn(box, g)
        total = slots[0]
        for s in slots[1:]:
            total = total + s
        return total

    def shard_map(f, mesh, in_specs, out_specs, **kw):
        n = mesh.size
        # every shard computes on one device, which compiles each op once
        dev0 = jax.devices("cpu")[0]

        def run(*args):
            box = {"n": n, "turn": 0, "err": False, "rounds": {},
                   "cv": threading.Condition()}
            outs, errs = [None] * n, []

            def body(g):
                state.g, state.box, state.round = g, box, 0
                try:
                    take_turn(box, g)
                    with jax.disable_jit():
                        outs[g] = f(*(jax.device_put(
                            a if len(sp) == 0 else a[g:g + 1], dev0)
                            for a, sp in zip(args, in_specs)))
                    pass_turn(box, g)
                except BaseException as e:  # noqa: BLE001 (re-raised below)
                    errs.append(e)
                    with box["cv"]:
                        box["err"] = True
                        box["cv"].notify_all()

            threads = [threading.Thread(target=body, args=(g,))
                       for g in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errs:
                raise errs[0]

            def merge(spec, parts):
                return parts[0] if len(spec) == 0 else jnp.concatenate(parts)

            if isinstance(out_specs, tuple):
                return tuple(merge(sp, [o[i] for o in outs])
                             for i, sp in enumerate(out_specs))
            return merge(out_specs, outs)

        return run

    monkeypatch.setattr(sm, "shard_map", shard_map)
    monkeypatch.setattr(jax.lax, "psum", psum)
    monkeypatch.setattr(jax.lax, "axis_index", axis_index)
    with jax.disable_jit():
        yield


def _program(mesh):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    def device(x, key):
        g = jax.lax.axis_index("data")
        k = jax.random.fold_in(key, g)
        y = x[0] * jax.random.uniform(k, x.shape[1:], jnp.float32)
        return y[None], jax.lax.psum(y, "data")

    return jax.jit(shard_map(device, mesh=mesh, in_specs=(P("data"), P()),
                             out_specs=(P("data"), P())))


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_psum_adds_devices_in_order(ndev):
    """XLA:CPU's ``psum`` equals ``((d0 + d1) + d2) + ...`` bit for bit,
    on values whose sum depends on the order."""
    from gfasort_tpu.parallel import default_mesh

    rng = np.random.default_rng(ndev)
    x = (rng.standard_normal((ndev, 10_000))
         * 10.0 ** rng.integers(-6, 7, (ndev, 10_000))).astype(np.float32)
    y, total = _program(default_mesh(ndev))(jnp.asarray(x), jax.random.key(3))
    y = np.asarray(y)
    want = y[0]
    for d in range(1, ndev):
        want = want + y[d]
    np.testing.assert_array_equal(np.asarray(total), want)
    # the values make the order matter: the reverse order differs
    rev = y[-1]
    for d in range(ndev - 2, -1, -1):
        rev = rev + y[d]
    assert ndev == 2 or not np.array_equal(want, rev)


@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_stand_in_equals_shard_map(ndev, monkeypatch):
    """The thread-per-shard stand-in gives the jitted ``shard_map``
    program's outputs: the per-shard values (``axis_index``, the folded
    keys, the draws) and the in-order ``psum``."""
    from gfasort_tpu.parallel import default_mesh

    mesh = default_mesh(ndev)
    x = np.random.default_rng(1).standard_normal((ndev, 1000)).astype(np.float32)
    ref = _program(mesh)(jnp.asarray(x), jax.random.key(5))
    with spmd_shard_map(monkeypatch):
        got = _program(mesh)(jnp.asarray(x), jax.random.key(5))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gfa_text_keeps_the_shard_length():
    from gfasort_tpu.io import gfa
    from gfasort_tpu.index import PathIndex
    from gfasort_tpu.parallel.sweep_shard import _shard_arrays

    pidx = PathIndex.from_graph(gfa.parse_gfa_numeric(gfa_text()))
    assert pidx.total_steps == 480
    assert [_shard_arrays(pidx, k, np.float32)[-1] for k in (1, 2, 4, 8)] == [
        480, 240, 240, 240]
