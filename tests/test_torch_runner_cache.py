"""Port parity: the runner cache (``ops/runner_cache.py``) against the
JAX package's ``gfasort_tpu/ops/runner_cache.py``, and its wiring into
``build_sweep_runner`` and ``build_sweep_nd_runner``.

* The key parts (``fingerprint_pidx``, ``params_key``, ``env_key``)
  equal the JAX functions' values on the same workload and environment.
* Off unless ``GFASORT_RUNNER_CACHE=1``; a second build returns the
  cached tuple itself; a changed ``GFASORT_*`` knob or device misses;
  the cap evicts the least recently used entry.
* Two runs of a cached 1D runner and of a cached nD runner are
  ``torch.equal`` to a fresh uncached build's run.
"""

from collections import OrderedDict
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

from gfasort_tpu import bench_util as j_bench  # noqa: E402
from gfasort_tpu import params as j_params  # noqa: E402
from gfasort_tpu.ops import runner_cache as j_rc  # noqa: E402
from gfasort_tpu_torch import bench_util as t_bench  # noqa: E402
from gfasort_tpu_torch import params as t_params  # noqa: E402
from gfasort_tpu_torch.ops import runner_cache as rc  # noqa: E402
from gfasort_tpu_torch.ops import sweep, sweep_nd  # noqa: E402
from gfasort_tpu_torch.ops.exact import layout_initial_coords  # noqa: E402
from gfasort_tpu_torch.ops.keys import key_data  # noqa: E402

SHAPE = (600, 3, 800)


@pytest.fixture
def cache(monkeypatch):
    """An empty cache, switched on."""
    monkeypatch.setattr(rc, "_CACHE", OrderedDict())
    monkeypatch.setenv("GFASORT_RUNNER_CACHE", "1")
    return rc._CACHE


@pytest.fixture(scope="module")
def pidx():
    return t_bench.synthetic_path_index(*SHAPE, seed=2)


def _p1d(pidx):
    return replace(t_params.PathSGDParams().derive_from_graph(pidx),
                   iter_max=3)


def _pnd(pidx):
    return replace(t_params.LayoutSGDParams().derive_from_graph(pidx, 2),
                   iter_max=3)


def test_key_parts_equal_jax(monkeypatch):
    jp = j_bench.synthetic_path_index(*SHAPE, seed=2)
    tp = t_bench.synthetic_path_index(*SHAPE, seed=2)
    assert rc.fingerprint_pidx(tp) == j_rc.fingerprint_pidx(jp)
    assert rc.fingerprint_pidx(tp) != rc.fingerprint_pidx(
        t_bench.synthetic_path_index(*SHAPE, seed=3))
    for jcls, tcls, args in (
            (j_params.PathSGDParams, t_params.PathSGDParams, ()),
            (j_params.LayoutSGDParams, t_params.LayoutSGDParams, (3,))):
        jpar = replace(jcls().derive_from_graph(jp, *args), dtype="float64")
        tpar = replace(tcls().derive_from_graph(tp, *args), dtype="float64")
        assert rc.params_key(tpar) == j_rc.params_key(jpar)
    for k, v in (("GFASORT_SNAP", "down"), ("GFASORT_KERNEL_KMAX", "64"),
                 ("GFASORT_RUNNER_CACHE", "1"),
                 ("GFASORT_SERVER_SOCKET", "/x.sock"),
                 ("GFASORT_IN_SERVER", "1")):
        monkeypatch.setenv(k, v)
    assert rc.env_key() == j_rc.env_key()
    assert ("GFASORT_SNAP", "down") in rc.env_key()
    assert not any(k == "GFASORT_IN_SERVER" for k, _ in rc.env_key())


def test_off_by_default(monkeypatch, pidx):
    monkeypatch.setattr(rc, "_CACHE", OrderedDict())
    monkeypatch.delenv("GFASORT_RUNNER_CACHE", raising=False)
    assert not rc.enabled()
    a = sweep.build_sweep_runner(pidx, _p1d(pidx), device="cpu")
    b = sweep.build_sweep_runner(pidx, _p1d(pidx), device="cpu")
    assert a is not b and not rc._CACHE


@pytest.mark.parametrize("engine", ["1d", "nd"])
def test_second_build_hits_and_knob_or_device_change_misses(
        cache, monkeypatch, pidx, engine):
    if engine == "1d":
        build, params = sweep.build_sweep_runner, _p1d(pidx)
        mod = sweep
    else:
        build, params = sweep_nd.build_sweep_nd_runner, _pnd(pidx)
        mod = sweep_nd
    a = build(pidx, params, device="cpu")
    assert build(pidx, params, device=torch.device("cpu")) is a
    # a knob read at plan time
    monkeypatch.setenv("GFASORT_SNAP", "down")
    b = build(pidx, params, device="cpu")
    assert b is not a
    monkeypatch.delenv("GFASORT_SNAP")
    assert build(pidx, params, device="cpu") is a
    # a structure-affecting parameter
    assert build(pidx, replace(params, iter_max=4), device="cpu") is not a
    # another resolved device: "cpu:0" stands in for a card, as only the
    # CPU is here (tests/test_torch_cuda.py holds cpu against cuda)
    monkeypatch.setattr(mod, "resolve_device", lambda d: torch.device("cpu", 0))
    c = build(pidx, params, device="cpu")
    assert c is not a
    assert len(cache) == 4


def test_cap_evicts_least_recently_used(cache, monkeypatch):
    monkeypatch.setenv("GFASORT_RUNNER_CACHE_CAP", "2")
    rc.put("a", 1)
    rc.put("b", 2)
    assert rc.get("a") == 1          # "b" is now the least recently used
    rc.put("c", 3)
    assert list(cache) == ["a", "c"] and rc.get("b") is None
    monkeypatch.setenv("GFASORT_RUNNER_CACHE_CAP", "0")   # at least one
    rc.put("d", 4)
    assert list(cache) == ["d"]


def _run_1d(built, pidx, seed):
    run, arrays, make_state, _ = built
    xs0, xn0 = make_state()
    return run(xs0, xn0, key_data(seed), *arrays)


def _run_nd(built, pidx, seed):
    run, arrays, make_state, _ = built
    cs0, csn0 = make_state(layout_initial_coords(pidx, 2, seed))
    return run(cs0, csn0, key_data(seed), *arrays)


@pytest.mark.parametrize("engine", ["1d", "nd"])
def test_cached_runner_equals_fresh_build(cache, monkeypatch, pidx, engine):
    """A hit gives the same answer as a fresh build, run after run: no
    run modifies a tensor the cached runner holds."""
    if engine == "1d":
        build, params, run = sweep.build_sweep_runner, _p1d(pidx), _run_1d
    else:
        build, params, run = sweep_nd.build_sweep_nd_runner, _pnd(pidx), _run_nd
    cached = build(pidx, params, device="cpu")
    firsts = [run(build(pidx, params, device="cpu"), pidx, s)
              for s in (params.seed, 7)]
    again = [run(build(pidx, params, device="cpu"), pidx, s)
             for s in (params.seed, 7)]
    assert build(pidx, params, device="cpu") is cached and len(cache) == 1
    monkeypatch.delenv("GFASORT_RUNNER_CACHE")
    fresh = [run(build(pidx, params, device="cpu"), pidx, s)
             for s in (params.seed, 7)]
    assert len(cache) == 1
    for a, b, c in zip(firsts, again, fresh):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert not torch.equal(fresh[0], fresh[1])
