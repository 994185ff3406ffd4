"""Native (C++) runtime components: the sequential SGD oracle.

High-level wrappers around the ctypes-bound shared library built from
``sgd_exact.cpp``.  Semantics are identical to
:mod:`gfasort_tpu_torch.ops.exact` (cross-checked in tests); these are used
for large parity runs and as the CPU baseline in ``bench.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..index import PathIndex
from ..io.layout_tsv import Layout
from ..params import LayoutSGDParams, PathSGDParams
from ..ops.fastpow import zeta_table
from ..ops.schedule import eta_schedule
from .build import load

__all__ = [
    "available",
    "path_linear_sgd_native",
    "path_linear_sgd_layout_native",
    "sgd1d_bench_native",
    "layout_stress_2d_native",
]


def available() -> bool:
    return load() is not None


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pf64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _prep(pidx: PathIndex):
    return (
        np.ascontiguousarray(pidx.step_path, dtype=np.int64),
        np.ascontiguousarray(pidx.step_rank, dtype=np.int64),
        np.ascontiguousarray(pidx.step_pos, dtype=np.int64),
        np.ascontiguousarray(pidx.step_node_idx, dtype=np.int64),
        np.ascontiguousarray(pidx.path_first, dtype=np.int64),
        np.ascontiguousarray(pidx.path_count, dtype=np.int64),
    )


def path_linear_sgd_native(
    graph, params: PathSGDParams, pidx: Optional[PathIndex] = None
) -> Optional[np.ndarray]:
    """Native 1D oracle; same contract as
    :func:`gfasort_tpu_torch.ops.exact.path_linear_sgd_exact`."""
    lib = load()
    assert lib is not None, "native library unavailable"
    pidx = pidx or PathIndex.from_graph(graph)
    if pidx.num_nodes == 0:
        return np.zeros(0)
    if not pidx.has_multi_step_path():
        return None
    sp, sr, spos, snode, pf, pc = _prep(pidx)
    x = pidx.initial_positions().copy()
    etas = eta_schedule(
        1.0 / params.eta_max, 1.0, params.iter_max,
        params.iter_with_max_learning_rate, params.eps,
    )
    zetas = zeta_table(
        params.space, params.space_max, params.space_quantization_step,
        params.theta,
    )
    lib.sgd1d_exact(
        pidx.total_steps, _p64(sp), _p64(sr), _p64(spos), _p64(snode),
        _p64(pf), _p64(pc),
        pidx.num_nodes, _pf64(x),
        params.iter_max, params.min_term_updates, params.theta,
        params.space, params.space_max, params.space_quantization_step,
        params.first_cooling_iteration, params.seed,
        _pf64(etas), _pf64(zetas), len(zetas),
    )
    return x


def path_sgd_sort_native(graph, params: PathSGDParams):
    from .. import handle as H

    pidx = PathIndex.from_graph(graph)
    x = path_linear_sgd_native(graph, params, pidx)
    if x is None or len(x) == 0:
        return []
    order = np.argsort(x, kind="stable")
    return [H.forward(int(pidx.node_ids[idx])) for idx in order]


def path_linear_sgd_layout_native(
    graph, params: LayoutSGDParams, pidx: Optional[PathIndex] = None,
    init_coords: Optional[np.ndarray] = None,
) -> Layout:
    """Native nD oracle.  ``init_coords`` (shape [2N, D]) overrides the
    default init (used to share the exact same gaussian init as the
    Python oracle in cross-checks)."""
    lib = load()
    assert lib is not None, "native library unavailable"
    pidx = pidx or PathIndex.from_graph(graph)
    n = pidx.num_nodes
    dims = params.dimensions
    if n == 0:
        return Layout(dims, 0)
    if not pidx.has_multi_step_path():
        return Layout(dims, n)
    assert dims <= 64, "native oracle supports up to 64 dims"

    if init_coords is None:
        from ..ops.exact import layout_initial_coords

        init_coords = layout_initial_coords(pidx, dims, params.seed)
    coords = np.ascontiguousarray(init_coords, dtype=np.float64).reshape(2 * n, dims).copy()

    sp, sr, spos, snode, pf, pc = _prep(pidx)
    srev = np.ascontiguousarray(pidx.step_handle & 1, dtype=np.int64)
    nlen = np.ascontiguousarray(pidx.node_len, dtype=np.int64)
    etas = eta_schedule(
        1.0 / params.eta_max, 1.0, params.iter_max,
        params.iter_with_max_learning_rate, params.eps,
    )
    zetas = zeta_table(
        params.space, params.space_max, params.space_quantization_step,
        params.theta,
    )
    lib.sgd_nd_exact(
        pidx.total_steps, _p64(sp), _p64(sr), _p64(spos), _p64(snode), _p64(srev),
        _p64(pf), _p64(pc), _p64(nlen),
        n, dims, _pf64(coords),
        params.iter_max, params.min_term_updates, params.theta,
        params.space, params.space_max, params.space_quantization_step,
        params.first_cooling_iteration, params.seed,
        _pf64(etas), _pf64(zetas), len(zetas),
    )
    return Layout.from_state(coords)


def layout_stress_2d_native(
    pidx: PathIndex,
    xs: np.ndarray,
    ys: np.ndarray,
    present: np.ndarray,
    sample_count: int,
    seed: int = 12345,
) -> float:
    """Sampled 2D layout stress, bit-matching the compare_layouts tool's
    Python loop (reference: src/bin/compare_layouts.rs:156-255).
    ``xs``/``ys``/``present`` are indexed by SGD node index."""
    lib = load()
    assert lib is not None, "native library unavailable"
    sp, sr, spos, snode, pf, pc = _prep(pidx)
    xs = np.ascontiguousarray(xs, dtype=np.float64)
    ys = np.ascontiguousarray(ys, dtype=np.float64)
    present = np.ascontiguousarray(present, dtype=np.uint8)
    return float(lib.layout_stress_2d(
        pidx.total_steps, _p64(sp), _p64(sr), _p64(spos), _p64(snode),
        _p64(pf), _p64(pc),
        _pf64(xs), _pf64(ys),
        present.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sample_count, seed,
    ))


def sgd1d_bench_native(
    graph, params: PathSGDParams, n_updates: int, seed: int = 42
) -> tuple[float, int]:
    """Run ``n_updates`` raw 1D term updates; returns (seconds, attempts)."""
    import time

    lib = load()
    assert lib is not None
    pidx = PathIndex.from_graph(graph)
    sp, sr, spos, snode, pf, pc = _prep(pidx)
    x = pidx.initial_positions().copy()
    zetas = zeta_table(
        params.space, params.space_max, params.space_quantization_step,
        params.theta,
    )
    t0 = time.perf_counter()
    attempts = lib.sgd1d_bench(
        pidx.total_steps, _p64(sp), _p64(sr), _p64(spos), _p64(snode),
        _p64(pf), _p64(pc),
        _pf64(x), n_updates, float(params.eta_max), params.theta,
        params.space, params.space_max, params.space_quantization_step,
        seed, _pf64(zetas), len(zetas),
    )
    return time.perf_counter() - t0, int(attempts)
