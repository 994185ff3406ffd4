"""In-process runner memoization for the warm-process server.

Counterpart of ``gfasort_tpu/ops/runner_cache.py``, with the same keys,
knobs and cap.  A fresh ``build_sweep_runner`` per CLI job redoes the
host set-up of the engine: the sweep plan, the sampler constants, the
gather-consensus tables and the upload of the static ``pos`` / ``rank``
/ ``cnt`` tensors.  The warm server (:mod:`gfasort_tpu_torch.server`)
sets ``GFASORT_RUNNER_CACHE=1`` so that ``build_sweep_runner`` and
``build_sweep_nd_runner`` memoize their whole return value ``(run,
arrays, make_state, info)``, keyed by a content fingerprint of the
workload, every structure-affecting parameter, every ``GFASORT_*`` knob
and the resolved ``torch.device`` (a CPU runner and a CUDA runner never
answer for each other).  A same-workload job then costs the fingerprint
hash and the run.

A hit returns the very objects a fresh build would have made: ``run``
and ``make_state`` modify no tensor they hold (each run starts from the
state ``make_state`` builds anew), so a hit gives the answer of a fresh
build.

Not enabled by default: the cache keeps device tensors alive for the
process lifetime (bounded by ``GFASORT_RUNNER_CACHE_CAP`` entries,
default 4, LRU).
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict

import numpy as np

__all__ = ["enabled", "fingerprint_pidx", "params_key", "env_key",
           "get", "put"]

_CACHE: OrderedDict = OrderedDict()


def enabled() -> bool:
    return os.environ.get("GFASORT_RUNNER_CACHE", "0") == "1"


def _cap() -> int:
    return max(1, int(os.environ.get("GFASORT_RUNNER_CACHE_CAP", 4)))


def fingerprint_pidx(pidx) -> str:
    """Content hash of every PathIndex array a runner's structure or
    static device arrays can depend on."""
    h = hashlib.sha256()
    for a in (pidx.step_node_idx, pidx.step_pos, pidx.step_rank,
              pidx.step_count_of_step, pidx.step_path, pidx.path_count,
              pidx.node_len, pidx.node_ids):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def params_key(params) -> tuple:
    """Structure-affecting parameter fields (seed excluded: it enters
    at run time as the base key, not at build time)."""
    return tuple(
        (f, getattr(params, f))
        for f in ("iter_max", "min_term_updates", "eta_max", "theta",
                  "space", "space_max", "space_quantization_step", "eps",
                  "first_cooling_iteration", "iter_with_max_learning_rate",
                  "dtype")
        if hasattr(params, f)
    )


def env_key() -> tuple:
    """Every GFASORT_* env knob that can alter a built runner."""
    return tuple(sorted(
        (k, v) for k, v in os.environ.items()
        if k.startswith("GFASORT_") and k not in (
            "GFASORT_RUNNER_CACHE", "GFASORT_RUNNER_CACHE_CAP",
            "GFASORT_SERVER_SOCKET", "GFASORT_SERVER_IDLE_S",
            "GFASORT_IN_SERVER", "GFASORT_COMPILE_CACHE",
        )
    ))


def get(key):
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE.move_to_end(key)
    return hit


def put(key, value) -> None:
    _CACHE[key] = value
    _CACHE.move_to_end(key)
    while len(_CACHE) > _cap():
        _CACHE.popitem(last=False)
