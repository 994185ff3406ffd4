"""Checkpoint/resume for long SGD runs (the port's copy of
``gfasort_tpu/checkpoint.py`` over the PyTorch batched engine).

The reference has no persistence beyond GFA/TSV output (SURVEY.md §6
"Checkpoint/resume: none"); for production-scale runs this module adds
segment-wise checkpointing of the 1D SGD: the round loop executes in
fixed-size segments, and after each segment the position vector plus
round cursor is written atomically to an ``.npz``.  Resuming validates a
fingerprint of (params, workload shape) so a checkpoint can never be
silently applied to a different optimization.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import asdict
from typing import Optional

import numpy as np

from .index import PathIndex
from .params import PathSGDParams

__all__ = ["fingerprint", "save_checkpoint", "load_checkpoint", "path_linear_sgd_checkpointed"]

_FORMAT = 1


def fingerprint(params: PathSGDParams, pidx: PathIndex) -> str:
    """Stable hash of the optimization identity: parameters + workload
    shape + first/last step data."""
    h = hashlib.sha256()
    h.update(json.dumps(asdict(params), sort_keys=True).encode())
    h.update(np.asarray([pidx.total_steps, pidx.num_nodes, pidx.num_paths]).tobytes())
    if pidx.total_steps:
        h.update(pidx.step_handle[:64].tobytes())
        h.update(pidx.step_handle[-64:].tobytes())
    return h.hexdigest()[:24]


def save_checkpoint(path: str, x: np.ndarray, next_round: int, fp: str) -> None:
    """Atomic write (tmp + rename)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(
                fh,
                format=np.int64(_FORMAT),
                x=np.asarray(x, dtype=np.float64),
                next_round=np.int64(next_round),
                fingerprint=np.frombuffer(fp.encode(), dtype=np.uint8),
            )
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_checkpoint(path: str, fp: str):
    """Returns (x, next_round) or None if absent/mismatched."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if int(z["format"]) != _FORMAT:
            return None
        stored = z["fingerprint"].tobytes().decode()
        if stored != fp:
            raise ValueError(
                f"checkpoint {path} belongs to a different run "
                f"(fingerprint {stored} != {fp})"
            )
        return z["x"].copy(), int(z["next_round"])


def path_linear_sgd_checkpointed(
    graph,
    params: PathSGDParams,
    checkpoint_path: str,
    pidx: Optional[PathIndex] = None,
    segment_rounds: int = 64,
    progress=None,
    *,
    device="cuda",
) -> Optional[np.ndarray]:
    """1D batched SGD with segment checkpointing on ``device``.  Resumes
    automatically from ``checkpoint_path`` when present; deletes it on
    completion.  ``progress(next_round, n_rounds)`` is called after each
    segment."""
    from .ops.keys import key_data
    from .ops.sgd import build_1d_runner

    pidx = pidx or PathIndex.from_graph(graph)
    if pidx.num_nodes == 0:
        return np.zeros(0)
    if not pidx.has_multi_step_path():
        return None

    fp = fingerprint(params, pidx)
    run, make_x0, n_rounds = build_1d_runner(
        pidx, params, segment_rounds=segment_rounds, device=device)
    key = key_data(params.seed)

    resumed = load_checkpoint(checkpoint_path, fp)
    if resumed is not None:
        x_host, start = resumed
        x = make_x0(x_host)
    else:
        x = make_x0()
        start = 0

    while start < n_rounds:
        x = run(x, key, start)
        start += segment_rounds
        x_host = x.cpu().numpy().astype(np.float64)
        if start < n_rounds:
            save_checkpoint(checkpoint_path, x_host, start, fp)
        if progress is not None:
            progress(min(start, n_rounds), n_rounds)
        x = make_x0(x_host)

    if os.path.exists(checkpoint_path):
        os.unlink(checkpoint_path)
    return x_host
