"""State carried across from the JAX reference.

The port and the JAX package are fed from one numpy state: the
``PathIndex`` arrays and the initial node positions or node-end
coordinates.  These helpers produce exactly the tensors the JAX
``build_sweep_runner`` uploads (``gfasort_tpu/ops/sweep.py``: ``pos``,
``rank``, ``cnt``, ``xs0``, ``x_node0``), those of
``build_sweep_nd_runner`` (``gfasort_tpu/ops/sweep_nd.py``: the static
``rev`` and ``len`` rows, and ``make_state``'s ``cs0`` and
``cs_node0``), those of the batched engines (``gfasort_tpu/ops/sgd.py``:
the ``DeviceIndex`` arrays and the initial positions or node-end
coordinates), and turn a JAX key into the port's key words.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .index import PathIndex

__all__ = ["static_arrays", "initial_state", "sweep_state_from_numpy",
           "layout_static_arrays", "layout_state", "batched_inputs",
           "key_words_from_jax"]


def static_arrays(pidx: PathIndex, device, dtype=np.float32):
    """(pos [S] of ``dtype``, rank i32 [S], cnt i32 [S]) on ``device``."""
    dev = resolve_device(device)
    return (
        torch.from_numpy(pidx.step_pos.astype(dtype)).to(dev),
        torch.from_numpy(pidx.step_rank.astype(np.int32)).to(dev),
        torch.from_numpy(pidx.step_count_of_step.astype(np.int32)).to(dev),
    )


def initial_state(pidx: PathIndex, x0: Optional[np.ndarray], device,
                  dtype=np.float32):
    """(xs0 [S], x_node0 [N]): node positions ``x0`` (default:
    ``pidx.initial_positions()``) rounded to ``dtype``, and each step's
    copy."""
    dev = resolve_device(device)
    x_node0 = np.asarray(
        x0 if x0 is not None else pidx.initial_positions(), dtype=dtype)
    xs0 = x_node0[pidx.step_node_idx]
    return (torch.from_numpy(np.ascontiguousarray(xs0)).to(dev),
            torch.from_numpy(x_node0.copy()).to(dev))


def sweep_state_from_numpy(pidx: PathIndex, x0: Optional[np.ndarray], device,
                           dtype=np.float32):
    """(pos, rank, cnt, xs0, x_node0) on ``device``."""
    return (static_arrays(pidx, device, dtype)
            + initial_state(pidx, x0, device, dtype))


def layout_static_arrays(pidx: PathIndex, device, dtype=np.float32):
    """(pos, rank i32, cnt i32, rev i32, len), each [S] on ``device``,
    pos and len of ``dtype``: ``rev`` is each step's orientation bit,
    ``len`` the length of its node (rounded to f32 first, as the JAX
    engine uploads it)."""
    dev = resolve_device(device)
    rev = (pidx.step_handle & 1).astype(np.int32)
    length = np.asarray(pidx.node_len, dtype=np.float32)[
        pidx.step_node_idx].astype(dtype)
    return static_arrays(pidx, dev, dtype) + (
        torch.from_numpy(np.ascontiguousarray(rev)).to(dev),
        torch.from_numpy(np.ascontiguousarray(length)).to(dev),
    )


def layout_state(pidx: PathIndex, init_node_coords: np.ndarray, dims: int,
                 device, dtype=np.float32):
    """(cs0 [2D, S], cs_node0 [2D, N]) of ``dtype`` from node-end
    coordinates [2N, D] (row ``2n + e`` is end ``e`` of node ``n``): row
    ``e*D + d`` holds end ``e``'s dimension ``d``, per step and per
    node."""
    dev = resolve_device(device)
    N = pidx.num_nodes
    nc = np.asarray(init_node_coords, dtype=dtype).reshape(N, 2, dims)
    cs0 = nc[pidx.step_node_idx].transpose(1, 2, 0).reshape(2 * dims, -1)
    cs_node0 = nc.transpose(1, 2, 0).reshape(2 * dims, N)
    return (torch.from_numpy(np.ascontiguousarray(cs0)).to(dev),
            torch.from_numpy(np.ascontiguousarray(cs_node0)).to(dev))


def batched_inputs(pidx: PathIndex, params, start=None, device="cuda"):
    """(DeviceIndex, start state, key words) of the batched engines from
    one numpy state, as the JAX ones upload them: the ``DeviceIndex``
    arrays in ``params.dtype``; the initial positions [N] (``start``, by
    default ``pidx.initial_positions()``, as ``build_1d_runner``'s
    ``make_x0``) for ``PathSGDParams``, or the node-end coordinates
    [2N, D] ``start`` for ``LayoutSGDParams``; and the words of
    ``jax.random.key(params.seed)``."""
    from .ops.keys import key_data
    from .ops.sgd import DeviceIndex

    dev = resolve_device(device)
    dtype = {"float32": np.float32, "float64": np.float64}[params.dtype]
    if start is None:
        if hasattr(params, "dimensions"):
            raise ValueError("the layout engine needs its start coordinates")
        start = pidx.initial_positions()
    state = torch.from_numpy(np.asarray(start, dtype=dtype).copy()).to(dev)
    return (DeviceIndex.from_path_index(pidx, dtype, dev), state,
            key_data(params.seed))


def key_words_from_jax(key_data) -> np.ndarray:
    """The port's base key (u32 [2]) from ``jax.random.key_data(key)``
    of a threefry key, given as a numpy array."""
    kd = np.asarray(key_data)
    if kd.shape != (2,):
        raise ValueError(f"expected threefry key data of shape (2,), got {kd.shape}")
    return kd.astype(np.uint32)
