"""Fused sweep apply: every bucket of a static offset set in one pass.

Counterpart of ``gfasort_tpu/ops/sweep_pallas.py``, with the same public
names and the same ``layout`` dict, so that the same padded inputs go
through both.  On CUDA tensors :func:`sweep_apply` launches the
hand-written Hopper kernel ``csrc/sweep_apply.cu``; on CPU tensors it
runs :func:`sweep_apply_ref`, the plain PyTorch version that follows the
TPU kernel body op for op.  A CUDA tensor never reaches the plain
version, and a failed launch raises.

Unlike the production split (``ops/sweep.py``: the bucket-apply kernel
for k <= KMAX, roll passes above), this apply guards each pair by the
path's rank and step count: the partner ahead needs ``rank + k < cnt``,
the one behind ``rank >= k``.  The state is padded with H >= max(offs)
elements on both sides (zeros, INACTIVE choices), and padded steps carry
rank = cnt = 0, so the padding never forms a pair.  No caller in the JAX
package runs the fused apply outside its test, and the port's sweep
runner does not call it either.
"""

from __future__ import annotations

import numpy as np
import torch

from .sweep_common import INACTIVE

__all__ = ["MAX_OFFSETS", "INACTIVE", "build_sweep_apply", "sweep_apply",
           "sweep_apply_ref", "pad_static", "pad_state", "pad_sidx"]

MAX_OFFSETS = 64   # the kernel's offset table (csrc/sweep_apply.cu)

_LANE = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def build_sweep_apply(offs, S: int, dtype=torch.float32, tile: int = 64 * 1024,
                      group: int = 4):
    """The fused apply for a static offset set.

    Returns ``(apply_fn, layout)``: ``apply_fn(xs_pad, pos_pad, sidx_pad,
    rank, cnt, eta) -> xs_new`` f32 ``[S_pad]``, and ``layout``, the JAX
    kernel's dict of padded shapes (S, S_pad, H, L, Lr, T, nb, K, G, NG)
    that :func:`pad_static`, :func:`pad_state` and :func:`pad_sidx`
    follow.  The padded arrays may be flat or ``[rows, 128]`` views.
    ``tile`` and ``group`` only shape the layout, as the TPU kernel's
    grid did; nothing on the card depends on them."""
    if dtype != torch.float32:
        raise ValueError(f"the fused sweep apply is float32 only, got {dtype}")
    offs = tuple(int(k) for k in np.asarray(offs).reshape(-1))
    if not offs:
        raise ValueError("the offset set is empty")
    K = len(offs)
    T = int(min(tile, _round_up(S, 8 * _LANE)))
    H = _round_up(max(offs), _LANE)
    S_pad = _round_up(S, T)
    L = S_pad + 2 * H
    G = int(group)
    layout = dict(S=S, S_pad=S_pad, H=H, L=L, Lr=L // _LANE, T=T,
                  nb=S_pad // T, K=K, G=G, NG=-(-K // G))

    def apply_fn(xs_pad, pos_pad, sidx_pad, rank, cnt, eta):
        return sweep_apply(xs_pad, pos_pad, sidx_pad, rank, cnt, eta, offs, H)

    return apply_fn, layout


def sweep_apply_ref(xs_pad, pos_pad, sidx_pad, rank, cnt, eta, offs, H: int):
    """Plain PyTorch fused apply (the spec of the kernel), on flat padded
    inputs: the TPU kernel body's ops in its order, per bucket
    ``dsum + (ahead + behind)``, then ``xs + dsum / max(csum, 1)``."""
    S_pad = rank.shape[0]

    def at(a, k):
        return a[H + k: H + k + S_pad]

    xs, pos, sidx = at(xs_pad, 0), at(pos_pad, 0), at(sidx_pad, 0)
    rank64 = rank.to(torch.int64)   # rank + k cannot overflow
    one = torch.ones((), dtype=torch.float32, device=xs.device)
    eta_t = torch.full((), float(np.float32(eta)), dtype=torch.float32,
                       device=xs.device)

    def half(k, w_bool, pair_ok):
        pos_o, xs_o = at(pos_pad, k), at(xs_pad, k)
        d = torch.abs(pos - pos_o)
        valid = pair_ok & (d != 0)
        w = (valid & w_bool).to(torch.float32)
        safe = torch.where(valid, d, one)
        mu = torch.minimum(eta_t / safe, one)
        dx = xs - xs_o
        dx = torch.where(dx == 0, 1e-9, dx)
        mag = torch.abs(dx)
        r_x = (mu * (mag - safe) / 2.0 / mag) * dx
        return -w * r_x, w

    dsum = torch.zeros_like(xs)
    csum = torch.zeros_like(xs)
    for ki, k in enumerate(offs):
        # partner ahead (t+k): I chose +k, or they chose -k
        d1, w1 = half(+k, (sidx == ki) | (at(sidx_pad, k) == ~ki),
                      rank64 + k < cnt)
        # partner behind (t-k): I chose -k, or they chose +k
        d2, w2 = half(-k, (sidx == ~ki) | (at(sidx_pad, -k) == ki),
                      rank >= k)
        dsum = dsum + (d1 + d2)
        csum = csum + (w1 + w2)
    return xs + dsum / torch.clamp_min(csum, 1.0)


def _flat(name, t, dtype, n, device):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.numel() != n:
        got = f"{t.dtype} of {t.numel()}" if isinstance(t, torch.Tensor) else type(t)
        raise ValueError(f"{name} must be {dtype} with {n} elements, got {got}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")
    return t.reshape(-1)


def sweep_apply(xs_pad, pos_pad, sidx_pad, rank, cnt, eta, offs, H: int):
    """xs_new f32 [S_pad] of the fused apply over ``offs`` (bucket ki at
    offset ``offs[ki]``, each in [1, H]).

    ``xs_pad``, ``pos_pad`` f32 and ``sidx_pad`` int32 hold L = S_pad + 2H
    elements (flat or ``[L / 128, 128]``); ``rank`` and ``cnt`` int32 hold
    S_pad; ``eta`` is the sweep's learning rate (an f32 value).  CUDA
    tensors launch the kernel and count one launch in
    ``sweep_apply.launches``; CPU tensors run the plain version."""
    offs = tuple(int(k) for k in offs)
    if not 1 <= len(offs) <= MAX_OFFSETS:
        raise ValueError(f"1 to {MAX_OFFSETS} offsets, got {len(offs)}")
    if any(not 1 <= k <= H for k in offs):
        raise ValueError(f"every offset must lie in [1, H = {H}], got {offs}")
    if not isinstance(rank, torch.Tensor):
        raise ValueError("rank must be a tensor")
    dev = rank.device
    S_pad = rank.numel()
    L = S_pad + 2 * H
    if L >= 1 << 31:
        raise ValueError(f"{L} padded steps exceed the kernel's int32 indexing")
    xs_pad = _flat("xs_pad", xs_pad, torch.float32, L, dev)
    pos_pad = _flat("pos_pad", pos_pad, torch.float32, L, dev)
    sidx_pad = _flat("sidx_pad", sidx_pad, torch.int32, L, dev)
    rank = _flat("rank", rank, torch.int32, S_pad, dev)
    cnt = _flat("cnt", cnt, torch.int32, S_pad, dev)
    if dev.type == "cpu":
        return sweep_apply_ref(xs_pad, pos_pad, sidx_pad, rank, cnt, eta,
                               offs, H)
    if dev.type != "cuda":
        raise ValueError(f"sweep_apply runs on cpu or cuda, not {dev}")
    from ..kernels import sweep_apply_cuda

    out = sweep_apply_cuda(xs_pad, pos_pad, sidx_pad, rank, cnt,
                           float(np.float32(eta)), offs, H)
    sweep_apply.launches += 1
    return out


sweep_apply.launches = 0


def pad_static(arr: np.ndarray, layout: dict, fill=0, dtype=None):
    """Host side: pad a [S] array to the kernel's [Lr, 128] layout."""
    out = np.full(layout["L"], fill, dtype=dtype or arr.dtype)
    out[layout["H"]: layout["H"] + layout["S"]] = arr
    return out.reshape(layout["Lr"], _LANE)


def pad_state(xs: torch.Tensor, layout: dict) -> torch.Tensor:
    """Place the per-sweep [S] state into the padded [Lr, 128] view, on
    ``xs``'s device."""
    flat = torch.zeros(layout["L"], dtype=xs.dtype, device=xs.device)
    flat[layout["H"]: layout["H"] + xs.shape[0]] = xs
    return flat.reshape(layout["Lr"], _LANE)


def pad_sidx(sidx: torch.Tensor, layout: dict) -> torch.Tensor:
    """Place an int32 [S] choice array into the padded [Lr, 128] view,
    INACTIVE around it, on ``sidx``'s device."""
    flat = torch.full((layout["L"],), int(INACTIVE), dtype=torch.int32,
                      device=sidx.device)
    flat[layout["H"]: layout["H"] + sidx.shape[0]] = sidx
    return flat.reshape(layout["Lr"], _LANE)
