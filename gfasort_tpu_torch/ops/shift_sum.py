"""Shift sum: ``out[s] = sum_{k=-halo..halo} x[s + k]``, zero outside.

Counterpart of the three mechanism probes of ``scratch/dense_probe.py``
(``pallas_transpose``, ``pallas_laneroll``, ``pallas_dma``).  Each
computed this 17-term sum (halo 8), the shifted-view access that the
bucket-apply kernels rest on, through one TPU mechanism: a VMEM
transpose, static lane rolls, or element-offset DMAs.  The port drops
those mechanisms and computes the sum with zero-padded edges, the form
of ``pallas_dma`` (the other two wrapped inside each 64k block).

On a CUDA tensor :func:`shift_sum` launches one of two hand-written
kernels of ``csrc/shift_sum.cu``: ``"global"`` (a thread loads one
16-byte vector and takes its neighbours' elements from the other lanes
of its warp by shuffles) or ``"smem"`` (a persistent grid stages tiles
plus their halo in a shared-memory ring by asynchronous copies).  Both
take any contiguous f32 [S], a view that starts off a 16-byte boundary
included, and equal :func:`shift_sum_ref` bit for bit.  On a CPU tensor
it runs :func:`shift_sum_ref`.  ``tools/dense_probe.py`` times the two
beside each other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["VARIANTS", "HALOS", "shift_sum", "shift_sum_ref"]

VARIANTS = ("global", "smem")
HALOS = (1, 2, 4, 8, 16)   # the halos the kernels are built for


def shift_sum_ref(x: torch.Tensor, halo: int = 8) -> torch.Tensor:
    """Plain PyTorch shift sum (the spec of both kernels): the terms
    added in ascending k, starting from the k = -halo term, as
    ``pallas_dma`` accumulates them."""
    S = x.shape[0]
    xp = F.pad(x, (halo, halo))
    acc = xp[0:S]
    for j in range(1, 2 * halo + 1):
        acc = acc + xp[j: j + S]
    return acc


def shift_sum(x: torch.Tensor, halo: int = 8,
              variant: str = "smem") -> torch.Tensor:
    """f32 [S] shift sum of the f32 [S] ``x``.  CUDA tensors launch the
    ``variant`` kernel and count one launch in
    ``shift_sum.launches[variant]``; CPU tensors run the plain
    version."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if halo not in HALOS:
        raise ValueError(f"halo must be one of {HALOS}, got {halo}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32 [S], got {x.dtype} "
                         f"{list(x.shape)}")
    if not 1 <= x.shape[0] <= 1 << 30:
        raise ValueError(f"1 to 2**30 elements, got {x.shape[0]}")
    if x.device.type == "cpu":
        return shift_sum_ref(x, halo)
    if x.device.type != "cuda":
        raise ValueError(f"shift_sum runs on cpu or cuda, not {x.device}")
    from ..kernels import shift_sum_cuda

    out = shift_sum_cuda(x, halo, variant)
    shift_sum.launches[variant] += 1
    return out


shift_sum.launches = dict.fromkeys(VARIANTS, 0)
