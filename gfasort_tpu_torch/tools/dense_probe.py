"""Probe: how should a kernel on the card reach its shifted neighbours?

Counterpart of ``scratch/dense_probe.py``, which asked which TPU mechanism
(a VMEM transpose, lane rolls, element-offset DMAs) fed the 17-term
shifted-view sum ``out[s] = sum_{k=-8..8} x[s + k]`` cheapest.  Here the
two hand-written kernels of ``ops/shift_sum.py`` answer the same question
for the H100: every term read from global memory, or a tile plus its
halo staged in shared memory.  Both are timed beside the plain PyTorch
version and one library call that computes the same function,
``conv1d`` with a ones filter (TF32 off), which is a yardstick only.

    python -m gfasort_tpu_torch.tools.dense_probe [S_millions]

needs a CUDA device; it prints one JSON line.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..bench_util import cuda_ms
from ..ops.shift_sum import VARIANTS, shift_sum, shift_sum_ref

__all__ = ["BLOCK", "run", "main"]

BLOCK = 128 * 512       # the TPU probes' block: S is a multiple of it
LIBRARY_ATOL = 1e-4     # conv1d sums in its own order


def _conv1d(x, weight, halo):
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv1d(x[None, None], weight, padding=halo)[0, 0]


def run(S: int, device="cuda", halo: int = 8, seed: int = 0) -> dict:
    """Check both kernels (bit-identical to the plain version) and the
    library call (within ``LIBRARY_ATOL``) on x ~ N(0, 1) f32 [S] made
    from ``seed``, then time each with CUDA events.  ``launches`` counts
    the kernel launches of the checked calls, before any timing.  Raises
    when ``device`` is not a CUDA device or a check fails."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probe times kernels on a CUDA device, not {dev}")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(S).astype(np.float32)).to(dev)
    weight = torch.ones(1, 1, 2 * halo + 1, device=dev)
    want = shift_sum_ref(x, halo)
    before = dict(shift_sum.launches)
    got = {v: shift_sum(x, halo, v) for v in VARIANTS}
    torch.cuda.synchronize()
    launches = {v: shift_sum.launches[v] - before[v] for v in VARIANTS}
    lib_err = float((_conv1d(x, weight, halo) - want).abs().max())
    if lib_err > LIBRARY_ATOL:
        raise AssertionError(f"conv1d off by {lib_err} (atol {LIBRARY_ATOL})")
    variants = {}
    for v in VARIANTS:
        if not torch.equal(got[v], want):
            raise AssertionError(f"shift_sum[{v}] differs from the plain "
                                 f"version by {float((got[v] - want).abs().max())}")
        variants[v] = dict(max_abs_err=0.0, bit_identical=True,
                           ms=cuda_ms(lambda v=v: shift_sum(x, halo, v)))
    return dict(
        S=S, halo=halo, variants=variants, launches=launches,
        plain_ms=cuda_ms(lambda: shift_sum_ref(x, halo), 5),
        library_ms=cuda_ms(lambda: _conv1d(x, weight, halo)),
        library_max_abs_err=lib_err,
        bytes=8 * S,                    # one f32 word in, one out
        f32_ops=2 * halo * S,
    )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    s_millions = float(argv[0]) if argv else 4.0
    S = max(BLOCK, int(s_millions * 1e6) // BLOCK * BLOCK)
    res = run(S)
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
