"""Probe: how should a kernel on the card reach its shifted neighbours?

Counterpart of ``scratch/dense_probe.py``, which asked which TPU mechanism
(a VMEM transpose, lane rolls, element-offset DMAs) fed the 17-term
shifted-view sum ``out[s] = sum_{k=-8..8} x[s + k]`` cheapest.  Here the
two hand-written kernels of ``ops/shift_sum.py`` answer the same question
for the H100: neighbours' elements by warp shuffles from registers, or a
tile plus its halo staged in shared memory.  Both are timed beside the
plain PyTorch version and one library call that computes the same
function, ``conv1d`` with a ones filter (TF32 off), which is a yardstick
only.

    python -m gfasort_tpu_torch.tools.dense_probe [S_millions]

needs a CUDA device; it prints one JSON line.  Its ``timers`` key says
what each time measures (``TIMERS``).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..bench_util import cuda_ms, device_ms
from ..ops.shift_sum import HALOS, VARIANTS, shift_sum, shift_sum_ref

__all__ = ["BLOCK", "TIMERS", "edge_cases", "same_bits", "check_edges",
           "run", "main"]

BLOCK = 128 * 512       # the TPU probes' block: S is a multiple of it
LIBRARY_ATOL = 1e-4     # conv1d sums in its own order
TIMERS = {
    "ms": "CUDA events around 20 back-to-back calls through the Python "
          "wrapper (bench_util.cuda_ms): where a launch is shorter than "
          "the host's launch path it measures the host",
    "device_ms": "the device alone, L2 cold: the median of 20 windows of "
                 "one call between two events, enqueued behind a sleep "
                 "and a 256 MB read (bench_util.device_ms); the share of "
                 "the bound is taken from it",
    "device_warm_ms": "the device alone, 20 calls back to back behind a "
                      "sleep, inputs L2-resident where they fit: may beat "
                      "the HBM bound, no share given",
}


def edge_cases(S: int, device, seed: int = 1):
    """(name, x, halo) of the edge cases at about ``S`` elements: for
    every halo of ``HALOS``, the views of S, S + 1, S + 2 and S + 3
    elements that start 0-3 elements into one 16-byte aligned buffer
    (the misaligned views, and S = 1, 2 and 3 mod 4 where S is a multiple
    of 4).  The buffer holds N(0, 1) values from ``seed``, -0.0 at both
    ends of every view and, where S >= 64, -0.0, +inf, -inf, NaN and
    +0.0 inside."""
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal(S + 8).astype(np.float32)
    buf[[0, 1, 2, 3, S - 1, S + 1, S + 3, S + 5]] = -0.0
    if S >= 64:
        at = rng.choice(np.arange(4, S - 1), 5, replace=False)
        buf[at] = [-0.0, np.inf, -np.inf, np.nan, 0.0]
    buf = torch.from_numpy(buf).to(device)
    for halo in HALOS:
        for off in range(4):
            yield f"halo{halo}_off{off}", buf[off: off + S + off], halo


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` equal bit for bit (NaN included, where
    ``torch.equal`` calls NaN unequal)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_edges(S: int, device="cuda") -> int:
    """Run both kernels on every case of :func:`edge_cases` and hold
    each to the plain version bit for bit; raises on a difference.
    Returns the number of cases."""
    n = 0
    for name, x, halo in edge_cases(S, device):
        want = shift_sum_ref(x, halo)
        for v in VARIANTS:
            got = shift_sum(x, halo, v)
            if not same_bits(got, want):
                bad = (got.view(torch.int32) != want.view(torch.int32))
                nan = torch.isnan(got) & torch.isnan(want)
                raise AssertionError(
                    f"shift_sum[{v}] {name} (S {x.shape[0]}, data_ptr % 16 "
                    f"= {x.data_ptr() % 16}) differs from the plain version "
                    f"at {int(bad.sum())} elements, {int((bad & nan).sum())} "
                    f"of them NaN in both; first at "
                    f"{int(bad.nonzero()[0, 0])}")
        n += 1
    return n


def _conv1d(x, weight, halo):
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv1d(x[None, None], weight, padding=halo)[0, 0]


def run(S: int, device="cuda", halo: int = 8, seed: int = 0,
        edges: bool = False) -> dict:
    """Check both kernels (bit-identical to the plain version) and the
    library call (within ``LIBRARY_ATOL``) on x ~ N(0, 1) f32 [S] made
    from ``seed``, and with ``edges`` on every case of
    :func:`edge_cases` at S; then time each (``TIMERS``).  ``launches``
    counts the kernel launches of the checked calls, before any timing.
    Raises when ``device`` is not a CUDA device or a check fails."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probe times kernels on a CUDA device, not {dev}")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(S).astype(np.float32)).to(dev)
    weight = torch.ones(1, 1, 2 * halo + 1, device=dev)
    want = shift_sum_ref(x, halo)
    before = dict(shift_sum.launches)
    got = {v: shift_sum(x, halo, v) for v in VARIANTS}
    n_edges = check_edges(S, dev) if edges else 0
    torch.cuda.synchronize()
    launches = {v: shift_sum.launches[v] - before[v] for v in VARIANTS}
    lib_err = float((_conv1d(x, weight, halo) - want).abs().max())
    if lib_err > LIBRARY_ATOL:
        raise AssertionError(f"conv1d off by {lib_err} (atol {LIBRARY_ATOL})")
    variants = {}
    for v in VARIANTS:
        if not same_bits(got[v], want):
            raise AssertionError(f"shift_sum[{v}] differs from the plain "
                                 f"version by {float((got[v] - want).abs().max())}")
        call = (lambda v=v: shift_sum(x, halo, v))
        variants[v] = dict(max_abs_err=0.0, bit_identical=True,
                           ms=cuda_ms(call), device_ms=device_ms(call),
                           device_warm_ms=device_ms(call, warm=True))
    del got, want
    lib = (lambda: _conv1d(x, weight, halo))
    return dict(
        S=S, halo=halo, variants=variants, launches=launches,
        edge_cases=n_edges, timers=TIMERS,
        plain_ms=cuda_ms(lambda: shift_sum_ref(x, halo), 5),
        library_ms=cuda_ms(lib), library_device_ms=device_ms(lib),
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
