"""The sweep engine's per-sweep sampler in plain PyTorch.

Counterparts of ``gfasort_tpu/ops/sweep_common.py``: the per-sweep
draws (``sweep_rng``: the murmur-hash RNG, or the ``jax.random``
threefry draws of :mod:`.jrandom` under ``GFASORT_SWEEP_RNG=threefry``
and always in f64), the P-proposal sampler (``sample_blocks``, the
shared-chain form that the JAX tests hold bit-identical to P
single-proposal calls; its Zipf maths runs in the run's dtype, f32 or
f64) and the 8-bit choice packing.  The JAX code is XLA, not a Pallas
kernel: XLA fuses the few hundred u32/f32 ops per proposal.  The port's
counterpart of that fusion is :func:`sample_words`, which launches the
hand-written kernel ``csrc/sweep_sampler.cu`` on a CUDA tensor (every
route: hash or threefry draws, f32 or f64) and runs
:func:`sample_words_ref`, the composition of the plain functions here,
on a CPU tensor.

Unsigned 32-bit arithmetic runs in int64 masked to 32 bits: torch's
uint32 supports few ops, and a right shift of an int32 is arithmetic.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import torch

import numpy as np

from . import jrandom
from .keys import split, sweep_key_table, threefry_key_table
from .sweep_plan import PhasePlan

__all__ = ["INACTIVE", "INACTIVE8", "PACKED_INACTIVE", "sweep_rng",
           "threefry_route", "threefry_draws", "route_keys",
           "SamplerConsts", "sampler_consts", "snap_idx_track", "zipf_core",
           "sample_blocks", "sample_words", "sample_words_ref",
           "pack_choices", "pack_choices_words", "pack_words",
           "unpack_choice"]

# Sentinel "no partner chosen" value of a choice array, as in the JAX
# package (i32, positive, far above any bucket index; ~INACTIVE is far
# below any ~ki).
INACTIVE = np.int32(0x7FFFFFF)

# Multi-proposal packing: up to 4 signed choices in one i32, one 8-bit
# two's-complement field per proposal.  A choice is ki (0..63), ~ki
# (-64..-1) or INACTIVE8 (127, no ki can equal it).
INACTIVE8 = np.int32(127)
PACKED_INACTIVE = np.int32(0x7F7F7F7F)  # all four fields INACTIVE8

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without overflowing
    int64: the high 16 bits of x only need c's low 16 bits."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = _mul32(x, 0x9E3779B9)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def threefry_route(mode: str, dtype) -> bool:
    """Whether a sweep draws threefry bits: under ``mode`` "threefry",
    and always in f64 (the JAX ``sweep_rng``)."""
    return mode == "threefry" or dtype == torch.float64


def threefry_draws(keys, S: int, device, dtype=torch.float32):
    """The threefry draws from one proposal's ``(k1, k2)`` (u32 [2, 2], a
    row of ``keys.threefry_key_table``): ``bits(k1, (S,))`` and
    ``uniform(k2, (S,), dtype)``, as ``jax.random`` draws them."""
    k1, k2 = np.asarray(keys, dtype=np.uint32)
    return (jrandom.bits(k1, (S,), device),
            jrandom.uniform(k2, (S,), dtype, device))


def route_keys(base_key, n_exec: int, proposals: int, mode: str, dtype):
    """A run's key table for its draws: ``keys.sweep_key_table``, or its
    ``keys.threefry_key_table`` where the run draws threefry bits
    (:func:`threefry_route`)."""
    table = sweep_key_table(base_key, n_exec, proposals)
    return threefry_key_table(table) if threefry_route(mode, dtype) else table


def sweep_rng(words, S: int, device, mode: str = "hash",
              dtype=torch.float32):
    """Per-sweep randomness from a key's ``(b2, b1)`` words: (bits int64
    [S] holding u32 values, u [S] in [0, 1) of ``dtype``).  ``mode``
    ``hash`` (f32 only) mixes the lane counter with the words;
    ``threefry`` (always taken in f64) splits the key in two and draws
    ``bits(k1, (S,))`` and ``uniform(k2, (S,), dtype)`` as
    ``jax.random`` does."""
    if threefry_route(mode, dtype):
        return threefry_draws(split(np.asarray(words, dtype=np.uint32), 2),
                              S, device, dtype)
    if mode != "hash":
        raise ValueError(f"unknown sweep RNG mode {mode!r}")
    b2, b1 = (int(w) for w in words)
    i = torch.arange(S, dtype=torch.int64, device=device)
    h = _mix((i + b1) & _M32)
    bits = _mix(h ^ b2)
    salt = (((b2 * 0x9E3779B9) & _M32) + 0x632BE59B) & _M32
    u_bits = _mix(h ^ salt)
    u = (u_bits >> 8).to(torch.float32) * 2.0 ** -24
    return bits, u


@dataclass(frozen=True)
class SamplerConsts:
    """One phase's sampler constants for one cooling state, on the
    device, in the run's dtype.  Built once per run: a host-to-device
    copy in the sweep loop would synchronise the stream every sweep."""

    offs: torch.Tensor          # i32 [K]
    zeta: torch.Tensor          # [K]
    eta_z: torch.Tensor         # [K]
    zeta2theta: torch.Tensor    # []
    alpha: torch.Tensor         # []
    space: int


def sampler_consts(phase: PhasePlan, cooling: bool, device,
                   dtype=torch.float32) -> SamplerConsts:
    """The plan's f64 constants rounded to ``dtype``; alpha computed in
    ``dtype``, as the JAX sampler does."""
    c = int(bool(cooling))
    npd = np.float32 if dtype == torch.float32 else np.float64
    return SamplerConsts(
        offs=torch.as_tensor(phase.offs, device=device),
        zeta=torch.as_tensor(phase.zeta[c].astype(npd), device=device),
        eta_z=torch.as_tensor(phase.eta_z[c].astype(npd), device=device),
        zeta2theta=torch.as_tensor(npd(phase.zeta2theta[c]), device=device),
        alpha=torch.as_tensor(npd(phase.alpha(cooling, npd)), device=device),
        space=phase.space,
    )


def snap_idx_track(offs: torch.Tensor, z: torch.Tensor, want_hi: bool):
    """Index of the largest offset <= max(z, 1), its offset and, with
    ``want_hi``, ``offs[min(idx + 1, K - 1)]`` (all int32)."""
    z = torch.clamp_min(z, 1)
    idx = torch.searchsorted(offs, z, right=True, out_int32=True) - 1
    lo = offs[idx]
    hi = offs[torch.clamp_max(idx + 1, len(offs) - 1)] if want_hi else None
    return idx, lo, hi


def zipf_core(u, jump_space, zeta, eta_z, zeta2theta, alpha):
    """Inverse-CDF Zipf draw from pre-selected bucket constants
    (``_zipf_core``): maths in ``u``'s dtype, a NaN guard, truncation to
    int32."""
    n = torch.clamp_min(jump_space, 1).to(u.dtype)
    uz = u * zeta
    arg = torch.clamp_min(eta_z * u - eta_z + 1.0, 1e-30)
    general = 1.0 + n * torch.exp(alpha * torch.log(arg))
    general = torch.where(torch.isnan(general), 0.0, general)
    g = torch.minimum(torch.clamp_min(general, 0.0), n).to(torch.int32)
    one = torch.ones_like(g)
    z = torch.where(uz < 1.0, one, torch.where(uz < zeta2theta, one + 1, g))
    return torch.minimum(z, jump_space)


def sample_blocks(consts: SamplerConsts, bu_pairs, cooling: bool,
                  rank: torch.Tensor, cnt: torch.Tensor, active_frac: float,
                  snap: str = "stoch"):
    """One signed choice array per proposal: ``ki`` picks the partner at
    ``+offs[ki]``, ``~ki`` the one at ``-offs[ki]``, INACTIVE none.

    ``consts``: the phase's constants for this ``cooling`` state.
    ``bu_pairs`` yields one (bits, u) pair per proposal, so a caller may
    hand a generator and keep one proposal's RNG in memory at a time.
    ``rank``/``cnt`` are int32 [S]; ``snap`` is ``"stoch"`` (the
    mean-preserving stochastic snap, the JAX default) or ``"down"``.
    The float maths runs in the dtype of the draws' ``u`` (that of
    ``consts``)."""
    if snap not in ("stoch", "down"):
        raise ValueError(f"unknown snap mode {snap!r}")
    offs = consts.offs

    # the two direction chains, computed once and selected per proposal;
    # a table lookup picks the constant the JAX ``const_tree`` where-tree
    # selects
    avail_b = rank
    avail_f = cnt - 1 - rank
    shared = []
    for avail_d in (avail_b, avail_f):
        js_d = torch.clamp_max(avail_d, consts.space)
        js_idx, _, _ = snap_idx_track(offs, torch.clamp_min(js_d, 1), False)
        shared.append((js_d, consts.zeta[js_idx], consts.eta_z[js_idx]))
    has_path = cnt > 1
    back_base = rank > 0
    last = rank == cnt - 1
    not_last = rank < cnt - 1
    thresh = int(active_frac * (1 << 20))

    out = []
    for bits, u in bu_pairs:
        coin1 = (bits >> 31) == 1
        coin2 = ((bits >> 30) & 1) == 1
        act = (bits & 0xFFFFF) < thresh if active_frac < 1.0 else None
        use_zipf = coin1 | cooling
        backward = back_base & (coin2 | last)
        forward = ~backward & not_last
        avail = torch.where(backward, avail_b, avail_f)
        jump_space = torch.where(backward, shared[0][0], shared[1][0])
        zeta = torch.where(backward, shared[0][1], shared[1][1])
        eta_z = torch.where(backward, shared[0][2], shared[1][2])
        z_zipf = zipf_core(u, jump_space, zeta, eta_z, consts.zeta2theta,
                           consts.alpha)
        fdt = u.dtype
        z_unif = 1 + (u * torch.clamp_min(avail, 1).to(fdt)).to(torch.int32)
        z = torch.where(use_zipf, z_zipf, z_unif)
        if snap == "stoch":
            oidx, off_lo_i, off_hi = snap_idx_track(offs, z, True)
            off_lo = off_lo_i.to(fdt)
            u2 = ((bits >> 20) & 0x1FF).to(fdt) * (1.0 / 512.0)
            qfrac = (z.to(fdt) - off_lo) / torch.clamp_min(
                off_hi.to(fdt) - off_lo, 1.0)
            promote = (u2 < qfrac) & (off_hi <= avail)
            oidx = torch.where(promote, oidx + 1, oidx)
            off_sel = torch.where(promote, off_hi, off_lo_i)
        else:
            oidx, off_sel, _ = snap_idx_track(offs, z, False)
        active = (forward | backward) & has_path & (off_sel <= avail)
        if act is not None:
            active = active & act
        choice = torch.where(backward, ~oidx, oidx)
        out.append(torch.where(active, choice, int(INACTIVE)).to(torch.int32))
    return out


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_choices(sidxs) -> torch.Tensor:
    """Pack 1-4 choice arrays into one int32 array, proposal p in bits
    [8p, 8p + 8) as a signed 8-bit field (INACTIVE -> INACTIVE8)."""
    if not 1 <= len(sidxs) <= 4:
        raise ValueError("pack_choices takes 1 to 4 choice arrays")
    packed = None
    for p, s in enumerate(sidxs):
        s8 = (torch.where(s == int(INACTIVE), int(INACTIVE8), s).to(torch.int64)
              & 0xFF)
        word = s8 << (8 * p)
        packed = word if packed is None else packed | word
    return _to_i32(packed)


def pack_choices_words(sidxs) -> list:
    """ceil(P/4) packed words for any number of choice arrays."""
    return [pack_choices(sidxs[w: w + 4]) for w in range(0, len(sidxs), 4)]


def unpack_choice(packed: torch.Tensor, p: int) -> torch.Tensor:
    """Signed 8-bit field p of a packed int32 array."""
    field = (packed >> (8 * p)) & 0xFF
    return torch.where(field >= 128, field - 256, field)


def pack_words(sidxs) -> list:
    """The choice words the bucket and roll kernels read: the raw choice
    array for one proposal, else :func:`pack_choices_words`."""
    return list(sidxs[:1]) if len(sidxs) == 1 else pack_choices_words(sidxs)


def _key_rows(key_words, threefry: bool) -> np.ndarray:
    """A sweep's key rows as u32: ``[P, 2]`` ``(b2, b1)`` words for hash
    draws, ``[P, 2, 2]`` ``(k1, k2)`` keys for threefry draws."""
    rows = np.asarray(key_words, dtype=np.uint32)
    want = (2, 2) if threefry else (2,)
    if rows.ndim != 1 + len(want) or rows.shape[1:] != want:
        kind = ("a threefry_key_table row [P, 2, 2]" if threefry
                else "a sweep_key_table row [P, 2]")
        raise ValueError(f"the draws take {kind}, got {list(rows.shape)}")
    return rows


def sample_words_ref(consts: SamplerConsts, key_words, cooling: bool,
                     rank: torch.Tensor, cnt: torch.Tensor,
                     active_frac: float, snap: str = "stoch",
                     rng: str = "hash", coin: bool = False):
    """Plain PyTorch version of :func:`sample_words`: the draws
    (``sweep_rng``'s, or :func:`threefry_draws` from the keys) ->
    :func:`sample_blocks` -> :func:`pack_words`, in the dtype of
    ``consts``.  Returns (words, proposal 0's end coin as bool [S] or
    None)."""
    S = rank.shape[0]
    dtype = consts.zeta.dtype
    threefry = threefry_route(rng, dtype)
    rows = _key_rows(key_words, threefry)

    def draws(row):
        if threefry:
            return threefry_draws(row, S, rank.device, dtype)
        return sweep_rng(row, S, rank.device, rng, dtype)

    first = draws(rows[0])
    end_coin = ((first[0] >> 29) & 1) == 1 if coin else None
    rest = (draws(row) for row in rows[1:])
    sidxs = sample_blocks(consts, itertools.chain([first], rest), cooling,
                          rank, cnt, active_frac, snap)
    return pack_words(sidxs), end_coin


def sample_words(consts: SamplerConsts, key_words, cooling: bool,
                 rank: torch.Tensor, cnt: torch.Tensor, active_frac: float,
                 snap: str = "stoch", rng: str = "hash", coin: bool = False):
    """One sweep's choice words: P = len(key_words) proposals in the
    dtype of ``consts`` (f32 or f64).  ``rng`` is the ``sweep_rng`` mode;
    the route draws threefry bits under "threefry" and always in f64
    (:func:`threefry_route`), and ``key_words`` is then a row of
    ``keys.threefry_key_table`` (``(k1, k2)`` per proposal), else a row
    of ``keys.sweep_key_table`` (``(b2, b1)`` per proposal).  Returns
    (words, end coin): ceil(P/4) packed int32 [S] words (the raw int32
    choices for P = 1), and with ``coin`` proposal 0's ``(bits >> 29) &
    1`` as bool [S] (the nD engine's end coin), else None.

    CUDA tensors launch ``csrc/sweep_sampler.cu`` and count one launch in
    ``sample_words.launches``; CPU tensors run :func:`sample_words_ref`."""
    if snap not in ("stoch", "down"):
        raise ValueError(f"unknown snap mode {snap!r}")
    if rng not in ("hash", "threefry"):
        raise ValueError(f"unknown sweep RNG mode {rng!r}")
    P = len(key_words)
    if not 1 <= P <= 16:
        raise ValueError(f"1 to 16 proposals, got {P}")
    S = rank.shape[0]
    for name, t in (("rank", rank), ("cnt", cnt)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != S:
            raise ValueError(f"{name} must be int32 [{S}], got {t.dtype} "
                             f"{list(t.shape)}")
        if t.device != rank.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {rank.device}")
    dtype = consts.zeta.dtype
    if dtype not in (torch.float32, torch.float64) or any(
            t.dtype != dtype for t in (consts.eta_z, consts.zeta2theta,
                                       consts.alpha)):
        raise ValueError("the sampler constants must all be float32 or all "
                         "float64")
    threefry = threefry_route(rng, dtype)
    rows = _key_rows(key_words, threefry)
    if rank.device.type == "cpu":
        return sample_words_ref(consts, rows, cooling, rank, cnt,
                                active_frac, snap, rng, coin)
    if rank.device.type != "cuda":
        raise ValueError(f"sample_words runs on cpu or cuda, not {rank.device}")
    if S >= 1 << 31:
        raise ValueError(f"{S} steps exceed the kernel's int32 indexing")
    if not 1 <= consts.offs.shape[0] <= 64:
        raise ValueError(f"1 to 64 offsets, got {consts.offs.shape[0]}")
    if consts.offs.device != rank.device:
        raise ValueError(f"the sampler constants lie on {consts.offs.device}, "
                         f"the steps on {rank.device}")
    from ..kernels import sweep_sampler_cuda

    out = sweep_sampler_cuda(consts, rows, cooling, rank, cnt, active_frac,
                             snap, coin, threefry=threefry)
    sample_words.launches += 1
    return out


sample_words.launches = 0
