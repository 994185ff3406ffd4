"""Port parity: the shift sum's plain version against the three TPU
mechanism probes of scratch/dense_probe.py (pallas_transpose,
pallas_laneroll, pallas_dma) in interpret mode, and against the script's
own numpy reference.  The hand-written CUDA kernels are tested against
the plain version in tests/test_torch_cuda.py; here a numpy model of
their index walk (``model_global``, ``model_smem``) is held bit for bit
to the plain version.

The probe script reads its size from ``sys.argv`` and its interpret flag
from the environment when it is imported, so the JAX side runs once, in
a subprocess, on two 64k blocks."""

import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gfasort_tpu_torch import kernels  # noqa: E402
from gfasort_tpu_torch.ops.shift_sum import (HALOS, VARIANTS,  # noqa: E402
                                             shift_sum, shift_sum_ref)

REPO = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-4    # the probe script's own check tolerance
H = 8
BLOCK = 128 * 512   # the probes' block: the wrapping probes wrap inside it

_PROBE = textwrap.dedent("""
    import importlib.util, os, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    repo, out = sys.argv[1:3]
    os.environ["DENSE_PROBE_INTERPRET"] = "1"
    sys.argv = ["dense_probe.py", "0.131072"]   # two 64k blocks
    spec = importlib.util.spec_from_file_location(
        "dense_probe", os.path.join(repo, "scratch", "dense_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    # the script turns on a persistent compilation cache: write nothing
    jax.config.update("jax_enable_compilation_cache", False)
    x = np.random.default_rng(0).standard_normal(probe.S).astype(np.float32)
    xj = jax.numpy.asarray(x)
    np.savez(out, x=x, ref_out=probe.ref_out(x),
             transpose=np.asarray(probe.pallas_transpose(xj)),
             laneroll=np.asarray(probe.pallas_laneroll(xj)),
             dma=np.asarray(probe.pallas_dma(xj)))
""")


@pytest.fixture(scope="module")
def probes(tmp_path_factory):
    out = tmp_path_factory.mktemp("dense_probe") / "probes.npz"
    run = subprocess.run([sys.executable, "-c", _PROBE, str(REPO), str(out)],
                         cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    assert res["x"].shape == (2 * BLOCK,)
    return res


def _port(x):
    return shift_sum_ref(torch.from_numpy(x), H).numpy()


def test_ref_matches_pallas_dma_everywhere(probes):
    """pallas_dma zero-pads its edges, as the port does."""
    np.testing.assert_allclose(_port(probes["x"]), probes["dma"], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("probe", ["transpose", "laneroll"])
def test_ref_matches_wrapping_probes_inside_each_block(probes, probe):
    """The transpose and lane-roll probes wrap inside each 64k block, so
    only the interior of every block is compared."""
    got, want = _port(probes["x"]), probes[probe]
    for b in range(len(got) // BLOCK):
        sl = slice(b * BLOCK + H + 128, (b + 1) * BLOCK - 128)
        np.testing.assert_allclose(got[sl], want[sl], rtol=0, atol=ATOL)


def test_ref_matches_probe_numpy_reference(probes):
    """The script's ``ref_out`` rolls around the whole array: its
    interior is the same sum."""
    np.testing.assert_allclose(_port(probes["x"])[H:-H],
                               probes["ref_out"][H:-H], rtol=0, atol=ATOL)


@pytest.mark.parametrize("halo", HALOS)
def test_ref_is_the_zero_padded_window_sum(halo):
    """Every halo the kernels are built for, against a float64 window sum
    of the same zero-padded input, with the first and last elements."""
    x = np.random.default_rng(halo).standard_normal(1000).astype(np.float32)
    xp = np.pad(x.astype(np.float64), halo)
    want = sum(xp[j: j + len(x)] for j in range(2 * halo + 1))
    got = shift_sum_ref(torch.from_numpy(x), halo).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * (2 * halo + 1))


@pytest.mark.parametrize("variant", VARIANTS)
def test_cpu_inputs_run_the_plain_version(monkeypatch, variant):
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(kernels, "library", refuse)
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal(5000).astype(np.float32))
    before = dict(shift_sum.launches)
    assert torch.equal(shift_sum(x, 8, variant), shift_sum_ref(x, 8))
    assert shift_sum.launches == before


def test_shift_sum_validates_inputs():
    x = torch.zeros(100)
    with pytest.raises(ValueError):
        shift_sum(x, 8, "lane_roll")
    with pytest.raises(ValueError):
        shift_sum(x, 3)
    with pytest.raises(ValueError):
        shift_sum(x.double())
    with pytest.raises(ValueError):
        shift_sum(x.reshape(10, 10))
    with pytest.raises(ValueError):   # no silent fallback off cpu/cuda
        shift_sum(torch.empty(100, device="meta"))


# ---- numpy model of csrc/shift_sum.cu ------------------------------------
#
# The model follows the kernels' index walk: the element offset A of the
# view past a 16-byte boundary, the vectors v + kLo .. v + kHi each output
# vector reads (the aligned superset of the halo), a whole vector as one
# aligned load inside the view, straddling vectors element by element with
# zeros outside; in `global` the warps' own vectors, the edge vectors of
# their first and last lanes and the shuffles that hand each lane its
# neighbours' elements; in `smem` each block's staged tile and halo and
# each thread's run of staged vectors;
# the sums in ascending k from the k = -halo term; the vector stores and
# the tail past S.

CU = (REPO / "gfasort_tpu_torch" / "csrc" / "shift_sum.cu").read_text()


def _cu_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


THREADS = _cu_constant("kThreads")
F32 = np.float32


def _cu_window_expr(name):
    """``Window``'s constexpr ``name`` as a Python expression of HALO and
    A (C's ``c ? a : b`` and its division of non-negative ints)."""
    expr = re.search(rf"static constexpr int {name} = (.+);", CU).group(1)
    m = re.fullmatch(r"(.+) \? (.+) : (.+)", expr)
    if m:
        expr = f"({m.group(2)}) if ({m.group(1)}) else ({m.group(3)})"
    return expr.replace("/", "//")


WINDOW = {name: _cu_window_expr(name) for name in ("kLo", "kHi", "kQ")}


def _window(halo, a):
    """(kLo, kHi, kQ) of ``Window<halo, a>``, from the kernel's source."""
    env = {"HALO": halo, "A": a}
    env["kLo"] = eval(WINDOW["kLo"], {}, env)
    return (env["kLo"], eval(WINDOW["kHi"], {}, env),
            eval(WINDOW["kQ"], {}, env))


def _load_vecs(buf, off, S, v):
    """Vectors ``v`` of the view ``buf[off: off + S]`` as ``load_vec``
    and ``stage_tile`` load them, [..., 4]; a vector wholly inside the
    view must start on a 16-byte boundary of ``buf`` (one aligned load)."""
    g = 4 * np.asarray(v)[..., None] - off % 4 + np.arange(4)
    whole = (g[..., 0] >= 0) & (g[..., 0] <= S - 4)
    assert np.all((off + g[..., 0][whole]) % 4 == 0)
    inside = (g >= 0) & (g < S)
    return np.where(inside, buf[off + np.clip(g, 0, S - 1)], F32(0))


def _window_sums(w, halo, q):
    """The four sums of each output vector from its window ``w`` [...,
    4 kVecs], in the kernels' order."""
    sums = []
    for c in range(4):
        acc = w[..., q + c - halo].copy()
        for k in range(-halo + 1, halo + 1):
            acc = acc + w[..., q + c + k]
        sums.append(acc)
    return np.stack(sums, -1)


def _store(out, written, v, r, S):
    """``store_vec`` of output vectors ``v`` (the tail past S dropped)."""
    s = 4 * np.asarray(v)[..., None] + np.arange(4)
    keep = s < S
    out[s[keep]] = r[keep]
    np.add.at(written, s[keep], 1)


def model_global(buf, off, S, halo):
    """``shift_sum_global`` on the view ``buf[off: off + S]``."""
    lo, hi, q = _window(halo, off % 4)
    nvec = -(-S // 4)
    v = np.arange(-(-nvec // THREADS) * THREADS)
    v = v[4 * (v - (v & 31)) < S].reshape(-1, 32)   # warps not past S
    lane = np.arange(32)
    own = _load_vecs(buf, off, S, v)
    edge = np.zeros_like(own)
    left = lane >= 32 + lo
    right = ~left & (lane < hi)
    edge[:, left] = _load_vecs(buf, off, S, v[:, left] - 32)
    edge[:, right] = _load_vecs(buf, off, S, v[:, right] + 32)
    w = np.zeros(v.shape + (4 * (hi - lo + 1),), F32)
    for m in range(lo, hi + 1):
        for c in range(4):
            qq = 4 * (m - lo) + c
            if qq < q - halo or qq > q + 3 + halo:
                continue
            if m == 0:
                w[..., qq] = own[..., c]
                continue
            # each source lane offers what its reader lane - m needs
            mine = lane >= m if m > 0 else lane < 32 + m
            offer = np.where(mine, own[..., c], edge[..., c])
            w[..., qq] = offer[:, (lane + m) & 31]
    out = np.full(S, np.nan, F32)
    written = np.zeros(S, np.int64)
    _store(out, written, v, _window_sums(w, halo, q), S)
    assert np.all(written == 1)
    return out


def model_smem(buf, off, S, halo):
    """``shift_sum_smem`` on the view ``buf[off: off + S]``: block b
    stages vectors b kThreads + kLo .. b kThreads + kThreads - 1 + kHi."""
    lo, hi, q = _window(halo, off % 4)
    blocks = -(-(-(-S // 4)) // THREADS)
    b = np.arange(blocks)
    tile = _load_vecs(buf, off, S,
                      b[:, None] * THREADS + lo + np.arange(THREADS + hi - lo))
    j = np.arange(THREADS)
    w = tile[:, j[:, None] + np.arange(hi - lo + 1)].reshape(
        blocks, THREADS, -1)
    out = np.full(S, np.nan, F32)
    written = np.zeros(S, np.int64)
    _store(out, written, b[:, None] * THREADS + j, _window_sums(w, halo, q), S)
    assert np.all(written == 1)
    return out


def _assert_same_bits(got, want, what):
    """Equal bit for bit outside NaN, NaN at the same places (CPU NaN
    payloads follow the operand order of the vector unit)."""
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), what
    assert np.array_equal(got.view(np.int32)[~nan], want.view(np.int32)[~nan]), what


def _edge_input(S, seed):
    """f32 [S + 3] from ``seed``: normal values, -0.0 at both ends of
    every view offset 0-3 and inside, +-inf and NaN inside."""
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal(S + 3).astype(F32)
    for i in (0, 1, 2, 3, S - 1, S, S + 1, S + 2):
        if i < len(buf):
            buf[i] = -0.0
    if S >= 64:
        at = rng.choice(np.arange(4, S - 1), 6, replace=False)
        buf[at] = [-0.0, -0.0, np.inf, -np.inf, np.nan, 0.0]
    return buf


@pytest.mark.parametrize("S", [1, 2, 3, 5, 4 * 1024 + 1, 70_001, 196_608])
@pytest.mark.parametrize("halo", HALOS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_model_equals_plain_version(variant, halo, S):
    """Every view offset 0-3 into a 16-byte aligned buffer (the kernels'
    A), S below one vector, S = 1, 2, 3 mod 4, one tile and one element,
    many tiles."""
    buf = _edge_input(S, seed=S + halo)
    for off in range(4):
        x = buf[off: off + S]
        want = shift_sum_ref(torch.from_numpy(x.copy()), halo).numpy()
        if variant == "global":
            got = model_global(buf, off, S, halo)
        else:
            got = model_smem(buf, off, S, halo)
        _assert_same_bits(got, want, f"{variant} halo {halo} S {S} off {off}")


@pytest.mark.parametrize("halo", HALOS)
def test_window_is_the_aligned_superset_of_the_halo(halo):
    """Output vector v's terms lie in vectors v + kLo .. v + kHi (the
    kernel's expressions), and the first and last of those hold a term:
    kLo = floor((A - halo) / 4), kHi = floor((halo + 3 + A) / 4)."""
    for a in range(4):
        lo, hi, q = _window(halo, a)
        d = np.arange(-halo, halo + 4) + a    # vector-space offsets of 4v
        assert d.min() // 4 == lo and d.max() // 4 == hi
        assert q - halo == d.min() - 4 * lo
