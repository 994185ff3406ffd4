"""Port parity: the shift sum's plain version against the three TPU
mechanism probes of scratch/dense_probe.py (pallas_transpose,
pallas_laneroll, pallas_dma) in interpret mode, and against the script's
own numpy reference.  The hand-written CUDA kernels are tested against
the plain version in tests/test_torch_cuda.py.

The probe script reads its size from ``sys.argv`` and its interpret flag
from the environment when it is imported, so the JAX side runs once, in
a subprocess, on two 64k blocks."""

import pathlib
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
