"""The port's twin of ``bench.py`` (``python -m gfasort_tpu_torch.tools.bench``)
on the CPU at tiny sizes: every stdout line is one parsable result, the
last is complete and has ``bench.py``'s result keys, the twin's
configurations equal ``bench.py``'s, and the run imports neither ``jax``
nor the JAX package."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from gfasort_tpu_torch.tools import bench as twin  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

# bench.py's result keys (bench.py:127-147) plus the headline's warmup_s
RESULT_KEYS = {
    "metric", "value", "unit", "vs_baseline", "vs_baseline_mt",
    "quality_mode_value", "quality_mode_cert", "quality", "cli_default",
    "nd_layout", "nd_layout_3d", "roofline", "fallback",
    "quality_full_schedule", "oracle_1t", "oracle_mt", "elapsed_s",
    "partial", "warmup_s",
}

TINY = dict(BENCH_NODES="1000", BENCH_PATHS="4", BENCH_STEPS_PER_PATH="1000",
            BENCH_ROUNDS="4", BENCH_CERT_NODES="1000",
            BENCH_CERT_LAYOUT_NODES="500", BENCH_QFS_NODES="1000")

# runs the twin as ``python -m`` does, then lists the JAX modules loaded
_CHILD = textwrap.dedent("""
    import json, runpy, sys
    sys.argv = ["bench", "--device", "cpu"]
    try:
        runpy.run_module("gfasort_tpu_torch.tools.bench", run_name="__main__")
        rc = 0
    except SystemExit as e:
        rc = e.code
    bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
                 or k == "gfasort_tpu" or k.startswith("gfasort_tpu."))
    print("MODULES " + json.dumps(bad), file=sys.stderr)
    sys.exit(rc)
""")


def _bench_py():
    """``bench.py`` as a module (it imports JAX only inside ``main``)."""
    spec = importlib.util.spec_from_file_location("bench_py", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def twin_run():
    env = dict(os.environ, OMP_NUM_THREADS="2", **TINY)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    return out


def test_twin_emits_every_section_and_bench_py_keys(twin_run):
    assert twin_run.returncode == 0, twin_run.stderr[-4000:]
    lines = [json.loads(line) for line in twin_run.stdout.splitlines()]
    # one emit after each of sections 2-11, two for each of 6-8
    assert len(lines) == 11
    assert all(line["partial"] for line in lines[:-1])
    last = lines[-1]
    assert last["partial"] is False
    assert set(last) == RESULT_KEYS
    assert all(set(line) <= RESULT_KEYS for line in lines)
    assert last["value"] > 0 and last["metric"] == "sgd_pair_updates_per_s_per_chip"
    for key in ("quality", "cli_default", "quality_mode_cert", "nd_layout",
                "nd_layout_3d", "quality_full_schedule"):
        assert isinstance(last[key]["ok"], bool)
    assert last["nd_layout"]["ratio"] > 0 and last["nd_layout_3d"]["ratio"] > 0
    roof = last["roofline"]
    assert roof["model"] == "gfasort_tpu_torch.bench_util.roofline_model"
    assert roof["device"] == "cpu" and roof["consensus_ms"] > 0
    assert 0 < roof["applied_frac_exact"] <= 1
    fb = last["fallback"]
    assert fb["auto_selected"] == "gather" and fb["shuffled_coverage"] is None
    assert fb["gather_rate"] > 0 and fb["shuffled_rate"] > 0
    assert last["quality_full_schedule"]["iter_max"] == 100


def test_twin_imports_no_jax(twin_run):
    tag = [line for line in twin_run.stderr.splitlines()
           if line.startswith("MODULES ")]
    assert tag == ["MODULES []"], twin_run.stderr[-4000:]


def test_twin_configs_equal_bench_py():
    ref = _bench_py()
    assert twin.THROUGHPUT_CFG == ref.THROUGHPUT_CFG
    assert twin.QUALITY_CFG == ref.QUALITY_CFG
    assert (twin.MAE_FRAC_MAX, twin.SPEARMAN_MIN, twin.STRESS_RATIO_MAX) == (
        ref.MAE_FRAC_MAX, ref.SPEARMAN_MIN, ref.STRESS_RATIO_MAX)
    assert (twin.N_NODES, twin.N_PATHS, twin.STEPS, twin.ROUNDS,
            twin.FULL) == (ref.N_NODES, ref.N_PATHS, ref.STEPS, ref.ROUNDS,
                           ref.FULL)
    for rounds in (1, 7, 24, 48, 96, 100):
        for ce in (8, 48, 96, 192):
            assert twin._fit_ce(rounds, ce) == ref._fit_ce(rounds, ce)


def test_twin_nd_knobs_equal_bench_py():
    """``bench.py`` sets its nD knobs inside ``main``; they are read from
    its source."""
    src = (REPO / "bench.py").read_text()
    for name in ("ND_ROT", "ND_FRAC", "ND_DU", "ND_P"):
        assert f"    {name} = {getattr(twin, name)!r}\n" in src
    assert "ND_CE = _fit_ce(ROUNDS // 2, 48)" in src


def test_twin_on_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.main(["--device", "cuda"])
