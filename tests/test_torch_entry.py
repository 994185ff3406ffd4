"""Port parity: the entry points (``gfasort_tpu_torch/entry.py``,
``tools/bench_scaling.py``, ``tools/e2e_chromosome.py``) and the
package's top-level names, against ``__graft_entry__.py``,
``bench_scaling.py`` and ``gfasort_tpu/__init__.py``, on the CPU.

* ``entry("cpu")``'s round equals the JAX ``entry()`` round run op by
  op bit for bit, and ``jax.jit`` of it within rtol 1e-6 / atol 1e-5
  (bit-equal too on XLA:CPU here; XLA may fuse differently elsewhere).
* ``dryrun_multichip(8, "cpu")`` runs the three multi-device engines.
* The scaling twin's rows on 1, 2 and 4 CPU shards carry the JAX
  script's keys, and their ``shard_len`` and ``consensus_every`` equal
  the JAX ``build_sharded_sweep`` info at the same shape (built only).
* The e2e twin runs ``sYgsuL`` on ~5k nodes and keeps every path hash.
"""

import json
import pathlib
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
import gfasort_tpu  # noqa: E402
import gfasort_tpu_torch  # noqa: E402
from gfasort_tpu import bench_util as j_bench  # noqa: E402
from gfasort_tpu.io import gfa as j_gfa  # noqa: E402
from gfasort_tpu.parallel import default_mesh as j_default_mesh  # noqa: E402
from gfasort_tpu.parallel.sweep_shard import build_sharded_sweep as j_build  # noqa: E402
from gfasort_tpu_torch import entry as t_entry  # noqa: E402
from gfasort_tpu_torch.bench_util import synthetic_path_index  # noqa: E402
from gfasort_tpu_torch.io import gfa as t_gfa  # noqa: E402
from gfasort_tpu_torch.tools import bench_scaling, e2e_chromosome  # noqa: E402

# the keys of a strong-scaling row of bench_scaling.py
ROW_KEYS = {"devices", "updates_per_s", "updates_per_s_per_device",
            "scaling_efficiency", "virtual_devices", "weak",
            "psum_bytes_per_consensus", "shard_len", "consensus_every",
            "grid_consensus", "period_wall_ms", "sweeps_wall_ms",
            "collective_ms", "collective_frac", "model", "spearman_vs_1dev"}
SCALING_SHAPE = (3000, 6, 1500)


def test_top_level_names_equal_jax():
    assert gfasort_tpu_torch.__all__ == gfasort_tpu.__all__
    for name in gfasort_tpu_torch.__all__:
        ours, theirs = (getattr(m, name) for m in (gfasort_tpu_torch,
                                                   gfasort_tpu))
        assert ours.__name__ == theirs.__name__
        assert ours.__module__.replace("gfasort_tpu_torch", "gfasort_tpu") \
            == theirs.__module__


def test_toy_graph_equals_jax():
    for args in ((), (32, 8)):
        assert t_gfa.write_gfa(t_entry._toy_graph(*args)) == \
            j_gfa.write_gfa(graft._toy_graph(*args))


def test_entry_round_equals_jax():
    fn, (x0, key, eta) = t_entry.entry("cpu")
    out = fn(x0, key, eta)
    assert out.dtype == torch.float32 and x0.device.type == "cpu"
    jfn, (jx0, jkey, jeta) = graft.entry()
    np.testing.assert_array_equal(np.asarray(jx0), x0.numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jkey)), key)
    assert float(jeta) == float(eta)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jfn(jx0, jkey, jeta)))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax.jit(jfn)(jx0, jkey, jeta)),
                               rtol=1e-6, atol=1e-5)
    # the round moves positions, and a second call gives the same
    assert not torch.equal(out, x0)
    assert torch.equal(fn(x0, key, eta), out)


def test_entry_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_entry.entry()


@pytest.fixture
def one_thread():
    """Tiny tensors on many shards: torch's intra-op threads only
    contend (with each other and with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_multichip_on_8_cpu_shards(one_thread):
    s = t_entry.dryrun_multichip(8, "cpu")
    assert s["shards"] == 8 and s["grid_consensus"] is False
    assert s["sweep_positions"] == 4096 and s["layout_coords"] == [4, 4096]


@pytest.fixture(scope="module")
def scaling_rows():
    return bench_scaling.run_scaling(
        4, device="cpu",
        workload=lambda nd: synthetic_path_index(*SCALING_SHAPE, seed=0),
        reps=1, part_reps=1, emit=lambda line: None)


@pytest.mark.parametrize("nd", [1, 2, 4])
def test_scaling_rows_match_jax_build(scaling_rows, monkeypatch, nd):
    monkeypatch.setenv("GFASORT_CONSENSUS", "gather")
    row = next(r for r in scaling_rows if r["devices"] == nd)
    assert set(row) == ROW_KEYS
    assert row["virtual_devices"] and not row["weak"]
    assert 0.99 <= row["spearman_vs_1dev"] <= 1.0
    pidx = j_bench.synthetic_path_index(*SCALING_SHAPE, seed=0)
    p = replace(j_bench.bench_params(pidx, 1, 1),
                iter_max=bench_scaling.ROUNDS - 1,
                min_term_updates=max(1, int(pidx.total_steps
                                            * bench_scaling.FRAC)))
    _, _, _, info = j_build(pidx, p, j_default_mesh(nd), per_octave=2,
                            consensus_every=None,
                            active_frac=bench_scaling.FRAC, rotate=8,
                            expose_parts=True)
    assert row["shard_len"] == info["shard_len"]
    assert row["consensus_every"] == info["consensus_every"]
    assert row["psum_bytes_per_consensus"] == pidx.num_nodes * 8


def test_e2e_chromosome_twin_keeps_path_hashes(tmp_path):
    assert e2e_chromosome.main(
        ["--nodes", "5000", "--paths", "4", "--steps", "5000",
         "--device", "cpu", "--work-dir", str(tmp_path)]) == 0
    art = json.loads(pathlib.Path(tmp_path, "E2E_CHROMOSOME.json").read_text())
    assert art["path_hashes_preserved"] and art["device"] == "cpu"
    w = art["workload"]
    assert w["output_nodes"] <= w["input_nodes"] == 5000
    assert [e["event"] for e in art["step_timings"]] == [
        "topo-sort", "SGD", "groom", "topo-sort", "unchop", "2D layout"]
    lines = (tmp_path / "layout.tsv").read_text().split("\n")
    assert len([ln for ln in lines[1:] if ln]) == w["output_nodes"]
