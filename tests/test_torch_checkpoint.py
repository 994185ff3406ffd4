"""The port's checkpoint/resume (``gfasort_tpu_torch/checkpoint.py``), the
three tests of ``tests/test_checkpoint.py`` on the port, on an in-repo
synthetic graph: a segmented run equals the single-shot run bit for bit,
a run stopped after two segments resumes from its saved cursor to the
same result, and a checkpoint of another run is refused.  The
fingerprint equals the JAX package's, so a checkpoint names the same
run in both."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gfasort_tpu import PathIndex as JPathIndex  # noqa: E402
from gfasort_tpu.checkpoint import fingerprint as j_fingerprint  # noqa: E402
from gfasort_tpu.io import gfa as jgfa  # noqa: E402
from gfasort_tpu_torch.index import PathIndex  # noqa: E402
from gfasort_tpu_torch.params import YgsParams  # noqa: E402
from gfasort_tpu_torch.checkpoint import (  # noqa: E402
    fingerprint,
    load_checkpoint,
    path_linear_sgd_checkpointed,
    save_checkpoint,
)
from gfasort_tpu_torch.io import gfa  # noqa: E402
from gfasort_tpu_torch.ops.sgd import path_linear_sgd_batched  # noqa: E402
from gfasort_tpu_torch.tools.make_synthetic_gfa import synthetic_gfa_lines  # noqa: E402

TEXT = "\n".join(synthetic_gfa_lines(120, 3, 150, seed=5)) + "\n"


@pytest.fixture(scope="module")
def setup():
    g = gfa.parse_gfa_numeric(TEXT)
    # 4 iterations of ceil(450 / 64) = 8 rounds: 32 rounds
    p = replace(YgsParams.from_graph(g).path_sgd, dtype="float64",
                pow_mode="fpp", iter_max=3, batch=64)
    pidx = PathIndex.from_graph(g)
    return g, p, pidx, path_linear_sgd_batched(g, p, pidx, device="cpu")


def test_segmented_equals_single_shot(setup, tmp_path):
    g, p, pidx, x_one = setup
    ck = str(tmp_path / "run.ckpt")
    x_seg = path_linear_sgd_checkpointed(g, p, ck, pidx, segment_rounds=7,
                                         device="cpu")
    np.testing.assert_array_equal(x_seg, x_one)
    assert not (tmp_path / "run.ckpt").exists()  # cleaned on success


def test_resume_from_partial(setup, tmp_path):
    g, p, pidx, x_one = setup
    ck = str(tmp_path / "run.ckpt")
    calls = []

    class Stop(Exception):
        pass

    def bail_after_two(nxt, total):
        calls.append((nxt, total))
        if len(calls) == 2:
            raise Stop()

    with pytest.raises(Stop):
        path_linear_sgd_checkpointed(g, p, ck, pidx, segment_rounds=5,
                                     progress=bail_after_two, device="cpu")
    assert calls == [(5, 32), (10, 32)]
    assert (tmp_path / "run.ckpt").exists()
    assert load_checkpoint(ck, fingerprint(p, pidx))[1] == 10
    # resume and finish
    x_res = path_linear_sgd_checkpointed(g, p, ck, pidx, segment_rounds=5,
                                         device="cpu")
    np.testing.assert_array_equal(x_res, x_one)
    assert not (tmp_path / "run.ckpt").exists()


def test_fingerprint_mismatch_rejected(setup, tmp_path):
    g, p, pidx, _ = setup
    ck = str(tmp_path / "run.ckpt")
    fp = fingerprint(p, pidx)
    save_checkpoint(ck, np.zeros(pidx.num_nodes), 5, fp)
    assert load_checkpoint(ck, fp) is not None
    other = replace(p, seed=123)
    with pytest.raises(ValueError, match="different run"):
        load_checkpoint(ck, fingerprint(other, pidx))
    # the JAX package names the same run by the same fingerprint
    jg = jgfa.parse_gfa_numeric(TEXT)
    assert fp == j_fingerprint(p, JPathIndex.from_graph(jg))
    assert load_checkpoint(str(tmp_path / "absent.ckpt"), fp) is None
