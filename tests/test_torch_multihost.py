"""The port's sharded engines across processes: two CPU processes joined
by a gloo process group (``init_distributed`` from the ``GFASORT_*``
variables), as ``tests/test_multihost.py`` runs the JAX engines.

* 2 processes x 1 shard equal a one-process run on 2 shards bit for bit
  (gloo adds the two processes' partial sums, and a + b == b + a);
* 2 processes x 4 shards give the same result on both ranks, and
  ``cli.main --distributed`` writes the same GFA on both.

Each worker has its own time limit (``communicate(timeout=240)``)."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gfasort_tpu_torch.index import PathIndex  # noqa: E402
from gfasort_tpu_torch.io import gfa  # noqa: E402
from gfasort_tpu_torch.parallel import default_mesh  # noqa: E402
from test_torch_spmd import gfa_text  # noqa: E402

REPO = str(pathlib.Path(__file__).resolve().parent.parent)

ENGINES = """
from dataclasses import replace
from gfasort_tpu_torch.params import LayoutSGDParams, PathSGDParams
from gfasort_tpu_torch.parallel import (
    path_linear_sgd_layout_sweep_sharded, path_linear_sgd_sharded,
    path_linear_sgd_sweep_sharded)

KW = dict(per_octave=1, dense_upto=2, rotate=2, consensus_every=2,
          proposals=4)


def engines(pidx, mesh):
    p = replace(PathSGDParams().derive_from_graph(pidx), iter_max=4)
    lp = replace(LayoutSGDParams().derive_from_graph(pidx, 2), iter_max=3)
    return {
        "sweep": path_linear_sgd_sweep_sharded(None, p, mesh, pidx, **KW),
        "batched": path_linear_sgd_sharded(None, replace(p, batch=100),
                                           mesh, pidx),
        "layout": path_linear_sgd_layout_sweep_sharded(
            None, lp, mesh, pidx, **KW).coords,
    }
"""

WORKER = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from gfasort_tpu_torch import cli
from gfasort_tpu_torch.index import PathIndex
from gfasort_tpu_torch.io import gfa
from gfasort_tpu_torch.parallel.mesh import (default_mesh, init_distributed,
                                             is_distributed)
{engines}
init_distributed(device="cpu")
init_distributed(device="cpu")       # a second call changes nothing
assert is_distributed()
src, out_dir = sys.argv[1], sys.argv[2]
pidx = PathIndex.from_graph(gfa.parse_gfa_numeric(open(src).read()))
rank = int(__import__("os").environ["GFASORT_PROCESS_ID"])
for n in (2, 8):
    mesh = default_mesh(n, "cpu")
    assert mesh.size == n and mesh.n_local == n // 2
    assert list(mesh.shards) == list(range(rank * n // 2, (rank + 1) * n // 2))
    for name, x in engines(pidx, mesh).items():
        np.save(f"{{out_dir}}/{{name}}_{{n}}_{{rank}}.npy", x)
rc = cli.main(["-i", src, "-o", f"{{out_dir}}/cli_{{rank}}.gfa", "-p", "YL",
               "--engine", "sweep-sharded", "--device", "cpu",
               "--distributed", "--iter-max", "2", "--layout-iter", "2",
               "-v", "0"])
assert rc == 0
print("DONE", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    src = d / "in.gfa"
    src.write_text(gfa_text(seed=4))
    worker = d / "worker.py"
    worker.write_text(WORKER.format(repo=REPO, engines=ENGINES))
    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, GFASORT_COORDINATOR=f"127.0.0.1:{port}",
                   GFASORT_NUM_PROCESSES="2", GFASORT_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(src), str(d)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        assert "DONE" in out
    return d


def test_two_processes_of_one_shard_equal_one_process_of_two(two_ranks):
    ns = {}
    exec(ENGINES, ns)
    pidx = PathIndex.from_graph(gfa.parse_gfa_numeric(
        (two_ranks / "in.gfa").read_text()))
    want = ns["engines"](pidx, default_mesh(2, "cpu"))
    for name, x in want.items():
        for rank in (0, 1):
            got = np.load(two_ranks / f"{name}_2_{rank}.npy")
            np.testing.assert_array_equal(got, x, err_msg=f"{name}, rank {rank}")


def test_two_processes_of_four_shards_agree(two_ranks):
    for name in ("sweep", "batched", "layout"):
        a = np.load(two_ranks / f"{name}_8_0.npy")
        b = np.load(two_ranks / f"{name}_8_1.npy")
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ((two_ranks / "cli_0.gfa").read_text()
            == (two_ranks / "cli_1.gfa").read_text())
