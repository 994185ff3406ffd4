"""The plain reference gives the program's files exactly, on the CPU,
where the program runs the plain versions of its kernels (which the card
holds its kernels to, bit for bit): the GFA line for line and the layout
value for value.  The reference imports nothing of the program."""

from __future__ import annotations

import subprocess
import sys

import pytest

from gfabench import run as R
from gfabench.jobs import make_job, run_job
from gfabench.spec import load_cell
from gfabench.tests.conftest import CPU_ARGV, LARGE, graph_config, make_root


@pytest.mark.parametrize("cell,sizes", [
    ("chr-sort.sYgs", graph_config(paths=5, haplotype_bp=450_000)),
    ("chr-layout.L2d", graph_config(paths=5, haplotype_bp=450_000)),
    ("chr-sort.sYgs", LARGE),
])
def test_reference_equals_the_program(tmp_path, cell, sizes):
    root = make_root(tmp_path, sizes, CPU_ARGV)
    c = load_cell(cell, root)
    job = make_job(c.config, c.traffic, tmp_path, 2**31 + 7, 1)
    run_job(job)
    assert job.rc == 0, job.error
    got = R.compare(job, "cpu")
    assert got and all(v == 0 for v in got.values())


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, gfabench.reference.pipeline, gfabench.run; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gfasort_tpu_torch', 'gfasort_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
