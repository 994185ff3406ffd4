"""On the card: a traced run of small cells through the kernels, held to
the plain reference on the card.  Run there with
``python -m pytest gfabench/tests -m cuda``."""

from __future__ import annotations

import pytest

from gfabench import run as R
from gfabench.tests.conftest import LARGE, make_root


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["chr-sort.sYgs", "chr-layout.L2d"])
def test_small_cell_on_the_card(cuda_card, tmp_path, cell):
    root = make_root(tmp_path, LARGE, ["--engine", "sweep"])
    res = R.run_cell(cell, 2**31 + 3, 1.0, True, root=root)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert res["breakdown"]["device_ops"]
