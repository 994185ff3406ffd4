"""The comparison that decides ``correct`` fails its control and the faults
a cell can have, at a size a test run holds (the CPU, the program's plain
versions; the readings at the cells' own size come from
``python -m gfabench.control`` on the card).

Faults, each planted in the program underneath a whole run: a sweep that
returns its state unchanged; the pair updates of half the steps left out;
an answer altered where it is produced (two nodes of the order that the
last step writes swapped; one coordinate of the layout moved).  The exchange between chips
has no fault here: every cell runs on one card."""

from __future__ import annotations

import pytest
import torch

from gfabench import run as R
from gfabench.control import bf16_state
from gfabench.jobs import make_job, run_job
from gfabench.spec import load_cell


@pytest.mark.parametrize("cell,number", [
    ("chr-sort.sYgs", "gfa_lines_differing"),
    ("chr-layout.L2d", "tsv_values_differing"),
])
def test_control_fails(tiny_root, tmp_path, cell, number):
    c = load_cell(cell, tiny_root)
    job = make_job(c.config, c.traffic, tmp_path, 21, 1)
    run_job(job)
    assert job.rc == 0
    assert R.compare(job, "cpu")[number] == 0
    assert R.compare(job, "cpu", bf16_state)[number] > 0


def _unchanged_1d(mp):
    import gfasort_tpu_torch.ops.sweep as sw
    mp.setattr(sw, "sweep_once", lambda xs, *a, **k: xs)


def _unchanged_nd(mp):
    import gfasort_tpu_torch.ops.sweep_nd as nd
    mp.setattr(nd, "nd_sweep_once", lambda cs, *a, **k: cs)


def _half_1d(mp):
    import gfasort_tpu_torch.ops.sweep as sw
    orig = sw.apply_choices

    def half(xs, *a, **k):
        new = orig(xs, *a, **k)
        h = xs.shape[0] // 2
        return torch.cat([new[:h], xs[h:]])
    mp.setattr(sw, "apply_choices", half)


def _half_nd(mp):
    import gfasort_tpu_torch.ops.sweep_nd as nd
    orig = nd.roll_apply_nd

    def half(my_pos, my_c, lane0, cs, *a, **k):
        new = orig(my_pos, my_c, lane0, cs, *a, **k)
        h = cs.shape[1] // 2
        return torch.cat([new[:, :h], cs[:, h:]], dim=1)
    mp.setattr(nd, "roll_apply_nd", half)


def _altered_order(mp):
    # sYgs's answer, the order, is produced by its last step, the
    # topological sort (a swap in the SGD order alone can be undone by
    # the groom and the sort after it)
    import gfasort_tpu_torch.pipeline as pl
    orig = pl.exact_odgi_topological_order

    def swapped(*a, **k):
        order = list(orig(*a, **k))
        order[0], order[1] = order[1], order[0]
        return order
    mp.setattr(pl, "exact_odgi_topological_order", swapped)


def _altered_layout(mp):
    import gfasort_tpu_torch.ops.sweep_nd as nd
    orig = nd.path_linear_sgd_layout_sweep

    def moved(*a, **k):
        layout = orig(*a, **k)
        layout.coords[0, 0, 1] += 1.0
        return layout
    mp.setattr(nd, "path_linear_sgd_layout_sweep", moved)


@pytest.mark.parametrize("cell,fault", [
    ("chr-sort.sYgs", _unchanged_1d),
    ("chr-sort.sYgs", _half_1d),
    ("chr-sort.sYgs", _altered_order),
    ("chr-layout.L2d", _unchanged_nd),
    ("chr-layout.L2d", _half_nd),
    ("chr-layout.L2d", _altered_layout),
])
def test_fault_makes_the_run_incorrect(tiny_root, tmp_path, monkeypatch,
                                      cell, fault):
    fault(monkeypatch)
    res = R.run_cell(cell, 77, 0.1, False, root=tiny_root,
                       chip=False, work=tmp_path / "work")
    assert res["attempted"] >= 1
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
