"""The frozen kernel counts and bounds of ``gfabench.bounds`` agree with
``chip_smoke.py``'s, and the plans they are worked out from (the
reference's, from a graph's shape alone) agree with the program's."""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest

import chip_smoke as cs
from gfabench import bounds as B
from gfabench.bounds import GraphShape
from gfabench.generator import GRAPH_KEYS, pangenome_gfa
from gfabench.tests.conftest import LARGE
from gfabench.gfa_check import summarize

# (P, K, coin, frac): the 1D plan's P = 12 and the 2D layout plan's P = 8
# with their phases' offset counts, and the edges P = 1, 5
SAMPLER = [(12, 12, False, 1.0), (12, 13, False, 1.0), (8, 16, True, 1.0),
           (8, 17, True, 0.6), (1, 12, False, 1.0), (5, 64, True, 0.5)]


@pytest.mark.parametrize("P,K,coin,frac", SAMPLER)
def test_sampler_counts(P, K, coin, frac):
    assert B.ops_sampler(P, K, coin, frac) == cs.ops_sampler(P, K, coin,
                                                             frac)[:3]
    assert cs.ops_sampler(P, K, coin, frac)[3] == 0


@pytest.mark.parametrize("P", [1, 5, 8, 12])
@pytest.mark.parametrize("n", [1, 4, 9])
def test_pair_counts(P, n):
    assert B.n_words(P) == cs.n_words(P)
    assert B.match_ops(P) == cs.match_ops(P)
    assert B.ops_1d(P, n) == cs.ops_1d(P, n)
    assert B.ops_nd(2, P, n) == cs.ops_nd(2, P, n)


@pytest.mark.parametrize("args", [
    # bench index S = 4M: the sampler at P = 12, #1 and the 1D roll pass
    # on 6 and 3 buckets, the 2D sampler with its coin at P = 8, #3 and
    # the nD roll pass
    (4_000_000, 2, 3) + cs.ops_sampler(12, 12, False, 1.0)[:3],
    (4_000_000, 5, 2) + cs.ops_1d(12, 6),
    (4_000_000, 7, 1, 12 * 3 + 3) + cs.ops_1d(12, 3)[1:],
    (4_000_000, 2, 2.25) + cs.ops_sampler(8, 16, True, 1.0)[:3],
    (4_000_000, 5, 3) + cs.ops_nd(2, 8, 6),
    (4_000_000, 10.25, 4) + cs.ops_nd(2, 8, 4),
])
def test_bound_ms(args):
    assert B.bound_ms(*args) == pytest.approx(cs.bound_ms(*args)[0],
                                              rel=1e-12)


def test_bound_at_another_clock():
    args = (4_000_000, 2, 3) + cs.ops_sampler(12, 12, False, 1.0)[:3]
    old = cs.CLOCK_MHZ
    try:
        cs.CLOCK_MHZ = 1755.0
        want = cs.bound_ms(*args)[0]
    finally:
        cs.CLOCK_MHZ = old
    assert B.bound_ms(*args, clock_mhz=1755.0) == pytest.approx(want,
                                                                rel=1e-12)


@pytest.fixture(scope="module")
def large_graph(tmp_path_factory):
    """A graph in the engines' large regime (S >= 2**18): its path in the
    program's index and its summary."""
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.io.gfa import parse_gfa_numeric

    data = pangenome_gfa(seed=5, **LARGE)
    path = tmp_path_factory.mktemp("g") / "g.gfa"
    path.write_bytes(data)
    text = data.decode()
    return PathIndex.from_graph(parse_gfa_numeric(text)), summarize(path)


def _same_plan(a, b):
    assert (a.proposals, a.active_frac, a.consensus_every, a.n_exec,
            a.rotate, a.dims) == (b.proposals, b.active_frac,
                                  b.consensus_every, b.n_exec, b.rotate,
                                  b.dims)
    np.testing.assert_array_equal(a.offs, b.offs)
    np.testing.assert_array_equal(a.sweep_eta, b.sweep_eta)
    np.testing.assert_array_equal(a.sweep_cool, b.sweep_cool)
    assert len(a.phases) == len(b.phases)
    for pa, pb in zip(a.phases, b.phases):
        np.testing.assert_array_equal(pa.offs, pb.offs)
        assert pa.kernel_buckets == pb.kernel_buckets
        assert pa.roll_buckets == pb.roll_buckets
        np.testing.assert_array_equal(pa.zeta, pb.zeta)
        np.testing.assert_array_equal(pa.eta_z, pb.eta_z)


def test_sort_plan_from_the_shape(large_graph):
    from gfasort_tpu_torch.ops.sweep_plan import make_sweep_plan
    from gfasort_tpu_torch.params import PathSGDParams

    pidx, summary = large_graph
    params = replace(PathSGDParams().derive_from_graph(pidx), iter_max=100)
    want = make_sweep_plan(pidx, params)
    got = B._sort_plan(GraphShape.of(summary), 100)
    assert want.proposals == 12 and want.n_exec == 120
    _same_plan(got, want)


def test_layout_plan_from_the_shape(large_graph):
    from gfasort_tpu_torch.ops.sweep_plan import make_layout_plan
    from gfasort_tpu_torch.params import LayoutSGDParams

    pidx, summary = large_graph
    params = replace(LayoutSGDParams().derive_from_graph(pidx, 2), iter_max=30)
    want = make_layout_plan(pidx, params)
    got = B._layout_plan(GraphShape.of(summary), 2, 30)
    assert want.proposals == 8
    _same_plan(got, want)


def test_step_bounds_sum_the_sweeps(large_graph):
    """A Y step's bound is its executed sweeps' three kernel bounds."""
    _, summary = large_graph
    shape = GraphShape.of(summary)
    plan = B._sort_plan(shape, 100)
    S, P = shape.total_steps, plan.proposals
    want = 0.0
    for e in range(plan.n_exec):
        ph = plan.phases[e % len(plan.phases)]
        kb, rb = len(ph.kernel_buckets), len(ph.roll_buckets)
        want += cs.bound_ms(S, 2, cs.n_words(P),
                            *cs.ops_sampler(P, len(ph.offs), False,
                                            plan.active_frac))[0]
        if kb:
            want += cs.bound_ms(S, 2 + cs.n_words(P), 2,
                                *cs.ops_1d(P, kb))[0]
        f32, i32, cvt = cs.ops_1d(P, rb)
        want += cs.bound_ms(S, 4 + cs.n_words(P), 1, f32 + 3, i32,
                            cvt + 1)[0]
    assert B.sort_step_bound_ms(shape, 100) == pytest.approx(want, rel=1e-9)


def test_plans_from_the_shape_of_a_looped_graph(tmp_path):
    """Paths that walk a repeat unit many times: the shape counts every
    visit as the program's index does, and both plans follow."""
    from gfasort_tpu_torch.index import PathIndex
    from gfasort_tpu_torch.io.gfa import parse_gfa_numeric
    from gfasort_tpu_torch.ops.sweep_plan import (make_layout_plan,
                                                  make_sweep_plan)
    from gfasort_tpu_torch.params import LayoutSGDParams, PathSGDParams

    from gfabench.tests.conftest import graph_config

    cfg = graph_config(paths=6, haplotype_bp=300_000)
    data = pangenome_gfa(seed=9, **cfg, repeat_arrays=[
        {"at": 0.5, "unit_bp": 2000, "unit_theta": 0.004,
         "copies": [40, 60], "absent_share": 0.3}])
    path = tmp_path / "g.gfa"
    path.write_bytes(data)
    pidx = PathIndex.from_graph(parse_gfa_numeric(data.decode()))
    shape = GraphShape.of(summarize(path))
    assert shape == GraphShape(pidx.total_steps, pidx.num_nodes,
                               pidx.max_path_step_count,
                               pidx.sum_path_step_count,
                               pidx.max_path_length)
    walks = np.split(pidx.step_node_idx, pidx.path_first[1:])
    assert any(len(np.unique(w)) < len(w) for w in walks)
    params = replace(PathSGDParams().derive_from_graph(pidx), iter_max=100)
    _same_plan(B._sort_plan(shape, 100), make_sweep_plan(pidx, params))
    params = replace(LayoutSGDParams().derive_from_graph(pidx, 2),
                     iter_max=30)
    _same_plan(B._layout_plan(shape, 2, 30), make_layout_plan(pidx, params))
