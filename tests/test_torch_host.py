"""Port parity for the host layers the port carries as copies: each copy,
fed the same input as its original in ``gfasort_tpu``, gives an equal
output — GFA parse and write, the host pipeline steps, the path index
and the parameter derivation, the 1D and nD exact oracles (Python and
C++), the layout initialisation and stress, the sweep policy functions,
the synthetic workloads and the tracer."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gfasort_tpu as J  # noqa: E402
import gfasort_tpu.bench_util as j_bench  # noqa: E402
import gfasort_tpu.native as j_native  # noqa: E402
import gfasort_tpu.ops.exact as j_exact  # noqa: E402
import gfasort_tpu.ops.sweep as j_sweep  # noqa: E402
import gfasort_tpu.ops.sweep_common as j_sc  # noqa: E402
import gfasort_tpu.pipeline as j_pipe  # noqa: E402
from gfasort_tpu.io import fast_gfa as j_fast  # noqa: E402
from gfasort_tpu.io import gfa as j_gfa  # noqa: E402
from gfasort_tpu.ops import fastpow as j_fastpow  # noqa: E402
from gfasort_tpu.tools import make_synthetic_gfa as j_synth  # noqa: E402
from gfasort_tpu.trace import Tracer as JTracer  # noqa: E402

import gfasort_tpu_torch.bench_util as t_bench  # noqa: E402
import gfasort_tpu_torch.native as t_native  # noqa: E402
import gfasort_tpu_torch.ops.exact as t_exact  # noqa: E402
import gfasort_tpu_torch.ops.sweep_common as t_sc  # noqa: E402
import gfasort_tpu_torch.ops.sweep_policy as t_pol  # noqa: E402
import gfasort_tpu_torch.pipeline as t_pipe  # noqa: E402
from gfasort_tpu_torch import index as t_index  # noqa: E402
from gfasort_tpu_torch import params as t_params  # noqa: E402
from gfasort_tpu_torch.io import fast_gfa as t_fast  # noqa: E402
from gfasort_tpu_torch.io import gfa as t_gfa  # noqa: E402
from gfasort_tpu_torch.ops import fastpow as t_fastpow  # noqa: E402
from gfasort_tpu_torch.tools import make_synthetic_gfa as t_synth  # noqa: E402
from gfasort_tpu_torch.trace import Tracer as TTracer  # noqa: E402


def _text(nodes=400, paths=3, steps=400, seed=5):
    lines = t_synth.synthetic_gfa_lines(nodes, paths, steps, seed=seed)
    return "\n".join(lines) + "\n"


def _pair(text):
    return t_gfa.parse_gfa_numeric(text), j_gfa.parse_gfa_numeric(text)


def _pidx_pair(text):
    gt, gj = _pair(text)
    return t_index.PathIndex.from_graph(gt), J.PathIndex.from_graph(gj)


def _assert_pidx_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("how", ["numeric", "fast", "named", "file",
                                 "synthetic_lines"])
def test_gfa_round_trip_matches_jax(how, tmp_path):
    text = _text(seed=2)
    if how == "numeric":
        gt, gj = _pair(text)
    elif how == "fast":
        gt, gj = t_fast.parse_gfa_numeric_fast(text), j_fast.parse_gfa_numeric_fast(text)
    elif how == "named":
        gt, gj = t_gfa.parse_gfa_named(text), j_gfa.parse_gfa_named(text)
    elif how == "file":
        path = tmp_path / "g.gfa"
        path.write_text(text)
        gt, gj = t_fast.load_gfa_numeric_fast(path), j_fast.load_gfa_numeric_fast(path)
    else:
        assert list(t_synth.synthetic_gfa_lines(300, 2, 250, seed=9)) == list(
            j_synth.synthetic_gfa_lines(300, 2, 250, seed=9))
        gt, gj = _pair(text)
    out = t_gfa.write_gfa(gt)
    assert out == j_gfa.write_gfa(gj)
    assert t_gfa.canonical_gfa(out) == j_gfa.canonical_gfa(out)
    assert gt.compute_all_path_hashes() == gj.compute_all_path_hashes()
    # write -> parse -> write is a fixed point in both
    assert t_gfa.write_gfa(t_gfa.parse_gfa_numeric(out)) == out


@pytest.mark.parametrize("steps", ["s", "S", "g", "u", "sgSu"])
def test_host_steps_match_jax(steps):
    gt, gj = _pair(_text(seed=3))
    fns = {"s": "topological_sort_only", "S": "priority_topological_sort_only",
           "g": "groom_only", "u": "unchop_only"}
    for c in steps:
        getattr(t_pipe, fns[c])(gt)
        getattr(j_pipe, fns[c])(gj)
        assert list(gt.node_order) == list(gj.node_order)
    assert t_gfa.write_gfa(gt) == j_gfa.write_gfa(gj)


@pytest.mark.parametrize("what", ["path_index", "ygs_params", "layout_params",
                                  "pipeline_chars"])
def test_index_and_params_match_jax(what):
    text = _text(seed=4)
    if what == "path_index":
        pt, pj = _pidx_pair(text)
        _assert_pidx_equal(pt, pj)
        np.testing.assert_array_equal(pt.initial_positions(),
                                      pj.initial_positions())
    elif what == "ygs_params":
        gt, gj = _pair(text)
        a = t_params.YgsParams.from_graph(gt, verbose=2, nthreads=3)
        b = J.YgsParams.from_graph(gj, verbose=2, nthreads=3)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.path_sgd.first_cooling_iteration
                == b.path_sgd.first_cooling_iteration)
    elif what == "layout_params":
        pt, pj = _pidx_pair(text)
        for dims in (2, 3):
            a = t_params.LayoutSGDParams().derive_from_graph(pt, dims)
            b = J.LayoutSGDParams().derive_from_graph(pj, dims)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.first_cooling_iteration == b.first_cooling_iteration
    else:
        assert t_pipe.PIPELINE_CHARS == j_pipe.PIPELINE_CHARS
        assert t_pipe.AUTO_ORACLE_MAX_NODES == j_pipe.AUTO_ORACLE_MAX_NODES
        for bad in ("", "sYx"):
            with pytest.raises(ValueError) as et:
                t_pipe.validate_pipeline(bad)
            with pytest.raises(ValueError) as ej:
                j_pipe.validate_pipeline(bad)
            assert str(et.value) == str(ej.value)


def _oracle_params(pidx_t, pidx_j, dims):
    if dims == 1:
        mk_t, mk_j = t_params.PathSGDParams(), J.PathSGDParams()
        args_t, args_j = (pidx_t,), (pidx_j,)
    else:
        mk_t, mk_j = t_params.LayoutSGDParams(), J.LayoutSGDParams()
        args_t, args_j = (pidx_t, dims), (pidx_j, dims)
    pt = dataclasses.replace(mk_t.derive_from_graph(*args_t), iter_max=3)
    pj = dataclasses.replace(mk_j.derive_from_graph(*args_j), iter_max=3)
    return pt, pj


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("impl", ["python", "native"])
def test_exact_oracles_match_jax(impl, dims):
    if impl == "native" and not (t_native.available() and j_native.available()):
        pytest.skip("no C++ toolchain for the native oracle")
    text = _text(nodes=150, paths=2, steps=150, seed=6)
    gt, gj = _pair(text)
    pidx_t, pidx_j = _pidx_pair(text)
    pt, pj = _oracle_params(pidx_t, pidx_j, dims)
    if dims == 1:
        if impl == "python":
            xt = t_exact.path_linear_sgd_exact(gt, pt, pidx_t)
            xj = j_exact.path_linear_sgd_exact(gj, pj, pidx_j)
            assert t_exact.path_sgd_sort_exact(gt, pt) == \
                j_exact.path_sgd_sort_exact(gj, pj)
        else:
            xt = t_native.path_linear_sgd_native(gt, pt, pidx_t)
            xj = j_native.path_linear_sgd_native(gj, pj, pidx_j)
            assert t_native.path_sgd_sort_native(gt, pt) == \
                j_native.path_sgd_sort_native(gj, pj)
        np.testing.assert_array_equal(xt, xj)
    else:
        if impl == "python":
            lt = t_exact.path_linear_sgd_layout_exact(gt, pt, pidx_t)
            lj = j_exact.path_linear_sgd_layout_exact(gj, pj, pidx_j)
        else:
            lt = t_native.path_linear_sgd_layout_native(gt, pt, pidx_t)
            lj = j_native.path_linear_sgd_layout_native(gj, pj, pidx_j)
        np.testing.assert_array_equal(lt.coords, lj.coords)
        assert lt.write_tsv() == lj.write_tsv()


@pytest.mark.parametrize("dims", [2, 3])
def test_layout_init_and_stress_match_jax(dims):
    text = _text(nodes=300, paths=3, steps=300, seed=7)
    gt, gj = _pair(text)
    pidx_t, pidx_j = _pidx_pair(text)
    it = t_exact.layout_initial_coords(pidx_t, dims, 9399220)
    ij = j_exact.layout_initial_coords(pidx_j, dims, 9399220)
    np.testing.assert_array_equal(it, ij)
    from gfasort_tpu.io.layout_tsv import Layout as JLayout
    from gfasort_tpu_torch.io.layout_tsv import Layout as TLayout

    lt, lj = TLayout.from_state(it), JLayout.from_state(ij)
    assert t_exact.calculate_layout_stress(gt, lt, 2000) == \
        j_exact.calculate_layout_stress(gj, lj, 2000)
    assert t_exact.calculate_layout_stress_pidx(pidx_t, lt, 500) == \
        j_exact.calculate_layout_stress_pidx(pidx_j, lj, 500)
    if dims == 2 and t_native.available() and j_native.available():
        present = np.ones(pidx_t.num_nodes, np.uint8)
        xs, ys = lt.coords[:, 0, 0], lt.coords[:, 0, 1]
        assert t_native.layout_stress_2d_native(pidx_t, xs, ys, present, 800) \
            == j_native.layout_stress_2d_native(pidx_j, xs, ys, present, 800)


# paths that take each skip of the stress: "one" has one step
# (count_p < 2), "two" two (rank_a == rank_b one draw in two), and "zero"
# steps on the empty nodes 2 and 3, so three of its steps share a position
# (path_dist == 0)
SKIP_GFA = "".join([
    "H\tVN:Z:1.0\n",
    "S\t1\tACGT\nS\t2\t\nS\t3\t\nS\t4\tACGTACGTA\nS\t5\tAC\nS\t6\tGATTACA\n",
    "L\t1\t+\t2\t+\t0M\nL\t2\t+\t3\t+\t0M\nL\t3\t+\t4\t+\t0M\n",
    "L\t4\t+\t5\t+\t0M\nL\t5\t+\t6\t+\t0M\nL\t1\t+\t5\t+\t0M\n",
    "P\tone\t4+\t*\nP\ttwo\t1+,5+\t*\nP\tzero\t1+,2+,3+,4+,5+,6+\t*\n",
])


def _stress_skips(pidx, sample_count):
    """Replays the stress's draws and counts the samples that each skip
    drops: ``count_p < 2``, ``rank_a == rank_b``, ``path_dist == 0``."""
    from gfasort_tpu_torch.ops.rng import UniformInt, Xoshiro256Plus

    rng = Xoshiro256Plus(12345)
    step_dist = UniformInt(0, pidx.total_steps)
    skips = [0, 0, 0]
    for _ in range(sample_count):
        sa0 = step_dist.sample(rng)
        p = int(pidx.step_path[sa0])
        count_p = int(pidx.path_count[p])
        if count_p < 2:
            skips[0] += 1
            continue
        rank_a = int(pidx.step_rank[sa0])
        rank_b = UniformInt(0, count_p).sample(rng)
        if rank_a == rank_b:
            skips[1] += 1
            continue
        first = int(pidx.path_first[p])
        skips[2] += int(pidx.step_pos[first + rank_a]
                        == pidx.step_pos[first + rank_b])
    return skips


@pytest.mark.parametrize("dims", [2, 3])
def test_stress_takes_every_skip_as_jax(dims):
    """The stress reads the sampled steps in place and takes the three
    skips of the reference's loop in its order: equal to the JAX
    package's to the bit, from a prebuilt index and from the graph."""
    from gfasort_tpu.io.layout_tsv import Layout as JLayout
    from gfasort_tpu_torch.io.layout_tsv import Layout as TLayout

    gt, gj = _pair(SKIP_GFA)
    pidx_t, pidx_j = _pidx_pair(SKIP_GFA)
    state = t_exact.layout_initial_coords(pidx_t, dims, 9399220)
    lt, lj = TLayout.from_state(state), JLayout.from_state(state)
    for n in (1, 7, 2000):
        s_t = t_exact.calculate_layout_stress_pidx(pidx_t, lt, n)
        assert s_t == j_exact.calculate_layout_stress_pidx(pidx_j, lj, n)
        assert t_exact.calculate_layout_stress(gt, lt, n) == s_t
    assert s_t > 0
    assert min(_stress_skips(pidx_t, 2000)) > 0


def _numpy_pidx(cls, steps=3_000_000, paths=90, nodes=250_000, seed=11):
    """A path index of a chromosome graph's proportions made in numpy
    alone: path 0 has one step, node lengths 0-39 bp."""
    rng = np.random.default_rng(seed)
    count = np.concatenate([[1], rng.multinomial(
        steps - 1, np.full(paths - 1, 1 / (paths - 1)))]).astype(np.int64)
    first = np.concatenate([[0], np.cumsum(count)[:-1]])
    step_path = np.repeat(np.arange(paths, dtype=np.int32), count)
    step_node = rng.integers(0, nodes, steps)
    node_len = rng.integers(0, 40, nodes)
    lengths = node_len[step_node]
    before = np.cumsum(lengths) - lengths
    return cls(
        step_handle=step_node * 2, step_pos=before - before[first][step_path],
        step_path=step_path,
        step_rank=np.arange(steps) - first[step_path],
        path_first=first, path_count=count,
        path_len=np.add.reduceat(lengths, first),
        node_ids=np.arange(nodes), node_len=node_len, handle_to_idx={},
        step_node_idx=step_node, step_count_of_step=count[step_path],
    ), np.random.default_rng(seed + 1).normal(0, 1e5, (2 * nodes, 2))


def test_stress_of_a_large_index_matches_jax():
    """3M steps, so the sampled steps lie far apart in the columns."""
    from gfasort_tpu.io.layout_tsv import Layout as JLayout
    from gfasort_tpu_torch.io.layout_tsv import Layout as TLayout

    pidx_t, state = _numpy_pidx(t_index.PathIndex)
    pidx_j, _ = _numpy_pidx(J.PathIndex)
    s_t = t_exact.calculate_layout_stress_pidx(
        pidx_t, TLayout.from_state(state), 10_000)
    assert s_t > 0
    assert s_t == j_exact.calculate_layout_stress_pidx(
        pidx_j, JLayout.from_state(state), 10_000)


@pytest.mark.parametrize("fn", ["offset_set", "auto_sweep_config",
                                "phase_structure", "fit_consensus_period",
                                "constants_and_fastpow"])
def test_sweep_policy_matches_jax(fn):
    spaces = [1, 2, 7, 100, 1000, 5999, 249_999]
    if fn == "offset_set":
        for space in spaces:
            for po in (2, 3, 4):
                for du in (4, 8):
                    np.testing.assert_array_equal(
                        t_pol.offset_set(space, po, du),
                        j_sweep.offset_set(space, po, du))
    elif fn == "auto_sweep_config":
        for S in (10, 6000, 1 << 18, 4_000_000):
            for N in (3, 1000, 1_000_000):
                for layout in (False, True):
                    assert t_pol.auto_sweep_config(S, N, layout=layout) == \
                        j_sc.auto_sweep_config(S, N, layout=layout)
        assert t_pol.LARGE_S == j_sc.LARGE_S
        for K in range(1, 80, 7):
            assert t_pol.auto_rotate(K, 4) == j_sc.auto_rotate(K, 4)
    elif fn == "phase_structure":
        for space in spaces:
            offs = t_pol.offset_set(space, 3, 4)
            for rotate in (1, 2, 12, "auto"):
                for ce in (4, 8, 48):
                    po_t, r_t, c_t = t_pol.phase_structure(offs, rotate, ce)
                    po_j, r_j, c_j = j_sc.phase_structure(offs, rotate, ce)
                    assert (r_t, c_t) == (r_j, c_j)
                    assert len(po_t) == len(po_j)
                    for a, b in zip(po_t, po_j):
                        np.testing.assert_array_equal(a, b)
    elif fn == "fit_consensus_period":
        for n in (1, 4, 62, 93, 101, 1000):
            for ce in (1, 8, 36, 48, 96):
                for ph in (1, 3, 12):
                    assert t_pol.fit_consensus_period(n, ce, ph) == \
                        j_sc.fit_consensus_period(n, ce, ph)
    else:
        for name in ("INACTIVE", "INACTIVE8", "PACKED_INACTIVE"):
            assert getattr(t_sc, name) == getattr(j_sc, name)
            assert getattr(t_sc, name).dtype == getattr(j_sc, name).dtype
        a = np.linspace(1e-4, 3.0, 997)
        for b in (0.001, 0.5, 0.99, 1.0, 2.5):
            np.testing.assert_array_equal(t_fastpow.fast_precise_pow_np(a, b),
                                          j_fastpow.fast_precise_pow_np(a, b))
        for args in ((100, 100, 100, 0.99), (5000, 1000, 100, 0.99),
                     (300, 1000, 100, 0.001)):
            np.testing.assert_array_equal(t_fastpow.zeta_table(*args),
                                          j_fastpow.zeta_table(*args))


@pytest.mark.parametrize("what", ["synthetic_path_index", "rank_quality",
                                  "bench_params", "tracer"])
def test_bench_util_and_trace_match_jax(what):
    if what == "bench_params":
        t_p = t_bench.bench_params(
            t_bench.synthetic_path_index(700, 3, 900, seed=4), 64, 5)
        j_p = j_bench.bench_params(
            j_bench.synthetic_path_index(700, 3, 900, seed=4), 64, 5)
        assert vars(t_p) == vars(j_p)
        assert (t_p.iter_max, t_p.min_term_updates, t_p.batch) == (4, 64, 64)
    elif what == "synthetic_path_index":
        _assert_pidx_equal(t_bench.synthetic_path_index(700, 3, 900, seed=4),
                           j_bench.synthetic_path_index(700, 3, 900, seed=4))
    elif what == "rank_quality":
        rng = np.random.default_rng(3)
        a, b = rng.permutation(500), rng.permutation(500)
        assert t_bench.rank_quality(a, b) == j_bench.rank_quality(a, b)
    else:
        # the step lines agree on the JAX tracer's keys; the port's lines
        # add the step span's start, end, counts and descendants
        out = []
        for tracer in (TTracer(), JTracer()):
            with tracer.step("SGD", step=1, nodes=3):
                pass
            out.append([json.loads(line)
                        for line in tracer.to_json_lines().splitlines()])
        (t_line,), (j_line,) = out
        jax_keys = set(j_line) - {"seconds"}
        assert {k: t_line[k] for k in jax_keys} == {k: j_line[k]
                                                    for k in jax_keys}
        assert set(t_line) - set(j_line) == {"start", "end", "counts",
                                             "spans"}
        assert t_line["spans"] == [] and t_line["counts"] == {}
        assert 0 <= t_line["start"] <= t_line["end"]
        assert t_line["end"] - t_line["start"] == pytest.approx(
            t_line["seconds"], abs=1e-5)


@pytest.mark.parametrize("what", ["verify", "compat", "compare_layouts",
                                  "measure_layout_quality", "sgd_diagnostics"])
def test_late_host_copies_match_jax(what, tmp_path, capsys):
    """The five host modules copied with only their imports changed
    (``verify.py``, ``compat.py`` and three ``tools/``) give the same
    output as their originals on the same input."""
    import gfasort_tpu.compat as j_compat
    import gfasort_tpu.verify as j_verify
    import gfasort_tpu_torch.compat as t_compat
    import gfasort_tpu_torch.verify as t_verify
    from gfasort_tpu.tools import compare_layouts as j_cmp
    from gfasort_tpu.tools import measure_layout_quality as j_mlq
    from gfasort_tpu.tools import sgd_diagnostics as j_diag
    from gfasort_tpu_torch.tools import compare_layouts as t_cmp
    from gfasort_tpu_torch.tools import measure_layout_quality as t_mlq
    from gfasort_tpu_torch.tools import sgd_diagnostics as t_diag

    text = _text(nodes=300, paths=3, steps=300, seed=9)
    gt, gj = _pair(text)
    src = tmp_path / "g.gfa"
    src.write_text(text)
    if what == "verify":
        out = []
        for mod, g in ((t_verify, gt), (j_verify, gj)):
            hashes = g.compute_all_path_hashes()
            name = sorted(hashes)[0]
            bad = dict(hashes, **{name: "0" * 64})
            reps = [mod.comprehensive_verify(g, h) for h in (None, hashes, bad)]
            out.append(([dataclasses.asdict(r) for r in reps],
                        [r.ok for r in reps],
                        mod.reconstruct_path_sequence(g, 1),
                        mod.validate_gfa_format(text),
                        mod.validate_gfa_format("S\t1\nL\t1\t+\n")))
        assert out[0] == out[1]
        assert out[0][1] == [True, True, False]
    elif what == "compat":
        out = []
        for mod, g in ((t_compat, gt), (j_compat, gj)):
            sg = mod.SimpleGraph.from_bidirected(g)
            res = [sg.topological_sort(), mod.tarjan_scc(sg),
                   mod.find_simple_components_legacy(sg),
                   mod.union_find_components(sg)]
            merged = mod.compact_simple(sg)
            back = sg.to_bidirected()
            out.append((res, merged, back.node_count(), len(back.edges)))
        assert out[0] == out[1]
    elif what == "compare_layouts":
        rng = np.random.default_rng(2)
        xy = rng.standard_normal((300, 4)) * 100
        ours, odgi = tmp_path / "ours.tsv", tmp_path / "odgi.tsv"
        ours.write_text("idx\tx\ty\n" + "".join(
            f"{i}\t{a}\t{b}\n" for i, (a, b) in enumerate(xy[:, :2])))
        odgi.write_text("idx\tX\tY\tcomponent\n" + "".join(
            f"{2 * i + e}\t{xy[i, 2 * e]}\t{xy[i, 2 * e + 1]}\t0\n"
            for i in range(300) for e in (0, 1)))
        argv = [str(src), str(ours), str(odgi)]
        assert t_cmp.main(argv) == 0
        got = capsys.readouterr()
        assert j_cmp.main(argv) == 0
        assert got == capsys.readouterr()
        assert "ratio (gfasort/ODGI)" in got.out
        assert t_cmp.main([]) == j_cmp.main([]) == 1
    elif what == "measure_layout_quality":
        assert t_mlq.main([str(src)]) == 0
        got = capsys.readouterr()
        assert j_mlq.main([str(src)]) == 0
        assert got == capsys.readouterr() and "MSE" in got.out
        assert dataclasses.asdict(t_mlq.measure(gt)) == dataclasses.asdict(
            j_mlq.measure(gj))
    else:
        logs = ([], [])
        n = (t_diag.diagnose(gt, log=lambda *a: logs[0].append(a)),
             j_diag.diagnose(gj, log=lambda *a: logs[1].append(a)))
        assert n[0] == n[1] and logs[0] == logs[1] and logs[0]
        assert t_diag.main([str(src)]) == 0
        got = capsys.readouterr()
        assert j_diag.main([str(src)]) == 0
        assert got == capsys.readouterr()
