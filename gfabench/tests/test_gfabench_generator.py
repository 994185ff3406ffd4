"""The benchmark's generator: the same seed gives the same bytes, and the
graph has the shape its docstring states (a shared backbone that every
path walks, bubbles at the sites, inversions and reversed paths, ids by
first visit; a repeat array folded into a loop).  The configurations'
graphs are pinned by their SHA-256.  At the configurations' size (22 Mbp,
90 paths, 14.9M steps) it takes a few seconds: the runs print each
input's time."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from gfabench.generator import (GRAPH_KEYS, job_seed, pangenome_gfa,
                                sites_per_bp, write_pangenome_gfa)
from gfabench.gfa_check import _RC
from gfabench.gfa_tokens import parse_steps, steps_text
from gfabench.tests.conftest import REPO, graph_config

SMALL = graph_config(paths=7, haplotype_bp=400_000)

# one array of 20 paths: 16 carriers of 18-25 copies, each copy a unit of
# 5 SNV sites (11 nodes)
ARRAY = {"at": 0.43, "unit_bp": 300, "unit_theta": 0.0047,
         "copies": [18, 25], "absent_share": 0.2}
LOOPED = graph_config(paths=20, haplotype_bp=200_000, reversed_share=0.5)


def _gfa(seed, **over):
    cfg = dict(SMALL, **over)
    return pangenome_gfa(seed=seed, **{k: cfg[k] for k in GRAPH_KEYS},
                         repeat_arrays=cfg.get("repeat_arrays", ()))


def _parse(data: bytes):
    seqs, edges, paths = {}, set(), {}
    for line in data.split(b"\n"):
        f = line.split(b"\t")
        if f[0] == b"S":
            seqs[int(f[1])] = f[2]
        elif f[0] == b"L":
            edges.add((int(f[1]), f[2], int(f[3]), f[4]))
        elif f[0] == b"P":
            paths[f[1].decode()] = parse_steps(f[2])
    return seqs, edges, paths


@pytest.mark.parametrize("over", [{}, dict(LOOPED, repeat_arrays=[ARRAY])],
                         ids=["plain", "looped"])
def test_same_seed_same_bytes(over):
    assert _gfa(5, **over) == _gfa(5, **over)
    assert _gfa(5, **over) != _gfa(6, **over)


# the parent's generator's graphs, before repeat arrays were added: the
# configurations at 300 kbp, every other key as in their files
@pytest.mark.parametrize("config", ["hprc-chr-sort", "hprc-chr-layout2d"])
@pytest.mark.parametrize("seed,size,sha256", [
    (job_seed(2**31 + 17, 0), 1559731,
     "e1f3a25a538b0a71c2eb80201c81c4d6dbb23cadb1d64b2976c454f88e723136"),
    (job_seed(5, 3), 1538070,
     "75accf33fe50e2e4240a51ea94fa63e612aeeccd9dac2a12f0001a6d96daf631"),
])
def test_the_configurations_graphs_are_pinned(tmp_path, config, seed, size,
                                              sha256):
    cfg = json.loads((REPO / "gfabench" / "configs" /
                      f"{config}.json").read_text())
    cfg["haplotype_bp"] = 300_000
    write_pangenome_gfa(tmp_path / "g.gfa", cfg, seed)
    data = (tmp_path / "g.gfa").read_bytes()
    assert (len(data), hashlib.sha256(data).hexdigest()) == (size, sha256)
    cfg["repeat_arrays"] = []
    write_pangenome_gfa(tmp_path / "g.gfa", cfg, seed)
    assert (tmp_path / "g.gfa").read_bytes() == data


def test_job_seeds_are_distinct():
    seeds = {job_seed(s, j) for s in (0, 1, 2**31 + 5) for j in range(64)}
    assert len(seeds) == 3 * 64


def test_the_shape_of_a_pangenome():
    cfg = SMALL
    seqs, edges, paths = _parse(_gfa(job_seed(2**31 + 11, 3)))
    n_sites = round(sites_per_bp(cfg["paths"], cfg["theta"])
                    * cfg["haplotype_bp"])
    n_indel = round(cfg["indel_share"] * n_sites)
    assert len(seqs) == n_sites + 1 + 2 * (n_sites - n_indel) + n_indel
    assert sorted(seqs) == list(range(1, len(seqs) + 1))
    assert len(paths) == cfg["paths"]
    visits = np.zeros(len(seqs) + 1, dtype=np.int64)
    n_back = 0
    for ids, rev in paths.values():
        assert len(np.unique(ids)) == len(ids)          # a simple walk
        visits[ids] += 1
        # about 2/3 of the nodes: every segment and one allele per site
        assert 0.6 < len(ids) / len(seqs) < 0.72
        bp = sum(len(seqs[i]) for i in ids.tolist())
        assert 0.9 < bp / cfg["haplotype_bp"] < 1.1
        n_back += rev.mean() > 0.5
        for a, ra, b, rb in zip(ids[:-1].tolist(), rev[:-1].tolist(),
                                ids[1:].tolist(), rev[1:].tolist()):
            s = (b"+", b"-")
            assert ((a, s[ra], b, s[rb]) in edges
                    or (b, s[not rb], a, s[not ra]) in edges)
    assert visits[1:].min() >= 1
    # the backbone's segments are on every path
    assert (visits == cfg["paths"]).sum() >= n_sites + 1
    assert n_back == round(cfg["reversed_share"] * cfg["paths"])
    # ids by first visit: the first path numbers its nodes 1, 2, 3, ...
    first = next(iter(paths.values()))[0]
    np.testing.assert_array_equal(first, np.arange(1, len(first) + 1))


def test_inversions_are_walked_in_reverse_by_their_carriers():
    _, _, paths = _parse(_gfa(3, inversions_per_mbp=20.0,
                              inversion_bp=[2000, 20000],
                              reversed_share=0.0))
    flips = [int(rev.sum()) for _, rev in paths.values()]
    assert any(flips) and not all(f == len(p[0]) for f, p in
                                  zip(flips, paths.values()))


def _spell(seqs, ids, rev) -> bytes:
    """The sequence a walk spells, reverse steps reverse complemented."""
    return b"".join(seqs[i].translate(_RC)[::-1] if r else seqs[i]
                    for i, r in zip(ids.tolist(), rev.tolist()))


@pytest.fixture(scope="module")
def looped():
    """A graph with one array and the same graph without it:
    (seqs, edges, paths) of each, at one seed."""
    seed = job_seed(2**31 + 23, 2)
    return (_parse(_gfa(seed, **LOOPED, repeat_arrays=[ARRAY])),
            _parse(_gfa(seed, **LOOPED)))


def _loop_of(ids) -> tuple:
    """(first, last) index of the array's steps in a forward carrier's
    walk: from the unit's first node, the first node that the walk
    visits again, to the last visit of the node before its return."""
    seen = {}
    for i, n in enumerate(ids.tolist()):
        if n in seen:
            return seen[n], int(np.flatnonzero(ids == ids[i - 1])[-1])
        seen[n] = i
    return None


def test_a_repeat_array_folds_into_a_loop(looped):
    (seqs, edges, paths), _ = looped
    ids = next(ids for ids, rev in paths.values()
               if rev.mean() < 0.5 and _loop_of(ids))
    a, b = _loop_of(ids)
    u0, u_end = int(ids[a]), int(ids[b])
    before, after = int(ids[a - 1]), int(ids[b + 1])
    # the back edge, from the unit's end to its start
    assert ((u_end, b"+", u0, b"+") in edges
            or (u0, b"-", u_end, b"-") in edges)
    deg = np.zeros(len(seqs) + 1, dtype=np.int64)
    carriers, absent, copies = 0, 0, []
    for ids, rev in paths.values():
        np.add.at(deg, ids, 1)
        back = bool(rev.mean() > 0.5)
        c = int((ids == u0).sum())
        if c == 0:
            # no array: the segment's halves are adjacent, and no node is
            # visited twice
            absent += 1
            assert len(np.unique(ids)) == len(ids)
            i = int(np.flatnonzero(ids == (after if back else before))[0])
            assert int(ids[i + 1]) == (before if back else after)
            continue
        carriers += 1
        copies.append(c)
        # every copy is walked whole: it enters at u0 and leaves at u_end,
        # and returns from u_end to u0 between copies
        assert int((ids == u_end).sum()) == c
        step = list(zip(ids.tolist(), rev.tolist()))
        if back:
            # a reversed path walks the loop backwards: u0- then u_end-
            assert rev[ids == u0].all()
            nxt = [step[i + 1] for i, (n, _) in enumerate(step) if n == u0]
            assert nxt == [(u_end, True)] * (c - 1) + [(before, True)]
        else:
            assert not rev[ids == u0].any()
            nxt = [step[i + 1] for i, (n, _) in enumerate(step)
                   if n == u_end]
            assert nxt == [(u0, False)] * (c - 1) + [(after, False)]
    n_absent = round(ARRAY["absent_share"] * LOOPED["paths"])
    assert (carriers, absent) == (LOOPED["paths"] - n_absent, n_absent)
    lo, hi = ARRAY["copies"]
    assert lo <= min(copies) and max(copies) <= hi
    # the unit's first segment: one step per copy of every carrier
    assert deg[u0] == sum(copies) > 128
    assert deg.max() == deg[u0]


def test_each_path_spells_its_haplotype(looped):
    """A path spells what it spells without the array, with the array's
    copies inserted where the segment was split: the copies all of the
    unit's length, differing only at its SNV sites."""
    (seqs, _, paths), (seqs0, _, paths0) = looped
    n_sites = round(sites_per_bp(LOOPED["paths"], ARRAY["unit_theta"])
                    * ARRAY["unit_bp"])
    distinct = []
    for name, (ids, rev) in paths.items():
        ids0, rev0 = paths0[name]
        back = rev.mean() > 0.5
        fwd_ids = ids[::-1] if back else ids
        lp = _loop_of(fwd_ids)
        if lp is None:
            assert _spell(seqs, ids, rev) == _spell(seqs0, ids0, rev0)
            continue
        a, b = lp
        keep = np.ones(len(ids), dtype=bool)
        if back:
            a, b = len(ids) - 1 - b, len(ids) - 1 - a
        keep[a:b + 1] = False
        assert _spell(seqs, ids[keep], rev[keep]) == _spell(seqs0, ids0,
                                                              rev0)
        loop = _spell(seqs, fwd_ids[min(lp):max(lp) + 1],
                      np.zeros(max(lp) - min(lp) + 1, bool))
        u0 = fwd_ids[lp[0]]
        c = int((ids == u0).sum())
        unit = len(loop) // c
        assert len(loop) == c * unit
        units = np.frombuffer(loop, np.uint8).reshape(c, unit)
        assert ((units != units[0]).sum(axis=1) <= n_sites).all()
        distinct.append(len(np.unique(units, axis=0)))
        assert 0.3 * ARRAY["unit_bp"] < unit < 3 * ARRAY["unit_bp"]
    # the alleles are drawn afresh at every copy
    assert max(distinct) > 1


@pytest.mark.parametrize("spec", [
    dict(ARRAY, copies=[0, 3]),
    dict(ARRAY, at=1.5),
    dict(ARRAY, unit=300),
])
def test_a_malformed_array_is_refused(spec):
    with pytest.raises(ValueError):
        _gfa(3, **LOOPED, repeat_arrays=[spec])


@pytest.mark.parametrize("ids,rev,text", [
    ([1, 22, 333], [False, True, False], b"1+,22-,333+"),
    ([0], [True], b"0-"),
    ([9, 10, 99, 100, 10**12], [0, 0, 1, 1, 0],
     b"9+,10+,99-,100-,1000000000000+"),
])
def test_steps_text_round_trip(ids, rev, text):
    assert steps_text(ids, rev) == text
    got_ids, got_rev = parse_steps(text)
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_array_equal(got_rev, np.asarray(rev, bool))


@pytest.mark.parametrize("text", [b"", b"1+,", b"1+2-", b"1 +", b"+",
                                  b"1+,,2-", b"a+", b"12"])
def test_malformed_steps_are_refused(text):
    with pytest.raises(ValueError):
        parse_steps(text)
