"""The benchmark's generator: the same seed gives the same bytes, and the
graph has the shape its docstring states (a shared backbone that every
path walks, bubbles at the sites, inversions and reversed paths, ids by
first visit).  At the configurations' size (22 Mbp, 90 paths, 14.9M
steps) it takes a few seconds: the runs print each input's time."""

from __future__ import annotations

import numpy as np
import pytest

from gfabench.generator import (GRAPH_KEYS, job_seed, pangenome_gfa,
                                sites_per_bp)
from gfabench.gfa_tokens import parse_steps, steps_text
from gfabench.tests.conftest import graph_config

SMALL = graph_config(paths=7, haplotype_bp=400_000)


def _gfa(seed, **over):
    cfg = dict(SMALL, **over)
    return pangenome_gfa(seed=seed, **{k: cfg[k] for k in GRAPH_KEYS})


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


def test_same_seed_same_bytes():
    assert _gfa(5) == _gfa(5)
    assert _gfa(5) != _gfa(6)


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
