"""The traffic's input graphs: synthetic pangenome GFAs, one per job.

A graph is the variation graph of ``paths`` haplotypes of one chromosome
region of ``haplotype_bp`` bases.  All haplotypes walk one shared
backbone: segments of the backbone are nodes that every path visits, and
between two segments lies a variant site, a bubble.  The site count is
Watterson's: ``theta`` per base times the harmonic number of
``paths - 1``.  A site is an SNV (a 1 bp node for each allele) or, a
share ``indel_share`` of them, an insertion or a deletion of 1 to
``max_indel_bp`` bases (one node, which the allele's carriers visit or
skip).  Each site's alternative allele is carried by k of the haplotypes,
k drawn from the neutral frequency spectrum (weight 1/k), the carriers at
random.  ``inversions_per_mbp`` inversions of ``inversion_bp`` bases
(log-uniform between the two) are walked in reverse, node by node, by
their carriers (k drawn the same way).  Segment lengths are exponential
around the mean gap between sites.  A share ``reversed_share`` of the
paths, chosen at random, runs against the backbone from end to start, as
an assembled contig of either strand does.

Node ids follow the order in which the paths, in file order, first visit
the nodes, as a graph inducer that reads the haplotypes one after another
numbers them.  L lines are every adjacency of the paths, once each.  The
same arguments give the same bytes; the site, indel and inversion counts
are fixed by the sizes, so every seed gives the same amount of work up
to the draws of k.

``repeat_arrays`` (optional; absent or empty, the graph above byte for
byte) folds tandem-repeat arrays into the graph as an all-to-all aligner
such as PGGB collapses a centromeric satellite: the copies of one repeat
unit become one chain of unit nodes with an edge from its last node back
to its first.  Each array sits at the fraction ``at`` along the
backbone, inside the nearest backbone segment of 2 bp or more that no
inversion holds, which it splits in two.  Its unit of ``unit_bp`` bases
is built as the backbone is, of segments and SNV sites, with
``unit_theta`` in the place of ``theta``, each site's alternative allele
at a frequency drawn from the same spectrum.  A share ``absent_share`` of
the haplotypes, at random, lacks the array and steps from the segment's
first half to its second; every other haplotype carries ``copies`` =
[lo, hi] copies, its count drawn uniformly, and walks the unit once per
copy, in its own orientation, picking each site's allele afresh at every
copy.  These draws come from a stream of their own per array, seeded
from the graph's seed, so no draw of the backbone moves.
"""

from __future__ import annotations

import time

import numpy as np

from .gfa_tokens import steps_text

__all__ = ["GRAPH_KEYS", "job_seed", "sites_per_bp", "pangenome_gfa",
           "write_pangenome_gfa"]

# the keys of a configuration's file that fix its graphs
GRAPH_KEYS = ("paths", "haplotype_bp", "theta", "indel_share",
              "max_indel_bp", "inversions_per_mbp", "inversion_bp",
              "reversed_share", "chrom")

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

# the repeat arrays' streams: np.random.default_rng([seed, _ARRAY_TAG, a])
# for array a
_ARRAY_TAG = 0x5A7E11
_ARRAY_KEYS = {"at", "unit_bp", "unit_theta", "copies", "absent_share"}


def job_seed(seed: int, job: int) -> int:
    """The generator seed of job ``job`` of the run with ``--seed`` seed:
    distinct for every (seed, job) pair with 0 <= job < 2**20."""
    return int(seed) * (1 << 20) + int(job)


def sites_per_bp(paths: int, theta: float) -> float:
    """Watterson's expected segregating sites per base among ``paths``
    haplotypes."""
    return theta * float(np.sum(1.0 / np.arange(1, paths)))


def _alt_counts(rng, n: int, paths: int) -> np.ndarray:
    """n allele counts in 1..paths-1 from the neutral spectrum."""
    k = np.arange(1, paths)
    return rng.choice(k, size=n, p=(1.0 / k) / np.sum(1.0 / k))


def _carriers(rng, counts: np.ndarray, paths: int) -> np.ndarray:
    """[n, paths] bool: row i has counts[i] carriers, at random."""
    keys = rng.random((len(counts), paths))
    kth = np.sort(keys, axis=1)[np.arange(len(counts)), counts - 1]
    return keys <= kth[:, None]


def _fold_array(spec: dict, rng, paths: int, free: np.ndarray,
                n_slots: int):
    """One repeat array (``spec``, an entry of ``repeat_arrays``), its
    draws from ``rng``, placed in the free segment nearest its ``at``
    (``free``: [n_sites + 1] bool).  Its new slots number from
    ``n_slots``: the unit's, each site as a segment, a ref and an alt
    node, the closing segment, and last the split segment's second half.
    Returns (segment index, per haplotype the slots it walks after the
    segment's first half, the unit's node lengths, the unit's bases)."""
    if set(spec) != _ARRAY_KEYS:
        raise ValueError(f"a repeat array has the keys {sorted(_ARRAY_KEYS)}"
                         f", not {sorted(spec)}")
    lo, hi = (int(c) for c in spec["copies"])
    if not (0 <= spec["at"] <= 1 and spec["unit_bp"] >= 1 and 1 <= lo <= hi
            and 0 <= spec["absent_share"] <= 1 and free.any()):
        raise ValueError(f"a repeat array out of range, or no free "
                         f"segment left for it: {spec}")
    cand = np.flatnonzero(free)
    seg = int(cand[np.argmin(np.abs(cand - spec["at"] * (len(free) - 1)))])

    n_us = max(1, int(round(sites_per_bp(paths, spec["unit_theta"])
                            * spec["unit_bp"])))
    gap = spec["unit_bp"] / (n_us + 1)
    unit_len = np.ones(3 * n_us + 1, dtype=np.int64)
    unit_len[0::3] = 1 + np.floor(rng.exponential(max(gap - 1, 0.0),
                                                  n_us + 1)).astype(np.int64)
    freq = _alt_counts(rng, n_us, paths) / paths
    bases = rng.integers(0, 4, size=int(unit_len.sum()), dtype=np.uint8)
    start = np.cumsum(unit_len) - unit_len
    bases[start[2::3]] = (bases[start[1::3]] + 1
                          + rng.integers(0, 3, size=n_us)) % 4
    absent = np.zeros(paths, dtype=bool)
    absent[:int(round(spec["absent_share"] * paths))] = True
    absent = rng.permutation(absent)
    copies = np.where(absent, 0, rng.integers(lo, hi + 1, size=paths))
    alt = rng.random((int(copies.sum()), n_us)) < freq
    # one row per copy: the segments, and each site's ref or alt node
    rows = np.empty((len(alt), 2 * n_us + 1), dtype=np.int64)
    rows[:, 0::2] = n_slots + 3 * np.arange(n_us + 1)
    rows[:, 1::2] = n_slots + 3 * np.arange(n_us) + 1 + alt
    second_half = n_slots + len(unit_len)
    ends = np.cumsum(copies)
    inserts = [np.append(rows[e - c:e].ravel(), second_half)
               for c, e in zip(copies.tolist(), ends.tolist())]
    return seg, inserts, unit_len, bases


def pangenome_gfa(paths: int, haplotype_bp: int, theta: float,
                  indel_share: float, max_indel_bp: int,
                  inversions_per_mbp: float, inversion_bp,
                  reversed_share: float, seed: int,
                  chrom: str = "chr", repeat_arrays=()) -> bytes:
    """The whole GFA, as bytes."""
    rng = np.random.default_rng(seed)
    per_bp = sites_per_bp(paths, theta)
    n_sites = max(1, int(round(per_bp * haplotype_bp)))
    # segment i precedes site i; segment n_sites closes the backbone
    mean_gap = haplotype_bp / (n_sites + 1)
    seg_len = 1 + np.floor(rng.exponential(max(mean_gap - 1, 0.0),
                                           n_sites + 1)).astype(np.int64)
    # site kinds: 0 SNV, 1 insertion (alt node only), 2 deletion (ref only)
    n_indel = int(round(indel_share * n_sites))
    kind = np.zeros(n_sites, dtype=np.int64)
    kind[:n_indel // 2] = 1
    kind[n_indel // 2:n_indel] = 2
    kind = rng.permutation(kind)
    indel_len = rng.integers(1, max_indel_bp + 1, size=n_sites)
    carry = _carriers(rng, _alt_counts(rng, n_sites, paths), paths)

    # the slots of the backbone, one node each: per site its segment, its
    # ref node (not for an insertion) and its alt node (not for a
    # deletion), then the closing segment.  slot role: 0 segment, 1 ref,
    # 2 alt.
    has = np.stack([np.ones(n_sites, bool), kind != 1, kind != 2], axis=1)
    role = np.broadcast_to(np.arange(3), has.shape)[has]
    site = np.broadcast_to(np.arange(n_sites)[:, None], has.shape)[has]
    role = np.append(role, 0)
    site = np.append(site, n_sites)
    n_nodes = len(role)
    node_len = np.where(role == 0, seg_len[site],
                        np.where(kind[np.minimum(site, n_sites - 1)] == 0,
                                 1, indel_len[np.minimum(site,
                                                         n_sites - 1)]))
    seg_slot = np.flatnonzero(role == 0)

    # inversions: runs of whole segments and the sites between them,
    # disjoint, the first and last segment never inside one
    n_inv = int(round(inversions_per_mbp * haplotype_bp / 1e6))
    lo_bp, hi_bp = inversion_bp
    span = np.maximum(1, np.round(per_bp * np.exp(rng.uniform(
        np.log(lo_bp), np.log(hi_bp), n_inv)))).astype(np.int64)
    span = np.minimum(span, max(n_sites - 2, 1))
    first = np.sort(1 + (rng.random(n_inv) * np.maximum(
        n_sites - 1 - span, 1)).astype(np.int64))
    last = np.minimum(first + span - 1, np.append(first[1:] - 1, n_sites - 1))
    inv_carry = _carriers(rng, _alt_counts(rng, n_inv, paths), paths)
    inv_lo, inv_hi = seg_slot[first], seg_slot[last] + 1   # slot ranges

    backward = np.zeros(paths, dtype=bool)
    backward[:int(round(reversed_share * paths))] = True
    backward = rng.permutation(backward)

    # the repeat arrays: segments that no inversion holds are free
    free = np.cumsum(np.bincount(first, minlength=n_sites + 2)
                     - np.bincount(last + 1, minlength=n_sites + 2))[:-1] == 0
    free &= seg_len >= 2
    arrays, n_slots = [], n_nodes
    for k, spec in enumerate(repeat_arrays or ()):
        arr = _fold_array(spec, np.random.default_rng([seed, _ARRAY_TAG, k]),
                          paths, free, n_slots)
        free[arr[0]] = False
        n_slots += len(arr[2]) + 1
        arrays.append(arr)

    carry_pad = np.vstack([carry, np.zeros((1, paths), bool)])
    walks = []
    for h in range(paths):
        c = carry_pad[site, h]
        walk = np.flatnonzero((role == 0) | ((role == 1) & ~c)
                              | ((role == 2) & c))
        rev = np.zeros(len(walk), dtype=bool)
        for i in np.flatnonzero(inv_carry[:, h]):
            a, b = np.searchsorted(walk, [inv_lo[i], inv_hi[i]])
            walk[a:b] = walk[a:b][::-1].copy()
            rev[a:b] = True
        for seg, inserts, _, _ in arrays:
            p = int(np.flatnonzero(walk == seg_slot[seg])[0]) + 1
            walk = np.concatenate([walk[:p], inserts[h], walk[p:]])
            rev = np.concatenate([rev[:p], np.zeros(len(inserts[h]), bool),
                                  rev[p:]])
        if backward[h]:
            walk, rev = walk[::-1].copy(), ~rev[::-1]
        walks.append((walk, rev))

    # ids by first visit, the paths in file order (an allele node of a
    # unit that no copy picked is left out)
    allw = np.concatenate([w for w, _ in walks])
    seen, first_at = np.unique(allw, return_index=True)
    node_id = np.zeros(n_slots, dtype=np.int64)
    node_id[seen[np.argsort(first_at, kind="stable")]] = np.arange(
        1, len(seen) + 1)

    # sequences, the alt base of an SNV unlike its ref base
    off = np.cumsum(node_len) - node_len
    seq = rng.integers(0, 4, size=int(node_len.sum()), dtype=np.uint8)
    snv = np.flatnonzero(kind == 0)
    ref_slot = np.flatnonzero((role == 1) & (kind[np.minimum(
        site, n_sites - 1)] == 0))
    alt_slot = np.flatnonzero((role == 2) & (kind[np.minimum(
        site, n_sites - 1)] == 0))
    seq[off[alt_slot]] = (seq[off[ref_slot]] + 1
                          + rng.integers(0, 3, size=len(snv))) % 4
    # each array's unit, then its segment's second half, which keeps the
    # backbone's bases where they were
    for seg, _, unit_len, bases in arrays:
        s_at, s_len = off[seg_slot[seg]], node_len[seg_slot[seg]]
        half = s_len // 2
        node_len[seg_slot[seg]] = half
        off = np.concatenate([off, len(seq) + np.cumsum(unit_len) - unit_len,
                              [s_at + half]])
        node_len = np.concatenate([node_len, unit_len, [s_len - half]])
        seq = np.concatenate([seq, bases])
    blob = _BASES[seq].tobytes()

    out = [b"H\tVN:Z:1.0"]
    by_id = seen[np.argsort(node_id[seen])]
    out += [b"S\t%d\t%s" % (i + 1, blob[o:o + n]) for i, (o, n) in
            enumerate(zip(off[by_id].tolist(), node_len[by_id].tolist()))]
    # L lines: the path adjacencies in canonical (smaller-handle-first)
    # form, deduplicated and sorted; handle = id * 2 + rev
    hs = [node_id[w] * 2 + r for w, r in walks]
    fh = np.concatenate([h[:-1] for h in hs])
    th = np.concatenate([h[1:] for h in hs])
    cf, ct = th ^ 1, fh ^ 1
    use_c = (cf < fh) | ((cf == fh) & (ct < th))
    key = np.unique((np.where(use_c, cf, fh) << 32) | np.where(use_c, ct, th))
    sign = (b"+", b"-")
    out += [b"L\t%d\t%s\t%d\t%s\t0M" % (a >> 1, sign[a & 1], b >> 1,
                                         sign[b & 1])
            for a, b in zip((key >> 32).tolist(),
                            (key & 0xFFFFFFFF).tolist())]
    for p, (walk, rev) in enumerate(walks):
        out.append(b"P\thap%d#%s\t%s\t*" % (p, chrom.encode(),
                                            steps_text(node_id[walk], rev)))
    out.append(b"")
    return b"\n".join(out)


def write_pangenome_gfa(path, config: dict, seed: int) -> float:
    """Write the graph of ``config`` (a configuration's file, its keys
    ``GRAPH_KEYS`` and, where it has one, ``repeat_arrays``) for ``seed``
    to ``path``; returns the seconds that making the text took, the write
    left out."""
    t0 = time.perf_counter()
    data = pangenome_gfa(seed=seed, **{k: config[k] for k in GRAPH_KEYS},
                         repeat_arrays=config.get("repeat_arrays", ()))
    text_s = time.perf_counter() - t0
    with open(path, "wb") as fh:
        fh.write(data)
    return text_s
