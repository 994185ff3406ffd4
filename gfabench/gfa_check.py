"""What a job's files say, read back without the program: the invariants
of every job and the comparison of a sampled job with the reference.

The invariants (the configurations' guarantees): every path's SHA-256
over its oriented sequence (:func:`summarize`) is kept, the node and edge counts are kept
(no job here unchops), and a layout gives both ends of every node finite
coordinates.  The comparison: the lines of the GFA a job wrote against
the reference's, and the TSV's coordinates against the reference's, both
exact.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass

import numpy as np

from .gfa_tokens import parse_steps
from .reference.algos.groom import RC_TABLE

__all__ = ["GfaSummary", "summarize", "invariant_breaks",
           "lines_differing", "read_tsv", "tsv_values_differing"]

_S_LINE = re.compile(rb"^S\t(\d+)\t([^\t\n]*)", re.M)
_P_LINE = re.compile(rb"^P\t([^\t\n]*)\t([^\t\n]*)", re.M)
_RC = RC_TABLE.tobytes()


@dataclass
class GfaSummary:
    nodes: int
    edges: int
    path_hashes: dict       # name -> SHA-256 hex of the oriented sequence
    path_steps: dict        # name -> step count
    path_bp: dict           # name -> sequence length


def _count_lines(data: bytes, tag: bytes) -> int:
    return data.count(b"\n" + tag + b"\t") + data.startswith(tag + b"\t")


def _digest(seq: bytes) -> bytes:
    return hashlib.blake2b(seq, digest_size=8).digest()


def summarize(path) -> GfaSummary:
    """Counts and path hashes of a GFA file.  A path's hash is the SHA-256
    of its steps' oriented sequences, each step as the 8-byte BLAKE2b of
    its node's sequence read in the step's orientation (reverse
    complemented on a reverse step): with the node boundaries kept (no
    job here merges or splits a node) it changes exactly where the path's
    sequence does."""
    with open(path, "rb") as fh:
        data = fh.read()
    segs = _S_LINE.findall(data)
    ids = np.array([int(i) for i, _ in segs], dtype=np.int64)
    lens = np.array([len(s) for _, s in segs], dtype=np.int64)
    fwd = np.frombuffer(b"".join(_digest(s) for _, s in segs),
                        dtype=np.uint64)
    rc = np.frombuffer(b"".join(_digest(s.translate(_RC)[::-1])
                                for _, s in segs), dtype=np.uint64)
    row = np.full(int(ids.max()) + 1 if len(ids) else 1, -1, np.int64)
    row[ids] = np.arange(len(ids))
    hashes, steps_of, bp_of = {}, {}, {}
    for name, steps in _P_LINE.findall(data):
        sid, rev = parse_steps(steps)
        r = row[np.minimum(sid, len(row) - 1)]
        if (sid >= len(row)).any() or (r < 0).any():
            raise ValueError(f"path {name.decode()} steps on a node with no "
                             f"S line")
        key = name.decode()
        hashes[key] = hashlib.sha256(
            np.where(rev, rc[r], fwd[r]).tobytes()).hexdigest()
        steps_of[key] = len(sid)
        bp_of[key] = int(lens[r].sum())
    return GfaSummary(nodes=len(segs), edges=_count_lines(data, b"L"),
                      path_hashes=hashes, path_steps=steps_of, path_bp=bp_of)


def invariant_breaks(before: GfaSummary, after: GfaSummary) -> list:
    """The guarantees a job broke, in words (empty: none)."""
    out = []
    if after.nodes != before.nodes:
        out.append(f"node count {before.nodes} -> {after.nodes}")
    if after.edges != before.edges:
        out.append(f"edge count {before.edges} -> {after.edges}")
    if set(after.path_hashes) != set(before.path_hashes):
        out.append("path names changed")
    changed = [p for p, h in before.path_hashes.items()
               if after.path_hashes.get(p, h) != h]
    if changed:
        out.append(f"{len(changed)} path sequences changed")
    return out


def lines_differing(a: bytes, b: bytes) -> int:
    """Lines at which two texts differ, the surplus of the longer included."""
    la, lb = a.split(b"\n"), b.split(b"\n")
    return sum(x != y for x, y in zip(la, lb)) + abs(len(la) - len(lb))


def read_tsv(path, dims: int) -> np.ndarray:
    """The layout TSV as node-end coordinates [2N, D] (row ``2n + e``),
    after checking its header and its node column."""
    with open(path, "rb") as fh:
        toks = fh.read().split()
    names = [f"{'xyzw'[d] if d < 4 else 'd'}{e}" for e in "+-"
             for d in range(dims)]
    width = 1 + 2 * dims
    if [t.decode() for t in toks[:width]] != ["idx"] + names:
        raise ValueError(f"unexpected TSV header {toks[:width]}")
    vals = np.array(toks[width:]).astype(np.float64).reshape(-1, width)
    if not np.array_equal(vals[:, 0], np.arange(len(vals))):
        raise ValueError("the TSV's node column is not 0..N-1")
    return vals[:, 1:].reshape(-1, dims)


def tsv_values_differing(got: np.ndarray, want: np.ndarray) -> int:
    """Coordinates that differ, every value of a missing or extra row
    counted."""
    if got.shape != want.shape:
        return int(max(got.size, want.size))
    return int((got != want).sum())
