"""A P line's steps as text and back, vectorised: ``12+,345-,...``, a
node id in decimal and its orientation, comma-separated.  The generator
and the reference write steps with :func:`steps_text`; the reference and
the invariants read them with :func:`parse_steps`."""

from __future__ import annotations

import numpy as np

__all__ = ["steps_text", "parse_steps"]

_PLUS, _MINUS, _COMMA, _ZERO = 43, 45, 44, 48
_POW10 = 10 ** np.arange(19, dtype=np.int64)


def steps_text(ids, rev) -> bytes:
    """The steps ``ids`` (node ids >= 0) with ``rev`` (reverse where
    true) as ``id+`` / ``id-`` tokens joined by commas."""
    ids = np.asarray(ids, dtype=np.int64)
    if len(ids) == 0:
        return b""
    nd = np.maximum(np.searchsorted(_POW10, ids, side="right"), 1)
    width = nd + 2
    width[-1] -= 1
    start = np.cumsum(width) - width
    buf = np.empty(int(width.sum()), dtype=np.uint8)
    for k in range(int(nd.max())):
        m = nd > k
        buf[start[m] + nd[m] - 1 - k] = _ZERO + (ids[m] // _POW10[k]) % 10
    buf[start + nd] = np.where(np.asarray(rev, dtype=bool), _MINUS, _PLUS)
    buf[(start + nd + 1)[:-1]] = _COMMA
    return buf.tobytes()


def parse_steps(text: bytes):
    """(ids int64, rev bool) of a steps field that :func:`steps_text`
    could have written; ValueError on any other text."""
    a = np.frombuffer(text, dtype=np.uint8)
    ends = np.flatnonzero((a == _PLUS) | (a == _MINUS))
    n = len(ends)
    if n == 0:
        raise ValueError("a path with no steps")
    start = np.empty(n, dtype=np.int64)
    start[0] = 0
    start[1:] = ends[:-1] + 2
    width = ends - start
    if (ends[-1] != len(a) - 1 or (width < 1).any()
            or (a[ends[:-1] + 1] != _COMMA).any()
            or int(width.sum()) + 2 * n - 1 != len(a)):
        raise ValueError("malformed steps")
    ids = np.zeros(n, dtype=np.int64)
    for k in range(int(width.max())):
        m = width > k
        d = a[ends[m] - 1 - k].astype(np.int64) - _ZERO
        if ((d < 0) | (d > 9)).any():
            raise ValueError("a step's id is not decimal")
        ids[m] += d * _POW10[k]
    return ids, a[ends] == _MINUS
