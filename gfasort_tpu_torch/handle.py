"""Oriented node handles for bidirected pangenome graphs.

A handle packs a node id and an orientation bit into a single integer:
``handle = (node_id << 1) | is_reverse``. This mirrors the reference
encoding (gfasort ``src/graph.rs:11-64``) because it is also the right
*array* encoding for a TPU-resident graph: handle arrays are plain
``uint64``/``int64`` tensors, and flipping orientation is ``handle ^ 1``.

All functions here are dual-use: they accept Python ints or numpy/JAX
arrays and are safe to call inside ``jit``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "encode",
    "forward",
    "reverse",
    "node_id",
    "is_reverse",
    "flip",
    "orientation_char",
    "fmt",
    "reverse_complement",
]


def encode(nid, rev):
    """Handle from node id + orientation. ``rev`` may be bool or 0/1 array."""
    return (nid << 1) | rev


def forward(nid):
    """Forward-strand handle for ``nid`` (reference: src/graph.rs:22-24)."""
    return nid << 1


def reverse(nid):
    """Reverse-strand handle for ``nid`` (reference: src/graph.rs:27-29)."""
    return (nid << 1) | 1


def node_id(handle):
    """Node id stored in a handle (reference: src/graph.rs:32-34)."""
    return handle >> 1


def is_reverse(handle):
    """Orientation bit of a handle (reference: src/graph.rs:37-39)."""
    return handle & 1


def flip(handle):
    """Flip orientation: XOR of the LSB (reference: src/graph.rs:51-53)."""
    return handle ^ 1


def orientation_char(handle) -> str:
    """'+' or '-' for a scalar handle (reference: src/graph.rs:42-48)."""
    return "-" if (handle & 1) else "+"


def fmt(handle) -> str:
    """Human-readable ``<id><+/->`` form of a scalar handle."""
    return f"{handle >> 1}{orientation_char(handle)}"


# Reverse-complement lookup covering the bases the reference maps
# (A/T/C/G case-insensitive -> complement uppercase, N/n -> N, everything
# else passes through unchanged; reference: src/graph.rs:72-85).
_RC_TABLE = np.arange(256, dtype=np.uint8)
for _src, _dst in [
    (b"A", b"T"), (b"a", b"T"),
    (b"T", b"A"), (b"t", b"A"),
    (b"C", b"G"), (b"c", b"G"),
    (b"G", b"C"), (b"g", b"C"),
    (b"N", b"N"), (b"n", b"N"),
]:
    _RC_TABLE[_src[0]] = _dst[0]


def reverse_complement(seq: bytes) -> bytes:
    """Reverse complement of a DNA byte string (reference: src/graph.rs:72-85)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _RC_TABLE[arr[::-1]].tobytes()
