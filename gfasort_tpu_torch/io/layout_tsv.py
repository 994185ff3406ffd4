"""nD layout container and TSV I/O.

Rebuild of the reference ``Layout`` (gfasort ``src/layout.rs``) with the
coordinates held as a ``[num_nodes, 2, dims]`` float array (end 0 = '+',
end 1 = '-'), which flattens to the reference's
``coords[node*2*D + end*D + dim]`` layout (src/layout.rs:14-24) and maps
directly onto the TPU kernel's ``[2N, D]`` state.

TSV format (src/layout.rs:138-217)::

    idx  x+  y+ ... x-  y- ...
"""

from __future__ import annotations

import io as _io
from typing import List

import numpy as np

__all__ = ["Layout"]


def _dim_name(dim: int) -> str:
    return {0: "x", 1: "y", 2: "z", 3: "w"}.get(dim, "d")


def _fmt(v: float) -> str:
    """Shortest positional decimal (Rust's f64 Display never uses
    exponent notation)."""
    return np.format_float_positional(v, unique=True, trim="-")


class Layout:
    def __init__(self, dimensions: int, num_nodes: int, coords: np.ndarray | None = None):
        self.dimensions = dimensions
        self.num_nodes = num_nodes
        if coords is None:
            coords = np.zeros((num_nodes, 2, dimensions), dtype=np.float64)
        self.coords = np.asarray(coords, dtype=np.float64).reshape(
            num_nodes, 2, dimensions
        )

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_vectors(cls, coord_vecs: List[np.ndarray]) -> "Layout":
        """From one flat vector per dimension, each of length 2*num_nodes
        with +/- ends interleaved (src/layout.rs:39-69)."""
        dims = len(coord_vecs)
        assert dims > 0
        entries = len(coord_vecs[0])
        assert entries % 2 == 0
        num_nodes = entries // 2
        coords = np.zeros((num_nodes, 2, dims), dtype=np.float64)
        for d, vec in enumerate(coord_vecs):
            assert len(vec) == entries
            coords[:, :, d] = np.asarray(vec, dtype=np.float64).reshape(num_nodes, 2)
        return cls(dims, num_nodes, coords)

    @classmethod
    def from_state(cls, state: np.ndarray) -> "Layout":
        """From the TPU kernel's ``[2N, D]`` state array (row 2i = + end
        of node i, row 2i+1 = - end)."""
        state = np.asarray(state, dtype=np.float64)
        num_nodes = state.shape[0] // 2
        return cls(state.shape[1], num_nodes, state.reshape(num_nodes, 2, -1))

    def to_state(self) -> np.ndarray:
        """``[2N, D]`` view for the device kernel."""
        return self.coords.reshape(self.num_nodes * 2, self.dimensions)

    # -- accessors (src/layout.rs:80-123) -------------------------------
    def get(self, node: int, end: int, dim: int) -> float:
        return float(self.coords[node, end, dim])

    def set(self, node: int, end: int, dim: int, value: float) -> None:
        self.coords[node, end, dim] = value

    def x_plus(self, node: int) -> float:
        return self.get(node, 0, 0)

    def y_plus(self, node: int) -> float:
        return self.get(node, 0, 1)

    def x_minus(self, node: int) -> float:
        return self.get(node, 1, 0)

    def y_minus(self, node: int) -> float:
        return self.get(node, 1, 1)

    def distance(self, node_a: int, end_a: int, node_b: int, end_b: int) -> float:
        """Euclidean distance between two node ends (src/layout.rs:126-133)."""
        d = self.coords[node_a, end_a] - self.coords[node_b, end_b]
        return float(np.sqrt((d * d).sum()))

    # -- TSV I/O (src/layout.rs:138-217) --------------------------------
    def write_tsv(self) -> str:
        out = _io.StringIO()
        out.write("idx")
        for end in "+-":
            for dim in range(self.dimensions):
                out.write(f"\t{_dim_name(dim)}{end}")
        out.write("\n")
        for node in range(self.num_nodes):
            out.write(str(node))
            for end in range(2):
                for dim in range(self.dimensions):
                    out.write("\t" + _fmt(self.coords[node, end, dim]))
            out.write("\n")
        return out.getvalue()

    def write_tsv_file(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.write_tsv())

    @classmethod
    def read_tsv(cls, text: str) -> "Layout":
        lines = [ln for ln in text.splitlines()]
        if not lines:
            raise ValueError("Empty file")
        cols = lines[0].split("\t")
        if len(cols) < 3 or (len(cols) - 1) % 2 != 0:
            raise ValueError("Invalid header format")
        dims = (len(cols) - 1) // 2
        rows = []
        for ln in lines[1:]:
            if not ln.strip():
                continue
            parts = ln.split("\t")
            if len(parts) != len(cols):
                raise ValueError(
                    f"Row has {len(parts)} columns, expected {len(cols)}"
                )
            rows.append([float(v) for v in parts[1:]])
        num_nodes = len(rows)
        layout = cls(dims, num_nodes)
        for node, vals in enumerate(rows):
            layout.coords[node, 0, :] = vals[:dims]
            layout.coords[node, 1, :] = vals[dims:]
        return layout

    @classmethod
    def read_tsv_file(cls, path) -> "Layout":
        with open(path) as fh:
            return cls.read_tsv(fh.read())

    # -- weighted-MDS stress (src/layout.rs:224-244) --------------------
    def calculate_stress(self, target_distances) -> float:
        """``target_distances``: iterable of
        (node_a, end_a, node_b, end_b, target_dist)."""
        weighted_sum = 0.0
        weight_total = 0.0
        for na, ea, nb, eb, target in target_distances:
            if target == 0.0:
                continue
            d = self.distance(na, ea, nb, eb)
            w = 1.0 / (target * target)
            err = d - target
            weighted_sum += err * err * w
            weight_total += w
        return float(np.sqrt(weighted_sum / weight_total)) if weight_total > 0 else 0.0
