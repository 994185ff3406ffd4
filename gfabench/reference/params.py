"""Hyper-parameter structs with ODGI defaults and graph-derived values.

Mirrors the reference parameter structs and their ``from_graph``
derivations exactly (gfasort ``src/sgd.rs:196-234`` / ``:676-763``,
``src/ygs.rs:16-92``).  The TPU engine adds one knob the Hogwild
reference did not have: ``batch`` — the number of term updates computed
per synchronous device round (SURVEY.md §2 "Parallelism" table).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from .index import PathIndex

__all__ = ["PathSGDParams", "LayoutSGDParams", "YgsParams"]

ODGI_SEED = 9399220  # fixed seed for reproducibility (src/sgd.rs:231)


@dataclass
class PathSGDParams:
    """1D path-SGD parameters (src/sgd.rs:196-234 defaults)."""

    iter_max: int = 100
    iter_with_max_learning_rate: int = 0
    min_term_updates: int = 100
    delta: float = 0.0
    eps: float = 0.01
    eta_max: float = 100.0
    theta: float = 0.99
    space: int = 100
    space_max: int = 100
    space_quantization_step: int = 100
    cooling_start: float = 0.5
    nthreads: int = 1
    progress: bool = False
    seed: int = ODGI_SEED
    # TPU engine knobs (not in the reference)
    batch: int = 4096           # term updates per synchronous round
    dtype: str = "float32"      # position dtype on device
    pow_mode: str = "fpp"       # "fpp" = bit-parity fast_precise_pow, "fast" = exp/log

    def derive_from_graph(self, pidx: PathIndex) -> "PathSGDParams":
        """ODGI's sort_main.cpp derivations (src/ygs.rs:61-79):
        min_term_updates = Σ path step counts, eta_max = (max path step
        count)², space = max path length in bp."""
        return replace(
            self,
            min_term_updates=pidx.sum_path_step_count,
            eta_max=float(pidx.max_path_step_count * pidx.max_path_step_count),
            space=pidx.max_path_length,
        )

    @property
    def first_cooling_iteration(self) -> int:
        """floor(cooling_start * iter_max) (src/sgd.rs:297)."""
        import math

        return int(math.floor(self.cooling_start * self.iter_max))


@dataclass
class LayoutSGDParams:
    """nD layout SGD parameters (src/sgd.rs:676-763)."""

    dimensions: int = 2
    iter_max: int = 30
    iter_with_max_learning_rate: int = 0
    min_term_updates: int = 100
    delta: float = 0.0
    eps: float = 0.01
    eta_max: float = 100.0
    theta: float = 0.99
    space: int = 100
    space_max: int = 1000
    space_quantization_step: int = 100
    cooling_start: float = 0.5
    nthreads: int = 1
    progress: bool = False
    seed: int = ODGI_SEED
    batch: int = 4096
    dtype: str = "float32"
    pow_mode: str = "fpp"

    def derive_from_graph(self, pidx: PathIndex, dimensions: int | None = None) -> "LayoutSGDParams":
        """ODGI layout defaults (src/sgd.rs:732-763): min_term_updates =
        10·Σ steps, eta_max = (max steps)², space = max path step count
        (in steps, not bp)."""
        return replace(
            self,
            dimensions=dimensions if dimensions is not None else self.dimensions,
            iter_max=30,
            min_term_updates=10 * pidx.sum_path_step_count,
            eta_max=float(pidx.max_path_step_count * pidx.max_path_step_count),
            space=pidx.max_path_step_count,
        )

    @property
    def first_cooling_iteration(self) -> int:
        import math

        return int(math.floor(self.cooling_start * self.iter_max))


@dataclass
class YgsParams:
    """Ygs pipeline parameters (src/ygs.rs:16-92)."""

    path_sgd: PathSGDParams = field(default_factory=lambda: PathSGDParams(
        min_term_updates=0, eta_max=0.0, space=0
    ))
    verbose: int = 0

    @classmethod
    def from_graph(cls, graph, verbose: int = 0, nthreads: int = 1) -> "YgsParams":
        pidx = PathIndex.from_graph(graph)
        params = cls(verbose=verbose)
        params.path_sgd = params.path_sgd.derive_from_graph(pidx)
        params.path_sgd = replace(
            params.path_sgd, nthreads=nthreads, progress=verbose >= 2
        )
        return params
