"""Pipeline orchestration for the port: the ``sYgs`` / ``L`` family of
pipelines with the PyTorch sweep engines as the device engines.

The host steps (``s``, ``S``, ``g``, ``u``), the parameter derivation
and the exact oracle branches are the port's copies of
``gfasort_tpu/pipeline.py``.  Engines:

* ``"exact"`` — the sequential oracle on the host (C++ if built);
* ``"sweep"`` — the port's offset-sweep engines on ``device``: the 1D
  engine for ``Y``, the nD layout engine for ``L``;
* ``"batched"`` — the port's batched-synchronous engines on ``device``
  (``ops/sgd.py``), 1D for ``Y`` and nD for ``L``;
* ``"sharded"`` — the sharded batched engine (``parallel/sgd_shard.py``)
  for ``Y`` over a mesh of shards;
* ``"sweep-sharded"`` — the sharded sweep engine
  (``parallel/sweep_shard.py``) for ``Y``;
* ``"auto"`` — the oracle up to 200,000 nodes, the sweep engines above.

In ``L`` both sharded names run the sharded nD layout
(``parallel/sweep_nd_shard.py``).  The sharded engines run on ``mesh``,
by default :func:`~.parallel.mesh.default_mesh` on ``device``'s type
(every visible card on cuda, one shard on the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

from .algos import (apply_grooming_with_reorder, compact,
                    exact_odgi_topological_order, groom,
                    priority_topological_order)
from .graph import BidirectedGraph
from .index import PathIndex
from .io.layout_tsv import Layout
from .params import LayoutSGDParams, PathSGDParams, YgsParams
from .trace import Tracer

__all__ = [
    "PIPELINE_CHARS", "AUTO_ORACLE_MAX_NODES", "validate_pipeline",
    "sgd_sort_only", "groom_only", "topological_sort_only",
    "priority_topological_sort_only", "unchop_only", "layout_step",
    "ygs_sort", "run_pipeline", "PipelineResult",
]

PIPELINE_CHARS = "YgsSuL"

# Below this node count the sequential oracle is both fast enough and
# bit-faithful to the reference contract; above it the device engine
# wins on throughput.
AUTO_ORACLE_MAX_NODES = 200_000

_ENGINES = ("exact", "sweep", "batched", "sharded", "sweep-sharded")


def validate_pipeline(pipeline: str) -> None:
    """src/bin/gfasort.rs:169-180."""
    if not pipeline:
        raise ValueError("Pipeline cannot be empty")
    for c in pipeline:
        if c not in PIPELINE_CHARS:
            raise ValueError(
                f"Unknown pipeline character '{c}'. Valid: Y (SGD), g (groom), "
                f"s (topo-sort), S (priority-topo-sort), u (unchop), L (layout)"
            )


def _resolve_engine(engine: str, n_nodes: int, *, layout: bool = False) -> str:
    """The engine that runs; ``layout``: the ``L`` step, which (as the JAX
    ``layout_step``) sends both sharded names to the sharded nD layout and
    every other engine name to the batched engine."""
    if engine == "auto":
        return "exact" if n_nodes <= AUTO_ORACLE_MAX_NODES else "sweep"
    if layout and engine in ("sharded", "sweep-sharded"):
        return "sweep-sharded"
    if engine not in _ENGINES:
        if layout:
            return "batched"
        raise ValueError(f"unknown engine {engine!r}")
    return engine


def _mesh(mesh, device):
    from .parallel.mesh import default_mesh

    return mesh if mesh is not None else default_mesh(device=device)


def _sgd_order(graph: BidirectedGraph, params: PathSGDParams, engine: str,
               threads: int, device, mesh=None):
    engine = _resolve_engine(engine, PathIndex.from_graph(graph).num_nodes)
    if engine == "exact":
        if threads > 1:
            # deterministic N-stream emulation of the reference's -t N
            # (rs:429-432); Python-only (the native oracle is -t 1)
            from .ops.exact import path_sgd_sort_exact

            return path_sgd_sort_exact(graph, params, nthreads=threads)
        try:
            from . import native

            if native.available():
                return native.path_sgd_sort_native(graph, params)
        except Exception:
            pass
        from .ops.exact import path_sgd_sort_exact

        return path_sgd_sort_exact(graph, params)
    if engine == "batched":
        from .ops.sgd import path_sgd_sort_batched

        return path_sgd_sort_batched(graph, params, device=device)
    if engine == "sharded":
        from .parallel import path_sgd_sort_sharded

        return path_sgd_sort_sharded(graph, params, _mesh(mesh, device))
    if engine == "sweep-sharded":
        from .parallel import path_sgd_sort_sweep_sharded

        return path_sgd_sort_sweep_sharded(graph, params, _mesh(mesh, device))
    from .ops.sweep import path_sgd_sort_sweep

    return path_sgd_sort_sweep(graph, params, device=device)


def sgd_sort_only(graph: BidirectedGraph, params: PathSGDParams,
                  engine: str = "auto", threads: int = 1, *,
                  device="cuda", mesh=None) -> None:
    """'Y' step (src/ygs.rs:195-206): SGD order, then renumber."""
    graph.apply_ordering(_sgd_order(graph, params, engine, threads, device,
                                    mesh))


def groom_only(graph: BidirectedGraph) -> None:
    """'g' step (src/ygs.rs:180-192): BFS groom, apply with renumber."""
    apply_grooming_with_reorder(graph, groom(graph, use_bfs=True), reorder=True)


def topological_sort_only(graph: BidirectedGraph) -> None:
    """'s' step (src/ygs.rs:147-158): heads-only exact ODGI topo sort."""
    graph.apply_ordering(
        exact_odgi_topological_order(graph, use_heads=True, use_tails=False)
    )


def priority_topological_sort_only(graph: BidirectedGraph) -> None:
    """'S' step (src/ygs.rs:163-177): priority = current node_order."""
    order = priority_topological_order(
        graph, list(graph.node_order), use_heads=True, reverse_edges=False
    )
    graph.apply_ordering(order)


def unchop_only(graph: BidirectedGraph) -> None:
    """'u' step (src/ygs.rs:210-218): compact + sequential renumber."""
    compact(graph)
    graph.renumber_nodes_sequentially()


def layout_step(
    graph: BidirectedGraph,
    params: LayoutSGDParams,
    engine: str = "auto",
    stress_samples: int = 10_000,
    *,
    device="cuda",
    mesh=None,
) -> Tuple[Layout, float]:
    """'L' step (src/bin/gfasort.rs:265-274): nD layout + sampled stress.
    The sweep and batched engines run on ``device``, the sharded layout on
    ``mesh``."""
    pidx = PathIndex.from_graph(graph)
    eng = _resolve_engine(engine, pidx.num_nodes, layout=True)
    if eng == "exact":
        layout = None
        try:
            from . import native

            if native.available():
                layout = native.path_linear_sgd_layout_native(graph, params, pidx)
        except Exception:
            layout = None
        if layout is None:
            from .ops.exact import path_linear_sgd_layout_exact

            layout = path_linear_sgd_layout_exact(graph, params, pidx)
    elif eng == "batched":
        from .ops.sgd import path_linear_sgd_layout_batched

        layout = path_linear_sgd_layout_batched(graph, params, pidx,
                                                device=device)
    elif eng == "sweep-sharded":
        from .parallel import path_linear_sgd_layout_sweep_sharded

        layout = path_linear_sgd_layout_sweep_sharded(
            graph, params, _mesh(mesh, device), pidx=pidx)
    else:
        from .ops.sweep_nd import path_linear_sgd_layout_sweep

        layout = path_linear_sgd_layout_sweep(graph, params, pidx, device=device)
    from .ops.exact import calculate_layout_stress_pidx

    stress = calculate_layout_stress_pidx(pidx, layout, stress_samples)
    return layout, stress


def ygs_sort(graph: BidirectedGraph, params: YgsParams, engine: str = "auto",
             *, device="cuda") -> None:
    """The Ygs pipeline (src/ygs.rs:97-143): SGD, groom (BFS), topo."""
    sgd_sort_only(graph, params.path_sgd, engine, device=device)
    groom_only(graph)
    topological_sort_only(graph)


@dataclass
class PipelineResult:
    graph: BidirectedGraph
    layout: Optional[Layout] = None
    layout_stress: Optional[float] = None
    tracer: object = None


def run_pipeline(
    graph: BidirectedGraph,
    pipeline: str = "sYgs",
    iter_max: int = 100,
    dimensions: int = 2,
    layout_iter: int = 30,
    engine: str = "auto",
    seed: Optional[int] = None,
    batch: Optional[int] = None,
    verbose: int = 0,
    log=print,
    tracer=None,
    threads: int = 1,
    *,
    device="cuda",
    mesh=None,
) -> PipelineResult:
    """Run a pipeline string left to right on ``graph`` (mutating it);
    parameters are derived from the input graph once, before any step,
    as in ``gfasort_tpu.pipeline.run_pipeline``.  ``mesh``: the sharded
    engines' mesh (default: ``default_mesh`` on ``device``'s type)."""
    validate_pipeline(pipeline)
    tracer = tracer if tracer is not None else Tracer()
    with tracer.active():
        with tracer.span("pipeline.params"):
            ygs_params = YgsParams.from_graph(graph, verbose=verbose)
            sgd_params = replace(ygs_params.path_sgd, iter_max=iter_max)
            pidx = PathIndex.from_graph(graph)
            layout_params = LayoutSGDParams().derive_from_graph(pidx,
                                                                dimensions)
            layout_params = replace(layout_params, iter_max=layout_iter)
            if seed is not None:
                sgd_params = replace(sgd_params, seed=seed)
                layout_params = replace(layout_params, seed=seed)
            if batch is not None:
                sgd_params = replace(sgd_params, batch=batch)
                layout_params = replace(layout_params, batch=batch)

        result = PipelineResult(graph=graph, tracer=tracer)
        names = {
            "Y": "SGD", "g": "groom", "s": "topo-sort",
            "S": "priority-topo-sort", "u": "unchop",
            "L": f"{dimensions}D layout",
        }
        for step_num, c in enumerate(pipeline):
            if verbose >= 1:
                log(f"[gfasort] [{step_num + 1}/{len(pipeline)}] {names[c]}")
            with tracer.step(names[c], step=step_num + 1,
                             nodes=graph.node_count(), edges=len(graph.edges)):
                if c == "Y":
                    sgd_sort_only(graph, sgd_params, engine, threads,
                                  device=device, mesh=mesh)
                elif c == "g":
                    groom_only(graph)
                elif c == "s":
                    topological_sort_only(graph)
                elif c == "S":
                    priority_topological_sort_only(graph)
                elif c == "u":
                    unchop_only(graph)
                elif c == "L":
                    layout, stress = layout_step(graph, layout_params, engine,
                                                 device=device, mesh=mesh)
                    result.layout = layout
                    result.layout_stress = stress
                    if verbose >= 1:
                        log(f"[gfasort] layout stress: {stress:.6f}")
            if verbose >= 1:
                log(f"[gfasort]   {names[c]} took "
                    f"{tracer.events[-1].seconds:.2f}s")
    if verbose >= 2:
        log(f"[gfasort] step timings: {tracer.summary()}")
    return result
