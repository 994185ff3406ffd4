"""The CLI job of the plain reference: parse, the pipeline's steps left to
right, the GFA and the layout it writes.

Mirrors ``gfasort_tpu_torch/cli.py::main`` and ``pipeline.py::run_pipeline``
for the sweep engines: the parameters are derived from the input graph
once, before any step; ``s`` is the exact ODGI topological sort (heads),
``g`` the BFS groom with renumbering, ``Y`` the 1D sweep engine and its
renumbering, ``L`` the nD sweep layout.  The engine must resolve to the
sweep engines (``--engine sweep``, or ``auto`` above 200,000 nodes): the
reference has no other.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from .algos.groom import apply_grooming_with_reorder, groom
from .algos.topo import exact_odgi_topological_order
from .index import PathIndex
from .io.gfa import parse_gfa_numeric, write_gfa
from .ops.sweep import path_sgd_sort_sweep
from .ops.sweep_nd import layout_coords
from .params import LayoutSGDParams, YgsParams

__all__ = ["JobResult", "job_args", "run_job"]

AUTO_ORACLE_MAX_NODES = 200_000


def job_args(argv):
    """The CLI flags a job's argv sets, with the CLI's defaults."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-p", "--pipeline", default="sYgs")
    p.add_argument("--iter-max", type=int, default=100)
    p.add_argument("--dimensions", type=int, default=2)
    p.add_argument("--layout-out", default=None)
    p.add_argument("--layout-iter", type=int, default=30)
    p.add_argument("--engine", default="auto")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--trace-out", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("-v", "--verbose", type=int, default=1)
    return p.parse_args(list(argv))


@dataclass
class JobResult:
    gfa: str                        # the GFA text the job writes
    layout: Optional[np.ndarray]    # [2N, D] node-end coordinates of L


def _engine(engine: str, n_nodes: int) -> None:
    resolved = engine
    if engine == "auto":
        resolved = "exact" if n_nodes <= AUTO_ORACLE_MAX_NODES else "sweep"
    if resolved != "sweep":
        raise ValueError(f"the reference runs the sweep engines only; "
                         f"--engine {engine} resolves to {resolved} at "
                         f"{n_nodes} nodes")


def run_job(argv, device, round_state=None) -> JobResult:
    """The job ``argv`` (the CLI's arguments) on ``device``.
    ``round_state``: see :mod:`.ops.sweep`."""
    args = job_args(argv)
    with open(args.input, "rb") as fh:
        graph = parse_gfa_numeric(fh.read())
    params = YgsParams.from_graph(graph).path_sgd
    sgd_params = replace(params, iter_max=args.iter_max)
    pidx = PathIndex.from_graph(graph)
    layout_params = replace(
        LayoutSGDParams().derive_from_graph(pidx, args.dimensions),
        iter_max=args.layout_iter)
    if args.seed is not None:
        sgd_params = replace(sgd_params, seed=args.seed)
        layout_params = replace(layout_params, seed=args.seed)
    layout = None
    for c in args.pipeline:
        if c == "s":
            graph.apply_ordering(exact_odgi_topological_order(graph))
        elif c == "g":
            apply_grooming_with_reorder(graph, groom(graph))
        elif c == "Y":
            _engine(args.engine, PathIndex.from_graph(graph).num_nodes)
            graph.apply_ordering(path_sgd_sort_sweep(graph, sgd_params, device,
                                                     round_state))
        elif c == "L":
            lp = PathIndex.from_graph(graph)
            _engine(args.engine, lp.num_nodes)
            layout = layout_coords(lp, layout_params, device, round_state)
            if layout is None:
                layout = np.zeros((2 * lp.num_nodes, args.dimensions))
        else:
            raise ValueError(f"the reference does not run step {c!r}")
    return JobResult(gfa=write_gfa(graph), layout=layout)
