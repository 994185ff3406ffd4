"""gfasort CLI for the PyTorch/CUDA port.

Usage::

    python -m gfasort_tpu_torch -i in.gfa -o out.gfa [-p sYgs] [--iter-max 100]
        [-t 1] [-v 1] [--dimensions 2] [--layout-out layout.tsv]
        [--layout-iter 30]
        [--engine auto|exact|sweep|batched|sharded|sweep-sharded] [--seed N]
        [--batch B] [--trace-out steps.jsonl] [--device cuda] [--distributed]
        [--server]

The flags are those of ``gfasort_tpu.cli`` that the port serves.  The
device engine runs on ``--device`` (default ``cuda``); with no CUDA
device it fails rather than fall back to the CPU.  The sharded engines
take one shard per visible card (one shard with ``--device cpu``);
``--distributed`` first joins the process group that the
``GFASORT_COORDINATOR``, ``GFASORT_NUM_PROCESSES`` and
``GFASORT_PROCESS_ID`` variables describe (NCCL on cuda, gloo on the
CPU), and the sharded engines then take one shard per process.
``--server`` routes the job to the warm process of
:mod:`gfasort_tpu_torch.server` (spawned on first use); the routing
happens before anything that imports ``torch``, so the client stays
light.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gfasort",
        description="Sort a GFA file using configurable pipeline steps "
                    "(PyTorch/CUDA)",
    )
    p.add_argument("-i", "--input", required=True, help="Input GFA file")
    p.add_argument("-o", "--output", required=True, help="Output GFA file")
    p.add_argument(
        "-p", "--pipeline", default="sYgs",
        help="Pipeline: Y=SGD g=groom s=topo S=priority-topo u=unchop L=layout "
             "(default: sYgs)",
    )
    p.add_argument("--iter-max", type=int, default=100, help="SGD iterations")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="Worker-stream count for the exact oracle engine; "
                        "the device engine ignores it")
    p.add_argument("-v", "--verbose", type=int, default=1,
                   help="Verbosity 0/1/2")
    p.add_argument("--dimensions", type=int, default=2,
                   help="Layout dimensions (L step)")
    p.add_argument("--layout-out", default=None,
                   help="Layout TSV output path (L step)")
    p.add_argument("--layout-iter", type=int, default=30,
                   help="Layout iterations (L step)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "exact", "sweep", "batched", "sharded",
                            "sweep-sharded"],
                   help="SGD engine: exact oracle / offset-sweep on the "
                        "device / batched rounds on the device / sharded "
                        "batched rounds / sharded offset-sweep (both over "
                        "a mesh of shards) / auto (oracle up to 200k nodes)")
    p.add_argument("--seed", type=int, default=None,
                   help="Override the fixed seed (default 9399220)")
    p.add_argument("--batch", type=int, default=None,
                   help="Batched engine round width (terms per round)")
    p.add_argument("--trace-out", default=None,
                   help="Write per-step timing events as JSON lines")
    p.add_argument("--device", default="cuda",
                   help="Device of the device engines, and the shards' "
                        "device type (default: cuda)")
    p.add_argument("--distributed", action="store_true",
                   help="Join a multi-process run (GFASORT_COORDINATOR, "
                        "GFASORT_NUM_PROCESSES, GFASORT_PROCESS_ID)")
    p.add_argument("--server", action="store_true",
                   help="Route this invocation through the warm-process "
                        "server (spawned on first use, reused afterwards; "
                        "the job runs with the server's environment) - "
                        "see gfasort_tpu_torch/server.py")
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if "--server" in argv and not os.environ.get("GFASORT_IN_SERVER"):
        # route to (or spawn) the warm process; the job re-enters this
        # function there WITHOUT the flag
        from .server import run_via_server

        return run_via_server([a for a in argv if a != "--server"])
    args = build_parser().parse_args(argv)
    from .pipeline import validate_pipeline
    from .trace import Tracer

    if args.distributed:
        from .parallel.mesh import init_distributed

        init_distributed(device=args.device)

    try:
        validate_pipeline(args.pipeline)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    tracer = Tracer()
    with tracer.active():
        return _run(args, tracer)


def _run(args, tracer) -> int:
    """The job of the parsed ``args``: read, run the pipeline, write;
    its spans go to ``tracer``."""
    from .io import gfa as gfa_io
    from .io.fast_gfa import load_gfa_numeric_fast
    from .pipeline import run_pipeline

    def log(*a):
        print(*a, file=sys.stderr)

    if args.verbose >= 1:
        log(f"[gfasort] reading {args.input}")
    try:
        with tracer.span("gfa.read"):
            graph = load_gfa_numeric_fast(args.input)
    except OSError as e:
        print(f"Error reading file: {e}", file=sys.stderr)
        return 1
    except (ValueError, IndexError) as e:
        print(f"Error parsing GFA: {e}", file=sys.stderr)
        return 1
    if args.verbose >= 1:
        log(f"[gfasort] loaded {graph.node_count()} nodes, "
            f"{len(graph.edges)} edges, {len(graph.paths)} paths")

    t0 = tracer.now()
    result = run_pipeline(
        graph,
        pipeline=args.pipeline,
        iter_max=args.iter_max,
        dimensions=args.dimensions,
        layout_iter=args.layout_iter,
        engine=args.engine,
        seed=args.seed,
        batch=args.batch,
        verbose=args.verbose,
        log=log,
        tracer=tracer,
        threads=args.threads,
        device=args.device,
    )
    if args.verbose >= 2:
        log(f"[gfasort] pipeline took {tracer.now() - t0:.2f}s")
    if args.trace_out:
        tracer.write(args.trace_out)
    if result.layout is not None:
        if args.layout_out:
            if args.verbose >= 1:
                log(f"[gfasort] writing layout to {args.layout_out}")
            with tracer.span("tsv.write"):
                result.layout.write_tsv_file(args.layout_out)
        elif args.verbose >= 1:
            log("[gfasort] warning: layout computed but --layout-out not specified")
    if args.verbose >= 1:
        log(f"[gfasort] writing {args.output}")
    with tracer.span("gfa.write"), open(args.output, "w") as fh:
        fh.write(gfa_io.write_gfa(graph))
    if args.verbose >= 1:
        log("[gfasort] done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
