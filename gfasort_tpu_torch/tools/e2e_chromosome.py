"""Chromosome-scale end-to-end run of the port (counterpart of
``scripts/e2e_chromosome.py``).

Generates a synthetic pangenome GFA (1M nodes, 16 paths x 250k steps by
default), runs the whole CLI pipeline ``sYgsuL`` with the sweep engine
forced in a fresh process, checks that every path's hash is kept and
that unchop grew no node, and writes a timing artifact (the CLI's
``--trace-out`` step log with the generation, load and check times) to
``<work-dir>/E2E_CHROMOSOME.json``.

    python -m gfasort_tpu_torch.tools.e2e_chromosome                 # 1M nodes
    python -m gfasort_tpu_torch.tools.e2e_chromosome --nodes 50000   # reduced
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[2]


def default_work_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "gfasort_torch_e2e")


def job_argv(iter_max: int, layout_iter: int, tsv_out, device: str) -> list:
    """The pipeline flags of the ``sYgsuL`` job."""
    return ["-p", "sYgsuL",
            "--engine", "sweep",
            "--iter-max", str(iter_max),
            "--layout-iter", str(layout_iter),
            "--dimensions", "2",
            "--layout-out", str(tsv_out),
            "--device", device]


def device_name(device: str) -> str:
    """The card's name for a cuda device, else the device's type."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev.index or 0)
    return dev.type


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gfasort_tpu_torch.tools.e2e_chromosome")
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--paths", type=int, default=16)
    ap.add_argument("--steps", type=int, default=250_000)
    ap.add_argument("--iter-max", type=int, default=30)
    ap.add_argument("--layout-iter", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work-dir", default=default_work_dir())
    ap.add_argument("--artifact", default=None,
                    help="default: <work-dir>/E2E_CHROMOSOME.json")
    args = ap.parse_args(argv)

    from ..io.fast_gfa import load_gfa_numeric_fast
    from .make_synthetic_gfa import write_synthetic_gfa

    wd = pathlib.Path(args.work_dir)
    wd.mkdir(parents=True, exist_ok=True)
    gfa_in = wd / f"synthetic_{args.nodes}_{args.paths}_{args.steps}.gfa"
    gfa_out = wd / "sorted.gfa"
    tsv_out = wd / "layout.tsv"
    trace_out = wd / "trace.jsonl"

    timings = {}
    if not gfa_in.exists():
        t0 = time.time()
        write_synthetic_gfa(
            str(gfa_in), n_nodes=args.nodes, n_paths=args.paths,
            steps_per_path=args.steps, seed=0,
        )
        timings["generate_gfa_s"] = time.time() - t0
    print(f"[e2e] input: {gfa_in} ({gfa_in.stat().st_size >> 20} MiB)",
          file=sys.stderr, flush=True)

    # pre-pipeline path hashes (the invariant every step must preserve)
    t0 = time.time()
    g0 = load_gfa_numeric_fast(str(gfa_in))
    h0 = g0.compute_all_path_hashes()
    timings["load_and_hash_s"] = time.time() - t0
    n_nodes0, n_edges0 = g0.node_count(), len(g0.edges)
    del g0

    cmd = [sys.executable, "-m", "gfasort_tpu_torch",
           "-i", str(gfa_in), "-o", str(gfa_out),
           *job_argv(args.iter_max, args.layout_iter, tsv_out, args.device),
           "--trace-out", str(trace_out), "-v", "2"]
    print("[e2e] running:", " ".join(cmd), file=sys.stderr, flush=True)
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True)
    timings["cli_wall_s"] = time.time() - t0
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        print(f"[e2e] CLI FAILED rc={proc.returncode}", file=sys.stderr)
        return 1

    # verify: hashes preserved; unchop merges nodes, never adds any
    t0 = time.time()
    g1 = load_gfa_numeric_fast(str(gfa_out))
    h1 = g1.compute_all_path_hashes()
    timings["reload_and_verify_s"] = time.time() - t0
    if h1 != h0:
        print("[e2e] path hashes changed across sYgsuL", file=sys.stderr)
        return 1
    if g1.node_count() > n_nodes0:
        print(f"[e2e] node count grew: {n_nodes0} -> {g1.node_count()}",
              file=sys.stderr)
        return 1

    steps = [json.loads(ln) for ln in trace_out.read_text().splitlines()
             if ln.strip()]
    artifact = {
        "device": device_name(args.device),
        "workload": {
            "nodes": args.nodes, "paths": args.paths,
            "steps_per_path": args.steps,
            "input_nodes": n_nodes0, "input_edges": n_edges0,
            "output_nodes": g1.node_count(), "output_edges": len(g1.edges),
        },
        "pipeline": "sYgsuL", "engine": "sweep",
        "iter_max": args.iter_max, "layout_iter": args.layout_iter,
        "path_hashes_preserved": True,
        "timings": timings,
        "step_timings": steps,
    }
    out = pathlib.Path(args.artifact or wd / "E2E_CHROMOSOME.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=1))
    print(f"[e2e] OK — artifact: {out}", file=sys.stderr)
    print(json.dumps({"ok": True, "cli_wall_s": timings["cli_wall_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
