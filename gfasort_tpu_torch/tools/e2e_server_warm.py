"""Warm-process server end to end (counterpart of
``scripts/e2e_server_warm.py``).

Runs the SAME CLI job twice through the port's ``--server``, each time
from a fresh client process:

* run 1 spawns the daemon and pays the whole per-process set-up (torch
  import, CUDA context, kernel library, the engine's host set-up);
* run 2 is served by the same live process, whose runner cache holds
  the engine built by run 1.

Reports both runs' client walls, the daemon's own job walls and the
per-step walls of the CLI's ``--trace-out``, checks that both jobs ran
in one process and wrote byte-identical outputs, writes
``<work-dir>/E2E_SERVER_WARM.json`` and stops the daemon.

    python -m gfasort_tpu_torch.tools.e2e_server_warm                 # 1M nodes
    python -m gfasort_tpu_torch.tools.e2e_server_warm --nodes 50000   # reduced
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

from .e2e_chromosome import REPO, default_work_dir, device_name

_SERVED = re.compile(r"served by warm process (\d+) in ([0-9.]+)s")


def step_walls(trace_path) -> dict:
    """step name -> wall seconds from a --trace-out JSONL."""
    walls = {}
    for line in pathlib.Path(trace_path).read_text().splitlines():
        if not line.strip():
            continue
        ev = json.loads(line)
        if "seconds" in ev and ev.get("event"):
            walls[ev["event"]] = float(ev["seconds"])
    return walls


def _client_env(sock: str) -> dict:
    env = dict(os.environ)
    env["GFASORT_SERVER_SOCKET"] = sock
    # prepend the repo: the client and the daemon it spawns import the
    # package from this checkout
    env["PYTHONPATH"] = str(REPO) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def running(pid: int) -> bool:
    """Whether ``pid`` is a live process: neither gone nor a zombie
    (a daemon whose parent client exited is reaped by whoever adopted
    it, maybe late)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def stop_server(sock: str, wait_s: float = 60.0) -> None:
    """Stop the daemon on ``sock``, if one answers; kill it if it
    outlives the request by ``wait_s`` seconds."""
    from ..server import request

    try:
        pid = request(sock, {"op": "ping"}, timeout=5.0)["pid"]
    except OSError:
        return
    with contextlib.suppress(subprocess.TimeoutExpired):
        subprocess.run(
            [sys.executable, "-m", "gfasort_tpu_torch.server", "--socket",
             sock, "stop"],
            env=_client_env(sock), cwd=str(REPO), capture_output=True,
            timeout=60)
    deadline = time.monotonic() + wait_s
    while running(pid) and time.monotonic() < deadline:
        time.sleep(0.2)
    if running(pid):
        os.kill(pid, signal.SIGKILL)


def serve_twice(gfa_in, work_dir, job_argv: list, sock: str,
                timeout: float = 3600) -> list:
    """Run ``python -m gfasort_tpu_torch -i gfa_in -o ... *job_argv
    --server`` twice from fresh clients against the daemon on ``sock``
    (spawned by the first), then stop the daemon.  Returns one dict per
    run: client wall, served wall and pid (from the client's log), the
    trace's step walls and the output path."""
    wd = pathlib.Path(work_dir)
    if len(os.fsencode(sock)) > 100:
        # a unix socket path stops at 107 bytes; every process here
        # (clients and daemon) runs in REPO
        sock = os.path.relpath(sock, REPO)
    env = _client_env(sock)
    runs = []
    try:
        for i in (1, 2):
            out = wd / f"server_sorted_{i}.gfa"
            trace = wd / f"server_trace_{i}.jsonl"
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "gfasort_tpu_torch",
                 "-i", str(gfa_in), "-o", str(out), *job_argv,
                 "--trace-out", str(trace), "--server"],
                env=env, cwd=str(REPO), capture_output=True, text=True,
                timeout=timeout,
            )
            wall = time.perf_counter() - t0
            m = _SERVED.search(r.stderr)
            if r.returncode != 0 or m is None:
                raise RuntimeError(f"served run {i} failed (rc "
                                   f"{r.returncode}):\n{r.stderr[-4000:]}")
            runs.append({
                "run": i, "client_wall_s": wall,
                "served_wall_s": float(m.group(2)), "pid": int(m.group(1)),
                "step_walls_s": step_walls(trace), "output": str(out),
            })
    finally:
        stop_server(sock)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gfasort_tpu_torch.tools.e2e_server_warm")
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--paths", type=int, default=16)
    ap.add_argument("--steps", type=int, default=250_000)
    ap.add_argument("--iter-max", type=int, default=30)
    ap.add_argument("--pipeline", default="Y")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work-dir", default=default_work_dir())
    ap.add_argument("--artifact", default=None,
                    help="default: <work-dir>/E2E_SERVER_WARM.json")
    args = ap.parse_args(argv)

    from .make_synthetic_gfa import write_synthetic_gfa

    wd = pathlib.Path(args.work_dir)
    wd.mkdir(parents=True, exist_ok=True)
    gfa_in = wd / f"synthetic_{args.nodes}_{args.paths}_{args.steps}.gfa"
    if not gfa_in.exists():
        write_synthetic_gfa(
            str(gfa_in), n_nodes=args.nodes, n_paths=args.paths,
            steps_per_path=args.steps, seed=0,
        )
    print(f"[e2e-server] input: {gfa_in} "
          f"({gfa_in.stat().st_size >> 20} MiB)", file=sys.stderr,
          flush=True)

    job = ["-p", args.pipeline, "--engine", "sweep",
           "--iter-max", str(args.iter_max), "--device", args.device]
    runs = serve_twice(gfa_in, wd, job, str(wd / "gfasort_warm.sock"))
    for r in runs:
        print(f"[e2e-server] run {r['run']}: client {r['client_wall_s']}s, "
              f"served {r['served_wall_s']}s, steps {r['step_walls_s']}",
              file=sys.stderr, flush=True)
    one_process = runs[0]["pid"] == runs[1]["pid"]
    identical = (pathlib.Path(runs[0]["output"]).read_bytes()
                 == pathlib.Path(runs[1]["output"]).read_bytes())
    artifact = {
        "what": "the same CLI job twice through the port's --server",
        "device": device_name(args.device),
        "nodes": args.nodes,
        "paths": args.paths,
        "steps_per_path": args.steps,
        "iter_max": args.iter_max,
        "pipeline": args.pipeline,
        "runs": runs,
        "one_process": one_process,
        "outputs_identical": identical,
        "ok": one_process and identical,
    }
    out = pathlib.Path(args.artifact or wd / "E2E_SERVER_WARM.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=1))
    print(json.dumps(artifact, indent=1))
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
