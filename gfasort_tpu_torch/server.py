"""Warm-process server: one live process runs many CLI jobs.

Counterpart of ``gfasort_tpu/server.py``: the same protocol and the
same lifecycle.  Each cold ``python -m gfasort_tpu_torch`` pays the
torch import, the CUDA context, the load of the kernel library and the
host set-up of every engine again.  This module keeps ONE live process
and routes CLI jobs to it over a unix-domain socket; inside it, the
1D and nD sweep engines memoize their built runners (plan, sampler
constants, consensus tables, static tensors on the device;
:mod:`.ops.runner_cache`), so a job on a workload seen before skips
that set-up.

Protocol: length-prefixed JSON.  Request ``{"op": "run", "argv":
[...], "cwd": "..."}`` executes :func:`gfasort_tpu_torch.cli.main` in
the server process (stdout/stderr captured and returned); ``{"op":
"ping"}`` health-checks; ``{"op": "shutdown"}`` stops the server.
Jobs are SERIALIZED — one device, one job at a time; concurrent
clients queue on connect.  A job runs with the daemon's environment and
the client's ``argv`` and ``cwd``: flags such as ``--device`` and
``--engine`` travel in ``argv``, ``GFASORT_*`` knobs do not.

Lifecycle:

* ``python -m gfasort_tpu_torch ... --server`` spawns the daemon on
  first use (keyed by the socket path, default
  ``$TMPDIR/gfasort-torch-<uid>.sock``; override with
  ``GFASORT_SERVER_SOCKET``) and reuses it on later invocations.  The
  name differs from the JAX package's ``gfasort-<uid>.sock`` so that a
  client of one package is never answered by a daemon of the other.
* ``python -m gfasort_tpu_torch.server stop`` shuts it down;
  ``... status`` pings it.
* The daemon exits after ``GFASORT_SERVER_IDLE_S`` (default 7200)
  seconds without a job, and replaces a stale socket on startup.
* The daemon is a new process (``subprocess.Popen``), never a fork of
  the client: a forked CUDA context is unusable.
* Invalidation: the server holds code loaded at spawn time — after
  upgrading the package, ``stop`` it (the next ``--server`` run
  respawns with fresh code).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import time
import traceback

__all__ = ["socket_path", "serve", "request", "ensure_server",
           "run_via_server", "main"]

_HDR = struct.Struct("!Q")


def socket_path() -> str:
    return os.environ.get(
        "GFASORT_SERVER_SOCKET",
        os.path.join(tempfile.gettempdir(), f"gfasort-torch-{os.getuid()}.sock"),
    )


def _send(conn: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    conn.sendall(_HDR.pack(len(data)) + data)


def _recv(conn: socket.socket) -> dict:
    hdr = b""
    while len(hdr) < _HDR.size:
        chunk = conn.recv(_HDR.size - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed during header")
        hdr += chunk
    (n,) = _HDR.unpack(hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed during body")
        buf += chunk
    return json.loads(bytes(buf))


def _run_job(req: dict) -> dict:
    """Execute one CLI job in-process, capturing output."""
    from . import cli

    out, err = io.StringIO(), io.StringIO()
    cwd0 = os.getcwd()
    t0 = time.perf_counter()
    try:
        if req.get("cwd"):
            os.chdir(req["cwd"])
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(req.get("argv") or [])
    except SystemExit as e:  # argparse errors
        rc = int(e.code or 0)
    except Exception as e:  # noqa: BLE001 — report, keep serving
        err.write(f"[gfasort-server] job failed: {type(e).__name__}: {e}\n"
                  f"{traceback.format_exc()}")
        rc = 1
    finally:
        os.chdir(cwd0)
    return {
        "rc": rc,
        "stdout": out.getvalue(),
        "stderr": err.getvalue(),
        "wall_s": round(time.perf_counter() - t0, 3),
        "pid": os.getpid(),
    }


def serve(path: str | None = None) -> None:
    """Run the daemon loop (blocking) on the given socket path."""
    path = path or socket_path()
    idle_s = float(os.environ.get("GFASORT_SERVER_IDLE_S", 7200))
    # replace a stale socket: if a live server answers a ping, bail out
    if os.path.exists(path):
        try:
            r = request(path, {"op": "ping"}, timeout=2.0)
            if r.get("ok"):
                print(f"[gfasort-server] already running (pid {r['pid']})",
                      file=sys.stderr)
                return
        except OSError:
            pass
        os.unlink(path)
    os.environ["GFASORT_IN_SERVER"] = "1"  # jobs must not re-route
    # memoize built engine runners across jobs (the point of the warm
    # process): same-workload jobs skip the engines' host set-up
    os.environ.setdefault("GFASORT_RUNNER_CACHE", "1")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(8)
    srv.settimeout(30.0)
    print(f"[gfasort-server] pid {os.getpid()} listening on {path}",
          file=sys.stderr, flush=True)
    last_job = time.monotonic()
    try:
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                if time.monotonic() - last_job > idle_s:
                    print("[gfasort-server] idle timeout, exiting",
                          file=sys.stderr)
                    return
                continue
            with conn:
                try:
                    req = _recv(conn)
                except (ConnectionError, json.JSONDecodeError):
                    continue
                op = req.get("op")
                if op == "ping":
                    _send(conn, {"ok": True, "pid": os.getpid()})
                elif op == "shutdown":
                    _send(conn, {"ok": True, "pid": os.getpid()})
                    print("[gfasort-server] shutdown requested",
                          file=sys.stderr)
                    return
                elif op == "run":
                    last_job = time.monotonic()
                    _send(conn, _run_job(req))
                    last_job = time.monotonic()
                else:
                    _send(conn, {"ok": False, "error": f"bad op {op!r}"})
    finally:
        srv.close()
        with contextlib.suppress(OSError):
            os.unlink(path)


def request(path: str, obj: dict, timeout: float | None = None) -> dict:
    """Send one request to a running server and return its response.
    ``timeout`` bounds CONNECT + header exchange; job execution itself
    is unbounded (a genome-scale pipeline legitimately runs minutes)."""
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(timeout)
    try:
        conn.connect(path)
        _send(conn, obj)
        conn.settimeout(None)  # job may run for minutes
        return _recv(conn)
    finally:
        conn.close()


def ensure_server(path: str | None = None, spawn: bool = True,
                  wait_s: float = 60.0) -> str:
    """Return the socket path of a live server, spawning one if needed."""
    path = path or socket_path()
    try:
        if request(path, {"op": "ping"}, timeout=2.0).get("ok"):
            return path
    except OSError:
        pass
    if not spawn:
        raise ConnectionError(f"no gfasort server on {path}")
    with contextlib.suppress(OSError):
        os.unlink(path)
    log_path = path + ".log"
    with open(log_path, "ab") as logf:
        subprocess.Popen(
            [sys.executable, "-m", "gfasort_tpu_torch.server", "--socket",
             path, "serve"],
            stdout=logf, stderr=logf,
            start_new_session=True,  # survives the client's exit
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            if request(path, {"op": "ping"}, timeout=2.0).get("ok"):
                return path
        except OSError:
            time.sleep(0.2)
    raise TimeoutError(
        f"gfasort server did not come up on {path} in {wait_s}s "
        f"(see {log_path})"
    )


def run_via_server(argv: list, path: str | None = None) -> int:
    """Route one CLI invocation to the warm server (spawning it if
    needed), relaying captured output.  Paths inside ``argv`` stay
    valid because the job runs with the CLIENT's cwd."""
    path = ensure_server(path)
    resp = request(path, {"op": "run", "argv": list(argv),
                          "cwd": os.getcwd()})
    sys.stdout.write(resp.get("stdout", ""))
    sys.stderr.write(resp.get("stderr", ""))
    sys.stderr.write(
        f"[gfasort] served by warm process {resp.get('pid')} in "
        f"{resp.get('wall_s')}s\n"
    )
    return int(resp.get("rc", 1))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="gfasort-server",
        description="Warm-process server for the gfasort CLI (PyTorch/CUDA)",
    )
    p.add_argument("command", choices=["serve", "status", "stop"],
                   nargs="?", default="serve")
    p.add_argument("--socket", default=None, help="unix socket path")
    args = p.parse_args(argv)
    path = args.socket or socket_path()
    if args.command == "serve":
        serve(path)
        return 0
    try:
        if args.command == "status":
            r = request(path, {"op": "ping"}, timeout=2.0)
            print(json.dumps(r))
            return 0 if r.get("ok") else 1
        r = request(path, {"op": "shutdown"}, timeout=5.0)
        print(json.dumps(r))
        return 0
    except OSError as e:
        print(f"no server on {path}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
