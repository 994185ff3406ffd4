"""The port's warm-process server (``gfasort_tpu_torch/server.py``) and
``--server`` in its CLI, on the CPU.

The daemon runs in a subprocess on a short socket path (a unix socket
path stops at 107 bytes), the jobs on a synthetic GFA.  Every
subprocess and request has a timeout, and every daemon is stopped, or
killed, in teardown.
"""

import contextlib
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import pytest

torch = pytest.importorskip("torch")

from gfasort_tpu import server as jax_server  # noqa: E402
from gfasort_tpu_torch import cli, server  # noqa: E402
from gfasort_tpu_torch.tools import e2e_server_warm  # noqa: E402
from gfasort_tpu_torch.tools.make_synthetic_gfa import synthetic_gfa_lines  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
JOB = ["-p", "sYgs", "--engine", "sweep", "--iter-max", "4", "--device", "cpu"]
SERVED = re.compile(r"served by warm process (\d+) in")


def _wait_up(sock, timeout=60.0) -> int:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return server.request(sock, {"op": "ping"}, timeout=2.0)["pid"]
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"no server on {sock}")


def _alive(pid: int) -> bool:
    with contextlib.suppress(ChildProcessError):   # reap our own child
        os.waitpid(pid, os.WNOHANG)
    return e2e_server_warm.running(pid)


def _kill(pid: int) -> None:
    with contextlib.suppress(ProcessLookupError):
        os.kill(pid, signal.SIGKILL)


@pytest.fixture
def short_dir():
    d = tempfile.mkdtemp(prefix="gfs", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _spawn(sock):
    with open(sock + ".log", "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "gfasort_tpu_torch.server", "--socket",
             sock, "serve"], cwd=REPO, stdout=log, stderr=log)


def _stop(proc, sock):
    with contextlib.suppress(OSError):
        server.request(sock, {"op": "shutdown"}, timeout=5.0)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


@pytest.fixture
def daemon(short_dir):
    sock = os.path.join(short_dir, "s.sock")
    proc = _spawn(sock)
    try:
        assert _wait_up(sock) == proc.pid
        yield sock, proc
    finally:
        _stop(proc, sock)


@pytest.fixture(scope="module")
def gfa_in(tmp_path_factory):
    p = tmp_path_factory.mktemp("gfa") / "in.gfa"
    p.write_text("\n".join(synthetic_gfa_lines(1500, 3, 1500, seed=4)) + "\n")
    return p


def _client(argv, sock, cwd):
    env = dict(os.environ, GFASORT_SERVER_SOCKET=sock, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", "gfasort_tpu_torch", *argv],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=180)


def test_two_served_jobs_run_in_one_process_and_equal_in_process(
        daemon, gfa_in, tmp_path, monkeypatch):
    """Two clients' ``--server`` jobs (relative paths: the job takes the
    client's cwd) run in the daemon's pid; the outputs are byte-identical
    to each other and to ``cli.main`` run in-process."""
    sock, proc = daemon
    pids, outs = [], []
    for i in (1, 2):
        r = _client(["-i", str(gfa_in), "-o", f"out{i}.gfa", *JOB,
                     "--server"], sock, tmp_path)
        assert r.returncode == 0, r.stderr
        pids.append(int(SERVED.search(r.stderr).group(1)))
        outs.append((tmp_path / f"out{i}.gfa").read_bytes())
    assert pids == [proc.pid, proc.pid]
    monkeypatch.delenv("GFASORT_RUNNER_CACHE", raising=False)
    assert cli.main(["-i", str(gfa_in), "-o", str(tmp_path / "ref.gfa"),
                     *JOB, "-v", "0"]) == 0
    ref = (tmp_path / "ref.gfa").read_bytes()
    assert outs[0] == outs[1] == ref


def test_cli_server_flag_routes_to_the_daemon(daemon, gfa_in, tmp_path,
                                              monkeypatch, capsys):
    sock, proc = daemon
    monkeypatch.setenv("GFASORT_SERVER_SOCKET", sock)
    monkeypatch.delenv("GFASORT_IN_SERVER", raising=False)
    out = tmp_path / "routed.gfa"
    assert cli.main(["-i", str(gfa_in), "-o", str(out), *JOB, "--server"]) == 0
    assert f"served by warm process {proc.pid} " in capsys.readouterr().err
    assert out.read_text().startswith("H\t")
    # a failing job reports its error and leaves the daemon serving
    assert cli.main(["-i", str(tmp_path / "missing.gfa"), "-o", str(out),
                     *JOB, "--server"]) == 1
    assert "Error reading file" in capsys.readouterr().err
    assert _wait_up(sock) == proc.pid


def test_status_and_stop(daemon):
    sock, proc = daemon

    def cmd(c):
        return subprocess.run(
            [sys.executable, "-m", "gfasort_tpu_torch.server", "--socket",
             sock, c], cwd=REPO, capture_output=True, text=True, timeout=60)

    r = cmd("status")
    assert r.returncode == 0 and json.loads(r.stdout) == {"ok": True,
                                                          "pid": proc.pid}
    r = cmd("stop")
    assert r.returncode == 0 and json.loads(r.stdout)["pid"] == proc.pid
    assert proc.wait(timeout=30) == 0
    assert not os.path.exists(sock)
    r = cmd("status")
    assert r.returncode == 1 and "no server on" in r.stderr


def test_stale_socket_is_replaced_and_a_live_one_kept(short_dir):
    import socket as socket_mod

    sock = os.path.join(short_dir, "s.sock")
    stale = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    stale.bind(sock)
    stale.close()                      # the file stays, nobody listens
    assert os.path.exists(sock)
    proc = _spawn(sock)
    try:
        assert _wait_up(sock) == proc.pid
        second = subprocess.run(
            [sys.executable, "-m", "gfasort_tpu_torch.server", "--socket",
             sock, "serve"], cwd=REPO, capture_output=True, text=True,
            timeout=60)
        assert second.returncode == 0
        assert f"already running (pid {proc.pid})" in second.stderr
        assert _wait_up(sock) == proc.pid
    finally:
        _stop(proc, sock)


def test_ensure_server_spawns_a_detached_daemon(short_dir):
    sock = os.path.join(short_dir, "s.sock")
    with pytest.raises(ConnectionError):
        server.ensure_server(sock, spawn=False)
    pid = None
    try:
        assert server.ensure_server(sock, wait_s=60.0) == sock
        pid = _wait_up(sock)
        assert pid != os.getpid() and os.getsid(pid) == pid
        assert server.ensure_server(sock) == sock     # reused
        assert _wait_up(sock) == pid
        assert server.main(["--socket", sock, "stop"]) == 0
        deadline = time.monotonic() + 30
        while _alive(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not _alive(pid)
    finally:
        if pid is not None:
            _kill(pid)


def test_client_imports_no_torch_and_socket_differs_from_jax(monkeypatch):
    """The client side (package, CLI routing, server client) imports no
    torch, and the default socket is not the JAX package's."""
    script = (
        "import sys\n"
        "import gfasort_tpu_torch, gfasort_tpu_torch.cli, "
        "gfasort_tpu_torch.server\n"
        "from gfasort_tpu_torch import BidirectedGraph, PathIndex, YgsParams\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'gfasort_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    monkeypatch.delenv("GFASORT_SERVER_SOCKET", raising=False)
    ours, theirs = server.socket_path(), jax_server.socket_path()
    assert ours != theirs
    assert os.path.dirname(ours) == os.path.dirname(theirs)
    assert os.path.basename(ours) == f"gfasort-torch-{os.getuid()}.sock"
    monkeypatch.setenv("GFASORT_SERVER_SOCKET", "/tmp/x.sock")
    assert server.socket_path() == jax_server.socket_path() == "/tmp/x.sock"


def test_e2e_server_warm_twin(short_dir):
    """The twin of ``scripts/e2e_server_warm.py`` at a tiny size on the
    CPU: both jobs in one daemon, byte-identical outputs, daemon stopped."""
    assert e2e_server_warm.main(
        ["--nodes", "2000", "--paths", "3", "--steps", "1500",
         "--iter-max", "4", "--device", "cpu", "--work-dir", short_dir]) == 0
    art = json.loads(pathlib.Path(short_dir, "E2E_SERVER_WARM.json").read_text())
    assert art["one_process"] and art["outputs_identical"] and art["ok"]
    assert [r["run"] for r in art["runs"]] == [1, 2]
    assert all(r["step_walls_s"]["SGD"] > 0 for r in art["runs"])
    pid = art["runs"][0]["pid"]
    deadline = time.monotonic() + 30
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _alive(pid)
