"""The port's interactive sessions (``bluefog_tpu_torch/run/interactive.py``,
``bfrun-torch --interactive``) held against the JAX package's
(``tests/test_interactive.py``): the frame bytes equal JAX's,
``cell_complete`` and ``execute_cell`` agree with JAX's, the REPL's block
accumulation and reply formatting, a duplicate process id and an
unauthenticated worker refused, a slow cell dropping the worker and not
the session, the worker loop's exits, a dead remote spawn failing fast,
and a two-worker session whose workers form the port's world over gloo
from torchrun's variables and run a gossip step sent as a cell.
"""
import io
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from bluefog_tpu.run import interactive as jit
from bluefog_tpu_torch.run import interactive as it
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(mod, obj) -> bytes:
    a, b = socket.socketpair()
    try:
        mod.send_msg(a, obj)
        a.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return buf
            buf += chunk
    finally:
        a.close(), b.close()


@pytest.mark.parametrize("obj", [
    {"type": "hello", "process_id": 3, "token": "ab" * 16},
    {"type": "cell", "code": "x" * 10000},
    {"stdout": "hi\n", "value": "5", "error": None},
])
def test_frame_bytes_equal_jax(obj):
    got = _frame(it, obj)
    assert got == _frame(jit, obj)
    assert int.from_bytes(got[:4], "big") == len(got) - 4
    a, b = socket.socketpair()
    t = threading.Thread(target=it.send_msg, args=(a, obj))
    t.start()
    assert it.recv_msg(b) == obj
    t.join()
    a.close(), b.close()


@pytest.mark.parametrize("src", [
    "x = 1", "def f():", "def f():\n    return 1", "def f():\n    return 1\n",
    "1 +", "for i in range(3):\n    pass\n", "if x:\n", ""])
def test_cell_complete_matches_jax(src):
    assert it.cell_complete(src) == jit.cell_complete(src)


def test_execute_cell_matches_jax():
    ns_t, ns_j = {}, {}
    for code in ("print('hi'); 2 + 3", "x = 41\nx + 1", "1 / 0",
                 "y = [x, x]\ny", "import math\nmath.floor(2.5)"):
        rt = it.execute_cell(code, ns_t)
        rj = jit.execute_cell(code, ns_j)
        if rj["error"] is not None:
            assert rt["error"].splitlines()[-1] == \
                rj["error"].splitlines()[-1]
            rt, rj = dict(rt, error=None), dict(rj, error=None)
        assert rt == rj
    assert ns_t["x"] == 41


class _FakeController:
    def __init__(self):
        self.cells = []

    def run_cell(self, code, timeout=None):
        self.cells.append(code)
        return {0: {"stdout": "ok\n", "value": None, "error": None},
                1: {"stdout": "ok\n", "value": None, "error": None}}


def test_repl_accumulates_blocks_and_formats_replies():
    ctrl = _FakeController()
    out = io.StringIO()
    it.repl(ctrl, stdin=io.StringIO("def f():\n    return 7\n\nprint(f())\n"),
            stdout=out)
    assert ctrl.cells == ["def f():\n    return 7\n", "print(f())"]
    assert "ok" in out.getvalue()
    replies = {0: {"stdout": "same\n", "value": None, "error": None},
               1: {"stdout": "different\n", "value": None, "error": None},
               2: {"stdout": "", "value": None, "error": "Traceback: boom\n"}}
    a, b = io.StringIO(), io.StringIO()
    it._format_replies(replies, stream=a)
    jit._format_replies(replies, stream=b)
    assert a.getvalue() == b.getvalue()
    assert "[rank 1] different" in a.getvalue()


def test_duplicate_process_id_rejected():
    ctrl = it.Controller(2, port=0, host="127.0.0.1")
    socks = []

    def fake_worker():
        s = socket.create_connection(("127.0.0.1", ctrl.port))
        it.send_msg(s, {"type": "hello", "process_id": 0,
                        "token": ctrl.token})
        socks.append(s)

    threads = [threading.Thread(target=fake_worker) for _ in range(2)]
    for t in threads:
        t.start()
    with pytest.raises(RuntimeError, match="process_id 0"):
        ctrl.wait_for_workers(timeout=30)
    for t in threads:
        t.join()
    for s in socks:
        s.close()


def test_slow_cell_drops_worker_not_session():
    ctrl = it.Controller(1, port=0, host="127.0.0.1")

    def fake_worker():
        s = socket.create_connection(("127.0.0.1", ctrl.port))
        it.send_msg(s, {"type": "hello", "process_id": 0,
                        "token": ctrl.token})
        it.recv_msg(s)          # the cell — never reply
        try:
            it.recv_msg(s)
        except (OSError, ConnectionError):
            pass

    threading.Thread(target=fake_worker, daemon=True).start()
    assert ctrl.wait_for_workers(timeout=30) == [0]
    replies = ctrl.run_cell("spin()", timeout=0.5)
    assert "dropped" in replies[0]["error"]
    assert ctrl._workers == {}
    ctrl.shutdown()


def test_unauthenticated_worker_rejected():
    ctrl = it.Controller(1, port=0, host="127.0.0.1")
    assert ctrl.token and len(ctrl.token) >= 32
    results = {}

    def bad_worker(name, hello):
        s = socket.create_connection(("127.0.0.1", ctrl.port))
        it.send_msg(s, hello)
        try:
            results[name] = it.recv_msg(s)
            it.recv_msg(s)
            results[name + "_closed"] = False
        except (ConnectionError, OSError):
            results[name + "_closed"] = True
        finally:
            s.close()

    def good_worker():
        s = socket.create_connection(("127.0.0.1", ctrl.port))
        it.send_msg(s, {"type": "hello", "process_id": 0,
                        "token": ctrl.token})
        results["good"] = True
        try:
            it.recv_msg(s)
        except (ConnectionError, OSError):
            pass
        s.close()

    accepted = []
    waiter = threading.Thread(
        target=lambda: accepted.extend(ctrl.wait_for_workers(timeout=60)))
    waiter.start()
    bad = [threading.Thread(target=bad_worker, args=(
               "wrong", {"type": "hello", "process_id": 0, "token": "nope"})),
           threading.Thread(target=bad_worker, args=(
               "missing", {"type": "hello", "process_id": 0}))]
    for t in bad:
        t.start()
    for t in bad:
        t.join(timeout=60)
    good = threading.Thread(target=good_worker, daemon=True)
    good.start()
    waiter.join(timeout=60)
    assert accepted == [0]
    ctrl.shutdown()
    good.join(timeout=30)
    assert results["wrong"]["type"] == results["missing"]["type"] == \
        "auth-failed"
    assert results["wrong_closed"] and results["missing_closed"]


def test_worker_loop_exits(capsys):
    srv, cli = socket.socketpair()
    it.send_msg(srv, {"type": "auth-failed", "error": "bad token"})
    assert it.worker_loop(cli, {}) == 1
    assert "rejected" in capsys.readouterr().err
    srv.close(), cli.close()
    srv, cli = socket.socketpair()
    it.send_msg(srv, {"type": "cell", "code": "1 + 1"})
    it.send_msg(srv, {"type": "shutdown"})
    assert it.worker_loop(cli, {}) == 0
    assert it.recv_msg(srv)["value"] == "2"
    srv.close(), cli.close()


def test_remote_interactive_dead_spawn_fails_fast(tmp_path):
    stub = tmp_path / "fake_ssh"
    stub.write_text("#!/bin/sh\nexit 7\n")
    stub.chmod(0o755)
    env = dict(os.environ)
    env.pop("BLUEFOG_SESSION_TOKEN", None)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.launcher",
         "--interactive", "-H", "deadhost", "--remote-shell", str(stub)],
        input="", env=env, cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert r.returncode != 0
    assert "exited with code 7" in r.stderr, r.stderr[-1500:]
    assert "failed to connect" in r.stderr, r.stderr[-1500:]
    assert time.perf_counter() - t0 < 60


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_worker_session_forms_the_world_over_gloo(tmp_path):
    """Two worker processes join one gloo process group from torchrun's
    variables (a rank each) and run a gossip step sent as cells."""
    ctrl = it.Controller(2, port=0, host="127.0.0.1")
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, BLUEFOG_SESSION_TOKEN=ctrl.token,
                   BLUEFOG_DEVICE="cpu", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(pid),
                   LOCAL_RANK=str(pid), OMP_NUM_THREADS="1")
        log = open(tmp_path / f"worker{pid}.log", "w+")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "bluefog_tpu_torch.run.interactive",
             "--connect", f"127.0.0.1:{ctrl.port}"],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        assert ctrl.wait_for_workers(timeout=120.0) == [0, 1]
        r = ctrl.run_cell("print(bf.size(), bf.get_context().world, "
                          "bf.get_context().device)", timeout=120.0)
        assert r[0]["error"] is None and r[1]["error"] is None, r
        assert r[0]["stdout"] == r[1]["stdout"] == "2 2 cpu\n"
        r = ctrl.run_cell(
            "me = bf.get_context().process\n"
            "x = torch.full((1, 2), float(me + 1))\n"
            "out = bf.neighbor_allreduce(x)\n"
            "print(out.tolist())", timeout=120.0)
        assert r[0]["error"] is None and r[1]["error"] is None, r
        # Exp2 over 2 ranks: each averages itself with the other
        assert r[0]["stdout"] == r[1]["stdout"] == "[[1.5, 1.5]]\n"
    finally:
        ctrl.shutdown()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
    assert all(p.returncode == 0 for p in procs), [
        (tmp_path / f"worker{i}.log").read_text()[-2000:]
        for i in range(2)]
