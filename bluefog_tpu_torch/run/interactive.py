"""Multi-host interactive sessions: the port's ``ibfrun`` (its own copy
of ``bluefog_tpu/run/interactive.py``).

The reference's interactive mode (``run/interactive_run.py:34-96``) stands
up an ipyparallel cluster — an ``ipcontroller`` plus one mpirun'd
``ipengine`` per rank — so a notebook can push code cells to every MPI
process.  Here the same capability is two pieces:

* every host runs one **worker** process that forms the port's world
  from torchrun's variables (``bluefog_tpu_torch.init``: one process
  group, exactly as a batch job would), then waits for code cells on a
  TCP socket;
* a **controller** (the user's terminal or notebook) broadcasts each cell
  to all workers, which execute it simultaneously, and returns per-rank
  stdout/value/error.

Wire format: 4-byte big-endian length + JSON, with no third-party
dependency.

Authentication: executing arbitrary cells over TCP is remote code
execution by design, so the controller mints a per-session token that
every worker must echo in its hello.  The launcher forwards it to spawned
workers via ``BLUEFOG_SESSION_TOKEN``; remote workers take ``--token``.
Comparison is constant time; a bad token gets an explicit
``auth-failed`` reply then a closed socket, and never counts toward the
expected worker set.

Usage (mirrors ``ibfrun start``/``ibfrun stop``):

    # on each host:
    bfrun-torch --interactive-worker --controller host0:47000 \
        --coordinator host0:29500 --num-processes 4 --process-id R

    # on the driving host:
    bfrun-torch --interactive --num-processes 4 --listen-port 47000

    # local emulation (one machine, N processes — like `ibfrun -np 4`):
    bfrun-torch --interactive -np 4
"""
from __future__ import annotations

import codeop
import contextlib
import hmac
import io
import json
import secrets
import socket
import struct
import sys
import threading
import traceback
from typing import Any, Dict, List, Optional, Tuple

_HDR = struct.Struct(">I")
MAX_MSG = 64 << 20


def send_msg(sock: socket.socket, obj: Any) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(_HDR.pack(len(data)) + data)


def recv_msg(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, _HDR.size)
    (length,) = _HDR.unpack(hdr)
    if length > MAX_MSG:
        raise ValueError(f"message too large: {length}")
    return json.loads(_recv_exact(sock, length).decode())


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def cell_complete(source: str) -> bool:
    """True when ``source`` is a complete cell (the REPL's continue-prompt
    predicate).  ``exec`` mode compiles an open indented block as complete,
    so the interactive blank-line convention is applied explicitly: a cell
    whose last line is indented stays open until a blank line closes it
    (then the joined source carries a trailing newline).  Invalid code
    counts as complete so the error surfaces on execution rather than
    trapping the prompt."""
    try:
        if codeop.compile_command(source, "<cell>", "exec") is None:
            return False
    except (SyntaxError, ValueError, OverflowError):
        return True
    lines = source.rstrip("\n").splitlines()
    last = lines[-1] if lines else ""
    if last.startswith((" ", "\t")) and not source.endswith("\n"):
        return False
    return True


def execute_cell(code: str, namespace: Dict[str, Any]) -> Dict[str, Any]:
    """Run one cell in ``namespace``; capture stdout, last-expression value
    (notebook semantics via ``single`` mode on the trailing statement), and
    any traceback."""
    out = io.StringIO()
    result: Dict[str, Any] = {"stdout": "", "value": None, "error": None}
    try:
        import ast

        tree = ast.parse(code, "<cell>", "exec")
        last_value: List[Any] = [None]
        with contextlib.redirect_stdout(out):
            if tree.body and isinstance(tree.body[-1], ast.Expr):
                body, last = tree.body[:-1], tree.body[-1]
                if body:
                    exec(compile(ast.Module(body, []), "<cell>", "exec"),
                         namespace)
                last_value[0] = eval(
                    compile(ast.Expression(last.value), "<cell>", "eval"),
                    namespace)
            else:
                exec(compile(tree, "<cell>", "exec"), namespace)
        if last_value[0] is not None:
            result["value"] = repr(last_value[0])
    except BaseException:
        result["error"] = traceback.format_exc()
    result["stdout"] = out.getvalue()
    return result


class Controller:
    """Accepts worker connections and broadcasts cells to all of them.

    Counterpart of the ipcontroller + ``client[:]`` DirectView: ``run_cell``
    is ``view.execute`` with a gather of per-rank results."""

    def __init__(self, num_workers: int, port: int = 0,
                 host: str = "0.0.0.0", token: Optional[str] = None):
        self.num_workers = num_workers
        # empty means unset: an empty token would match a token-less hello,
        # silently disabling auth on a 0.0.0.0 listener
        self.token = token or secrets.token_hex(16)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(num_workers)
        self.port = self._srv.getsockname()[1]
        self._workers: Dict[int, socket.socket] = {}
        self._lock = threading.Lock()
        self._aborted: Optional[str] = None

    def abort(self, reason: str) -> None:
        """Make a blocked :meth:`wait_for_workers` raise ``reason`` now.

        Closing the listener does NOT wake a thread blocked in accept();
        instead the flag is set and a wake-up connection is dialed to our
        own port (a launcher monitor calls this when a spawned worker
        dies before connecting)."""
        self._aborted = reason
        with contextlib.suppress(OSError):
            socket.create_connection(("127.0.0.1", self.port),
                                     timeout=5).close()

    def wait_for_workers(self, timeout: float = 300.0) -> List[int]:
        """Block until all workers have connected + handshaken; returns the
        sorted process ids."""
        self._srv.settimeout(timeout)
        while len(self._workers) < self.num_workers:
            if self._aborted:
                raise RuntimeError(self._aborted)
            conn, _ = self._srv.accept()
            if self._aborted:
                conn.close()
                raise RuntimeError(self._aborted)
            # accepted sockets do NOT inherit the listener timeout; a
            # connected-but-silent peer must not block startup forever
            conn.settimeout(timeout)
            # the socket is unauthenticated (0.0.0.0 in remote mode): any
            # malformed frame — wrong JSON shape as much as a bad length —
            # rejects that connection, never crashes the controller
            try:
                hello = recv_msg(conn)
                if hello.get("type") != "hello":
                    raise ValueError("not a hello")
                # compare bytes: compare_digest raises TypeError on
                # non-ASCII str, which the catch-all below would turn into
                # a silent close instead of a loud auth-failed
                presented = str(hello.get("token", "")).encode(
                    "utf-8", "surrogatepass")
                if not hmac.compare_digest(presented, self.token.encode()):
                    # loud rejection so a mis-tokened worker fails fast
                    # instead of hanging; the bad peer never joins the set
                    with contextlib.suppress(OSError):
                        send_msg(conn, {"type": "auth-failed",
                                        "error": "bad or missing session "
                                                 "token"})
                    raise ValueError("bad session token")
                pid = int(hello["process_id"])
            except (OSError, ValueError, AttributeError, KeyError, TypeError):
                conn.close()
                continue
            with self._lock:
                duplicate = pid in self._workers
                if not duplicate:
                    conn.settimeout(None)
                    self._workers[pid] = conn
            if duplicate:
                conn.close()
                self.shutdown()
                raise RuntimeError(
                    f"two workers reported process_id {pid} — each host "
                    "must join the process group with a distinct "
                    "--process-id (or RANK)")
        return sorted(self._workers)

    def run_cell(self, code: str,
                 timeout: Optional[float] = None) -> Dict[int, Dict]:
        """Broadcast one cell; gather ``{rank: {stdout, value, error}}``.

        The broadcast completes to every worker before any reply is read —
        cells containing collectives deadlock otherwise (process 0 inside
        an all-reduce while process 1 never received the cell)."""
        with self._lock:
            workers = dict(self._workers)
        replies: Dict[int, Dict] = {}

        def _drop(pid, sock, exc, when):
            # a failed send or a timeout mid-recv leaves the stream
            # unsynchronizable — drop the worker rather than corrupt every
            # later cell (or kill the whole session)
            with self._lock:
                self._workers.pop(pid, None)
            sock.close()
            replies[pid] = {
                "stdout": "", "value": None,
                "error": f"worker {pid} dropped ({when}): {exc!r} — other "
                         "ranks may have executed the cell; restart the "
                         "worker\n"}

        for pid, sock in workers.items():
            try:
                send_msg(sock, {"type": "cell", "code": code})
            except OSError as exc:
                _drop(pid, sock, exc, "send")
        for pid, sock in workers.items():
            if pid in replies:
                continue
            sock.settimeout(timeout)
            try:
                replies[pid] = recv_msg(sock)
                sock.settimeout(None)
            except (OSError, ValueError) as exc:
                _drop(pid, sock, exc, "recv")
        return replies

    def shutdown(self) -> None:
        with self._lock:
            for sock in self._workers.values():
                try:
                    send_msg(sock, {"type": "shutdown"})
                    sock.close()
                except OSError:
                    pass
            self._workers.clear()
        self._srv.close()


def worker_main(controller_addr: str,
                token: Optional[str] = None) -> int:
    """Run one interactive worker: ``bf.init()`` (joining the process
    group torchrun's variables describe), connect to the controller, then
    execute cells until shutdown.  The namespace is pre-seeded like the
    single-host REPL's.  The world forms on CUDA; ``BLUEFOG_DEVICE=cpu``
    forms it on the CPU, as the tests do."""
    import os

    import torch

    import bluefog_tpu_torch as bf

    token = token if token is not None else os.environ.get(
        "BLUEFOG_SESSION_TOKEN", "")
    bf.init(device=os.environ.get("BLUEFOG_DEVICE") or None)
    namespace: Dict[str, Any] = {
        "bf": bf, "torch": torch, "__name__": "__main__"}
    host, port = parse_addr(controller_addr)
    sock = socket.create_connection((host, port), timeout=300.0)
    sock.settimeout(None)
    send_msg(sock, {"type": "hello",
                    "process_id": bf.get_context().process,
                    "token": token})
    return worker_loop(sock, namespace)


def worker_loop(sock: socket.socket, namespace: Dict[str, Any]) -> int:
    """Post-hello worker state machine: execute cells until shutdown; an
    auth-failed reply is a loud non-zero exit (mis-tokened launches fail
    fast instead of hanging)."""
    while True:
        try:
            msg = recv_msg(sock)
        except (ConnectionError, OSError):
            return 0
        if msg.get("type") == "auth-failed":
            print(f"controller rejected this worker: {msg.get('error')} "
                  "(pass the session token printed by the controller via "
                  "--token or BLUEFOG_SESSION_TOKEN)", file=sys.stderr)
            return 1
        if msg.get("type") == "shutdown":
            return 0
        if msg.get("type") == "cell":
            send_msg(sock, execute_cell(msg["code"], namespace))


def parse_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def _format_replies(replies: Dict[int, Dict], stream=sys.stdout) -> None:
    """Rank-0 output inline (the common case: all ranks agree); other
    ranks shown only where they diverge or error."""
    r0 = replies.get(0, {})
    if r0.get("stdout"):
        stream.write(r0["stdout"])
    if r0.get("value") is not None:
        stream.write(r0["value"] + "\n")
    for pid in sorted(replies):
        rep = replies[pid]
        if rep.get("error"):
            stream.write(f"[rank {pid}] {rep['error']}")
        elif pid != 0 and (rep.get("stdout"), rep.get("value")) != (
                r0.get("stdout"), r0.get("value")):
            body = (rep.get("stdout") or "") + (
                (rep["value"] + "\n") if rep.get("value") is not None else "")
            for line in body.splitlines():
                stream.write(f"[rank {pid}] {line}\n")


def repl(controller: Controller, *, stdin=None, stdout=None) -> None:
    """Line REPL over the controller: accumulate until a complete cell,
    broadcast, print gathered output."""
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    buf: List[str] = []
    interactive = stdin.isatty() if hasattr(stdin, "isatty") else False
    while True:
        if interactive:
            stdout.write("... " if buf else ">>> ")
            stdout.flush()
        line = stdin.readline()
        if not line:
            break
        buf.append(line.rstrip("\n"))
        src = "\n".join(buf)
        if not src.strip():
            buf = []
            continue
        # a blank line always closes an open block (REPL convention)
        if not cell_complete(src) and line.strip():
            continue
        buf = []
        try:
            _format_replies(controller.run_cell(src), stream=stdout)
        except (ConnectionError, OSError) as exc:
            stdout.write(f"controller: lost worker ({exc}); exiting\n")
            break


def main(argv: Optional[List[str]] = None) -> int:
    """CLI for the worker side: ``python -m
    bluefog_tpu_torch.run.interactive --connect host:port`` (what
    ``bfrun-torch --interactive-worker`` execs)."""
    import argparse

    p = argparse.ArgumentParser(prog="bluefog-torch-interactive-worker")
    p.add_argument("--connect", required=True,
                   help="controller address host:port")
    p.add_argument("--token", default=None,
                   help="session token printed by the controller; argv is "
                        "visible in `ps` on shared hosts — prefer the "
                        "BLUEFOG_SESSION_TOKEN env var there (default)")
    args = p.parse_args(argv)
    return worker_main(args.connect, token=args.token)


if __name__ == "__main__":
    sys.exit(main())
