"""bfrun-torch: the multi-process launcher over torch.distributed (the
port of ``bluefog_tpu/run/launcher.py``, ``bfrun-tpu``).

Counterpart of the reference's ``bfrun`` (``run/run.py``).  Each child is
started with torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), which
``bluefog_tpu_torch.init`` reads to join the process group (NCCL on a
card, gloo on the CPU):

    bfrun-torch -np 4 python train.py            # 4 local processes
    bfrun-torch -H host1,host2:2 python train.py # SSH fan-out: all ranks
    bfrun-torch --coordinator host0:1234 --num-processes 16 --process-id 3 \
        python train.py                          # explicit multi-host start

The ``-H`` fan-out (reference: ``bfrun -H`` + mpirun's remote spawn,
``run.py:133-198``) SSHes to each host and starts its ranks with
torchrun's variables — the master on the first host, dense ranks in host
order, ``LOCAL_RANK`` the slot on its host — and ``BLUEFOG_*`` /
``TORCH_*`` / ``NCCL_*`` / ``CUDA_*`` forwarded.  ``--coordinator`` /
``--num-processes`` / ``--process-id`` map onto ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.

Env forwarding matches bfrun's ``-x``/env behavior: the child inherits the
environment plus ``-x NAME=VALUE`` extras.

The supervisor (``_supervise_procs``) restarts dead ranks
(``--restart-limit``, ``BLUEFOG_RESTART_COUNT``), grows and shrinks the
job from the scale file (``--elastic`` / ``--scale``, joins with
``BLUEFOG_JOIN_COUNT``) and replays spot-preemption traces
(``--preempt-trace``: SIGTERM, the grace window, SIGKILL, then a re-grant
respawn).  A join re-forms the process group: the supervisor publishes
the new process count and its ``MASTER_PORT`` in ``$BLUEFOG_PORT_FILE``
(emptied when the supervisor starts) before it starts the joiners, and
the survivors' ``parallel.context.reinit`` dials it.  A shrink re-forms
no group across processes: no port is published for it.

Interactive mode (reference: ``ibfrun``): ``--interactive`` alone opens a
single-process REPL; ``--interactive -np N`` drives N spawned workers from
a local REPL; ``--interactive -H host1,host2`` SSH-starts the workers
itself (the session token travels over each ssh stdin, never argv); or
run ``--interactive-worker`` on each host with ``--interactive
--num-processes N`` on the driving host (see ``interactive.py``).

The JAX launcher's XLA parts have no counterpart: ``--no-xla-tuning`` and
the TPU overlap flags it adds, and the persistent compilation cache (the
port compiles no programs; its kernels are built once a process,
``ops/_build.py``).
"""
from __future__ import annotations

import argparse
import os
import shlex
import socket
import subprocess
import sys
from typing import List, Optional

__all__ = ["build_parser", "main", "parse_hosts", "parse_hostfile",
           "build_multihost_plan", "check_environment", "_write_scale",
           "_read_scale", "_load_preempt_trace", "_supervise_procs",
           "PREEMPT_TRACE_SCHEMA"]

PROG = "bfrun-torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Launch a bluefog_tpu_torch training script (single or "
                    "multi host).")
    p.add_argument("-np", "--num-local-processes", type=int, default=None,
                   help="spawn N local processes, one process group "
                        "(reference: bfrun -np)")
    p.add_argument("-v", "--version", action="store_true",
                   help="print the bluefog_tpu_torch version and exit "
                        "(reference: bfrun -v)")
    p.add_argument("--check", action="store_true",
                   help="print an environment diagnosis (torch, CUDA, "
                        "devices, nvcc, native components, bootstrap env) "
                        "and exit; "
                        "the horovodrun --check-build counterpart")
    hosts_group = p.add_mutually_exclusive_group()
    hosts_group.add_argument(
        "-H", "--hosts", default=None,
        help="comma-separated remote hosts, each optionally "
             "host:slots (processes on that host, default 1): "
             "one SSH fan-out starts every rank with the "
             "torchrun's variables (reference: bfrun "
             "-H + mpirun's remote spawn, run.py:133-198)")
    hosts_group.add_argument(
        "--hostfile", default=None,
        help="file of hosts, one '<hostname> slots=<n>' per "
             "line (reference: bfrun -hostfile); alternative to -H")
    p.add_argument("--verbose", action="store_true",
                   help="with -H/--hostfile: print each rank's remote "
                        "command line before starting it")
    p.add_argument("--ssh-port", type=int, default=None,
                   help="SSH port for -H fan-out")
    p.add_argument("--remote-shell", default="ssh",
                   help="remote-spawn command for -H (default ssh; tests "
                        "substitute a local stub)")
    p.add_argument("--coordinator", default=None,
                   help="master address host:port of the process group "
                        "(MASTER_ADDR / MASTER_PORT)")
    p.add_argument("--coordinator-port", type=int, default=48292,
                   help="port of the derived default master (first -H "
                        "host); avoids collisions when two launches share a "
                        "first host (ignored with --coordinator)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count (WORLD_SIZE)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this host's process id (RANK)")
    p.add_argument("--timeline-filename", default=None,
                   help="enable timeline tracing to this path prefix "
                        "(sets BLUEFOG_TIMELINE; reference: bfrun flag)")
    p.add_argument("--metrics-filename", default=None,
                   help="enable the JSONL metrics log to this path prefix "
                        "(sets BLUEFOG_METRICS; merge per-host files with "
                        "tools/metrics_report.py)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus text exposition on this port "
                        "(sets BLUEFOG_METRICS_PORT; endpoints: /metrics, "
                        "/healthz, and — with --fleet-view — /fleet)")
    p.add_argument("--fleet-view", type=int, default=None, metavar="K",
                   dest="fleet_view",
                   help="arm in-band fleet observability: gossip the "
                        "declared metric set on every K-th consensus "
                        "probe (sets BLUEFOG_FLEET_EVERY; K also defaults "
                        "metrics_every_k for train steps built without "
                        "one; watch with python -m "
                        "bluefog_tpu_torch.tools.fleet_top)")
    p.add_argument("--flight-dir", default=None,
                   help="collect every rank's flight-recorder bundle in "
                        "this directory (sets BLUEFOG_FLIGHT_DIR: each "
                        "rank dumps its black box on failure/SIGTERM/exit; "
                        "merge with tools/postmortem.py)")
    p.add_argument("-x", "--env", action="append", default=[],
                   help="extra NAME=VALUE env for the child (repeatable)")
    p.add_argument("--restart-limit", type=int, default=0,
                   help="elastic restart: respawn a rank that exits "
                        "non-zero up to N times (per rank) instead of "
                        "tearing the job down; the respawned rank should "
                        "resume from its latest complete checkpoint "
                        "(checkpoint.restore_latest).  Default 0 = first "
                        "failure kills the job (mpirun semantics)")
    p.add_argument("--restart-backoff", type=float, default=1.0,
                   help="base seconds for the exponential restart backoff "
                        "(doubled per attempt, with deterministic jitter)")
    p.add_argument("--elastic", action="store_true",
                   help="elastic membership: the supervisor watches the "
                        "scale file (see --scale) and grows the job with "
                        "fresh-identity ranks (BLUEFOG_JOIN_COUNT set, "
                        "flight recorder armed) or retires the "
                        "highest-numbered ranks via SIGTERM; the running "
                        "program absorbs the change at application level "
                        "(resilience.regrow_world / admit_rank / "
                        "retire_rank); each join publishes the re-formed "
                        "group's process count and MASTER_PORT in "
                        "$BLUEFOG_PORT_FILE")
    p.add_argument("--scale", type=int, default=None,
                   help="without a command: signal a running --elastic "
                        "supervisor to resize the job to N ranks (writes "
                        "the scale file and exits). With a command: also "
                        "record N as the initial target")
    p.add_argument("--scale-file", default=None,
                   help="path of the elastic scale file shared between the "
                        "supervisor and `bfrun-torch --scale N` (default: "
                        "<flight-dir>/bluefog_scale, else a per-user file "
                        "under the system temp dir)")
    p.add_argument("--preempt-trace", default=None,
                   help="replay a spot-preemption trace (JSON, schema "
                        "bluefog-preempt-trace-1; generate with "
                        "tools/preempt_trace.py) against the local ranks: "
                        "at each event the victims get SIGTERM advance "
                        "notice, the grace window to drain (flush flight + "
                        "trace bundles), then SIGKILL; after the re-grant "
                        "delay the reclaimed capacity respawns as "
                        "fresh-identity joins.  Requires -np")
    p.add_argument("--preempt-grace", type=float, default=None,
                   help="default advance-notice seconds for preemption "
                        "events that do not carry their own grace=; also "
                        "exported to children as BLUEFOG_PREEMPT_GRACE so "
                        "in-process drain logic knows its budget")
    p.add_argument("--serve", action="store_true",
                   help="launch in serving mode (sets BLUEFOG_SERVE=1 for "
                        "the child): the command should bring up a "
                        "bluefog_tpu_torch.serve engine; with no command, "
                        "runs the built-in `python -m "
                        "bluefog_tpu_torch.serve` demo loop")
    p.add_argument("--serve-buckets", default=None,
                   help="serving shape buckets '<batch,..>@<prompt_len,..>' "
                        "e.g. '1,2,4@16,64,256' (sets "
                        "BLUEFOG_SERVE_BUCKETS; see ServeConfig.from_env)")
    p.add_argument("--spec-decode", default=None,
                   help="self-speculative decoding '<k>' or '<k>@<stages>' "
                        "draft depth / draft pipeline stages (sets "
                        "BLUEFOG_SPEC_DECODE; see ServeConfig.from_env)")
    p.add_argument("--kv-dtype", default=None,
                   choices=("raw", "int8", "fp8"),
                   help="KV cache page storage (sets BLUEFOG_KV_DTYPE)")
    p.add_argument("--prefix-pages", default=None,
                   help="shared prefix pages '<pages>' or "
                        "'<pages>x<page_tokens>' (sets "
                        "BLUEFOG_PREFIX_PAGES; see ServeConfig.from_env)")
    p.add_argument("--refresh-every", type=int, default=None,
                   help="serving weight refresh: pull fresh params from "
                        "the training fleet every N train steps (sets "
                        "BLUEFOG_REFRESH_EVERY; see serve.WeightRefresher)")
    p.add_argument("--serve-moe", default=None,
                   help="serve a routed MoE: "
                        "'<experts>[x<top_k>][@<ep>][:<tile>]' e.g. "
                        "'8x2@2:4' — experts, top-k routing, expert-"
                        "parallel peers carved per replica, dropless "
                        "decode tile (sets BLUEFOG_SERVE_MOE; see "
                        "ServeConfig.from_env)")
    p.add_argument("--interactive", action="store_true",
                   help="drop into an initialized Python REPL instead of "
                        "running a command (reference: ibfrun). With -np N "
                        "the REPL drives N spawned workers; with "
                        "--num-processes it waits for remote "
                        "--interactive-worker hosts; alone it is a "
                        "single-process session")
    p.add_argument("--interactive-worker", action="store_true",
                   help="run this host as an interactive worker that "
                        "executes cells from a remote --interactive "
                        "controller (reference: ibfrun's ipengine)")
    p.add_argument("--controller", default=None,
                   help="controller address host:port "
                        "(with --interactive-worker)")
    p.add_argument("--session-token", default=None,
                   help="interactive session token: with "
                        "--interactive-worker, the token printed by the "
                        "controller; with --interactive, a fixed token to "
                        "use instead of a generated one. NOTE: argv is "
                        "visible in `ps` on shared hosts — prefer the "
                        "BLUEFOG_SESSION_TOKEN env var there (default)")
    p.add_argument("--listen-port", type=int, default=0,
                   help="port the interactive controller listens on "
                        "(default: ephemeral, printed at start)")
    p.add_argument("--advertise", default=None,
                   help="address (host:port) remote interactive workers "
                        "dial back to with --interactive -H (default: "
                        "this hostname + the listen port)")
    p.add_argument("--remote-python", default="python3",
                   help="interpreter to run interactive workers with on "
                        "-H hosts (e.g. /path/to/venv/bin/python)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="the training command, e.g. python train.py")
    return p


def _child_env(args) -> dict:
    env = dict(os.environ)
    for kv in args.env:
        if "=" not in kv:
            raise SystemExit(f"-x expects NAME=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        env[k] = v
    if args.timeline_filename:
        env["BLUEFOG_TIMELINE"] = args.timeline_filename
    if args.metrics_filename:
        env["BLUEFOG_METRICS"] = args.metrics_filename
    if args.metrics_port is not None:
        env["BLUEFOG_METRICS_PORT"] = str(args.metrics_port)
    if args.fleet_view is not None:
        if args.fleet_view < 1:
            raise SystemExit("--fleet-view must be a positive probe cadence")
        env["BLUEFOG_FLEET_EVERY"] = str(args.fleet_view)
    if args.flight_dir:
        env["BLUEFOG_FLIGHT_DIR"] = os.path.abspath(args.flight_dir)
    if args.serve:
        env["BLUEFOG_SERVE"] = "1"
    if args.serve_buckets:
        env["BLUEFOG_SERVE_BUCKETS"] = args.serve_buckets
    if args.spec_decode:
        env["BLUEFOG_SPEC_DECODE"] = args.spec_decode
    if args.kv_dtype:
        env["BLUEFOG_KV_DTYPE"] = args.kv_dtype
    if args.prefix_pages:
        env["BLUEFOG_PREFIX_PAGES"] = args.prefix_pages
    if args.refresh_every is not None:
        env["BLUEFOG_REFRESH_EVERY"] = str(args.refresh_every)
    if args.serve_moe:
        env["BLUEFOG_SERVE_MOE"] = args.serve_moe
    if args.preempt_grace is not None:
        env["BLUEFOG_PREEMPT_GRACE"] = str(args.preempt_grace)
    return env


def parse_hosts(spec: str):
    """``"host1,host2:2"`` -> ``[("host1", 1), ("host2", 2)]``."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, slots = part.partition(":")
        out.append((host, int(slots) if slots else 1))
    if not out:
        raise SystemExit("-H needs at least one host")
    return out


def parse_hostfile(path: str):
    """mpirun-style hostfile: one ``<hostname> slots=<n>`` per line
    (reference: ``bfrun -hostfile``, ``run.py:84-87``); ``slots`` defaults
    to 1, ``#`` comments and blank lines are skipped."""
    out = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            fields = line.split()
            slots = 1
            for field in fields[1:]:
                key, _, val = field.partition("=")
                if key != "slots":
                    raise SystemExit(
                        f"{path}:{lineno}: unsupported hostfile field "
                        f"{field!r} (expected '<hostname> slots=<n>')")
                if not val.isdigit() or int(val) < 1:
                    raise SystemExit(
                        f"{path}:{lineno}: slots must be a positive "
                        f"integer, got {val!r}")
                slots = int(val)
            out.append((fields[0], slots))
    if not out:
        raise SystemExit(f"hostfile {path} lists no hosts")
    return out


# env the remote ranks need even without explicit -x (reference: bfrun
# forwards every exportable variable through mpirun -x; here the relevant
# namespaces are forwarded and -x adds the rest)
_FORWARD_PREFIXES = ("BLUEFOG_", "TORCH_", "NCCL_", "CUDA_", "PYTORCH_")

#: torchrun's variables, set per rank by the launcher (never forwarded)
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT")


def _split_addr(addr: str):
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise SystemExit(f"--coordinator expects host:port, got {addr!r}")
    return host, port


def _free_port() -> int:
    """An unused TCP port on this host (for a local master)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_multihost_plan(hosts, command, *, cwd, coordinator=None,
                         base_env=None, extra_env=(), remote_shell="ssh",
                         ssh_port=None, coordinator_port=48292):
    """Build one remote-spawn argv per rank for the ``-H`` fan-out.

    Each rank's remote command cds into the launch directory and execs the
    training command under torchrun's variables (the master on the first
    host, dense ranks in host order, ``LOCAL_RANK`` the slot on its host)
    plus the forwarded ``BLUEFOG_*``/``TORCH_*``/``NCCL_*``/``CUDA_*``
    variables and any ``-x NAME=VALUE`` extras — the reference's
    env-forwarding contract (``run.py:184-196``) without the mpirun
    dependency.  The interactive session token is never embedded (the
    argv is visible in ``ps`` on both ends).
    """
    base_env = dict(base_env or {})
    total = sum(s for _, s in hosts)
    if coordinator is None:
        # the first HOST is the master: an ssh spec may carry a 'user@'
        # login prefix, which is not part of the dialable address
        host0 = hosts[0][0].rpartition("@")[2]
        coordinator = f"{host0}:{coordinator_port}"
    maddr, mport = _split_addr(coordinator)
    forwarded = {k: v for k, v in base_env.items()
                 if k.startswith(_FORWARD_PREFIXES)
                 and k not in ("BLUEFOG_SESSION_TOKEN",)}
    for kv in extra_env:
        k, _, v = kv.partition("=")
        forwarded[k] = v
    plans = []
    pid = 0
    for host, slots in hosts:
        for local in range(slots):
            env_pairs = {
                **forwarded,
                "MASTER_ADDR": maddr,
                "MASTER_PORT": mport,
                "WORLD_SIZE": str(total),
                "RANK": str(pid),
                "LOCAL_RANK": str(local),
            }
            remote_cmd = "cd {} && exec env {} {}".format(
                shlex.quote(cwd),
                " ".join(f"{k}={shlex.quote(v)}"
                         for k, v in sorted(env_pairs.items())),
                " ".join(shlex.quote(c) for c in command))
            argv = shlex.split(remote_shell)
            if ssh_port is not None:
                argv += ["-p", str(ssh_port)]
            argv += [host, remote_cmd]
            plans.append((host, pid, argv))
            pid += 1
    return plans


def _multihost_fanout(args, env) -> int:
    """``bfrun-torch -H host1,host2 python train.py``: start every rank over
    SSH, stream their output, propagate the first failure — the one-command
    multi-host launch the reference gets from mpirun's remote spawn."""
    hosts = (parse_hostfile(args.hostfile) if args.hostfile
             else parse_hosts(args.hosts))
    plans = build_multihost_plan(
        hosts, args.command, cwd=os.getcwd(),
        coordinator=args.coordinator, base_env=env, extra_env=args.env,
        remote_shell=args.remote_shell, ssh_port=args.ssh_port,
        coordinator_port=args.coordinator_port)
    procs = []
    for host, pid, argv in plans:
        print(f"{PROG}: starting rank {pid} on {host}", flush=True)
        if args.verbose:
            print(f"{PROG}:   {shlex.join(argv)}", flush=True)
        procs.append(subprocess.Popen(argv))
    # restart respawns the same remote argv: the rank's bootstrap env is
    # baked into it, and resume-from-checkpoint is the child's job
    return _supervise_procs(
        procs,
        respawn=lambda rank, _count: subprocess.Popen(plans[rank][2]),
        restart_limit=args.restart_limit,
        restart_backoff=args.restart_backoff,
        labels=[f"rank {pid} on {host}" for host, pid, _ in plans],
        flight_dir=env.get("BLUEFOG_FLIGHT_DIR"))


def _count_restart() -> None:
    from ..utils import metrics as _metrics
    _metrics.counter(
        "bluefog_rank_restarts_total",
        "rank respawns performed by the launcher supervisor").inc()


def _count_membership(change: str) -> None:
    from ..utils import metrics as _metrics
    _metrics.counter(
        "bluefog_membership_changes_total",
        "membership transitions applied (dead / join / retire)"
    ).inc(change=change)


def _scale_file_path(args, env=None) -> str:
    """Resolve the scale file both the supervisor and ``--scale N`` use."""
    if args.scale_file:
        return os.path.abspath(args.scale_file)
    flight_dir = (env or {}).get("BLUEFOG_FLIGHT_DIR") or args.flight_dir
    if flight_dir:
        return os.path.join(os.path.abspath(flight_dir), "bluefog_scale")
    import tempfile
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(), f"bfrun_scale_{uid}")


def _write_scale(path: str, target: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{int(target)}\n")
    os.replace(tmp, path)      # atomic: the supervisor never reads a torn file


_warned_scale: set = set()


def _read_scale(path: str, min_world: Optional[int] = None) -> Optional[int]:
    """Read the elastic scale target; ``None`` when absent or unusable.

    A missing file is the normal idle state (silent), but a *malformed*
    file or a target below ``min_world`` means a hand-written target is
    silently disabling elastic scaling — warn once per offending content
    naming the path, so the operator can fix it.
    """
    try:
        with open(path) as f:
            raw = f.read().strip()
    except OSError:
        return None
    try:
        target = int(raw)
    except ValueError:
        key = (path, raw)
        if key not in _warned_scale:
            _warned_scale.add(key)
            print(f"{PROG}: ignoring malformed scale file {path}: "
                  f"expected an integer target, got {raw!r}",
                  file=sys.stderr, flush=True)
        return None
    if min_world is not None and target < min_world:
        key = (path, raw)
        if key not in _warned_scale:
            _warned_scale.add(key)
            print(f"{PROG}: ignoring scale file {path}: target "
                  f"{target} is below the minimum world size {min_world}",
                  file=sys.stderr, flush=True)
        return None
    return target


def _report_flight_bundles(flight_dir, say) -> None:
    """After a job failure, say which per-rank flight bundles landed in the
    collection directory (the children wrote them on failure/SIGTERM) and
    how to turn them into a verdict."""
    if not flight_dir:
        return
    try:
        bundles = sorted(f for f in os.listdir(flight_dir)
                         if f.startswith("flight_rank")
                         and f.endswith(".json"))
    except OSError:
        bundles = []
    if bundles:
        say(f"collected {len(bundles)} flight bundle(s) in {flight_dir}: "
            + ", ".join(bundles))
        say(f"postmortem: python tools/postmortem.py --dir {flight_dir}")
    else:
        say(f"no flight bundles found in {flight_dir}")


PREEMPT_TRACE_SCHEMA = "bluefog-preempt-trace-1"


def _load_preempt_trace(path: str, *, default_grace=None) -> dict:
    """Parse a ``bluefog-preempt-trace-1`` JSON file into a normalized
    ``{"zones": Z, "world": N|None, "events": [...]}`` dict.  Each event
    carries ``t`` (seconds after supervision start), victims (an explicit
    rank list or a ``zone`` id), ``grace`` advance-notice seconds, and the
    ``regrant`` delay before the reclaimed capacity comes back."""
    import json

    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("schema") != PREEMPT_TRACE_SCHEMA:
        raise SystemExit(
            f"--preempt-trace {path}: expected schema "
            f"{PREEMPT_TRACE_SCHEMA!r}, got {doc.get('schema')!r}")
    events = []
    for ev in doc.get("events", ()):
        grace = ev.get("grace", doc.get("grace"))
        if grace is None:
            grace = 0.0 if default_grace is None else default_grace
        events.append({
            "t": float(ev["t"]),
            "zone": ev.get("zone"),
            "victims": [int(r) for r in ev.get("victims", ())],
            "grace": max(0.0, float(grace)),
            "regrant": max(0.0, float(ev.get("regrant",
                                            doc.get("regrant", 0.0)))),
        })
        if not events[-1]["victims"] and events[-1]["zone"] is None:
            raise SystemExit(
                f"--preempt-trace {path}: event at t={ev['t']} names "
                "neither victims nor a zone")
    events.sort(key=lambda e: e["t"])
    return {"zones": max(1, int(doc.get("zones", 1))),
            "world": doc.get("world"), "pattern": doc.get("pattern"),
            "events": events}


def _supervise_procs(procs, respawn=None, *, restart_limit=0,
                     restart_backoff=1.0, labels=None,
                     poll_interval=0.2, flight_dir=None,
                     elastic=False, scale_file=None, spawn=None,
                     preempt_trace=None) -> int:
    """Supervise one Popen per rank; the shared exit path for ``-np`` and
    ``-H`` launches.

    Default (``restart_limit=0``) keeps mpirun semantics — the first
    non-zero exit terminates the survivors (a dead rank leaves the others
    blocked in the process group's collectives forever) — but now *says which
    rank died with which code* before doing so, and names it again in the
    final error line: the reference's mpirun teardown loses exactly this
    diagnosis.

    With ``restart_limit=N`` (elastic restart, the Elastic-Horovod move):
    a rank exiting non-zero is respawned via ``respawn(rank, attempt)`` up
    to N times, after an exponential backoff with deterministic seeded
    jitter (``restart_backoff * 2**(attempt-1)``, +0..25 %) so crash loops
    do not hammer the host and two supervisors never thunder in lockstep.
    Survivors keep running throughout; the respawned child is expected to
    resume from its latest *complete* checkpoint.  Every respawn
    increments ``bluefog_rank_restarts_total``.

    With ``elastic=True`` the supervisor also watches ``scale_file`` (the
    join queue fed by ``bfrun-torch --scale N``): a target above the current
    slot count spawns fresh ranks via ``spawn(rank, total, join_count)`` —
    rank ids are never reused, so a joined rank gets a fresh identity
    (``BLUEFOG_JOIN_COUNT``) with the flight recorder armed through the
    inherited env — and a target below it SIGTERMs the highest-numbered
    live ranks (the graceful-retire signal: their flight handler dumps a
    bundle on the way out).  The running ranks absorb the change at
    application level (``resilience.regrow_world``, or
    ``admit_rank``/``retire_rank`` inside a fixed world).
    """
    import random as _random
    import signal as _signal
    import time as _time

    procs = list(procs)
    labels = (list(labels) if labels is not None
              else [f"rank {r}" for r in range(len(procs))])
    restarts = [0] * len(procs)
    done = [False] * len(procs)
    retiring: set = set()
    preempted: set = set()
    joins = 0
    applied_target: Optional[int] = None
    world0 = len(procs)
    trace = preempt_trace or {"zones": 1, "world": None, "events": []}
    trace_world = int(trace.get("world") or world0)
    pending = list(trace["events"])      # sorted by t at load time
    notified: list = []                  # grace windows awaiting hard kill
    regrants: list = []                  # reclaimed capacity awaiting return
    t0 = _time.monotonic()

    def say(msg):
        print(f"{PROG}: {msg}", file=sys.stderr, flush=True)

    def _preempt_victims(ev):
        if ev["victims"]:
            ranks = ev["victims"]
        else:
            from ..utils.chaos import zone_victims
            ranks = zone_victims(ev["zone"], trace_world, trace["zones"])
        return [r for r in ranks
                if r < len(procs) and not done[r] and r not in retiring]

    while True:
        now = _time.monotonic() - t0
        # -- preemption-trace replay: notice -> grace -> kill -> re-grant --
        while pending and pending[0]["t"] <= now:
            ev = pending.pop(0)
            victims = _preempt_victims(ev)
            if not victims:
                continue
            zone = (f"zone {ev['zone']} " if ev["zone"] is not None else "")
            say(f"preempt: {zone}reclaiming rank(s) {victims} "
                f"(grace {ev['grace']:g} s, re-grant {ev['regrant']:g} s)")
            for r in victims:
                retiring.add(r)
                preempted.add(r)
                _count_membership("preempt")
                if procs[r].poll() is None:
                    try:        # the SIGTERM advance notice: drain window
                        procs[r].send_signal(_signal.SIGTERM)
                    except OSError:                   # pragma: no cover
                        pass
            notified.append({"ranks": victims, "kill_at": now + ev["grace"],
                             "regrant": ev["regrant"]})
        for notice in list(notified):
            if now < notice["kill_at"]:
                continue
            notified.remove(notice)
            for r in notice["ranks"]:       # grace expired: the reclaim lands
                if not done[r] and procs[r].poll() is None:
                    say(f"preempt: grace expired, killing {labels[r]}")
                    try:
                        procs[r].kill()
                    except OSError:                   # pragma: no cover
                        pass
            if spawn is not None:
                regrants.append({"count": len(notice["ranks"]),
                                 "at": now + notice["regrant"]})
        for grant in list(regrants):
            if now < grant["at"]:
                continue
            regrants.remove(grant)
            for _ in range(grant["count"]):
                rank = len(procs)
                joins += 1
                say(f"preempt re-grant: starting rank {rank} "
                    f"(fresh identity, join {joins})")
                procs.append(spawn(rank, trace_world, joins))
                labels.append(f"rank {rank}")
                restarts.append(0)
                done.append(False)
                _count_membership("join")
        if elastic and scale_file and spawn is not None:
            target = _read_scale(scale_file, min_world=1)
            if target is not None and target != applied_target:
                applied_target = target
                slots = len(procs) - len(retiring)
                while slots < target:
                    rank = len(procs)
                    joins += 1
                    say(f"elastic join: starting rank {rank} "
                        f"(target {target})")
                    procs.append(spawn(rank, target, joins))
                    labels.append(f"rank {rank}")
                    restarts.append(0)
                    done.append(False)
                    _count_membership("join")
                    slots += 1
                for rank in reversed(range(len(procs))):
                    if slots <= target:
                        break
                    if rank in retiring:
                        continue
                    retiring.add(rank)
                    slots -= 1
                    _count_membership("retire")
                    if not done[rank] and procs[rank].poll() is None:
                        say(f"elastic retire: stopping {labels[rank]} "
                            f"(target {target})")
                        try:
                            procs[rank].send_signal(_signal.SIGTERM)
                        except OSError:       # pragma: no cover
                            pass
        all_done = True
        for rank, p in enumerate(procs):
            if done[rank]:
                continue
            code = p.poll()
            if code is None:
                all_done = False
                continue
            if rank in retiring:
                # asked to leave: any exit (incl. -SIGTERM) is a clean retire
                done[rank] = True
                verb = "preempted" if rank in preempted else "retired"
                say(f"{labels[rank]} {verb} (exit code {code})")
                continue
            if code == 0:
                done[rank] = True
                continue
            say(f"{labels[rank]} exited with code {code}")
            if respawn is not None and restarts[rank] < restart_limit:
                restarts[rank] += 1
                delay = restart_backoff * (2 ** (restarts[rank] - 1))
                delay *= 1.0 + 0.25 * _random.Random(
                    f"bfrun:{rank}:{restarts[rank]}").random()
                say(f"restarting {labels[rank]} (attempt {restarts[rank]}"
                    f"/{restart_limit}) after {delay:.2f} s backoff")
                _time.sleep(delay)
                procs[rank] = respawn(rank, restarts[rank])
                _count_restart()
                all_done = False
                continue
            # out of restart budget (or restarts disabled): tear down the
            # survivors, reporting any that die non-zero on the way out
            for r, q in enumerate(procs):
                if r != rank and not done[r] and q.poll() is None:
                    q.terminate()
            for r, q in enumerate(procs):
                if r == rank or done[r]:
                    continue
                try:
                    q.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    q.kill()
                    q.wait()
                if q.returncode:
                    say(f"{labels[r]} exited with code {q.returncode} "
                        "during teardown")
            _report_flight_bundles(flight_dir, say)
            say(f"job failed: {labels[rank]} exited with code {code}"
                + (f" after {restarts[rank]} restart(s)"
                   if restarts[rank] else ""))
            return code
        if all_done:
            return 0
        _time.sleep(poll_interval)


def _interactive_cluster(args, env) -> int:
    """Multi-host interactive session (the ibfrun counterpart): drive N
    workers from a local REPL.  ``-np N`` spawns the workers here (local
    emulation, like `ibfrun -np`); ``-H host1,host2`` (or ``--hostfile``)
    SSH-starts one worker per slot — the one-command remote ibfrun;
    ``--num-processes N`` alone waits for manually started
    ``--interactive-worker`` hosts to dial in."""
    from .interactive import Controller, repl

    hosts = (parse_hostfile(args.hostfile) if args.hostfile
             else parse_hosts(args.hosts) if args.hosts else None)
    n = (args.num_local_processes if args.num_local_processes
         else sum(s for _, s in hosts) if hosts
         else args.num_processes)
    # local spawn keeps the cell socket on loopback; remote-worker mode must
    # listen on all interfaces — either way cells only execute for peers
    # presenting the session token
    host = "127.0.0.1" if args.num_local_processes else "0.0.0.0"
    token = args.session_token or os.environ.get("BLUEFOG_SESSION_TOKEN")
    ctrl = Controller(n, port=args.listen_port, host=host, token=token)
    print(f"interactive controller listening on port {ctrl.port} "
          f"({n} worker(s))", flush=True)
    procs = []
    if args.num_local_processes:
        env = dict(env, BLUEFOG_SESSION_TOKEN=ctrl.token)
        procs = _spawn_local_workers(
            n, args.coordinator or f"127.0.0.1:{_free_port()}", env,
            [sys.executable, "-m", "bluefog_tpu_torch.run.interactive",
             "--connect", f"127.0.0.1:{ctrl.port}"])
    elif hosts:
        # one-command remote ibfrun: SSH-start every worker via the -H
        # fan-out plan.  The session token travels over each ssh STDIN
        # (`read` in the remote shell), never the ps-visible argv.
        me = args.advertise or f"{socket.gethostname()}:{ctrl.port}"
        worker_cmd = [args.remote_python, "-m",
                      "bluefog_tpu_torch.run.interactive", "--connect", me]
        plans = build_multihost_plan(
            hosts, worker_cmd, cwd=os.getcwd(),
            coordinator=args.coordinator, base_env=env, extra_env=args.env,
            remote_shell=args.remote_shell, ssh_port=args.ssh_port,
            coordinator_port=args.coordinator_port)
        for host_, pid, argv in plans:
            # prefix the remote command with a token read from stdin
            argv = argv[:-1] + [
                "IFS= read -r BLUEFOG_SESSION_TOKEN; "
                "export BLUEFOG_SESSION_TOKEN; " + argv[-1]]
            print(f"{PROG}: starting interactive worker {pid} on "
                  f"{host_}", flush=True)
            p = subprocess.Popen(argv, stdin=subprocess.PIPE)
            try:
                p.stdin.write((ctrl.token + "\n").encode())
                p.stdin.close()
            except (BrokenPipeError, OSError):
                pass              # spawn already dead; the monitor reports it
            procs.append(p)
        # a dead spawn (bad host, auth failure, missing interpreter) must
        # surface immediately, not as a silent 300 s accept timeout
        import threading as _threading

        ready = _threading.Event()

        def _monitor():
            # ANY exit before the session is ready is fatal, exit code
            # included: a worker that ends cleanly (ssh succeeded but the
            # command no-op'd) has still not connected, and waiting out
            # the full accept timeout would hide the diagnosis
            while not ready.is_set():
                for p_ in procs:
                    if p_.poll() is not None:
                        print(f"{PROG}: an interactive worker exited "
                              f"with code {p_.returncode} before "
                              "connecting — check host/interpreter "
                              "(--remote-python) and ssh access",
                              file=sys.stderr, flush=True)
                        ctrl.abort(
                            f"a worker spawn exited with code "
                            f"{p_.returncode} before connecting")
                        return
                _time.sleep(0.5)

        import time as _time
        _threading.Thread(target=_monitor, daemon=True).start()
    else:
        # remote workers need the token out of band (notebook-server style)
        print("session token (pass to each worker via --session-token or "
              f"BLUEFOG_SESSION_TOKEN): {ctrl.token}", flush=True)
    try:
        try:
            ranks = ctrl.wait_for_workers()
        except (OSError, RuntimeError) as exc:
            raise SystemExit(
                f"interactive workers failed to connect ({exc}); see the "
                "worker-exit diagnosis above") from exc
        if hosts:
            ready.set()
        print(f"workers ready: ranks {ranks}", flush=True)
        repl(ctrl)
    finally:
        ctrl.shutdown()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
    return 0


def _spawn_local_worker(pid, n, coordinator, env, cmd, restart_count=0,
                        join_count=0):
    """Spawn ONE local rank of an n-process group with torchrun's
    variables (``LOCAL_RANK`` = its rank: one host).

    ``restart_count > 0`` marks an elastic respawn: the child sees
    ``BLUEFOG_RESTART_COUNT`` so training scripts can branch (e.g. resume
    via ``checkpoint.restore_latest`` rather than cold-start).
    ``join_count > 0`` marks an elastic *join*: a fresh rank id that never
    ran before — the child sees ``BLUEFOG_JOIN_COUNT`` so scripts
    bootstrap by neighbor pull (``resilience.regrow_join`` /
    ``join_rank``) instead of a checkpoint."""
    maddr, mport = _split_addr(coordinator)
    penv = dict(env)
    penv.update({"MASTER_ADDR": maddr, "MASTER_PORT": mport,
                 "WORLD_SIZE": str(n), "RANK": str(pid),
                 "LOCAL_RANK": str(pid)})
    if restart_count:
        penv["BLUEFOG_RESTART_COUNT"] = str(restart_count)
    if join_count:
        penv["BLUEFOG_JOIN_COUNT"] = str(join_count)
    return subprocess.Popen(cmd, env=penv)


def _spawn_local_workers(n, coordinator, env, cmd):
    """Spawn N local processes wired into one process group (the
    `mpirun -np N` stand-in shared by the batch and interactive paths)."""
    return [_spawn_local_worker(pid, n, coordinator, env, cmd)
            for pid in range(n)]


def _publish_port(path: str, processes: int, port: int) -> None:
    """Write ``"<processes> <port>"`` to ``path`` atomically: the port the
    process group re-formed at ``processes`` meets on."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{int(processes)} {int(port)}\n")
    os.replace(tmp, path)


def _published_port(path: str, processes: int) -> Optional[str]:
    """The port :func:`_publish_port` wrote in ``path`` for
    ``processes``; ``None`` while the file is absent or holds another
    count."""
    try:
        with open(path) as f:
            line = f.read().split()
    except OSError:
        return None
    if len(line) == 2 and line[0] == str(int(processes)):
        return line[1]
    return None


def _join_spawner(coordinator, env, cmd, port_file):
    """``spawn(rank, total, joins)`` for the supervisor's joins: each new
    world size gets a fresh master port, published with the size in
    ``port_file`` (``$BLUEFOG_PORT_FILE`` of every child) before its
    first joiner starts, so the survivors re-form the group on the same
    port."""
    maddr, _ = _split_addr(coordinator)
    ports = {}

    def spawn(rank, total, joins):
        if total not in ports:
            ports[total] = str(_free_port())
            _publish_port(port_file, total, int(ports[total]))
        return _spawn_local_worker(rank, total, f"{maddr}:{ports[total]}",
                                   env, cmd, join_count=joins)

    return spawn


def _apply_coordinator_env(args, env) -> None:
    """Map --coordinator/--num-processes/--process-id onto torchrun's
    variables ``bluefog_tpu_torch.init`` reads (shared by batch and
    worker modes)."""
    if (args.num_processes or 1) > 1 and args.process_id is None:
        raise SystemExit(
            "--process-id is required with --coordinator: defaulting "
            "every host to process 0 would deadlock the rendezvous")
    maddr, mport = _split_addr(args.coordinator)
    env.update({"MASTER_ADDR": maddr, "MASTER_PORT": mport,
                "WORLD_SIZE": str(args.num_processes or 1),
                "RANK": str(args.process_id or 0),
                "LOCAL_RANK": env.get("LOCAL_RANK", "0")})


def check_environment(stream=None) -> int:
    """Print an environment diagnosis (``bfrun-torch --check``).

    Everything a stuck launch needs triaged: versions, CUDA and the
    visible cards, ``nvcc`` (the kernels are built from source at first
    use), the native (C++) component status, and which torchrun / bluefog
    bootstrap variables are set.  Returns 1 when no card is visible: the
    port runs on CUDA unless a caller asks for the CPU.
    """
    from .. import __version__
    from ..ops import _build

    stream = stream if stream is not None else sys.stdout
    w = lambda s: stream.write(s + "\n")
    w(f"bluefog_tpu_torch {__version__}")
    import torch

    w(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    boot = {k: os.environ[k] for k in
            LAUNCH_VARS + ("BLUEFOG_NODES_PER_MACHINE", "BLUEFOG_TIMELINE",
                           "BLUEFOG_DEVICE") if k in os.environ}
    w(f"bootstrap env: {boot or '(none set)'}")
    try:
        w(f"nvcc: {_build._nvcc()}")
    except RuntimeError as e:
        w(f"nvcc: not found ({e})")
    from .. import _native
    w(f"native (C++) components: "
      f"{'built' if _native.available() else 'pure-Python fallback'}")
    stream.flush()
    if not torch.cuda.is_available():
        w("devices: no CUDA device visible (the port runs on CUDA unless "
          "a caller asks for device='cpu')")
        return 1
    n = torch.cuda.device_count()
    w(f"devices: {n} x {torch.cuda.get_device_name(0)}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        from .. import __version__
        print(f"bluefog_tpu_torch {__version__}")
        return 0
    if args.check:
        return check_environment()
    if args.interactive_worker:
        if not args.controller:
            raise SystemExit("--interactive-worker requires --controller")
        env = _child_env(args)
        # the worker joins the process group exactly like a batch rank:
        # forward any --coordinator bootstrap into its env
        if args.coordinator:
            _apply_coordinator_env(args, env)
        if args.session_token:
            env["BLUEFOG_SESSION_TOKEN"] = args.session_token
        return subprocess.call(
            [sys.executable, "-m", "bluefog_tpu_torch.run.interactive",
             "--connect", args.controller], env=env)
    if args.interactive and (args.num_local_processes or args.num_processes
                             or args.hosts or args.hostfile):
        return _interactive_cluster(args, _child_env(args))
    if args.interactive:
        env = _child_env(args)
        bootstrap = (
            "import os, bluefog_tpu_torch as bf; "
            "bf.init(device=os.environ.get('BLUEFOG_DEVICE') or None); "
            "print(f'bluefog_tpu_torch ready: {bf.size()} rank(s), "
            "device={bf.get_context().device}')")
        return subprocess.call(
            [sys.executable, "-i", "-c", bootstrap], env=env)
    if args.scale is not None and not args.command:
        # signalling mode: resize a running --elastic supervisor and exit
        if args.scale < 1:
            raise SystemExit(f"--scale needs a positive target, "
                             f"got {args.scale}")
        path = _scale_file_path(args)
        _write_scale(path, args.scale)
        print(f"{PROG}: scale target {args.scale} written to {path}",
              flush=True)
        return 0
    if args.serve and not args.command:
        # serving mode with no command: run the built-in demo loop so the
        # launcher path is exercisable end to end (serve/__main__.py)
        args.command = [sys.executable, "-m", "bluefog_tpu_torch.serve"]
    if not args.command:
        build_parser().print_help()
        return 2
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]

    env = _child_env(args)

    if args.hosts or args.hostfile:
        args.command = cmd
        return _multihost_fanout(args, env)

    if args.num_local_processes:
        # local multi-process: one process group on this host (the role of
        # `mpirun -np N` / torchrun --nproc-per-node on one machine)
        n = args.num_local_processes
        coordinator = args.coordinator or f"127.0.0.1:{_free_port()}"
        scale_file = _scale_file_path(args, env) if args.elastic else None
        if args.elastic and args.scale is not None:
            _write_scale(scale_file, args.scale)
        trace = (_load_preempt_trace(args.preempt_trace,
                                     default_grace=args.preempt_grace)
                 if args.preempt_trace else None)
        port_file = (scale_file or _scale_file_path(args, env)) + ".port"
        # a port an earlier job published here is not this job's
        try:
            os.remove(port_file)
        except FileNotFoundError:
            pass
        env = dict(env, BLUEFOG_PORT_FILE=port_file)
        procs = _spawn_local_workers(n, coordinator, env, cmd)
        return _supervise_procs(
            procs,
            respawn=lambda rank, count: _spawn_local_worker(
                rank, n, coordinator, env, cmd, restart_count=count),
            restart_limit=args.restart_limit,
            restart_backoff=args.restart_backoff,
            flight_dir=env.get("BLUEFOG_FLIGHT_DIR"),
            elastic=args.elastic, scale_file=scale_file,
            spawn=_join_spawner(coordinator, env, cmd, port_file),
            preempt_trace=trace)

    if args.preempt_trace:
        raise SystemExit("--preempt-trace requires -np (the local "
                         "supervisor replays the trace against its ranks)")

    if args.coordinator:
        _apply_coordinator_env(args, env)

    return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    sys.exit(main())
