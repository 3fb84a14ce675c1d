"""The multi-process checks of the port: the port's counterpart of
``tests/test_multihost.py``'s child, and a launcher for it.

:func:`run_checks` drives every op that moves rows between ranks, on the
live context: weighted ring gossip (round by round, and with every
round at once under ``set_round_parallel``), the wire codecs, the new
collectives
(``neighbor_allgather``, ``ragged_neighbor_allgather``, ``pair_gossip``),
``allreduce`` / ``allgather`` / ``ragged_allgather`` / ``broadcast``,
hierarchical gossip over a ring of machines, a sequence of window ops,
the named windows (:func:`named_window_checks`) and async window gossip
(:func:`async_checks`: its forced sync-ups take a MAX through the process
group), ZeRO-1 over 5
steps of ``make_train_step``, and the pipelines across the rank axis
(GPipe with its gradients, interleaved, 1F1B).  ``--only windows`` runs
the named-window checks alone.  It counts
the ``batch_isend_irecv`` calls of the gossip and ZeRO steps
(``p2p_calls``).  Launched as
several processes each returns its block of every per-rank result (and
every process the replicated ones); in one process it returns the whole
of each, the reference the multi-process run must equal bit for bit.

:func:`spawn` starts the processes with torchrun's variables (gloo on the
CPU, NCCL on a card), each with its own time limit, and joins their
blocks; :func:`reference` runs the same checks in one process.

Run a child by hand::

    RANK=0 WORLD_SIZE=1 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 \\
    MASTER_PORT=29511 python -m bluefog_tpu_torch.tools.world_check \\
        --out /tmp/w --size 8 --device cpu
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import optimizers as bfopt
from bluefog_tpu_torch import schedule as sch_mod
from bluefog_tpu_torch import topology as tu
from bluefog_tpu_torch.ops import windows as wops
from bluefog_tpu_torch.parallel import pipeline as pipe

#: results every process holds whole (the others are per-rank blocks)
REPLICATED = ("pp_out", "pp_loss", "il_out", "st_out", "zero_loss_mean",
              "layout", "p2p_calls", "nw_version", "nw_stamps",
              "nw_staleness", "async_local_steps")
WIRES = ("bf16", "fp8", "int8@4", "fp8@4")
PARTNERS = [7, 2, 1, 4, 3, 5, 6, 0]       # pairs across and inside blocks
ROOT = 5


def count_p2p(fn):
    """``fn()`` and the number of ``batch_isend_irecv`` calls it made
    (each a group of messages, one a process pair)."""
    from bluefog_tpu_torch.ops import collectives as coll
    calls, p2p = [0], coll._p2p

    def counted(*args):
        calls[0] += 1
        return p2p(*args)

    coll._p2p = counted
    try:
        return fn(), calls[0]
    finally:
        coll._p2p = p2p


def window_sequence(ops, sched, x, wire):
    """Every window op once on the stacked ``x`` (``ops`` is a window
    module: the port's, or the JAX package's under ``shard_map``);
    returns the combined values and the mailboxes."""
    n = sched.size
    K = max(sched.max_in_degree, 1)
    sw = np.linspace(0.3, 0.6, n).astype(np.float32)
    slot_w = (np.arange(K * n, dtype=np.float32).reshape(K, n) % 3) / 10
    win = ops.win_create(x, sched, zero_init=False)
    out = [win.recv]
    win = ops.win_put(win, 2 * x, sched, wire=wire)
    out.append(win.recv)
    c1, win = ops.win_update(win, sched)
    c2, win = ops.win_update(win, sched, self_weight=sw, slot_weights=slot_w)
    win = ops.win_accumulate(win, x + 1, sched, wire=wire)
    out.append(win.recv)
    win = ops.win_get(win, sched, wire=wire)
    out.append(win.recv)
    c3, win = ops.win_update_then_collect(win, sched)
    out.append(win.recv)
    return [c1, c2, c3, win.value] + out


def inputs(n: int) -> Dict[str, np.ndarray]:
    """The checks' global inputs, from a numpy seed."""
    rng = np.random.default_rng(7)
    return {
        "ramp3": np.broadcast_to(np.arange(float(n))[:, None],
                                 (n, 3)).astype(np.float32),
        "ramp8": np.broadcast_to(np.arange(float(n))[:, None],
                                 (n, 8)).astype(np.float32),
        "rand": rng.normal(size=(n, 5, 7)).astype(np.float32),
        "gather": rng.normal(size=(n, 2, 3)).astype(np.float32),
        "ragged": rng.normal(size=(n, 4, 3)).astype(np.float32),
        "lengths": (np.arange(n) % 5).astype(np.int32),
        "window": rng.normal(size=(n, 6)).astype(np.float32),
        "pp_w": np.linspace(0.1, 0.9, n * 16).reshape(n, 4, 4)
        .astype(np.float32),
        "pp_mb": np.linspace(-1, 1, 3 * 2 * 4).reshape(3, 2, 4)
        .astype(np.float32),
        "pp_tgt": rng.normal(size=(3, 2, 4)).astype(np.float32),
        "il_w": (rng.normal(size=(n, 2, 4, 4)) * 0.5).astype(np.float32),
        "st_embed": (rng.normal(size=(16, 4)) * 0.3).astype(np.float32),
        "st_w": (rng.normal(size=(n - 2, 4, 4)) * 0.3).astype(np.float32),
        "st_head": (rng.normal(size=(4, 16)) * 0.3).astype(np.float32),
        "st_tokens": rng.integers(0, 16, size=(3, 2, 5)),
    }


def named_window_checks(dist) -> Dict[str, torch.Tensor]:
    """The named-window API on Exp2: puts with and without dst weights
    and a codec, accumulate with the associated p, get, the combines,
    versions, stamps and staleness."""
    from bluefog_tpu_torch.parallel import windows as nw
    n = bf.size()
    bf.set_topology(tu.ExponentialTwoGraph(n))
    x = dist("window")
    out = {}
    bf.win_create(x, "wc")
    bf.win_create(x, "wa", zero_init=True)
    bf.win_put(2 * x, "wc", wire="int8")
    sched = nw._registry["wc"].sched
    # each rank puts to its first out-neighbor only, scaled
    first = [min(q for q in range(n) if r in sched.in_neighbors[q])
             for r in range(n)]
    dst = [{d: 0.5 + 0.1 * (d % 3)} for d in first]
    bf.win_put(x + 1, "wc", dst_weights=dst)
    out["nw_put_recv"] = nw._registry["wc"].window.recv
    out["nw_update"] = bf.win_update("wc")
    bf.turn_on_win_ops_with_associated_p()
    try:
        bf.win_accumulate(x, "wa", dst_weights=dst)
        bf.win_accumulate(x, "wa")
        out["nw_collect"] = bf.win_update_then_collect("wa")
        out["nw_p"] = bf.win_associated_p("wa")
    finally:
        bf.turn_off_win_ops_with_associated_p()
    bf.win_get("wc")
    out["nw_get_recv"] = nw._registry["wc"].window.recv
    out["nw_version"] = torch.from_numpy(bf.get_win_version("wc"))
    out["nw_stamps"] = torch.from_numpy(bf.get_win_stamps("wc"))
    out["nw_staleness"] = torch.from_numpy(bf.win_staleness("wc"))
    bf.win_free()
    return out


def async_checks(dist) -> Dict[str, torch.Tensor]:
    """6 ticks of async window gossip on Exp2 with rank 3 at pace 3 and
    bound 1: its forced sync-ups take a MAX through the process group."""
    n = bf.size()
    bf.set_topology(tu.ExponentialTwoGraph(n))
    x = dist("window")
    strat = bfopt.async_window_gossip(
        bfopt.sgd(0.1), bfopt.push_schedule(bf.load_topology(), n),
        staleness_bound=1, pace=[3 if r == 3 else 1 for r in range(n)])
    target = x[:, :1] * 2

    def grad_fn(params, batch):
        p = params["w"].detach().requires_grad_()
        loss = torch.mean((p - batch) ** 2)
        loss.backward()
        return loss.detach(), {"w": p.grad}

    params = {"w": x.clone()}
    state = bfopt.init_distributed(strat, params)
    step = bfopt.make_train_step(grad_fn, strat)
    for _ in range(6):
        params, state, _ = step(params, state, target)
    cs = state.comm_state
    return {"async_w": params["w"], "async_p": cs.p,
            "async_depth": cs.depth, "async_force": cs.force,
            "async_stamps": cs.stamps,
            "async_local_steps": bf.allgather(
                cs.local_steps[:, None].contiguous())[0]}


def run_checks(device, only: Optional[str] = None
               ) -> Dict[str, torch.Tensor]:
    """Every check on the live context (``only="windows"``: the named
    windows alone); returns this process's results (its block of every
    per-rank one, :data:`REPLICATED` whole)."""
    n = bf.size()
    ctx = bf.get_context()
    data = inputs(n)

    def dist(key):
        return bf.shard_distributed(torch.from_numpy(np.array(data[key])))

    def whole(key):
        return torch.from_numpy(np.array(data[key])).to(device)

    if only == "windows":
        out = {**named_window_checks(dist), **async_checks(dist)}
        bf.barrier()
        return {k: v.detach().cpu() for k, v in out.items()}

    # the process layout: world, rows, machines, and how they were found
    out = {"layout": torch.tensor([
        ctx.world, ctx.rows, ctx.nodes_per_machine, ctx.machine_size,
        int(ctx.hierarchical == "auto"),
        int(bool(ctx.machine_topology_weighted))])}
    bf.set_topology(tu.RingGraph(n), is_weighted=True)
    out["ring"], seq = count_p2p(lambda: bf.neighbor_allreduce(
        dist("ramp3")))
    # round-parallel emission: the same result, every round's crossing
    # rows in one message a process pair
    bf.set_round_parallel(True)
    out["ring_rp"], rp = count_p2p(lambda: bf.neighbor_allreduce(
        dist("ramp3")))
    bf.set_round_parallel(None)
    out["rand_int8@4_rp"], rp_wire = count_p2p(
        lambda: bf.neighbor_allreduce(dist("rand"), wire="int8@4",
                                      concurrent=True))
    for w in WIRES:
        out["ring_" + w] = bf.neighbor_allreduce(dist("ramp8"), wire=w)
        out["rand_" + w] = bf.neighbor_allreduce(dist("rand"), wire=w)
    bf.set_topology(tu.ExponentialTwoGraph(n))
    out["expo2"] = bf.neighbor_allreduce(dist("rand"))
    out["nag"] = bf.neighbor_allgather(dist("gather"))
    lengths = data["lengths"][ctx.first_rank:ctx.first_rank + ctx.rows]
    out["rnag"], out["rnag_len"] = bf.ragged_neighbor_allgather(
        dist("ragged"), lengths)
    out["pair"] = bf.pair_gossip(dist("rand"), PARTNERS,
                                 self_weight=0.25, pair_weight=0.75)
    out["allreduce"] = bf.allreduce(dist("rand"))
    out["allreduce_sum"] = bf.allreduce(dist("rand"), average=False)
    out["allgather"] = bf.allgather(dist("gather"))
    out["rag"], out["rag_len"] = bf.ragged_allgather(dist("ragged"),
                                                     lengths)
    out["broadcast"] = bf.broadcast(dist("rand"), ROOT)
    # hierarchical: the machines (a process's block across processes) on
    # a weighted ring
    bf.set_machine_topology(tu.RingGraph(bf.machine_size()),
                            is_weighted=True)
    out["hier"] = bf.hierarchical_neighbor_allreduce(dist("rand"))
    for kind, wire in (("ring", None), ("expo2", "int8")):
        topo = tu.RingGraph(n) if kind == "ring" else \
            tu.ExponentialTwoGraph(n)
        sched = sch_mod.compile_topology(topo, kind == "ring")
        for i, v in enumerate(window_sequence(wops, sched, dist("window"),
                                              wire)):
            out[f"win_{kind}_{i}"] = v
        out[f"pull_{kind}"] = wops.win_pull(dist("window"), sched,
                                            wire=wire)
    out.update(named_window_checks(dist))
    out.update(async_checks(dist))
    # ZeRO-1 over 5 train steps (tests/test_multihost.py's)
    def grad_fn(params, batch):
        p = params["w"].detach().requires_grad_()
        loss = torch.mean((p - batch) ** 2)
        loss.backward()
        return loss.detach(), {"w": p.grad}

    strat = bfopt.zero_gradient_allreduce(bfopt.sgd(0.2))
    params = {"w": dist("ramp3").repeat(1, 2)[:, :5].contiguous()}
    state = bfopt.init_distributed(strat, params)
    step = bfopt.make_train_step(grad_fn, strat)
    target = torch.full((ctx.rows, 5), 2.0, device=device)
    losses, zero_calls = [], 0
    for k in range(5):
        (params, state, loss), calls = count_p2p(
            lambda: step(params, state, target))
        zero_calls += calls
        out[f"zero_loss_{k}"] = loss
        losses.append(bf.allreduce(loss[:, None])[0, 0])
    out["zero_w"] = params["w"]
    out["zero_loss_mean"] = torch.stack(losses)
    out["p2p_calls"] = torch.tensor([seq, rp, rp_wire, zero_calls])
    # GPipe across the rank axis, with its gradients
    w = dist("pp_w").requires_grad_()
    y = pipe.pipeline_apply(lambda p, x: torch.tanh(torch.bmm(x, p)),
                            w, whole("pp_mb"), axis="rank")
    loss = ((y - whole("pp_tgt")) ** 2).mean()
    loss.backward()
    out["pp_out"], out["pp_loss"] = y.detach(), loss.detach()
    out["pp_grad"] = w.grad
    # 1F1B across the rank axis
    lz, gz = pipe.pipeline_1f1b_grad(
        lambda p, x: torch.tanh(torch.bmm(x, p)),
        lambda y, t: ((y - t) ** 2).mean(), dist("pp_w"), whole("pp_mb"),
        whole("pp_tgt"), axis="rank")
    out["f1b_loss"], out["f1b_grad"] = lz, gz
    # interleaved: 2 chunks a rank, the ring's S-1 -> 0 wrap crosses too
    wi = dist("il_w").requires_grad_()
    yi = pipe.pipeline_interleaved_apply(
        lambda p, x: torch.tanh(torch.bmm(x, p)), wi, whole("pp_mb"),
        axis="rank")
    yi.square().mean().backward()
    out["il_out"], out["il_grad"] = yi.detach(), wi.grad
    # stage lists: embed | n - 2 blocks | head, stage 0 reading tokens
    trees = ([{"embed": torch.from_numpy(data["st_embed"])}]
             + [{"w": torch.from_numpy(w)} for w in data["st_w"]]
             + [{"head": torch.from_numpy(data["st_head"])}])
    packed, unpacks = pipe.pack_stage_params(trees)
    ws = bf.shard_distributed(packed).requires_grad_()
    fns = ([lambda p, t: p["embed"][t]]
           + [lambda p, x: x + torch.tanh(x @ p["w"])] * (n - 2)
           + [lambda p, x: x @ p["head"]])
    ys = pipe.pipeline_apply_stages(
        fns, unpacks, ws, whole("st_tokens"),
        boundary_shapes=[(2, 5, 4)] * (n - 1) + [(2, 5, 16)], axis="rank")
    ys.square().mean().backward()
    out["st_out"], out["st_grad"] = ys.detach(), ws.grad
    bf.barrier()
    return {k: v.detach().cpu() for k, v in out.items()}


def join(blocks) -> Dict[str, torch.Tensor]:
    """The processes' results (in process order) as whole results:
    per-rank blocks concatenated, replicated ones checked equal."""
    got = {}
    for key in blocks[0]:
        parts = [b[key] for b in blocks]
        if key in REPLICATED:
            for p in parts[1:]:
                if not torch.equal(p, parts[0]):
                    raise AssertionError(f"{key} differs across processes")
            got[key] = parts[0]
        else:
            got[key] = torch.cat(parts)
    return got


def reference(size: int, nodes_per_machine: int, device="cpu",
              only: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The checks in one process (``nodes_per_machine`` as the
    multi-process run's machines)."""
    bf.init(size=size, device=device, nodes_per_machine=nodes_per_machine)
    try:
        return run_checks(torch.device(device), only)
    finally:
        bf.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(nproc: int, size: int, out_dir, device: str = "cpu",
          timeout: float = 120.0, threads: int = 1,
          env: Optional[Dict[str, str]] = None,
          only: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Run :func:`run_checks` in ``nproc`` processes (torchrun's
    variables; gloo on the CPU, NCCL on ``cuda``) and join their results.
    Each process has ``timeout`` seconds: a hung rendezvous fails the
    call, and every process is stopped.  ``env`` adds variables."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    root = Path(__file__).resolve().parents[2]
    port = str(_free_port())
    procs = []
    for p in range(nproc):
        penv = dict(os.environ, **(env or {}), RANK=str(p),
                    WORLD_SIZE=str(nproc),
                    LOCAL_RANK=str(p) if device != "cpu" else "0",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                    OMP_NUM_THREADS=str(threads),
                    PYTHONPATH=os.pathsep.join(
                        [str(root)] + [v for v in [os.environ.get(
                            "PYTHONPATH")] if v]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "bluefog_tpu_torch.tools.world_check",
             "--out", str(out_dir), "--size", str(size), "--device", device,
             "--threads", str(threads), "--timeout", str(timeout)]
            + (["--only", only] if only else []),
            cwd=root, env=penv, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for proc in procs:
            left = max(deadline - time.monotonic(), 1.0)
            logs.append(proc.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        tails = [proc.communicate()[0][-1500:] for proc in procs]
        raise AssertionError(f"world_check: {nproc} processes did not end "
                             f"within {timeout} s:\n" + "\n".join(tails))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for p, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            raise AssertionError(f"world_check process {p} exited "
                                 f"{proc.returncode}:\n{log[-3000:]}")
    return join([torch.load(out_dir / f"proc{p}.pt") for p in range(nproc)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--size", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda:LOCAL_RANK, NCCL)")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch threads (default: torch's)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="dump the stacks and exit after this many seconds")
    ap.add_argument("--only", default=None, choices=["windows"],
                    help="run only the named-window checks")
    args = ap.parse_args(argv)
    if args.timeout:
        import faulthandler
        faulthandler.dump_traceback_later(max(args.timeout - 5, 1),
                                          exit=True)
    if args.threads:
        torch.set_num_threads(args.threads)
    ctx = bf.init(size=args.size, device=args.device)
    try:
        got = run_checks(ctx.device, args.only)
        torch.save(got, Path(args.out) / f"proc{ctx.process}.pt")
        print(f"process {ctx.process} of {ctx.world} ({ctx.rows} ranks, "
              f"{ctx.device}): {len(got)} results", flush=True)
    finally:
        bf.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
