"""Collectives over stacked ranks (counterpart of
``bluefog_tpu/ops/collectives.py``).

The JAX ops run inside ``shard_map`` with one block per device.  This is
the single-process *stacked* backend: the ranks live along dim 0 of every
tensor (the JAX API's ``[n_ranks, ...]`` layout), and a ``ppermute`` over
a round's ``(src, dst)`` pairs is a gather along dim 0 by the round's
``recv_src`` table that zero-fills ranks receiving nothing, as
``lax.ppermute`` does.  The weighted combine and the wire codecs
(``bf16``, ``int8``, ``fp8``, optionally ``@B``-blocked) are plain torch:
in JAX they are XLA-fused elementwise passes, not Pallas kernels.  Each
rank encodes its own buffer (its own amax scale), as each JAX device
does; the quantized KV store shares the amax scaling.

The composed carving's intra-replica collectives act on one named axis
of a ``[dp, pp, tp, sp, ...]`` view, which is a dim of a stacked tensor
here: :func:`psum` / :func:`pmean` over a dim, :func:`ppermute` along
it, and the tiled :func:`all_to_all`.  Each is plain tensor ops, so
autograd gives its transpose: ``psum``'s is the same sum of the
cotangents (the JAX transpose under ``check_vma=False``), ``ppermute``'s
the permutation back, ``all_to_all``'s the all-to-all with split and
concat swapped.

Across processes (:mod:`bluefog_tpu_torch.parallel.context` launched by
torchrun) each process holds a contiguous block of the global rank axis,
and every row that moves between ranks goes through :func:`_permute`:
the rows whose source is in the same process are gathered locally, and
the rows that cross go through ``torch.distributed.batch_isend_irecv``,
one message per process pair and round carrying every row that crosses
(one a pair for all the rounds of a gossip step under ``concurrent=True``
/ :func:`~bluefog_tpu_torch.parallel.context.set_round_parallel`).
That move is an autograd function whose backward is the reverse move,
so gradients cross the boundary as ``jax.grad`` through ``ppermute``
does.  The per-rank tables of a schedule stay global; each process reads
its block of them (:func:`_local`).  The reductions over the rank axis
(:func:`allreduce`, :func:`allgather`, :func:`broadcast`,
:func:`rank_sum`, :func:`rank_max`) go through the process group.  The peer-dim
collectives of a composed carving stay inside one process: a replica's
peers never straddle a process boundary (``compose_parallelism`` refuses
such a carving).

Each collective records itself in an armed wire-byte ledger
(:mod:`bluefog_tpu_torch.utils.wire_bytes`, the autotuner's byte count):
the moved rows of every round (the codec's own arrays under a wire, not
the raw bytes they travel as), the sums, gathers and all-to-alls, as the
JAX op each stands for.  The peer-dim ops take ``lead``, the dims of
their tensor that stack chips, so each chip is charged its share.
Disarmed, a collective reads one module flag.

Under a profiler (``torch.profiler``, ``utils.timeline``) each move runs
inside a ``record_function`` range ``bluefog::<op>``, ``<op>`` the JAX op
it stands for (``neighbor_allreduce``, ``psum``, ``ppermute``,
``all_to_all``, ``allreduce``, the window ops, ``cross`` for the rows
that cross processes), and so does each autograd node of the move when
the backward runs: :mod:`bluefog_tpu_torch.tools.trace_analyze` counts
the device work launched inside those ranges as communication.  The
range covers the moves only (the gathers, zero fills, peer sums and
process-group calls); the weighted combine and the wire codecs stay
outside, as JAX's classifier counts them as compute.  With no profiler
running a move reads one flag and makes no range.
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..schedule import CommSchedule
from ..utils import wire_bytes as _wb

__all__ = ["neighbor_allreduce", "hierarchical_neighbor_allreduce",
           "neighbor_allgather", "ragged_neighbor_allgather", "pair_gossip",
           "allreduce", "allgather", "broadcast", "rank_sum", "rank_max",
           "psum",
           "peer_sum",
           "pmean", "ppermute", "all_to_all", "WIRE_CODECS",
           "_amax_scale", "_parse_wire", "_check_wire", "_wire_encode",
           "_wire_decode", "_default_dcn_wire", "_default_concurrent"]

_TINY = float(np.finfo(np.float32).tiny)

#: the prefix of every communication range in a profiler trace
COMM_PREFIX = "bluefog::"
_tracing = torch._C._autograd._profiler_enabled
_NO_RANGE = contextlib.nullcontext()


def _range(op: str):
    """The range ``bluefog::<op>`` under a profiler, else a shared no-op
    context."""
    if not _tracing():
        return _NO_RANGE
    return torch.autograd.profiler.record_function(COMM_PREFIX + op)


def _move(op: str, fn, x, *args):
    """``fn(x, *args)``, a move between ranks or peers (``x`` a tensor or
    a list of them).  Under a profiler it runs inside ``bluefog::<op>``,
    and each autograd node between its output and ``x`` opens the same
    range around its backward (:func:`_range_backward`)."""
    if not _tracing():
        return fn(x, *args)
    with torch.autograd.profiler.record_function(COMM_PREFIX + op):
        out = fn(x, *args)
    _range_backward(COMM_PREFIX + op, out, x)
    return out


def _tensors(x) -> list:
    return [t for t in (x if isinstance(x, (list, tuple)) else [x])
            if isinstance(t, torch.Tensor)]


def _range_backward(name: str, out, ins) -> None:
    """Hook every autograd node from ``out`` back to ``ins`` (its inputs'
    nodes and the leaves' accumulators excluded) so that its backward
    runs inside the range ``name``: the transpose of the move is a move
    too, and autograd's own backward computes it."""
    stop = {t.grad_fn for t in _tensors(ins) if t.grad_fn is not None}
    todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or node in stop or node in seen or \
                type(node).__name__ == "AccumulateGrad":
            continue
        seen.add(node)
        opened = []

        def enter(grad_outputs, opened=opened):
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            opened.append(rf)

        def leave(grad_inputs, grad_outputs, opened=opened):
            if opened:
                opened.pop().__exit__(None, None, None)

        node.register_prehook(enter)
        node.register_hook(leave)
        todo.extend(nxt for nxt, _ in node.next_functions)


WIRE_CODECS = ("bf16", "int8", "fp8")


def _parse_wire(wire: str) -> Tuple[str, Optional[int]]:
    """``"int8"`` -> (int8, None); ``"int8@256"`` -> (int8, 256).

    The ``@B`` suffix switches the quantizers from one amax scale per
    buffer to one per B-element block; bf16 is a plain cast and takes no
    block size."""
    if not isinstance(wire, str):
        raise ValueError(
            f"unknown wire codec {wire!r}: pass one of {WIRE_CODECS} "
            "(optionally with an @B block-size suffix for int8/fp8)")
    base, sep, blk = wire.partition("@")
    if not sep:
        return base, None
    if base == "bf16":
        raise ValueError("bf16 is a plain cast; block size applies only "
                         "to the quantizing codecs (int8/fp8)")
    try:
        b = int(blk)                  # "" raises too: "int8@" is malformed
    except ValueError:
        b = 0
    if b <= 0:
        raise ValueError(f"bad wire block size in {wire!r}")
    return base, b


def _check_wire(wire: str) -> str:
    """Validate a wire-codec spec eagerly (base + optional @B block
    size), so a typo fails where it is set rather than at encode time."""
    base, _ = _parse_wire(wire)
    if base not in WIRE_CODECS:
        raise ValueError(
            f"unknown wire codec {wire!r}: pass one of {WIRE_CODECS} "
            "(optionally with an @B block-size suffix for int8/fp8)")
    return wire


def _block(xf: torch.Tensor, blk: int, lead: int) -> torch.Tensor:
    """Flatten each buffer (the dims after the first ``lead``), zero-pad
    it to a multiple of ``blk`` and cut it into ``[nb, blk]`` rows."""
    flat = xf.reshape(tuple(xf.shape[:lead]) + (-1,))
    pad = (-flat.shape[-1]) % blk
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(tuple(xf.shape[:lead]) + (-1, blk))


def _amax_scale(xf: torch.Tensor, qmax: float, blk: Optional[int],
                lead: int = 0):
    """(scaled values ready to cast, riding scale(s)).  Per buffer when
    ``blk`` is None (the first ``lead`` dims index independent buffers,
    e.g. the stacked ranks; with none, one scalar scale), else one scale
    per row of the last dim.  The scale is floored at the smallest normal
    f32: for a subnormal amax the division would underflow to 0 and
    ``xf / scale`` become inf, which e4m3fn (no inf) would turn into NaN.
    With the floor, tiny payloads quantize to 0.  The step is ``amax *
    f32(1 / qmax)``, not ``amax / qmax``: XLA rewrites a division by a
    constant so in a compiled program, and the JAX package runs its gossip
    codecs and its KV store compiled."""
    if blk is not None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    elif lead:
        amax = xf.abs().amax(dim=tuple(range(lead, xf.ndim)), keepdim=True)
    else:
        amax = xf.abs().max()
    step = amax * torch.tensor(1.0 / qmax, dtype=amax.dtype)
    scale = torch.where(amax > 0, torch.clamp(step, min=_TINY),
                        torch.ones_like(amax))
    return xf / scale, scale.to(torch.float32)


def _wire_encode(wire: str, x: torch.Tensor, lead: int = 0
                 ) -> Tuple[torch.Tensor, ...]:
    """Compress ``x`` for the wire (``_wire_encode`` of the JAX package
    as it runs compiled, bit for bit): ``bf16`` a plain cast; ``int8`` symmetric quantization
    (round half to even, clip to +-127) with an f32 amax scale riding
    beside; ``fp8`` an e4m3fn cast of the amax-scaled values.  An ``@B``
    suffix scales per B-element block.  The first ``lead`` dims index
    independent buffers (one scale set each: the stacked ranks)."""
    base, blk = _parse_wire(wire)
    if base == "bf16":
        return (x.to(torch.bfloat16),)
    if base in ("int8", "fp8"):
        xf = x.to(torch.float32)
        if blk is not None:
            xf = _block(xf, blk, lead)
        if base == "int8":
            scaled, scale = _amax_scale(xf, 127.0, blk, lead)
            q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
        else:
            f8max = float(torch.finfo(torch.float8_e4m3fn).max)    # 448
            scaled, scale = _amax_scale(xf, f8max, blk, lead)
            q = scaled.to(torch.float8_e4m3fn)
        return (q, scale)
    raise ValueError(f"unknown wire codec {wire!r}; choose from "
                     f"{WIRE_CODECS} (quantizers accept an '@B' block "
                     "suffix, e.g. 'int8@256')")


def _wire_decode(wire: str, parts: Sequence[torch.Tensor], dtype,
                 shape=None, lead: int = 0) -> torch.Tensor:
    """Inverse of :func:`_wire_encode`; ``shape`` is the encoded tensor's
    (needed to drop a blocked codec's padding)."""
    base, blk = _parse_wire(wire)
    if base == "bf16":
        return parts[0].to(dtype)
    q, scale = parts
    out = q.to(torch.float32) * scale         # broadcasts per block too
    if blk is not None:
        shape = tuple(shape)
        size = int(np.prod(shape[lead:], dtype=np.int64))
        out = out.reshape(shape[:lead] + (-1,))[..., :size].reshape(shape)
    return out.to(dtype)


def _default_dcn_wire() -> Optional[str]:
    """Default wire codec of hierarchical gossip's machine hop: the
    context's knob (:func:`bluefog_tpu_torch.parallel.context.set_dcn_wire`),
    else ``BLUEFOG_DCN_WIRE``.  Flat gossip keeps its explicit ``wire=``."""
    from ..parallel import context as _ctx
    c = _ctx._context
    if c is not None and c.dcn_wire is not None:
        return c.dcn_wire if c.dcn_wire != "off" else None
    w = os.environ.get("BLUEFOG_DCN_WIRE", "").strip()
    if w and w.lower() not in ("off", "none", "0"):
        return _check_wire(w)   # a typo'd codec must not fall back silently
    return None


def _default_concurrent() -> bool:
    """Round-parallel default of :func:`neighbor_allreduce`: the context's
    knob, else ``BLUEFOG_ROUND_PARALLEL``."""
    from ..parallel import context as _ctx
    from ..utils.config import env_flag
    c = _ctx._context
    if c is not None and c.round_parallel is not None:
        return bool(c.round_parallel)
    return env_flag("BLUEFOG_ROUND_PARALLEL", False)


def _procs() -> Tuple[int, int]:
    """``(world, process)`` of the live context; ``(1, 0)`` without one."""
    from ..parallel import context as _ctx
    c = _ctx._context
    return (c.world, c.process) if c is not None else (1, 0)


def _local(table, rows: int) -> np.ndarray:
    """This process's entries of a global table with one entry a rank (or
    a machine): the whole table when it has one entry a row of the local
    tensor, else the process's block of a table over every process's
    rows."""
    table = np.asarray(table)
    if len(table) == rows:
        return table
    world, process = _procs()
    if len(table) != world * rows:
        raise ValueError(f"a table of {len(table)} entries does not fit "
                         f"{rows} rows on each of {world} processes")
    return table[process * rows:(process + 1) * rows]


def _table(row: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Per-rank table entries as a ``[n, 1, ...]`` column in x's dtype
    (this process's ``n`` of them)."""
    t = torch.as_tensor(_local(row, x.shape[0]),
                        device=x.device).to(x.dtype)
    return t.reshape((x.shape[0],) + (1,) * (x.ndim - 1))


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _p2p(sends, recvs, dtype, device) -> List[torch.Tensor]:
    """One ``batch_isend_irecv``: ``sends`` ``[(process, tensor)]`` and
    ``recvs`` ``[(process, shape)]``; the messages travel as raw bytes
    (every dtype, fp8 and bool too).  Returns the received tensors."""
    import torch.distributed as dist
    item = torch.empty((), dtype=dtype).element_size()
    bufs = [torch.empty(int(np.prod(shape, dtype=np.int64)) * item,
                        dtype=torch.uint8, device=device)
            for _, shape in recvs]
    ops = [dist.P2POp(dist.irecv, b, q) for b, (q, _) in zip(bufs, recvs)]
    ops += [dist.P2POp(dist.isend, _as_bytes(t), q) for q, t in sends]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.view(dtype).reshape(shape) for b, (_, shape) in
            zip(bufs, recvs)]


class _Cross(torch.autograd.Function):
    """The rows of one or more rounds that cross processes.  ``plan`` is
    ``(outs, ins)``: ``outs`` ``[(process, [(round, rows)])]``, the rows
    of each round's send that go to a process, and ``ins`` ``[(process,
    [(round, count)])]``, how many rows of each round come from one.
    Forward: one message a process pair carrying every round's rows; the
    outputs are the received blocks in ``ins`` order.  Backward: the
    reverse move, the received rows' cotangents back to their senders,
    the sent rows' added into each round's ``send``.  The last output is
    an empty row block, so that every process holds a node of every move
    in its graph, and its backward runs (in the same order on every
    process) even where it received nothing."""

    @staticmethod
    def forward(ctx, plan, *sends):
        outs, ins = plan
        ctx.plan, ctx.shape = plan, sends[0].shape
        ctx.rounds = len(sends)
        row = tuple(sends[0].shape[1:])
        with _range("cross"):
            got = _p2p([(q, torch.cat([sends[r].index_select(0, idx)
                                       for r, idx in parts]))
                        for q, parts in outs],
                       [(q, (sum(k for _, k in parts),) + row)
                        for q, parts in ins], sends[0].dtype,
                       sends[0].device)
        blocks = [b for g, (_, parts) in zip(got, ins)
                  for b in g.split([k for _, k in parts])]
        return tuple(blocks) + (sends[0].new_zeros((0,) + row),)

    @staticmethod
    def backward(ctx, *grads):
        outs, ins = ctx.plan
        g0 = grads[-1]
        row = tuple(ctx.shape[1:])
        it = iter(grads[:-1])
        with _range("cross"):
            back = _p2p([(q, torch.cat([next(it) for _ in parts]))
                         for q, parts in ins],
                        [(q, (sum(len(idx) for _, idx in parts),) + row)
                         for q, parts in outs], g0.dtype, g0.device)
            dsends = [g0.new_zeros(ctx.shape) for _ in range(ctx.rounds)]
            for (_, parts), g in zip(outs, back):
                for (r, idx), gr in zip(parts, g.split(
                        [len(idx) for _, idx in parts])):
                    dsends[r].index_add_(0, idx, gr)
        return (None,) + tuple(dsends)


def _permute(send: torch.Tensor, src: np.ndarray, lead: int = 1,
             op: str = "ppermute") -> torch.Tensor:
    """One round: rank d receives ``send[src[d]]``; ``src[d] < 0`` receives
    zeros.  ``src`` is over every process's rows when ``send`` is this
    process's block of them: the rows that cross processes then travel
    through :class:`_Cross`.  ``lead``: the dims of ``send`` that stack
    chips (a row holds ``prod(shape[1:lead])`` of them), for the wire-byte
    ledger; ``op``: the JAX op the move stands for (its profiler
    range)."""
    return _permute_rounds([send], [src], lead=lead, op=op)[0]


def _permute_rounds(sends: Sequence[torch.Tensor],
                    srcs: Sequence[np.ndarray], *, lead: int = 1,
                    record: bool = True, op: str = "ppermute"
                    ) -> List[torch.Tensor]:
    """:func:`_permute` of each ``sends[r]`` by ``srcs[r]`` (the sends
    share their row shape and dtype).  Across processes every round's
    crossing rows travel together, one message a process pair.  An armed
    wire-byte ledger records each round's moved rows (``record=False``:
    the caller recorded them itself)."""
    srcs = [np.asarray(src) for src in srcs]
    if _wb._armed is None or not record:
        return _move(op, _permute_rounds_impl, sends, srcs)
    row = [(sends[0].dtype, _wb.nbytes(sends[0]) // max(len(sends[0]), 1))]
    events = _record_moves(sends[0], srcs, lead, [row] * len(srcs))
    got = _move(op, _permute_rounds_impl, sends, srcs)
    return [_wb.transpose_on_backward(g, ev) for g, ev in zip(got, events)]


def _record_moves(send: torch.Tensor, srcs, lead: int, parts):
    """The armed ledger's records of each round's moved rows: ``send``
    is a round's ``[rows, ...]`` (its first ``lead`` dims stack chips),
    ``parts[r]`` the arrays a row of round ``r`` carries, ``(dtype,
    bytes)`` each."""
    rows = send.shape[0]
    first = _procs()[1] * rows if any(len(s) != rows for s in srcs) else 0
    c = _wb.peers(send, lead) // max(rows, 1)
    return [_wb._armed.moves([src], rows, first, c, part)
            for src, part in zip(srcs, parts)]


def _permute_rounds_impl(sends: Sequence[torch.Tensor],
                         srcs: Sequence[np.ndarray]) -> List[torch.Tensor]:
    rows = sends[0].shape[0]
    dev = sends[0].device
    if all(len(src) == rows for src in srcs):
        got = []
        for send, src in zip(sends, srcs):
            recv = send.index_select(0, torch.as_tensor(
                np.clip(src, 0, None), dtype=torch.long, device=dev))
            if (src < 0).any():
                keep = torch.as_tensor(src >= 0, device=dev)
                recv = recv * keep.reshape(
                    (-1,) + (1,) * (send.ndim - 1)).to(recv.dtype)
            got.append(recv)
        return got
    world, p = _procs()
    if any(len(src) != world * rows for src in srcs):
        raise ValueError(f"a round over {len(srcs[0])} ranks does not fit "
                         f"{rows} rows on each of {world} processes")
    peers = [q for q in range(world) if q != p]
    outs = {q: [] for q in peers}
    ins = {q: [] for q in peers}
    takes = []
    for r, src in enumerate(srcs):
        mine = src[p * rows:(p + 1) * rows]
        owner = np.where(mine >= 0, mine // rows, -1)
        take = np.full(rows, -1, dtype=np.int64)
        take[owner == p] = mine[owner == p] - p * rows
        at = rows
        for q in peers:
            qsrc = src[q * rows:(q + 1) * rows]
            out = qsrc[(qsrc >= 0) & (qsrc // rows == p)] - p * rows
            if out.size:
                outs[q].append((r, torch.as_tensor(out, device=dev)))
            into = np.flatnonzero(owner == q)
            if into.size:
                ins[q].append((r, int(into.size)))
                take[into] = at + np.arange(into.size)
                at += into.size
        takes.append((take, at))
    outs = [(q, parts) for q, parts in outs.items() if parts]
    ins = [(q, parts) for q, parts in ins.items() if parts]
    pools = [[send] for send in sends]
    if outs or ins:
        blocks = iter(_Cross.apply((outs, ins), *sends))
        for _, parts in ins:
            for r, _ in parts:
                pools[r].append(next(blocks))
        pools[0].append(next(blocks))       # the empty block, into the graph
    got = []
    for send, pool, (take, at) in zip(sends, pools, takes):
        if (take < 0).any():
            pool.append(send.new_zeros((1,) + tuple(send.shape[1:])))
            take[take < 0] = at
        pool = torch.cat(pool) if len(pool) > 1 else send
        got.append(pool.index_select(0, torch.as_tensor(take, device=dev)))
    return got


def _wire_permute(wire: Optional[str], send: torch.Tensor, src: np.ndarray,
                  lead: int = 1, parts=None, op: str = "ppermute"
                  ) -> torch.Tensor:
    """One round, optionally wire-compressed (``_wire_ppermute`` of the
    JAX package): each of the first ``lead`` dims' buffers is encoded,
    the codes and scales travel (zero-filled where nothing arrives, so a
    rank receiving nothing decodes zeros), and the receiver decodes.
    ``parts`` passes ``send``'s encoding when the caller has it."""
    return _wire_permute_rounds(wire, [send], [src], lead, parts, op)[0]


def _wire_permute_rounds(wire: Optional[str], sends, srcs, lead: int = 1,
                         parts=None, op: str = "ppermute"
                         ) -> List[torch.Tensor]:
    """:func:`_wire_permute` of each ``sends[r]`` by ``srcs[r]``, moved by
    one :func:`_permute_rounds` (the codecs outside its range); ``parts``
    is the encoding every send shares when the caller has it."""
    if wire is None:
        return _permute_rounds(sends, srcs, lead=lead, op=op)
    if not sends[0].is_floating_point():
        # complex would silently lose its imaginary part in the codecs
        raise ValueError(
            f"wire compression needs a real float input, got "
            f"{sends[0].dtype}")
    encoded = [parts if parts is not None else _wire_encode(wire, s, lead)
               for s in sends]
    # the codes and scales travel together, as one row of raw bytes a
    # rank (one message a process pair across processes)
    n = sends[0].shape[0]
    if _wb._armed is not None:
        # the codec's own arrays (codes, scales), not the bytes they
        # travel as
        _record_moves(sends[0], [np.asarray(s) for s in srcs], lead,
                      [[(q.dtype, _wb.nbytes(q) // max(n, 1)) for q in e]
                       for e in encoded])
    raws = [[q.contiguous().view(n, -1).view(torch.uint8) for q in e]
            for e in encoded]
    moved = _permute_rounds([torch.cat(raw, dim=1) if len(raw) > 1
                             else raw[0] for raw in raws], srcs,
                            record=False, op=op)
    out = []
    for send, e, raw, m in zip(sends, encoded, raws, moved):
        got, at = [], 0
        for q, r in zip(e, raw):
            # a fresh copy: a view's byte offset need not align to q's
            # dtype
            got.append(m[:, at:at + r.shape[1]].clone(
                memory_format=torch.contiguous_format).view(q.dtype)
                       .reshape(q.shape))
            at += r.shape[1]
        out.append(_wire_decode(wire, got, send.dtype, shape=send.shape,
                                lead=lead))
    return out


def _check_ranks(x: torch.Tensor, n: int, what: str) -> None:
    """``x`` stacks this process's ranks of ``n``: all of them in one
    process, its block of them across processes."""
    world, _ = _procs()
    want = n // world if world > 1 and n % world == 0 else n
    if x.ndim < 1 or x.shape[0] != want:
        raise ValueError(f"{what} wants a stacked [n={want}, ...] tensor, "
                         f"got shape {tuple(x.shape)}")


def neighbor_allreduce(x: torch.Tensor, sched: CommSchedule, *,
                       wire: Optional[str] = None,
                       concurrent: Optional[bool] = None,
                       lead: int = 1) -> torch.Tensor:
    """Weighted average of each rank's row with its in-neighbors' under
    ``sched``: ``self_weight * x + sum_r recv_weight[r] * permute_r(send_r)``
    with ``send_r = x * send_scale[r]`` under dst-weighting, rank by rank
    exactly the JAX op's combine.  ``wire`` compresses what each round
    moves (``"bf16"``, ``"int8"``, ``"fp8"``, ``"@B"`` blocks for the
    quantizers); the self term stays full precision.  ``lead`` is the
    number of leading dims that index devices, each encoding its own
    buffer: the rank, and in a composed carving the replica's peers
    (``x`` then ``[n, slice, ...]``).  ``concurrent`` (default
    :func:`_default_concurrent`) moves every round at once: across
    processes, one message a process pair for all the rounds instead of
    one a round.  The rounds combine in round order either way, so the
    result is the same."""
    _check_ranks(x, sched.size, "neighbor_allreduce")
    if concurrent is None:
        concurrent = _default_concurrent()
    acc = x * _table(sched.self_weight, x)
    # without dst-weighting every round sends x: encode it once
    parts = (_wire_encode(wire, x, lead) if wire is not None
             and x.is_floating_point() and sched.num_rounds
             and not sched.uses_dst_weighting else None)
    sends = [x * _table(sched.send_scale[r], x)
             if sched.uses_dst_weighting else x
             for r in range(sched.num_rounds)]
    op = "neighbor_allreduce"
    if concurrent and sends:
        recvs = _wire_permute_rounds(wire, sends, sched.recv_src, lead,
                                     parts, op)
    else:
        recvs = [_wire_permute(wire, send, src, lead, parts, op)
                 for send, src in zip(sends, sched.recv_src)]
    for r, recv in enumerate(recvs):
        acc = acc + recv * _table(sched.recv_weight[r], x)
    return acc


def hierarchical_neighbor_allreduce(
        x: torch.Tensor, machine_sched: CommSchedule, *,
        wire: Optional[str] = None,
        concurrent: Optional[bool] = None) -> torch.Tensor:
    """Machine-level neighbor averaging: the mean over each machine's
    local ranks (the JAX op's ``pmean`` over the local axis: the sum, then
    / local size), then gossip of the machine means under
    ``machine_sched``, every local rank getting its machine's result.  The
    ``n`` stacked ranks are machine-major, ``n / machine_sched.size`` a
    machine.  ``wire`` compresses the machine-level permutes only; None
    resolves to the process default (:func:`_default_dcn_wire`), and
    ``"off"`` forces full width."""
    if wire is None:
        wire = _default_dcn_wire()
    elif wire == "off":
        wire = None
    world, _ = _procs()
    M = machine_sched.size
    n = x.shape[0] * world
    if x.ndim < 1 or n % M:
        raise ValueError(f"hierarchical_neighbor_allreduce: {n} stacked "
                         f"ranks are not {M} machines of equal size")
    L = n // M
    if x.shape[0] % L:
        raise ValueError(
            f"hierarchical_neighbor_allreduce: a machine of {L} ranks spans "
            f"processes of {x.shape[0]} ranks; a machine's mean stays inside "
            "one process (ROADMAP queue 1, item 12)")
    grouped = x.reshape((x.shape[0] // L, L) + tuple(x.shape[1:]))
    if _wb._armed is not None:         # the pmean over the local ranks
        _wb._armed.rank_reduce("all_reduce", x.dtype, _wb.nbytes(x)
                               // max(x.shape[0], 1), L)
    machine_avg = _move("pmean", lambda g: g.sum(dim=1), grouped) / L
    out = neighbor_allreduce(machine_avg, machine_sched, wire=wire,
                             concurrent=concurrent)
    return out.unsqueeze(1).expand_as(grouped).reshape(x.shape)


def neighbor_allgather(x: torch.Tensor, sched: CommSchedule) -> torch.Tensor:
    """Every rank's in-neighbors' blocks concatenated along the block's
    first dim, sorted by source rank: ``[n, d0, ...] -> [n, max_in_degree
    * d0, ...]``; a rank with a smaller in-degree leaves its trailing
    slots zero (reference: ``MPI_Neighbor_allgatherv``)."""
    _check_ranks(x, sched.size, "neighbor_allgather")
    rows, d0 = x.shape[0], x.shape[1]
    slots = max(sched.max_in_degree, 1)
    out = x.new_zeros((rows, slots, d0) + tuple(x.shape[2:]))
    for r in range(sched.num_rounds):
        recv = _permute(x, sched.recv_src[r], op="neighbor_allgather")
        got = np.flatnonzero(_local(sched.recv_src[r], rows) >= 0)
        if got.size:
            gi = torch.as_tensor(got, device=x.device)
            si = torch.as_tensor(_local(sched.recv_slot[r], rows)[got]
                                 .astype(np.int64), device=x.device)
            out[gi, si] = recv.index_select(0, gi)
    return out.reshape((rows, slots * d0) + tuple(x.shape[2:]))


def ragged_neighbor_allgather(x: torch.Tensor, length: torch.Tensor,
                              sched: CommSchedule
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neighbor allgather of padded ragged blocks in one collective chain:
    ``x [n, max_d0, ...]`` holds rank r's valid rows in ``x[r,
    :length[r]]``, and the 4-byte length rides as one extra row of the
    same byte buffer (everything travels as raw bytes).  Returns
    ``(gathered [n, max_in_degree * max_d0, ...], lengths [n,
    max_in_degree])`` sorted by source rank, zero where a rank has fewer
    in-neighbors."""
    orig = x.dtype
    if orig == torch.bool:
        x = x.to(torch.uint8)           # a 0/1 byte round-trips exactly
    elif orig.is_complex:
        x = torch.view_as_real(x)
    n, d0 = x.shape[0], x.shape[1]
    row = int(np.prod(x.shape[2:], dtype=np.int64))
    item = x.element_size()
    row_b = max(row * item, 1)
    W = max(row_b, 4)
    xb = x.contiguous().reshape(n, d0, -1).view(torch.uint8) \
        .reshape(n, d0, row_b)
    lb = torch.as_tensor(length, dtype=torch.int32, device=x.device) \
        .reshape(n, 1, 1).view(torch.uint8).reshape(n, 1, 4)
    buf = torch.cat([torch.nn.functional.pad(xb, (0, W - row_b)),
                     torch.nn.functional.pad(lb, (0, W - 4))], dim=1)
    g = neighbor_allgather(buf, sched)
    slots = max(sched.max_in_degree, 1)
    g = g.reshape(n, slots, d0 + 1, W)
    data = g[:, :, :d0, :row_b].contiguous().view(x.dtype) \
        .reshape((n, slots * d0) + tuple(x.shape[2:]))
    if orig == torch.bool:
        data = data.to(torch.bool)
    elif orig.is_complex:
        data = torch.view_as_complex(data.contiguous())
    lens = g[:, :, d0, :4].contiguous().view(torch.int32).reshape(n, slots)
    return data, lens


def pair_gossip(x: torch.Tensor, partners: Sequence[int], *,
                self_weight: float = 0.5,
                pair_weight: float = 0.5) -> torch.Tensor:
    """Exchange with a paired partner and weighted-average (reference:
    ``MPI_Sendrecv`` pair gossip): ``partners[i]`` is rank i's partner,
    the pairing an involution; a self-paired rank keeps its value."""
    partners = [int(q) for q in partners]
    n = len(partners)
    for i, q in enumerate(partners):
        if partners[q] != i:
            raise ValueError("partners must be a pairing (involution)")
    _check_ranks(x, n, "pair_gossip")
    src = np.array([q if q != i else -1 for i, q in enumerate(partners)])
    if (src < 0).all():
        return x
    recv = _permute(x, src, op="pair_gossip")
    paired = torch.as_tensor(_local(src >= 0, x.shape[0]), device=x.device)
    paired = paired.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(paired, x * self_weight + recv * pair_weight, x)


def rank_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the global rank axis (dim 0, kept as a dim of 1) on
    every process: the local rows' sum, then the process group's."""
    if _wb._armed is not None:
        _rank_record("all_reduce", x)
    return _move("allreduce", _rank_sum, x)


def _rank_sum(x: torch.Tensor) -> torch.Tensor:
    total = x.sum(dim=0, keepdim=True)
    if _procs()[0] > 1:
        import torch.distributed as dist
        total = total.contiguous()
        dist.all_reduce(total)
    return total


def _rank_record(kind: str, x: torch.Tensor, rounds: int = 1,
                 out_rows: int = 1):
    """An armed ledger's record of a collective over the rank axis of
    ``x`` (``[rows, ...]``, a chip a row): ``rounds`` ops of one row's
    bytes (times ``out_rows`` for an all-gather's result)."""
    n = x.shape[0] * _procs()[0]
    row = _wb.nbytes(x) // max(x.shape[0], 1)
    out = row * out_rows
    wire = out * (n - 1) // n if kind == "all_gather" else out
    for _ in range(rounds):
        _wb._armed.rank_reduce(kind, x.dtype, out, n, wire=wire)


def rank_max(x: torch.Tensor) -> torch.Tensor:
    """The max over the global rank axis (dim 0, kept as a dim of 1) on
    every process (``lax.pmax``): the local rows' max, then a MAX
    reduction through the process group."""
    if _wb._armed is not None:
        _rank_record("all_reduce", x)
    return _move("allreduce", _rank_max, x)


def _rank_max(x: torch.Tensor) -> torch.Tensor:
    top = x.amax(dim=0, keepdim=True)
    if _procs()[0] > 1:
        import torch.distributed as dist
        top = top.contiguous()
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
    return top


def allreduce(x: torch.Tensor, *, average: bool = True) -> torch.Tensor:
    """Every rank gets the sum (or mean) over the ranks."""
    total = rank_sum(x)
    if average:
        total = total / (x.shape[0] * _procs()[0])
    return _move("allreduce", lambda t: t.expand_as(x).clone(), total)


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Every rank gets all ranks' blocks concatenated along their dim 0:
    ``[n, d0, ...] -> [n, n * d0, ...]``."""
    rows = x.shape[0]
    world, _ = _procs()
    if _wb._armed is not None:
        _rank_record("all_gather", x, out_rows=rows * world)
    return _move("all_gather", _allgather, x)


def _allgather(x: torch.Tensor) -> torch.Tensor:
    rows = x.shape[0]
    if _procs()[0] > 1:
        import torch.distributed as dist
        parts = [torch.empty_like(x) for _ in range(_procs()[0])]
        dist.all_gather(parts, x.contiguous())
        x = torch.cat(parts)
    n = x.shape[0]
    flat = x.reshape((n * x.shape[1],) + tuple(x.shape[2:]))
    return flat.unsqueeze(0).expand((rows,) + tuple(flat.shape)).clone()


def broadcast(x: torch.Tensor, root_rank: int) -> torch.Tensor:
    """Every rank gets root's block."""
    rows = x.shape[0]
    world, _ = _procs()
    if not 0 <= root_rank < rows * world:
        raise ValueError(f"root_rank {root_rank} out of range for "
                         f"{rows * world} ranks")
    owner, r = divmod(root_rank, rows)
    if _wb._armed is not None:
        # the JAX op's binomial tree: ceil(log2 n) permute rounds
        _rank_record("collective_permute", x,
                     rounds=int(np.ceil(np.log2(max(rows * world, 1)))))
    return _move("broadcast", _broadcast, x, owner, r)


def _broadcast(x: torch.Tensor, owner: int, r: int) -> torch.Tensor:
    if _procs()[0] == 1:
        return x[r:r + 1].expand_as(x).clone()
    import torch.distributed as dist
    block = x[r:r + 1].contiguous() if owner == _procs()[1] else \
        torch.empty_like(x[:1])
    dist.broadcast(block, src=owner)
    return block.expand_as(x).clone()


# ---------------------------------------------------------------------------
# Collectives over one named axis of the stacked carving (a dim)
# ---------------------------------------------------------------------------

def _peer_record(kind: str, x: torch.Tensor, axis: int,
                 lead: Optional[int]):
    """An armed ledger's record of a collective over the peers stacked
    along dim ``axis`` of ``x``, whose first ``lead`` dims (default: up
    to ``axis``) stack the chips: each chip's share of ``x``, inside its
    replica (ICI).  None when the dim holds one peer (nothing moves)."""
    axis = int(axis) % x.ndim
    if x.shape[axis] < 2:
        return None
    lead = axis + 1 if lead is None else int(lead)
    return _wb._armed.uniform(kind, x.dtype,
                              _wb.nbytes(x) // _wb.peers(x, lead))


def _tapped(y: torch.Tensor, ev) -> torch.Tensor:
    return y if ev is None else _wb.transpose_on_backward(y, [ev])


def psum(x: torch.Tensor, axis: int, lead: Optional[int] = None
         ) -> torch.Tensor:
    """``lax.psum`` over the peers stacked along dim ``axis``: every peer
    gets the sum (a broadcast view of it).  ``lead``: the dims of ``x``
    that stack chips (default: up to ``axis``), for the wire-byte
    ledger; so for :func:`peer_sum`, :func:`pmean`, :func:`ppermute` and
    :func:`all_to_all`."""
    ev = (_peer_record("all_reduce", x, axis, lead)
          if _wb._armed is not None else None)
    return _tapped(_move("psum", _psum, x, axis), ev)


def _psum(x: torch.Tensor, axis: int) -> torch.Tensor:
    return x.sum(dim=axis, keepdim=True).expand_as(x)


def peer_sum(x: torch.Tensor, axis: int, lead: Optional[int] = None
             ) -> torch.Tensor:
    """The sum over the peers stacked along dim ``axis``, added in peer
    order (``(x0 + x1) + x2 ...``, the order the JAX reference's ``psum``
    over the tp axis adds them), that dim removed.  One peer: a view."""
    ev = (_peer_record("all_reduce", x, axis, lead)
          if _wb._armed is not None else None)
    return _tapped(_move("psum", _peer_sum, x, axis), ev)


def _peer_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    out = x.select(axis, 0)
    for t in range(1, x.shape[axis]):
        out = out + x.select(axis, t)
    return out


def pmean(x: torch.Tensor, axis: int, lead: Optional[int] = None
          ) -> torch.Tensor:
    """``lax.pmean`` over the peers stacked along dim ``axis``."""
    return psum(x, axis, lead) / x.shape[axis]


def ppermute(x: torch.Tensor, axis: int,
             perm: Sequence[Tuple[int, int]], lead: Optional[int] = None
             ) -> torch.Tensor:
    """``lax.ppermute`` along dim ``axis``: peer ``dst`` gets peer
    ``src``'s block for each ``(src, dst)`` pair, and a peer that is no
    pair's destination gets zeros."""
    n = x.shape[axis]
    src = np.full(n, -1)
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n) or src[d] >= 0:
            raise ValueError(f"ppermute pairs {list(perm)} are not a "
                             f"partial permutation of {n} peers")
        src[d] = s
    ev = (_peer_record("collective_permute", x, axis, lead)
          if _wb._armed is not None else None)
    y = _permute_rounds([x.movedim(axis, 0)], [src], record=False)[0]
    return _tapped(y.movedim(0, axis), ev)


def all_to_all(x: torch.Tensor, axis: int, split_axis: int,
               concat_axis: int, lead: Optional[int] = None
               ) -> torch.Tensor:
    """Tiled ``lax.all_to_all`` over the ``n`` peers stacked along dim
    ``axis``: each peer's block is cut into ``n`` chunks along
    ``split_axis``, chunk ``u`` goes to peer ``u``, and each peer lays the
    chunks it gets along ``concat_axis`` in peer order.  ``split_axis``
    and ``concat_axis`` are dims of ``x`` other than ``axis``."""
    ev = (_peer_record("all_to_all", x, axis, lead)
          if _wb._armed is not None else None)
    return _tapped(_move("all_to_all", _all_to_all, x, axis, split_axis,
                         concat_axis), ev)


def _all_to_all(x: torch.Tensor, axis: int, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    nd = x.ndim
    a, s, c = (int(d) % nd for d in (axis, split_axis, concat_axis))
    if a in (s, c):
        raise ValueError("split_axis and concat_axis must differ from the "
                         "peer axis")
    n = x.shape[a]
    if x.shape[s] % n:
        raise ValueError(f"all_to_all splits dim {s} of {x.shape[s]} into "
                         f"{n} chunks")
    # dim s becomes (chunk u at s, its rows at s + 1)
    y = x.unflatten(s, (n, x.shape[s] // n))

    def at(d):                     # a dim of x in y
        return d + 1 if d >= s and d != s else d

    order = []
    for d in range(nd):
        if d == a:
            order.append(s)                   # the chunk index: new peer
            continue
        if d == c:
            order.append(at(a))               # the sending peer, outer
        order.append(s + 1 if d == s else at(d))
    z = y.permute(order)
    p = order.index(at(a))
    return z.flatten(p, p + 1)
