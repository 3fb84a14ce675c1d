"""Pipeline schedules over stacked stages (counterpart of
``bluefog_tpu/parallel/pipeline.py``): GPipe (:func:`pipeline_apply`),
1F1B (:func:`pipeline_1f1b_grad`), interleaved virtual stages
(:func:`pipeline_interleaved_apply`), per-stage functions
(:func:`pipeline_apply_stages` over :func:`pack_stage_params`), and
:func:`last_stage_value`.

The JAX functions run one stage per device along a mesh axis: at every
tick each device computes its stage on its microbatch when that is in
range, masks its output to zero otherwise, and ``ppermute`` ships it to
the next stage.  Here the stages live stacked along dim 0 of every stage
parameter, and each tick runs the stages that have a microbatch at once,
in one call of ``stage_fn`` over a contiguous range of stages.  The
masked ticks of the JAX schedules (the bubble) are skipped: their output
and its gradient are exactly zero there, so skipping them changes no
result.  The ship to the next stage is a
:func:`~bluefog_tpu_torch.ops.collectives._permute` of the stage rows
(the tick's outputs laid into the stage block, zeros elsewhere).

``axis="rank"`` puts the stages on the context's rank axis: across
processes (torchrun) each process holds its block of ``rows`` stages,
there are ``rows * world`` of them, and the ship crosses the process
boundary.  Autograd through a schedule then crosses it too, so every
process runs every tick over its whole block, the rows outside the
schedule masked as the JAX devices mask them: each process then holds
one move of every tick in its graph, and the backward reaches them all
in the same order on every process.  The returned outputs are the last
stage's, on every process.

Autograd through :func:`pipeline_apply`, :func:`pipeline_interleaved_apply`
and :func:`pipeline_apply_stages` is their backward schedule, as
``jax.grad`` is in the JAX package; ``remat=True`` recomputes each
tick's stage forward in the backward (``torch.utils.checkpoint``),
keeping only its inputs.  :func:`pipeline_1f1b_grad` runs its own
backward ticks (``torch.autograd.grad`` of one stage call each), so its
live activations do not grow with the microbatch count.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..fusion import tree_flatten, tree_unflatten
from ..ops import collectives as _coll

__all__ = ["pipeline_apply", "last_stage_value", "pipeline_1f1b_grad",
           "pipeline_interleaved_apply", "pipeline_apply_stages",
           "pack_stage_params"]


class _Stages:
    """The stage rows this process holds: all ``S`` stages stacked on dim
    0 (``axis="stage"``), or its block of the context's rank axis
    (``axis="rank"``: ``rows`` stages on each of ``world`` processes)."""

    def __init__(self, rows: int, axis: str, lead: int = 1):
        if axis not in ("stage", "rank"):
            raise ValueError(f"axis must be 'stage' or 'rank', got {axis!r}")
        world, p = _coll._procs() if axis == "rank" else (1, 0)
        self.rows, self.S, self.r0 = rows, rows * world, p * rows
        self.world, self.spmd = world, world > 1
        self.lead = lead               # the block's dims that stack chips

    def span(self, lo: int, hi: int) -> Tuple[int, int]:
        """The global stages ``[a, b)`` this process computes at a tick
        whose live stages are ``lo..hi``: their share of the block, or,
        across processes, the whole block (masked by the caller)."""
        if self.spmd:
            return self.r0, self.r0 + self.rows
        return max(lo, self.r0), min(hi + 1, self.r0 + self.rows)

    def place(self, pieces: Sequence[Tuple[int, torch.Tensor]],
              like: torch.Tensor) -> torch.Tensor:
        """The block ``[rows, ...]`` holding each ``(global stage, rows)``
        piece at its stages, zeros elsewhere."""
        parts, at = [], self.r0
        for a, y in pieces:
            if a > at:
                parts.append(like.new_zeros((a - at,) + tuple(y.shape[1:])))
            parts.append(y)
            at = a + y.shape[0]
        end = self.r0 + self.rows
        if at < end:
            parts.append(like.new_zeros((end - at,) + tuple(like.shape[1:])))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def ship(self, pieces, like, src: np.ndarray) -> torch.Tensor:
        """The tick's outputs moved along ``src`` (a global table: stage
        ``d`` receives stage ``src[d]``'s row)."""
        return _coll._permute(self.place(pieces, like), src, self.lead)

    def mask(self, y: torch.Tensor, valid: np.ndarray,
             inbox: torch.Tensor) -> torch.Tensor:
        """Across processes: the rows outside the schedule zeroed, as the
        JAX devices' ``where(valid, y, 0)``, and the tick's inbox tied to
        its output (:class:`_Tie`)."""
        keep = torch.as_tensor(valid, device=y.device).reshape(
            (-1,) + (1,) * (y.ndim - 1))
        return _Tie.apply(torch.where(keep, y, torch.zeros_like(y)), inbox)

    def from_last(self, outputs: List[Optional[torch.Tensor]],
                  connector: torch.Tensor) -> torch.Tensor:
        """The last stage's ``[M, ...]`` outputs on every process: the
        process holding the last stage recorded them, the others pass
        the final tick's block (the ``connector``), which ties their
        pipeline to the loss they compute from the result."""
        if not self.spmd:
            return torch.stack(outputs)
        owner = outputs[0] is not None
        return _FromLast.apply(torch.stack(outputs) if owner else connector,
                               owner, self.world - 1,
                               (len(outputs),) + tuple(connector.shape[1:]))


class _Tie(torch.autograd.Function):
    """``y`` unchanged, with ``inbox`` as a second input whose gradient is
    zero.  A stage that reads no inbox (stage 0) still has the previous
    tick's move in its graph, as each JAX device's program holds every
    ``ppermute`` and its transpose: so every process runs the backward of
    every move, which its neighbours wait on."""

    @staticmethod
    def forward(ctx, y, inbox):
        ctx.shape = inbox.shape
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(ctx.shape)


class _FromLast(torch.autograd.Function):
    """Broadcast of the last stage's outputs from the process holding it.
    Every process computes the same loss from them, so the backward keeps
    that process's own cotangent and gives the others' inputs zeros (the
    transpose of the JAX ``psum`` into a replicated value)."""

    @staticmethod
    def forward(ctx, x, owner: bool, src: int, shape):
        import torch.distributed as dist
        ctx.owner, ctx.shape = owner, x.shape
        out = x.clone() if owner else x.new_empty(shape)
        dist.broadcast(out, src=src)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.owner else g.new_zeros(ctx.shape)), None, None, None


def _stage_leaves(params, what: str):
    leaves, treedef = tree_flatten(params)
    if not leaves:
        raise ValueError(f"{what} needs stage parameters")
    n = leaves[0].shape[0]
    if any(w.shape[0] != n for w in leaves):
        raise ValueError("every stage parameter must stack the same "
                         f"{n} stages on dim 0")
    return leaves, treedef, n


def _remat(fn, remat: bool):
    if not remat:
        return fn
    return lambda p, x: checkpoint(fn, p, x, use_reentrant=False)


def _shift(S: int, step: int) -> np.ndarray:
    """Stage ``d`` receives stage ``d - step`` (zeros past either end)."""
    src = np.arange(S) - step
    src[(src < 0) | (src >= S)] = -1
    return src


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor, *,
                   axis: str = "stage", remat: bool = False,
                   lead: int = 1) -> torch.Tensor:
    """Run a stage-partitioned network over microbatches (GPipe).

    Args:
      stage_fn: ``(params, x) -> y`` for a contiguous range of ``k``
        stages at once: every leaf of ``params`` and ``x``/``y`` carry
        those stages on dim 0 (``y[i]`` is stage ``i``'s output for its
        input ``x[i]``).  Activations share one shape and dtype across
        stages (the pipeline contract).
      stage_params: a tree whose leaves stack the stages' parameters on
        dim 0 (this process's block of them with ``axis="rank"``).
      microbatches: ``[num_micro, ...]`` inputs; stage 0 reads them.
      axis: ``"stage"`` (the stages stacked here) or ``"rank"`` (the
        context's rank axis, across processes).
      remat: recompute each tick's stage forward in the backward.
      lead: the dims of a stage row that stack chips (the stage dim and
        the microbatch's leading peer dims), for the wire-byte ledger.

    Returns:
      ``[num_micro, ...]``: the last stage's outputs, in microbatch order.
      (The JAX function returns them on the last stage's device and zeros
      on the others; :func:`last_stage_value` is that per-stage view.)
    """
    leaves, treedef, rows = _stage_leaves(stage_params, "pipeline_apply")
    st = _Stages(rows, axis, lead)
    S, M = st.S, microbatches.shape[0]
    fn = _remat(stage_fn, remat)
    fwd = _shift(S, 1)
    outputs: List[Optional[torch.Tensor]] = [None] * M
    inbox = microbatches.new_zeros((rows,) + tuple(microbatches.shape[1:]))
    y = None
    for t in range(M + S - 1):
        # stages lo..hi hold microbatches t - hi .. t - lo at this tick
        a, b = st.span(max(0, t - M + 1), min(t, S - 1))
        parts = []
        if a == 0:
            parts.append(microbatches[min(t, M - 1)][None])
        if b > max(a, 1):
            # stage s > 0 takes what stage s - 1 shipped at the previous
            # tick
            parts.append(inbox[max(a, 1) - st.r0:b - st.r0])
        x = parts[0] if len(parts) == 1 else torch.cat(parts)
        y = fn(tree_unflatten(treedef, [w[a - st.r0:b - st.r0]
                                        for w in leaves]), x)
        if st.spmd:
            m = t - np.arange(a, b)
            y = st.mask(y, (m >= 0) & (m < M), inbox)
        if b == S and t >= S - 1:
            outputs[t - S + 1] = y[-1]            # the last stage records
        if t < M + S - 2:
            inbox = st.ship([(a, y)], y, fwd)
    return st.from_last(outputs, y)


def last_stage_value(x: torch.Tensor) -> torch.Tensor:
    """The last stage's value on every stage: ``x`` stacks the stages on
    dim 0, and every row of the result is ``x[-1]`` (the JAX function's
    mask-and-``psum``).  Its gradient reaches the last stage's row only."""
    return x[-1:].expand_as(x)


def pipeline_1f1b_grad(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,
    targets: torch.Tensor,
    *,
    axis: str = "stage",
) -> Tuple[torch.Tensor, Any]:
    """One-forward-one-backward pipeline training step with O(S)
    activation memory (vs :func:`pipeline_apply` + autograd's O(M + S)
    stash).

    Stage ``s`` forwards microbatch ``m`` at tick ``s + m`` and backwards
    it at tick ``2S - 1 - s + m`` (PipeDream-flush / 1F1B), so a stashed
    stage input lives at most ``2S - 1`` ticks: the ring buffer is
    ``min(M, 2S - 1)`` stage inputs per stage however many microbatches
    flow through.  Forwards run without a graph; each backward tick
    recomputes its stages' forward from the stashed inputs
    (``torch.autograd.grad`` of that one stage call) and ships the input
    cotangents to the stage before.  The backward slot runs before the
    forward slot in each tick, so the forward may reuse the slot the
    backward just read.

    Args:
      stage_fn: ``(params, x) -> y`` over a contiguous range of stages
        (the contract of :func:`pipeline_apply`).
      loss_fn: ``(y, target) -> scalar`` applied per microbatch on the
        LAST stage's output.
      stage_params: the stages' parameters stacked on dim 0.
      microbatches: ``[M, ...]`` inputs (read by stage 0).
      targets: ``[M, ...]`` per-microbatch targets (read by the last
        stage).
      axis: ``"stage"`` or ``"rank"`` (as :func:`pipeline_apply`).

    Returns:
      ``(loss, dparams)``: ``loss [S]`` the loss summed over microbatches
      on the last stage's row, zeros on the others (the JAX per-device
      values stacked), and each stage's parameter gradient summed over
      microbatches, stacked like ``stage_params``.
    """
    leaves, treedef, rows = _stage_leaves(stage_params, "pipeline_1f1b_grad")
    st = _Stages(rows, axis)
    S, M = st.S, microbatches.shape[0]
    act = tuple(microbatches.shape[1:])
    buf = min(M, 2 * S - 1)
    ticks = M + 2 * (S - 1) + 1          # last bwd: t_b(0, M-1) = 2S-2+M
    r0 = st.r0
    dev = microbatches.device
    stash = microbatches.new_zeros((rows, buf) + act)
    fwd_inbox = microbatches.new_zeros((rows,) + act)
    bwd_inbox = microbatches.new_zeros((rows,) + act)
    params = [w.detach() for w in leaves]
    dparams = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
               for w in params]
    loss_acc = torch.zeros(rows, dtype=torch.float32, device=dev)
    fwd, bwd = _shift(S, 1), _shift(S, -1)
    for t in range(ticks):
        # backward slot: stage s backwards microbatch t - (2S - 1 - s)
        a = max(0, 2 * S - 1 - t, r0)
        b = min(S, 2 * S - 1 - t + M, r0 + rows)
        back = []
        if a < b:
            mbs = t - (2 * S - 1) + np.arange(a, b)
            x = stash[torch.arange(a - r0, b - r0, device=dev),
                      torch.as_tensor(mbs % buf, device=dev)]
            x.requires_grad_()
            ps = [w[a - r0:b - r0].requires_grad_() for w in params]
            with torch.enable_grad():
                y = stage_fn(tree_unflatten(treedef, ps), x)
                if b == S:       # the loss's cotangent on the last stage
                    loss = loss_fn(y[-1], targets[int(mbs[-1])])
                    outs = [loss] + ([y[:-1]] if b - a > 1 else [])
                    cots = [torch.ones_like(loss)] + (
                        [bwd_inbox[a - r0:b - r0 - 1]] if b - a > 1 else [])
                    loss_acc[S - 1 - r0] += loss.detach().float()
                else:
                    outs, cots = [y], [bwd_inbox[a - r0:b - r0]]
                grads = torch.autograd.grad(outs, ps + [x], cots)
            for acc, g in zip(dparams, grads[:-1]):
                acc[a - r0:b - r0] += g.float()
            back = [(a, grads[-1].detach())]
        if t < ticks - 1:
            bwd_inbox = st.ship(back, bwd_inbox, bwd)
        # forward slot: stage s forwards microbatch t - s
        a = max(0, t - M + 1, r0)
        b = min(t + 1, S, r0 + rows)
        ahead = []
        if a < b:
            parts = []
            if a == 0:
                parts.append(microbatches[t][None])
            if b > max(a, 1):
                parts.append(fwd_inbox[max(a, 1) - r0:b - r0])
            x = parts[0] if len(parts) == 1 else torch.cat(parts)
            with torch.no_grad():
                y = stage_fn(tree_unflatten(
                    treedef, [w[a - r0:b - r0] for w in params]), x)
            stash[torch.arange(a - r0, b - r0, device=dev),
                  torch.as_tensor((t - np.arange(a, b)) % buf,
                                  device=dev)] = x
            ahead = [(a, y)]
        if t < M + S - 2:
            fwd_inbox = st.ship(ahead, fwd_inbox, fwd)
    dparams = [g.to(w.dtype) for g, w in zip(dparams, params)]
    return loss_acc, tree_unflatten(treedef, dparams)


def pipeline_interleaved_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    chunk_params: Any,
    microbatches: torch.Tensor,
    *,
    axis: str = "stage",
    remat: bool = False,
) -> torch.Tensor:
    """Interleaved (virtual-stage) pipeline: each device hosts ``V``
    model chunks instead of one contiguous stage, shrinking the bubble
    ~``V``-fold.

    Device ``d`` holds chunks ``k = 0..V-1`` as virtual stages ``v = k*S +
    d`` (the Megatron-LM placement), and microbatches flow around the
    device ring ``V`` times (``d -> d+1``, the wrap ``S-1 -> 0`` advancing
    the chunk).  Virtual stage ``v`` computes microbatch ``m`` at tick ``v
    + m``; with ``M <= S`` (enforced) every tick is at most one chunk a
    device, and the schedule is ``V*S + M - 1`` ticks.  A tick's devices
    run at most two chunks; each chunk's run of devices is one
    ``stage_fn`` call.  Autograd through it is the reverse interleaved
    schedule.

    Args:
      stage_fn: ``(params, x) -> y`` for ONE chunk over a contiguous range
        of devices (the contract of :func:`pipeline_apply`).
      chunk_params: leaves ``[S, V, ...]``; ``[d, k]`` is virtual stage
        ``k*S + d``'s parameters (from a full ``[V*S, ...]`` stack:
        ``full[k*S + d]``).
      microbatches: ``[M, ...]`` inputs, ``M <= S`` (stream larger batches
        in groups of ``S``, accumulating grads across groups).
      axis: ``"stage"`` or ``"rank"`` (as :func:`pipeline_apply`).
      remat: recompute each chunk forward in the backward pass.

    Returns:
      ``[M, ...]``: the last virtual stage's outputs, in microbatch order
      (the layout of :func:`pipeline_apply`'s).
    """
    leaves, treedef, rows = _stage_leaves(chunk_params,
                                          "pipeline_interleaved_apply")
    st = _Stages(rows, axis)
    S, M = st.S, microbatches.shape[0]
    if M > S:
        raise ValueError(
            f"pipeline_interleaved_apply needs M <= S ({M} > {S}): the "
            "circular schedule is conflict-free only when at most one "
            "microbatch per chunk is in flight per ring lap; stream "
            "larger batches in groups of S")
    V = leaves[0].shape[1]
    fn = _remat(stage_fn, remat)
    ring = (np.arange(S) - 1) % S            # the S-1 -> 0 wrap: next chunk
    outputs: List[Optional[torch.Tensor]] = [None] * M
    inbox = microbatches.new_zeros((rows,) + tuple(microbatches.shape[1:]))
    ticks = V * S + M - 1
    y = None
    for t in range(ticks):
        d = np.arange(st.r0, st.r0 + rows)
        r = t - d
        valid = (r >= 0) & (r // S < V) & (r % S < M)
        k = np.clip(r // S, 0, V - 1)
        if not st.spmd:
            d, k = d[valid], k[valid]
        pieces = []
        # runs of consecutive devices on one chunk: one call each
        cut = np.flatnonzero((np.diff(d) != 1) | (np.diff(k) != 0)) + 1
        for dr, kr in zip(np.split(d, cut), np.split(k, cut)):
            if not dr.size:
                continue
            a, b, kk = int(dr[0]), int(dr[-1]) + 1, int(kr[0])
            parts = []
            if a == 0 and kk == 0:           # virtual stage 0 reads mb
                parts.append(microbatches[min(max(t, 0), M - 1)][None])
            lo = a + 1 if a == 0 and kk == 0 else a
            if b > lo:
                parts.append(inbox[lo - st.r0:b - st.r0])
            x = parts[0] if len(parts) == 1 else torch.cat(parts)
            yr = fn(tree_unflatten(treedef, [w[a - st.r0:b - st.r0, kk]
                                             for w in leaves]), x)
            pieces.append((a, yr))
        y = pieces[0][1] if len(pieces) == 1 else \
            torch.cat([p for _, p in pieces])
        if st.spmd:
            y = st.mask(y, valid, inbox)
            pieces = [(st.r0, y)]
        # the exit: device S-1, chunk V-1 (virtual stage V*S - 1)
        m_last = t - (S - 1) - (V - 1) * S
        if 0 <= m_last < M and pieces[-1][0] + pieces[-1][1].shape[0] == S:
            outputs[m_last] = pieces[-1][1][-1]
        if t < ticks - 1:
            inbox = st.ship(pieces, y, ring)
    return st.from_last(outputs, y)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def pack_stage_params(trees):
    """Pack per-stage parameter trees (different structures allowed) into
    one uniform ``[S, P_max]`` flat buffer plus per-stage unpack
    functions.

    Stages with different parameters have no common stacked layout; the
    escape is a padded flat buffer per stage (one dtype, zero-padded to
    the largest stage) with unpack closures restoring stage ``s``'s tree
    from its row.  Returns ``(stacked [S, P_max], unpack_fns)``;
    ``unpack_fns[s](stacked[s])`` is stage ``s``'s tree (views of the
    row)."""
    flats, unpacks = [], []
    buf_dtype = None
    for tree in trees:
        leaves, treedef = tree_flatten(tree)
        if not leaves:
            raise ValueError("a stage has no parameters")
        dtype = leaves[0].dtype
        seen = {_dtype_name(leaf.dtype) for leaf in leaves}
        if buf_dtype is not None:
            seen.add(_dtype_name(buf_dtype))
        if len(seen) > 1:
            # across stages too: stacking would promote silently, handing
            # a stage parameters in a dtype it never declared
            raise ValueError(
                "pack_stage_params needs a single param dtype across all "
                f"stages (got {sorted(seen)})")
        buf_dtype = dtype
        shapes = [tuple(leaf.shape) for leaf in leaves]
        sizes = [int(np.prod(sh)) if sh else 1 for sh in shapes]
        flats.append(torch.cat([leaf.reshape(-1) for leaf in leaves]))

        def unpack(buf, treedef=treedef, shapes=shapes, sizes=sizes):
            out, off = [], 0
            for sh, sz in zip(shapes, sizes):
                out.append(buf[off:off + sz].reshape(sh))
                off += sz
            return tree_unflatten(treedef, out)

        unpacks.append(unpack)
    pmax = max(f.numel() for f in flats)
    stacked = torch.stack([torch.nn.functional.pad(f, (0, pmax - f.numel()))
                           for f in flats])
    return stacked, unpacks


def pipeline_apply_stages(
    stage_fns,
    unpack_fns,
    stage_params: torch.Tensor,
    microbatches: torch.Tensor,
    *,
    boundary_shapes,
    boundary_dtype=torch.float32,
    axis: str = "stage",
    remat: bool = False,
) -> torch.Tensor:
    """Heterogeneous pipeline: per-stage functions, parameters and
    activation shapes, so the embedding and the head live inside the
    pipeline (``examples/pipeline_lm.py --hetero``).

    Stage boundaries ride one flat buffer of ``boundary_dtype`` a stage,
    zero-padded to the largest boundary; the stage-0 input comes straight
    from ``microbatches`` and may be any shape and dtype (e.g. integer
    tokens).  The stages differ, so each tick calls each live stage's own
    function on its own row (the JAX function's ``lax.switch`` over the
    device's stage index needs no counterpart).  Autograd through the
    schedule is the backward pipeline, as for :func:`pipeline_apply`.

    Args:
      stage_fns: length-``S`` list; ``stage_fns[s](params_s, x) -> y``
        with ``x`` of shape ``boundary_shapes[s-1]`` (``microbatches[m]``
        for ``s=0``) and ``y`` of shape ``boundary_shapes[s]``.
      unpack_fns: from :func:`pack_stage_params`.
      stage_params: the ``[S, P_max]`` packed parameter rows.
      microbatches: ``[M, ...]`` stage-0 inputs.
      boundary_shapes: length-``S``; ``boundary_shapes[s]`` is the shape
        leaving stage ``s`` (the last entry is the pipeline output shape).
      boundary_dtype: dtype of every boundary activation.
      axis: ``"stage"`` or ``"rank"`` (as :func:`pipeline_apply`).

    Returns:
      ``[M, *boundary_shapes[-1]]``: the last stage's outputs.
    """
    S = len(stage_fns)
    if len(unpack_fns) != S or len(boundary_shapes) != S:
        raise ValueError(
            f"stage_fns/unpack_fns/boundary_shapes must all have length S "
            f"({S} / {len(unpack_fns)} / {len(boundary_shapes)})")
    st = _Stages(stage_params.shape[0], axis)
    if st.S != S:
        raise ValueError(f"{S} stages need a {S}-device '{axis}' axis "
                         f"(got {st.S})")
    M = microbatches.shape[0]
    sizes = [int(np.prod(sh)) for sh in boundary_shapes]
    A = max(sizes)
    fns = [_remat(f, remat) for f in stage_fns]
    fwd = _shift(S, 1)
    outputs: List[Optional[torch.Tensor]] = [None] * M
    inbox = torch.zeros((st.rows, A), dtype=boundary_dtype,
                        device=stage_params.device)
    y = None
    for t in range(M + S - 1):
        a, b = st.span(max(0, t - M + 1), min(t, S - 1))
        rows = []
        for s in range(a, b):
            x = microbatches[min(max(t - s, 0), M - 1)] if s == 0 else \
                inbox[s - st.r0, :sizes[s - 1]].reshape(boundary_shapes[s - 1])
            ys = fns[s](unpack_fns[s](stage_params[s - st.r0]), x)
            if tuple(ys.shape) != tuple(boundary_shapes[s]):
                raise ValueError(
                    f"stage {s} returned {tuple(ys.shape)}, declared "
                    f"{tuple(boundary_shapes[s])}")
            ys = ys.reshape(-1).to(boundary_dtype)
            rows.append(torch.nn.functional.pad(ys, (0, A - ys.numel())))
        y = torch.stack(rows)
        if st.spmd:
            m = t - np.arange(a, b)
            y = st.mask(y, (m >= 0) & (m < M), inbox)
        if b == S and t >= S - 1:
            outputs[t - S + 1] = y[-1]
        if t < M + S - 2:
            inbox = st.ship([(a, y)], y, fwd)
    out = st.from_last(outputs, y)
    return out[:, :sizes[-1]].reshape((M,) + tuple(boundary_shapes[-1]))
