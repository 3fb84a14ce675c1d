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
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..schedule import CommSchedule

__all__ = ["neighbor_allreduce", "hierarchical_neighbor_allreduce",
           "allreduce", "allgather", "broadcast", "psum", "peer_sum",
           "pmean", "ppermute", "all_to_all", "WIRE_CODECS",
           "_amax_scale", "_parse_wire", "_check_wire", "_wire_encode",
           "_wire_decode", "_default_dcn_wire"]

_TINY = float(np.finfo(np.float32).tiny)

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


def _table(row: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Per-rank table entries as a ``[n, 1, ...]`` column in x's dtype."""
    t = torch.as_tensor(np.asarray(row), device=x.device).to(x.dtype)
    return t.reshape((x.shape[0],) + (1,) * (x.ndim - 1))


def _permute(send: torch.Tensor, src: np.ndarray) -> torch.Tensor:
    """One round: rank d receives ``send[src[d]]``; ``src[d] < 0`` receives
    zeros."""
    idx = torch.as_tensor(np.clip(src, 0, None), dtype=torch.long,
                          device=send.device)
    recv = send.index_select(0, idx)
    if (src < 0).any():
        got = torch.as_tensor(src >= 0, device=send.device)
        recv = recv * got.reshape((-1,) + (1,) * (send.ndim - 1)).to(
            recv.dtype)
    return recv


def _wire_permute(wire: Optional[str], send: torch.Tensor, src: np.ndarray,
                  lead: int = 1, parts=None) -> torch.Tensor:
    """One round, optionally wire-compressed (``_wire_ppermute`` of the
    JAX package): each of the first ``lead`` dims' buffers is encoded,
    the codes and scales travel (zero-filled where nothing arrives, so a
    rank receiving nothing decodes zeros), and the receiver decodes.
    ``parts`` passes ``send``'s encoding when the caller has it."""
    if wire is None:
        return _permute(send, src)
    if not send.is_floating_point():
        # complex would silently lose its imaginary part in the codecs
        raise ValueError(
            f"wire compression needs a real float input, got {send.dtype}")
    if parts is None:
        parts = _wire_encode(wire, send, lead)
    moved = []
    for p in parts:
        if p.dtype == torch.float8_e4m3fn:     # permuted as raw bytes
            moved.append(_permute(p.view(torch.uint8), src).view(p.dtype))
        else:
            moved.append(_permute(p, src))
    return _wire_decode(wire, moved, send.dtype, shape=send.shape, lead=lead)


def _check_ranks(x: torch.Tensor, n: int, what: str) -> None:
    if x.ndim < 1 or x.shape[0] != n:
        raise ValueError(f"{what} wants a stacked [n={n}, ...] tensor, got "
                         f"shape {tuple(x.shape)}")


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
    (``x`` then ``[n, slice, ...]``).  ``concurrent`` is accepted: the
    rounds always combine in round order, so the result is the same
    either way."""
    _check_ranks(x, sched.size, "neighbor_allreduce")
    acc = x * _table(sched.self_weight, x)
    # without dst-weighting every round sends x: encode it once
    parts = (_wire_encode(wire, x, lead) if wire is not None
             and x.is_floating_point() and sched.num_rounds
             and not sched.uses_dst_weighting else None)
    for r in range(sched.num_rounds):
        send = x
        if sched.uses_dst_weighting:
            send = x * _table(sched.send_scale[r], x)
        recv = _wire_permute(wire, send, sched.recv_src[r], lead, parts)
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
    M = machine_sched.size
    n = x.shape[0]
    if x.ndim < 1 or n % M:
        raise ValueError(f"hierarchical_neighbor_allreduce: {n} stacked "
                         f"ranks are not {M} machines of equal size")
    grouped = x.reshape((M, n // M) + tuple(x.shape[1:]))
    machine_avg = grouped.sum(dim=1) / (n // M)
    out = neighbor_allreduce(machine_avg, machine_sched, wire=wire,
                             concurrent=concurrent)
    return out.unsqueeze(1).expand_as(grouped).reshape(x.shape)


def allreduce(x: torch.Tensor, *, average: bool = True) -> torch.Tensor:
    """Every rank gets the sum (or mean) over the ranks."""
    total = x.sum(dim=0, keepdim=True)
    if average:
        total = total / x.shape[0]
    return total.expand_as(x).clone()


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Every rank gets all ranks' blocks concatenated along their dim 0:
    ``[n, d0, ...] -> [n, n * d0, ...]``."""
    n = x.shape[0]
    flat = x.reshape((n * x.shape[1],) + tuple(x.shape[2:]))
    return flat.unsqueeze(0).expand((n,) + tuple(flat.shape)).clone()


def broadcast(x: torch.Tensor, root_rank: int) -> torch.Tensor:
    """Every rank gets root's block."""
    if not 0 <= root_rank < x.shape[0]:
        raise ValueError(f"root_rank {root_rank} out of range for "
                         f"{x.shape[0]} ranks")
    return x[root_rank:root_rank + 1].expand_as(x).clone()


# ---------------------------------------------------------------------------
# Collectives over one named axis of the stacked carving (a dim)
# ---------------------------------------------------------------------------

def psum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``lax.psum`` over the peers stacked along dim ``axis``: every peer
    gets the sum (a broadcast view of it)."""
    return x.sum(dim=axis, keepdim=True).expand_as(x)


def peer_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The sum over the peers stacked along dim ``axis``, added in peer
    order (``(x0 + x1) + x2 ...``, the order the JAX reference's ``psum``
    over the tp axis adds them), that dim removed.  One peer: a view."""
    out = x.select(axis, 0)
    for t in range(1, x.shape[axis]):
        out = out + x.select(axis, t)
    return out


def pmean(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``lax.pmean`` over the peers stacked along dim ``axis``."""
    return psum(x, axis) / x.shape[axis]


def ppermute(x: torch.Tensor, axis: int,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
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
    return _permute(x.movedim(axis, 0), src).movedim(0, axis)


def all_to_all(x: torch.Tensor, axis: int, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Tiled ``lax.all_to_all`` over the ``n`` peers stacked along dim
    ``axis``: each peer's block is cut into ``n`` chunks along
    ``split_axis``, chunk ``u`` goes to peer ``u``, and each peer lays the
    chunks it gets along ``concat_axis`` in peer order.  ``split_axis``
    and ``concat_axis`` are dims of ``x`` other than ``axis``."""
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
