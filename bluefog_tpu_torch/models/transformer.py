"""Decoder transformer with sequence parallelism over stacked ranks
(counterpart of ``bluefog_tpu/models/transformer.py``).

A GPT-style decoder whose attention runs over a sequence sharded across
``n`` sequence ranks.  The JAX model runs inside ``shard_map`` and each
device holds ``T / n`` tokens; here the ranks stack on dim 0 of every
activation (tokens ``[n, B, T/n]``, positions ``[n, T/n]``), as in
:mod:`bluefog_tpu_torch.ops.ring`.  The weights are one set shared by
every rank, so JAX's ``psum`` of the replicated parameters' gradients
over the ring is autograd's sum over that one weight's uses.  With
``axis=None`` the input is one plain ``[B, T]`` sequence.

Attention per block (``sp_mode``):

* ``ring``: :func:`~bluefog_tpu_torch.ops.ring.ring_attention`, layout
  ``contiguous`` or ``zigzag`` (tokens pre-permuted by ``zigzag_order``,
  positions from ``zigzag_positions``), grouped-query kv allowed;
* ``ulysses``: :func:`~bluefog_tpu_torch.ops.ulysses.ulysses_attention`
  over the rank dim (equal q/kv heads);
* one rank (``axis=None``): ``local_flash_attention`` (K1/K2), or
  ``dense_attention`` for CPU tensors without ``use_pallas``.

On CUDA tensors every one of these attends through K1/K2 (as
``ops/ring.py`` does; ``use_pallas`` selects nothing there).  The cached
decode path (``cache=``, :func:`init_decode_cache`) is the JAX one,
single rank.

The JAX model is flax: ``nn.LayerNorm`` (learned scale and bias,
epsilon 1e-6, computed at the f32 floor), ``nn.Dense`` kernels ``[in,
out]`` (the port keeps that layout), ``nn.gelu`` (the tanh
approximation).  ``scan_layers`` is a compile-time device of XLA; the
port runs one module per layer, and :func:`params_from_jax` takes the
scanned tree (``blocks`` with a leading ``[num_layers]``) as well as the
unrolled one.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.ring import ring_attention
from ..ops.ulysses import (dense_attention, local_flash_attention,
                           ulysses_attention)
from .rope import apply_rope, apply_rope_grid

__all__ = ["RingTransformerBlock", "RingTransformerLM", "init_decode_cache",
           "params_from_jax", "lm_loss"]

LN_EPS = 1e-6          # flax nn.LayerNorm's epsilon (torch's default 1e-5)


def _floor(dtype: torch.dtype) -> torch.dtype:
    """The f32 floor: f32 for narrower types, f64 stays f64."""
    return torch.promote_types(dtype, torch.float32)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    ct = _floor(x.dtype)
    return F.layer_norm(x.to(ct), x.shape[-1:], scale.to(ct), bias.to(ct),
                        LN_EPS)


def _dense(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel ``[in, out]`` and bias
    cast to ``dtype``, then ``x @ w + b``."""
    dt = dtype or x.dtype
    y = torch.matmul(x.to(dt), w.to(dt))
    return y if b is None else y + b.to(dt)


def _rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rope on ``[B, T, H, D]`` (positions ``[T]``) or on stacked ranks
    ``[n, B, T, H, D]`` (positions ``[n, T]``)."""
    if x.ndim == 4:
        return apply_rope(x, positions)
    n, B = x.shape[:2]
    flat = apply_rope_grid(x.reshape((n * B,) + tuple(x.shape[2:])),
                           positions.repeat_interleave(B, dim=0))
    return flat.view(x.shape)


class RingTransformerBlock(nn.Module):
    """Pre-LN decoder block; attention runs over the stacked sequence
    ranks when ``axis`` is set.  Parameters in the flax layout: LayerNorm
    scale/bias, ``wqkv [C, C + 2 Hkv Dh]`` and ``wo [C, C]`` without bias,
    the MLP ``w1 [C, mlp_ratio C]``/``b1`` and ``w2``/``b2``."""

    def __init__(self, d_model: int, num_heads: int,
                 num_kv_heads: Optional[int] = None, mlp_ratio: int = 4,
                 axis: Optional[str] = None,
                 dtype: torch.dtype = torch.bfloat16, sp_mode: str = "ring",
                 sp_layout: str = "contiguous", rope: bool = False,
                 use_pallas: bool = False):
        super().__init__()
        H = num_heads
        Hkv = num_kv_heads or H
        if H % Hkv:
            raise ValueError(
                f"num_heads {H} not a multiple of num_kv_heads {Hkv}")
        C, Dh = d_model, d_model // H
        self.num_heads, self.num_kv_heads, self.head_dim = H, Hkv, Dh
        self.axis, self.dtype = axis, dtype
        self.sp_mode, self.sp_layout = sp_mode, sp_layout
        self.rope, self.use_pallas = rope, use_pallas

        def p(*shape, fill=0.0):
            return nn.Parameter(torch.full(shape, fill))

        self.ln1_scale, self.ln1_bias = p(C, fill=1.0), p(C)
        self.wqkv = p(C, C + 2 * Hkv * Dh)
        self.wo = p(C, C)
        self.ln2_scale, self.ln2_bias = p(C, fill=1.0), p(C)
        self.w1, self.b1 = p(C, mlp_ratio * C), p(mlp_ratio * C)
        self.w2, self.b2 = p(mlp_ratio * C, C), p(C)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = _layer_norm(x, self.ln2_scale, self.ln2_bias).to(self.dtype)
        h = F.gelu(_dense(h, self.w1, self.b1), approximate="tanh")
        return x + _dense(h, self.w2, self.b2)

    def _qkv(self, x: torch.Tensor, positions):
        H, Hkv, Dh = self.num_heads, self.num_kv_heads, self.head_dim
        C = H * Dh
        h = _layer_norm(x, self.ln1_scale, self.ln1_bias).to(self.dtype)
        qkv = _dense(h, self.wqkv)
        lead = tuple(x.shape[:-1])
        q = qkv[..., :C].reshape(lead + (H, Dh))
        k = qkv[..., C:C + Hkv * Dh].reshape(lead + (Hkv, Dh))
        v = qkv[..., C + Hkv * Dh:].reshape(lead + (Hkv, Dh))
        if self.rope:
            if positions is None:
                raise ValueError("rope needs the tokens' global positions")
            q, k = _rope(q, positions), _rope(k, positions)
        return q, k, v

    def forward(self, x: torch.Tensor, positions=None, cache=None):
        """``x [B, T, C]`` (``[n, B, T/n, C]`` with ``axis``); with
        ``cache`` the decode step, returning ``(x, cache)``."""
        H, Hkv, Dh = self.num_heads, self.num_kv_heads, self.head_dim
        q, k, v = self._qkv(x, positions)
        if cache is not None:
            return self._decode(x, q, k, v, positions, cache)
        if self.sp_mode not in ("ring", "ulysses"):
            raise ValueError(
                f"unknown sp_mode {self.sp_mode!r}; choose 'ring' or "
                "'ulysses'")
        if self.sp_layout not in ("contiguous", "zigzag"):
            raise ValueError(f"unknown sp_layout {self.sp_layout!r}")
        if self.sp_layout == "zigzag" and self.sp_mode != "ring":
            raise ValueError("sp_layout='zigzag' is a ring-attention layout")
        if self.axis is not None:
            if self.sp_mode == "ring":
                att = ring_attention(q, k, v, causal=True,
                                     layout=self.sp_layout,
                                     use_pallas=self.use_pallas)
            else:
                att = ulysses_attention(q, k, v, axis=0, causal=True,
                                        use_pallas=self.use_pallas)
        elif self.use_pallas or q.is_cuda:
            att = local_flash_attention(q, k, v, True, Dh ** -0.5,
                                        512).to(self.dtype)
        else:
            if Hkv != H:                 # the dense oracle wants full kv
                k = k.repeat_interleave(H // Hkv, dim=-2)
                v = v.repeat_interleave(H // Hkv, dim=-2)
            att = dense_attention(q, k, v, causal=True).to(self.dtype)
        att = att.reshape(tuple(x.shape[:-1]) + (H * Dh,))
        x = x + _dense(att, self.wo)
        return self._mlp(x)

    def _decode(self, x, q, k, v, positions, cache):
        """Append this chunk's compact kv at ``positions[0]`` (in place)
        and attend over everything written so far, with the numerics of
        ``dense_attention`` (scale folded into q, -inf masking), so a
        decoded token is logit-identical to the full forward."""
        if self.axis is not None:
            raise ValueError(
                "decode with a KV cache is a single-device path; the "
                "serve engine handles PP/TP sharding itself "
                "(bluefog_tpu_torch.serve.engine)")
        H, Hkv, Dh = self.num_heads, self.num_kv_heads, self.head_dim
        B, T = x.shape[:2]
        offset = int(positions[0])
        cache["k"][:, offset:offset + T] = k.to(cache["k"].dtype)
        cache["v"][:, offset:offset + T] = v.to(cache["v"].dtype)
        ck, cv = cache["k"], cache["v"]
        if Hkv != H:
            ck = ck.repeat_interleave(H // Hkv, dim=2)
            cv = cv.repeat_interleave(H // Hkv, dim=2)
        L = ck.shape[1]
        ct = _floor(q.dtype)
        s = torch.einsum("bthd,bshd->bths", q.to(ct) * (Dh ** -0.5),
                         ck.to(ct))
        valid = (torch.arange(L, device=x.device)[None, :]
                 <= (offset + torch.arange(T, device=x.device))[:, None])
        s = s.masked_fill(~valid[None, :, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("bths,bshd->bthd", p, cv.to(ct)).to(q.dtype)
        att = att.to(self.dtype).reshape(B, T, H * Dh)
        x = x + _dense(att, self.wo)
        return self._mlp(x), cache


class RingTransformerLM(nn.Module):
    """Small GPT-style LM over token ids ``[B, T]``, or ``[n, B, T/n]``
    for ``n`` stacked sequence ranks when ``axis`` is set.  Positions are
    global: ``pos_offset + arange(T)`` by default, or ``positions``
    (``[T]``; ``[n, T/n]`` stacked) for the zigzag layout
    (:func:`~bluefog_tpu_torch.ops.ring.zigzag_positions`).  Learned
    position embeddings unless ``rope``.  ``remat`` recomputes each block
    in the backward (``torch.utils.checkpoint``)."""

    def __init__(self, vocab_size: int = 32000, num_layers: int = 4,
                 num_heads: int = 8, num_kv_heads: Optional[int] = None,
                 d_model: int = 512, max_seq_len: int = 8192,
                 axis: Optional[str] = None,
                 dtype: torch.dtype = torch.bfloat16, sp_mode: str = "ring",
                 sp_layout: str = "contiguous", rope: bool = False,
                 remat: bool = False, use_pallas: bool = False,
                 mlp_ratio: int = 4):
        super().__init__()
        self.num_layers, self.d_model = num_layers, d_model
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.axis, self.dtype, self.rope, self.remat = axis, dtype, rope, remat
        self.embed = nn.Parameter(torch.zeros(vocab_size, d_model))
        self.pos_embed = (None if rope else
                          nn.Parameter(torch.zeros(max_seq_len, d_model)))
        self.blocks = nn.ModuleList(
            RingTransformerBlock(d_model, num_heads, num_kv_heads, mlp_ratio,
                                 axis, dtype, sp_mode, sp_layout, rope,
                                 use_pallas)
            for _ in range(num_layers))
        self.ln_f_scale = nn.Parameter(torch.ones(d_model))
        self.ln_f_bias = nn.Parameter(torch.zeros(d_model))
        self.head = nn.Parameter(torch.zeros(d_model, vocab_size))

    @property
    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs per token at ``seq_len`` tokens of context: 6N
        plus the attention products, 6 L C T (the JAX accounting, as
        ``parallel.compose.LMConfig.flops_per_token``)."""
        return (6.0 * self.n_params
                + 6.0 * self.num_layers * self.d_model * seq_len)

    def reset_parameters(self, seed: int = 0) -> "RingTransformerLM":
        """The port's own seeded init (an explicit ``torch.Generator`` on
        the CPU, then copied to the parameters' device): flax's defaults
        in kind -- Dense kernels lecun-normal (truncated at 2 sigma),
        embeddings normal with std ``1/sqrt(d_model)``, biases 0,
        LayerNorm scales 1."""
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("embed", "pos_embed"):
                    w = torch.randn(p.shape, generator=g) / math.sqrt(
                        self.d_model)
                elif leaf in ("wqkv", "wo", "w1", "w2", "head"):
                    std = 1.0 / math.sqrt(p.shape[0]) / .87962566103423978
                    w = torch.nn.init.trunc_normal_(
                        torch.empty(p.shape), std=std, a=-2 * std,
                        b=2 * std, generator=g)
                elif "scale" in leaf:
                    w = torch.ones(p.shape)
                else:
                    w = torch.zeros(p.shape)
                p.copy_(w)
        return self

    def forward(self, tokens: torch.Tensor, pos_offset: int = 0,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Sequence[dict]] = None):
        """Logits ``[..., T, vocab]`` at the f32 floor; with ``cache`` (a
        decode step: ``tokens`` is the next chunk, ``pos_offset`` the
        tokens already cached) ``(logits, cache)``, the cache updated in
        place."""
        T = tokens.shape[-1]
        if self.axis is not None and tokens.ndim != 3:
            raise ValueError("stacked ranks want tokens [n, B, T/n]")
        x = self.embed.to(self.dtype)[tokens]
        if positions is None:
            positions = pos_offset + torch.arange(T, device=tokens.device)
            if self.axis is not None:
                n = tokens.shape[0]
                positions = positions + T * torch.arange(
                    n, device=tokens.device)[:, None]
        if not self.rope:
            pos = self.pos_embed.to(self.dtype)[positions.long()]
            x = x + (pos[:, None] if positions.ndim == 2 else pos[None])
        if cache is not None:
            if self.axis is not None:
                raise ValueError(
                    "decode with a KV cache is a single-device path; the "
                    "serve engine handles sharding "
                    "(bluefog_tpu_torch.serve)")
            if len(cache) != self.num_layers:
                raise ValueError(
                    f"cache has {len(cache)} layer entries, model has "
                    f"{self.num_layers} (init_decode_cache builds one)")
            for blk, c in zip(self.blocks, cache):
                x, _ = blk(x, positions, cache=c)
        else:
            for blk in self.blocks:
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(blk, x, positions, use_reentrant=False)
                else:
                    x = blk(x, positions)
        x = _layer_norm(x, self.ln_f_scale, self.ln_f_bias)
        logits = _dense(x, self.head, dtype=_floor(x.dtype))
        return logits if cache is None else (logits, cache)


def init_decode_cache(model: RingTransformerLM, batch: int, max_len: int,
                      dtype: Optional[torch.dtype] = None,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Tuple[dict, ...]:
    """A zeroed per-layer KV cache for the decode path: ``{"k", "v"}``
    ``[batch, max_len, num_kv_heads, head_dim]`` per layer (the compact
    kv heads), on the model's device unless ``device`` is given."""
    Hkv = model.num_kv_heads or model.num_heads
    Dh = model.d_model // model.num_heads
    dt = model.dtype if dtype is None else dtype
    dev = model.embed.device if device is None else resolve_device(device)
    return tuple({"k": torch.zeros(batch, max_len, Hkv, Dh, dtype=dt,
                                   device=dev),
                  "v": torch.zeros(batch, max_len, Hkv, Dh, dtype=dt,
                                   device=dev)}
                 for _ in range(model.num_layers))


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The long-context example's loss of each stacked rank (``[n]``; a
    plain ``[B, T]`` batch is one rank): the mean cross entropy over its
    targets ``>= 0`` (``-1`` masks a position).  The example reports
    their mean and steps on the gradient of their sum (JAX ``psum``)."""
    if logits.ndim == 3:
        logits, targets = logits[None], targets[None]
    n, V = logits.shape[0], logits.shape[-1]
    mask = (targets >= 0).to(logits.dtype)
    ce = F.cross_entropy(logits.reshape(-1, V),
                         targets.clamp(min=0).reshape(-1).long(),
                         reduction="none").reshape(targets.shape)
    return (ce * mask).reshape(n, -1).sum(1) / mask.reshape(
        n, -1).sum(1).clamp(min=1.0)


_BLOCK_LEAVES = {
    ("LayerNorm_0", "scale"): "ln1_scale", ("LayerNorm_0", "bias"): "ln1_bias",
    ("Dense_0", "kernel"): "wqkv", ("Dense_1", "kernel"): "wo",
    ("LayerNorm_1", "scale"): "ln2_scale", ("LayerNorm_1", "bias"): "ln2_bias",
    ("Dense_2", "kernel"): "w1", ("Dense_2", "bias"): "b1",
    ("Dense_3", "kernel"): "w2", ("Dense_3", "bias"): "b2"}
_TOP_LEAVES = {
    ("Embed_0", "embedding"): "embed", ("LayerNorm_0", "scale"): "ln_f_scale",
    ("LayerNorm_0", "bias"): "ln_f_bias", ("Dense_0", "kernel"): "head"}


def _block_trees(params: Mapping[str, Any], num_layers: int):
    """Each layer's flax subtree, from the unrolled tree
    (``RingTransformerBlock_i`` or, under remat,
    ``CheckpointRingTransformerBlock_i``) or the scanned one (``blocks``
    with a leading ``[num_layers]``)."""
    if "blocks" in params:
        scanned = params["blocks"]
        depth = len(np.asarray(scanned["Dense_0"]["kernel"]))
        trees = [{m: {k: np.asarray(v)[i] for k, v in leaves.items()}
                  for m, leaves in scanned.items()} for i in range(depth)]
    else:
        prefix = next((p for p in ("RingTransformerBlock_",
                                   "CheckpointRingTransformerBlock_")
                       if p + "0" in params), None)
        if prefix is None:
            raise ValueError("no RingTransformerBlock_* or scanned 'blocks' "
                             "subtree in the param tree")
        trees = []
        while f"{prefix}{len(trees)}" in params:
            trees.append(params[f"{prefix}{len(trees)}"])
    if len(trees) != num_layers:
        raise ValueError(f"the param tree has {len(trees)} blocks, the "
                         f"model {num_layers}")
    return trees


def params_from_jax(tree: Mapping[str, Any], model: RingTransformerLM
                    ) -> RingTransformerLM:
    """Copy a flax ``RingTransformerLM`` param tree (``{"params": ...}`` or
    its inside; leaves numpy arrays or anything ``np.asarray`` takes)
    into ``model``: the unrolled or the scanned tree; Dense kernels stay
    ``[in, out]``.  Returns ``model``."""
    params = tree.get("params", tree)

    def put(p: torch.Tensor, value) -> None:
        a = np.asarray(value)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"param of shape {a.shape} for a module "
                             f"parameter of shape {tuple(p.shape)}")
        p.copy_(torch.as_tensor(np.array(a, dtype=np.float64)).to(p))

    blocks = _block_trees(params, model.num_layers)
    with torch.no_grad():
        for (mod, leaf), name in _TOP_LEAVES.items():
            put(getattr(model, name), params[mod][leaf])
        if model.pos_embed is not None:
            put(model.pos_embed, params["Embed_1"]["embedding"])
        for blk, sub in zip(model.blocks, blocks):
            for (mod, leaf), name in _BLOCK_LEAVES.items():
                put(getattr(blk, name), sub[mod][leaf])
    return model
