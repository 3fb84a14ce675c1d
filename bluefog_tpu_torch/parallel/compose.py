"""The composed decoder LM (counterpart of the serving part of
``bluefog_tpu/parallel/compose.py``) at pp = tp = sp = 1.

Weights keep the JAX orientation (``x @ W`` with ``wqkv: [D, 3D]``,
``wo: [D, D]``, ``w1: [D, F]``, ``w2: [F, D]``, ``embed: [V, D]``,
``head: [D, V]``), so :func:`params_from_jax` is a copy, not a
transpose.  The dp x pp x tp x sp carving needs ``torch.distributed``
and comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..models.rope import apply_rope
from ..ops.ulysses import dense_attention

__all__ = ["LMConfig", "ComposeLM", "DecoderBlock", "init_lm_params",
           "params_from_jax", "_ln"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Shape of the composed decoder-only LM (same fields and defaults as
    the JAX ``LMConfig``; ``seq_len``/``micro``/``batch``/``lag`` size the
    copy-task trainer and are kept for parity)."""
    vocab: int = 64
    d_model: int = 32
    heads: int = 4
    layers: int = 4
    seq_len: int = 32
    micro: int = 4
    batch: int = 2
    lag: int = 2
    ffn_mult: int = 4

    def validate(self) -> None:
        """The JAX rules at pp = tp = sp = 1."""
        D, H = self.d_model, self.heads
        if D % H:
            raise ValueError(f"d_model ({D}) % heads ({H}) != 0")
        if (D // H) % 2:
            raise ValueError(f"head_dim ({D // H}) must be even for rope")
        if self.seq_len <= self.lag:
            raise ValueError("local sequence shorter than the copy lag")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads

    @property
    def n_params(self) -> int:
        """Dense parameter count."""
        D, F_ = self.d_model, self.ffn_mult * self.d_model
        per_block = D * 3 * D + D * D + D * F_ + F_ * D
        return self.layers * per_block + 2 * self.vocab * D


def _ln(z: torch.Tensor) -> torch.Tensor:
    """Parameter-free layer norm, eps 1e-6 (the JAX ``_ln``)."""
    mu = z.mean(-1, keepdim=True)
    return (z - mu) / torch.sqrt(z.var(-1, unbiased=False, keepdim=True)
                                 + 1e-6)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


class DecoderBlock(nn.Module):
    """One pre-LN decoder block: attention sublayer, then the gelu FFN.

    The attention itself is the caller's (dense for prefill, the paged
    cache for decode), so the block exposes the two halves around it."""

    def __init__(self, d_model: int, ffn_mult: int):
        super().__init__()
        D, F_ = d_model, ffn_mult * d_model
        self.wqkv = nn.Parameter(torch.empty(D, 3 * D))
        self.wo = nn.Parameter(torch.empty(D, D))
        self.w1 = nn.Parameter(torch.empty(D, F_))
        self.w2 = nn.Parameter(torch.empty(F_, D))

    def qkv(self, x: torch.Tensor):
        """``x: [..., D]`` -> ``(q, k, v)`` each ``[..., D]``."""
        return (_ln(x) @ self.wqkv).chunk(3, dim=-1)

    def finish(self, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
        """Residual attention output projection, then the FFN sublayer;
        ``att`` is ``[..., D]`` (heads flattened)."""
        x = x + att @ self.wo
        return x + _gelu(_ln(x) @ self.w1) @ self.w2


class ComposeLM(nn.Module):
    """The composed LM's weights and its dense forward."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model))
        self.head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab))
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg.d_model, cfg.ffn_mult)
            for _ in range(cfg.layers))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return _ln(x) @ self.head

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Causal dense forward: ``tokens [B, T]`` -> logits ``[B, T, V]``
        — the cache-free reference the serving engine is checked against."""
        B, T = tokens.shape
        H, Dh = self.cfg.heads, self.cfg.head_dim
        pos = torch.arange(T, device=tokens.device)
        x = self.embed[tokens]
        for blk in self.blocks:
            q, k, v = blk.qkv(x)
            q = apply_rope(q.reshape(B, T, H, Dh), pos)
            k = apply_rope(k.reshape(B, T, H, Dh), pos)
            att = dense_attention(q, k, v.reshape(B, T, H, Dh), causal=True)
            x = blk.finish(x, att.reshape(B, T, H * Dh))
        return self.logits(x)


def _load(model: ComposeLM, blocks: Mapping[str, Any], embed: Any,
          head: Any) -> ComposeLM:
    with torch.no_grad():
        model.embed.copy_(torch.tensor(np.asarray(embed)))
        model.head.copy_(torch.tensor(np.asarray(head)))
        for i, blk in enumerate(model.blocks):
            for name in ("wqkv", "wo", "w1", "w2"):
                getattr(blk, name).copy_(
                    torch.tensor(np.asarray(blocks[name][i])))
    return model.requires_grad_(False)


def init_lm_params(cfg: LMConfig, seed: int = 0, *,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> ComposeLM:
    """Random LM weights from ``np.random.default_rng(seed)``, drawn with
    the same calls in the same order as the JAX ``init_lm_params``, so at
    pp = tp = 1 every array is bit-identical to the JAX one."""
    cfg.validate()
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    D, F_, L = cfg.d_model, cfg.ffn_mult * cfg.d_model, cfg.layers

    def w(*shape, scale=0.1):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    blocks = {"wqkv": w(L, D, 3 * D), "wo": w(L, D, D),
              "w1": w(L, D, F_), "w2": w(L, F_, D)}
    embed, head = w(cfg.vocab, D), w(D, cfg.vocab)
    return _load(ComposeLM(cfg), blocks, embed, head).to(dev)


def params_from_jax(tree: Mapping[str, Any], cfg: LMConfig, *,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> ComposeLM:
    """Build the port's LM from a JAX ``init_lm_params`` /
    ``checkpoint.load_for_serving`` tree carved at pp = tp = 1 (leaves as
    numpy arrays or anything ``np.asarray`` takes).  Leaves come stacked
    ``[n_devices, ...]`` and every row is a replica: row 0 is taken."""
    dev = resolve_device(device)
    blocks = {k: np.asarray(v)[0] for k, v in tree["blocks"].items()}
    want = (cfg.layers, cfg.d_model, 3 * cfg.d_model)
    if blocks["wqkv"].shape != want:
        raise ValueError(f"wqkv {blocks['wqkv'].shape} != {want}: the tree "
                         "must be a pp = tp = 1 carving of this LMConfig")
    shared = tree["shared"]
    return _load(ComposeLM(cfg), blocks, np.asarray(shared["embed"])[0],
                 np.asarray(shared["head"])[0]).to(dev)
