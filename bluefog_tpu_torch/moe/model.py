"""The routed-MoE LM (counterpart of ``bluefog_tpu/moe/model.py``) at
pp = tp = sp = ep = 1, for serving.

:class:`MoELMConfig` keeps the JAX fields, defaults, env surface and
rules (with their error texts, at ep = 1).  :class:`MoELM` is the
composed LM with every block's dense FFN replaced by the routed dropless
expert FFN: blocks hold ``wqkv``, ``wo``, ``wr [D, E]``, ``w1e [E, D, F]``
and ``w2e [E, F, D]`` in the JAX orientation.  :func:`init_moe_params`
draws bit-identical weights to the JAX ``init_moe_params``;
:func:`moe_params_from_jax` loads a JAX MoE tree.  Training (aux and z
losses, the metrics carrier, capacity dispatch) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..parallel.compose import AttnBlock, ComposeLM, LMConfig, _ln
from . import layers as _layers

__all__ = ["MoELMConfig", "MoEBlock", "MoELM", "init_moe_params",
           "moe_params_from_jax"]

# the JAX training carrier row's fixed channels; its width d_model must
# also hold one usage channel per expert
_CH_FIXED = 6


@dataclasses.dataclass(frozen=True)
class MoELMConfig(LMConfig):
    """Shape of the routed-MoE LM: the dense fields (``ffn_mult`` sizes
    each expert's hidden layer) plus the JAX MoE fields and defaults."""
    num_experts: int = 8
    top_k: int = 1           # 1 (Switch) or 2 (classic mixture)
    capacity_factor: float = 1.25
    aux_alpha: float = 1e-2  # load-balance loss weight
    z_alpha: float = 1e-3    # router z-loss weight
    router_mode: str = "topk"      # "topk" | "expert_choice"
    dispatch: str = "capacity"     # "capacity" | "dropless"
    group_tile: int = 8            # dropless grouped-GEMM tile rows

    @classmethod
    def from_env(cls, **overrides) -> "MoELMConfig":
        """Defaults from ``BLUEFOG_MOE_*`` env knobs (explicit kwargs
        win): ``BLUEFOG_MOE_EXPERTS``, ``BLUEFOG_MOE_TOPK``,
        ``BLUEFOG_MOE_CAPACITY_FACTOR``, ``BLUEFOG_MOE_AUX_ALPHA``,
        ``BLUEFOG_MOE_Z_ALPHA``, ``BLUEFOG_MOE_ROUTER``,
        ``BLUEFOG_MOE_DISPATCH``, ``BLUEFOG_MOE_TILE``."""
        env = {}
        for key, name, cast in (
                ("num_experts", "BLUEFOG_MOE_EXPERTS", int),
                ("top_k", "BLUEFOG_MOE_TOPK", int),
                ("capacity_factor", "BLUEFOG_MOE_CAPACITY_FACTOR", float),
                ("aux_alpha", "BLUEFOG_MOE_AUX_ALPHA", float),
                ("z_alpha", "BLUEFOG_MOE_Z_ALPHA", float),
                ("router_mode", "BLUEFOG_MOE_ROUTER", str),
                ("dispatch", "BLUEFOG_MOE_DISPATCH", str),
                ("group_tile", "BLUEFOG_MOE_TILE", int)):
            raw = os.environ.get(name)
            if raw is not None:
                try:
                    env[key] = cast(raw)
                except ValueError as e:
                    raise ValueError(f"{name}={raw!r}: {e}") from None
        env.update(overrides)
        return cls(**env)

    def validate(self) -> None:
        """The JAX rules at pp = tp = sp = ep = 1, in the JAX order."""
        super().validate()
        E = self.num_experts
        if self.top_k not in (1, 2):
            raise ValueError(f"top_k ({self.top_k}) must be 1 or 2")
        if not isinstance(E, int) or E < 1:
            raise ValueError(f"num_experts ({E!r}) must be a positive int")
        if self.d_model < _CH_FIXED + E:
            raise ValueError(
                f"d_model ({self.d_model}) < {_CH_FIXED} + num_experts "
                f"({E}): the metrics carrier row stores per-expert usage "
                "in the channel dimension")
        if not (isinstance(self.capacity_factor, (int, float))
                and self.capacity_factor > 0):
            raise ValueError(
                f"capacity_factor ({self.capacity_factor!r}) must be > 0")
        if self.dispatch not in ("capacity", "dropless"):
            raise ValueError(
                f"dispatch ({self.dispatch!r}) must be 'capacity' or "
                "'dropless'")
        if self.router_mode not in ("topk", "expert_choice"):
            raise ValueError(
                f"router_mode ({self.router_mode!r}) must be 'topk' or "
                "'expert_choice'")
        if not isinstance(self.group_tile, int) or self.group_tile < 1:
            raise ValueError(
                f"group_tile ({self.group_tile!r}) must be a positive int")
        if self.router_mode == "expert_choice":
            if self.dispatch != "dropless":
                raise ValueError(
                    "router_mode='expert_choice' requires "
                    "dispatch='dropless': expert choice has no capacity "
                    "overflow to drop, so the padded-slot path does not "
                    "apply")
            if self.ec_capacity() > self.seq_len:
                raise ValueError(
                    f"expert-choice capacity ({self.ec_capacity()}) > "
                    f"local seq_len ({self.seq_len}): raise "
                    "num_experts or shrink top_k")

    def ec_capacity(self) -> int:
        """Expert-choice top-C per (expert, batch row):
        ``ceil(top_k * seq_len / num_experts)``."""
        return max(1, math.ceil(self.top_k * self.seq_len
                                / self.num_experts))

    @property
    def n_params(self) -> int:
        """Parameter count, all experts included."""
        D, F, E = self.d_model, self.ffn_mult * self.d_model, self.num_experts
        per_block = D * 3 * D + D * D + D * E + E * (D * F + F * D)
        return self.layers * per_block + 2 * self.vocab * D

    @property
    def n_active_params(self) -> int:
        """Parameters a single token activates (top-k experts only)."""
        D, F, E = self.d_model, self.ffn_mult * self.d_model, self.num_experts
        per_block = (D * 3 * D + D * D + D * E
                     + self.top_k * (D * F + F * D))
        return self.layers * per_block + 2 * self.vocab * D

    def flops_per_token(self) -> float:
        return (6.0 * self.n_active_params
                + 6.0 * self.layers * self.d_model * self.seq_len)

    def dense_twin(self) -> LMConfig:
        """The dense LM with the same active FFN parameters per token:
        ``ffn_mult = top_k * ffn_mult``, every other dense field copied."""
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(LMConfig)}
        fields["ffn_mult"] = self.top_k * self.ffn_mult
        return LMConfig(**fields)


class MoEBlock(AttnBlock):
    """A decoder block whose FFN is the routed dropless expert FFN."""

    def __init__(self, cfg: MoELMConfig):
        super().__init__(cfg.d_model)
        D, F, E = cfg.d_model, cfg.ffn_mult * cfg.d_model, cfg.num_experts
        self.wr = nn.Parameter(torch.empty(D, E))
        self.w1e = nn.Parameter(torch.empty(E, D, F))
        self.w2e = nn.Parameter(torch.empty(E, F, D))
        self.num_experts, self.top_k = E, cfg.top_k
        self.group_tile = cfg.group_tile

    def ffn(self, x: torch.Tensor, tile: Optional[int] = None):
        """Top-k router, dropless grouped expert FFN (tile ``tile``,
        default ``group_tile``), gate-weighted combine, residual.  Returns
        ``(x, (probs, idx))``: the routing feeds the engine's hot-expert
        statistics."""
        shp = x.shape
        hf = _ln(x).reshape(-1, shp[-1])
        _, probs, idx, gate = _layers.router_topk(hf, self.wr,
                                                  top_k=self.top_k)
        y = _layers.moe_dropless_combine(
            hf, idx, gate, self.w1e, self.w2e, num_experts=self.num_experts,
            tile=self.group_tile if tile is None else tile)
        return x + y.reshape(shp), (probs, idx)


class MoELM(ComposeLM):
    """The MoE LM's weights and its cache-free forward (the reference the
    serving engine is checked against)."""

    def _block(self, cfg: MoELMConfig) -> MoEBlock:
        return MoEBlock(cfg)


def _load(model: MoELM, blocks: Mapping[str, Any], embed: Any,
          head: Any) -> MoELM:
    with torch.no_grad():
        model.embed.copy_(torch.tensor(np.asarray(embed)))
        model.head.copy_(torch.tensor(np.asarray(head)))
        for i, blk in enumerate(model.blocks):
            for name in ("wqkv", "wo", "wr", "w1e", "w2e"):
                getattr(blk, name).copy_(
                    torch.tensor(np.asarray(blocks[name][i])))
    return model.requires_grad_(False)


def init_moe_params(cfg: MoELMConfig, seed: int = 0, *,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> MoELM:
    """Random MoE LM weights as the serving module, drawn from
    ``np.random.default_rng(seed)`` with the calls of the JAX
    ``init_moe_params`` in its order (wqkv, wo, wr, w1, w2, embed, head),
    so at pp = tp = ep = 1 every array is bit-identical to the JAX one."""
    cfg.validate()
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    D, F, E, L = cfg.d_model, cfg.ffn_mult * cfg.d_model, cfg.num_experts, \
        cfg.layers

    def w(*shape, scale=0.1):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    blocks = {"wqkv": w(L, D, 3 * D), "wo": w(L, D, D), "wr": w(L, D, E),
              "w1e": w(L, E, D, F), "w2e": w(L, E, F, D)}
    embed, head = w(cfg.vocab, D), w(D, cfg.vocab)
    return _load(MoELM(cfg), blocks, embed, head).to(dev)


def moe_params_from_jax(tree: Mapping[str, Any], cfg: MoELMConfig, *,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> MoELM:
    """Build the port's MoE LM from a JAX ``init_moe_params`` tree carved
    at pp = tp = ep = 1 (leaves stacked ``[n_devices, ...]`` as numpy
    arrays or anything ``np.asarray`` takes; row 0 is served)."""
    dev = resolve_device(device)
    E, D = cfg.num_experts, cfg.d_model
    want = (cfg.layers, E, D, cfg.ffn_mult * D)
    got = np.asarray(tree["experts"]["w1"]).shape[1:]
    if got != want:
        raise ValueError(f"experts w1 [n, {got}] != [n, {want}]: the tree "
                         "must be a pp = tp = ep = 1 carving of this "
                         "MoELMConfig")
    row0 = {k: np.asarray(v)[0] for k, v in tree["blocks"].items()}
    blocks = {"wqkv": row0["wqkv"], "wo": row0["wo"],
              "wr": np.asarray(tree["router"]["wr"])[0],
              "w1e": np.asarray(tree["experts"]["w1"])[0],
              "w2e": np.asarray(tree["experts"]["w2"])[0]}
    shared = tree["shared"]
    return _load(MoELM(cfg), blocks, np.asarray(shared["embed"])[0],
                 np.asarray(shared["head"])[0]).to(dev)
