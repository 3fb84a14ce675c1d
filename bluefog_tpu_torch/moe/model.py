"""The routed-MoE LM (counterpart of ``bluefog_tpu/moe/model.py``):
serving at any dp x pp x tp x ep carving, and training at any gossip-DP x
pipeline x tensor x Ulysses x expert carving, with dropless or capacity
dispatch and top-k or expert-choice routing.

:class:`MoELMConfig` keeps the JAX fields, defaults, env surface and
rules (with their error texts and order).  :class:`MoELM` is
the composed LM with every block's dense FFN replaced by the routed
dropless expert FFN: blocks hold ``wqkv``, ``wo``, ``wr [D, E]``, ``w1e
[E, D, F]`` and ``w2e [E, F, D]`` in the JAX orientation.
:func:`init_moe_params` draws bit-identical weights to the JAX
``init_moe_params`` (the serving module); :func:`moe_params_from_jax`
loads a JAX MoE tree: replica 0 as one module (at ep > 1 its ep peers'
experts joined), or with the carving ``m`` every replica and peer in the
serving engine's layout.

Training: :func:`init_moe_train_params` and :func:`make_moe_batch` are
the JAX tree and tokens bit for bit, stacked ``[n, ...]`` per peer as in
:mod:`bluefog_tpu_torch.parallel.compose`; :func:`make_moe_grad_fn` is
the JAX gradient recipe (see the JAX module's docstring) for one DP
replica's peers at once, on the composed trainer's machinery
(``compose._replica_fns``): GPipe ticks, tp as a batched product with
psums, Ulysses over sp around K1/K2, the expert axis's ``all_to_all``s
over the stacked ep peers, and every live stage, tp, sp and ep peer of a
tick folded into ONE dropless dispatch and ONE grouped-FFN call a layer
(K4 and its hand-written backward on the card).  Capacity dispatch and
expert choice compute their experts with ``torch.matmul``, as JAX does
with an einsum (no TPU kernel there).  The per-layer aux / z / metric
channels ride the pipeline on carrier rows appended to the activations,
so their cotangents reach every stage's routers.  :func:`make_moe_probe`
returns the routing-health scalars.
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
from ..parallel import compose as _compose
from ..parallel.compose import AttnBlock, ComposeLM, LMConfig, Mesh3D, _ln
from . import layers as _layers

__all__ = ["MoELMConfig", "MoEBlock", "MoELM", "init_moe_params",
           "moe_params_from_jax", "init_moe_train_params", "make_moe_batch",
           "make_moe_grad_fn", "make_moe_probe"]

# carrier-row channel layout (written once per layer, summed over layers):
# 0 aux (load balance), 1 router-z, 2 dropped fraction, 3 mean token
# entropy, 4 expert-choice coverage (0 under top-k routing), 5 reserved,
# 6.. per-expert dispatch fraction; d_model must hold them all
_CH_FIXED = 6


def _axes(m: Optional[Mesh3D]):
    """``(pp, tp, sp, ep, num_experts)`` of a carving (all 1 and None
    without one: the serving rules)."""
    if m is None:
        return 1, 1, 1, 1, None
    return m.pp, m.tp, m.sp, m.ep, m.num_experts


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

    def validate(self, m: Optional[Mesh3D] = None) -> None:
        """The JAX rules for the carving ``m`` (pp = tp = sp = ep = 1
        without one, as the serving engine calls it), in the JAX order
        and with its texts."""
        super().validate(m)
        _, tp, sp, ep, m_experts = _axes(m)
        E = self.num_experts
        if self.top_k not in (1, 2):
            raise ValueError(f"top_k ({self.top_k}) must be 1 or 2")
        if not isinstance(E, int) or E < 1:
            raise ValueError(f"num_experts ({E!r}) must be a positive int")
        if E % ep:
            raise ValueError(
                f"num_experts ({E}) % ep ({ep}) != 0: each expert peer "
                "owns a contiguous block of num_experts // ep experts")
        if m_experts is not None and m_experts != E:
            raise ValueError(
                f"carving was validated for num_experts={m_experts} "
                f"but the model has {E}")
        if self.batch % ep:
            raise ValueError(
                f"batch ({self.batch}) % ep ({ep}) != 0: the expert "
                "axis shards the global microbatch")
        if (self.ffn_mult * self.d_model) % tp:
            raise ValueError(
                f"expert hidden ({self.ffn_mult * self.d_model}) % tp "
                f"({tp}) != 0")
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
            if sp != 1:
                raise ValueError(
                    f"router_mode='expert_choice' requires sp=1 (got "
                    f"sp={sp}): experts select their top-C tokens over "
                    "the whole sequence dimension")
            if self.ec_capacity(m) > self.seq_len // sp:
                raise ValueError(
                    f"expert-choice capacity ({self.ec_capacity(m)}) > "
                    f"local seq_len ({self.seq_len // sp}): raise "
                    "num_experts or shrink top_k")

    def capacity(self, m: Optional[Mesh3D] = None) -> int:
        """Static per-(source, expert, choice) slot count for one
        capacity dispatch: ``ceil(capacity_factor * local_tokens /
        num_experts)`` over the ``batch/ep * seq_len/sp`` tokens of one
        microbatch."""
        _, _, sp, ep, _ = _axes(m)
        tokens = (self.batch // ep) * (self.seq_len // sp)
        return max(1, math.ceil(
            float(self.capacity_factor) * tokens / self.num_experts))

    def ec_capacity(self, m: Optional[Mesh3D] = None) -> int:
        """Expert-choice top-C per (expert, batch row):
        ``ceil(top_k * (seq_len / sp) / num_experts)``."""
        sp = _axes(m)[2]
        return max(1, math.ceil(self.top_k * (self.seq_len // sp)
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
                        device: Optional[Union[str, torch.device]] = None,
                        m: Optional[Mesh3D] = None
                        ) -> Union[MoELM, "_compose.ServingParams"]:
    """Build the port's MoE LM from a JAX ``init_moe_params`` tree (leaves
    stacked ``[n_devices, ...]`` as numpy arrays or anything
    ``np.asarray`` takes).

    With ``m``, the carving the tree was made for (dp, pp, tp, sp, ep),
    the whole carving loads into the serving engine's layout
    (:class:`~bluefog_tpu_torch.parallel.compose.ServingParams` on
    ``device``, default ``m.device``): every replica's rows, each
    owner's ``E / ep`` experts cut ``F / tp`` by its tp peer, the router
    once a replica (replicated over tp and ep).

    Without ``m`` the tree must be carved at pp = tp = 1 and replica 0
    is served: at ep = 1 row 0; carved at ep > 1, rows ``0 .. ep - 1``
    (replica 0's expert peers, ep innermost in the flat order) each hold
    ``E / ep`` experts, joined along the expert axis in owner order."""
    if m is not None:
        D, E = cfg.d_model, cfg.num_experts
        Dl, Fl, El = D // m.tp, cfg.ffn_mult * D // m.tp, E // m.ep
        return _compose._serving_from_tree(tree, cfg, m, device, [
            ("blocks", "wqkv", "wqkv", (D, 3 * Dl), ("tp",)),
            ("blocks", "wo", "wo", (Dl, D), ("tp",)),
            ("router", "wr", "wr", (D, E), ()),
            ("experts", "w1", "w1e", (El, D, Fl), ("tp", "ep")),
            ("experts", "w2", "w2e", (El, Fl, D), ("tp", "ep"))])
    dev = resolve_device(device)
    E, D = cfg.num_experts, cfg.d_model
    want = (cfg.layers, E, D, cfg.ffn_mult * D)
    w1 = np.asarray(tree["experts"]["w1"])
    got = w1.shape[1:]
    e_local = got[1] if len(got) == 4 else 0
    ep = E // e_local if e_local and E % e_local == 0 else 0
    if not ep or got[:1] + got[2:] != want[:1] + want[2:] \
            or w1.shape[0] % ep:
        raise ValueError(f"experts w1 [n, {got}] != [n, {want}] (or [n, "
                         f"layers, E / ep, ...]): the tree must be a pp = "
                         "tp = 1 carving of this MoELMConfig")

    def experts(name):
        return np.concatenate(list(np.asarray(tree["experts"][name])[:ep]),
                              axis=1)

    row0 = {k: np.asarray(v)[0] for k, v in tree["blocks"].items()}
    blocks = {"wqkv": row0["wqkv"], "wo": row0["wo"],
              "wr": np.asarray(tree["router"]["wr"])[0],
              "w1e": experts("w1"), "w2e": experts("w2")}
    shared = tree["shared"]
    return _load(MoELM(cfg), blocks, np.asarray(shared["embed"])[0],
                 np.asarray(shared["head"])[0]).to(dev)


# ---------------------------------------------------------------------------
# Training: stacked params, batches, the per-replica gradient and the probe
# ---------------------------------------------------------------------------

def init_moe_train_params(cfg: MoELMConfig, m: Mesh3D, seed: int = 0, *,
                          dense_equiv: bool = False,
                          dtype: torch.dtype = torch.float32) -> dict:
    """The JAX ``init_moe_params(cfg, m, seed, dtype, dense_equiv=...)``
    tree, bit for bit, every leaf stacked ``[n, ...]`` on ``m.device`` in
    ``dtype`` (JAX's numpy cast of the float64 draws rounds through f32,
    as this does):
    ``blocks`` (``wqkv``, ``wo``: owner ``(s, t)``'s tp shard of ``[pp,
    tp, layers / pp, ...]``), ``router`` (``wr``, stage s's ``[layers /
    pp, D, E]``), ``experts`` (``w1`` / ``w2``: the experts drawn at the
    full ``[pp, layers / pp, E, D, F]`` and ``[..., F, D]`` and cut per
    (stage, tp, ep) owner: ep peer e's ``E / ep`` experts, columns of w1
    and rows of w2) and ``shared`` (``embed``, ``head`` on every peer).
    So carvings that differ only in ep share every value.
    ``dense_equiv`` (the float64 oracle's twin, every expert local)
    refuses ep != 1 with the JAX text."""
    cfg.validate(m)
    if dense_equiv and m.ep != 1:
        raise ValueError("dense_equiv keeps every expert local — carve "
                         f"ep=1, not ep={m.ep}")
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.ffn_mult * cfg.d_model, cfg.num_experts
    Lps, TP = cfg.layers // m.pp, m.tp
    Fl, El = F // TP, E // m.ep

    def w(*shape, scale=0.1):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    blocks = {"wqkv": w(m.pp, TP, Lps, D, 3 * D // TP),
              "wo": w(m.pp, TP, Lps, D // TP, D)}
    wr_full = w(m.pp, Lps, D, E)
    w1_full = w(m.pp, Lps, E, D, F)
    w2_full = w(m.pp, Lps, E, F, D)
    shared = {"embed": w(cfg.vocab, D), "head": w(D, cfg.vocab)}
    _, s, t, _, e = _compose._coords(m)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(m.device).to(
            dtype)

    def per_peer(cut):
        return torch.stack([dev(cut(si, ti)[:, ei * El:(ei + 1) * El])
                            for si, ti, ei in zip(s, t, e)])

    def stack(a):
        x = dev(a)
        return x.unsqueeze(0).expand((m.size,) + a.shape).contiguous()

    return {
        "blocks": {k: dev(v[s, t]) for k, v in blocks.items()},
        "router": {"wr": dev(wr_full[s])},
        "experts": {
            "w1": per_peer(lambda si, ti: w1_full[si][
                ..., ti * Fl:(ti + 1) * Fl]),
            "w2": per_peer(lambda si, ti: w2_full[si][
                :, :, ti * Fl:(ti + 1) * Fl, :])},
        "shared": {k: stack(v) for k, v in shared.items()},
    }


def make_moe_batch(cfg: MoELMConfig, m: Mesh3D, seed: int = 0,
                   steps: Optional[int] = None) -> torch.Tensor:
    """Copy-task tokens stacked per peer, ``[n, (steps,) micro, batch /
    ep, seq_len / sp]`` int32: the JAX ``make_moe_batch`` bit for bit.
    Each replica draws its own global batch (the draw of
    :func:`~bluefog_tpu_torch.parallel.compose.make_lm_batch`); ep peer
    e takes its contiguous rows ``e * batch / ep ..``, so carvings that
    differ only in ep train on the same data."""
    rng = np.random.default_rng(seed)
    shape = (m.dp, cfg.micro, cfg.batch, cfg.seq_len) if steps is None \
        else (m.dp, steps, cfg.micro, cfg.batch, cfg.seq_len)
    data = rng.integers(0, cfg.vocab, size=shape).astype(np.int32)
    Tl, Bl = cfg.seq_len // m.sp, cfg.batch // m.ep
    r, _, _, u, e = _compose._coords(m)
    per_peer = np.stack(
        [data[ri][..., ei * Bl:(ei + 1) * Bl, ui * Tl:(ui + 1) * Tl]
         for ri, ui, ei in zip(r, u, e)])
    return torch.from_numpy(per_peer).to(m.device)


def _moe_replica(cfg: MoELMConfig, m: Mesh3D, *, remat: bool,
                 dense_equiv: bool):
    """``(grad_fn, probe)`` of one replica (``compose._replica_fns``)."""
    cfg.validate(m)
    if dense_equiv and m.ep != 1:
        raise ValueError("dense_equiv keeps every expert local — carve "
                         f"ep=1, not ep={m.ep}")
    E, k, L = cfg.num_experts, cfg.top_k, cfg.layers
    n_ch = _CH_FIXED + E
    Tl = cfg.seq_len // m.sp
    ec = cfg.router_mode == "expert_choice"
    ec_cap = cfg.ec_capacity(m) if ec else 0
    cap = cfg.capacity(m)
    attn = _compose._attention(cfg, m, use_pallas=False)

    def layer_fn(lp, x, cos, sin):
        # x [kst, TP, SP, EP, B / EP * Tl, D]: every live stage, tp, sp
        # and ep peer; the sublayer is picked in the JAX order
        x = attn(lp["blocks"], x, cos, sin)
        h = _ln(x)
        wr, w1, w2 = lp["router"]["wr"], lp["experts"]["w1"], \
            lp["experts"]["w2"]
        seqs = h.shape[:-2] + (-1, Tl, h.shape[-1])       # [.., B, Tl, D]
        if ec and dense_equiv:
            y, st = _layers.moe_ffn_dense_ec(h.reshape(seqs), wr, w1, w2,
                                             capacity=ec_cap, tp_dim=1)
        elif ec:
            y, st = _layers.moe_ffn_expert_choice(
                h.reshape(seqs), wr, w1, w2, num_experts=E, capacity=ec_cap,
                tp_dim=1, ep_dim=3)
        elif dense_equiv:
            y, st = _layers.moe_ffn_dense(h, wr, w1, w2, top_k=k, tp_dim=1)
        elif cfg.dispatch == "dropless":
            y, st = _layers.moe_ffn_dropless(h, wr, w1, w2, num_experts=E,
                                             top_k=k, tile=cfg.group_tile,
                                             tp_dim=1, ep_dim=3)
        else:
            y, st = _layers.moe_ffn_routed(h, wr, w1, w2, num_experts=E,
                                           top_k=k, capacity=cap, tp_dim=1,
                                           ep_dim=3)
        zero = torch.zeros_like(st["aux"])
        cover = st["coverage"].detach() if "coverage" in st else zero
        vec = torch.cat([torch.stack([
            st["aux"], st["z"], st["dropped"].detach(),
            st["entropy"].detach(), cover, zero], -1),
            st["usage"].detach().to(x.dtype)], -1)
        return x + y.reshape(x.shape), vec

    def channel_loss(ch):                # ch [SP, EP, n_ch]
        return (cfg.aux_alpha * ch[..., 0] / L
                + cfg.z_alpha * ch[..., 1] / L).mean()

    return _compose._replica_fns(
        cfg, m, layer_fn,
        sums={"blocks": (2, 3), "experts": (2,), "router": (1, 2, 3),
              "shared": (0, 1, 2, 3)},
        remat=remat, n_ch=n_ch, channel_loss=channel_loss, ep_batch=True)


def make_moe_grad_fn(cfg: MoELMConfig, m: Mesh3D, *, remat: bool = False,
                     dense_equiv: bool = False):
    """``grad_fn(params, toks) -> (loss, grads)`` for one DP replica of the
    routed-MoE LM, with the contract of
    :func:`~bluefog_tpu_torch.parallel.compose.make_lm_grad_fn` (one
    replica's ``slice_size`` peers stacked in the flat (s, t, u, e)
    order; :func:`~bluefog_tpu_torch.parallel.compose.make_train_step`
    drives it).

    The JAX recipe (see the JAX module's docstring).  Each layer's expert
    FFN is, in the JAX order: expert choice (its dense twin under
    ``dense_equiv``), the dense-equivalent twin, the dropless sublayer
    (:func:`~bluefog_tpu_torch.moe.layers.moe_ffn_dropless`: every live
    stage, tp, sp and ep peer of a GPipe tick in one dispatch and one K4
    call, so K4 and its backward pair each run ``(micro + pp - 1) *
    layers / pp`` times a call, twice the forwards under ``remat``), or
    capacity dispatch (:func:`~bluefog_tpu_torch.moe.layers.
    moe_ffn_routed`).  The expert outputs are summed over tp before the
    gate-weighted combine, and the per-layer aux / z / metric channels
    ride carrier rows through the pipeline.  Each ep peer holds ``batch /
    ep`` rows; the router statistics are global over the ep peers (sums
    of ``1 / ep``-scaled shard means), and the loss is the mean over the
    sp and ep peers of ``ce + aux_alpha * ch[0] / L + z_alpha * ch[1] /
    L`` on the last stage (JAX's ``(ce + aux + z) / ep`` summed over the
    expert axis).  The reductions outside autograd are the JAX ones:
    shared grads over (stage, tp), router grads over tp, then the loss
    and the shared, block and router grads over the ep peers (global-
    batch partials), everything over sp (the port's partials carry the
    1/sp of the mean, so those are sums); expert grads stay sharded over
    ep, each owner's complete.  ``dense_equiv`` computes every expert on
    every token instead (the JAX float64 oracle's twin; ep 1 only)."""
    return _moe_replica(cfg, m, remat=remat, dense_equiv=dense_equiv)[0]


def make_moe_probe(cfg: MoELMConfig, m: Mesh3D, *,
                   dense_equiv: bool = False):
    """``probe(params, toks) -> dict``: the JAX probe's routing-health
    scalars of replica 0 (the last stage's carrier, mean over
    microbatches and the sp and ep peers, divided by the layer count):
    ``aux_loss``, ``z_loss``, ``dropped_fraction``, ``token_entropy``,
    ``ec_coverage``, per-expert ``usage`` and its ``usage_entropy``
    (nats), and ``ce``.
    A forward without a graph, outside any timed step."""
    probe_fn = _moe_replica(cfg, m, remat=False, dense_equiv=dense_equiv)[1]
    L, E = cfg.layers, cfg.num_experts

    def probe(params, toks):
        ce, ch = probe_fn(params, toks)
        row = ch.float().cpu().numpy()
        usage = row[_CH_FIXED:_CH_FIXED + E] / L
        u = np.clip(usage / max(usage.sum(), 1e-20), 1e-20, 1.0)
        return {
            "aux_loss": float(row[0] / L),
            "z_loss": float(row[1] / L),
            "dropped_fraction": float(row[2] / L),
            "token_entropy": float(row[3] / L),
            "ec_coverage": float(row[4] / L),
            "usage": [float(x) for x in usage],
            "usage_entropy": float(-(u * np.log(u)).sum()),
            "ce": float(ce),
        }

    return probe
