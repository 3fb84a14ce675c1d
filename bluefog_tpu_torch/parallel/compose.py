"""The composed decoder LM (counterpart of
``bluefog_tpu/parallel/compose.py``): serving at any dp x pp x tp (x
ep) carving (:class:`ServingParams`: every replica's and peer's weights
as the serving engine reads them; a module is the carving of size 1;
the speculative draft is a prefix of the stages, :func:`draft_carve`),
and training at any gossip-DP x pipeline x tensor x Ulysses x expert
carving.  The MoE LM (:mod:`bluefog_tpu_torch.moe.model`) reuses the
attention half, :class:`AttnBlock`, and brings its own FFN.

Weights keep the JAX orientation (``x @ W`` with ``wqkv: [D, 3D]``,
``wo: [D, D]``, ``w1: [D, F]``, ``w2: [F, D]``, ``embed: [V, D]``,
``head: [D, V]``), so :func:`params_from_jax` is a copy, not a
transpose.

Training runs the whole JAX carving on one card.  NCCL refuses two ranks
on one device, so every (replica r, stage s, tp t, sp u, expert e) peer
lives stacked along dim 0 of every parameter in the JAX flat device
order ``i = (((r * pp + s) * tp + t) * sp + u) * ep + e`` (the JAX API's
``[n, ...]`` layout), and a collective over one axis is a tensor op on
that axis of a ``[dp, pp, tp, sp, ep, ...]`` view
(:mod:`bluefog_tpu_torch.ops.collectives`).
:func:`compose_parallelism` validates the carving and compiles the
gossip graph over the ``dp`` replicas; :func:`make_train_step` wires
``neighbor_communicator`` (gossip over dp for each (s, t, u) coordinate)
and ``adapt_with_combine(delayed=...)`` through
:func:`bluefog_tpu_torch.optimizers.make_train_step`.
:func:`make_lm_grad_fn` runs one replica's peers at once: GPipe over the
stages (:func:`~bluefog_tpu_torch.parallel.pipeline.pipeline_apply`),
Megatron tp with a ``psum`` after ``wo`` and after ``w2``, and Ulysses
over sp around the K1/K2 flash kernels
(:func:`~bluefog_tpu_torch.ops.ulysses.ulysses_attention`).  The expert
axis shards the MoE LM's experts and batch rows; the dense LM, as in
JAX, runs a full copy of the replica on each of its ep peers.  A
``wire`` codec compresses the gossip between replicas (each peer encodes
its own buffer, as each JAX device does); the intra-replica collectives
stay full width.
"""
from __future__ import annotations

import dataclasses
import types
from typing import (Any, Callable, Dict, List, Mapping, Optional, Tuple,
                    Union)

import networkx as nx
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import topology as topo_util
from ..device import resolve_device
from ..models.rope import _cos_sin, _rotate, apply_rope
from ..ops.collectives import psum
from ..ops.ulysses import dense_attention, ulysses_attention
from ..schedule import CommSchedule, compile_topology
from ..utils import wire_bytes as _wb
from .pipeline import pipeline_apply

__all__ = ["LMConfig", "ComposeLM", "AttnBlock", "DecoderBlock",
           "init_lm_params", "params_from_jax", "_ln", "Mesh3D",
           "DraftCarve", "draft_carve", "serving_carve", "ServingParams",
           "compose_parallelism", "make_train_step", "init_lm_train_params",
           "make_lm_batch", "make_lm_grad_fn"]


@dataclasses.dataclass(frozen=True)
class Mesh3D:
    """A validated (gossip-DP, PP, TP, SP, EP) carving, its peers stacked
    on one device.

    ``topology``/``schedule`` describe the gossip graph over the ``dp``
    replicas (not over all peers); ``device`` is where the stacked tensors
    live.  ``num_experts`` / ``capacity_factor`` are the JAX carving's
    metadata for the MoE model it will run (see
    :class:`bluefog_tpu_torch.moe.model.MoELMConfig`).  ``wire`` is the
    codec the gossip between replicas travels in (None: full width)."""
    dp: int
    topology: nx.DiGraph
    is_weighted: bool
    schedule: CommSchedule
    device: torch.device
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    num_experts: Optional[int] = None
    capacity_factor: Optional[float] = None
    wire: Optional[str] = None

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.tp * self.sp * self.ep

    @property
    def slice_size(self) -> int:
        """Peers per DP replica."""
        return self.pp * self.tp * self.sp * self.ep

    def leader_degree(self) -> int:
        """Max out-degree (self-loops excluded) of the DP gossip graph."""
        return max(
            sum(1 for v in self.topology.successors(u) if v != u)
            for u in self.topology.nodes)

    def effective_mixing(self) -> np.ndarray:
        """Mixing matrix over ALL ranks: ``W_dp (x) I_slice``."""
        W = topo_util.to_weight_matrix(self.topology)
        return topo_util.compose_two_level(W, np.eye(self.slice_size))

    def spectral_gap(self) -> float:
        """Consensus contraction rate of the DP graph."""
        return topo_util.spectral_gap(
            topo_util.to_weight_matrix(self.topology))

    def describe(self) -> dict:
        """JSON-ready summary for bench artifacts."""
        return {
            "dp": self.dp, "pp": self.pp, "tp": self.tp, "sp": self.sp,
            "ep": self.ep, "num_experts": self.num_experts,
            "capacity_factor": self.capacity_factor,
            "n_chips": self.size,
            "topology": self.topology.graph.get(
                "name", f"digraph<{self.topology.number_of_nodes()}>"),
            "leader_degree": self.leader_degree(),
            "gossip_rounds": self.schedule.num_rounds,
            "wire": self.wire,
            "spectral_gap": round(self.spectral_gap(), 6),
        }


def compose_parallelism(
    dp: int,
    pp: int = 1,
    tp: int = 1,
    sp: int = 1,
    ep: int = 1,
    *,
    device: Optional[Union[str, torch.device]] = None,
    topology: Union[nx.DiGraph, Callable[[int], nx.DiGraph], None] = None,
    weighted: bool = True,
    wire: Optional[str] = None,
    num_experts: Optional[int] = None,
    capacity_factor: Optional[float] = None,
) -> Mesh3D:
    """Carve ``dp x pp x tp x sp x ep`` peers, stacked on ``device`` (CUDA
    unless the caller asks for another) in the JAX flat device order, ep
    innermost.  The checks the JAX function shares keep its error texts
    (``num_experts`` is required at ep > 1 and must split over it);
    ``wire`` is the gossip's codec, checked here (and refused at dp = 1,
    which has no gossip edges).  ``topology``: the gossip graph over
    the ``dp`` replicas, an ``nx.DiGraph`` with exactly ``dp`` nodes or a
    callable ``f(dp) -> DiGraph`` (default ``ExponentialTwoGraph(dp)``);
    ``weighted`` compiles the graph's own weights (vs the uniform
    ``1/(in_degree+1)``).  ``num_experts`` / ``capacity_factor``: the MoE
    metadata the JAX function takes (``num_experts`` optional at ep = 1;
    the model config holds the operative values), reported by
    ``describe()``."""
    for name, v in (("dp", dp), ("pp", pp), ("tp", tp), ("sp", sp),
                    ("ep", ep)):
        if not isinstance(v, (int, np.integer)) or v < 1:
            raise ValueError(f"axis size {name}={v!r} must be a positive int")
    if num_experts is not None and (
            not isinstance(num_experts, (int, np.integer))
            or num_experts < 1):
        raise ValueError(
            f"num_experts={num_experts!r} must be a positive int")
    if ep > 1:
        if num_experts is None:
            raise ValueError(
                f"ep={ep} carves an expert-parallel axis but num_experts "
                "was not given; each expert peer owns num_experts // ep "
                "experts, so the carving contract needs the total")
        if num_experts % ep:
            raise ValueError(
                f"num_experts ({num_experts}) % ep ({ep}) != 0: each "
                "expert-parallel peer owns a contiguous block of "
                "num_experts // ep experts")
    if capacity_factor is not None and not (
            isinstance(capacity_factor, (int, float, np.floating))
            and float(capacity_factor) > 0):
        raise ValueError(
            f"capacity_factor={capacity_factor!r} must be a positive number")
    if wire is not None:
        from ..ops import collectives as _coll
        _coll._check_wire(wire)       # eager: fail at carve, not at step
        if dp == 1:
            raise ValueError(
                "wire codec applies to gossip permutes only; a dp=1 "
                "carving has no gossip edges to compress")
    from . import context as _ctx
    live = _ctx._context
    if live is not None and live.world > 1 and \
            live.rows % (pp * tp * sp * ep):
        raise ValueError(
            f"a replica's {pp * tp * sp * ep} peers (pp x tp x sp x ep) "
            f"would straddle processes of {live.rows} ranks; a carving "
            "keeps each replica's peers inside one process (ROADMAP queue "
            "1, item 12)")
    dev = resolve_device(device)
    if topology is None:
        topo = topo_util.ExponentialTwoGraph(dp) if dp > 1 \
            else topo_util.FullyConnectedGraph(1)
    elif callable(topology):
        topo = topology(dp)
    else:
        topo = topology
    if topo.number_of_nodes() != dp:
        raise ValueError(
            f"gossip topology has {topo.number_of_nodes()} nodes but the "
            f"DP axis has {dp} leaders; the gossip graph lives over DP "
            "replicas only (PP/TP/SP peers hold different shards and must "
            "not be mixed)")
    m = Mesh3D(dp=int(dp), topology=topo, is_weighted=weighted,
               schedule=compile_topology(topo, weighted), device=dev,
               pp=int(pp), tp=int(tp), sp=int(sp), ep=int(ep),
               num_experts=num_experts,
               capacity_factor=(None if capacity_factor is None
                                else float(capacity_factor)),
               wire=wire)
    if _ctx.is_initialized():
        _ctx.set_compose(m)
    return m


def make_train_step(m: Mesh3D, grad_fn: Callable[[Any, Any], Tuple[Any, Any]],
                    opt, *, delayed: bool = True, steps_per_call: int = 1,
                    reuse_batch: bool = False, fuse: bool = True,
                    concurrent: Optional[bool] = None,
                    metrics_every_k: Optional[int] = None,
                    metrics_warmup: int = 2):
    """Wire the carving through the step machinery: a
    ``neighbor_communicator`` that gossips over the ``dp`` replicas for
    every (stage, tp, sp, expert) coordinate (through ``m.wire``), ``opt`` (a ``torch.optim`` factory
    such as :func:`bluefog_tpu_torch.optimizers.adam`) wrapped in
    ``adapt_with_combine(delayed=...)``, and
    :func:`bluefog_tpu_torch.optimizers.make_train_step`, which calls
    ``grad_fn`` once per replica on that replica's ``slice_size`` peers
    (see :func:`make_lm_grad_fn`).  ``metrics_every_k`` /
    ``metrics_warmup`` go to the step wrapper (its consensus probe runs
    over the context's ranks, so it needs ``init(size=...)`` with every
    peer).  Returns ``(step, strategy)``; the strategy is needed for
    ``init_distributed(strategy, params)``."""
    from .. import optimizers as bfopt
    comm = bfopt.neighbor_communicator(m.schedule, fuse=fuse, wire=m.wire,
                                       concurrent=concurrent,
                                       slice_size=m.slice_size)
    strategy = bfopt.adapt_with_combine(opt, comm, delayed=delayed)
    step = bfopt.make_train_step(grad_fn, strategy,
                                 steps_per_call=steps_per_call,
                                 reuse_batch=reuse_batch,
                                 slice_size=m.slice_size,
                                 metrics_every_k=metrics_every_k,
                                 metrics_warmup=metrics_warmup)
    return step, strategy


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Shape of the composed decoder-only LM (same fields and defaults as
    the JAX ``LMConfig``; ``seq_len``/``micro``/``batch``/``lag`` size the
    copy-task trainer)."""
    vocab: int = 64
    d_model: int = 32
    heads: int = 4
    layers: int = 4
    seq_len: int = 32
    micro: int = 4
    batch: int = 2
    lag: int = 2
    ffn_mult: int = 4

    def validate(self, m: Optional["Mesh3D"] = None) -> None:
        """The JAX rules for the carving ``m`` (pp = tp = sp = 1 without
        one), in the JAX order and with its texts."""
        D, H = self.d_model, self.heads
        pp, tp, sp = (1, 1, 1) if m is None else (m.pp, m.tp, m.sp)
        if self.layers % pp:
            raise ValueError(f"layers ({self.layers}) % pp ({pp}) != 0")
        if D % H:
            raise ValueError(f"d_model ({D}) % heads ({H}) != 0")
        if (D // H) % 2:
            raise ValueError(f"head_dim ({D // H}) must be even for rope")
        if H % tp:
            raise ValueError(f"heads ({H}) % tp ({tp}) != 0")
        if (H // tp) % sp:
            raise ValueError(
                f"local heads ({H // tp}) % sp ({sp}) != 0: ulysses "
                "scatters this tp rank's heads across the sp axis")
        if self.seq_len % sp:
            raise ValueError(f"seq_len ({self.seq_len}) % sp ({sp}) != 0")
        if self.seq_len // sp <= self.lag:
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

    def flops_per_token(self) -> float:
        """Training FLOPs/token: 6N weight term + attention score/value
        matmuls (the JAX accounting)."""
        return (6.0 * self.n_params
                + 6.0 * self.layers * self.d_model * self.seq_len)


def serving_carve(pp: int = 1):
    """The carving of a serving module on one card: ``pp`` pipeline
    stages run in order, everything else 1 (the JAX engine's carving at
    dp = tp = sp = ep = 1)."""
    return types.SimpleNamespace(dp=1, pp=pp, tp=1, sp=1, ep=1,
                                 num_experts=None, slice_size=pp)


@dataclasses.dataclass(frozen=True)
class DraftCarve:
    """The truncated-stage draft of self-speculative decoding (the JAX
    ``DraftCarve``): the first ``stages`` of the target's ``pp`` pipeline
    stages, early-exited into the shared LN + head.  No extra weights: the
    draft is a prefix of the served model, so its early-layer KV writes
    equal the target's and the verify pass overwrites them with the same
    values.  Pure metadata: the engine reads ``layers``."""
    stages: int            # pipeline stages the draft runs (1 .. pp)
    pp: int                # target pipeline depth it was carved from
    layers: int            # decoder blocks the draft runs
    total_layers: int      # decoder blocks in the target
    n_params: int          # dense draft params (blocks run + embed/head)
    target_params: int     # dense target params

    @property
    def cost_fraction(self) -> float:
        """Draft-token FLOPs as a fraction of a target token's (the ``c``
        of the speculative speedup model ``(1 - a^(k+1)) / ((1 - a) (ck +
        1))``)."""
        return self.n_params / self.target_params

    def describe(self) -> dict:
        return {"stages": self.stages, "pp": self.pp,
                "layers": self.layers, "total_layers": self.total_layers,
                "cost_fraction": round(self.cost_fraction, 4)}


def draft_carve(pp: int, cfg: "LMConfig", stages: int) -> DraftCarve:
    """Carve the truncated-stage draft off a ``pp``-stage serving carving
    (``1 <= stages <= pp``; ``stages == pp`` is the identity draft: every
    token accepted, no speedup).  The JAX rules and texts."""
    if not isinstance(stages, int) or not 1 <= stages <= pp:
        raise ValueError(f"draft stages={stages!r} must be an int in "
                         f"[1, pp={pp}]")
    cfg.validate(serving_carve(pp))
    draft_layers = stages * (cfg.layers // pp)
    D, F_ = cfg.d_model, cfg.ffn_mult * cfg.d_model
    per_block = D * 3 * D + D * D + D * F_ + F_ * D
    return DraftCarve(
        stages=stages, pp=pp, layers=draft_layers, total_layers=cfg.layers,
        n_params=draft_layers * per_block + 2 * cfg.vocab * D,
        target_params=cfg.n_params)


def _ln(z: torch.Tensor) -> torch.Tensor:
    """Parameter-free layer norm, eps 1e-6 (the JAX ``_ln``)."""
    mu = z.mean(-1, keepdim=True)
    return (z - mu) / torch.sqrt(z.var(-1, unbiased=False, keepdim=True)
                                 + 1e-6)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


class AttnBlock(nn.Module):
    """The attention half of a pre-LN decoder block; subclasses add the
    FFN sublayer as ``ffn(x, tile) -> (x, routing)``.

    The attention itself is the caller's (dense for prefill, the paged
    cache for decode), so the block exposes the two halves around it."""

    def __init__(self, d_model: int):
        super().__init__()
        self.wqkv = nn.Parameter(torch.empty(d_model, 3 * d_model))
        self.wo = nn.Parameter(torch.empty(d_model, d_model))

    def qkv(self, x: torch.Tensor):
        """``x: [..., D]`` -> ``(q, k, v)`` each ``[..., D]``."""
        return (_ln(x) @ self.wqkv).chunk(3, dim=-1)

    def finish(self, x: torch.Tensor, att: torch.Tensor,
               tile: Optional[int] = None):
        """Residual attention output projection, then the FFN sublayer;
        ``att`` is ``[..., D]`` (heads flattened).  Returns ``(x,
        routing)`` as :meth:`ffn` does."""
        return self.ffn(x + att @ self.wo, tile)


class DecoderBlock(AttnBlock):
    """One pre-LN decoder block: attention sublayer, then the gelu FFN."""

    def __init__(self, d_model: int, ffn_mult: int):
        super().__init__(d_model)
        D, F_ = d_model, ffn_mult * d_model
        self.w1 = nn.Parameter(torch.empty(D, F_))
        self.w2 = nn.Parameter(torch.empty(F_, D))

    def ffn(self, x: torch.Tensor, tile: Optional[int] = None):
        """The residual gelu FFN; ``tile`` (the MoE block's grouped tile)
        is unused and the routing is ``None``."""
        return x + _gelu(_ln(x) @ self.w1) @ self.w2, None


class ComposeLM(nn.Module):
    """The composed LM's weights and its dense forward."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model))
        self.head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab))
        self.blocks = nn.ModuleList(self._block(cfg)
                                    for _ in range(cfg.layers))

    def _block(self, cfg: LMConfig) -> AttnBlock:
        return DecoderBlock(cfg.d_model, cfg.ffn_mult)

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
            x, _ = blk.finish(x, att.reshape(B, T, H * Dh))
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


def _draw_weights(cfg: LMConfig, seed: int):
    """The weights as numpy arrays from ``np.random.default_rng(seed)``,
    drawn with the same calls in the same order as the JAX
    ``init_lm_params``, so at pp = tp = 1 every array is bit-identical to
    the JAX one."""
    rng = np.random.default_rng(seed)
    D, F_, L = cfg.d_model, cfg.ffn_mult * cfg.d_model, cfg.layers

    def w(*shape, scale=0.1):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    blocks = {"wqkv": w(L, D, 3 * D), "wo": w(L, D, D),
              "w1": w(L, D, F_), "w2": w(L, F_, D)}
    embed, head = w(cfg.vocab, D), w(D, cfg.vocab)
    return blocks, embed, head


def init_lm_params(cfg: LMConfig, seed: int = 0, *,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> ComposeLM:
    """Random LM weights (the JAX ``init_lm_params`` draws) as the serving
    module."""
    cfg.validate()
    dev = resolve_device(device)
    blocks, embed, head = _draw_weights(cfg, seed)
    return _load(ComposeLM(cfg), blocks, embed, head).to(dev)


def params_from_jax(tree: Mapping[str, Any], cfg: LMConfig, *,
                    device: Optional[Union[str, torch.device]] = None,
                    stacked: bool = False, m: Optional["Mesh3D"] = None
                    ) -> Union[ComposeLM, dict, "ServingParams"]:
    """Build the port's LM from a JAX ``init_lm_params`` /
    ``checkpoint.load_for_serving`` tree (leaves as numpy arrays or
    anything ``np.asarray`` takes, stacked ``[n_devices, ...]``).

    With ``m``, the carving the tree was made for (a :class:`Mesh3D` of
    the same dp, pp, tp, sp and ep), the whole carving loads into the
    serving engine's layout: :class:`ServingParams` on ``device``
    (default ``m.device``), every replica's rows kept and the tp shards
    as JAX cuts them (sp and ep peers hold copies of their replica's
    blocks; their first is read).

    Without ``m`` the tree must be carved at tp = 1: by default row 0
    becomes the serving module; a tree carved at pp > 1 (each row holds
    ``layers / pp`` blocks, device ``r * pp + s`` stage s of replica r)
    loads with the stages' blocks of replica 0 joined in stage order.
    With ``stacked=True`` (pp = tp = 1 only) the training tree
    ``{"blocks", "shared"}`` comes back as stacked tensors with every row
    kept (ranks diverge once training starts)."""
    if m is not None:
        D, F_ = cfg.d_model, cfg.ffn_mult * cfg.d_model
        Dl, Fl = D // m.tp, F_ // m.tp
        return _serving_from_tree(tree, cfg, m, device, [
            ("blocks", "wqkv", "wqkv", (D, 3 * Dl), ("tp",)),
            ("blocks", "wo", "wo", (Dl, D), ("tp",)),
            ("blocks", "w1", "w1", (D, Fl), ("tp",)),
            ("blocks", "w2", "w2", (Fl, D), ("tp",))])
    dev = resolve_device(device)
    shape = np.asarray(tree["blocks"]["wqkv"]).shape
    Lps = shape[1] if len(shape) == 4 else 0
    pp = cfg.layers // Lps if Lps and cfg.layers % Lps == 0 else 0
    if (not pp or shape[2:] != (cfg.d_model, 3 * cfg.d_model)
            or shape[0] % pp or (stacked and pp != 1)):
        want = (cfg.layers, cfg.d_model, 3 * cfg.d_model)
        raise ValueError(f"wqkv {shape} != [n, {want}] (or [n * pp, "
                         f"layers / pp, ...]): the tree must be a tp = 1 "
                         f"carving of this LMConfig{' at pp = 1' * stacked}")
    if stacked:
        def t(x):
            return torch.as_tensor(np.array(x, dtype=np.float32)).to(dev)
        return {"blocks": {k: t(v) for k, v in tree["blocks"].items()},
                "shared": {k: t(v) for k, v in tree["shared"].items()}}
    blocks = {k: np.concatenate(list(np.asarray(v)[:pp]))
              for k, v in tree["blocks"].items()}
    shared = tree["shared"]
    return _load(ComposeLM(cfg), blocks, np.asarray(shared["embed"])[0],
                 np.asarray(shared["head"])[0]).to(dev)


def _join(name: str, w: torch.Tensor) -> torch.Tensor:
    """One replica's ``[tp, ...]`` (``[tp, ep, ...]``) shards of block
    weight ``name`` joined into the weight of one module, peers in
    order."""
    if name == "wqkv":              # [tp, D, 3 Dl]: q, k, v thirds per peer
        TP, D, _ = w.shape
        return w.reshape(TP, D, 3, -1).permute(1, 2, 0, 3).reshape(D, -1)
    if name == "w1":                # [tp, D, Fl]: columns per peer
        return w.permute(1, 0, 2).reshape(w.shape[1], -1)
    if name in ("wo", "w2"):        # [tp, rows / tp, D]: rows per peer
        return w.reshape(-1, w.shape[-1])
    if name == "w1e":               # [tp, ep, El, D, Fl]
        TP, EP, El, D, Fl = w.shape
        return w.permute(1, 2, 3, 0, 4).reshape(EP * El, D, TP * Fl)
    if name == "w2e":               # [tp, ep, El, Fl, D]
        TP, EP, El, Fl, D = w.shape
        return w.permute(1, 2, 0, 3, 4).reshape(EP * El, TP * Fl, D)
    return w                        # wr [D, E]: replicated


@dataclasses.dataclass
class ServingParams:
    """A carving's serving weights on one card, as the serving engine
    reads them: every replica's, every tp and ep peer's.

    ``m`` is the carving (a :class:`Mesh3D`, or :func:`serving_carve`'s
    for one module) and ``cfg`` the model's config.  ``embed [dp, V, D]``
    and ``head [dp, D, V]`` are each replica's own.  ``blocks`` maps each
    block weight to one tensor per layer (the stages' layers in order):
    ``wqkv [dp, tp, D, 3 D / tp]`` (tp peer t's q, k and v columns, for
    heads ``t * H / tp ..``), ``wo [dp, tp, D / tp, D]`` (its rows); the
    dense LM's ``w1 [dp, tp, D, F / tp]`` and ``w2 [dp, tp, F / tp, D]``;
    the MoE LM's ``wr [dp, D, E]`` (the router, replicated over tp and
    ep), ``w1e [dp, tp, ep, E / ep, D, F / tp]`` and ``w2e [dp, tp, ep,
    E / ep, F / tp, D]`` (owner e's experts, tp peer t's cut).  Replicas
    may hold different weights: trained replicas diverge."""
    m: Any
    cfg: LMConfig
    embed: torch.Tensor
    head: torch.Tensor
    blocks: Dict[str, List[torch.Tensor]]

    @classmethod
    def from_module(cls, model: ComposeLM, pp: int = 1) -> "ServingParams":
        """One module (dense or MoE) as the carving of size 1 at ``pp``
        stages: views of its parameters, nothing copied."""
        moe = hasattr(model.blocks[0], "w1e")
        names = ("wqkv", "wo", "wr", "w1e", "w2e") if moe else \
            ("wqkv", "wo", "w1", "w2")
        lead = {"wr": 1, "w1e": 3, "w2e": 3}
        blocks = {n: [getattr(b, n)[(None,) * lead.get(n, 2)]
                      for b in model.blocks] for n in names}
        return cls(serving_carve(pp), model.cfg, model.embed[None],
                   model.head[None], blocks)

    def tensors(self):
        """``(name, tensor)`` of every weight, layer by layer."""
        yield "embed", self.embed
        yield "head", self.head
        for name, per_layer in self.blocks.items():
            for i, t in enumerate(per_layer):
                yield f"{name}[{i}]", t

    def to(self, device: Union[str, torch.device]) -> "ServingParams":
        return ServingParams(
            self.m, self.cfg, self.embed.to(device), self.head.to(device),
            {k: [t.to(device) for t in v] for k, v in self.blocks.items()})

    def replica(self, r: int) -> ComposeLM:
        """Replica ``r``'s weights joined into one serving module (the
        tp shards' columns and rows, the ep owners' experts, in peer
        order) on the weights' device: the carving of size 1 that serves
        the same model."""
        if "w1e" in self.blocks:
            from ..moe.model import MoELM as cls
        else:
            cls = ComposeLM
        with torch.device(self.embed.device):
            model = cls(self.cfg)
        with torch.no_grad():
            model.embed.copy_(self.embed[r])
            model.head.copy_(self.head[r])
            for i, blk in enumerate(model.blocks):
                for name, per_layer in self.blocks.items():
                    getattr(blk, name).copy_(_join(name, per_layer[i][r]))
        return model.requires_grad_(False)


def _serving_from_tree(tree: Mapping[str, Any], cfg: LMConfig, m: "Mesh3D",
                       device, leaves) -> ServingParams:
    """The JAX serving tree of carving ``m`` in the :class:`ServingParams`
    layout.  ``leaves``: ``(group, name, engine name, per-device shape
    past [n, layers / pp], peer axes)`` with peer axes a subset of
    ``("tp", "ep")`` in that order (the flat device order ``(((r * pp +
    s) * tp + t) * sp + u) * ep + e``; sp peers and, for blocks without
    the axis, ep peers hold copies: the first is read)."""
    cfg.validate(m)
    dev = m.device if device is None else resolve_device(device)
    idx = np.arange(m.size).reshape(m.dp, m.pp, m.tp, m.sp, m.ep)
    Lps = cfg.layers // m.pp
    carving = (f"dp {m.dp} x pp {m.pp} x tp {m.tp} x sp {m.sp} x ep "
               f"{m.ep}")

    def leaf(x, name, tail):
        t = x if torch.is_tensor(x) else torch.as_tensor(np.array(x))
        if tuple(t.shape) != tail:
            raise ValueError(f"{name} {tuple(t.shape)} != {list(tail)}: the "
                             f"tree must be the carving {carving} of this "
                             "config")
        return t

    def pick(t, ids):
        return t[torch.as_tensor(ids, device=t.device)]

    blocks = {}
    for group, name, key, tail, axes in leaves:
        t = leaf(tree[group][name], name, (m.size, Lps) + tail)
        ids = idx[:, :, slice(None) if "tp" in axes else 0, 0,
                  slice(None) if "ep" in axes else 0]
        x = pick(t, ids)                   # [dp, pp, *peers, Lps, *tail]
        k = len(axes)
        x = x.permute(1, 2 + k, 0, *range(2, 2 + k),
                      *range(3 + k, x.ndim))
        x = x.reshape((cfg.layers, m.dp) + tuple(x.shape[3:]))
        blocks[key] = list(x.to(dev).contiguous().unbind(0))
    V, D = cfg.vocab, cfg.d_model
    first = idx[:, 0, 0, 0, 0]
    shared = tree["shared"]
    embed = pick(leaf(shared["embed"], "embed", (m.size, V, D)), first)
    head = pick(leaf(shared["head"], "head", (m.size, D, V)), first)
    return ServingParams(m, cfg, embed.to(dev).contiguous(),
                         head.to(dev).contiguous(), blocks)


# ---------------------------------------------------------------------------
# Training: stacked params, batches and the per-replica gradient
# ---------------------------------------------------------------------------

def _coords(m: Mesh3D):
    """``(r, s, t, u, e)`` of every stacked peer, in the flat device
    order."""
    return np.unravel_index(np.arange(m.size),
                            (m.dp, m.pp, m.tp, m.sp, m.ep))


def init_lm_train_params(cfg: LMConfig, m: Mesh3D, seed: int = 0) -> dict:
    """The JAX ``init_lm_params(cfg, m, seed)`` tree, bit for bit:
    ``{"blocks": {wqkv, wo, w1, w2}, "shared": {embed, head}}`` with every
    leaf stacked ``[n, ...]`` on ``m.device``.  Block owners are drawn
    ``[pp, tp, layers / pp, ...]`` (tp-sharded columns of ``wqkv``/``w1``,
    rows of ``wo``/``w2``) and peer ``(r, s, t, u)`` holds owner ``(s,
    t)``'s (its ep peers hold copies); every peer holds the shared
    embed/head."""
    cfg.validate(m)
    rng = np.random.default_rng(seed)
    D, F_ = cfg.d_model, cfg.ffn_mult * cfg.d_model
    Lps, TP = cfg.layers // m.pp, m.tp

    def w(*shape, scale=0.1):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    blocks = {"wqkv": w(m.pp, TP, Lps, D, 3 * D // TP),
              "wo": w(m.pp, TP, Lps, D // TP, D),
              "w1": w(m.pp, TP, Lps, D, F_ // TP),
              "w2": w(m.pp, TP, Lps, F_ // TP, D)}
    shared = {"embed": w(cfg.vocab, D), "head": w(D, cfg.vocab)}
    _, s, t, _, _ = _coords(m)

    def stack(a):
        x = torch.from_numpy(a).to(m.device)
        return x.unsqueeze(0).expand((m.size,) + a.shape).contiguous()

    return {"blocks": {k: torch.from_numpy(np.ascontiguousarray(v[s, t]))
                       .to(m.device) for k, v in blocks.items()},
            "shared": {k: stack(v) for k, v in shared.items()}}


def make_lm_batch(cfg: LMConfig, m: Mesh3D, seed: int = 0,
                  steps: Optional[int] = None) -> torch.Tensor:
    """Copy-task tokens stacked per peer, ``[n, (steps,) micro, batch,
    seq_len / sp]`` int32 on ``m.device``: the JAX ``make_lm_batch``
    tokens bit for bit (the same ``rng.integers`` call; each replica draws
    its own data, stage, tp and ep peers see the same tokens, sp peers
    slice the sequence)."""
    rng = np.random.default_rng(seed)
    shape = (m.dp, cfg.micro, cfg.batch, cfg.seq_len) if steps is None \
        else (m.dp, steps, cfg.micro, cfg.batch, cfg.seq_len)
    data = rng.integers(0, cfg.vocab, size=shape).astype(np.int32)
    Tl = cfg.seq_len // m.sp
    r, _, _, u, _ = _coords(m)
    per_peer = np.stack([data[ri][..., ui * Tl:(ui + 1) * Tl]
                         for ri, ui in zip(r, u)])
    return torch.from_numpy(per_peer).to(m.device)


def _attention(cfg: LMConfig, m: Mesh3D, use_pallas: bool):
    """The attention sublayer of one GPipe tick's peers: ``attn(lp, x,
    cos, sin)`` for ``x [k, TP, SP, EP, B * Tl, D]`` (k live stages, each
    ep peer's own ``B`` batch rows) and ``lp`` leaves ``[k, TP, SP, EP,
    ...]`` (every peer's own ``wqkv`` / ``wo`` shard): pre-LN, rope at the
    global positions, Ulysses over sp around the K1/K2 flash kernels (the
    ep peers' rows as more batch rows of one launch), ``wo`` and the psum
    over tp, residual."""
    TP, SP = m.tp, m.sp
    D, H = cfg.d_model, cfg.heads
    Hl, hsz = H // TP, D // H
    Tl = cfg.seq_len // SP
    block_q = min(512, cfg.seq_len)

    def attn(lp, x, cos, sin):
        shape = (x.shape[0], TP, SP, -1, Tl, Hl, hsz)
        q, k, v = torch.matmul(_ln(x), lp["wqkv"]).split(D // TP, dim=-1)
        q = _rotate(q.reshape(shape), cos, sin)
        k = _rotate(k.reshape(shape), cos, sin)
        att = ulysses_attention(q, k, v.reshape(shape), axis=2, causal=True,
                                use_pallas=use_pallas,
                                pallas_block_q=block_q)
        att = att.reshape(x.shape[:-1] + (D // TP,))
        return x + psum(torch.matmul(att, lp["wo"]), 1, lead=4)

    return attn


def _replica_fns(cfg: LMConfig, m: Mesh3D, layer_fn, *, sums,
                 remat: bool = False, n_ch: int = 0, channel_loss=None,
                 ep_batch: bool = False):
    """``(grad_fn, probe)`` for one DP replica of a stacked pipelined LM:
    the machinery :func:`make_lm_grad_fn` documents, shared with the MoE
    trainer (:func:`bluefog_tpu_torch.moe.model.make_moe_grad_fn`).

    ``layer_fn(lp, x, cos, sin) -> (x, vec)`` is one layer of a tick's
    peers, ``x [k, TP, SP, EP, rows, D]``, ``lp`` a dict of the param
    groups that ride the pipeline (every group of ``sums`` but
    ``"shared"``; leaves ``[k, TP, SP, EP, ...]``), ``vec`` ``[k, TP, SP,
    EP, n_ch]`` or None.  With ``ep_batch`` each ep peer holds ``batch /
    ep`` rows of the batch (the MoE LM), else the whole batch (the dense
    LM's ep peers are copies).
    With ``n_ch`` a carrier rides the pipeline as the JAX MoE model's
    carrier row: ``Tl`` zero rows appended to each peer's ``B * Tl``
    activation rows, which the layer math never sees; each stage adds its
    layers' ``vec`` sum to the first carrier row's first ``n_ch``
    channels, so the channels reach the last stage, and their
    cotangents every stage, through the pipeline itself.  Each
    microbatch's loss is its cross-entropy (the mean over the sp and ep
    peers' tokens) plus ``channel_loss(ch [SP, EP, n_ch])``, over the
    microbatch count.  ``sums`` maps each param group to the dims of the
    ``[pp, tp, sp, ep]`` peer view its gradient is summed over outside
    autograd (the JAX ``psum``/``pmean``s).  ``probe(params, toks)``
    returns replica 0's cross-entropy and carrier channels, mean over
    microbatches and the sp and ep peers, without a graph."""
    from ..fusion import tree_flatten, tree_map, tree_unflatten

    S, TP, SP, EP = m.pp, m.tp, m.sp, m.ep
    view = (S, TP, SP, EP)           # the replica's peers
    n = m.slice_size
    D, H, V = cfg.d_model, cfg.heads, cfg.vocab
    hsz = D // H
    Tl, lag = cfg.seq_len // SP, cfg.lag
    B = cfg.batch // EP if ep_batch else cfg.batch
    Lps = cfg.layers // S
    R = B * Tl                       # a peer's activation rows
    groups = [g for g in sorted(sums) if g != "shared"]

    def forward(p, toks):
        """The last stage's pipeline output ``[M, TP, SP, EP, rows, D]``."""
        dev, M = toks.device, toks.shape[1]
        tk = toks.long().view(view + (M, B, Tl))
        stage_params = {g: {k: w.view(view + tuple(w.shape[1:]))
                            for k, w in p[g].items()} for g in groups}
        embed = p["shared"]["embed"].view(view + (V, D))
        pos = (torch.arange(SP, device=dev)[:, None] * Tl
               + torch.arange(Tl, device=dev))
        cos, sin = _cos_sin(pos, hsz, 10000.0)         # [SP, Tl, hsz / 2]
        cos, sin = (c[:, None, :, None, :] for c in (cos, sin))

        def stage_fn(bp, x):
            data, acc = (x[..., :R, :] if n_ch else x), None
            for i in range(Lps):
                lp = {g: {k: w[:, :, :, :, i] for k, w in d.items()}
                      for g, d in bp.items()}
                data, vec = layer_fn(lp, data, cos, sin)
                if vec is not None:
                    acc = vec if acc is None else acc + vec
            if not n_ch:
                return data
            row = x[..., R:, :]
            first = row[..., :1, :] + F.pad(acc, (0, D - n_ch))[..., None, :]
            return torch.cat([data, first, row[..., 1:, :]], dim=-2)

        # stage 0's peers embed their own tokens with their own rows
        ti = torch.arange(TP, device=dev).view(TP, 1, 1, 1, 1, 1)
        ui = torch.arange(SP, device=dev).view(1, SP, 1, 1, 1, 1)
        ei = torch.arange(EP, device=dev).view(1, 1, EP, 1, 1, 1)
        x0 = embed[0][ti, ui, ei, tk[0]]      # [TP, SP, EP, M, B, Tl, D]
        mbs = x0.permute(3, 0, 1, 2, 4, 5, 6).reshape(M, TP, SP, EP, R, D)
        del x0
        if n_ch:                                  # the carrier rows
            mbs = torch.cat([mbs, mbs.new_zeros((M, TP, SP, EP, Tl, D))], 4)
        return pipeline_apply(stage_fn, stage_params, mbs, remat=remat,
                              lead=4), tk

    def head_loss(p, o, tk, mb):
        """Microbatch ``mb``'s cross-entropy over the sp and ep peers and
        its carrier channels ``[SP, EP, n_ch]``, from the last stage's tp
        peer 0 (``o [SP, EP, rows, D]``)."""
        hd = p["shared"]["head"].view(view + (D, V))[S - 1, 0]
        targets = torch.roll(tk[S - 1, 0, :, :, mb], lag, dims=-1)
        logits = torch.matmul(_ln(o[..., :R, :]), hd)
        logits = logits.view(SP, EP, B, Tl, V)[..., lag:, :]
        ce = F.cross_entropy(logits.reshape(-1, V),
                             targets[..., lag:].reshape(-1))
        return ce, (o[..., R, :n_ch] if n_ch else None)

    def grad_fn(params, toks):
        leaves, treedef = tree_flatten(params)
        if n == 1:                           # the rank's own view
            leaves, toks = [x[None] for x in leaves], toks[None]
        ws = [x.detach().requires_grad_() for x in leaves]
        p = tree_unflatten(treedef, ws)
        total = torch.zeros((), device=toks.device)
        with torch.enable_grad():
            out, tk = forward(p, toks)
            M = out.shape[0]
            out_cut = out.detach().requires_grad_()   # [M, TP, SP, EP, ..]
            for mb in range(M):
                ce, ch = head_loss(p, out_cut[mb, 0], tk, mb)
                loss = (ce if ch is None else ce + channel_loss(ch)) / M
                loss.backward()
                total = total + loss.detach()
                del ce, ch, loss
            out.backward(out_cut.grad)
            del out, out_cut
        grads = tree_unflatten(treedef, [w.grad for w in ws])
        if _wb._armed is not None:
            _record_grad_sums(grads, sums, view)
        # the JAX psums / pmeans outside AD, over the peer view's dims
        grads = {grp: {k: g.view(view + tuple(g.shape[1:])).sum(
            sums[grp], keepdim=True).expand(
            view + tuple(g.shape[1:])).reshape(g.shape)
            for k, g in d.items()} for grp, d in grads.items()}
        if n == 1:
            return total, tree_map(lambda g: g[0], grads)
        return total.expand(n), grads

    def probe(params, toks):
        p = tree_map(lambda x: x[:n] if n > 1 else x[:1], params)
        with torch.no_grad():
            out, tk = forward(p, toks[:n] if n > 1 else toks[:1])
            M = out.shape[0]
            parts = [head_loss(p, out[mb, 0], tk, mb) for mb in range(M)]
        ce = sum(c for c, _ in parts) / M
        ch = (sum(c for _, c in parts) / M).mean((0, 1)) if n_ch else None
        return ce, ch

    return grad_fn, probe


def _record_grad_sums(grads, sums, view) -> None:
    """The armed ledger's records of the gradient sums over the peers:
    JAX's ``psum`` over (stage, tp), then its ``pmean`` over sp, and a
    sum over the ep peers, each an all-reduce of the group's gradients
    where that axis holds more than one peer."""
    for grp, d in grads.items():
        dims = set(sums[grp])
        axes = [a for a in ({0, 1} & dims, {2} & dims, {3} & dims)
                if a and int(np.prod([view[i] for i in a])) > 1]
        for g in d.values():
            per_chip = _wb.nbytes(g) // max(int(np.prod(view)), 1)
            for _ in axes:
                _wb._armed.uniform("all_reduce", g.dtype, per_chip)


def make_lm_grad_fn(cfg: LMConfig, m: Mesh3D, *, remat: bool = False,
                    use_pallas: bool = False):
    """``grad_fn(params, toks) -> (loss, grads)`` for one DP replica of the
    composed LM (the JAX ``make_lm_grad_fn``'s ``layer_fn``, ``stage_fn``
    and copy-task loss: mean cross-entropy of predicting the token ``lag``
    positions back within each sp peer's slice, over positions ``lag:``).

    Contract: one call takes one replica's ``slice_size`` peers, leaves
    ``[pp * tp * sp * ep, ...]`` in the flat (s, t, u, e) order, and
    ``toks`` ``[pp * tp * sp * ep, micro, batch, seq_len / sp]``; it
    returns the loss of
    each peer ``[slice_size]`` and the grads stacked like the params.  At
    ``slice_size == 1`` the slice axis is absent (leaves are the rank's
    own, the loss a scalar).  :func:`bluefog_tpu_torch.optimizers.
    stacked_grads` calls it once per replica.

    Every peer of the replica runs at once: the stages by the GPipe
    schedule of :func:`~bluefog_tpu_torch.parallel.pipeline.pipeline_apply`
    (each tick runs its live stages in one call), the tp peers' shards as
    one batched product with a ``psum`` over tp after ``wo`` and after
    ``w2``, and attention by Ulysses over sp
    (:func:`~bluefog_tpu_torch.ops.ulysses.ulysses_attention`; K1/K2 on
    the card, every stage, tp and sp peer of a tick folded into one
    launch), with rope at the global positions ``u * Tl + arange(Tl)``.
    So K1 and K2 each launch ``(micro + pp - 1) * layers / pp`` times a
    call (twice as many forwards with ``remat``).

    The gradients are the JAX function's under ``check_vma=False``: its
    loss is masked to the last stage and seeded ``1/TP`` on every tp
    peer, the shared grads ``psum``'d over (stage, tp) and everything
    ``pmean``'d over sp.  Here the head and loss run on the last stage's
    tp peer 0 alone (the other peers' head gradient is exactly zero in
    JAX, and is zero here before the reduction), seeded with 1 for the
    mean over the sp peers; the psums' autograd transposes sum the
    cotangents over tp, then the block grads are summed over sp and the
    shared grads over the whole replica.  At ep > 1 each ep peer is a copy
    of the replica on the whole batch (the JAX dense LM's): the loss is
    their mean, and every gradient is also summed over them, which gives
    each copy the whole gradient.  The pipeline output is cut from
    the graph so that one microbatch's logits live at a time: each
    microbatch's head and loss backpropagate into its rows, then one
    backward runs through the pipeline.  Only summation order differs
    from the JAX function.  ``use_pallas`` selects the flash path on the
    CPU (the kernels' plain versions); on CUDA the kernels always run."""
    cfg.validate(m)
    attn = _attention(cfg, m, use_pallas)

    def layer_fn(lp, x, cos, sin):
        bp = lp["blocks"]
        x = attn(bp, x, cos, sin)
        h = _gelu(torch.matmul(_ln(x), bp["w1"]))
        return x + psum(torch.matmul(h, bp["w2"]), 1, lead=4), None

    return _replica_fns(cfg, m, layer_fn,
                        sums={"blocks": (2, 3), "shared": (0, 1, 2, 3)},
                        remat=remat)[0]
