"""The composed decoder LM (counterpart of ``bluefog_tpu/parallel/compose.py``)
at pp = tp = sp = 1: serving and gossip data-parallel training.  The
MoE LM (:mod:`bluefog_tpu_torch.moe.model`) reuses the attention half,
:class:`AttnBlock`, and brings its own FFN.

Weights keep the JAX orientation (``x @ W`` with ``wqkv: [D, 3D]``,
``wo: [D, D]``, ``w1: [D, F]``, ``w2: [F, D]``, ``embed: [V, D]``,
``head: [D, V]``), so :func:`params_from_jax` is a copy, not a
transpose.

Training runs the JAX carving's gossip-DP axis on one card: the ``dp``
ranks live stacked along dim 0 of every parameter (the JAX API's
``[n, ...]`` layout).  :func:`compose_parallelism` validates the carving
and compiles the gossip graph; :func:`make_train_step` wires
``neighbor_communicator`` and ``adapt_with_combine(delayed=...)`` through
:func:`bluefog_tpu_torch.optimizers.make_train_step`; the per-rank
:func:`make_lm_grad_fn` runs each rank's microbatches through the decoder
blocks, whose attention goes through the K1/K2 flash kernels on the card
(:func:`~bluefog_tpu_torch.ops.ulysses.ulysses_attention`).  Pipeline,
tensor, sequence (Ulysses) and expert carvings (pp/tp/sp/ep > 1) and
gossip wire codecs are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Tuple, Union

import networkx as nx
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import topology as topo_util
from ..device import resolve_device
from ..models.rope import apply_rope
from ..ops.ulysses import dense_attention, ulysses_attention
from ..schedule import CommSchedule, compile_topology

__all__ = ["LMConfig", "ComposeLM", "AttnBlock", "DecoderBlock",
           "init_lm_params", "params_from_jax", "_ln", "Mesh3D",
           "compose_parallelism", "make_train_step", "init_lm_train_params",
           "make_lm_batch", "make_lm_grad_fn"]


@dataclasses.dataclass(frozen=True)
class Mesh3D:
    """A validated carving of the gossip-DP ranks stacked on one device.

    ``topology``/``schedule`` describe the gossip graph over the ``dp``
    ranks; ``device`` is where the stacked tensors live.  The other axes
    of the JAX carving are not ported: they are the constants below, kept
    so :meth:`describe` has the JAX carving's keys."""
    dp: int
    topology: nx.DiGraph
    is_weighted: bool
    schedule: CommSchedule
    device: torch.device
    pp = tp = sp = ep = 1
    wire = num_experts = capacity_factor = None

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.tp * self.sp * self.ep

    @property
    def slice_size(self) -> int:
        """Ranks per DP replica."""
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
) -> Mesh3D:
    """Carve ``dp`` gossip-DP ranks, stacked on ``device`` (CUDA unless the
    caller asks for another).  The checks the JAX function shares keep its
    error texts; pp/tp/sp/ep > 1 and ``wire`` raise "not yet ported".
    ``topology``: an ``nx.DiGraph`` with exactly ``dp`` nodes or a callable
    ``f(dp) -> DiGraph`` (default ``ExponentialTwoGraph(dp)``);
    ``weighted`` compiles the graph's own weights (vs the uniform
    ``1/(in_degree+1)``)."""
    for name, v in (("dp", dp), ("pp", pp), ("tp", tp), ("sp", sp),
                    ("ep", ep)):
        if not isinstance(v, (int, np.integer)) or v < 1:
            raise ValueError(f"axis size {name}={v!r} must be a positive int")
    for name, v in (("pp", pp), ("tp", tp), ("sp", sp), ("ep", ep)):
        if v > 1:
            raise ValueError(
                f"{name}={v}: only the gossip-DP axis is ported to "
                "bluefog_tpu_torch; pipeline, tensor, sequence and expert "
                "carvings (pp/tp/sp/ep > 1) are not yet ported")
    if wire is not None:
        if dp == 1:
            raise ValueError(
                "wire codec applies to gossip permutes only; a dp=1 "
                "carving has no gossip edges to compress")
        raise ValueError(f"wire codec {wire!r}: wire codecs are not yet "
                         "ported to bluefog_tpu_torch")
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
    return Mesh3D(dp=dp, topology=topo, is_weighted=weighted,
                  schedule=compile_topology(topo, weighted), device=dev)


def make_train_step(m: Mesh3D, grad_fn: Callable[[Any, Any], Tuple[Any, Any]],
                    opt, *, delayed: bool = True, steps_per_call: int = 1,
                    reuse_batch: bool = False, fuse: bool = True,
                    concurrent: Optional[bool] = None):
    """Wire the carving through the step machinery: a
    ``neighbor_communicator`` over the DP ranks, ``opt`` (a
    ``torch.optim`` factory such as
    :func:`bluefog_tpu_torch.optimizers.adam`) wrapped in
    ``adapt_with_combine(delayed=...)``, and
    :func:`bluefog_tpu_torch.optimizers.make_train_step`.  Returns
    ``(step, strategy)``; the strategy is needed for
    ``init_distributed(strategy, params)``."""
    from .. import optimizers as bfopt
    comm = bfopt.neighbor_communicator(m.schedule, fuse=fuse,
                                       concurrent=concurrent)
    strategy = bfopt.adapt_with_combine(opt, comm, delayed=delayed)
    step = bfopt.make_train_step(grad_fn, strategy,
                                 steps_per_call=steps_per_call,
                                 reuse_batch=reuse_batch)
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

    def validate(self) -> None:
        """The JAX rules at pp = tp = sp = 1 (the rules on those axes
        always hold there)."""
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

    def flops_per_token(self) -> float:
        """Training FLOPs/token: 6N weight term + attention score/value
        matmuls (the JAX accounting)."""
        return (6.0 * self.n_params
                + 6.0 * self.layers * self.d_model * self.seq_len)


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
                    stacked: bool = False) -> Union[ComposeLM, dict]:
    """Build the port's LM from a JAX ``init_lm_params`` /
    ``checkpoint.load_for_serving`` tree carved at pp = tp = 1 (leaves as
    numpy arrays or anything ``np.asarray`` takes).  Leaves come stacked
    ``[n_devices, ...]``.  By default every row is a replica and row 0
    becomes the serving module; with ``stacked=True`` the training tree
    ``{"blocks", "shared"}`` comes back as stacked tensors with every row
    kept (ranks diverge once training starts)."""
    dev = resolve_device(device)
    want = (cfg.layers, cfg.d_model, 3 * cfg.d_model)
    if np.asarray(tree["blocks"]["wqkv"]).shape[1:] != want:
        raise ValueError(f"wqkv {np.asarray(tree['blocks']['wqkv']).shape}"
                         f" != [n, {want}]: the tree must be a pp = tp = 1 "
                         "carving of this LMConfig")
    if stacked:
        def t(x):
            return torch.as_tensor(np.array(x, dtype=np.float32)).to(dev)
        return {"blocks": {k: t(v) for k, v in tree["blocks"].items()},
                "shared": {k: t(v) for k, v in tree["shared"].items()}}
    blocks = {k: np.asarray(v)[0] for k, v in tree["blocks"].items()}
    shared = tree["shared"]
    return _load(ComposeLM(cfg), blocks, np.asarray(shared["embed"])[0],
                 np.asarray(shared["head"])[0]).to(dev)


# ---------------------------------------------------------------------------
# Training: stacked params, batches and the per-rank gradient
# ---------------------------------------------------------------------------

def init_lm_train_params(cfg: LMConfig, m: Mesh3D, seed: int = 0) -> dict:
    """The JAX ``init_lm_params(cfg, m, seed)`` tree at pp = tp = sp = 1:
    ``{"blocks": {wqkv, wo, w1, w2}, "shared": {embed, head}}`` with every
    leaf stacked ``[dp, ...]`` on ``m.device`` (every rank starts from the
    same draw)."""
    cfg.validate()
    blocks, embed, head = _draw_weights(cfg, seed)

    def stack(a):
        t = torch.from_numpy(a).to(m.device)
        return t.unsqueeze(0).expand((m.size,) + a.shape).contiguous()

    return {"blocks": {k: stack(v) for k, v in blocks.items()},
            "shared": {"embed": stack(embed), "head": stack(head)}}


def make_lm_batch(cfg: LMConfig, m: Mesh3D, seed: int = 0,
                  steps: Optional[int] = None) -> torch.Tensor:
    """Copy-task tokens stacked per rank, ``[dp, (steps,) micro, batch,
    seq_len]`` int32 on ``m.device``: the JAX ``make_lm_batch`` tokens bit
    for bit (the same ``rng.integers`` call; each rank draws its own
    data)."""
    rng = np.random.default_rng(seed)
    shape = (m.dp, cfg.micro, cfg.batch, cfg.seq_len) if steps is None \
        else (m.dp, steps, cfg.micro, cfg.batch, cfg.seq_len)
    data = rng.integers(0, cfg.vocab, size=shape).astype(np.int32)
    return torch.from_numpy(data).to(m.device)


def make_lm_grad_fn(cfg: LMConfig, m: Mesh3D, *, use_pallas: bool = False):
    """Per-rank ``grad_fn(params, toks) -> (loss, grads)`` for the composed
    LM at pp = tp = sp = 1 (the JAX ``make_lm_grad_fn``'s ``layer_fn`` and
    copy-task loss: mean cross-entropy of predicting the token ``lag``
    positions back, over positions ``lag:``).

    The microbatch loop is ``pipeline_apply`` at one stage: the decoder
    blocks run once per microbatch, so the K1/K2 kernels launch once per
    (microbatch, layer).  Each microbatch's loss (``1/micro`` of the mean)
    is back-propagated before the next one runs, so the
    ``[micro, batch, seq, vocab]`` logits never exist at once; only the
    summation order of the mean differs from the JAX function.
    ``use_pallas`` selects the flash attention path on the CPU (the
    kernels' plain versions); on CUDA the kernels always run."""
    cfg.validate()
    from ..fusion import tree_flatten, tree_unflatten

    D, H, V = cfg.d_model, cfg.heads, cfg.vocab
    hsz, T, B, lag = D // H, cfg.seq_len, cfg.batch, cfg.lag
    block_q = min(512, cfg.seq_len)

    def layer_fn(lp, x, positions):
        h = _ln(x)
        q, k, v = (h @ lp["wqkv"]).split(D, dim=-1)
        q = apply_rope(q.reshape(B, T, H, hsz), positions)
        k = apply_rope(k.reshape(B, T, H, hsz), positions)
        v = v.reshape(B, T, H, hsz)
        att = ulysses_attention(q, k, v, causal=True, use_pallas=use_pallas,
                                pallas_block_q=block_q)
        x = x + att.reshape(B, T, D) @ lp["wo"]
        h = _ln(x)
        return x + _gelu(h @ lp["w1"]) @ lp["w2"]

    def grad_fn(params, toks):
        leaves, treedef = tree_flatten(params)
        ws = [x.detach().requires_grad_() for x in leaves]
        p = tree_unflatten(treedef, ws)
        positions = torch.arange(T, device=toks.device)
        micro = toks.shape[0]
        total = torch.zeros((), device=toks.device)
        with torch.enable_grad():
            for mb in range(micro):
                t = toks[mb].long()
                x = p["shared"]["embed"][t]                    # [B, T, D]
                for layer in range(cfg.layers):
                    x = layer_fn({k: w[layer] for k, w in p["blocks"].items()},
                                 x, positions)
                logits = _ln(x) @ p["shared"]["head"]
                targets = torch.roll(t, lag, dims=-1)
                loss = F.cross_entropy(
                    logits[:, lag:].reshape(-1, V),
                    targets[:, lag:].reshape(-1)) / micro
                loss.backward()
                total = total + loss.detach()
                del x, logits, loss
        return total, tree_unflatten(treedef, [w.grad for w in ws])

    return grad_fn
