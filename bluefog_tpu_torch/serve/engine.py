"""Prefill + fused decode engine over a carving (counterpart of
``bluefog_tpu/serve/engine.py``), its peers stacked on one device.

The carving is the JAX engine's: ``dp`` replicas, each holding the whole
model cut into ``pp`` stages and ``tp`` tensor-parallel peers (and, for
an MoE model, its experts over ``ep`` peers), every replica serving its
own requests.  On one card the replicas and peers are stacked: each
weight is ``[dp, tp, ...]`` per layer (:class:`~bluefog_tpu_torch.
parallel.compose.ServingParams`), the stages' layers run in order, and
a ``psum`` over tp is a sum over the tp peers in peer order.  A serving
module (``ComposeLM`` / ``MoELM``) is the carving of size 1 and runs
through the same code.  ``sp > 1`` is refused as in JAX.

Shapes are bucketed as in the JAX engine: decode batches only have the
lane counts in ``ServeConfig.batch_buckets`` (idle lanes ride the trash
slot) and prompts are padded to ``prefill_buckets``.  The host surface
takes and returns the JAX engine's ``[replicas, S]`` arrays.

Each decode call runs ``decode_steps_per_call`` tokens for every replica
at once: embed, then per layer LN -> each tp peer's qkv columns -> rope
-> cache append (quantized for int8/fp8 stores) -> flash-decode
attention -> each peer's output rows, summed over tp -> FFN (the dense
FFN the same way), then the logits and the next token, which feeds the
next step without leaving the device.  The caches of every replica and
tp peer are one tensor (:mod:`.kv_cache`), so decode attention is ONE
call a layer-step of
:func:`~bluefog_tpu_torch.ops.flash_decode.flash_attend_rows` over every
replica's lanes and every peer's heads: on a CUDA cache always the
hand-written kernel (``decode_kernel`` selects no path: as in the JAX
config, ``"pallas"`` declares ``decode_block_k`` and checks it,
``"xla"`` leaves it unchecked).  Prefill runs one replica (the others
idle, as the JAX engine's run their trash slot); its attention over the
prompt is dense and full precision.

An :class:`~bluefog_tpu_torch.moe.model.MoELMConfig` model is served as
the JAX engine serves it: each block's FFN is the top-k router (once a
replica: tp and ep peers route alike), the dropless sort-based dispatch
of every ep peer's (replicated) lane rows over the stacked expert peers,
and ONE grouped expert FFN call (the hand-written kernel K4 on CUDA) for
every replica, tp peer and ep owner, with the small decode tile
``decode_tile(ep * S * k, E / ep)`` on the decode path and
``group_tile`` for prefill.  The tp sum comes before the gate-weighted
combine.  Decode folds each layer's routing of the live lanes into each
replica's ``[E + 2]`` hot-expert carrier, which
:meth:`ServeEngine.moe_load` reads.

Fast paths, as in the JAX engine:

- **Self-speculative decoding** (``spec_decode=k``): the draft is the
  first ``spec_stages`` of the carving's ``pp`` pipeline stages
  (:func:`~bluefog_tpu_torch.parallel.compose.draft_carve`; on one card
  the stages' layers simply run in order), early-exited into the shared
  LN + head; it drafts k greedy tokens, then one chunk call of T = k + 1
  (K3's chunk form) verifies them and the host keeps the longest
  agreeing prefix plus the target's bonus token.  An MoE draft runs the
  expert-mean dense FFN (plain PyTorch: the JAX engine computes it in
  XLA): each owner's experts summed, then the owners in order, over E.
- **Shared prefix pages** (``prefix_pages=p``): prompt prefixes sealed
  once into each replica's reserved cache rows by a plain prefill; a
  prefix-hit request prefills only its remainder
  (:meth:`ServeEngine.chunk_prefill`, K3's chunk form at the prefill
  bucket's T) and every attention reads through the page indirection.

Observability, as in the JAX engine: with request tracing armed
(:mod:`bluefog_tpu_torch.utils.tracing`) each call adds a
``prefill_call`` / ``chunk_call`` / ``decode_call`` / ``spec_round`` span
(``cat="engine"``) on the host clock, ending where the call's tokens
reach the host (a seal ends at its launch: it reads nothing back);
disarmed, a call pays one flag read.  A speculative round counts
``bluefog_serve_spec_{drafted,accepted}_total`` in the metrics registry,
and :meth:`ServeEngine.warmup` leaves a ``warmup`` flight record.  The
JAX engine's retrace sentinel has no counterpart: nothing here compiles
per shape.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.rope import _cos_sin, _rotate
from ..moe import layers as _layers
from ..moe.dropless import decode_tile
from ..moe.model import MoELMConfig
from ..ops import flash_decode as _fd
from ..ops.collectives import peer_sum
from ..ops.ulysses import dense_attention
from ..parallel.compose import (ComposeLM, LMConfig, ServingParams, _gelu,
                                _ln, draft_carve)
from ..utils import flight as _flight
from ..utils import metrics as _metrics
from ..utils import tracing as _tracing
from . import kv_cache as _kv

__all__ = ["ServeConfig", "ServeEngine"]

_ROPE_BASE = 10000.0          # the rope functions' default, as in JAX

_BUCKET_GRAMMAR = ("'<batch,...>@<prompt_len,...>' with positive ints "
                   "(e.g. '1,2,4@8,16')")


def _parse_buckets(spec: str) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``"1,2,4@8,16"`` -> ``((1, 2, 4), (8, 16))`` (batch@prefill); a
    malformed spec names the offending token and the grammar."""
    if spec.count("@") > 1:
        raise ValueError(
            f"BLUEFOG_SERVE_BUCKETS={spec!r}: more than one '@' — expected "
            + _BUCKET_GRAMMAR)
    batch_s, _, prefill_s = spec.partition("@")

    def ints(part: str, side: str) -> Tuple[int, ...]:
        out = []
        for tok in part.split(","):
            tok = tok.strip()
            if not tok:
                continue
            try:
                v = int(tok)
            except ValueError:
                raise ValueError(
                    f"BLUEFOG_SERVE_BUCKETS={spec!r}: bad {side} bucket "
                    f"token {tok!r} — expected " + _BUCKET_GRAMMAR) from None
            if v < 1:
                raise ValueError(
                    f"BLUEFOG_SERVE_BUCKETS={spec!r}: {side} bucket "
                    f"{tok!r} must be >= 1 — expected " + _BUCKET_GRAMMAR)
            out.append(v)
        return tuple(out)

    return ints(batch_s, "batch"), ints(prefill_s, "prefill")


def _env_int(name: str, tok: str, grammar: str) -> int:
    try:
        v = int(tok.strip())
    except ValueError:
        raise ValueError(f"{name}={tok!r}: bad token {tok.strip()!r} — "
                         f"expected {grammar}") from None
    if v < 0:
        raise ValueError(f"{name}={tok!r}: {tok.strip()!r} must be >= 0 — "
                         f"expected {grammar}")
    return v


_MOE_GRAMMAR = ("'<experts>[x<top_k>][@<ep>][:<tile>]' with positive ints "
                "(e.g. '8', '8x2', '8x2@2:4'; tile in 1..8, omitted = "
                "auto decode tile)")


def _parse_serve_moe(spec: str) -> Tuple[int, int, int, int]:
    """``"8x2@2:4"`` -> ``(experts=8, top_k=2, ep=2, tile=4)``; ``top_k``
    / ``ep`` / ``tile`` default to 1 / 1 / 0 (0: the engine picks the
    decode tile).  A malformed spec names the offending token and the
    grammar."""
    body, _, tile_s = spec.partition(":")
    body, _, ep_s = body.partition("@")
    e_s, _, k_s = body.partition("x")

    def intval(tok: str, what: str, lo: int) -> int:
        tok = tok.strip()
        try:
            v = int(tok)
        except ValueError:
            raise ValueError(
                f"BLUEFOG_SERVE_MOE={spec!r}: bad {what} token {tok!r} — "
                f"expected " + _MOE_GRAMMAR) from None
        if v < lo:
            raise ValueError(
                f"BLUEFOG_SERVE_MOE={spec!r}: {what} {tok!r} must be >= "
                f"{lo} — expected " + _MOE_GRAMMAR)
        return v

    return (intval(e_s, "experts", 1),
            intval(k_s, "top_k", 1) if k_s else 1,
            intval(ep_s, "ep", 1) if ep_s else 1,
            intval(tile_s, "tile", 1) if tile_s else 0)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static serving shapes: the JAX ``ServeConfig``'s fields and rules.

    ``spec_decode`` is the draft depth k of self-speculative decoding (0:
    off; greedy only) and ``spec_stages`` the pipeline stages its draft
    runs; ``prefix_pages`` / ``prefix_page_tokens`` size the shared
    prefix pool and the page granularity prompts are keyed at.
    ``moe_experts``/``moe_top_k``/``moe_ep`` declare an MoE model and
    its expert-parallel peers a replica (checked against the model and
    the carving by the engine) and ``moe_tile`` its decode tile (0:
    auto).
    ``decode_block_k`` is the flash-decode KV block (clamped to
    ``max_len``), checked only under ``decode_kernel == "pallas"``, as
    the JAX config checks it; :attr:`kernel_block_k` is what the engine
    hands the kernel."""
    batch_buckets: Tuple[int, ...] = (1, 2, 4)
    prefill_buckets: Tuple[int, ...] = (8, 16)
    slots: int = 8
    max_len: int = 64
    decode_steps_per_call: int = 1
    dtype: torch.dtype = torch.float32
    kv_dtype: str = "raw"
    decode_kernel: str = "xla"
    decode_block_k: int = 128
    spec_decode: int = 0
    spec_stages: int = 1
    prefix_pages: int = 0
    prefix_page_tokens: int = 16
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_ep: int = 1
    moe_tile: int = 0

    def __post_init__(self):
        if not self.batch_buckets or not self.prefill_buckets:
            raise ValueError("declare at least one batch and one prefill "
                             "bucket — undeclared shapes retrace")
        for name in ("batch_buckets", "prefill_buckets"):
            b = getattr(self, name)
            if tuple(sorted(set(b))) != tuple(b):
                raise ValueError(f"{name}={b} must be strictly ascending")
        if self.batch_buckets[-1] > self.slots:
            raise ValueError(
                f"largest batch bucket ({self.batch_buckets[-1]}) exceeds "
                f"slots ({self.slots}); a lane needs a resident slot")
        if self.prefill_buckets[-1] > self.max_len:
            raise ValueError(
                f"largest prefill bucket ({self.prefill_buckets[-1]}) "
                f"exceeds max_len ({self.max_len})")
        if self.decode_steps_per_call < 1:
            raise ValueError("decode_steps_per_call must be >= 1")
        if self.kv_dtype not in _kv.KV_STORES:
            raise ValueError(f"kv_dtype={self.kv_dtype!r}: expected one of "
                             f"{', '.join(_kv.KV_STORES)}")
        if self.decode_kernel not in ("xla", "pallas"):
            raise ValueError(
                f"decode_kernel={self.decode_kernel!r}: expected 'xla' or "
                "'pallas'")
        if self.decode_block_k < 1:
            raise ValueError("decode_block_k must be >= 1")
        if self.decode_kernel == "pallas":
            # fail at config time, not at the first decode step
            bk = _fd._block_k_for(self.max_len, self.decode_block_k)
            if self.prefix_pages and self.prefix_page_tokens % bk:
                raise ValueError(
                    f"prefix_page_tokens ({self.prefix_page_tokens}) must be "
                    f"a multiple of the flash-decode KV block "
                    f"({bk}): the kernel routes whole KV blocks through the "
                    "shared prefix page, so a prefix may not end mid-block")
        if self.spec_decode < 0:
            raise ValueError("spec_decode (draft depth k) must be >= 0")
        if self.spec_stages < 1:
            raise ValueError("spec_stages must be >= 1")
        if self.prefix_pages < 0:
            raise ValueError("prefix_pages must be >= 0")
        if self.prefix_page_tokens < 1:
            raise ValueError("prefix_page_tokens must be >= 1")
        if self.prefix_pages and \
                self.prefix_page_tokens > self.prefill_buckets[-1]:
            raise ValueError(
                f"prefix_page_tokens ({self.prefix_page_tokens}) exceeds "
                f"the largest prefill bucket ({self.prefill_buckets[-1]}): "
                "a prefix page is sealed by one prefill call")
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0 (0 = greedy)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.spec_decode and self.temperature > 0.0:
            raise ValueError(
                "speculative decoding is greedy-only: its accept rule is "
                "argmax-prefix agreement; sampled speculation needs the "
                "full accept-reject rule (set temperature=0.0 or "
                "spec_decode=0)")
        if self.moe_experts < 0:
            raise ValueError("moe_experts must be >= 0 (0 = dense model)")
        if self.moe_experts:
            if self.moe_top_k not in (1, 2):
                raise ValueError(
                    f"moe_top_k ({self.moe_top_k}) must be 1 or 2: serving "
                    "routes top-k only")
            if self.moe_ep < 1:
                raise ValueError(f"moe_ep ({self.moe_ep}) must be >= 1")
            if self.moe_experts % self.moe_ep:
                raise ValueError(
                    f"moe_serving_ep_mismatch: moe_experts "
                    f"({self.moe_experts}) % moe_ep ({self.moe_ep}) != 0 — "
                    "each expert-parallel peer owns a contiguous block of "
                    f"experts; offender: moe_ep={self.moe_ep}")
            if not 0 <= self.moe_tile <= 8:
                raise ValueError(
                    f"moe_tile ({self.moe_tile}) must be in [0, 8] (0 = "
                    "auto): decode batches are tiny, so grouped tiles "
                    "above 8 rows pad every expert group with mostly-zero "
                    "tiles")

    @property
    def kernel_block_k(self) -> int:
        """The KV block handed to the decode kernel.  K3 reads it only to
        pick a key's prefix row, so under ``"xla"`` (no block declared)
        it is ``max_len``, which always tiles."""
        return (self.decode_block_k if self.decode_kernel == "pallas"
                else self.max_len)

    @property
    def decode_window(self) -> int:
        """Most tokens one engine call can add to a slot (plain fused
        decode vs one speculative round's k drafts + bonus)."""
        return max(self.decode_steps_per_call,
                   self.spec_decode + 1 if self.spec_decode else 0)

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        """The JAX env surface: ``BLUEFOG_SERVE_BUCKETS``,
        ``BLUEFOG_KV_DTYPE``, ``BLUEFOG_DECODE_KERNEL`` (``'xla'``,
        ``'pallas'`` or ``'pallas@<block_k>'``),
        ``BLUEFOG_SPEC_DECODE='<k>[@<stages>]'``,
        ``BLUEFOG_PREFIX_PAGES='<pages>[x<page_tokens>]'`` and
        ``BLUEFOG_SERVE_MOE='<experts>[x<top_k>][@<ep>][:<tile>]'``."""
        spec = os.environ.get("BLUEFOG_SERVE_BUCKETS", "")
        if spec:
            batch, prefill = _parse_buckets(spec)
            overrides.setdefault("batch_buckets", batch)
            if prefill:
                overrides.setdefault("prefill_buckets", prefill)
        sd = os.environ.get("BLUEFOG_SPEC_DECODE", "")
        if sd:
            grammar = "'<k>' or '<k>@<stages>' (e.g. '4' or '4@1')"
            k_s, _, st_s = sd.partition("@")
            overrides.setdefault(
                "spec_decode", _env_int("BLUEFOG_SPEC_DECODE", k_s, grammar))
            if st_s:
                overrides.setdefault(
                    "spec_stages",
                    _env_int("BLUEFOG_SPEC_DECODE", st_s, grammar))
        kd = os.environ.get("BLUEFOG_KV_DTYPE", "")
        if kd:
            if kd not in _kv.KV_STORES:
                raise ValueError(
                    f"BLUEFOG_KV_DTYPE={kd!r}: bad token {kd!r} — expected "
                    f"one of {', '.join(_kv.KV_STORES)}")
            overrides.setdefault("kv_dtype", kd)
        dk = os.environ.get("BLUEFOG_DECODE_KERNEL", "")
        if dk:
            grammar = ("'xla' or 'pallas' or 'pallas@<block_k>' "
                       "(e.g. 'pallas@128')")
            kern, _, bk_s = dk.partition("@")
            if kern not in ("xla", "pallas"):
                raise ValueError(
                    f"BLUEFOG_DECODE_KERNEL={dk!r}: bad token {kern!r} — "
                    f"expected {grammar}")
            overrides.setdefault("decode_kernel", kern)
            if bk_s:
                overrides.setdefault(
                    "decode_block_k",
                    _env_int("BLUEFOG_DECODE_KERNEL", bk_s, grammar))
        pp = os.environ.get("BLUEFOG_PREFIX_PAGES", "")
        if pp:
            grammar = ("'<pages>' or '<pages>x<page_tokens>' "
                       "(e.g. '4' or '4x16')")
            pages_s, _, ptok_s = pp.partition("x")
            overrides.setdefault(
                "prefix_pages",
                _env_int("BLUEFOG_PREFIX_PAGES", pages_s, grammar))
            if ptok_s:
                overrides.setdefault(
                    "prefix_page_tokens",
                    _env_int("BLUEFOG_PREFIX_PAGES", ptok_s, grammar))
        sm = os.environ.get("BLUEFOG_SERVE_MOE", "")
        if sm:
            experts, top_k, ep, tile = _parse_serve_moe(sm)
            overrides.setdefault("moe_experts", experts)
            overrides.setdefault("moe_top_k", top_k)
            overrides.setdefault("moe_ep", ep)
            overrides.setdefault("moe_tile", tile)
        return cls(**overrides)

    def batch_bucket_for(self, lanes: int) -> int:
        """Smallest declared decode bucket that fits ``lanes`` live lanes."""
        for b in self.batch_buckets:
            if b >= lanes:
                return b
        raise ValueError(f"{lanes} live lanes exceed the largest declared "
                         f"batch bucket {self.batch_buckets[-1]}")

    def prefill_bucket_for(self, length: int) -> int:
        """Smallest declared prompt pad length that fits ``length`` tokens."""
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(f"prompt of {length} tokens exceeds the largest "
                         f"declared prefill bucket "
                         f"{self.prefill_buckets[-1]}")


def _serving(model: Union[ComposeLM, ServingParams], pp: Optional[int],
             device: torch.device
             ) -> Tuple[ServingParams, Optional[ComposeLM]]:
    """``(params on device, the module or None)`` for what the engine is
    given: a carving's params (at ``pp`` stages, if named) or one module,
    the carving of size 1 at ``pp`` stages (default 1)."""
    if isinstance(model, ServingParams):
        if pp is not None and pp != model.m.pp:
            raise ValueError(f"pp={pp!r}, but the params are carved at "
                             f"pp={model.m.pp}")
        return model.to(device), None
    pp = 1 if pp is None else pp
    if not isinstance(pp, int) or pp < 1:
        raise ValueError(f"pp ({pp!r}) must be an int >= 1")
    module = model.to(device).requires_grad_(False)
    return ServingParams.from_module(module, pp), module


class ServeEngine:
    """Prefill and fused decode of a carving of the composed LM (dense or
    MoE) over slotted paged KV caches on one device.

    ``model`` is a :class:`~bluefog_tpu_torch.parallel.compose.
    ServingParams` (a carving's weights, from ``params_from_jax(tree, cfg,
    m=m)`` or ``moe_params_from_jax(tree, cfg, m=m)``: ``m.dp`` replicas
    of ``m.pp`` stages x ``m.tp`` x ``m.ep`` peers) or one serving module
    (``init_lm_params`` / ``params_from_jax`` without ``m``, or their MoE
    counterparts: the carving of size 1, whose pipeline stages ``pp``
    names).  The engine moves the weights to ``device`` (CUDA unless the
    caller passes ``device="cpu"``) and never changes them;
    :meth:`update_params` rebinds them.  The caches are updated in place.
    On one card the stages' layers run in order with the same math, so
    ``pp`` only sets how deep the speculative draft is
    (``draft_carve(pp, cfg, spec_stages)``) and must divide the layers.
    """

    def __init__(self, cfg: LMConfig,
                 model: Union[ComposeLM, ServingParams],
                 scfg: Optional[ServeConfig] = None, *,
                 pp: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        params, self.model = _serving(model, pp, self.device)
        m = params.m
        if m.sp != 1:
            raise ValueError(
                "serving decodes one token at a time; an sp > 1 carving has "
                "no sequence to shard — fold sp into tp for inference")
        self._moe = isinstance(cfg, MoELMConfig)
        if self._moe and cfg.router_mode == "expert_choice":
            raise ValueError(
                "moe_serving_requires_topk_router: expert-choice routing "
                "selects each expert's top-C tokens over the WHOLE "
                "sequence, but autoregressive decode sees one token at a "
                "time — an EC router at serve time would condition routing "
                "on future tokens (the causality caveat that keeps it "
                "training-only).  Serve with router_mode='topk'.")
        cfg.validate(m)
        if params.cfg != cfg:
            raise ValueError(f"model was built for {params.cfg}, not {cfg}")
        scfg = scfg or ServeConfig.from_env()
        if scfg.max_len < scfg.prefill_buckets[-1] + scfg.decode_window:
            raise ValueError("max_len leaves no room to decode past the "
                             "longest prompt bucket")
        if scfg.moe_experts and not self._moe:
            raise ValueError(
                f"ServeConfig declares an MoE (moe_experts="
                f"{scfg.moe_experts}, via BLUEFOG_SERVE_MOE or --serve-moe) "
                "but the model config is dense — build an MoELMConfig or "
                "drop the knob")
        if self._moe and scfg.moe_experts:
            for knob, mine in (("moe_experts", cfg.num_experts),
                               ("moe_top_k", cfg.top_k),
                               ("moe_ep", m.ep)):
                declared = getattr(scfg, knob)
                if declared != mine:
                    raise ValueError(
                        f"ServeConfig.{knob}={declared} does not match the "
                        f"model/carving value {mine} — the serve-MoE knob "
                        "must agree with the MoELMConfig and the ep carve")
        if self._moe:
            # decode tile: every ep peer contributes its (replicated) lane
            # rows, so each owner's grouped buffer sees ep * S * k rows
            # over its E / ep groups; prefill and verify (chunk) shapes
            # keep the training tile
            self._moe_tile = scfg.moe_tile or decode_tile(
                m.ep * scfg.batch_buckets[-1] * cfg.top_k,
                cfg.num_experts // m.ep)
            self._moe_chunk_tile = cfg.group_tile
        self._route_stats: Optional[torch.Tensor] = None
        self.m, self.cfg, self.scfg, self.pp = m, cfg, scfg, m.pp
        self.replicas = m.dp
        self.draft = draft_carve(m.pp, cfg, scfg.spec_stages) \
            if scfg.spec_decode else None
        self.params = params
        self.cache_cfg = _kv.KVCacheConfig(
            layers=cfg.layers, slots=scfg.slots, max_len=scfg.max_len,
            kv_heads=cfg.heads // m.tp, head_dim=cfg.head_dim,
            dtype=scfg.dtype, store=scfg.kv_dtype,
            prefix_slots=scfg.prefix_pages)
        self.cache = _kv.init_cache(self.cache_cfg, self.device,
                                    replicas=m.dp, tp=m.tp)
        # replica r's cache rows start at r * rows
        self._ridx = torch.arange(m.dp, device=self.device)[:, None]
        self._rowoff = (self._ridx * self.cache_cfg.rows).to(torch.int32)
        # per-row sampling generators (keyed by the cache row, replica
        # folded in), re-seeded at each prefill from (seed, replica * rows
        # + row, admission count) so a fixed seed replays a fixed run
        self._gens: Dict[int, torch.Generator] = {}
        self._seed_count = 0
        # the MoE draft's expert-mean FFN weights, per draft layer (built
        # at the first draft, dropped when the weights are rebound)
        self._mean_ffn: Optional[list] = None
        self._engine_trace = ""          # minted lazily when tracing is armed

    def _trace_id(self) -> str:
        if not self._engine_trace:
            self._engine_trace = _tracing.new_trace("engine")
        return self._engine_trace

    # ------------------------------------------------------------------
    # device-side math: activations [R, N, D] (N positions a replica) of
    # R replicas (all of them, or the slice ``rs``), weights [R, tp, ...]
    # per layer
    # ------------------------------------------------------------------

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s views of the cache (writes land in the cache)."""
        return {name: t[i] for name, t in self.cache.items()}

    def _w(self, name: str, i: int, rs: Optional[slice]) -> torch.Tensor:
        t = self.params.blocks[name][i]
        return t if rs is None else t[rs]

    def _qkv(self, i: int, x: torch.Tensor, rs: Optional[slice],
             shape: Tuple[int, ...]):
        """``x [R, N, D]`` -> ``(q, k, v)``, each of ``shape`` (heads last,
        ``[..., H, Dh]``): every tp peer's columns of its replica's
        ``wqkv`` in one batched product, peer t's heads at ``t * H / tp
        ..``."""
        w = self._w("wqkv", i, rs)                     # [R, tp, D, 3 D / tp]
        R, TP = w.shape[:2]
        H, Dh = self.cfg.heads, self.cfg.head_dim
        qkv = torch.matmul(_ln(x)[:, None], w)        # [R, tp, N, 3 D / tp]
        return qkv.reshape(R, TP, -1, 3, H // TP, Dh).permute(
            3, 0, 2, 1, 4, 5).reshape((3,) + shape).unbind(0)

    def _out(self, i: int, att: torch.Tensor,
             rs: Optional[slice]) -> torch.Tensor:
        """The attention output projection ``[R, N, D]`` of ``att`` (``R
        * N`` positions' heads): each tp peer's heads through its rows of
        ``wo``, summed over the peers in order (the JAX ``psum`` over
        ``"tp"``)."""
        wo = self._w("wo", i, rs)                      # [R, tp, D / tp, D]
        R, TP, Dl, _ = wo.shape
        a = att.reshape(R, -1, TP, Dl).transpose(1, 2)
        return peer_sum(torch.matmul(a, wo), 1)

    def _dense_ffn(self, x: torch.Tensor, w1: torch.Tensor,
                   w2: torch.Tensor) -> torch.Tensor:
        """The residual gelu FFN of ``x [R, N, D]`` over each tp peer's
        ``w1 [R, tp, D, F / tp]`` columns and ``w2`` rows, summed over the
        peers in order."""
        u = _gelu(torch.matmul(_ln(x)[:, None], w1))
        return x + peer_sum(torch.matmul(u, w2), 1)

    def _ffn(self, i: int, x: torch.Tensor, tile: Optional[int],
             rs: Optional[slice]):
        """The FFN sublayer of layer ``i`` on ``x [R, N, D]``; returns
        ``(x, routing)``, ``routing`` the router's ``(probs [R, N, E], idx
        [R, N, k])`` on the MoE path (``None`` when dense)."""
        if not self._moe:
            return self._dense_ffn(x, self._w("w1", i, rs),
                                   self._w("w2", i, rs)), None
        w1, w2 = self._w("w1e", i, rs), self._w("w2e", i, rs)
        lead = w1.shape[:3]                            # [R, tp, ep]
        hf = _ln(x)
        _, probs, idx, gate = _layers.router_topk(
            hf, self._w("wr", i, rs), top_k=self.cfg.top_k)

        def peers(t):              # every tp and ep peer holds the lanes
            return t[:, None, None].expand(lead + t.shape[1:])
        y = _layers.moe_dropless_combine(
            peers(hf), peers(idx), peers(gate), w1, w2,
            num_experts=self.cfg.num_experts, tile=tile, tp_dim=1,
            ep_dim=2)
        return x + y[:, 0, 0], (probs, idx)

    def _logits(self, x: torch.Tensor, rs: Optional[slice]) -> torch.Tensor:
        head = self.params.head if rs is None else self.params.head[rs]
        return _ln(x) @ head                           # [R, N, V]

    def _next_token(self, logits: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
        """Greedy argmax over ``logits [..., V]``, or temperature / top-p
        sampling with each lane's generator (``rows``: the lanes' cache
        rows, flattened).  top-p keeps the smallest probability-sorted set
        covering ``top_p`` mass (always >= 1 token)."""
        scfg = self.scfg
        if scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        out = []
        flat = logits.reshape(-1, logits.shape[-1]) / scfg.temperature
        for lg, row in zip(flat, rows.tolist()):
            if scfg.top_p < 1.0:
                srt = torch.sort(lg, descending=True).values
                probs = torch.softmax(srt, dim=-1)
                keep = (torch.cumsum(probs, dim=-1) - probs) < scfg.top_p
                thresh = srt[keep].min()
                lg = lg.masked_fill(lg < thresh, float("-inf"))
            out.append(torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                         generator=self._generator(row)))
        return torch.cat(out).reshape(logits.shape[:-1])

    def _generator(self, row: int) -> torch.Generator:
        if row not in self._gens:
            self._seed_row(row)
        return self._gens[row]

    def _seed_row(self, row: int) -> None:
        self._seed_count += 1
        g = torch.Generator(self.device)
        g.manual_seed(int(np.random.SeedSequence(
            [self.scfg.seed, row, self._seed_count]).generate_state(1)[0]))
        self._gens[row] = g

    def _route_vec(self, routing, live: torch.Tensor) -> torch.Tensor:
        """One layer's routing folded into each replica's ``[E + 2]``
        carrier (``[R, E + 2]``): per-expert top-1 counts over live lanes,
        summed live-token router entropy, live-token count."""
        probs, idx = routing
        w = live.to(torch.float32)                     # [R, N]
        cnt = torch.zeros((w.shape[0], self.cfg.num_experts),
                          device=w.device).scatter_add_(1, idx[..., 0], w)
        ent = (-(probs * torch.log(probs + 1e-20)).sum(-1) * w).sum(-1)
        return torch.cat([cnt, ent[:, None], w.sum(-1, keepdim=True)], -1)

    def _draft_ffn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The MoE draft's FFN at layer ``i``: the dense FFN over the
        experts' mean weights (each owner's experts summed, then the
        owners in order, over E; one matmul pair a tp peer, no routing),
        as the JAX engine's ``_ffn(draft=True)``.  Any draft keeps the
        stream exact: the verify overwrites every drafted KV row and only
        target-argmax tokens are emitted."""
        if self._mean_ffn is None:
            E, n = self.cfg.num_experts, self.draft.layers
            b = self.params.blocks
            self._mean_ffn = [(peer_sum(w1.sum(3), 2) / E,
                               peer_sum(w2.sum(3), 2) / E)
                              for w1, w2 in zip(b["w1e"][:n], b["w2e"][:n])]
        return self._dense_ffn(x, *self._mean_ffn[i])

    def _layer_step(self, i: int, x: torch.Tensor, slot_ids: torch.Tensor,
                    lens: torch.Tensor, prows, plens, rope,
                    draft: bool = False):
        """Decoder block ``i`` on one new token per lane of every replica:
        ``x [R, S, D]``, ``slot_ids`` / ``lens`` / ``prows`` / ``plens``
        ``[R * S]`` (cache rows with the replica folded in), ``rope`` the
        lanes' ``(cos, sin)``; returns ``(x, routing)`` (``routing`` is
        ``None`` when dense or on the MoE draft)."""
        H, Dh = self.cfg.heads, self.cfg.head_dim
        cl = self._layer(i)
        q, k, v = self._qkv(i, x, None, (lens.shape[0], H, Dh))
        q, k = _rotate(q, *rope), _rotate(k, *rope)
        _kv.layer_append(cl, slot_ids, lens, k, v, store=self.scfg.kv_dtype)
        att = _fd.flash_attend_rows(
            q, cl["k"], cl["v"], slot_ids, lens,
            k_scale=cl.get("k_scale"), v_scale=cl.get("v_scale"),
            prefix_slots=prows, prefix_lens=plens,
            block_k=self.scfg.kernel_block_k)
        x = x + self._out(i, att, None)
        if draft and self._moe:
            return self._draft_ffn(i, x), None
        return self._ffn(i, x, self._moe_tile if self._moe else None, None)

    @torch.inference_mode()
    def _decode_steps(self, toks: torch.Tensor, slot_ids: torch.Tensor,
                      lens: torch.Tensor, prows=None, plens=None,
                      draft: bool = False) -> torch.Tensor:
        """Fused tokens ``[steps, R, S]`` for ``toks``, ``slot_ids``,
        ``lens`` (and ``prows`` / ``plens``) ``[R, S]``:
        ``decode_steps_per_call`` steps through every layer, or
        (``draft``) ``spec_decode`` greedy steps through the draft's
        layers, then the shared LN and head.  On the MoE path a target
        call's routing of live lanes (every step, every layer) becomes
        each replica's hot-expert snapshot."""
        R, S = toks.shape
        gen = []
        n_layers = self.draft.layers if draft else self.cfg.layers
        steps = self.scfg.spec_decode if draft else \
            self.scfg.decode_steps_per_call
        track = self._moe and not draft
        live = slot_ids < self.scfg.slots                  # [R, S] real lanes
        rows = (slot_ids + self._rowoff).reshape(-1)
        if prows is not None:
            prows = (prows + self._rowoff).reshape(-1)
            plens = plens.reshape(-1)
        st = torch.zeros((R, self.cfg.num_experts + 2),
                         device=self.device) if track else None
        for _ in range(steps):
            x = self.params.embed[self._ridx, toks]           # [R, S, D]
            flat = lens.reshape(-1)
            # every layer ropes at the lanes' positions: once a step
            cos, sin = _cos_sin(flat, self.cfg.head_dim, _ROPE_BASE)
            rope = (cos[:, None], sin[:, None])
            for i in range(n_layers):
                x, routing = self._layer_step(i, x, rows, flat, prows,
                                              plens, rope, draft)
                if track:
                    st = st + self._route_vec(routing, live)
            logits = self._logits(x, None)                    # [R, S, V]
            toks = torch.argmax(logits, dim=-1) if draft else \
                self._next_token(logits, rows)
            gen.append(toks)
            lens = lens + 1
        if track:
            self._route_stats = st
        return torch.stack(gen)

    @torch.inference_mode()
    def _chunk_forward(self, toks: torch.Tensor, slot_ids: torch.Tensor,
                       lens: torch.Tensor, prows, plens,
                       rs: Optional[slice] = None) -> torch.Tensor:
        """The k-token verify forward / chunked prefill (the JAX
        ``_chunk_body``) of every replica, or of the replicas ``rs``:
        ``toks [R, S, T]``, token t of lane i at position ``lens[r, i] +
        t``.  Appends all T kv rows, attends causally over the slot (and
        through the prefix pages) with K3's chunk form, one launch a
        layer, and returns the argmax at every position ``[R, S, T]``:
        for a verify the target tokens, for a chunked prefill the
        request's first token at its last real position.  On the MoE path
        every chunk row of a live lane counts toward the hot-expert
        snapshot (replicas outside ``rs`` count none)."""
        H, Dh = self.cfg.heads, self.cfg.head_dim
        R, S, T = toks.shape
        rowoff = self._rowoff if rs is None else self._rowoff[rs]
        ridx = self._ridx if rs is None else self._ridx[rs]
        rows = (slot_ids + rowoff).reshape(-1)
        trash = (rowoff + self.cache_cfg.trash_slot).expand(R, S).reshape(-1)
        if prows is not None:
            prows = (prows + rowoff).reshape(-1)
            plens = plens.reshape(-1)
        flat = lens.reshape(-1)
        pos = flat[:, None] + torch.arange(T, device=self.device)[None]
        cos, sin = _cos_sin(pos, Dh, _ROPE_BASE)           # [R * S, T, Dh/2]
        cos, sin = cos[:, :, None], sin[:, :, None]
        live = (slot_ids < self.scfg.slots)[..., None].expand(
            R, S, T).reshape(R, S * T)
        st = torch.zeros((R, self.cfg.num_experts + 2),
                         device=self.device) if self._moe else None
        x = self.params.embed[ridx, toks.reshape(R, S * T)]  # [R, S T, D]
        for i in range(self.cfg.layers):
            cl = self._layer(i)
            q, k, v = self._qkv(i, x, rs, (R * S, T, H, Dh))
            q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
            _kv.layer_append_chunk(cl, rows, flat, k, v,
                                   store=self.scfg.kv_dtype, trash=trash)
            att = _fd.flash_attend_chunk(
                q, cl, rows, flat, prefix_slots=prows, prefix_lens=plens,
                block_k=self.scfg.kernel_block_k)
            x = x + self._out(i, att, rs)
            x, routing = self._ffn(i, x, self._moe_chunk_tile
                                   if self._moe else None, rs)
            if routing is not None:
                st = st + self._route_vec(routing, live)
        if self._moe:
            if rs is not None:
                full = torch.zeros((self.replicas,) + st.shape[1:],
                                   device=self.device)
                full[rs] = st
                st = full
            self._route_stats = st
        return torch.argmax(self._logits(x, rs), dim=-1).reshape(R, S, T)

    @torch.inference_mode()
    def _prefill_forward(self, toks: torch.Tensor, r: int, row: int,
                         true_len: int) -> torch.Tensor:
        """Run replica ``r``'s padded prompt ``toks [Tpad]`` into its
        cache row ``row``; returns the last real position's logits
        ``[V]``."""
        H, Dh = self.cfg.heads, self.cfg.head_dim
        Tpad = toks.shape[0]
        rs = slice(r, r + 1)
        cos, sin = _cos_sin(torch.arange(Tpad, device=self.device), Dh,
                            _ROPE_BASE)
        cos, sin = cos[None, :, None], sin[None, :, None]
        x = self.params.embed[r][toks][None]                 # [1, Tpad, D]
        row = r * self.cache_cfg.rows + row
        for i in range(self.cfg.layers):
            q, k, v = self._qkv(i, x, rs, (1, Tpad, H, Dh))
            q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
            # the whole padded prompt lands in the row; attention over the
            # prompt itself is dense full precision — quantization drift
            # only enters where a stored page is read back
            _kv.layer_prefill(self._layer(i), row, k[0], v[0],
                              store=self.scfg.kv_dtype)
            att = dense_attention(q, k, v, causal=True)
            x = x + self._out(i, att, rs)
            x, _ = self._ffn(i, x, self._moe_chunk_tile if self._moe
                             else None, rs)
        return _ln(x[0, true_len - 1]) @ self.params.head[r]

    # ------------------------------------------------------------------
    # host-side surface ([replicas, ...] arrays)
    # ------------------------------------------------------------------

    def _lanes(self, arr, name: str) -> torch.Tensor:
        arr = np.asarray(arr, np.int64)
        if arr.ndim < 2 or arr.shape[0] != self.replicas:
            raise ValueError(f"{name} must be [replicas={self.replicas}, S],"
                             f" got {arr.shape}")
        return torch.as_tensor(arr, device=self.device)

    def _bucket(self, S: int) -> None:
        if S not in self.scfg.batch_buckets:
            raise ValueError(f"batch lane count {S} is not a declared "
                             f"bucket {self.scfg.batch_buckets}")

    def _slot_in_range(self, slot: int) -> None:
        if not 0 <= slot < self.scfg.slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.scfg.slots})")

    def _replica_in_range(self, replica: int) -> None:
        if not 0 <= replica < self.replicas:
            raise ValueError(f"replica {replica} out of range "
                             f"[0, {self.replicas})")

    def _trash_vec(self, S: int) -> np.ndarray:
        return np.full((self.replicas, S), self.cache_cfg.trash_slot,
                       np.int32)

    def _prefix_args(self, prefix_rows, prefix_lens, S: int):
        """Per-lane prefix attachments as int32 tensors ``[replicas, S]``
        on the device, or ``(None, None)`` when prefix pages are off.  A
        lane that is not attached reads the trash row at length 0 (no
        indirection)."""
        if not self.scfg.prefix_pages:
            if prefix_rows is not None:
                raise ValueError("prefix attachments need prefix_pages > 0")
            return None, None
        if prefix_rows is None:
            prefix_rows = self._trash_vec(S)
            prefix_lens = np.zeros((self.replicas, S), np.int32)
        return (self._lanes(prefix_rows, "prefix_rows").to(torch.int32),
                self._lanes(prefix_lens, "prefix_lens").to(torch.int32))

    def prefill(self, replica: int, slot: int,
                tokens: Sequence[int]) -> Tuple[int, np.ndarray]:
        """Prefill one request into ``slot`` of ``replica``; returns the
        first greedy token and the last-position logits ``[vocab]``."""
        self._slot_in_range(slot)
        traced = _tracing.enabled()
        t0 = time.monotonic() if traced else 0.0
        logits = self._prefill_into(replica, slot, tokens)
        self._seed_row(replica * self.cache_cfg.rows + slot)
        logits = logits.float().cpu().numpy()
        if traced:
            self._prefill_span(t0, tokens, replica)
        return int(np.argmax(logits)), logits

    def _prefill_span(self, t0: float, tokens: Sequence[int],
                      replica: int) -> None:
        _tracing.add_span(self._trace_id(), "prefill_call", t0,
                          time.monotonic(), cat="engine",
                          Tpad=self.scfg.prefill_bucket_for(len(tokens)),
                          replica=replica)

    def _prefill_into(self, replica: int, row: int,
                      tokens: Sequence[int]) -> torch.Tensor:
        self._replica_in_range(replica)
        if not tokens:
            raise ValueError("empty prompt")
        Tpad = self.scfg.prefill_bucket_for(len(tokens))
        toks = np.zeros((Tpad,), np.int64)
        toks[:len(tokens)] = np.asarray(tokens, np.int64)
        return self._prefill_forward(
            torch.as_tensor(toks, device=self.device), replica, row,
            len(tokens))

    def seal_prefix(self, replica: int, row: int,
                    tokens: Sequence[int]) -> None:
        """Prefill a shared prefix into reserved page row ``row`` (from
        the replica's :class:`~bluefog_tpu_torch.serve.kv_cache.
        PrefixCache` ``admit``) with the plain prefill."""
        cc = self.cache_cfg
        if not cc.slots <= row < cc.slots + cc.prefix_slots:
            raise ValueError(f"prefix row {row} out of range "
                             f"[{cc.slots}, {cc.slots + cc.prefix_slots})")
        if len(tokens) % self.scfg.prefix_page_tokens:
            raise ValueError(f"prefix of {len(tokens)} tokens is not whole "
                             f"pages of {self.scfg.prefix_page_tokens}")
        traced = _tracing.enabled()
        t0 = time.monotonic() if traced else 0.0
        self._prefill_into(replica, row, tokens)
        if traced:
            self._prefill_span(t0, tokens, replica)

    def chunk_prefill(self, replica: int, slot: int, tokens: Sequence[int],
                      start: int, prefix_row: int) -> int:
        """Prefill only the remainder of a prefix-hit request.

        The request attached to a sealed prefix of ``start`` tokens at
        page row ``prefix_row`` of ``replica``; ``tokens`` is the rest of
        its prompt (``>= 1`` token).  The remainder, padded to its prefill
        bucket, runs as one chunk of that replica through the page
        indirection, writes its own kv into the private ``slot``
        (positions ``start ..``) and returns the request's first greedy
        token."""
        self._replica_in_range(replica)
        self._slot_in_range(slot)
        if not tokens:
            raise ValueError("empty remainder: a prefix hit always leaves "
                             ">= 1 prompt token")
        if not self.scfg.prefix_pages:
            raise ValueError("prefix attachments need prefix_pages > 0")
        Tpad = self.scfg.prefill_bucket_for(len(tokens))
        toks = np.zeros((1, 1, Tpad), np.int64)
        toks[0, 0, :len(tokens)] = np.asarray(tokens, np.int64)

        def lane(v):
            return torch.full((1, 1), v, dtype=torch.int32,
                              device=self.device)
        traced = _tracing.enabled()
        t0 = time.monotonic() if traced else 0.0
        gen = self._chunk_forward(
            torch.as_tensor(toks, device=self.device), lane(slot),
            lane(start), lane(prefix_row), lane(start),
            rs=slice(replica, replica + 1))
        self._seed_row(replica * self.cache_cfg.rows + slot)
        first = int(gen[0, 0, len(tokens) - 1])
        if traced:
            _tracing.add_span(self._trace_id(), "chunk_call", t0,
                              time.monotonic(), cat="engine", S=1, T=Tpad)
        return first

    def _chunk_call(self, toks, slots, lens, prows, plens) -> np.ndarray:
        """One chunk forward of every replica on ``[replicas, S, T]`` host
        arrays; returns the argmax tokens ``[replicas, S, T]``."""
        toks = np.asarray(toks)
        traced = _tracing.enabled()
        t0 = time.monotonic() if traced else 0.0
        prows, plens = self._prefix_args(prows, plens, toks.shape[1])
        gen = self._chunk_forward(
            self._lanes(toks, "tokens"),
            self._lanes(slots, "slots").to(torch.int32),
            self._lanes(lens, "lens").to(torch.int32), prows, plens)
        out = gen.cpu().numpy().astype(np.int32)
        if traced:
            _tracing.add_span(self._trace_id(), "chunk_call", t0,
                              time.monotonic(), cat="engine",
                              S=int(toks.shape[1]), T=int(toks.shape[2]))
        return out

    def decode(self, tokens: np.ndarray, slots: np.ndarray,
               lens: np.ndarray, prefix_rows: Optional[np.ndarray] = None,
               prefix_lens: Optional[np.ndarray] = None) -> np.ndarray:
        """One fused decode call for every replica at one batch bucket.

        ``tokens``/``slots``/``lens``: ``[replicas, S]`` with ``S`` in
        ``batch_buckets``; idle lanes use the trash slot with ``lens=0``.
        ``lens[r, i]`` is the position the lane's pending token occupies.
        ``prefix_rows`` / ``prefix_lens`` attach lanes to sealed prefix
        pages (trash row at length 0 for lanes that are not attached).
        Returns ``[replicas, decode_steps_per_call, S]`` tokens."""
        S = np.asarray(tokens).shape[1]
        self._bucket(S)
        traced = _tracing.enabled()
        t0 = time.monotonic() if traced else 0.0
        prows, plens = self._prefix_args(prefix_rows, prefix_lens, S)
        gen = self._decode_steps(self._lanes(tokens, "tokens"),
                                 self._lanes(slots, "slots").to(torch.int32),
                                 self._lanes(lens, "lens").to(torch.int32),
                                 prows, plens)
        out = gen.permute(1, 0, 2).cpu().numpy().astype(np.int32)
        if traced:
            _tracing.add_span(self._trace_id(), "decode_call", t0,
                              time.monotonic(), cat="engine", S=int(S))
        return out

    def spec_decode(self, tokens: np.ndarray, slots: np.ndarray,
                    lens: np.ndarray,
                    prefix_rows: Optional[np.ndarray] = None,
                    prefix_lens: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative round for every replica: draft k, verify in
        one chunk, accept.

        Same lane contract as :meth:`decode`.  Returns ``(emitted,
        counts)``: ``emitted`` is ``[replicas, S, k+1]`` int32 (positions
        ``>= counts`` hold -1) and ``counts`` ``[replicas, S]``: each lane
        advances by ``counts`` tokens (``1 <= counts <= k+1``: the
        accepted draft prefix plus the target's bonus token).  Every
        emitted token is a target-argmax token, so the stream equals plain
        greedy decode; speculation only changes how many arrive a call.
        The drafts stay on the device for the verify: the one read back
        is the drafts and the verify's tokens, together, at the end."""
        k = self.scfg.spec_decode
        if not k:
            raise ValueError("spec_decode is not armed "
                             "(ServeConfig.spec_decode == 0)")
        tokens = np.asarray(tokens, np.int32)
        slots = np.asarray(slots, np.int32)
        S = tokens.shape[1]
        self._bucket(S)
        traced = _tracing.enabled()
        t0 = time.monotonic() if traced else 0.0
        prows, plens = self._prefix_args(prefix_rows, prefix_lens, S)
        toks_t = self._lanes(tokens, "tokens")
        slots_t = self._lanes(slots, "slots").to(torch.int32)
        lens_t = self._lanes(lens, "lens").to(torch.int32)
        drafts = self._decode_steps(toks_t, slots_t, lens_t, prows, plens,
                                    draft=True).permute(1, 2, 0)  # [R, S, k]
        # verify chunk [t0, d_1 .. d_k] per lane: the draft's kv rows are
        # overwritten with the (same) target values and the later layers
        # get theirs written for the first time
        tc = time.monotonic() if traced else 0.0
        gen = self._chunk_forward(torch.cat([toks_t[..., None], drafts], -1),
                                  slots_t, lens_t, prows, plens)
        d = drafts.cpu().numpy().astype(np.int32)             # [R, S, k]
        gen = gen.cpu().numpy().astype(np.int32)              # [R, S, k+1]
        if traced:                 # the verify, as the JAX engine's span
            _tracing.add_span(self._trace_id(), "chunk_call", tc,
                              time.monotonic(), cat="engine", S=int(S),
                              T=k + 1)
        # accept: the longest prefix where draft_i == target g_i, then the
        # bonus g_{j+1}; rejected rows past the new frontier are garbage
        # that the next round's appends overwrite before any read
        match = d == gen[:, :, :k]
        j = np.argmin(np.concatenate(
            [match, np.zeros_like(match[:, :, :1])], axis=2), axis=2)
        counts = (j + 1).astype(np.int32)
        t_idx = np.arange(k + 1)[None, None, :]
        d_pad = np.concatenate([d, np.zeros_like(d[:, :, :1])], axis=2)
        emitted = np.where(
            t_idx < j[:, :, None], d_pad,
            np.where(t_idx == j[:, :, None], gen, -1)).astype(np.int32)
        live = slots < self.scfg.slots          # trash lanes do not count
        drafted = int(live.sum()) * k
        accepted = int(j[live].sum())
        if drafted:
            _metrics.counter(
                "bluefog_serve_spec_drafted_total",
                "draft tokens proposed by speculative decoding").inc(drafted)
            _metrics.counter(
                "bluefog_serve_spec_accepted_total",
                "draft tokens accepted by the verify pass").inc(accepted)
        if traced:
            _tracing.add_span(self._trace_id(), "spec_round", t0,
                              time.monotonic(), cat="engine", S=int(S), k=k,
                              drafted=drafted, accepted=accepted)
        return emitted, counts

    def idle_lane(self) -> Tuple[int, int, int]:
        """(token, slot, len) triple a padding lane carries."""
        return 0, self.cache_cfg.trash_slot, 0

    def moe_load(self) -> Optional[list]:
        """Per-replica routing load from the most recent MoE target call
        (fused decode, or a chunk: the spec verify or a chunked prefill),
        in the JAX layout: one dict per replica with ``counts`` (``[E]``
        live token-layer top-1 counts), ``fractions``, ``entropy`` (mean
        live-token router entropy, nats) and ``tokens`` (live token-layer
        count).  ``None`` for dense engines or before the first call."""
        if not self._moe or self._route_stats is None:
            return None
        stats = self._route_stats.cpu().numpy().astype(np.float64)
        E = self.cfg.num_experts
        out = []
        for st in stats:
            cnt = st[:E]
            tot = float(cnt.sum())
            n = float(st[E + 1])
            out.append({
                "counts": cnt.copy(),
                "fractions": cnt / tot if tot else np.zeros(E),
                "entropy": float(st[E]) / n if n else 0.0,
                "tokens": n,
            })
        return out

    def update_params(self, model: Union[ComposeLM, ServingParams]) -> None:
        """Rebind the served weights (the JAX engine's refresher swap):
        ``model`` is what the engine was built from, a
        :class:`~bluefog_tpu_torch.parallel.compose.ServingParams` of the
        same carving or a module of the same config, every tensor of the
        same shape and dtype.  The caches, the buckets and every shape
        stay; the next call reads the new weights."""
        if isinstance(model, ServingParams) != (self.model is None):
            raise ValueError(
                f"update_params: the engine serves "
                f"{'a carving' if self.model is None else 'one module'}; "
                f"got {type(model).__name__}")
        new, module = _serving(model, self.pp, self.device)
        if new.cfg != self.cfg:
            raise ValueError(f"update_params: model was built for "
                             f"{new.cfg}, not {self.cfg}")
        for (name, a), (_, b) in zip(self.params.tensors(), new.tensors()):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(
                    f"update_params: {name} {tuple(b.shape)} {b.dtype} != "
                    f"the served {tuple(a.shape)} {a.dtype}")
        self.params, self._mean_ffn = new, None
        if module is not None:
            self.model = module

    def warmup(self) -> None:
        """Run every declared shape once: prefill and decode buckets, and
        when armed a speculative round (draft + verify) per decode bucket
        and a chunk per prefill bucket (on CUDA this builds the kernels
        and the library handles before traffic arrives)."""
        scfg, R = self.scfg, self.replicas
        for Tpad in scfg.prefill_buckets:
            self.prefill(0, 0, [0] * Tpad)
        tok, slot, ln = self.idle_lane()
        for S in scfg.batch_buckets:
            full = lambda v: np.full((R, S), v, np.int32)   # noqa: E731
            self.decode(full(tok), full(slot), full(ln))
            if scfg.spec_decode:
                self.spec_decode(full(tok), full(slot), full(ln))
        if scfg.prefix_pages:
            for Tpad in scfg.prefill_buckets:
                self._chunk_call(np.zeros((R, 1, Tpad), np.int32),
                                 self._trash_vec(1),
                                 np.zeros((R, 1), np.int32),
                                 self._trash_vec(1),
                                 np.zeros((R, 1), np.int32))
        _flight.record("serve", name="warmup",
                       batch_buckets=list(scfg.batch_buckets),
                       prefill_buckets=list(scfg.prefill_buckets),
                       spec_decode=scfg.spec_decode,
                       prefix_pages=scfg.prefix_pages,
                       kv_dtype=scfg.kv_dtype,
                       moe_experts=self.cfg.num_experts if self._moe else 0,
                       moe_ep=self.m.ep if self._moe else 0,
                       moe_tile=self._moe_tile if self._moe else 0)
        _metrics.mark_steady_state(True)
