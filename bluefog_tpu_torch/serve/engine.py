"""Prefill + fused decode engine on one device (counterpart of
``bluefog_tpu/serve/engine.py`` at one replica, pp = tp = 1).

Shapes are bucketed as in the JAX engine: decode batches only have the
lane counts in ``ServeConfig.batch_buckets`` (idle lanes ride the trash
slot) and prompts are padded to ``prefill_buckets``.  The host surface
keeps the JAX engine's ``[replicas, S]`` arrays with ``replicas == 1``.

Each decode call runs ``decode_steps_per_call`` tokens: embed, then per
layer LN -> qkv -> rope -> cache append (quantized for int8/fp8 stores)
-> flash-decode attention -> output projection -> FFN, then the logits
and the next token, which feeds the next step without leaving the
device.  Decode attention goes through
:func:`~bluefog_tpu_torch.ops.flash_decode.flash_attend_rows`: on a CUDA
cache that is always the hand-written kernel (``decode_kernel`` is kept
as a token for parity with the JAX env surface and selects nothing).
Prefill attention over the prompt itself is dense and full precision.

An :class:`~bluefog_tpu_torch.moe.model.MoELMConfig` model is served as
the JAX engine serves it at ep = 1: each block's FFN is the top-k router,
the dropless sort-based dispatch and the grouped expert FFN (the
hand-written kernel K4 on CUDA), with the small decode tile on the
decode path and ``group_tile`` for prefill.  Decode folds each layer's
routing of the live lanes into the ``[E + 2]`` hot-expert carrier that
:meth:`ServeEngine.moe_load` reads.

Not ported yet (each raises ``ValueError`` naming the feature):
speculative decoding, shared prefix pages and expert-parallel (ep > 1)
MoE serving.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.rope import apply_rope, apply_rope_rows
from ..moe.dropless import decode_tile
from ..moe.model import MoELMConfig
from ..ops import flash_decode as _fd
from ..ops.ulysses import dense_attention
from ..parallel.compose import ComposeLM, LMConfig
from . import kv_cache as _kv

__all__ = ["ServeConfig", "ServeEngine"]

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


def _not_ported(feature: str, knob: str) -> ValueError:
    return ValueError(f"{feature} ({knob}) is not yet ported to "
                      "bluefog_tpu_torch; serve with the JAX package or "
                      "leave the knob at 0")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static serving shapes: the JAX ``ServeConfig``'s fields and rules.

    ``spec_decode`` and ``prefix_pages`` must stay 0, and ``moe_ep`` 1,
    until their slices are ported; ``spec_stages`` and
    ``prefix_page_tokens`` are kept for parity and unused.
    ``moe_experts``/``moe_top_k`` declare an MoE model (checked against
    it by the engine) and ``moe_tile`` its decode tile (0: auto).
    ``decode_block_k`` is the kernel's KV block (clamped to
    ``max_len``), validated here because the port's decode attention
    always uses it."""
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
        _fd._block_k_for(self.max_len, self.decode_block_k)
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0 (0 = greedy)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
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
        if self.spec_decode:
            raise _not_ported("speculative decoding", "spec_decode")
        if self.prefix_pages:
            raise _not_ported("shared prefix pages", "prefix_pages")
        if self.moe_experts and self.moe_ep > 1:
            raise _not_ported("expert-parallel MoE serving", "moe_ep")

    @property
    def decode_window(self) -> int:
        """Most tokens one engine call can add to a slot."""
        return self.decode_steps_per_call

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        """The JAX env surface: ``BLUEFOG_SERVE_BUCKETS``,
        ``BLUEFOG_KV_DTYPE``, ``BLUEFOG_DECODE_KERNEL`` (``'xla'``,
        ``'pallas'`` or ``'pallas@<block_k>'``), ``BLUEFOG_SPEC_DECODE``
        and ``BLUEFOG_PREFIX_PAGES`` (refused above 0), and
        ``BLUEFOG_SERVE_MOE='<experts>[x<top_k>][@<ep>][:<tile>]'`` (ep
        above 1 refused)."""
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


class ServeEngine:
    """Prefill and fused decode of one :class:`ComposeLM` (or MoE LM)
    replica over a slotted paged KV cache on one device.

    ``model`` comes from :func:`~bluefog_tpu_torch.parallel.compose.
    init_lm_params` / :func:`~bluefog_tpu_torch.parallel.compose.
    params_from_jax`, or their MoE counterparts in
    :mod:`bluefog_tpu_torch.moe.model`; the engine moves it to ``device``
    (CUDA unless the caller passes ``device="cpu"``) and never changes its
    weights.  The cache is updated in place.
    """

    replicas = 1

    def __init__(self, cfg: LMConfig, model: ComposeLM,
                 scfg: Optional[ServeConfig] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._moe = isinstance(cfg, MoELMConfig)
        if self._moe and cfg.router_mode == "expert_choice":
            raise ValueError(
                "moe_serving_requires_topk_router: expert-choice routing "
                "selects each expert's top-C tokens over the WHOLE "
                "sequence, but autoregressive decode sees one token at a "
                "time — an EC router at serve time would condition routing "
                "on future tokens (the causality caveat that keeps it "
                "training-only).  Serve with router_mode='topk'.")
        cfg.validate()
        if model.cfg != cfg:
            raise ValueError(f"model was built for {model.cfg}, not {cfg}")
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
            # (moe_ep > 1 never gets here: ServeConfig refuses it)
            for knob, mine in (("moe_experts", cfg.num_experts),
                               ("moe_top_k", cfg.top_k)):
                declared = getattr(scfg, knob)
                if declared != mine:
                    raise ValueError(
                        f"ServeConfig.{knob}={declared} does not match the "
                        f"model/carving value {mine} — the serve-MoE knob "
                        "must agree with the MoELMConfig and the ep carve")
        if self._moe:
            # decode tile: S * k rows over the E expert groups; prefill
            # (chunk) shapes keep the training tile
            self._moe_tile = scfg.moe_tile or decode_tile(
                scfg.batch_buckets[-1] * cfg.top_k, cfg.num_experts)
            self._moe_chunk_tile = cfg.group_tile
        self._route_stats: Optional[torch.Tensor] = None
        self.cfg, self.scfg = cfg, scfg
        self.model = model.to(self.device).requires_grad_(False)
        self.cache_cfg = _kv.KVCacheConfig(
            layers=cfg.layers, slots=scfg.slots, max_len=scfg.max_len,
            kv_heads=cfg.heads, head_dim=cfg.head_dim, dtype=scfg.dtype,
            store=scfg.kv_dtype)
        self.cache = _kv.init_cache(self.cache_cfg, self.device)
        # per-row sampling generators, re-seeded at each prefill from
        # (seed, row, admission count) so a fixed seed replays a fixed run
        self._gens: Dict[int, torch.Generator] = {}
        self._seed_count = 0

    # ------------------------------------------------------------------
    # device-side math
    # ------------------------------------------------------------------

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s views of the cache (writes land in the cache)."""
        return {name: t[i] for name, t in self.cache.items()}

    def _next_token(self, logits: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
        """Greedy argmax, or temperature / top-p sampling with each lane's
        generator.  top-p keeps the smallest probability-sorted set
        covering ``top_p`` mass (always >= 1 token)."""
        scfg = self.scfg
        if scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        out = []
        for lg, row in zip(logits / scfg.temperature, rows.tolist()):
            if scfg.top_p < 1.0:
                srt = torch.sort(lg, descending=True).values
                probs = torch.softmax(srt, dim=-1)
                keep = (torch.cumsum(probs, dim=-1) - probs) < scfg.top_p
                thresh = srt[keep].min()
                lg = lg.masked_fill(lg < thresh, float("-inf"))
            out.append(torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                         generator=self._generator(row)))
        return torch.cat(out)

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
        """One layer's routing folded into the ``[E + 2]`` carrier:
        per-expert top-1 counts over live lanes, summed live-token router
        entropy, live-token count."""
        probs, idx = routing
        w = live.to(torch.float32)
        cnt = torch.zeros(self.cfg.num_experts, dtype=torch.float32,
                          device=w.device).index_add_(0, idx[:, 0], w)
        ent = (-(probs * torch.log(probs + 1e-20)).sum(-1) * w).sum()
        return torch.cat([cnt, ent[None], w.sum()[None]])

    def _layer_step(self, blk, x: torch.Tensor, cl, slot_ids: torch.Tensor,
                    lens: torch.Tensor):
        """One decoder block on one new token per lane: ``x [S, D]``;
        returns ``(x, routing)`` (``routing`` is ``None`` when dense)."""
        H, Dh = self.cfg.heads, self.cfg.head_dim
        S = x.shape[0]
        q, k, v = blk.qkv(x)
        q = apply_rope_rows(q.reshape(S, H, Dh), lens)
        k = apply_rope_rows(k.reshape(S, H, Dh), lens)
        _kv.layer_append(cl, slot_ids, lens, k, v.reshape(S, H, Dh),
                         store=self.scfg.kv_dtype)
        att = _fd.flash_attend_rows(
            q, cl["k"], cl["v"], slot_ids, lens,
            k_scale=cl.get("k_scale"), v_scale=cl.get("v_scale"),
            block_k=self.scfg.decode_block_k)
        return blk.finish(x, att.reshape(S, H * Dh),
                          self._moe_tile if self._moe else None)

    @torch.inference_mode()
    def _decode_steps(self, toks: torch.Tensor, slot_ids: torch.Tensor,
                      lens: torch.Tensor) -> torch.Tensor:
        """``decode_steps_per_call`` fused tokens: ``[steps, S]``.  On the
        MoE path the call's routing of live lanes (every step, every
        layer) becomes the hot-expert snapshot."""
        model, gen = self.model, []
        live = slot_ids < self.scfg.slots                     # [S] real lanes
        st = torch.zeros((self.cfg.num_experts + 2,), device=self.device) \
            if self._moe else None
        for _ in range(self.scfg.decode_steps_per_call):
            x = model.embed[toks]                                  # [S, D]
            for i, blk in enumerate(model.blocks):
                x, routing = self._layer_step(blk, x, self._layer(i),
                                              slot_ids, lens)
                if routing is not None:
                    st = st + self._route_vec(routing, live)
            toks = self._next_token(model.logits(x), slot_ids)
            gen.append(toks)
            lens = lens + 1
        if self._moe:
            self._route_stats = st
        return torch.stack(gen)

    @torch.inference_mode()
    def _prefill_forward(self, toks: torch.Tensor, row: int,
                         true_len: int) -> torch.Tensor:
        """Run the padded prompt ``toks [Tpad]`` into ``row``; returns the
        last real position's logits ``[V]``."""
        H, Dh = self.cfg.heads, self.cfg.head_dim
        Tpad = toks.shape[0]
        pos = torch.arange(Tpad, device=self.device)
        x = self.model.embed[toks][None]                       # [1, Tpad, D]
        for i, blk in enumerate(self.model.blocks):
            q, k, v = blk.qkv(x)
            q = apply_rope(q.reshape(1, Tpad, H, Dh), pos)
            k = apply_rope(k.reshape(1, Tpad, H, Dh), pos)
            v = v.reshape(1, Tpad, H, Dh)
            # the whole padded prompt lands in the row; attention over the
            # prompt itself is dense full precision — quantization drift
            # only enters where a stored page is read back
            _kv.layer_prefill(self._layer(i), row, k[0], v[0],
                              store=self.scfg.kv_dtype)
            att = dense_attention(q, k, v, causal=True)
            x, _ = blk.finish(x, att.reshape(1, Tpad, H * Dh),
                              self._moe_chunk_tile if self._moe else None)
        return self.model.logits(x[0, true_len - 1])

    # ------------------------------------------------------------------
    # host-side surface ([replicas, ...] arrays, replicas == 1)
    # ------------------------------------------------------------------

    def _lanes(self, arr, name: str) -> torch.Tensor:
        arr = np.asarray(arr, np.int64)
        if arr.ndim != 2 or arr.shape[0] != self.replicas:
            raise ValueError(f"{name} must be [replicas={self.replicas}, S],"
                             f" got {arr.shape}")
        return torch.as_tensor(arr[0], device=self.device)

    def prefill(self, replica: int, slot: int,
                tokens: Sequence[int]) -> Tuple[int, np.ndarray]:
        """Prefill one request into ``slot``; returns the first greedy
        token and the last-position logits ``[vocab]``."""
        if replica != 0:
            raise ValueError(f"replica {replica} out of range [0, 1)")
        if not 0 <= slot < self.scfg.slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.scfg.slots})")
        if not tokens:
            raise ValueError("empty prompt")
        Tpad = self.scfg.prefill_bucket_for(len(tokens))
        toks = np.zeros((Tpad,), np.int64)
        toks[:len(tokens)] = np.asarray(tokens, np.int64)
        logits = self._prefill_forward(
            torch.as_tensor(toks, device=self.device), slot, len(tokens))
        self._seed_row(slot)
        logits = logits.float().cpu().numpy()
        return int(np.argmax(logits)), logits

    def decode(self, tokens: np.ndarray, slots: np.ndarray,
               lens: np.ndarray, prefix_rows: Optional[np.ndarray] = None,
               prefix_lens: Optional[np.ndarray] = None) -> np.ndarray:
        """One fused decode call at one batch bucket.

        ``tokens``/``slots``/``lens``: ``[replicas, S]`` with ``S`` in
        ``batch_buckets``; idle lanes use the trash slot with ``lens=0``.
        ``lens[0, i]`` is the position the lane's pending token occupies.
        Returns ``[replicas, decode_steps_per_call, S]`` tokens."""
        if prefix_rows is not None or prefix_lens is not None:
            raise _not_ported("shared prefix pages", "prefix_rows")
        S = np.asarray(tokens).shape[1]
        if S not in self.scfg.batch_buckets:
            raise ValueError(f"batch lane count {S} is not a declared "
                             f"bucket {self.scfg.batch_buckets}")
        gen = self._decode_steps(self._lanes(tokens, "tokens"),
                                 self._lanes(slots, "slots").to(torch.int32),
                                 self._lanes(lens, "lens").to(torch.int32))
        return gen.cpu().numpy().astype(np.int32)[None]

    def idle_lane(self) -> Tuple[int, int, int]:
        """(token, slot, len) triple a padding lane carries."""
        return 0, self.cache_cfg.trash_slot, 0

    def moe_load(self) -> Optional[list]:
        """Routing load from the most recent MoE decode call, in the JAX
        layout: one dict per replica with ``counts`` (``[E]`` live
        token-layer top-1 counts), ``fractions``, ``entropy`` (mean
        live-token router entropy, nats) and ``tokens`` (live
        token-layer count).  ``None`` for dense engines or before the
        first decode call."""
        if not self._moe or self._route_stats is None:
            return None
        st = self._route_stats.cpu().numpy().astype(np.float64)
        E = self.cfg.num_experts
        cnt = st[:E]
        tot = float(cnt.sum())
        n = float(st[E + 1])
        return [{
            "counts": cnt.copy(),
            "fractions": cnt / tot if tot else np.zeros(E),
            "entropy": float(st[E]) / n if n else 0.0,
            "tokens": n,
        }]

    def warmup(self) -> None:
        """Run every declared prefill and decode bucket once (on CUDA this
        builds the flash-decode kernel and the library handles before
        traffic arrives)."""
        for Tpad in self.scfg.prefill_buckets:
            self.prefill(0, 0, [0] * Tpad)
        tok, slot, ln = self.idle_lane()
        for S in self.scfg.batch_buckets:
            full = lambda v: np.full((1, S), v, np.int32)   # noqa: E731
            self.decode(full(tok), full(slot), full(ln))
