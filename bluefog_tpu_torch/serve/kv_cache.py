"""Slotted paged KV cache (counterpart of ``bluefog_tpu/serve/kv_cache.py``).

Layout, one device::

    k, v: [layers, slots + prefix_slots + 1, kv_heads, max_len, head_dim]

Request slots come first, then ``prefix_slots`` shared prefix pages, then
the **trash slot** that padding lanes of a bucketed decode batch write
their garbage kv to.  The layout is kv-head major, so one (row, head)'s
key positions are contiguous and the flash-decode kernel
(:mod:`bluefog_tpu_torch.ops.flash_decode`) streams ``[block_k,
head_dim]`` blocks straight from device memory.

Quantized storage (``store="int8"`` / ``"fp8"``) keeps the payload plus
per-(position, head) f32 amax scales in ``k_scale`` / ``v_scale``: the
gossip wire codec's recipe at a ``head_dim`` block.

The JAX functions return new arrays; here :func:`append_rows`,
:func:`layer_append`, :func:`layer_append_chunk` and
:func:`layer_prefill` write into the cache in place (the engine owns one
cache and never needs the old one) and return it for parity.
:func:`attend_rows` / :func:`attend_chunk` are the gather-then-attend
plain versions of the flash-decode kernel.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Optional, Union

import torch

from ..device import resolve_device
from ..ops.collectives import _amax_scale

__all__ = ["KVCacheConfig", "init_cache", "append_rows", "attend_rows",
           "attend_chunk", "layer_append", "layer_append_chunk",
           "layer_prefill", "quantize_rows", "dequantize_rows",
           "store_dtype", "SlotAllocator", "KV_STORES"]

KV_STORES = ("raw", "int8", "fp8")

Cache = Dict[str, torch.Tensor]


def store_dtype(store: str, raw_dtype: torch.dtype = torch.float32
                ) -> torch.dtype:
    """Payload dtype of one cache page under ``store``."""
    if store == "raw":
        return raw_dtype
    if store == "int8":
        return torch.int8
    if store == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown KV store {store!r}: choose from {KV_STORES}")


def quantize_rows(x: torch.Tensor, store: str):
    """Quantize kv rows ``[..., head_dim]`` for page storage: returns
    ``(payload, scale)``, ``scale`` None for raw storage and ``[...]`` f32
    (one amax scale per row) otherwise.  Both casts round to nearest even,
    as the JAX ones do."""
    if store == "raw":
        return x, None
    shape = x.shape
    xf = x.to(torch.float32).reshape(-1, shape[-1])
    if store == "int8":
        scaled, scale = _amax_scale(xf, 127.0, shape[-1])
        q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    elif store == "fp8":
        f8max = float(torch.finfo(torch.float8_e4m3fn).max)       # 448
        scaled, scale = _amax_scale(xf, f8max, shape[-1])
        q = scaled.to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"unknown KV store {store!r}: choose from "
                         f"{KV_STORES}")
    return q.reshape(shape), scale.reshape(shape[:-1])


def dequantize_rows(q: torch.Tensor, scale: Optional[torch.Tensor],
                    dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (identity cast for raw storage)."""
    if scale is None:
        return q.to(dtype)
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Static shape of one device's cache."""
    layers: int
    slots: int
    max_len: int
    kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.float32   # raw payload dtype
    store: str = "raw"                   # "raw" | "int8" | "fp8"
    prefix_slots: int = 0

    def __post_init__(self):
        for name in ("layers", "slots", "max_len", "kv_heads", "head_dim"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"KVCacheConfig.{name}={v!r} must be a "
                                 "positive int")
        if not isinstance(self.prefix_slots, int) or self.prefix_slots < 0:
            raise ValueError(f"KVCacheConfig.prefix_slots="
                             f"{self.prefix_slots!r} must be an int >= 0")
        store_dtype(self.store)

    @property
    def rows(self) -> int:
        """Physical rows: request slots + prefix pages + the trash slot."""
        return self.slots + self.prefix_slots + 1

    @property
    def trash_slot(self) -> int:
        return self.slots + self.prefix_slots

    @property
    def quantized(self) -> bool:
        return self.store != "raw"


def init_cache(cfg: KVCacheConfig,
               device: Optional[Union[str, torch.device]] = None) -> Cache:
    """Zeroed cache: ``k``/``v`` payload pages, plus ``k_scale`` /
    ``v_scale`` when quantized.  On CUDA unless ``device`` says otherwise
    (:func:`~bluefog_tpu_torch.device.resolve_device`)."""
    device = resolve_device(device)
    shape = (cfg.layers, cfg.rows, cfg.kv_heads, cfg.max_len, cfg.head_dim)
    dt = store_dtype(cfg.store, cfg.dtype)
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.quantized:
        cache["k_scale"] = torch.zeros(shape[:-1], device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], device=device)
    return cache


# ---------------------------------------------------------------------------
# Page math on one layer's slice of the cache
# ---------------------------------------------------------------------------

def append_rows(kl: torch.Tensor, vl: torch.Tensor, slots: torch.Tensor,
                lengths: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor):
    """Write one new token's kv per lane in place: ``kl/vl`` are one
    layer's pages ``[rows, kv_heads, max_len, head_dim]``, the token of
    lane i lands at position ``lengths[i]`` of row ``slots[i]``;
    ``k_new/v_new`` are ``[S, kv_heads, head_dim]``.

    Padding lanes all point at the trash row, so the indices may repeat.
    Which duplicate write wins is then unspecified (on CUDA it varies from
    run to run); that is harmless only because nothing reads the trash
    row."""
    kl[slots, :, lengths] = k_new.to(kl.dtype)
    vl[slots, :, lengths] = v_new.to(vl.dtype)
    return kl, vl


def layer_append(cl: Cache, slots: torch.Tensor, lengths: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 store: str = "raw") -> Cache:
    """One decode token per lane into one layer's cache, quantizing on
    the way in when the store calls for it."""
    qk, sk = quantize_rows(k_new, store)
    qv, sv = quantize_rows(v_new, store)
    append_rows(cl["k"], cl["v"], slots, lengths, qk, qv)
    if sk is not None:
        # duplicate trash-row indices as in append_rows
        cl["k_scale"][slots, :, lengths] = sk
        cl["v_scale"][slots, :, lengths] = sv
    return cl


def layer_append_chunk(cl: Cache, slots: torch.Tensor,
                       lengths: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, store: str = "raw") -> Cache:
    """A T-token chunk per lane: ``k_new/v_new`` are ``[S, T, kv_heads,
    head_dim]`` and token t of lane i lands at ``lengths[i] + t`` of
    ``slots[i]``."""
    T = k_new.shape[1]
    rows = slots[:, None]
    pos = lengths[:, None] + torch.arange(T, device=lengths.device)[None]
    qk, sk = quantize_rows(k_new, store)
    qv, sv = quantize_rows(v_new, store)
    # duplicate trash-row indices as in append_rows
    cl["k"][rows, :, pos] = qk.to(cl["k"].dtype)
    cl["v"][rows, :, pos] = qv.to(cl["v"].dtype)
    if sk is not None:
        cl["k_scale"][rows, :, pos] = sk
        cl["v_scale"][rows, :, pos] = sv
    return cl


def layer_prefill(cl: Cache, slot_id: int, k: torch.Tensor, v: torch.Tensor,
                  store: str = "raw") -> Cache:
    """Land a padded prompt's kv (``[Tpad, kv_heads, head_dim]``) at
    positions ``0 .. Tpad-1`` of row ``slot_id``.  Positions past the true
    length hold garbage that the length masks never read before an append
    overwrites them."""
    Tpad = k.shape[0]
    qk, sk = quantize_rows(k, store)
    qv, sv = quantize_rows(v, store)
    cl["k"][slot_id, :, :Tpad] = qk.transpose(0, 1).to(cl["k"].dtype)
    cl["v"][slot_id, :, :Tpad] = qv.transpose(0, 1).to(cl["v"].dtype)
    if sk is not None:
        cl["k_scale"][slot_id, :, :Tpad] = sk.T
        cl["v_scale"][slot_id, :, :Tpad] = sv.T
    return cl


def _gather_pages(cl: Cache, slots: torch.Tensor,
                  prefix_slots: Optional[torch.Tensor],
                  prefix_lens: Optional[torch.Tensor]):
    """Each lane's kv rows through the page indirection (positions below
    ``prefix_lens[i]`` from the lane's prefix page), dequantized to f32:
    ``(ks, vs)`` of shape ``[S, Hkv, max_len, Dh]``."""
    ks, vs = cl["k"][slots], cl["v"][slots]
    ksc = cl["k_scale"][slots] if "k_scale" in cl else None
    vsc = cl["v_scale"][slots] if "v_scale" in cl else None
    if prefix_slots is not None:
        L = cl["k"].shape[2]
        shared = (torch.arange(L, device=slots.device)[None, :]
                  < prefix_lens[:, None])                        # [S, L]
        sel = shared[:, None, :, None]
        ks = torch.where(sel, cl["k"][prefix_slots], ks)
        vs = torch.where(sel, cl["v"][prefix_slots], vs)
        if ksc is not None:
            ksc = torch.where(shared[:, None, :],
                              cl["k_scale"][prefix_slots], ksc)
            vsc = torch.where(shared[:, None, :],
                              cl["v_scale"][prefix_slots], vsc)
    return (dequantize_rows(ks, ksc, torch.float32),
            dequantize_rows(vs, vsc, torch.float32))


def attend_rows(q: torch.Tensor, kl: torch.Tensor, vl: torch.Tensor,
                slots: torch.Tensor, lengths: torch.Tensor,
                scale: Optional[float] = None, *,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None,
                prefix_slots: Optional[torch.Tensor] = None,
                prefix_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked decode attention of one new token per lane over its slot:
    ``q [S, heads, head_dim]``, keys ``0 .. lengths[i]`` inclusive valid.
    q head ``h`` attends kv head ``h // group``.  f32-floor scores, scale
    folded into q, ``-inf`` masking."""
    S, H, Dh = q.shape
    Hkv = kl.shape[1]
    if H % Hkv:
        raise ValueError(f"{H} q heads not a multiple of {Hkv} kv heads")
    if scale is None:
        scale = Dh ** -0.5
    cl = {"k": kl, "v": vl}
    if k_scale is not None:
        cl["k_scale"], cl["v_scale"] = k_scale, v_scale
    ks, vs = _gather_pages(cl, slots, prefix_slots, prefix_lens)
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = (q.to(ct) * scale).reshape(S, Hkv, H // Hkv, Dh)
    s = torch.einsum("skgd,skld->skgl", qg, ks.to(ct))
    valid = (torch.arange(kl.shape[2], device=q.device)[None, :]
             <= lengths[:, None])                                 # [S, L]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("skgl,skld->skgd", p, vs.to(ct))
    return out.reshape(S, H, Dh).to(q.dtype)


def attend_chunk(q: torch.Tensor, cl: Cache, slots: torch.Tensor,
                 lengths: torch.Tensor, scale: Optional[float] = None, *,
                 prefix_slots: Optional[torch.Tensor] = None,
                 prefix_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunked causal attention: ``q [S, T, heads, head_dim]``, query t of
    lane i at position ``lengths[i] + t`` attends rows ``0 .. lengths[i] +
    t`` of its slot (prefix pages and quantized pages as in
    :func:`attend_rows`)."""
    S, T, H, Dh = q.shape
    Hkv = cl["k"].shape[1]
    if H % Hkv:
        raise ValueError(f"{H} q heads not a multiple of {Hkv} kv heads")
    if scale is None:
        scale = Dh ** -0.5
    ks, vs = _gather_pages(cl, slots, prefix_slots, prefix_lens)
    L = cl["k"].shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = (q.to(ct) * scale).reshape(S, T, Hkv, H // Hkv, Dh)
    s = torch.einsum("stkgd,skld->stkgl", qg, ks.to(ct))
    qpos = lengths[:, None] + torch.arange(T, device=q.device)[None, :]
    valid = (torch.arange(L, device=q.device)[None, None, :]
             <= qpos[:, :, None])                                 # [S, T, L]
    s = s.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("stkgl,skld->stkgd", p, vs.to(ct))
    return out.reshape(S, T, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Host-side bookkeeping
# ---------------------------------------------------------------------------

class SlotAllocator:
    """Host-side free heap over one replica's request slots: lowest free
    slot first, O(log slots) alloc and free.  A recycled slot is
    overwritten by the next prefill and masked by its new length, so the
    cache rows are never zeroed."""

    def __init__(self, slots: int, *, replica: int = 0):
        if slots < 1:
            raise ValueError(f"need >= 1 slot, got {slots}")
        self.slots = int(slots)
        self.replica = int(replica)
        self._free = list(range(self.slots))     # already a valid min-heap
        self._in_use: set = set()

    def alloc(self) -> Optional[int]:
        """Lowest free slot id, or None when the replica is full."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._in_use.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")
        self._in_use.discard(slot)
        heapq.heappush(self._free, slot)

    @property
    def in_use(self) -> int:
        return len(self._in_use)

    @property
    def occupancy(self) -> float:
        return len(self._in_use) / self.slots
