"""Paged flash-decode attention (counterpart of
``bluefog_tpu/ops/pallas_decode.py``).

:func:`flash_attend_rows` and :func:`flash_attend_chunk` take the same
arguments as the JAX entry points.  On CUDA tensors they launch the
hand-written Hopper kernel in ``csrc/flash_decode.cu`` (see its header
for the design and what bounds it); on CPU tensors they run the plain
version, :func:`~bluefog_tpu_torch.serve.kv_cache.attend_rows` /
``attend_chunk`` (gather the pages, then attend).  A CUDA tensor never
takes the plain version: the kernel launches or the call raises.

The kernel splits each lane's keys across CTAs (flash-decoding): the
host-side plan :func:`split_plan` picks the number of splits from the
batch, the kv heads, the query-row tiles and the page length alone, and
a second small launch merges the splits' partials.  A call takes any
number of query rows ``T * G``: they run as tiles of ``ROW_TILE`` rows
in the same launch (:func:`row_tiles`).  Nothing on this path reads a
device value back to the host.

The kernel takes every head dim from 1 to 256 at run time, inside a
built bucket of 32, 64, 128 or 256 (:func:`head_dim_bucket`): the pages
keep their own width, nothing is padded or copied.  Tile rows arrive by
16-byte ``cp.async`` when a row is whole 16-byte chunks (head_dim % 4
for f32 pages, % 8 for bf16, % 16 for int8 / e4m3), else value by value
with plain loads (every odd head dim).

``flash_decode_cuda.launches`` counts calls that launched the kernel (one
per call, whether or not it needed the merge launch), so a run can show
that its decode attention went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..serve import kv_cache as _kv
from . import _build

__all__ = ["flash_attend_rows", "flash_attend_chunk", "flash_decode_cuda",
           "split_plan", "row_tiles", "head_dim_bucket", "build"]

_LIB = "flash_decode"
_SOURCES = ("flash_decode.cu",)
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.float8_e4m3fn: 3}
_BUCKETS = (32, 64, 128, 256)   # built head dims; dr <= bucket runs inside
MAX_HEAD_DIM = 256
_MAX_SMEM = 232448          # bytes of shared memory one H100 CTA may use
ROW_TILE = 64               # query rows of one CTA (16 row groups x 4)
SMS = 132                   # streaming multiprocessors of an H100
CTAS_PER_SM = 4             # the split plan's target
MIN_CHUNK = 32              # keys: the finest split


def build() -> ctypes.CDLL:
    """Compile (at the first call in a checkout) and load the kernel."""
    lib = _build.load_library(_LIB, _SOURCES)
    fn = lib.bf_flash_decode
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.bf_flash_decode_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.bf_flash_decode_smem_bytes.restype = ctypes.c_size_t
    return lib


def row_tiles(TG: int) -> int:
    """Tiles of at most ``ROW_TILE`` query rows that ``TG = T * G`` rows
    of one (lane, kv head) take."""
    return -(-TG // ROW_TILE)


def split_plan(S: int, Hkv: int, L: int, tiles: int = 1) -> Tuple[int, int]:
    """``(splits, chunk)``: how many CTAs share each (lane, kv head, row
    tile) and the keys each covers (a multiple of ``MIN_CHUNK``; ``splits
    * chunk >= L``).  Enough splits for ``CTAS_PER_SM`` CTAs on each SM
    over the ``S * Hkv * tiles`` (lane, kv head, row tile) triples, but no
    more than ``L`` has ``MIN_CHUNK``-key chunks.  Host integers only: the
    plan never looks at ``lengths`` (a CTA whose keys lie past what its
    rows see exits at once)."""
    want = -(-CTAS_PER_SM * SMS // (S * Hkv * tiles))
    splits = max(1, min(want, -(-L // MIN_CHUNK)))
    chunk = -(-L // splits)
    chunk = -(-chunk // MIN_CHUNK) * MIN_CHUNK
    return -(-L // chunk), chunk


def head_dim_bucket(Dh: int) -> int:
    """The built head dim a head dim ``Dh`` runs inside (every ``Dh``
    from 1 up to 256; anything else raises)."""
    if not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(
            f"flash decode head_dim {Dh}: the kernel takes head dims from 1 "
            f"up to {MAX_HEAD_DIM} (built in buckets {_BUCKETS})")
    return next(b for b in _BUCKETS if Dh <= b)


def _block_k_for(L: int, block_k: int) -> int:
    """Clamp ``block_k`` to the page length and validate divisibility
    (the JAX contract and error text, so ``ServeConfig`` validation
    matches)."""
    bk = min(int(block_k), L)
    if bk < 1 or L % bk:
        raise ValueError(
            f"flash decode block_k={block_k} does not tile max_len={L}: "
            f"need block_k >= 1 with max_len % min(block_k, max_len) == 0")
    if bk % 8 and bk != L:
        raise ValueError(
            f"flash decode block_k={block_k}: KV blocks are TPU sublane "
            f"tiles — use a multiple of 8 (or one covering max_len={L})")
    return bk


def _common_checks(H: int, Dh: int, cl: Dict[str, torch.Tensor],
                   slots: torch.Tensor, lengths: torch.Tensor,
                   prefix_slots, prefix_lens) -> None:
    if cl["k"].ndim != 4 or cl["v"].shape != cl["k"].shape:
        raise ValueError(
            f"flash decode wants one layer's pages [rows, kv_heads, "
            f"max_len, head_dim]; got k {tuple(cl['k'].shape)} "
            f"v {tuple(cl['v'].shape)}")
    Hkv = cl["k"].shape[1]
    if H % Hkv:
        raise ValueError(f"{H} q heads not a multiple of {Hkv} kv heads")
    if cl["k"].shape[-1] != Dh:
        raise ValueError(f"q head_dim {Dh} != page head_dim "
                         f"{cl['k'].shape[-1]}")
    if slots.shape != lengths.shape or slots.ndim != 1:
        raise ValueError(f"slots/lengths must be [S] int32, got "
                         f"{tuple(slots.shape)} / {tuple(lengths.shape)}")
    if (prefix_slots is None) != (prefix_lens is None):
        raise ValueError("prefix_slots and prefix_lens come together")
    if ("k_scale" in cl) != ("v_scale" in cl):
        raise ValueError("k_scale and v_scale come together")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _index(t: Optional[torch.Tensor], S: int, dev: torch.device,
           name: str) -> Optional[torch.Tensor]:
    if t is None:
        return None
    if t.device != dev or t.shape != (S,):
        raise ValueError(f"{name} must be [S={S}] on {dev}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.to(torch.int32).contiguous()


def flash_decode_cuda(q4: torch.Tensor, cl: Dict[str, torch.Tensor],
                      slots: torch.Tensor, lengths: torch.Tensor,
                      scale: float, prefix_slots: Optional[torch.Tensor],
                      prefix_lens: Optional[torch.Tensor],
                      block_k: int) -> torch.Tensor:
    """Launch the kernel on ``q4 [S, T, H, Dh]`` over one layer's pages;
    returns ``[S, T, H, Dh]`` in q's dtype.  Raises on anything the kernel
    does not take."""
    dev = q4.device
    if dev.type != "cuda":
        raise RuntimeError(f"flash_decode_cuda needs CUDA tensors, got {dev}")
    S, T, H, Dh = q4.shape
    k, v = cl["k"], cl["v"]
    Hkv, L = k.shape[1], k.shape[2]
    bk = _block_k_for(L, block_k)
    if q4.dtype not in _Q_DTYPES:
        raise TypeError(f"flash decode q dtype {q4.dtype}: expected one of "
                        f"{list(_Q_DTYPES)}")
    if k.dtype not in _PAGE_DTYPES or v.dtype != k.dtype:
        raise TypeError(f"flash decode page dtypes {k.dtype}/{v.dtype}: "
                        f"expected one of {list(_PAGE_DTYPES)}")
    DH = head_dim_bucket(Dh)
    ksc, vsc = cl.get("k_scale"), cl.get("v_scale")
    quantized = k.dtype in (torch.int8, torch.float8_e4m3fn)
    if quantized != (ksc is not None):
        raise ValueError("int8/fp8 pages need k_scale/v_scale, and only "
                         "they take scales")
    tensors = [q4, k, v] + ([ksc, vsc] if quantized else [])
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"flash decode operands must be contiguous on "
                             f"{dev}; got one on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    if quantized and (ksc.dtype != torch.float32 or ksc.shape != k.shape[:3]
                      or vsc.shape != ksc.shape or vsc.dtype != ksc.dtype):
        raise ValueError(f"scales must be f32 {tuple(k.shape[:3])}, got "
                         f"{tuple(ksc.shape)} {ksc.dtype} / "
                         f"{tuple(vsc.shape)} {vsc.dtype}")
    TG = T * (H // Hkv)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash decode pages must be 16-byte aligned (they "
                         "are copied 16 bytes at a time)")
    lib = build()
    smem = lib.bf_flash_decode_smem_bytes(TG, Dh, _PAGE_DTYPES[k.dtype])
    if smem > _MAX_SMEM:
        raise ValueError(f"flash decode tile of T*G={min(TG, ROW_TILE)} "
                         f"rows at head_dim "
                         f"{Dh} needs {smem} bytes of shared memory "
                         f"(> {_MAX_SMEM})")
    slots = _index(slots, S, dev, "slots")
    lengths = _index(lengths, S, dev, "lengths")
    prefix_slots = _index(prefix_slots, S, dev, "prefix_slots")
    prefix_lens = _index(prefix_lens, S, dev, "prefix_lens")
    splits, chunk = split_plan(S, Hkv, L, row_tiles(TG))
    out = torch.empty_like(q4)
    # the splits' partials: o [S, Hkv, splits, T*G, DH], then m and l
    part = (torch.empty(S * Hkv * splits * TG * (DH + 2),
                        dtype=torch.float32, device=dev)
            if splits > 1 else None)
    err = lib.bf_flash_decode(
        _ptr(q4), _ptr(k), _ptr(v), _ptr(ksc), _ptr(vsc), _ptr(slots),
        _ptr(lengths), _ptr(prefix_slots), _ptr(prefix_lens), _ptr(out),
        _ptr(part), S, T, H, Hkv, L, Dh, bk, chunk, splits, float(scale),
        _Q_DTYPES[q4.dtype], _PAGE_DTYPES[k.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash decode kernel launch failed: CUDA error "
                           f"{err} (S={S} T={T} H={H} Hkv={Hkv} L={L} "
                           f"Dh={Dh} bk={bk} splits={splits})")
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0


def _flash_attend(q4, cl, slots, lengths, scale, prefix_slots, prefix_lens,
                  block_k) -> torch.Tensor:
    if q4.device.type == "cuda":
        return flash_decode_cuda(q4, cl, slots, lengths, scale,
                                 prefix_slots, prefix_lens, block_k)
    if q4.device.type != "cpu":
        raise RuntimeError(f"flash decode runs on CUDA or the CPU, not "
                           f"{q4.device}")
    _block_k_for(cl["k"].shape[2], block_k)
    return _kv.attend_chunk(q4, cl, slots, lengths, scale,
                            prefix_slots=prefix_slots,
                            prefix_lens=prefix_lens)


def flash_attend_rows(q: torch.Tensor, kl: torch.Tensor, vl: torch.Tensor,
                      slots: torch.Tensor, lengths: torch.Tensor,
                      scale: Optional[float] = None, *,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      prefix_slots: Optional[torch.Tensor] = None,
                      prefix_lens: Optional[torch.Tensor] = None,
                      block_k: int = 128) -> torch.Tensor:
    """Flash-decode drop-in for ``attend_rows``: one new token per lane
    (``q [S, heads, head_dim]``) over its slot's keys ``0 .. lengths[i]``
    inclusive, through the prefix-page indirection, dequantizing int8/fp8
    pages in the kernel."""
    S, H, Dh = q.shape
    cl = {"k": kl, "v": vl}
    if k_scale is not None:
        cl["k_scale"] = k_scale
    if v_scale is not None:
        cl["v_scale"] = v_scale
    _common_checks(H, Dh, cl, slots, lengths, prefix_slots, prefix_lens)
    if scale is None:
        scale = Dh ** -0.5
    out = _flash_attend(q[:, None], cl, slots, lengths, float(scale),
                        prefix_slots, prefix_lens, block_k)
    return out[:, 0]


def flash_attend_chunk(q: torch.Tensor, cl: Dict[str, torch.Tensor],
                       slots: torch.Tensor, lengths: torch.Tensor,
                       scale: Optional[float] = None, *,
                       prefix_slots: Optional[torch.Tensor] = None,
                       prefix_lens: Optional[torch.Tensor] = None,
                       block_k: int = 128) -> torch.Tensor:
    """Flash-decode drop-in for ``attend_chunk``: query t of lane i sits at
    position ``lengths[i] + t`` and attends keys ``0 .. lengths[i] + t``;
    the T queries fold into the q rows with the GQA group (row ``t * G +
    g``), any number of them, in tiles of ``ROW_TILE``."""
    S, T, H, Dh = q.shape
    _common_checks(H, Dh, cl, slots, lengths, prefix_slots, prefix_lens)
    if scale is None:
        scale = Dh ** -0.5
    return _flash_attend(q, cl, slots, lengths, float(scale), prefix_slots,
                         prefix_lens, block_k)
