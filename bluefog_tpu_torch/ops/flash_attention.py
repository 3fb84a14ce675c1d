"""Blockwise flash-attention partials and their backward (counterpart of
``bluefog_tpu/ops/pallas_attention.py``).

:func:`attention_block_partial` (K1) and :func:`attention_block_backward`
(K2) take the JAX entry points' arguments and return the same tensors.
On CUDA tensors they launch the hand-written Hopper kernels in
``csrc/flash_attention.cu`` (``flash_fwd``; ``flash_bwd_dkdv`` then
``flash_bwd_dq``; see the source's header for the design and what bounds
it).  On CPU tensors they run the plain versions,
:func:`attention_block_partial_plain` / :func:`attention_block_backward_plain`
(dense einsums over the whole ``Tk``).  A CUDA tensor never takes the
plain version: the kernel launches or the call raises.

``fwd_launches`` and ``bwd_launches`` count kernel launches (one per
forward call; one per backward call, which runs the dkdv and dq kernels),
so a run can show that its attention went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build

__all__ = ["NEG_INF", "attention_block_partial", "attention_block_backward",
           "attention_block_partial_plain", "attention_block_backward_plain",
           "merge_partials", "flash_fwd_cuda", "flash_bwd_cuda", "build"]

NEG_INF = -1e30  # large-negative stand-in: keeps exp() exact zeros without nan

_LIB = "flash_attention"
_SOURCES = ("flash_attention.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

fwd_launches = 0
bwd_launches = 0

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def build() -> ctypes.CDLL:
    """Compile (at the first call in a checkout) and load the kernels."""
    lib = _build.load_library(_LIB, _SOURCES)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bf_flash_fwd.argtypes = ([ptr] * 6 + [i32] * 6 + [ctypes.c_float]
                                 + [i32] * 5 + [ptr])
    lib.bf_flash_fwd.restype = i32
    lib.bf_flash_bwd.argtypes = ([ptr] * 9 + [i32] * 6 + [ctypes.c_float]
                                 + [i32] * 5 + [ptr])
    lib.bf_flash_bwd.restype = i32
    return lib


def _check_heads(H: int, Hkv: int) -> None:
    if H % Hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")


def _check_block_q(block_q: int) -> None:
    # the TPU kernel pads Tq up to a multiple of min(block_q, Tq); the
    # padding never reaches the result, so only the argument is checked
    if not isinstance(block_q, (int, np.integer)) or block_q < 1:
        raise ValueError(f"block_q={block_q!r} must be a positive int")


def _keep(Tq: int, Tk: int, q_offset: int, k_offset: int, window: int,
          device) -> torch.Tensor:
    """``[Tq, Tk]`` causal (and sliding-window) visibility from the global
    offsets."""
    q_pos = q_offset + torch.arange(Tq, device=device)
    k_pos = k_offset + torch.arange(Tk, device=device)
    d = q_pos[:, None] - k_pos[None, :]
    keep = d >= 0
    if window:
        keep = keep & (d < window)
    return keep


def _expand_kv(x: torch.Tensor, G: int) -> torch.Tensor:
    """GQA: kv head ``h // G`` serves q head ``h``."""
    x = x.float()
    return x.repeat_interleave(G, dim=2) if G > 1 else x


def attention_block_partial_plain(q, k, v, q_offset=0, k_offset=0, *,
                                  causal: bool = False, scale: float = 1.0,
                                  block_q: int = 512, window: int = 0
                                  ) -> Tensors3:
    """Plain version of K1: one K/V block's flash partial over the whole
    ``Tk`` with dense einsums.  Returns ``(o [B,Tq,H,D], l [B,Tq,H],
    m [B,Tq,H])`` in f32, relative to the row max ``m`` (rows with no
    visible key: ``m = -inf, l = 0, o = 0``)."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    _check_heads(H, Hkv)
    _check_block_q(block_q)
    G = H // Hkv
    s = torch.einsum("bihd,bjhd->bihj", q.float() * scale, _expand_kv(k, G))
    if causal:
        keep = _keep(Tq, Tk, int(q_offset), int(k_offset), window, q.device)
        s = s.masked_fill(~keep[None, :, None, :], NEG_INF)
    m = s.amax(dim=-1)
    safe_m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - safe_m[..., None])
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bihj,bjhd->bihd", p, _expand_kv(v, G))
    m = m.masked_fill(m <= NEG_INF / 2, float("-inf"))
    return o, l, m


def attention_block_backward_plain(q, k, v, do, lse, delta, q_offset=0,
                                   k_offset=0, *, causal: bool = False,
                                   scale: float = 1.0, block_q: int = 512,
                                   window: int = 0) -> Tensors3:
    """Plain version of K2: the FlashAttention-2 backward of one K/V block
    given the global ``lse`` and ``delta``; ``(dq, dk, dv)`` in f32, with
    dk/dv summed over the q heads of each GQA group."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    _check_heads(H, Hkv)
    _check_block_q(block_q)
    G = H // Hkv
    qf, kf, vf = q.float(), _expand_kv(k, G), _expand_kv(v, G)
    do, lse, delta = do.float(), lse.float(), delta.float()
    s = torch.einsum("bihd,bjhd->bihj", qf, kf) * scale
    if causal:
        keep = _keep(Tq, Tk, int(q_offset), int(k_offset), window, q.device)
        s = s.masked_fill(~keep[None, :, None, :], NEG_INF)
    neg = torch.isneginf(lse)
    safe = torch.where(neg, torch.zeros_like(lse), lse)
    p = torch.exp(s - safe[..., None])
    p = p.masked_fill((s <= NEG_INF / 2) | neg[..., None], 0.0)
    dv = torch.einsum("bihj,bihd->bjhd", p, do)
    dp = torch.einsum("bihd,bjhd->bihj", do, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bihj,bjhd->bihd", ds, kf) * scale
    dk = torch.einsum("bihj,bihd->bjhd", ds, qf) * scale
    if G > 1:
        dk = dk.reshape(B, Tk, Hkv, G, D).sum(dim=3)
        dv = dv.reshape(B, Tk, Hkv, G, D).sum(dim=3)
    return dq, dk, dv


def _check_cuda(name: str, D: int, dtype: torch.dtype,
                *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name} needs CUDA tensors, got {dev}")
    if dtype not in _DTYPES:
        raise TypeError(f"{name} dtype {dtype}: expected one of "
                        f"{list(_DTYPES)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name} head_dim {D}: the kernel is built for "
                         f"{_HEAD_DIMS}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous on {dev}; "
                             f"got one on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    return dev


def _shapes(q, k, v) -> Tuple[int, int, int, int, int, int]:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention wants q [B, Tq, H, D] and k/v "
                         f"[B, Tk, Hkv, D]; got q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    B, Tq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head_dim")
    _check_heads(H, k.shape[2])
    return B, Tq, k.shape[1], H, k.shape[2], D


def flash_fwd_cuda(q, k, v, q_offset: int, k_offset: int, *, causal: bool,
                   scale: float, window: int = 0) -> Tensors3:
    """Launch ``flash_fwd`` on CUDA tensors: ``(o, l, m)`` in f32."""
    global fwd_launches
    B, Tq, Tk, H, Hkv, D = _shapes(q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd needs one dtype for q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    dev = _check_cuda("flash_fwd", D, q.dtype, q, k, v)
    lib = build()
    o = torch.empty(B, Tq, H, D, dtype=torch.float32, device=dev)
    l = torch.empty(B, Tq, H, dtype=torch.float32, device=dev)
    m = torch.empty(B, Tq, H, dtype=torch.float32, device=dev)
    err = lib.bf_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(),
        m.data_ptr(), B, Tq, Tk, H, Hkv, D, float(scale), int(causal),
        int(window), int(q_offset), int(k_offset), _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err} "
                           f"(B={B} Tq={Tq} Tk={Tk} H={H} Hkv={Hkv} D={D})")
    fwd_launches += 1
    return o, l, m


def flash_bwd_cuda(q, k, v, do, lse, delta, q_offset: int, k_offset: int,
                   *, causal: bool, scale: float, window: int = 0
                   ) -> Tensors3:
    """Launch ``flash_bwd_dkdv`` and ``flash_bwd_dq`` on CUDA tensors:
    ``(dq, dk, dv)`` in f32."""
    global bwd_launches
    B, Tq, Tk, H, Hkv, D = _shapes(q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_bwd needs one dtype for q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    do = do.float().contiguous()
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    if do.shape != q.shape or lse.shape != q.shape[:3] or \
            delta.shape != q.shape[:3]:
        raise ValueError(f"do {tuple(do.shape)} / lse {tuple(lse.shape)} / "
                         f"delta {tuple(delta.shape)} do not match q "
                         f"{tuple(q.shape)}")
    dev = _check_cuda("flash_bwd", D, q.dtype, q, k, v, do, lse, delta)
    lib = build()
    dq = torch.empty(B, Tq, H, D, dtype=torch.float32, device=dev)
    dk = torch.empty(B, Tk, Hkv, D, dtype=torch.float32, device=dev)
    dv = torch.empty(B, Tk, Hkv, D, dtype=torch.float32, device=dev)
    err = lib.bf_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, Tq, Tk, H, Hkv, D, float(scale), int(causal),
        int(window), int(q_offset), int(k_offset), _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {err} "
                           f"(B={B} Tq={Tq} Tk={Tk} H={H} Hkv={Hkv} D={D})")
    bwd_launches += 1
    return dq, dk, dv


def _device_type(q: torch.Tensor) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"flash attention runs on CUDA or the CPU, not "
                           f"{q.device}")
    return q.device.type


def attention_block_partial(q, k, v, q_offset=0, k_offset=0, *,
                            causal: bool = False, scale: float = 1.0,
                            block_q: int = 512, window: int = 0
                            ) -> Tensors3:
    """One K/V block's flash-attention partial (K1).  ``q [B,Tq,H,D]``,
    ``k``/``v`` ``[B,Tk,Hkv,D]`` (Hkv divides H); ``window > 0`` (with
    ``causal``) masks keys more than ``window - 1`` tokens behind the
    query.  Returns ``(o [B,Tq,H,D], l [B,Tq,H], m [B,Tq,H])`` in f32,
    relative to the row max ``m`` (no visible key: ``m = -inf, l = 0,
    o = 0``).  ``block_q`` is checked as the JAX function checks it; it
    does not set the kernel's tile."""
    _check_heads(q.shape[2], k.shape[2])
    _check_block_q(block_q)
    if _device_type(q) == "cuda":
        return flash_fwd_cuda(q, k, v, int(q_offset), int(k_offset),
                              causal=causal, scale=scale, window=window)
    return attention_block_partial_plain(
        q, k, v, q_offset, k_offset, causal=causal, scale=scale,
        block_q=block_q, window=window)


def attention_block_backward(q, k, v, do, lse, delta, q_offset=0,
                             k_offset=0, *, causal: bool = False,
                             scale: float = 1.0, block_q: int = 512,
                             window: int = 0) -> Tensors3:
    """One K/V block's backward partial (K2): ``(dq, dk_blk, dv_blk)`` in
    f32.  ``dq`` is this block's contribution to the query gradient;
    ``dk_blk``/``dv_blk`` are complete for this block with respect to
    these queries (summed over each GQA group's q heads)."""
    _check_heads(q.shape[2], k.shape[2])
    _check_block_q(block_q)
    if _device_type(q) == "cuda":
        return flash_bwd_cuda(q, k, v, do, lse, delta, int(q_offset),
                              int(k_offset), causal=causal, scale=scale,
                              window=window)
    return attention_block_backward_plain(
        q, k, v, do, lse, delta, q_offset, k_offset, causal=causal,
        scale=scale, block_q=block_q, window=window)


def merge_partials(carry: Tensors3, partial: Tensors3) -> Tensors3:
    """Fold one block partial into the running ``(o, l, m)`` flash state."""
    o, l, m = carry
    o_b, l_b, m_b = partial
    m_new = torch.maximum(m, m_b)
    zero = torch.zeros_like(m_new)
    safe = torch.where(torch.isneginf(m_new), zero, m_new)
    c_old = torch.where(torch.isneginf(m), zero, torch.exp(m - safe))
    c_new = torch.where(torch.isneginf(m_b), zero, torch.exp(m_b - safe))
    l = l * c_old + l_b * c_new
    o = o * c_old[..., None] + o_b * c_new[..., None]
    return o, l, m_new
