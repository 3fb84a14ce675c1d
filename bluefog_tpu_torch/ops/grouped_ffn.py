"""Grouped expert FFN for dropless MoE (counterpart of
``bluefog_tpu/ops/pallas_moe.py``).

:func:`grouped_ffn` takes the JAX ``grouped_ffn_pallas`` arguments:
``xt [G, tile, D]`` expert-grouped rows, ``tile_eid [G]`` the expert of
each tile, ``w1 [E, D, F]`` and ``w2 [E, F, D]``, and returns
``gelu_tanh(xt[g] @ w1[eid[g]]) @ w2[eid[g]]`` per tile as ``[G, tile,
D]`` in xt's dtype, computed in f32.  On CUDA tensors it launches the
hand-written Hopper kernel in ``csrc/grouped_ffn.cu`` (see its header for
the design and what bounds it); on CPU tensors it runs
:func:`grouped_ffn_plain`.  A CUDA tensor never takes the plain version:
the kernel launches or the call raises.

``grouped_ffn_cuda.launches`` counts calls that launched the kernel (one
per call; each call is two CUDA launches, up- and down-projection), so a
run can show that its expert FFNs went through it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["grouped_ffn", "grouped_ffn_plain", "grouped_ffn_cuda", "build"]

_LIB = "grouped_ffn"
_SOURCES = ("grouped_ffn.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TILES = 65535          # the kernel's grid y


def build() -> ctypes.CDLL:
    """Compile (at the first call in a checkout) and load the kernel."""
    lib = _build.load_library(_LIB, _SOURCES)
    fn = lib.bf_grouped_ffn
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def grouped_ffn_plain(xt: torch.Tensor, tile_eid: torch.Tensor,
                      w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The plain version: gather each tile's expert weights, then two
    batched einsums with the tanh gelu between (the JAX
    ``grouped_ffn_xla``), in f32 as the TPU kernel computes, cast back to
    xt's dtype.  The gather materializes ``[G, D, F]`` copies of the
    weights (about 4.5 GB in f32 for the 135 tiles of a 512-token prefill
    at D 1024, F 4096), which is acceptable for the CPU tests and the
    card-side comparisons that use it, and why the card's main path never
    does."""
    idx = tile_eid.long()
    u = F.gelu(torch.einsum("gtd,gdf->gtf", xt.float(), w1[idx].float()),
               approximate="tanh")
    return torch.einsum("gtf,gfd->gtd", u, w2[idx].float()).to(xt.dtype)


def _check(xt: torch.Tensor, tile_eid: torch.Tensor, w1: torch.Tensor,
           w2: torch.Tensor) -> None:
    if xt.ndim != 3 or tile_eid.shape != (xt.shape[0],):
        raise ValueError(
            f"grouped_ffn: xt must be [n_tiles, tile, D] with tile_eid "
            f"[n_tiles], got {tuple(xt.shape)} / {tuple(tile_eid.shape)}")
    D = xt.shape[2]
    if (w1.ndim != 3 or w2.ndim != 3 or w1.shape[1] != D
            or w2.shape != (w1.shape[0], w1.shape[2], D)):
        raise ValueError(
            f"grouped_ffn: want w1 [E, D={D}, F] and w2 [E, F, D], got "
            f"{tuple(w1.shape)} / {tuple(w2.shape)}")


def grouped_ffn_cuda(xt: torch.Tensor, tile_eid: torch.Tensor,
                     w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Launch the kernel; raises on anything it does not take.  The ids
    in ``tile_eid`` must lie in ``[0, E)`` (the layout guarantees it;
    checking would cost a host sync)."""
    dev = xt.device
    if dev.type != "cuda":
        raise RuntimeError(f"grouped_ffn_cuda needs CUDA tensors, got {dev}")
    _check(xt, tile_eid, w1, w2)
    if xt.dtype not in _DTYPES or w1.dtype != xt.dtype \
            or w2.dtype != xt.dtype:
        raise TypeError(f"grouped_ffn dtypes {xt.dtype}/{w1.dtype}/"
                        f"{w2.dtype}: expected all alike, one of "
                        f"{list(_DTYPES)}")
    if tile_eid.dtype != torch.int32:
        raise TypeError(f"tile_eid must be int32, got {tile_eid.dtype}")
    for t in (xt, tile_eid, w1, w2):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"grouped_ffn operands must be contiguous on "
                             f"{dev}; got one on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    G, tile, D = xt.shape
    Fd = w1.shape[2]
    if G > _MAX_TILES or 0 in (G, tile, D, Fd):
        raise ValueError(f"grouped_ffn takes 1 .. {_MAX_TILES} tiles and "
                         f"non-empty tiles/widths, got G={G} tile={tile} "
                         f"D={D} F={Fd}")
    lib = build()
    u = torch.empty((G, tile, Fd), dtype=torch.float32, device=dev)
    out = torch.empty_like(xt)
    err = lib.bf_grouped_ffn(
        xt.data_ptr(), tile_eid.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        u.data_ptr(), out.data_ptr(), G, tile, D, Fd, _DTYPES[xt.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped ffn kernel launch failed: CUDA error "
                           f"{err} (G={G} tile={tile} D={D} F={Fd})")
    grouped_ffn_cuda.launches += 1
    return out


grouped_ffn_cuda.launches = 0


def grouped_ffn(xt: torch.Tensor, tile_eid: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if xt.device.type == "cuda":
        return grouped_ffn_cuda(xt, tile_eid, w1, w2)
    if xt.device.type != "cpu":
        raise RuntimeError(f"grouped_ffn runs on CUDA or the CPU, not "
                           f"{xt.device}")
    _check(xt, tile_eid, w1, w2)
    return grouped_ffn_plain(xt, tile_eid, w1, w2)
