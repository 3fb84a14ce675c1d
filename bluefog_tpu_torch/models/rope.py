"""Rotary position embedding (counterpart of the rope functions in
``bluefog_tpu/models/transformer.py``).

Same channel pairing (channel ``i`` with ``i + d//2``) and float32
internals as the JAX functions, so a token roped by prefill, by chunked
decode or by single-token decode gets the same rotation.
"""
from __future__ import annotations

import torch

__all__ = ["apply_rope", "apply_rope_grid", "apply_rope_rows"]


def _cos_sin(positions: torch.Tensor, d: int, base: float):
    if d % 2:
        raise ValueError(f"rope needs an even head_dim, got {d}: the "
                         "rotation pairs channel i with channel i + d//2")
    half = d // 2
    exps = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(base, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs     # [..., half]
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """Rope on ``[B, T, H, D]`` with per-token ``positions`` ``[T]``."""
    cos, sin = _cos_sin(positions, x.shape[-1], base)          # [T, half]
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def apply_rope_grid(x: torch.Tensor, positions: torch.Tensor,
                    base: float = 10000.0) -> torch.Tensor:
    """Rope on ``[S, T, H, D]`` with a per-row grid ``positions`` ``[S, T]``
    (chunked decode: each lane's chunk starts at its own offset)."""
    cos, sin = _cos_sin(positions, x.shape[-1], base)          # [S, T, half]
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def apply_rope_rows(x: torch.Tensor, positions: torch.Tensor,
                    base: float = 10000.0) -> torch.Tensor:
    """Rope on ``[B, H, D]`` with per-row ``positions`` ``[B]`` (the decode
    hot path: each lane sits at its own sequence offset)."""
    cos, sin = _cos_sin(positions, x.shape[-1], base)          # [B, half]
    return _rotate(x, cos[:, None, :], sin[:, None, :])
