"""Env-var config helpers (the port's own copy of the part of
``bluefog_tpu/utils/config.py`` it needs: the logger and the
``env_flag`` / ``env_int`` / ``env_float`` readers).

The JAX module's XLA-flag and compilation-cache helpers
(``apply_recommended_xla_flags``, ``enable_compilation_cache``) have no
counterpart here: the port compiles no XLA programs, and its CUDA
kernels are built once per checkout by :mod:`bluefog_tpu_torch.ops._build`.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

__all__ = ["logger", "env_flag", "env_int", "env_float"]

logger = logging.getLogger("bluefog_tpu_torch")


def env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    v = os.environ.get(name)
    return default if v is None else int(v)


def env_float(name: str, default: Optional[float] = None) -> Optional[float]:
    v = os.environ.get(name)
    return default if v is None else float(v)
