"""Parallel layouts of the port (pp = tp = sp = 1 so far)."""
from .compose import LMConfig, ComposeLM, init_lm_params, params_from_jax

__all__ = ["LMConfig", "ComposeLM", "init_lm_params", "params_from_jax"]
