"""Parallel layouts of the port: the composed LM at pp = tp = sp = 1,
served on one card or trained by gossip over stacked DP ranks."""
from .compose import (ComposeLM, LMConfig, Mesh3D, compose_parallelism,
                      init_lm_params, init_lm_train_params, make_lm_batch,
                      make_lm_grad_fn, make_train_step, params_from_jax)

__all__ = ["LMConfig", "ComposeLM", "init_lm_params", "params_from_jax",
           "Mesh3D", "compose_parallelism", "make_train_step",
           "init_lm_train_params", "make_lm_batch", "make_lm_grad_fn"]
