"""Parallel layouts of the port: the composed LM, served or trained at
any dp x pp x tp (x sp for training) x ep carving with every peer
stacked on one card (:mod:`.pipeline`, :mod:`.tensor_parallel`)."""
from .compose import (ComposeLM, LMConfig, Mesh3D, ServingParams,
                      compose_parallelism, init_lm_params,
                      init_lm_train_params, make_lm_batch, make_lm_grad_fn,
                      make_train_step, params_from_jax)

__all__ = ["LMConfig", "ComposeLM", "init_lm_params", "params_from_jax",
           "ServingParams", "Mesh3D", "compose_parallelism",
           "make_train_step", "init_lm_train_params", "make_lm_batch",
           "make_lm_grad_fn"]
