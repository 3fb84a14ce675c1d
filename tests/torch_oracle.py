"""Shared harness of the port's optimizer-core tests: one small float64
problem, its gradient on both sides, and the JAX and port trajectories
of a strategy over 8 ranks (8 virtual devices on the JAX side).

The model is a 16 -> 16 -> 5 MLP in the flax layout on both sides, the
data differs by rank (seeded numpy), the ranks start from the same
params (the ``replicate`` flow).  ``jax_run`` returns JAX's params after
every step and its params and state after step ``mid``; ``port_run``
runs the port from the start (or from a JAX state through
``state_from_jax``) and holds each step to JAX's within ``rel`` x
max|param|; ``run_both`` does both, from the start and from JAX's state
after ``mid`` steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import bluefog_tpu as jbf
import bluefog_tpu.optimizers as jopt
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch.fusion import tree_flatten, tree_unflatten
from bluefog_tpu_torch.parallel import context as tctx

N, DIN, DH, DOUT, B = 8, 16, 16, 5, 6


def problem(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, B, DIN))
    y = rng.integers(0, DOUT, size=(N, B))
    p0 = {"Dense_0": {"kernel": 0.3 * rng.normal(size=(DIN, DH)),
                      "bias": 0.1 * rng.normal(size=(DH,))},
          "Dense_1": {"kernel": 0.3 * rng.normal(size=(DH, DOUT)),
                      "bias": 0.1 * rng.normal(size=(DOUT,))}}
    return x, y, p0


def jax_loss(p, batch):
    x, y = batch
    h = jax.nn.relu(x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])
    logits = h @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"]
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


def jax_grad_fn(p, batch):
    return jax.value_and_grad(jax_loss)(p, batch)


def port_loss(q, batch):
    x, y = batch
    h = torch.relu(x @ q["Dense_0"]["kernel"] + q["Dense_0"]["bias"])
    logits = h @ q["Dense_1"]["kernel"] + q["Dense_1"]["bias"]
    return torch.nn.functional.cross_entropy(logits, y)


def port_grad_fn(p, batch):
    leaves, treedef = tree_flatten(p)
    ps = [t.detach().requires_grad_() for t in leaves]
    loss = port_loss(tree_unflatten(treedef, ps), batch)
    grads = torch.autograd.grad(loss, ps)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def tensors(tree):
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def host(tree):
    return jax.tree.map(np.asarray, tree)


def assert_params(got, want, tag, rel=1e-12):
    for g, w in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
        w = np.asarray(w)
        tol = rel * max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=tol,
                                   err_msg=tag)


def jax_run(cpu_devices, make, steps, mid=None, *, seed=0, setup=None,
            npm=None, grad_fn=jax_grad_fn):
    """``make()`` builds the JAX strategy on the live context (``setup``
    runs first); float64.  Returns the params after each step, the params
    and state after step ``mid``, and the final state."""
    x, y, p0 = problem(seed)
    with jax.enable_x64(True):
        jbf.init(devices=cpu_devices[:N], nodes_per_machine=npm)
        try:
            if setup is not None:
                setup()
            strat = make()
            step = jopt.make_train_step(grad_fn, strat, donate=False)
            params = jopt.replicate(jax.tree.map(jnp.asarray, p0), N)
            state = jopt.init_distributed(strat, params)
            batch = (jnp.asarray(x), jnp.asarray(y, jnp.int32))
            hist, at_mid = [], None
            for t in range(steps):
                params, state, _ = step(params, state, batch)
                hist.append(host(params))
                if mid is not None and t + 1 == mid:
                    at_mid = (host(params), host(state))
            return hist, at_mid, host(state)
        finally:
            jbf.shutdown()


def port_run(make, want, *, seed=0, setup=None, npm=None, start=0,
             from_state=None, rel=1e-12, tag="", grad_fn=port_grad_fn,
             check=None):
    """The port's steps ``start + 1 .. len(want)`` held to ``want``;
    ``from_state`` is JAX's ``(params, state)`` after step ``start``.
    ``check(t, params, state)`` runs after each step.  Returns the final
    params and state."""
    x, y, p0 = problem(seed)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    tctx.init(size=N, device="cpu", nodes_per_machine=npm)
    try:
        if setup is not None:
            setup()
        strat = make()
        step = topt.make_train_step(grad_fn, strat)
        if from_state is None:
            params = topt.replicate(tensors(p0), N)
            state = topt.init_distributed(strat, params)
        else:
            params = tensors(from_state[0])
            state = topt.state_from_jax(from_state[1], strat, params)
        for t in range(start, len(want)):
            params, state, _ = step(params, state, batch)
            assert_params(params, want[t], f"{tag} step {t + 1}", rel)
            if check is not None:
                check(t, params, state)
        return params, state
    finally:
        tctx.shutdown()


def run_both(cpu_devices, make_jax, make_port, steps=12, mid=6, rel=1e-12,
             tag="", **kw):
    """JAX's trajectory, then the port's from the start and from JAX's
    state after ``mid``; returns the port's final ``(params, state)``
    (from the start) and JAX's final state."""
    jkw = {k: v for k, v in kw.items() if k in ("seed", "npm")}
    want, at_mid, jfinal = jax_run(cpu_devices, make_jax, steps, mid,
                                   setup=kw.get("jax_setup"), **jkw)
    pkw = {k: v for k, v in kw.items()
           if k in ("seed", "npm", "check")}
    out = port_run(make_port, want, setup=kw.get("port_setup"), rel=rel,
                   tag=tag, **pkw)
    port_run(make_port, want, setup=kw.get("port_setup"), start=mid,
             from_state=at_mid, rel=rel, tag=tag + " from JAX's state",
             **{k: v for k, v in pkw.items() if k != "check"})
    return out, jfinal
