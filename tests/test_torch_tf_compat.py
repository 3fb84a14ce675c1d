"""The port's Keras weight migration (``bluefog_tpu_torch/utils/
tf_compat.py``) against the JAX package's (``bluefog_tpu/utils/
tf_compat.py``): ``tests/test_tf_compat.py``'s four cases through both
packages give equal trees leaf by leaf (exact), the same round trips and
the same errors; the decentralized-training handoff follows JAX's losses
within 1e-5."""
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bluefog_tpu as bf  # noqa: E402
import bluefog_tpu_torch as tbf  # noqa: E402
from bluefog_tpu import optimizers as bfopt  # noqa: E402
from bluefog_tpu import topology as tu  # noqa: E402
from bluefog_tpu.utils import tf_compat as jtc  # noqa: E402
from bluefog_tpu_torch import optimizers as topt  # noqa: E402
from bluefog_tpu_torch import topology as ttu  # noqa: E402
from bluefog_tpu_torch.utils import tf_compat as ptc  # noqa: E402


def _model():
    tf.random.set_seed(0)
    return tf.keras.Sequential([
        tf.keras.Input(shape=(3,)),
        tf.keras.layers.Dense(4, activation="tanh", name="hidden"),
        tf.keras.layers.Dense(2, name="out"),
    ])


def _same_tree(port, ref):
    """Equal nesting and keys; every leaf a CPU torch tensor equal, dtype
    and bits, to the JAX leaf."""
    assert isinstance(port, dict) and sorted(port) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _same_tree(port[k], ref[k])
        else:
            assert isinstance(port[k], torch.Tensor)
            assert port[k].device.type == "cpu"
            want = np.asarray(ref[k])
            got = port[k].numpy()
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_keras_round_trip_is_exact():
    m = _model()
    tree = ptc.from_keras(m, device="cpu")
    _same_tree(tree, jtc.from_keras(m))
    assert tree["hidden"]["kernel"].shape == (3, 4)      # Keras [in, out]
    assert ptc.param_count(tree) == jtc.param_count(jtc.from_keras(m)) \
        == m.count_params()
    m2 = _model()
    ptc.to_keras(m2, tree)
    for a, b in zip(m.get_weights(), m2.get_weights()):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(m(x).numpy(), m2(x).numpy(), rtol=1e-6)
    # a dtype asked for: both packages cast the same
    _same_tree(ptc.from_keras(m, dtype=torch.float16, device="cpu"),
               jtc.from_keras(m, dtype=jnp.float16))


def _errors(tc, zeros):
    m = _model()
    tree = tc.from_keras(m, **({"device": "cpu"} if tc is ptc else {}))
    bad = {**tree, "hidden": {**tree["hidden"], "kernel": zeros((3, 5))}}
    out = []
    with pytest.raises(ValueError) as e:
        tc.to_keras(_model(), bad)
    out.append(str(e.value))
    del bad["hidden"]
    with pytest.raises(ValueError) as e:
        tc.to_keras(_model(), bad)
    out.append(str(e.value))
    with pytest.raises(ValueError) as e:
        tc.from_variables([tf.Variable(np.ones(2, np.float32), name="a/w"),
                           tf.Variable(np.ones(2, np.float32), name="a/w")],
                          **({"device": "cpu"} if tc is ptc else {}))
    out.append(str(e.value))
    return out


def test_keras_shape_mismatch_and_missing_fail_loud():
    got = _errors(ptc, torch.zeros)
    assert got == _errors(jtc, jnp.zeros)
    assert "hidden/kernel" in got[0] and "missing" in got[1]
    assert "duplicate" in got[2]


def test_variables_round_trip():
    results = []
    for tc, kw in ((jtc, {}), (ptc, {"device": "cpu"})):
        v = [tf.Variable(np.arange(6, dtype=np.float32).reshape(2, 3),
                         name="scope/w"),
             tf.Variable(np.ones(3, dtype=np.float32), name="scope/b")]
        tree = tc.from_variables(v, **kw)
        results.append(tree)
        tree = {"scope": {"w": tree["scope"]["w"] * 2,
                          "b": tree["scope"]["b"] + 1}}
        tc.to_variables(v, tree)
        np.testing.assert_array_equal(
            v[0].numpy(), 2 * np.arange(6, dtype=np.float32).reshape(2, 3))
        np.testing.assert_array_equal(v[1].numpy(), 2 * np.ones(3))
        bad = {"scope": {"w": tree["scope"]["w"].T, "b": tree["scope"]["b"]}}
        with pytest.raises(ValueError, match="shape mismatch for 'scope/w'"):
            tc.to_variables(v, bad)
    _same_tree(results[1], results[0])


def test_from_keras_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptc.from_keras(_model())


def _jax_losses(m, n, batch):
    import optax
    params = jtc.from_keras(m)
    strat = bfopt.DistributedAdaptWithCombineOptimizer(
        optax.sgd(0.05), communication_type="neighbor_allreduce")
    dist = bfopt.replicate(params, n)
    state = bfopt.init_distributed(strat, dist)

    def grad_fn(p, b):
        def loss(q):
            h = jnp.tanh(b @ q["hidden"]["kernel"] + q["hidden"]["bias"])
            y = h @ q["out"]["kernel"] + q["out"]["bias"]
            return jnp.mean(y ** 2)
        return jax.value_and_grad(loss)(p)

    step = bfopt.make_train_step(grad_fn, strat)
    losses = []
    for _ in range(3):
        dist, state, loss = step(dist, state, jnp.asarray(batch))
        losses.append(np.asarray(loss))
    return losses, jax.tree.map(lambda x: np.asarray(x[0]), dist)


def _port_losses(m, n, batch):
    params = ptc.from_keras(m, device="cpu")
    strat = topt.DistributedAdaptWithCombineOptimizer(
        topt.sgd(0.05), communication_type="neighbor_allreduce")
    dist = topt.replicate(params, n)
    state = topt.init_distributed(strat, dist)

    def grad_fn(p, b):
        leaves = {k: {w: t.detach().requires_grad_() for w, t in d.items()}
                  for k, d in p.items()}
        h = torch.tanh(b @ leaves["hidden"]["kernel"]
                       + leaves["hidden"]["bias"])
        y = h @ leaves["out"]["kernel"] + leaves["out"]["bias"]
        loss = (y ** 2).mean()
        flat = [leaves[k][w] for k in leaves for w in leaves[k]]
        gs = iter(torch.autograd.grad(loss, flat))
        return loss.detach(), {k: {w: next(gs) for w in leaves[k]}
                               for k in leaves}

    step = topt.make_train_step(grad_fn, strat)
    losses = []
    for _ in range(3):
        dist, state, loss = step(dist, state, torch.as_tensor(batch))
        losses.append(loss.numpy())
    return losses, {k: {w: t[0] for w, t in d.items()}
                    for k, d in dist.items()}


def test_keras_weights_train_decentralized(cpu_devices):
    """Keras weights -> tree -> 3 CTA gossip steps over 8 stacked ranks ->
    back into Keras, in both packages from the same model and batch."""
    n = 8
    batch = np.broadcast_to(np.linspace(-1, 1, 3 * 4, dtype=np.float32)
                            .reshape(4, 3)[None], (n, 4, 3)).copy()
    m = _model()
    bf.init(devices=cpu_devices)
    bf.set_topology(tu.ExponentialTwoGraph(n), is_weighted=True)
    try:
        want, want_rank0 = _jax_losses(m, n, batch)
    finally:
        bf.shutdown()
    tbf.init(size=n, device="cpu")
    tbf.set_topology(ttu.ExponentialTwoGraph(n), is_weighted=True)
    try:
        got, rank0 = _port_losses(m, n, batch)
    finally:
        tbf.shutdown()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    ptc.to_keras(m, rank0)
    np.testing.assert_array_equal(m.get_weights()[0],
                                  rank0["hidden"]["kernel"].numpy())
    np.testing.assert_allclose(m.get_weights()[0],
                               want_rank0["hidden"]["kernel"], atol=1e-5)
