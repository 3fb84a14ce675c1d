"""The port's ``examples/mnist.py`` against the JAX example on the CPU:
both read the same small ``mnist.npz`` (256 of the example's synthetic
blobs, through ``--data-dir``) at ``--epochs 2 --batch-size 8`` over 8
ranks (4 steps an epoch), the JAX example in a subprocess
(``tests/torch_example_twins.py``), the port in process from the JAX
example's own initial weights (flax's init at ``key(0)``, converted by
``models.variables_from_jax``).  The loader's batches are JAX's, so each
epoch's mean, first and last loss equal JAX's printed values within 2e-3
(f32, SGD with momentum over 8 steps, the sums in another order) and the
test accuracy within 0.02 (512 held-out blobs); both end conditions hold
(the loss falls).  The port's own run at its defaults is chip_smoke's
(phase 21f); five other ``--dist-optimizer`` / ``--atc`` /
``--dynamic-topology`` choices run the same 2 epochs here (their end
condition holds).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bluefog_tpu import models as jmodels
from bluefog_tpu_torch import models as tmodels
from bluefog_tpu_torch.examples import mnist
import torch_cpu_threads  # noqa: F401  (the worker's thread share)
import torch_example_twins as twins

EPOCH = re.compile(r"^epoch (\d+): mean loss ([0-9.]+) \(first ([0-9.]+) "
                   r"-> last ([0-9.]+)\)")


def _epochs(lines):
    return [tuple(float(g) for g in m.groups()[1:])
            for m in map(EPOCH.match, lines) if m]


def _data(tmp_path):
    x, y = mnist.synthetic_mnist(np.random.default_rng(42), 256)
    np.savez(tmp_path / "mnist.npz", x_train=x, y_train=y)
    return str(tmp_path)


def _flax_init():
    v = jmodels.MnistCNN().init({"params": jax.random.key(0)},
                                jnp.ones((1, 28, 28, 1)), train=False)
    return tmodels.variables_from_jax(tmodels.MnistCNN(),
                                      jax.tree.map(np.asarray, dict(v)))


def test_mnist_matches_the_jax_example(tmp_path, capsys):
    argv = ["--epochs", "2", "--batch-size", "8", "--data-dir",
            _data(tmp_path)]
    proc = twins.start("mnist", argv)
    with twins.one_thread():
        res = mnist.train(mnist.parse(argv + ["--device", "cpu"]),
                          variables=_flax_init())
    lines = capsys.readouterr().out.strip().splitlines()
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    jlines = out.strip().splitlines()
    got, want = _epochs(lines), _epochs(jlines)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-3)
    acc = float(lines[-1].rsplit(" ", 1)[1])
    jacc = float(jlines[-1].rsplit(" ", 1)[1])
    assert abs(acc - jacc) <= 0.02, (lines[-1], jlines[-1])
    assert lines[-1].split(":")[0] == jlines[-1].split(":")[0]
    assert res["losses"][-1].shape == (8, 4)


@pytest.mark.parametrize("argv", [
    ["--dist-optimizer", "gradient_allreduce"],
    ["--dist-optimizer", "win_put"], ["--dist-optimizer", "push_sum"],
    ["--dist-optimizer", "hierarchical_neighbor_allreduce"],
    ["--atc", "--dynamic-topology"]],
    ids=["gradient_allreduce", "win_put", "push_sum", "hierarchical",
         "atc_dynamic"])
def test_mnist_strategies_run(tmp_path, argv, capsys):
    with twins.one_thread():
        res = mnist.train(mnist.parse(
            argv + ["--epochs", "2", "--batch-size", "8", "--device",
                    "cpu", "--data-dir", _data(tmp_path)]))
    assert [h.shape for h in res["losses"]] == [(8, 4), (8, 4)]
    assert np.isfinite(res["losses"][-1]).all()
    assert "test accuracy" in capsys.readouterr().out
