"""The port's ``examples/resnet.py`` against the JAX example on the CPU:
both read the same small ``cifar.npz`` (``--data-dir``: 128 training and
64 test images of the example's synthetic blobs) at ``--epochs 3
--batch-size 8`` over 8 ranks (2 steps an epoch: a warmup epoch, then
the step decay), the JAX example in a subprocess
(``tests/torch_example_twins.py``), the port in process from the JAX
example's own initial weights (flax's ResNet-18 init at ``key(0)``,
converted by ``models.variables_from_jax``).  Over the 3 epochs the
train loss falls from ~2.59 to ~1.91.  The convolutions run in bf16 on
both sides, in another order, so each epoch's train loss agrees with
JAX's within 2e-2 (relative); the validation accuracy of these barely
trained models on 64 images is not compared (one flipped argmax moves
it by 1/64).  The gate is shown to catch a planted fault: the port with
no update (``--base-lr 0``) or no gossip (``--dist-optimizer empty``)
misses JAX's losses by more than 2e-2 at some epoch (on this data the
sound port's largest gap was 1.6e-3, the faulted ones' 0.36 and 0.14,
each at epoch 2).
``--checkpoint-dir``: with the last epoch's checkpoint removed, a
resumed run gives the uninterrupted run's last epoch exactly (the
resumed schedule count and shuffle included); the learning-rate
schedule equals optax's ``join_schedules`` step for step.
"""
import re
import shutil

import jax
import pytest
import jax.numpy as jnp
import numpy as np
import optax

from bluefog_tpu import models as jmodels
from bluefog_tpu_torch import models as tmodels
from bluefog_tpu_torch.examples import resnet
import torch_cpu_threads  # noqa: F401  (the worker's thread share)
import torch_example_twins as twins

EPOCH = re.compile(r"^epoch (\d+): train loss ([0-9.]+), val acc "
                   r"\(rank0 model\) ([0-9.]+)")


def _epochs(lines):
    return [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
            for m in map(EPOCH.match, lines) if m]


def _data(tmp_path):
    x, y = resnet.synthetic_cifar(np.random.default_rng(0), 128)
    xt, yt = resnet.synthetic_cifar(np.random.default_rng(1), 64)
    np.savez(tmp_path / "cifar.npz", x_train=x, y_train=y, x_test=xt,
             y_test=yt)
    return str(tmp_path)


def _flax_init():
    model = jmodels.ResNet18(num_classes=10, num_filters=16)
    v = model.init(jax.random.key(0), jnp.ones((1, 32, 32, 3)), train=False)
    port = tmodels.ResNet18(num_classes=10, num_filters=16)
    return tmodels.variables_from_jax(port, jax.tree.map(np.asarray,
                                                         dict(v)))


def test_lr_schedule_equals_optax():
    W, total, base = 3, 10, 0.05
    want = optax.join_schedules([
        optax.linear_schedule(base / 10, base, W),
        optax.piecewise_constant_schedule(
            base, {int(total * 0.5): 0.1, int(total * 0.75): 0.1})], [W])
    got = resnet.lr_schedule(base, W, total)
    np.testing.assert_allclose([got(t) for t in range(16)],
                               [float(want(t)) for t in range(16)],
                               rtol=1e-6)


ARGV = ["--epochs", "3", "--batch-size", "8"]
RTOL = 2e-2


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The data directory, and the JAX example's epochs on it (started at
    once, read at the first call of ``epochs``; it runs while the port
    trains)."""
    data = _data(tmp_path_factory.mktemp("cifar"))
    proc = twins.start("resnet", ARGV + ["--data-dir", data])
    got = []

    def epochs():
        if not got:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            got.append(_epochs(out.strip().splitlines()))
        return got[0]
    yield data, epochs
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _port(data, extra=()):
    with twins.one_thread():
        return resnet.train(resnet.parse(
            ARGV + ["--data-dir", data, "--device", "cpu", *extra]),
            variables=_flax_init())


def _gaps(history, want):
    return [abs(loss - jloss) / jloss
            for (loss, _), (_, jloss, _) in zip(history, want)]


def test_resnet_matches_the_jax_example(jax_run, tmp_path, capsys):
    data, jax_epochs = jax_run
    ck = tmp_path / "ck"
    whole = _port(data, ["--checkpoint-dir", str(ck)])
    lines = capsys.readouterr().out.strip().splitlines()
    # the epoch-3 checkpoint lost: resume from epoch 2's
    shutil.rmtree(ck / "step_3")
    resumed = _port(data, ["--checkpoint-dir", str(ck)])
    rlines = capsys.readouterr().out.strip().splitlines()
    got, want = _epochs(lines), jax_epochs()
    assert [e for e, _, _ in got] == [e for e, _, _ in want] == [0, 1, 2]
    assert got[-1][1] < 0.8 * got[0][1], got       # the loss moved
    assert max(_gaps(whole["history"], want)) <= RTOL, (got, want)
    # the resumed run: epoch 2 of the uninterrupted run, exactly
    assert resumed["start_epoch"] == 2 and rlines[0] == \
        "resumed from epoch 2"
    assert resumed["history"] == whole["history"][2:]


@pytest.mark.parametrize("fault", [["--base-lr", "0"],
                                   ["--dist-optimizer", "empty"]],
                         ids=["no_update", "no_gossip"])
def test_the_loss_gate_catches_a_planted_fault(jax_run, fault):
    data, jax_epochs = jax_run
    faulted = _port(data, fault)
    assert max(_gaps(faulted["history"], jax_epochs())) > RTOL
