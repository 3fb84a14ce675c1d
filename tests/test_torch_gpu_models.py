"""The port's ResNets and the ResNet-50 bench on the card, against the
port on the CPU.

These tests need a CUDA card and skip elsewhere; this file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_gpu_models.py -m gpu

ResNet18 and ResNet50 (1000 classes, the port's own seeded init with
every BatchNorm scale and bias drawn) take bench.py's loss on 4 seeded
64 x 64 images with seeded labels; the step-1 loss, logits and gradients
on the card are held to the CPU's by the gates of
``bluefog_tpu_torch/tools/resnet_parity.py``, which ``chip_smoke.py``
phase 14a uses at 224 x 224 (f32 each gradient leaf within 1e-4 x
max|g|, bf16 within twice the card's own bf16-against-f32 gap, the CPU
replaying the card's ReLU masks and max-pool picks, each flip a near
tie).

The bench tool's one-call run on the card prints its schema with a finite
loss that falls.
"""
import numpy as np
import pytest
import torch

from bluefog_tpu_torch.fusion import tree_flatten
from bluefog_tpu_torch.models import ResNet18, ResNet50
from bluefog_tpu_torch.tools import bench, resnet_parity

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("cls", [ResNet18, ResNet50])
def test_resnet_step1_on_the_card_matches_the_cpu(cuda, cls):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 64, 64, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 1000, 4))
    models = {name: cls(num_classes=1000, dtype=dt,
                        generator=torch.Generator().manual_seed(0))
              for name, dt in (("f64", torch.float64),
                               ("f32", torch.float32),
                               ("bf16", torch.bfloat16))}
    variables = resnet_parity.live_variables(models["f32"], seed=1)
    summary = resnet_parity.compare(models, variables, x, labels, cuda)
    print({k: v for k, v in summary.items() if k != "per_leaf"})
    resnet_parity.check(summary)


def test_bench_one_call_on_the_card(cuda):
    benchmark = torch.backends.cudnn.benchmark
    doc, b = bench.run(bench.parse(["--image-size", "64", "--classes", "10",
                                    "--batch", "8", "--steps-per-call", "3",
                                    "--iters", "1", "--ranks", "2"]))
    assert torch.backends.cudnn.benchmark == benchmark
    assert doc["on_accelerator"] is True and doc["n_ranks"] == 2
    assert doc["device"] == torch.cuda.get_device_name(0)
    assert doc["value"] > 0 and doc["power_limit_w"] > 0
    assert np.isfinite(doc["loss_last"]) and doc["loss_last"] < \
        doc["loss_first"]
    if doc["device"] in bench.PEAK_BF16_FLOPS:
        assert 0 < doc["mfu"] < 1
    for leaf in tree_flatten(b.params)[0]:
        assert leaf.is_cuda and torch.isfinite(leaf).all()
