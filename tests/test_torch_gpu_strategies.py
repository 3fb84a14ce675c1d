"""The wire codecs and three window / compressed strategies on the card,
against the port on the CPU.

These tests need a CUDA card and skip elsewhere; this file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_gpu_strategies.py -m gpu

By ``bluefog_tpu_torch/tools/strategy_parity.py``, the gates
``chip_smoke.py`` phases 15a-15b use: every codec's payload, scales and
decode bit-identical to the CPU's on rows from 1e-3 to 1e4, an all-zero
row and a subnormal row (whose scale alone may differ, both storing
zeros), here at 2^16 a rank; and ``win_put``, ``push_sum`` and ``choco``
on the benchmark example's MLP over 8 ranks, 5 steps on rank-varying
data, each leaf within 1e-5 x max|leaf| of the CPU's (or twice the CPU
f32 run's distance from its float64 run), push-sum's weights summing to
n.
"""
import json

import pytest
import torch

from bluefog_tpu_torch.tools import strategy_parity as sp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def test_codecs_on_the_card_match_the_cpu(cuda):
    summary = sp.codec_parity(cuda, width=2 ** 16)
    print(json.dumps(summary))
    sp.check_codecs(summary)


@pytest.mark.parametrize("name", ["win_put", "push_sum", "choco"])
def test_strategy_on_the_card_matches_the_cpu(cuda, name):
    variants = [v for v in sp.VARIANTS if v[0] == name]
    summary = sp.strategy_parity(cuda, variants)
    print(json.dumps(sp.flat_summary(summary)))
    sp.check_strategies(summary)
    assert summary["variants"][name]["loss_last"] < \
        summary["variants"][name]["loss_first"]
