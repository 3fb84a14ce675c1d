"""The train->serve estate (``bluefog_tpu_torch/tools/serve_bench.py``) on
the card, against the same run on the CPU.

These tests need a CUDA card and skip elsewhere; this file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_gpu_serve_estate.py -m gpu

At serve_bench's smoke widths, dense and MoE (``4x2@2:4``), with the
refresher pulling every 2 train steps: the run ends ``ok`` with every
request done and K1/K2, K3 (and K4 with its backward) launched; a pull
of the card's trained tree on the card equals, bit for bit, the same
pull on the CPU of a copy of that tree into a CPU engine (two rows
weighted 1/2 and added: one rounding either way); and 4 prompts drained
on the card equal that CPU engine's, up to near ties (a top-2 logit gap
below 1e-3, or for MoE a router whose k-th and (k+1)-th probabilities
lie within 1e-5).  The trained weights themselves are not compared
across devices: Adam's first steps move each weight by about the
learning rate times the sign of its gradient, so a gradient within f32
rounding of zero moves it either way.
"""
import contextlib
import io
from unittest import mock

import pytest
import torch

from bluefog_tpu_torch.moe import layers as moe_layers
from bluefog_tpu_torch.ops import flash_attention as fa
from bluefog_tpu_torch.ops import flash_decode as fd
from bluefog_tpu_torch.ops import grouped_ffn as gf
from bluefog_tpu_torch.parallel.compose import compose_parallelism
from bluefog_tpu_torch.serve import Scheduler, ServeEngine, WeightRefresher
from bluefog_tpu_torch.tools import serve_bench

pytestmark = pytest.mark.gpu

MOE = ["--serve-moe", "4x2@2:4"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _run(device, extra):
    with contextlib.redirect_stdout(io.StringIO()):
        return serve_bench.run(["--device", device, "--smoke",
                                "--refresh-every", "2"] + extra)


def _near_tie(model, seq, top_k):
    """The smallest top-2 logit gap of ``seq``'s last position, and for
    MoE the smallest k-th to (k+1)-th router probability gap over every
    layer and position."""
    gaps = []
    orig = moe_layers.router_topk

    def recording(x, wr, *, top_k):
        out = orig(x, wr, top_k=top_k)
        srt = torch.sort(out[1], dim=-1, descending=True).values
        gaps.append(float((srt[:, top_k - 1] - srt[:, top_k]).min()))
        return out
    with mock.patch.object(moe_layers, "router_topk", recording), \
            torch.inference_mode():
        lg = model(torch.tensor([seq]))[0, -1].float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1]) < 1e-3 or (
        top_k is not None and min(gaps) < 1e-5)


@pytest.mark.parametrize("extra", [[], MOE], ids=["dense", "moe"])
def test_estate_on_the_card_matches_the_cpu(cuda, extra):
    for mod, attr in ((fa, "fwd_launches"), (fa, "bwd_launches"),
                      (fd.flash_decode_cuda, "launches"),
                      (gf.grouped_ffn_cuda, "launches"),
                      (gf.grouped_ffn_dgrad_cuda, "launches")):
        setattr(mod, attr, 0)
    gdoc, gst = _run("cuda", extra)
    launched = {"fwd": fa.fwd_launches, "bwd": fa.bwd_launches,
                "k3": fd.flash_decode_cuda.launches,
                "k4": gf.grouped_ffn_cuda.launches,
                "k4_dgrad": gf.grouped_ffn_dgrad_cuda.launches}
    assert gdoc["ok"] and gdoc["requests"]["failed"] == 0
    assert gdoc["refresh"]["pulls"] == 3
    assert gdoc["on_accelerator"] and gdoc["mfu"]["mfu"] > 0
    assert gdoc["invariants"]["cache_in_place"]
    assert min(launched[k] for k in ("fwd", "bwd", "k3")) > 0
    assert (min(launched["k4"], launched["k4_dgrad"]) > 0) == bool(extra)
    assert gdoc["kernels"]["drain"]["launches"]["flash_decode"] > 0

    # one more pull of the trained tree, on the card and on the CPU
    geng, tm = gst["engine"], gst["train_m"]
    twin = ServeEngine(gst["cfg"], geng.params.to("cpu"), gst["scfg"],
                       device="cpu")
    ctm = compose_parallelism(tm.dp, tm.pp, tm.tp, tm.sp, tm.ep,
                              num_experts=tm.num_experts, device="cpu")
    tree = gst["train_params"]
    gst["refresher"].pull(tree)
    WeightRefresher(twin, ctm, every=2).pull(
        {g: {k: v.cpu() for k, v in leaves.items()}
         for g, leaves in tree.items()})
    for (name, a), (_, b) in zip(geng.params.tensors(),
                                 twin.params.tensors()):
        assert torch.equal(a.cpu(), b), name

    # 4 prompts on the card against the CPU engine holding its weights
    prompts = [r.prompt for r in gst["requests"][:4]]
    max_new = gdoc["requests"]["max_new_tokens"]

    def drain(eng):
        sched = Scheduler(eng)
        reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
        sched.drain()
        sched.close()
        return reqs
    top_k = getattr(gst["cfg"], "top_k", None) if extra else None
    for a, b in zip(drain(geng), drain(twin)):
        assert a.replica == b.replica
        if a.generated == b.generated:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a.generated, b.generated))
                 if x != y)
        model = twin.params.replica(a.replica)
        assert _near_tie(model, a.prompt + a.generated[:i], top_k), \
            (a.id, i)
