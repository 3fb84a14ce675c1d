"""Guards on the port's boundaries.

* ``bluefog_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of ``bluefog_tpu`` (a fresh interpreter imports every port
  module, each one first into a package state with none of the port
  loaded, and inspects ``sys.modules``; a source scan catches imports on
  paths the subprocess does not reach);
* entry points run on CUDA unless told otherwise: without a card and
  without ``device="cpu"`` they raise instead of dropping to the CPU;
* the CUDA kernel wrappers refuse CPU tensors, and a missing ``nvcc``
  raises rather than falling back to the plain version.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "bluefog_tpu_torch"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax():
    mods = _port_modules()
    for m in ("ops.flash_decode", "ops.flash_attention", "ops.ring",
              "optimizers", "topology", "schedule", "fusion",
              "tools.lm_bench", "ops.grouped_ffn", "moe.dropless",
              "moe.layers", "moe.model", "parallel.expert"):
        assert "bluefog_tpu_torch." + m in mods
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    # each module is imported first, into a package state with none of
    # the port loaded, so no module needs another imported before it
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    for k in [k for k in sys.modules\n"
            "              if k.split('.')[0] == 'bluefog_tpu_torch']:\n"
            "        del sys.modules[k]\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'bluefog_tpu.')) or "
            "m == 'bluefog_tpu')\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=180)
    assert p.returncode == 0, p.stdout + p.stderr[-3000:]


_BAD_IMPORT = re.compile(
    r"^\s*(import\s+(jax|jaxlib|bluefog_tpu)\b(?!_torch)"
    r"|from\s+(jax|jaxlib|bluefog_tpu)\b(?!_torch)"
    r"|from\s+\.\.\.)", re.M)


def test_source_scan_finds_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert (REPO / "chip_smoke.py").exists()
    offenders = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
                 for f in files for m in _BAD_IMPORT.finditer(f.read_text())]
    assert not offenders, offenders


def test_entry_points_refuse_a_missing_card(monkeypatch):
    from bluefog_tpu_torch import resolve_device
    from bluefog_tpu_torch.parallel.compose import LMConfig, init_lm_params
    from bluefog_tpu_torch.parallel.compose import compose_parallelism
    from bluefog_tpu_torch.serve import ServeConfig, ServeEngine
    from bluefog_tpu_torch.serve.kv_cache import KVCacheConfig, init_cache
    from bluefog_tpu_torch.tools import lm_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LMConfig(layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm_params(cfg)
    model = init_lm_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, model, ServeConfig())
    assert ServeEngine(cfg, model, ServeConfig(),
                       device="cpu").device.type == "cpu"
    kcfg = KVCacheConfig(layers=1, slots=1, max_len=8, kv_heads=1,
                         head_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(kcfg)
    assert init_cache(kcfg, device="cpu")["k"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compose_parallelism(4)
    assert compose_parallelism(4, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_bench.main([])
    from bluefog_tpu_torch.moe.model import MoELMConfig, init_moe_params
    mcfg = MoELMConfig(layers=1, num_experts=2, dispatch="dropless")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_moe_params(mcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(mcfg, init_moe_params(mcfg, device="cpu"),
                    ServeConfig())


def test_kernel_wrapper_refuses_cpu_tensors_and_missing_nvcc(
        monkeypatch, tmp_path):
    from bluefog_tpu_torch.ops import _build
    from bluefog_tpu_torch.ops import flash_attention as fa
    from bluefog_tpu_torch.ops import flash_decode as fd
    from bluefog_tpu_torch.ops import grouped_ffn as gf
    cl = {"k": torch.zeros(2, 1, 8, 64), "v": torch.zeros(2, 1, 8, 64)}
    idx = torch.zeros(1, dtype=torch.int32)
    before = fd.flash_decode_cuda.launches
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        fd.flash_decode_cuda(torch.zeros(1, 1, 1, 64), cl, idx, idx, 0.1,
                             None, None, 8)
    with pytest.raises(RuntimeError, match="CUDA or the CPU"):
        fd.flash_attend_rows(torch.zeros(1, 1, 64, device="meta"),
                             cl["k"].to("meta"), cl["v"].to("meta"),
                             idx.to("meta"), idx.to("meta"))
    assert fd.flash_decode_cuda.launches == before
    xt, eid = torch.zeros(3, 2, 8), torch.zeros(3, dtype=torch.int32)
    w1, w2 = torch.zeros(2, 8, 16), torch.zeros(2, 16, 8)
    k4_before = gf.grouped_ffn_cuda.launches
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        gf.grouped_ffn_cuda(xt, eid, w1, w2)
    with pytest.raises(RuntimeError, match="CUDA or the CPU"):
        gf.grouped_ffn(*(t.to("meta") for t in (xt, eid, w1, w2)))
    assert gf.grouped_ffn_cuda.launches == k4_before
    # no nvcc, no prebuilt library: building raises, nothing falls back
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(os.path, "exists",
                        lambda p: str(p).startswith(str(tmp_path)))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fd.build()
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gf.build()
    assert gf.grouped_ffn_cuda.launches == k4_before
    before = (fa.fwd_launches, fa.bwd_launches)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        fa.flash_bwd_cuda(q, q, q, q, q[..., 0], q[..., 0], 0, 0,
                          causal=True, scale=0.1)
    assert (fa.fwd_launches, fa.bwd_launches) == before
