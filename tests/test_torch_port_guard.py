"""Guards on the port's boundaries.

* ``bluefog_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of ``bluefog_tpu`` (a fresh interpreter imports every port
  module, each one first into a package state with none of the port
  loaded, and inspects ``sys.modules``; a source scan catches imports on
  paths the subprocess does not reach);
* entry points run on CUDA unless told otherwise: without a card and
  without ``device="cpu"`` they raise instead of dropping to the CPU;
* the CUDA kernel wrappers refuse CPU tensors, and a missing ``nvcc``
  raises rather than falling back to the plain version;
* the host C++ helpers (``_native``) are the port's own copies, built
  into the port's ``_build/``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

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
              "moe.layers", "moe.model", "parallel.expert",
              "parallel.pipeline", "parallel.tensor_parallel",
              "ops.collectives", "ops.ulysses", "models.transformer",
              "tools.long_context", "tools.sp_bench", "models.layers",
              "models.resnet", "models.mlp", "models.cnn", "models.vgg",
              "parallel.context", "api", "tools.bench",
              "tools.resnet_parity", "examples.average_consensus",
              "ops.windows", "examples.benchmark", "utils.config",
              "utils.flight", "utils.metrics", "utils.timeseries",
              "utils.tracing", "diagnostics", "run.launcher",
              "serve.refresh", "tools.trace_report", "tools.serve_bench",
              "examples.llm_3d", "examples.moe", "examples.moe_lm",
              "examples.pipeline_lm", "tools.world_check",
              "parallel.windows", "examples.decentralized_optimization",
              "tools.gossip_bench", "tools.strategy_bench", "_native",
              "utils.chaos", "utils.timeline", "utils.watchdog",
              "utils.utility", "resilience", "checkpoint", "data",
              "examples.mnist", "examples.resnet",
              "examples.elastic_restart", "run.interactive",
              "utils.fleetview", "tools.regrow_drill",
              "tools.preempt_trace", "tools.preempt_bench",
              "tools.fleet_top", "utils.wire_bytes", "autotune",
              "autotune.candidates", "autotune.plan", "autotune.bank",
              "autotune.cost_model", "autotune.trials", "autotune.tuner",
              "autotune.__main__", "tools.trace_analyze",
              "tools.step_sweep", "tools.gen_api_docs", "utils.tf_compat"):
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


def test_ported_parts_no_longer_name_item_10():
    """Item 10 (the launcher, the elastic world, the fleet view, and last
    autotune with ``apply_plan``) is ported: no line of the port names
    ROADMAP queue 1, item 10."""
    hits = [(f.relative_to(REPO), line.strip())
            for f in sorted(PORT.rglob("*.py"))
            for line in f.read_text().splitlines() if "item 10" in line]
    assert hits == [], hits


def test_port_imports_no_root_tool():
    """The port keeps its own copies of the repo's ``tools/*.py`` (the
    JAX package's tools): no port file imports or loads one."""
    pat = re.compile(r"^\s*(import\s+tools\b|from\s+tools\b)"
                     r"|spec_from_file_location\(", re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
                 for f in files for m in pat.finditer(f.read_text())]
    assert not offenders, offenders


def test_source_scan_finds_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert (REPO / "chip_smoke.py").exists()
    offenders = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
                 for f in files for m in _BAD_IMPORT.finditer(f.read_text())]
    assert not offenders, offenders


def test_entry_points_refuse_a_missing_card(monkeypatch, tmp_path):
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
    from bluefog_tpu_torch.autotune import __main__ as autotune_cli
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune_cli.main(["--smoke"])
    from bluefog_tpu_torch.models.transformer import (RingTransformerLM,
                                                      init_decode_cache)
    from bluefog_tpu_torch.examples import (benchmark,
                                            decentralized_optimization,
                                            elastic_restart, llm_3d, mnist,
                                            moe, moe_lm, resnet)
    from bluefog_tpu_torch.tools import (gossip_bench, long_context,
                                         serve_bench, sp_bench,
                                         strategy_bench)
    for tool in (long_context, sp_bench, benchmark, serve_bench, llm_3d,
                 moe, moe_lm, decentralized_optimization, gossip_bench,
                 strategy_bench, mnist, resnet, elastic_restart):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gossip_bench.main(["--async-frontier"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_bench.main(["--chaos", "throttle:from=2,t=0.1,rank=1"])
    lm = RingTransformerLM(vocab_size=8, num_layers=1, num_heads=2,
                           d_model=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_decode_cache(lm, 1, 4, device="cuda")
    from bluefog_tpu_torch.moe.model import MoELMConfig, init_moe_params
    mcfg = MoELMConfig(layers=1, num_experts=2, dispatch="dropless")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_moe_params(mcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(mcfg, init_moe_params(mcfg, device="cpu"),
                    ServeConfig())
    from bluefog_tpu_torch.run import interactive
    from bluefog_tpu_torch.tools import (preempt_bench, preempt_trace,
                                         regrow_drill)
    trace = tmp_path / "trace.json"
    assert preempt_trace.main(["--pattern", "mass", "--out",
                               str(trace)]) == 0
    monkeypatch.delenv("BLUEFOG_DEVICE", raising=False)
    for call in (lambda: regrow_drill.main([]),
                 lambda: regrow_drill.main(["--chaos",
                                            "kill_coordinator:step=1"]),
                 lambda: preempt_bench.main(["--trace", str(trace)]),
                 lambda: interactive.worker_main("127.0.0.1:1")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


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


def test_moe_training_refuses_a_missing_card(monkeypatch):
    """The MoE trainer's entry points (the carving, ``lm_bench --moe``)
    raise without a card unless asked for the CPU; on a CPU carving
    ``init_moe_train_params`` / ``make_moe_grad_fn`` stay on the CPU, and
    K4's backward wrappers refuse CPU tensors without counting."""
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.moe.model import (MoELMConfig, init_moe_train_params,
                                             make_moe_batch, make_moe_grad_fn)
    from bluefog_tpu_torch.ops import grouped_ffn as gf
    from bluefog_tpu_torch.parallel.compose import compose_parallelism
    from bluefog_tpu_torch.tools import lm_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compose_parallelism(2, 2, 2, 1, num_experts=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_bench.main(["--moe", "--dropless"])
    cfg = MoELMConfig(layers=2, num_experts=2, dispatch="dropless",
                      group_tile=4, micro=2, seq_len=8)
    m = compose_parallelism(1, 2, 1, 1, device="cpu", num_experts=2)
    params = init_moe_train_params(cfg, m)
    assert sorted(params) == ["blocks", "experts", "router", "shared"]
    loss, grads = bfopt.stacked_grads(make_moe_grad_fn(cfg, m), params,
                                      make_moe_batch(cfg, m), m.slice_size)
    assert loss.device.type == "cpu"
    assert all(g.device.type == "cpu" for d in grads.values()
               for g in d.values())
    before = (gf.grouped_ffn_dgrad_cuda.launches,
              gf.grouped_ffn_wgrad_cuda.launches)
    xt, eid = torch.zeros(3, 2, 8), torch.zeros(3, dtype=torch.int32)
    w1, w2 = torch.zeros(2, 8, 16), torch.zeros(2, 16, 8)
    s = torch.zeros(3, 2, 16)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        gf.grouped_ffn_dgrad_cuda(xt, eid, w1, w2, s)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        gf.grouped_ffn_wgrad_cuda(xt, s, s, xt, eid, 2)
    assert (gf.grouped_ffn_dgrad_cuda.launches,
            gf.grouped_ffn_wgrad_cuda.launches) == before


def test_carved_serving_refuses_a_missing_card(monkeypatch):
    """The carved serving engine and the demo raise without a card unless
    asked for the CPU; a CPU carving's params stay on the CPU."""
    from bluefog_tpu_torch.parallel.compose import (LMConfig,
                                                    compose_parallelism,
                                                    init_lm_train_params,
                                                    params_from_jax)
    from bluefog_tpu_torch.serve import ServeConfig, ServeEngine
    from bluefog_tpu_torch.serve import __main__ as demo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LMConfig(layers=2)
    m = compose_parallelism(2, 1, 2, device="cpu")
    params = params_from_jax(init_lm_train_params(cfg, m), cfg, m=m)
    assert params.embed.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params, ServeConfig())
    eng = ServeEngine(cfg, params, ServeConfig(), device="cpu")
    assert eng.cache["k"].device.type == "cpu" and eng.replicas == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main(["--dp", "2", "--tp", "2"])


def test_bench_context_and_consensus_refuse_a_missing_card(monkeypatch):
    """The ResNet bench, the context's ``init`` and the consensus example
    raise without a card unless asked for the CPU; nothing is left
    initialized."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.examples import average_consensus
    from bluefog_tpu_torch.tools import bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bf.shutdown()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bf.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bf.init(size=4)
    assert not bf.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--image-size", "32", "--classes", "10", "--batch", "1",
                    "--steps-per-call", "1", "--iters", "1"])
    assert not bf.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        average_consensus.main(["--data-size", "8"])
    assert bf.init(size=2, device="cpu").device.type == "cpu"
    bf.shutdown()


def test_native_helpers_are_the_ports_own():
    """``bluefog_tpu_torch/_native`` builds its own sources into the
    port's ``_build/``: no string of its code names a path into
    ``bluefog_tpu`` (docstrings may cite the JAX counterpart), the C++
    sources include only system headers, and the library loads from the
    port's build directory."""
    import ast
    from bluefog_tpu_torch import _native
    nat = PORT / "_native"
    assert sorted(p.name for p in nat.glob("*.cc")) == \
        ["loader.cc", "schedule.cc", "timeline.cc"]
    for f in sorted(nat.glob("*.cc")):
        includes = re.findall(r'^#include\s+(\S+)', f.read_text(), re.M)
        assert includes and all(i.startswith("<") for i in includes), f
    tree = ast.parse((nat / "__init__.py").read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    strings = [n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)
               and id(n) not in docs]
    assert strings and not [v for v in strings
                            if re.search(r"bluefog_tpu\b(?!_torch)", v)]
    assert Path(_native._BUILD) == PORT / "_build"
    assert _native.available(), _native.build_error()
    lib = Path(_native.library_path())
    assert lib.parent == PORT / "_build" and lib.name.startswith(
        "libbft_native-")
