"""Generate ``bluefog_tpu_torch/docs/API.md`` from the port's docstrings
(counterpart of ``tools/gen_api_docs.py``, which writes the JAX package's
``docs/API.md``).

One markdown page over the public surface, module by module, in the JAX
page's order with the port's counterparts: the three Pallas modules are
the CUDA kernels' modules (``ops.flash_attention``, ``ops.flash_decode``,
``ops.grouped_ffn``), ``utils.hlo_bytes`` is ``utils.wire_bytes``, and
``parallel.exec_cache`` and ``utils.torch_compat`` have no counterpart
(README: not applicable).  Every name of a module's ``__all__`` gets an
entry: functions and classes with their signatures and docstrings, other
objects by type.  Regenerate after API changes:

    python -m bluefog_tpu_torch.tools.gen_api_docs
"""
from __future__ import annotations

import importlib
import inspect
import os
import re

MODULES = [
    ("bluefog_tpu_torch.api", "Core API (init, ops, synchronization)"),
    ("bluefog_tpu_torch.topology", "Topologies (static + dynamic generators)"),
    ("bluefog_tpu_torch.schedule",
     "Communication schedules (topology compiler)"),
    ("bluefog_tpu_torch.optimizers", "Distributed optimizer strategies"),
    ("bluefog_tpu_torch.ops.collectives",
     "Collective ops (gossip primitives, stacked ranks)"),
    ("bluefog_tpu_torch.ops.windows", "Window ops (one-sided mailboxes)"),
    ("bluefog_tpu_torch.ops.ring", "Ring attention (sequence parallelism)"),
    ("bluefog_tpu_torch.ops.ulysses", "Ulysses attention (all-to-all SP)"),
    ("bluefog_tpu_torch.ops.flash_attention",
     "Flash-attention kernels K1/K2 (CUDA C++; plain versions beside)"),
    ("bluefog_tpu_torch.ops.flash_decode",
     "Paged flash-decode kernel K3 (serving)"),
    ("bluefog_tpu_torch.ops.grouped_ffn",
     "Grouped expert FFN kernel K4 and its backward"),
    ("bluefog_tpu_torch.parallel.context",
     "Context (init/topology state, stacked ranks, processes)"),
    ("bluefog_tpu_torch.parallel.windows", "Window registry (named windows)"),
    ("bluefog_tpu_torch.parallel.pipeline", "Pipeline parallelism"),
    ("bluefog_tpu_torch.parallel.compose",
     "Composed parallelism (gossip-DP x PP x TP x Ulysses x EP)"),
    ("bluefog_tpu_torch.parallel.tensor_parallel", "Tensor parallelism"),
    ("bluefog_tpu_torch.parallel.expert", "Expert (MoE) parallelism"),
    ("bluefog_tpu_torch.moe.layers",
     "Routed-MoE layers (router + expert FFN)"),
    ("bluefog_tpu_torch.moe.model", "Routed-MoE reference LM"),
    ("bluefog_tpu_torch.checkpoint", "Checkpointing (elastic, async)"),
    ("bluefog_tpu_torch.serve.engine",
     "Serving engine (prefill + fused decode)"),
    ("bluefog_tpu_torch.serve.kv_cache", "Slotted paged KV cache"),
    ("bluefog_tpu_torch.serve.scheduler", "Continuous batching scheduler"),
    ("bluefog_tpu_torch.serve.refresh", "Live gossip weight refresh"),
    ("bluefog_tpu_torch.data", "Sharded input pipeline"),
    ("bluefog_tpu_torch.fusion", "Tensor fusion (per-dtype bucketing)"),
    ("bluefog_tpu_torch.models", "Model zoo"),
    ("bluefog_tpu_torch.run.launcher", "bfrun-torch launcher"),
    ("bluefog_tpu_torch.run.interactive", "Interactive multi-process mode"),
    ("bluefog_tpu_torch.utils.utility", "Broadcast utilities (restart flow)"),
    ("bluefog_tpu_torch.utils.tf_compat",
     "TensorFlow/Keras migration helpers"),
    ("bluefog_tpu_torch.utils.config", "Environment configuration"),
    ("bluefog_tpu_torch.utils.timeline", "Timeline tracing"),
    ("bluefog_tpu_torch.utils.metrics", "Live metrics registry + exporters"),
    ("bluefog_tpu_torch.utils.tracing", "Request-scoped span tracing"),
    ("bluefog_tpu_torch.utils.timeseries", "Bounded metric history rings"),
    ("bluefog_tpu_torch.utils.fleetview",
     "Fleet view (gossiped whole-fleet metric carrier)"),
    ("bluefog_tpu_torch.diagnostics",
     "Consensus-health probes + peer health"),
    ("bluefog_tpu_torch.utils.watchdog", "Stall watchdog"),
    ("bluefog_tpu_torch.resilience", "Fault tolerance (healing + rollback)"),
    ("bluefog_tpu_torch.utils.chaos", "Deterministic fault injection"),
    ("bluefog_tpu_torch.autotune.tuner", "Strategy autotuner (bf.autotune)"),
    ("bluefog_tpu_torch.autotune.plan",
     "Autotune plans (persist/apply/replay)"),
    ("bluefog_tpu_torch.autotune.candidates",
     "Autotune candidate enumeration"),
    ("bluefog_tpu_torch.autotune.cost_model", "Autotune analytic cost model"),
    ("bluefog_tpu_torch.autotune.bank", "Autotune measurement bank (tier 2)"),
    ("bluefog_tpu_torch.autotune.trials",
     "Autotune live micro-trials (tier 3)"),
    ("bluefog_tpu_torch.utils.wire_bytes",
     "Wire-byte ledger of the port's collectives"),
]

PAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "API.md")


def _strip_addrs(text):
    # repr'd default objects embed memory addresses — nondeterministic
    # churn on every regeneration (signatures AND dataclass auto-docstrings)
    return re.sub(r" at 0x[0-9a-f]+", "", text)


def _doc_head(obj, max_paras=1):
    doc = inspect.getdoc(obj)
    if not doc:
        return "*(no docstring)*"
    paras = doc.split("\n\n")
    return _strip_addrs("\n\n".join(paras[:max_paras]).strip())


def _signature(obj):
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    return _strip_addrs(sig)


def _members(mod):
    """``(name, obj)`` of every ``__all__`` name; without ``__all__``, the
    public functions and classes defined in the module."""
    names = getattr(mod, "__all__", None)
    out = []
    for name in names if names else sorted(vars(mod)):
        obj = getattr(mod, name, None)
        if names:
            out.append((name, obj))
        elif (not name.startswith("_")
              and (inspect.isfunction(obj) or inspect.isclass(obj))
              and getattr(obj, "__module__", None) == mod.__name__):
            out.append((name, obj))
    return out


def _entry(name, obj):
    if inspect.isclass(obj):
        body = [f"### `{name}`", "", _doc_head(obj, 2), ""]
        methods = [
            (n, m) for n, m in inspect.getmembers(obj)
            if not n.startswith("_")
            and (inspect.isfunction(m) or inspect.ismethod(m))
            and m.__qualname__.startswith(obj.__name__ + ".")]
        for mname, meth in methods:
            body += [f"- **`.{mname}{_signature(meth)}`** — "
                     f"{_doc_head(meth, 1)}"]
        return body + ([""] if methods else [])
    if callable(obj) and not inspect.ismodule(obj):
        return [f"### `{name}{_signature(obj)}`", "", _doc_head(obj, 2), ""]
    kind = (f"module `{obj.__name__}`" if inspect.ismodule(obj)
            else f"a `{type(obj).__name__}`")
    return [f"### `{name}`", "", f"*({kind})*", ""]


def generate() -> str:
    """The page's text."""
    lines = [
        "# API reference — bluefog_tpu_torch",
        "",
        "Generated from docstrings by `bluefog_tpu_torch/tools/gen_api_docs.py`",
        "— do not edit by hand.  The JAX package's page is `docs/API.md`;",
        "each module below is the counterpart of the JAX module of the same",
        "name (the Pallas modules: `ops.flash_attention`, `ops.flash_decode`,",
        "`ops.grouped_ffn`).",
        "",
        "Most names are re-exported at the top level: `import",
        "bluefog_tpu_torch as bf; bf.init(size=8); bf.neighbor_allreduce(...)`,",
        "`bf.optimizers.*`, `bf.topology.*`.",
        "",
    ]
    toc = ["## Contents", ""]
    body = []
    for mod_name, title in MODULES:
        mod = importlib.import_module(mod_name)
        anchor = mod_name.replace(".", "")
        toc.append(f"- [`{mod_name}` — {title}](#{anchor})")
        body += [f'<a name="{anchor}"></a>', "", f"## `{mod_name}` — {title}",
                 ""]
        mod_doc = _doc_head(mod, max_paras=1)
        if mod_doc != "*(no docstring)*":
            body += [mod_doc, ""]
        for name, obj in _members(mod):
            body += _entry(name, obj)
    return "\n".join(lines + toc + [""] + body).rstrip() + "\n"


def main(argv=None):
    out = generate()
    os.makedirs(os.path.dirname(PAGE), exist_ok=True)
    with open(PAGE, "w") as f:
        f.write(out)
    print(f"wrote {os.path.relpath(PAGE)} "
          f"({len(out.splitlines())} lines, {len(MODULES)} modules)")


if __name__ == "__main__":
    main()
