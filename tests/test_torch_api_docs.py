"""The port's API page (``bluefog_tpu_torch/docs/API.md``): the committed
page is what ``bluefog_tpu_torch/tools/gen_api_docs.py`` generates now,
byte for byte, and every name of each listed module's ``__all__`` has an
entry; the module list is the JAX generator's with the port's
counterparts."""
import importlib
import os

import torch_cpu_threads  # noqa: F401  (the worker's thread share)

from bluefog_tpu_torch.tools import gen_api_docs as gad

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_committed_page_is_a_fresh_generation():
    with open(gad.PAGE) as f:
        committed = f.read()
    assert gad.PAGE == os.path.join(REPO, "bluefog_tpu_torch", "docs",
                                    "API.md")
    assert committed == gad.generate(), (
        "regenerate: python -m bluefog_tpu_torch.tools.gen_api_docs")


def test_every_all_name_has_an_entry():
    page = gad.generate()
    for mod_name, _ in gad.MODULES:
        mod = importlib.import_module(mod_name)
        assert f"## `{mod_name}`" in page
        for name in getattr(mod, "__all__", ()):
            assert f"### `{name}" in page, (mod_name, name)


def test_module_list_is_the_jax_list_ported():
    with open(os.path.join(REPO, "tools", "gen_api_docs.py")) as f:
        src = f.read()
    jax_list = src[src.index("MODULES = ["):src.index("]\n", src.index(
        "MODULES = ["))]
    jax_mods = [ln.split('"')[1] for ln in jax_list.splitlines()
                if '("bluefog_tpu.' in ln]
    renamed = {"ops.pallas_attention": "ops.flash_attention",
               "ops.pallas_decode": "ops.flash_decode",
               "utils.hlo_bytes": "utils.wire_bytes"}
    dropped = {"parallel.exec_cache", "utils.torch_compat"}
    want = []
    for m in jax_mods:
        rel = m[len("bluefog_tpu."):]
        if rel in dropped:
            continue
        want.append("bluefog_tpu_torch." + renamed.get(rel, rel))
        if rel == "ops.pallas_decode":
            want.append("bluefog_tpu_torch.ops.grouped_ffn")
    assert [m for m, _ in gad.MODULES] == want
