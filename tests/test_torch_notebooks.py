"""The port's notebooks (``bluefog_tpu_torch/examples/*.ipynb``) against
the JAX package's (``examples/*.ipynb``): each notebook's code cells are
exec'd in order, the port's on the CPU over 8 stacked ranks
(``BLUEFOG_DEVICE=cpu``), JAX's on conftest's 8 virtual devices, and the
results compared — helloworld's rank values after 12 gossip steps and
after one dynamic period within 1e-6, the resource allocation's final
prices within 1e-5 (both notebooks' own asserts run too)."""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _exec(path):
    """Run the notebook's code cells in one namespace; returns it and the
    printed text."""
    with open(path) as f:
        cells = [c for c in json.load(f)["cells"]
                 if c["cell_type"] == "code"]
    ns, out = {}, io.StringIO()
    with contextlib.redirect_stdout(out):
        for i, c in enumerate(cells):
            exec(compile("".join(c["source"]), f"{path}[{i}]", "exec"), ns)
    return ns, out.getvalue()


def _pair(name, monkeypatch):
    import bluefog_tpu as jbf
    import bluefog_tpu_torch as tbf
    try:
        jns, _ = _exec(os.path.join(REPO, "examples", f"{name}.ipynb"))
    finally:
        jbf.shutdown()
    monkeypatch.setenv("BLUEFOG_DEVICE", "cpu")
    try:
        tns, text = _exec(os.path.join(REPO, "bluefog_tpu_torch", "examples",
                                       f"{name}.ipynb"))
    finally:
        tbf.shutdown()
    return jns, tns, text


def test_helloworld_matches_jax(cpu_devices, monkeypatch):
    jns, tns, text = _pair("interactive_helloworld", monkeypatch)
    assert "8 ranks on cpu" in text and "after one period:" in text
    for key in ("x", "y"):
        got = tns[key].numpy()
        want = np.asarray(jns[key])
        assert got.shape == want.shape == (8, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # one period of one-peer schedules reaches consensus
    assert np.ptp(tns["y"].numpy(), axis=0).max() < 1e-6


def test_resource_allocation_matches_jax(cpu_devices, monkeypatch):
    jns, tns, text = _pair("resource_allocation", monkeypatch)
    assert "OK: agents agreed on the optimal dispatch" in text
    np.testing.assert_allclose(tns["lam_final"], jns["lam_final"], rtol=0,
                               atol=1e-5)
    assert tns["lam_star"] == pytest.approx(jns["lam_star"], rel=1e-6)


def test_notebooks_default_to_the_card(monkeypatch):
    monkeypatch.delenv("BLUEFOG_DEVICE", raising=False)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    path = os.path.join(REPO, "bluefog_tpu_torch", "examples",
                        "resource_allocation.ipynb")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _exec(path)
