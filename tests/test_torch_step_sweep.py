"""The port's step sweep (``bluefog_tpu_torch/tools/step_sweep.py``)
against the JAX tool (``tools/step_sweep.py``): the same rows summarize to
the same dict, and a CPU run over two stacked ranks writes its rows, then
the complete summary."""
import importlib.util
import json
import os

import pytest
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

from bluefog_tpu_torch.tools import step_sweep as pss

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_step_sweep", os.path.join(REPO, "tools", "step_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROWS = [{"steps_per_call": 1, "imgs_per_sec_per_chip": 600.0, "mfu": 0.1},
        {"steps_per_call": 2, "imgs_per_sec_per_chip": 640.5, "mfu": 0.11},
        {"steps_per_call": 5, "imgs_per_sec_per_chip": 655.25, "mfu": None},
        {"steps_per_call": 10, "imgs_per_sec_per_chip": 650.0, "mfu": 0.1}]


@pytest.mark.parametrize("upto", [1, 2, 4])
@pytest.mark.parametrize("partial", [False, True])
def test_summarize_equals_the_jax_tool(upto, partial, tmp_path):
    jss = _jax_tool()
    rows = ROWS[:upto]
    assert pss._summarize("NVIDIA H100 80GB HBM3", 16, rows, partial) == \
        jss._summarize("NVIDIA H100 80GB HBM3", 16, rows, partial)
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    pss._write_summary(str(a), "cpu", 2, rows, partial)
    jss._write_summary(str(b), "cpu", 2, rows, partial)
    assert a.read_text() == b.read_text()


def test_cpu_sweep_writes_rows_then_the_summary(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    doc = pss.main(["--device", "cpu", "--ranks", "2", "--sweep", "2,1",
                    "--iters", "1", "--batch", "1", "--image-size", "32",
                    "--classes", "10", "--out", str(out),
                    "--trace", str(tmp_path / "trace")])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["steps_per_call"] for ln in lines[:2]] == [1, 2]
    assert all(ln["imgs_per_sec_per_chip"] > 0 and ln["mfu"] is None
               for ln in lines[:2])
    # the trace of the largest value's timed calls, analyzed beside the
    # rows: a CPU profile has no device track
    assert not lines[2]["trace_analysis"]["ok"]
    assert (tmp_path / "trace" / "step_sweep.pt.trace.json").exists()
    last = lines[-1]
    summary = json.loads(out.read_text())
    assert "partial" not in summary and summary["device"] == "cpu"
    assert summary["batch"] == 1 and len(summary["rows"]) == 2
    assert summary["rows"][0]["vs_spc1"] == 1.0
    assert last == {"summary": summary["dispatch_amortization"],
                    "best": max(summary["rows"],
                                key=lambda r: r["imgs_per_sec_per_chip"])}
    assert doc["rows"] == summary["rows"]
