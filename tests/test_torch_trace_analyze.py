"""The port's trace analyzer (``bluefog_tpu_torch/tools/trace_analyze.py``)
against the JAX tool (``tools/trace_analyze.py``), and the ``bluefog::``
comm ranges of the port's collectives that it reads.

* every TPU-shaped fixture of ``tests/test_trace_tools.py`` gives the JAX
  tool's dict;
* a hand-written Kineto-shaped trace (kernels, a memcpy and a memset, the
  moves' ranges on the host thread linked by correlation, a nested range,
  a launch on another thread, a ``gpu_user_annotation``, an NCCL kernel,
  host noise) gives numbers checkable by hand;
* a CPU ``torch.profiler`` run of ``neighbor_allreduce`` and of a tp
  ``psum`` exports their ranges in both directions, with gradients equal
  to an unprofiled run; with no profiler no range is entered.
"""
import gzip
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

from bluefog_tpu_torch import schedule as tsched
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import collectives as tcoll
from bluefog_tpu_torch.parallel.tensor_parallel import RowParallelDense
from bluefog_tpu_torch.tools import trace_analyze as pta
from test_trace_tools import _trace_doc

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_trace_analyze", os.path.join(REPO, "tools", "trace_analyze.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tpu_fixtures():
    ev = _trace_doc()["traceEvents"]
    xs = [e for e in ev if e["ph"] == "X"]
    out = {"trace_doc": ev, "no_metadata": xs,
           "one_pid": [e for e in xs if e["pid"] == 1], "empty": []}
    for name in ("obs_trace", "overlap_trace"):
        with open(os.path.join(FIXTURES, f"{name}.trace.json")) as f:
            out[name] = json.load(f)["traceEvents"]
    return out


@pytest.mark.parametrize("name", sorted(_tpu_fixtures()))
def test_tpu_fixtures_give_the_jax_dict(name):
    events = _tpu_fixtures()[name]
    assert pta.analyze(events) == _jax_tool().analyze(events)


def test_helpers_match_the_jax_tool():
    jta = _jax_tool()
    ivs = [(5.0, 9.0), (0.0, 3.0), (2.0, 4.0), (8.0, 12.0)]
    assert pta.merge(list(ivs)) == jta.merge(list(ivs))
    merged, _ = pta.merge(ivs)
    assert pta.subtract(merged, [[1.0, 6.0]]) == \
        jta.subtract(merged, [[1.0, 6.0]])
    for name in ("collective-permute-start.5", "all-reduce.2.1", "", "x"):
        assert pta.canonical_op(name) == jta.canonical_op(name)
    assert pta.COMM_RE.pattern == jta.COMM_RE.pattern
    assert pta.DEVICE_RE.pattern == jta.DEVICE_RE.pattern


def test_find_trace_file_reads_the_port_names(tmp_path):
    for name in ("a.pt.trace.json", "b.device_trace.json"):
        d = tmp_path / name.split(".")[0]
        d.mkdir()
        (d / name).write_text("{}")
        assert pta.find_trace_file(str(d)) == str(d / name)
    with pytest.raises(FileNotFoundError):
        pta.find_trace_file(str(tmp_path / "nothing"))


def _kineto_doc():
    """Host pid 100 (thread 100 launches, thread 101 another thread),
    device pid 0 (streams 7 and 8); times in ms (the trace's us x 1000).

    Ranges on thread 100: ``bluefog::psum`` [10, 20), ``bluefog::
    neighbor_allreduce`` [40, 60) holding ``bluefog::cross`` [50, 55).
    Device work (launch ms, thread -> class):
      gemm      [0, 100)    1 @100   compute
      index_sel [80, 130)   12 @100  comm, bluefog::psum
      relu      [95, 100)   15 @101  compute (the range is another thread's)
      memcpy    [150, 190)  30 @100  compute
      memset    [190, 250)  35 @100  compute
      nccl      [200, 210)  (none)   comm, by its name
      add       [210, 220)  52 @100  comm, bluefog::cross (innermost)
      zero-dur  [240, 240)  57 @100  dropped (no duration)
    compute [0, 100) + [150, 250) = 200; comm [80, 130) + [200, 220) =
    70; exposed [100, 130) = 30; busy [0, 130) + [150, 250) = 230; wall
    250; idle [130, 150) = 20; overlap 1 - 30 / 70."""
    ms = 1000.0

    def x(cat, name, pid, tid, t0, dur, corr=None):
        ev = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
              "ts": t0 * ms, "dur": dur * ms, "args": {}}
        if corr is not None:
            ev["args"]["correlation"] = corr
        return ev

    dev = [
        x("kernel", "sgemm_128x64", 0, 7, 0, 100, 1),
        x("kernel", "indexSelectLargeIndex", 0, 8, 80, 50, 2),
        x("kernel", "relu_kernel", 0, 7, 95, 5, 3),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 0, 7, 150, 40, 4),
        x("gpu_memset", "Memset (Device)", 0, 7, 190, 60, 5),
        x("kernel", "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)", 0, 8,
          200, 10, 6),
        x("kernel", "elementwise_add", 0, 8, 210, 10, 7),
        x("kernel", "empty_kernel", 0, 8, 240, 0, 8),
    ]
    host = [
        x("user_annotation", "bluefog::psum", 100, 100, 10, 10),
        x("user_annotation", "bluefog::neighbor_allreduce", 100, 100, 40,
          20),
        x("user_annotation", "bluefog::cross", 100, 100, 50, 5),
        x("cuda_runtime", "cudaLaunchKernel", 100, 100, 1, 0.01, 1),
        x("cuda_runtime", "cudaLaunchKernel", 100, 100, 12, 0.01, 2),
        x("cuda_runtime", "cudaLaunchKernel", 100, 101, 15, 0.01, 3),
        x("cuda_runtime", "cudaMemcpyAsync", 100, 100, 30, 0.01, 4),
        x("cuda_runtime", "cudaMemsetAsync", 100, 100, 35, 0.01, 5),
        x("cuda_runtime", "cudaLaunchKernel", 100, 100, 52, 0.01, 7),
        x("cuda_driver", "cuLaunchKernel", 100, 100, 57, 0.01, 8),
        x("cpu_op", "aten::mm", 100, 100, 0, 500),
        x("gpu_user_annotation", "bluefog::psum", 0, 8, 80, 50),
    ]
    # torch 2.11's Kineto: every process named "python", the card's
    # labelled "GPU 0"
    meta = [{"ph": "M", "name": "process_name", "pid": 100,
             "args": {"name": "python"}},
            {"ph": "M", "name": "process_labels", "pid": 100,
             "args": {"labels": "CPU"}},
            {"ph": "M", "name": "process_name", "pid": 0,
             "args": {"name": "python"}},
            {"ph": "M", "name": "process_labels", "pid": 0,
             "args": {"labels": "GPU 0"}}]
    return {"schemaVersion": 1, "traceEvents": meta + host + dev}


def test_kineto_trace_arithmetic():
    out = pta.analyze(_kineto_doc()["traceEvents"])
    assert out["ok"] and out["n_events"] == 7
    assert out["wall_ms"] == 250.0 and out["busy_ms"] == 230.0
    assert out["compute_ms"] == 200.0 and out["comm_ms"] == 70.0
    assert out["comm_exposed_ms"] == 30.0 and out["idle_ms"] == 20.0
    assert out["overlap_fraction"] == round(1 - 30 / 70, 4)
    assert out["n_comm_ranges"] == 3 and out["device_tracks"] == ["GPU 0"]
    assert out["top_exposed_comm_ops"] == [
        {"name": "bluefog::psum", "count": 1, "total_ms": 50.0,
         "exposed_ms": 30.0},
        {"name": "bluefog::cross", "count": 1, "total_ms": 10.0,
         "exposed_ms": 0.0},
        {"name": "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)",
         "count": 1, "total_ms": 10.0, "exposed_ms": 0.0}]


def test_kineto_refusals_name_what_is_missing(tmp_path):
    ev = _kineto_doc()["traceEvents"]
    host_only = [e for e in ev if e.get("cat") not in pta.DEVICE_CATS]
    out = pta.analyze(host_only)
    assert not out["ok"] and "no CUDA device events" in out["error"]
    # the moves' launches unlinked: ranges but no comm
    unlinked = [dict(e, args={}) if e.get("cat") in ("cuda_runtime",
                                                     "cuda_driver") else e
                for e in ev
                if "nccl" not in e.get("name", "")]
    out = pta.analyze(unlinked)
    assert not out["ok"] and "3 bluefog:: ranges" in out["error"]
    path = tmp_path / "cpu.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": host_only}))
    out = pta.analyze_file(str(tmp_path))
    assert not out["ok"] and out["error"].startswith(str(path))


def test_cli_on_the_kineto_trace(tmp_path):
    run = tmp_path / "run1"
    run.mkdir()
    with gzip.open(run / "x.pt.trace.json.gz", "wt") as f:
        json.dump(_kineto_doc(), f)
    out = tmp_path / "split.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.tools.trace_analyze",
         str(tmp_path), "--out", str(out)],
        capture_output=True, text=True, timeout=60, cwd=REPO, env=env)
    assert p.returncode == 0, p.stderr
    doc = json.loads(p.stdout.strip().splitlines()[-1])
    assert doc == json.load(open(out))
    assert doc["comm_exposed_ms"] == 30.0
    (run / "x.pt.trace.json.gz").unlink()
    (run / "cpu.pt.trace.json").write_text(json.dumps({"traceEvents": [
        e for e in _kineto_doc()["traceEvents"]
        if e.get("cat") not in pta.DEVICE_CATS]}))
    p = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.tools.trace_analyze",
         str(tmp_path)], capture_output=True, text=True, timeout=60,
        cwd=REPO, env=env)
    assert p.returncode == 1 and '"ok": false' in p.stdout


def _moves(seed=0):
    """A gossip round set and a tp row-parallel dense with its backward;
    returns the leaves' gradients."""
    torch.manual_seed(seed)
    sched = tsched.compile_topology(ttopo.ExponentialTwoGraph(8))
    x = torch.randn(8, 6, requires_grad=True)
    y = tcoll.neighbor_allreduce(x * 1.5, sched)
    dense = RowParallelDense(8, 5, tp=2)
    torch.nn.init.normal_(dense.kernel)
    h = torch.randn(2, 3, 4, requires_grad=True)
    z = dense(h)
    loss = (y ** 2).sum() + (z ** 3).sum()
    with torch.autograd.profiler.record_function("test::backward"):
        loss.backward()
    return [x.grad, h.grad, dense.kernel.grad, dense.bias.grad]


def test_profiled_moves_export_ranges_both_ways(tmp_path):
    plain = _moves()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = _moves()
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    path = str(tmp_path / "moves.pt.trace.json")
    prof.export_chrome_trace(path)
    ev = pta.load_events(path)
    ann = [e for e in ev if e.get("cat") == "user_annotation"]
    bwd = [e for e in ann if e["name"] == "test::backward"]
    assert len(bwd) == 1
    b0, b1 = bwd[0]["ts"], bwd[0]["ts"] + bwd[0]["dur"]
    for op in ("bluefog::neighbor_allreduce", "bluefog::psum"):
        spans = [e for e in ann if e["name"] == op]
        fwd = [e for e in spans if e["ts"] < b0]
        back = [e for e in spans if b0 <= e["ts"] < b1]
        assert fwd and back, (op, len(fwd), len(back))
    # on the CPU there is no device track to split
    out = pta.analyze_file(path)
    assert not out["ok"] and "no CUDA device events" in out["error"]


def test_no_profiler_enters_no_range(monkeypatch):
    entered = []

    class Spy:
        def __init__(self, name, *a, **kw):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    grads = _moves(seed=1)
    assert all(g is not None for g in grads)
    assert entered == ["test::backward"]
    assert tcoll._range("psum") is tcoll._NO_RANGE
    a = torch.randn(2, 4, 6, 8, requires_grad=True)
    for out in (tcoll.all_to_all(a, 0, 2, 3),
                tcoll.ppermute(a, 0, [(0, 1), (1, 0)]),
                tcoll.peer_sum(a, 0), tcoll.allreduce(a[0])):
        out.sum().backward()
    assert entered == ["test::backward"]
    assert np.isfinite(a.grad.numpy()).all()
