"""The port's chaos drill read by the repo's own postmortem tools
(``tools/postmortem.py``, ``tools/metrics_report.py``: they import no
JAX and read the flight-bundle and metrics-JSONL schemas), as
``tests/test_lm_bench.py:233-257`` drives the JAX tool:

* the port's ``tools/lm_bench`` smoke on the CPU (dp 2 x pp 2 x tp 2, 8
  stacked peers, 2 warm-up and 6 timed steps) with rank 5 throttled from
  step 2: ``straggler.detected_ranks`` is [5], rank 5's time the table's
  largest; the flight bundle it dumps is blamed by postmortem (rank 5,
  the skew within 25 % of the throttle, the first chaos event at step 2,
  every chaos event on rank 5), and ``BLUEFOG_METRICS``' JSONL merges in
  metrics_report (the injected faults, the step count, the consensus
  series).  The throttle is 1 s, not JAX's 0.05: the detector's rule (a
  rank over 2x the median) needs the delay above the others' whole
  step, and the port's eager CPU step takes 0.1-0.5 s here;
* the watchdog's timeout names the last flight event and dumps the
  bundle first, as ``tests/test_flight.py`` holds the JAX one.
"""
import importlib.util
import json
import time
from pathlib import Path

import pytest

from bluefog_tpu_torch.tools import lm_bench
from bluefog_tpu_torch.utils import flight as tflight
from bluefog_tpu_torch.utils import metrics as tm
from bluefog_tpu_torch.utils import watchdog as twd
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

ROOT = Path(__file__).resolve().parents[1]
T = 1.0


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _clean():
    tflight.reset()
    tm.reset_metrics()
    yield
    tm.stop_metrics()
    tflight.reset()
    tm.reset_metrics()


def test_chaos_straggler_blamed_by_postmortem(tmp_path, monkeypatch,
                                              capsys):
    fdir = tmp_path / "flight"
    monkeypatch.setenv("BLUEFOG_METRICS", str(tmp_path / "m"))
    doc = lm_bench.main(
        ["--device", "cpu", "--iters", "6",
         "--chaos", f"throttle:from=2,until=99,t={T},rank=5",
         "--flight-dir", str(fdir)])
    monkeypatch.delenv("BLUEFOG_METRICS")
    metrics_path = tm.stop_metrics()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(doc))
    assert doc["ok"] and doc["chaos"].startswith("throttle:")
    assert doc["straggler"]["detected_ranks"] == [5]
    times = doc["straggler"]["step_times_s"]
    assert len(times) == 8 and max(times) == times[5]

    bundle = doc["flight_bundle"]
    assert Path(bundle).exists()
    rep = _tool("postmortem").report_from_files([bundle])
    assert rep["ok"] is True and rep["schema"] == "bluefog-flight-1"
    st = rep["step_time"]
    assert st["straggler_rank"] == 5
    assert st["skew_s"] == pytest.approx(T, rel=0.25)
    events = json.load(open(bundle))["events"]
    chaos = [e for e in events if e.get("kind") == "chaos"]
    assert chaos and min(e["step"] for e in chaos) == 2
    assert all(e["rank"] == 5 for e in chaos)
    cons = [e for e in events if e.get("kind") == "consensus"]
    assert cons[-1]["stragglers"] == [5]

    report = _tool("metrics_report").report_from_files([metrics_path])
    assert report["ok"] is True and report["n_samples"] >= 8
    m = report["metrics"]
    faults = m["bluefog_faults_injected_total"]["values"]
    assert faults['kind="throttle"'] == 7.0
    assert m["bluefog_step_time_s"]["count"] == 8
    assert len(report["series"]["bluefog_consensus_distance_max"]) >= 4
    assert report["summary"]["step_time_s"]["count"] == 8


def test_watchdog_timeout_names_last_flight_event(tmp_path, monkeypatch):
    tflight.set_dump_dir(str(tmp_path))
    tflight.record_op("neighbor_allreduce")
    monkeypatch.setattr(twd, "_block", lambda x: (time.sleep(10), x)[1])
    with pytest.raises(TimeoutError,
                       match=r"slowstep did not complete within 0\.15 s.*"
                             r"last event: neighbor_allreduce call 1"):
        twd.synchronize_with_watchdog(7, interval=0.04, name="slowstep",
                                      timeout=0.15)
    bundle = json.load(open(tmp_path / "flight_rank0.json"))
    assert bundle["reason"] == "watchdog_timeout"
    fail = [e for e in bundle["events"] if e["kind"] == "failure"]
    assert fail and fail[-1]["name"] == "watchdog_timeout"
    assert tm.counter("bluefog_watchdog_timeouts_total").value(
        name="slowstep") == 1
    rep = _tool("postmortem").report_from_files(
        [str(tmp_path / "flight_rank0.json")])
    assert rep["verdict"]["failure_kind"] == "watchdog_timeout"

    def boom(x):
        raise RuntimeError("device lost")

    monkeypatch.setattr(twd, "_block", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        twd.synchronize_with_watchdog(7, interval=60.0, timeout=5.0)
