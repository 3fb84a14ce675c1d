"""CPU parity of the port's host registries with the JAX package's.

The same seeded operation sequences go through ``bluefog_tpu.utils``'
metrics, time series, tracing and flight recorder and through the
port's copies (``bluefog_tpu_torch.utils``), and everything a reader
sees must be equal: ``snapshot()``, the Prometheus text, histogram
percentiles, windowed time-series reads at explicit timestamps, span
records and the trace report built from them, flight events and
registered blocks.  ``SLOEngine`` burn rates and tripwires are compared
on one injected time series, and the scale file round trips through
both ``_write_scale`` / ``_read_scale`` pairs.  Exact equality
throughout: both sides run the same float64 Python arithmetic.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from bluefog_tpu import diagnostics as jdiag
from bluefog_tpu.run import launcher as jlaunch
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu.utils import flight as jflight
from bluefog_tpu.utils import metrics as jmetrics
from bluefog_tpu.utils import timeseries as jts
from bluefog_tpu.utils import tracing as jtracing
from bluefog_tpu_torch import diagnostics as tdiag
from bluefog_tpu_torch.run import launcher as tlaunch
from bluefog_tpu_torch.tools import trace_report as ttrace_report
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import flight as tflight
from bluefog_tpu_torch.utils import metrics as tmetrics
from bluefog_tpu_torch.utils import timeseries as tts
from bluefog_tpu_torch.utils import tracing as ttracing
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": (jmetrics, jts, jtracing, jflight),
         "port": (tmetrics, tts, ttracing, tflight)}


def _reset_all():
    for m, ts, tr, fl in SIDES.values():
        m.reset_metrics()
        ts.reset()
        tr.reset()
        fl.reset()


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


def _metric_ops(seed):
    """A seeded sequence of registry updates, as (kind, name, args)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(60):
        k = rng.integers(0, 4)
        lab = {} if rng.random() < 0.4 else {
            "replica": str(rng.integers(0, 3))}
        if k == 0:
            ops.append(("counter", f"c{rng.integers(0, 3)}_total",
                        float(rng.integers(1, 5)), lab))
        elif k == 1:
            ops.append(("gauge", f"g{rng.integers(0, 2)}",
                        float(rng.normal()), lab))
        elif k == 2:
            ops.append(("gauge", "e", float(rng.exponential()), lab))
        else:
            ops.append(("histogram", "lat_seconds",
                        float(rng.exponential(0.05)), {}))
    return ops


def _apply_metrics(m, ops):
    for kind, name, v, lab in ops:
        if kind == "counter":
            m.counter(name, "a counter").inc(v, **lab)
        elif kind == "gauge":
            m.gauge(name, "a gauge").set(v, **lab)
        else:
            m.histogram(name, "a histogram",
                        buckets=(.001, .01, .05, .1, .5)).observe(v)
    m.mark_steady_state(True)
    h = m.get_metric("lat_seconds")
    return {"snapshot": m.snapshot(), "prometheus": m.render_prometheus(),
            "summary": m.metrics_summary(),
            "percentiles": [h.percentile(q) if h else None
                            for q in (0, 1, 50, 90, 99, 100)],
            "steady": m.in_steady_state()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_registry_matches_jax(seed):
    ops = _metric_ops(seed)
    got = {side: _apply_metrics(mods[0], ops)
           for side, mods in SIDES.items()}
    assert got["port"] == got["jax"]
    assert "lat_seconds_bucket" in got["port"]["prometheus"]


def test_metrics_jsonl_sample_and_http_endpoint(tmp_path):
    """The JSONL exporter writes one snapshot a ``sample``; the HTTP
    endpoint serves the same exposition text and /healthz."""
    import urllib.request
    tmetrics.counter("bluefog_x_total", "x").inc(3, op="put")
    assert tmetrics.start_metrics(str(tmp_path / "m"))
    assert tmetrics.sample(step=1)
    path = tmetrics.stop_metrics()
    line = json.loads(open(path).read().strip().splitlines()[-1])
    assert line["metrics"]["bluefog_x_total"]["values"] == {'op="put"': 3.0}
    port = tmetrics.start_http_server(0)
    try:
        base = f"http://localhost:{port}"
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        assert text == tmetrics.render_prometheus()
        health = json.loads(urllib.request.urlopen(base + "/healthz").read())
        assert health["status"] == "ok"
        assert health["metrics"] == len(tmetrics.snapshot())
    finally:
        tmetrics.stop_http_server()


def test_timeseries_reads_match_jax():
    rng = np.random.default_rng(7)
    stamps = np.cumsum(rng.exponential(0.5, 200)) + 1000.0
    vals = rng.exponential(0.1, 200)
    out = {}
    for side, (m, ts, _, _) in SIDES.items():
        ts.arm("lat", capacity=128)
        ts.arm("bluefog_c_total")
        for t, v in zip(stamps, vals):
            ts.append("lat", float(v), ts=float(t))
        m.counter("bluefog_c_total", "c").inc(2)      # armed: appends
        now = float(stamps[-1])
        out[side] = {
            "armed": ts.armed_metrics(), "latest": ts.latest("lat"),
            "history": ts.history("lat", 10.0, now),
            "reads": [(ts.percentile("lat", q, w, now),
                       ts.over_fraction("lat", 0.1, w, now),
                       ts.rate("lat", w, now), ts.mean("lat", w, now))
                      for q in (50, 99) for w in (None, 5.0, 30.0)],
            "counter_pts": [v for _, v in ts.history("bluefog_c_total")]}
    assert out["port"] == out["jax"]
    assert len(out["port"]["history"]) > 3


def test_tracing_spans_and_report_match_jax(tmp_path):
    """Spans at explicit timestamps, the same trace ids, and the latency
    breakdown of ``report_from_files`` (the port's copy against the JAX
    tool) over each side's flushed bundle."""
    spec = importlib.util.spec_from_file_location(
        "jax_trace_report", os.path.join(REPO, "tools", "trace_report.py"))
    jtrace_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtrace_report)
    rng = np.random.default_rng(3)
    plan = []
    for i in range(6):
        t = 50.0 + 3 * i
        q, p = rng.uniform(0, .5), rng.uniform(0, .2)
        plan.append((t, q, p, [rng.uniform(0, .1) for _ in range(3)]))
    reports = {}
    for side, (_, _, tr, _) in SIDES.items():
        assert not tr.enabled()
        assert tr.add_span("x", "off", 0.0, 1.0) == 0   # disarmed: no-op
        tr.configure(str(tmp_path / side))
        ids = []
        for t, q, p, decs in plan:
            tid = tr.new_trace("req")
            ids.append(tid)
            tr.add_span(tid, "queue", t, t + q, cat="serve", replica=0)
            tr.add_span(tid, "prefill", t + q, t + q + p, cat="serve",
                        hit=bool(len(ids) % 2))
            c = t + q + p
            for d in decs:
                tr.add_span(tid, "decode", c, c + d, cat="serve", tokens=2)
                c += d + 0.01
            tr.add_span(tid, "request", t, c + 0.02, cat="serve", tokens=6,
                        replica=0, requeued=0)
        tr.add_span("train-r0-1", "train_step", 1.0, 1.5, cat="train")
        with tr.span("engine-r0-9", "decode_call", cat="engine", S=4) as sp:
            pass
        assert sp.id > 0
        spans = [{k: v for k, v in s.items() if k not in ("t0", "t1")}
                 if s["name"] == "decode_call" else s for s in tr.spans()]
        bundle = tr.flush()
        with open(bundle) as f:
            lines = [json.loads(x) for x in f]
        assert lines[0]["kind"] == "meta" and lines[0]["n_spans"] == len(
            spans)
        rep = (ttrace_report if side == "port" else
               jtrace_report).report_from_files([bundle])[0]
        reports[side] = (ids, spans, tr.dropped(), rep)
    assert reports["port"] == reports["jax"]
    rep = reports["port"][3]
    assert len(rep["requests"]) == 6 and rep["train"]["steps"] == 1
    for row in rep["requests"].values():
        parts = row["queue_s"] + row["prefill_s"] + row["decode_s"] + \
            row["gap_s"]
        assert abs(parts - row["total_s"]) < 1e-9


def test_flight_events_and_blocks_match_jax(tmp_path):
    bundles = {}
    for side, (m, ts, _, fl) in SIDES.items():
        fl.record("serve", name="warmup", batch_buckets=[1, 2])
        fl.record("train", step=3, loss=0.5)
        fl.record_op("neighbor_allreduce")
        fl.note_failure("boom", detail="x")
        fl.register_block("serve", lambda: {"replicas": 2, "failed": []})
        fl.register_block("gone", lambda: {"a": 1})
        fl.unregister_block("gone")
        m.counter("bluefog_requests_total", "r").inc(status="done")
        ts.arm("bluefog_serve_p99_s")
        ts.append("bluefog_serve_p99_s", 0.2, ts=5.0)
        path = fl.dump(str(tmp_path / f"{side}.json"), reason="parity")
        doc = json.loads(open(path).read())
        drop = ("ts", "pid")
        doc["events"] = [{k: v for k, v in e.items() if k not in drop}
                         for e in doc["events"]]
        doc["timeseries"]["anchor"] = None
        for key in drop:
            doc.pop(key)
        # the port has no timeline, so no open timeline spans to carry;
        # the JAX process's timeline holds none either
        assert doc.pop("open_spans") == ({} if side == "jax" else None)
        bundles[side] = (doc, fl.last_event()["kind"], len(fl.events()))
    assert bundles["port"] == bundles["jax"]
    doc = bundles["port"][0]
    assert doc["serve"] == {"replicas": 2, "failed": []} and "gone" not in doc


class _StubSched:
    def __init__(self):
        self.completed, self.failed = [], []
        self.pending = self.in_flight = 0


def _slo_run(diag, m, ts):
    rng = np.random.default_rng(11)
    eng = diag.SLOEngine(p99_ms=50.0, ttft_ms=200.0, availability=0.9,
                         window_scale=0.01, step_baseline_n=4,
                         idle_steps=2, tripwire_cooldown=3)
    sched = _StubSched()
    out = []
    for i in range(40):
        now = 100.0 + i
        for _ in range(5):
            ts.append("bluefog_serve_token_latency_seconds",
                      float(rng.exponential(0.04 if i < 20 else 0.2)),
                      ts=now - rng.uniform(0, 1))
        ts.append("bluefog_serve_ttft_cold_seconds",
                  float(rng.exponential(0.1)), ts=now)
        ts.append("bluefog_step_time_s", 0.1 if i < 25 else 0.4, ts=now)
        ts.append("bluefog_consensus_distance_max",
                  float(1.0 / (i + 1) if i < 30 else i), ts=now)
        sched.completed += [object()] * int(rng.integers(0, 3))
        if i % 7 == 6:
            sched.failed.append(object())
        sched.pending, sched.in_flight = (3, 0) if 30 <= i < 34 else (0, 1)
        res = eng.observe(sched, now=now)
        out.append((sorted(res["burn_rates"].items()),
                    [(f["kind"], sorted((k, v) for k, v in f.items()
                                        if k != "kind"))
                     for f in res["tripwires"]]))
    return out, eng.breached(1.0), m.snapshot()


def test_slo_engine_burn_rates_and_tripwires_match_jax():
    got = {side: _slo_run(diag, mods[0], mods[1])
           for side, diag, mods in (("jax", jdiag, SIDES["jax"]),
                                    ("port", tdiag, SIDES["port"]))}
    assert got["port"] == got["jax"]
    kinds = {k for _, fired in got["port"][0] for k, _ in fired}
    assert {"slo_fast_burn", "step_time_regression", "consensus_stall",
            "queue_growth_idle"} <= kinds
    with pytest.raises(ValueError, match="availability"):
        tdiag.SLOEngine(availability=1.0)


def test_scale_file_round_trips_match_jax(tmp_path, capsys):
    for side, mod in (("jax", jlaunch), ("port", tlaunch)):
        d = tmp_path / side / "deep"
        path = str(d / "bluefog_scale")
        assert mod._read_scale(path) is None            # absent: silent
        mod._write_scale(path, 6)
        assert open(path).read() == "6\n"
        assert mod._read_scale(path) == 6
        assert mod._read_scale(path, min_world=8) is None
        with open(path, "w") as f:
            f.write("six")
        assert mod._read_scale(path) is None
    err = capsys.readouterr().err
    assert err.count("malformed scale file") == 2
    assert err.count("below the minimum world size") == 2


def test_env_readers_match_jax(monkeypatch):
    for raw in (None, "1", "true", "off", "7", "2.5"):
        if raw is None:
            monkeypatch.delenv("BLUEFOG_PARITY_KNOB", raising=False)
        else:
            monkeypatch.setenv("BLUEFOG_PARITY_KNOB", raw)
        for fn in ("env_flag", "env_int", "env_float"):
            def call(mod):
                try:
                    return getattr(mod, fn)("BLUEFOG_PARITY_KNOB", None)
                except ValueError as e:
                    return ("error", str(e))
            assert call(tconfig) == call(jconfig)


def test_init_arms_the_exporters_from_env(tmp_path, monkeypatch):
    """``bf.init`` honors the exporters' variables as JAX's init does:
    BLUEFOG_METRICS starts the JSONL log, BLUEFOG_METRICS_PORT the HTTP
    endpoint, BLUEFOG_FLIGHT_DIR arms the dump and its crash handlers,
    BLUEFOG_TRACE arms the tracer; the init lands in the flight ring.
    With none set, nothing is armed."""
    import bluefog_tpu_torch as bf
    env = {"BLUEFOG_METRICS": str(tmp_path / "m"),
           "BLUEFOG_METRICS_PORT": "0",
           "BLUEFOG_FLIGHT_DIR": str(tmp_path / "flight"),
           "BLUEFOG_TRACE": str(tmp_path / "trace")}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BLUEFOG_FLIGHT_EVENTS", raising=False)
    try:
        bf.init(size=2, device="cpu")
        assert tmetrics.metrics_active()
        assert tmetrics._http_server is not None
        assert tflight.dump_dir() == env["BLUEFOG_FLIGHT_DIR"]
        assert tflight._handlers_installed
        assert ttracing.enabled()
        ev = tflight.last_event()
        assert (ev["kind"], ev["name"], ev["devices"]) == (
            "lifecycle", "init", 2)
    finally:
        bf.shutdown()
        tmetrics.stop_metrics()
        tmetrics.stop_http_server()
    _reset_all()
    for k in env:
        monkeypatch.delenv(k)
    bf.init(size=2, device="cpu")
    try:
        assert not tmetrics.metrics_active()
        assert tmetrics._http_server is None
        assert not tflight.enabled() and not tflight._handlers_installed
        assert not ttracing.enabled()
    finally:
        bf.shutdown()
