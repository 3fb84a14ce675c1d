"""Process-local metrics registry + exporters (the port's own copy of
``bluefog_tpu/utils/metrics.py``, with its names, help texts and
semantics; it imports no JAX and nothing of the JAX package).

Counter/Gauge/Histogram primitives in one global registry, updated from
the hot paths of the serving estate: the scheduler's request, token and
latency metrics, the KV-cache slot and prefix gauges, the engine's
speculative-decoding counters, the refresher's staleness gauge and the
autoscaler's events.  JAX's retrace sentinel and its per-op and
per-step recorders have no caller in the port (its engine compiles no
programs; its trainer does not record steps) and are not copied.

Exporters, both optional and zero-cost when off; ``bf.init`` honors
their variables (:func:`maybe_start_from_env`), as JAX's does:

* JSONL log -- ``BLUEFOG_METRICS=<prefix>`` writes
  ``<prefix>.metrics.jsonl``, one snapshot line per :func:`sample` call.
* Prometheus text exposition -- ``start_http_server(port)`` (or
  ``BLUEFOG_METRICS_PORT``) serves ``/metrics`` and ``/healthz`` from a
  daemon thread (JAX's ``/fleet`` waits for a port of the fleet view).

Hot-path cost discipline: an update is a dict lookup + float add under one
lock; snapshots/serialization happen only in :func:`sample` or on scrape.
"""
from __future__ import annotations

import http.server
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .config import logger

__all__ = [
    "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram", "get_metric",
    "snapshot", "reset_metrics", "metrics_summary",
    "start_metrics", "stop_metrics", "metrics_active", "sample",
    "render_prometheus", "start_http_server", "stop_http_server",
    "mark_steady_state", "in_steady_state", "maybe_start_from_env",
]

_lock = threading.RLock()
_registry: Dict[str, "_Metric"] = {}

# step-time histogram buckets (seconds): spans CPU-test microsteps through
# multi-second pod steps
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, float("inf"),
)
_RESERVOIR = 1024          # last-N raw observations kept for percentiles


def _label_key(labels: Dict[str, str]) -> str:
    """Canonical prometheus-style label string ('' for unlabeled)."""
    if not labels:
        return ""
    return ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        # opt-in history ring (timeseries.arm attaches
        # one); unarmed metrics pay exactly this None on their hot path
        self._ts = None


class Counter(_Metric):
    """Monotonic float counter, optionally labeled (``c.inc(5, op="put")``)."""
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[str, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with _lock:
            self._values[key] = v = self._values.get(key, 0.0) + amount
        ts = self._ts
        if ts is not None:
            ts.append(v)

    def value(self, **labels) -> float:
        with _lock:
            return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        with _lock:
            return sum(self._values.values())

    def dump(self) -> dict:
        with _lock:
            return {"type": self.kind, "help": self.help,
                    "values": dict(self._values)}


class Gauge(_Metric):
    """Last-value metric (set wins; ``g.set(0.93)``)."""
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[str, float] = {}

    def set(self, value: float, **labels) -> None:
        with _lock:
            self._values[_label_key(labels)] = float(value)
        ts = self._ts
        if ts is not None:
            ts.append(value)

    def value(self, **labels) -> Optional[float]:
        with _lock:
            return self._values.get(_label_key(labels))

    def dump(self) -> dict:
        with _lock:
            return {"type": self.kind, "help": self.help,
                    "values": dict(self._values)}


class Histogram(_Metric):
    """Cumulative-bucket histogram plus a bounded raw reservoir.

    Buckets give the Prometheus exposition; the reservoir (last
    ``_RESERVOIR`` observations) gives exact percentiles for the bench
    artifact's summary block without unbounded memory.
    """
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        if self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)
        self._counts = [0] * len(self.buckets)
        self._count = 0
        self._sum = 0.0
        self._recent: deque = deque(maxlen=_RESERVOIR)

    def observe(self, value: float) -> None:
        v = float(value)
        with _lock:
            self._count += 1
            self._sum += v
            self._recent.append(v)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    break
        ts = self._ts
        if ts is not None:
            ts.append(v)

    def percentile(self, q: float) -> Optional[float]:
        """Exact percentile over the recent reservoir (None when empty)."""
        with _lock:
            if not self._recent:
                return None
            xs = sorted(self._recent)
        idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
        return xs[idx]

    def dump(self) -> dict:
        with _lock:
            return {
                "type": self.kind, "help": self.help,
                "count": self._count, "sum": self._sum,
                "buckets": [[b if b != float("inf") else "+Inf", c]
                            for b, c in zip(self.buckets, self._counts)],
            }


def _get_or_create(cls, name: str, help: str, **kw):
    with _lock:
        m = _registry.get(name)
        if m is None:
            m = cls(name, help, **kw)
            # re-attach an armed history ring across reset_metrics() —
            # guarded on the module already being loaded so processes
            # that never arm a ring skip the lookup entirely
            ts_mod = sys.modules.get("bluefog_tpu_torch.utils.timeseries")
            if ts_mod is not None:
                m._ts = ts_mod._ring_for(name)
            _registry[name] = m
        elif not isinstance(m, cls) and type(m) is not cls:
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}")
        elif help and not m.help:
            # a read-only accessor (``counter(name)``) may have created
            # the metric before the help-bearing site ran — backfill so
            # the exposition carries the doc regardless of call order
            m.help = help
        return m


def counter(name: str, help: str = "") -> Counter:
    return _get_or_create(Counter, name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _get_or_create(Gauge, name, help)


def histogram(name: str, help: str = "",
              buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    return _get_or_create(Histogram, name, help, buckets=buckets)


def get_metric(name: str) -> Optional[_Metric]:
    with _lock:
        return _registry.get(name)


def snapshot() -> Dict[str, dict]:
    """Point-in-time dump of every registered metric."""
    with _lock:
        metrics = list(_registry.values())
    return {m.name: m.dump() for m in metrics}


def reset_metrics() -> None:
    """Drop every metric and the steady-state flag (test isolation).
    Armed time-series rings keep their arming but drop their points —
    history must not leak across registry resets."""
    global _steady
    with _lock:
        _registry.clear()
        _steady = False
    ts_mod = sys.modules.get("bluefog_tpu_torch.utils.timeseries")
    if ts_mod is not None:
        ts_mod._clear_points()


# ---------------------------------------------------------------------------
# Steady state
# ---------------------------------------------------------------------------
# The serving engine flips the process into "steady state" once its warmup
# calls are done (JAX's retrace sentinel keys off the same flag).

_steady = False


def mark_steady_state(value: bool = True) -> None:
    global _steady
    with _lock:
        _steady = bool(value)


def in_steady_state() -> bool:
    return _steady


# ---------------------------------------------------------------------------
# JSONL exporter (BLUEFOG_METRICS — same contract as BLUEFOG_TIMELINE)
# ---------------------------------------------------------------------------

_jsonl_path: Optional[str] = None
_jsonl_file = None
_atexit_registered = False


def start_metrics(path_prefix: str) -> bool:
    """Begin appending snapshot lines to ``<prefix>.metrics.jsonl``."""
    global _jsonl_path, _jsonl_file, _atexit_registered
    with _lock:
        if _jsonl_path is not None:
            return False
        out = path_prefix + ".metrics.jsonl"
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        _jsonl_file = open(out, "a")
        _jsonl_path = out
        if not _atexit_registered:
            import atexit
            atexit.register(stop_metrics)
            _atexit_registered = True
    return True


def metrics_active() -> bool:
    return _jsonl_path is not None


def sample(step: Optional[int] = None) -> bool:
    """Append one snapshot line to the JSONL log (no-op when inactive)."""
    if _jsonl_path is None:
        return False
    line = {"ts": time.time(), "host": _host_id(), "step": step,
            "metrics": snapshot()}
    with _lock:
        f = _jsonl_file
        if f is None:
            return False
        f.write(json.dumps(line) + "\n")
        f.flush()
    return True


def stop_metrics() -> Optional[str]:
    """Write a final sample, close the log, return its path."""
    global _jsonl_path, _jsonl_file
    if _jsonl_path is None:
        return None
    sample()
    with _lock:
        out, _jsonl_path = _jsonl_path, None
        f, _jsonl_file = _jsonl_file, None
    if f is not None:
        f.close()
    return out


def _host_id() -> int:
    # the launcher bootstrap env (the stacked ranks of one process share
    # one registry)
    try:
        return int(os.environ.get("BLUEFOG_PROCESS_ID", "0"))
    except ValueError:
        return 0


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def render_prometheus() -> str:
    """Registry as Prometheus text format (one scrape)."""
    lines: List[str] = []
    for name, doc in sorted(snapshot().items()):
        if doc.get("help"):
            lines.append(f"# HELP {name} {doc['help']}")
        lines.append(f"# TYPE {name} {doc['type']}")
        if doc["type"] == "histogram":
            acc = 0
            for b, c in doc["buckets"]:
                acc += c
                le = b if b == "+Inf" else repr(float(b))
                lines.append(f'{name}_bucket{{le="{le}"}} {acc}')
            lines.append(f"{name}_sum {doc['sum']}")
            lines.append(f"{name}_count {doc['count']}")
        else:
            for key, v in sorted(doc["values"].items()):
                lines.append(f"{name}{{{key}}} {v}" if key else f"{name} {v}")
    return "\n".join(lines) + "\n"


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):                                    # noqa: N802
        path = self.path.split("?", 1)[0].rstrip("/")
        if path in ("", "/metrics"):
            self._reply(200, render_prometheus().encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
            return
        if path == "/healthz":
            with _lock:
                n_metrics = len(_registry)
            body = json.dumps({
                "status": "ok",
                "ts": time.time(),
                "pid": os.getpid(),
                "metrics": n_metrics,
            }).encode()
            self._reply(200, body, "application/json")
            return
        self.send_response(404)
        self.end_headers()

    def log_message(self, *a):                           # scrapes are not news
        pass


_http_server: Optional[http.server.ThreadingHTTPServer] = None


def start_http_server(port: int) -> int:
    """Serve ``/metrics`` on a daemon thread; returns the bound port
    (pass 0 for an ephemeral one)."""
    global _http_server
    with _lock:
        if _http_server is not None:
            return _http_server.server_address[1]
        srv = http.server.ThreadingHTTPServer(("0.0.0.0", port),
                                              _MetricsHandler)
        srv.daemon_threads = True
        _http_server = srv
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="bluefog-metrics-http").start()
    logger.info("metrics endpoint on :%d/metrics", srv.server_address[1])
    return srv.server_address[1]


def stop_http_server() -> None:
    global _http_server
    with _lock:
        srv, _http_server = _http_server, None
    if srv is not None:
        srv.shutdown()
        srv.server_close()


def maybe_start_from_env() -> None:
    """Honor ``BLUEFOG_METRICS`` / ``BLUEFOG_METRICS_PORT`` at init (the
    metrics analogue of timeline's ``BLUEFOG_TIMELINE`` hook)."""
    prefix = os.environ.get("BLUEFOG_METRICS")
    if prefix:
        start_metrics(prefix)
    port = os.environ.get("BLUEFOG_METRICS_PORT")
    if port:
        try:
            start_http_server(int(port))
        except (ValueError, OSError) as e:
            logger.warning("BLUEFOG_METRICS_PORT=%r: %s", port, e)


# ---------------------------------------------------------------------------
# Artifact summary (bench.py / hw_watch embed this)
# ---------------------------------------------------------------------------

def metrics_summary() -> dict:
    """Compact summary block for graded artifacts: step-time percentiles,
    comm bytes, cache hit ratio, consensus gauges, sentinel counters."""
    def _counter_total(name):
        m = get_metric(name)
        return m.total() if isinstance(m, Counter) else 0.0

    def _gauge_val(name):
        m = get_metric(name)
        return m.value() if isinstance(m, Gauge) else None

    out: dict = {}
    h = get_metric("bluefog_step_time_s")
    if isinstance(h, Histogram) and h._count:
        out["step_time_s"] = {
            "count": h._count,
            "mean": h._sum / h._count,
            "p50": h.percentile(50), "p90": h.percentile(90),
            "p99": h.percentile(99),
            "ewma": _gauge_val("bluefog_step_time_ewma_s"),
        }
    ops = get_metric("bluefog_ops_total")
    if isinstance(ops, Counter) and ops._values:
        out["ops"] = {k or "_": v for k, v in ops.dump()["values"].items()}
    out["comm_bytes_total"] = _counter_total("bluefog_op_bytes_total")
    hits = _counter_total("bluefog_compile_cache_hits_total")
    misses = _counter_total("bluefog_compile_cache_misses_total")
    out["cache"] = {
        "hits": hits, "misses": misses,
        "hit_ratio": hits / (hits + misses) if hits + misses else None,
    }
    consensus = {
        k.replace("bluefog_", ""): _gauge_val(k)
        for k in ("bluefog_consensus_distance_max",
                  "bluefog_consensus_distance_mean",
                  "bluefog_neighbor_disagreement_max",
                  "bluefog_window_staleness_max")
        if _gauge_val(k) is not None
    }
    if consensus:
        out["consensus"] = consensus
    out["retrace_after_warmup"] = _counter_total(
        "bluefog_retrace_after_warmup_total")
    out["watchdog_stalls"] = _counter_total("bluefog_watchdog_stalls_total")
    resilience = {
        "faults_injected": _counter_total("bluefog_faults_injected_total"),
        "nonfinite_steps": _counter_total("bluefog_nonfinite_steps_total"),
        "rank_restarts": _counter_total("bluefog_rank_restarts_total"),
        "watchdog_timeouts": _counter_total(
            "bluefog_watchdog_timeouts_total"),
        "dead_ranks": _gauge_val("bluefog_dead_ranks"),
        "membership_changes": _counter_total(
            "bluefog_membership_changes_total"),
        "live_ranks": _gauge_val("bluefog_live_ranks"),
    }
    if any(v for v in resilience.values()):
        out["resilience"] = resilience
    return out
