"""The port's consensus probes (``bluefog_tpu_torch/diagnostics.py``)
against the JAX package's on 8 ranks: ``diagnose_consensus`` (the
per-rank distance to the mean, its max and mean, the neighbor
disagreement under the context's and a given schedule, with
``dead_ranks`` and with ``step_times``: the per-rank times, their skew,
the in-neighbors' max and the stragglers), its gauges and flight event,
``consensus_distance``, ``window_staleness`` over named windows, and
``detect_stragglers`` / ``observe_step_time`` / ``last_step_times``.
The probe flattens to float32 on both sides; the sums over ranks run in
another order, so the values agree to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
from bluefog_tpu import diagnostics as jdiag
from bluefog_tpu import schedule as jsch
from bluefog_tpu import topology as jtopo
from bluefog_tpu.utils import flight as jflight
from bluefog_tpu.utils import metrics as jmetrics
from bluefog_tpu_torch import diagnostics as tdiag
from bluefog_tpu_torch import schedule as tsch
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.parallel import context as tctx
from bluefog_tpu_torch.parallel import windows as tnw
from bluefog_tpu_torch.utils import flight as tflight
from bluefog_tpu_torch.utils import metrics as tmetrics
import bluefog_tpu_torch as tbf
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N = 8
GAUGES = ("bluefog_consensus_distance_max", "bluefog_consensus_distance_mean",
          "bluefog_neighbor_disagreement_max", "bluefog_window_staleness_max",
          "bluefog_step_time_skew", "bluefog_straggler_rank")


@pytest.fixture(autouse=True)
def _clean():
    for m in (jmetrics, tmetrics):
        m.reset_metrics()
    for f in (jflight, tflight):
        f.reset()
    yield
    for m in (jmetrics, tmetrics):
        m.reset_metrics()
    for f in (jflight, tflight):
        f.reset()


def _params():
    rng = np.random.default_rng(9)
    base = rng.normal(size=(5, 3))
    return {"a": {"w": (base[None] + 0.1 * rng.normal(size=(N, 5, 3)))
                  .astype(np.float32),
                  "b": rng.normal(size=(N, 4)).astype(np.float32)},
            "count": np.arange(N, dtype=np.int32)}


def _tree(tree, arr):
    if isinstance(tree, dict):
        return {k: _tree(v, arr) for k, v in tree.items()}
    return arr(tree)


TIMES = [0.10, 0.11, 0.10, 0.35, 0.10, 0.12, 0.10, 0.10]
# (id, schedule, dead ranks, step times)
CASES = [("static", None, (), None), ("ring", "ring", (), None),
         ("dead", None, (3,), None), ("dead2_ring", "ring", (0, 5), None),
         ("times", None, (), TIMES), ("times_dead", "ring", (3,), TIMES)]


def _sched(mod, topo_mod, kind):
    return (None if kind is None
            else mod.compile_topology(topo_mod.RingGraph(N), True))


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "t", "seq")}
            for e in events if e["kind"] == "consensus"]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_diagnose_consensus_matches_jax(cpu_devices, case):
    _, kind, dead, times = case
    p = _params()
    jbf.init(devices=cpu_devices[:N])
    try:
        jbf.set_topology(jtopo.ExponentialTwoGraph(N))
        want = jdiag.diagnose_consensus(
            _tree(p, jnp.asarray), schedule=_sched(jsch, jtopo, kind),
            dead_ranks=dead, step_times=times)
        want_dist = jdiag.consensus_distance(_tree(p, jnp.asarray))
        jg = {g: jmetrics.gauge(g).value() for g in GAUGES}
        jev = _strip(jflight.events())
    finally:
        jbf.shutdown()
    tctx.init(size=N, device="cpu")
    try:
        tctx.set_topology(ttopo.ExponentialTwoGraph(N))
        got = tdiag.diagnose_consensus(
            _tree(p, torch.from_numpy), schedule=_sched(tsch, ttopo, kind),
            dead_ranks=dead, step_times=times)
        got_dist = tdiag.consensus_distance(_tree(p, torch.from_numpy))
        tg = {g: tmetrics.gauge(g).value() for g in GAUGES}
        tev = _strip(tflight.events())
    finally:
        tctx.shutdown()
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (dict, tuple)):
            assert g == w, k
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got_dist, want_dist, rtol=1e-5, atol=1e-6)
    for r in dead:
        assert got["consensus_distance"][r] == 0.0
        assert got["neighbor_disagreement"][r] == 0.0
    for g in GAUGES:
        if jg[g] is None:
            assert tg[g] is None, g
        else:
            np.testing.assert_allclose(tg[g], jg[g], rtol=1e-5, err_msg=g)
    assert len(tev) == len(jev) == 1
    assert set(tev[0]) == set(jev[0])
    if times is not None:
        assert tev[0]["stragglers"] == jev[0]["stragglers"]
        assert tev[0]["step_times"] == jev[0]["step_times"]


def test_all_dead_is_refused_with_the_jax_text(cpu_devices):
    p = _params()
    msgs = []
    jbf.init(devices=cpu_devices[:N])
    try:
        with pytest.raises(ValueError) as e:
            jdiag.diagnose_consensus(_tree(p, jnp.asarray),
                                     dead_ranks=range(N))
        msgs.append(str(e.value))
        with pytest.raises(ValueError) as e:
            jdiag.diagnose_consensus(_tree(p, jnp.asarray),
                                     step_times=[1.0, 2.0])
        msgs.append(str(e.value))
    finally:
        jbf.shutdown()
    tctx.init(size=N, device="cpu")
    try:
        with pytest.raises(ValueError) as e:
            tdiag.diagnose_consensus(_tree(p, torch.from_numpy),
                                     dead_ranks=range(N))
        assert str(e.value) == msgs[0]
        with pytest.raises(ValueError) as e:
            tdiag.diagnose_consensus(_tree(p, torch.from_numpy),
                                     step_times=[1.0, 2.0])
        assert str(e.value) == msgs[1]
    finally:
        tctx.shutdown()


def test_window_staleness_matches_jax(cpu_devices):
    x = np.random.default_rng(2).normal(size=(N, 4)).astype(np.float32)

    def drive(mod, arr):
        mod.win_create(arr(x), "u")
        mod.win_create(arr(x), "v", zero_init=True)
        mod.win_put(arr(x), "u")
        mod.win_put(arr(x), "u")
        mod.win_accumulate(arr(x), "v")
        first = mod.diagnostics.window_staleness() \
            if hasattr(mod, "diagnostics") else None
        mod.win_update("v", reset=False)
        mod.win_update_then_collect("u")
        return first

    jbf.init(devices=cpu_devices[:N])
    try:
        jbf.set_topology(jtopo.ExponentialTwoGraph(N))
        drive(jbf, jnp.asarray)
        want = jdiag.window_staleness()
        jbf.win_free()
    finally:
        jbf.shutdown()
    tctx.init(size=N, device="cpu")
    try:
        tctx.set_topology(ttopo.ExponentialTwoGraph(N))
        drive(tbf, torch.from_numpy)
        got = tdiag.window_staleness()
        tnw.win_free()
    finally:
        tctx.shutdown()
    assert got == want == {"u": 0, "v": 1}


STRAGGLERS = [
    (TIMES, {}), (TIMES, {"factor": 3.5}), (TIMES, {"min_skew_s": 0.3}),
    (TIMES, {"dead_ranks": (3,)}),
    ([1.0, 5.0, 1.0, 4.0, 1.0, 1.0, 1.0, 1.0], {}),
    ([2.0] * N, {}), ([], {}), ([1.0, 9.0], {"dead_ranks": (0, 1)}),
]


def test_stragglers_and_step_times_match_jax(cpu_devices):
    for times, kw in STRAGGLERS:
        assert tdiag.detect_stragglers(times, **kw) == \
            jdiag.detect_stragglers(times, **kw), (times, kw)
    jbf.init(devices=cpu_devices[:N])
    tctx.init(size=N, device="cpu")
    try:
        for dt in (0.25, -1.0):
            want = jdiag.observe_step_time(dt)
            got = tdiag.observe_step_time(dt)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(tdiag.last_step_times(), want)
            assert tdiag.detect_stragglers() == jdiag.detect_stragglers()
        np.testing.assert_array_equal(tdiag.observe_step_time(0.5, size=3),
                                      jdiag.observe_step_time(0.5, size=3))
    finally:
        tctx.shutdown()
        jbf.shutdown()
    assert tdiag.observe_step_time(1.0) is None
