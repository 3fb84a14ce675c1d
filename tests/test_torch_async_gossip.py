"""The port's async window gossip against the JAX package on the CPU.

* The window stamps (``stamp_push``, ``staleness_depth``) equal JAX's
  tick by tick under a seeded activity sequence on Exp2(8) and on a ring,
  and ``async_mixing_matrices`` equals JAX's.
* ``async_window_gossip`` follows JAX's float64 trajectory within 1e-12 x
  max|param| over 12 ticks, from the start and from JAX's state after 6
  (``state_from_jax``), at K 0, at K 2 with rank 3 at pace 3, and at K 2
  with rank 3 at pace 8 (forced sync-ups fire), each with SGD, SGD with
  momentum 0.9 and Adam: an inactive rank's params, momentum, moments and
  Adam count stay frozen, as JAX's ``jnp.where`` leaves them.
* The port's ticks equal the host matrix model under a pace table, and K
  0 equals synchronous combine-then-adapt on the push weights
  (``tests/test_async_gossip.py:124`` and ``:218``, here on the port).
* The refusals keep JAX's texts; the knob resolves through
  ``set_async_gossip``, ``BLUEFOG_ASYNC`` and the default 4; the
  staleness probe publishes JAX's gauges and flight event; the adaptive
  controller follows JAX's recommendations and hysteresis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import bluefog_tpu as jbf
import bluefog_tpu.optimizers as jopt
from bluefog_tpu import diagnostics as jdiag
from bluefog_tpu import schedule as jsch
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import windows as jwops
from bluefog_tpu.utils import flight as jflight
from bluefog_tpu.utils import metrics as jmetrics
import bluefog_tpu_torch as tbf
from bluefog_tpu_torch import diagnostics as tdiag
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch import schedule as tsch
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import windows as twops
from bluefog_tpu_torch.parallel import context as tctx
from bluefog_tpu_torch.utils import flight as tflight
from bluefog_tpu_torch.utils import metrics as tmetrics
import torch_cpu_threads  # noqa: F401  (the worker's thread share)
from torch_oracle import N, run_both

D = 16


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


def _topo(mod, name):
    return (mod.ExponentialTwoGraph(N) if name == "exp2"
            else mod.RingGraph(N, connect_style=0))


# ---------------------------------------------------------------------------
# stamps, depth, the host model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo", ["exp2", "ring"])
def test_stamps_depth_and_mixing_match_jax(cpu_devices, topo):
    jsched = jopt.push_schedule(_topo(jtopo, topo), N)
    tsched = topt.push_schedule(_topo(ttopo, topo), N)
    K = max(jsched.max_in_degree, 1)
    mesh = Mesh(np.array(cpu_devices[:N]), ("rank",))

    def body(stamps, active, tick):
        st = jwops.stamp_push(stamps[0], tick[0], active[0], jsched)
        return st[None], jwops.staleness_depth(st, tick[0], jsched)[None]

    jfn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("rank"),) * 3,
                                out_specs=(P("rank"), P("rank"))))
    rng = np.random.RandomState(1234)
    jst = jnp.zeros((N, K), jnp.int32)
    tst = twops.stamp_create(tsched)
    assert tuple(tst.shape) == (N, K) and tst.dtype == torch.int32
    for tick in range(1, 16):
        active = rng.rand(N) < rng.uniform(0.15, 0.95)
        jst, jdepth = jfn(jst, jnp.asarray(active),
                          jnp.full((N,), tick, jnp.int32))
        tst = twops.stamp_push(tst, tick, torch.from_numpy(active), tsched)
        tdepth = twops.staleness_depth(tst, tick, tsched)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(tdepth.numpy(), np.asarray(jdepth))
        P_t, C_t = twops.async_mixing_matrices(tsched, active)
        P_j, C_j = jwops.async_mixing_matrices(jsched, active)
        np.testing.assert_array_equal(P_t, P_j)
        np.testing.assert_array_equal(C_t, C_j)
        np.testing.assert_allclose((C_t @ P_t).sum(axis=0), 1.0, atol=1e-12)
    with pytest.raises(ValueError, match="active must have shape"):
        twops.async_mixing_matrices(tsched, np.ones(3, bool))


def _zero_grad_fn(p, _):
    return torch.zeros(()), {k: torch.zeros_like(v) for k, v in p.items()}


def test_ticks_equal_the_host_matrix_model():
    """Under a pace table and no forced sync, the de-biased params equal
    ``(prod CP x) / (prod CP p)`` every tick (float64)."""
    tctx.init(size=N, device="cpu")
    try:
        sched = topt.push_schedule(ttopo.ExponentialTwoGraph(N), N)
        K = max(sched.max_in_degree, 1)
        pace = [1, 1, 2, 3, 1, 1, 1, 4]
        strat = topt.async_window_gossip(topt.sgd(0.0), sched,
                                         staleness_bound=50, pace=pace)
        step = topt.make_train_step(_zero_grad_fn, strat)
        x0 = np.random.RandomState(11).randn(N, D)
        params = {"w": torch.from_numpy(x0.copy())}
        state = topt.init_distributed(strat, params)
        m = N + N * K
        X = np.zeros((m, D))
        X[:N] = x0
        mass = np.zeros(m)
        mass[:N] = 1.0
        batch = torch.zeros((N, 1))
        for tick in range(12):
            params, state, _ = step(params, state, batch)
            active = np.array([tick % pace[r] == 0 for r in range(N)])
            Pm, Cm = twops.async_mixing_matrices(sched, active)
            X = Cm @ Pm @ X
            mass = Cm @ Pm @ mass
            np.testing.assert_allclose(params["w"].numpy(),
                                       X[:N] / mass[:N, None], rtol=0,
                                       atol=1e-12, err_msg=f"tick {tick}")
        local = state.comm_state.local_steps.numpy()
        assert local[0] == 12 and local[7] == 3, local
    finally:
        tctx.shutdown()


def test_k0_equals_synchronous_cta():
    """Bound 0 is combine-then-adapt on the same push weights (float64)."""
    tctx.init(size=N, device="cpu")
    try:
        sched = topt.push_schedule(ttopo.ExponentialTwoGraph(N), N)
        rng = np.random.RandomState(3)
        w0 = rng.randn(N, D)
        target = torch.from_numpy(rng.randn(D))

        def grad_fn(p, _):
            w = p["w"].detach().requires_grad_()
            loss = ((w - target) ** 2).mean()
            return loss.detach(), {"w": torch.autograd.grad(loss, w)[0]}

        def run(strat):
            step = topt.make_train_step(grad_fn, strat)
            params = {"w": torch.from_numpy(w0.copy())}
            state = topt.init_distributed(strat, params)
            traj = []
            for _ in range(12):
                params, state, _ = step(params, state, torch.zeros((N, 1)))
                traj.append(params["w"].clone())
            return traj

        a = run(topt.async_window_gossip(topt.sgd(0.05), sched,
                                         staleness_bound=0))
        b = run(topt.STRATEGIES["neighbor_cta"].build(
            topt.sgd(0.05), schedule=sched, wire=None, concurrent=None,
            delayed=False, num_steps_per_communication=1))
        assert max(float((x - y).abs().max()) for x, y in zip(a, b)) < 1e-12
        spread = [float((t - t.mean(0)).abs().max()) for t in (a[0], a[-1])]
        assert spread[1] < spread[0], spread
    finally:
        tctx.shutdown()


# ---------------------------------------------------------------------------
# the strategy against JAX, float64
# ---------------------------------------------------------------------------

OPTS = {"sgd": (lambda: optax.sgd(0.05), lambda: topt.sgd(0.05)),
        "momentum": (lambda: optax.sgd(0.05, momentum=0.9),
                     lambda: topt.sgd(0.05, momentum=0.9)),
        "adam": (lambda: optax.adam(0.01), lambda: topt.adam(0.01))}
# (id, staleness bound, pace)
CASES = [("k0", 0, None),
         ("k2_pace3", 2, [1, 1, 1, 3, 1, 1, 1, 1]),
         ("k2_pace8", 2, [1, 1, 1, 8, 1, 1, 1, 1])]


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_async_matches_jax(cpu_devices, case, opt):
    _, bound, pace = case
    jo, to = OPTS[opt]

    def make_jax():
        s = jopt.push_schedule(jbf.load_topology(), N)
        return jopt.async_window_gossip(jo(), s, staleness_bound=bound,
                                        pace=pace)

    def make_port():
        s = topt.push_schedule(tctx.load_topology(), N)
        return topt.async_window_gossip(to(), s, staleness_bound=bound,
                                        pace=pace)

    forced = []

    def check(t, params, state):
        forced.append(bool(state.comm_state.force.any()))

    (params, state), jstate = run_both(
        cpu_devices, make_jax, make_port, tag=f"{case[0]} {opt}",
        check=check)
    cs, jcs = state.comm_state, jstate.comm_state
    for f in ("stamps", "local_steps", "force", "depth"):
        np.testing.assert_array_equal(getattr(cs, f).numpy(),
                                      np.asarray(getattr(jcs, f)), f)
    np.testing.assert_allclose(cs.p.numpy(), np.asarray(jcs.p), rtol=1e-6)
    # the mass lane stays column-stochastic: values plus mailboxes sum to n
    assert abs(float(cs.p.double().sum() + cs.p_recv.double().sum()) - N) \
        < 1e-5
    local = cs.local_steps.numpy()
    if case[0] == "k2_pace8":
        assert any(forced) and local[3] > 12 // 8 + 1, (forced, local)
    if case[0] == "k2_pace3":
        assert local[3] < local[0] == 12, local
    if opt == "adam":
        counts = [st["step"].numpy() for st in
                  state.opt_state.state.values()]
        jcount = np.asarray(jax.tree.leaves(jstate.opt_state)[0])
        for c in counts:
            np.testing.assert_array_equal(c, jcount.astype(np.float32))


# ---------------------------------------------------------------------------
# refusals, the knob, the probe, the controller
# ---------------------------------------------------------------------------

def _texts(cpu_devices, build_j, build_t):
    jbf.init(devices=cpu_devices[:N])
    try:
        with pytest.raises(Exception) as ej:
            build_j()
    finally:
        jbf.shutdown()
    tctx.init(size=N, device="cpu")
    try:
        with pytest.raises(Exception) as et:
            build_t()
    finally:
        tctx.shutdown()
    assert type(et.value) is type(ej.value)
    assert str(et.value) == str(ej.value)
    return str(et.value)


def _dst_sched(mod):
    srcs = [{(r - 1) % N: 0.5} for r in range(N)]
    dsts = [{(r + 1) % N: 0.5} for r in range(N)]
    return mod.compile_from_weights(N, [0.5] * N, srcs, dsts)


def test_refusals_keep_the_jax_texts(cpu_devices):
    zj = {"w": jnp.zeros((N, D))}
    zt = {"w": torch.zeros((N, D))}
    text = _texts(
        cpu_devices,
        lambda: jopt.async_window_gossip(
            optax.sgd(0.1), _dst_sched(jsch)).init({"w": jnp.zeros(D)}),
        lambda: topt.async_window_gossip(
            topt.sgd(0.1), _dst_sched(tsch)).init(zt))
    assert "column-stochastic push" in text
    assert topt.strategy_constraint_violation(
        "async_window_gossip", schedule=_dst_sched(tsch)) == text
    text = _texts(
        cpu_devices,
        lambda: jopt.async_window_gossip(
            optax.sgd(0.1), staleness_bound=-1).init({"w": jnp.zeros(D)}),
        lambda: topt.async_window_gossip(
            topt.sgd(0.1), staleness_bound=-1).init(zt))
    assert "staleness_bound must be >= 0" in text

    def bad_pace_j():
        s = jopt.async_window_gossip(optax.sgd(0.0), staleness_bound=1,
                                     pace=[1, 2])
        step = jopt.make_train_step(
            lambda p, b: (jnp.zeros(()), jax.tree.map(jnp.zeros_like, p)),
            s, donate=False)
        step(zj, jopt.init_distributed(s, zj), jnp.zeros((N, 1)))

    def bad_pace_t():
        s = topt.async_window_gossip(topt.sgd(0.0), staleness_bound=1,
                                     pace=[1, 2])
        step = topt.make_train_step(_zero_grad_fn, s)
        step(zt, topt.init_distributed(s, zt), torch.zeros((N, 1)))

    assert "pace must be" in _texts(cpu_devices, bad_pace_j, bad_pace_t)


def test_knob_resolution_matches_jax(cpu_devices, monkeypatch):
    monkeypatch.delenv("BLUEFOG_ASYNC", raising=False)
    jbf.init(devices=cpu_devices[:N])
    tbf.init(size=N, device="cpu")
    try:
        for mod in (jbf, tbf):
            assert mod.async_gossip_bound() == 4          # the default
        assert tctx._DEFAULT_ASYNC_BOUND == \
            jbf.parallel.context._DEFAULT_ASYNC_BOUND
        monkeypatch.setenv("BLUEFOG_ASYNC", "7")
        assert jbf.async_gossip_bound() == tbf.async_gossip_bound() == 7
        for mod in (jbf, tbf):
            mod.set_async_gossip(2)
        assert jbf.async_gossip_bound() == tbf.async_gossip_bound() == 2
        # the strategy reads the knob when no bound is given
        s = topt.push_schedule(tctx.load_topology(), N)
        strat = topt.async_window_gossip(topt.sgd(0.0), s)
        state = strat.init({"w": torch.zeros((N, D))})
        assert state.comm_state.force.dtype == torch.bool
        for mod in (jbf, tbf):
            mod.set_async_gossip(None)
        assert jbf.async_gossip_bound() == tbf.async_gossip_bound() == 7
        for mod in (jbf, tbf):
            with pytest.raises(ValueError,
                               match="staleness bound must be >= 0"):
                mod.set_async_gossip(-3)
        monkeypatch.setenv("BLUEFOG_ASYNC", "-1")
        texts = []
        for mod in (jbf, tbf):
            with pytest.raises(ValueError) as e:
                mod.async_gossip_bound()
            texts.append(str(e.value))
        assert texts[0] == texts[1]
    finally:
        jbf.shutdown()
        tbf.shutdown()


def test_observe_async_staleness_matches_jax(cpu_devices):
    pace = [1, 1, 1, 4, 1, 1, 1, 1]
    jbf.init(devices=cpu_devices[:N])
    try:
        js = jopt.async_window_gossip(
            optax.sgd(0.0), jopt.push_schedule(jbf.load_topology(), N),
            staleness_bound=6, pace=pace)
        jstep = jopt.make_train_step(
            lambda p, b: (jnp.zeros(()), jax.tree.map(jnp.zeros_like, p)),
            js, donate=False)
        params = {"w": jnp.ones((N, D), jnp.float32)}
        state = jopt.init_distributed(js, params)
        for _ in range(4):
            params, state, _ = jstep(params, state, jnp.zeros((N, 1)))
        jflight.reset()
        want = jdiag.observe_async_staleness(state)
        want_ev = [e for e in jflight.events() if e["kind"] ==
                   "async_staleness"]
    finally:
        jbf.shutdown()
    tctx.init(size=N, device="cpu")
    try:
        ts = topt.async_window_gossip(
            topt.sgd(0.0), topt.push_schedule(tctx.load_topology(), N),
            staleness_bound=6, pace=pace)
        tstep = topt.make_train_step(_zero_grad_fn, ts)
        params = {"w": torch.ones((N, D))}
        state = topt.init_distributed(ts, params)
        for _ in range(4):
            params, state, _ = tstep(params, state, torch.zeros((N, 1)))
        tflight.reset()
        got = tdiag.observe_async_staleness(state)
        got_ev = [e for e in tflight.events() if e["kind"] ==
                  "async_staleness"]
        assert tdiag.observe_async_staleness(object()) is None
    finally:
        tctx.shutdown()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), k)
    assert got["staleness_depth_max"] >= 2
    for name in ("bluefog_async_staleness_steps",
                 "bluefog_async_forced_sync"):
        assert tmetrics.gauge(name).value() == jmetrics.gauge(name).value()
        assert tmetrics.get_metric(name).help == \
            jmetrics.get_metric(name).help
    strip = lambda e: {k: v for k, v in e.items() if k not in ("ts", "t", "seq")}
    assert [strip(e) for e in got_ev] == [strip(e) for e in want_ev]


STEP_TIMES = [
    [1.0] * N,                                  # no spread: K 0
    [1.0, 1.0, 1.0, 3.5, 1.0, 1.0, 1.0, 1.0],   # a 3.5x straggler: K 3
    [1.0, 1.0, 1.0, 3.5, 1.0, 1.0, 1.0, 1.0],
    [1.0, 1.0, 1.0, 3.4, 1.0, 1.0, 1.0, 1.0],   # third agreeing: applied
    [1.0, 1.0, 1.0, 9.0, 1.0, 1.0, 1.0, 1.0],   # K 8, then a flap
    [1.0, 1.0, 1.0, 1.2, 1.0, 1.0, 1.0, 1.0],
    [1.0, 1.0, 1.0, 40.0, 1.0, 1.0, 1.0, 1.0],  # clamped at k_max
    [1.0, 1.0, 1.0, 40.0, 1.0, 1.0, 1.0, 1.0],
    [1.0, 1.0, 1.0, 40.0, 1.0, 1.0, 1.0, 1.0],
    [1.0, float("inf"), 1.0, 1.0, 2.0, 1.0, 1.0, 1.0],
    [0.0] * N,
]


@pytest.mark.parametrize("dead", [(), (3,)])
def test_controller_matches_jax(cpu_devices, dead):
    def drive(mod_opt, ctx):
        c = mod_opt.AdaptiveStalenessController(k_max=12, patience=3,
                                                dead_ranks=dead)
        out = []
        for t in STEP_TIMES:
            out.append((c.recommend(t), c.observe(t), c.current_bound,
                        c.applied))
        return out

    jbf.init(devices=cpu_devices[:N])
    try:
        jbf.set_async_gossip(0)
        want = drive(jopt, jbf)
        jev = [e for e in jflight.events() if e["kind"] == "async_bound"]
        jg = jmetrics.gauge("bluefog_async_staleness_bound").value()
    finally:
        jbf.shutdown()
    tctx.init(size=N, device="cpu")
    try:
        tbf.set_async_gossip(0)
        got = drive(topt, tbf)
        tev = [e for e in tflight.events() if e["kind"] == "async_bound"]
        tg = tmetrics.gauge("bluefog_async_staleness_bound").value()
        # with no table observed yet, nothing to recommend
        tdiag._last_step_times = None
        assert topt.AdaptiveStalenessController().recommend() is None
    finally:
        tctx.shutdown()
    assert got == want
    assert tg == jg
    strip = lambda e: {k: v for k, v in e.items() if k not in ("ts", "t", "seq")}
    assert [strip(e) for e in tev] == [strip(e) for e in jev]
    for bad in ({"k_min": 3, "k_max": 1}, {"patience": 0}):
        msgs = []
        for mod in (jopt, topt):
            with pytest.raises(ValueError) as e:
                mod.AdaptiveStalenessController(**bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
