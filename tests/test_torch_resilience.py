"""The port's healing, elastic membership and skip-and-rollback
(``bluefog_tpu_torch/resilience.py`` with the peer-health table of
``diagnostics.py``) held against the JAX package's:

* the healed and membership weight matrices (``heal_schedule``,
  ``heal_topology``, ``membership_schedule`` with inactive, draining and
  warming ranks, ``heal_dynamic_schedules``) equal JAX's exactly, and so
  do the live context's tables after every step of a membership
  sequence (kill, admit with warmup, its ramp, retire with drain, leave);
* ``bootstrap_params`` pulls JAX's values (1e-6 in f32), refuses too few
  donors with JAX's text; a chaos ``join`` runs the whole protocol;
* the kill-2-join-3 acceptance run: the survivors' and then the joined
  ranks' consensus distances equal JAX's trajectory (rel 1e-5, f32) and
  contract monotonically;
* ``check_finite`` and the peer-health table agree with JAX's;
* the guard's rollback trajectory on the 16-16-5 MLP x 8 ranks in f64
  (NaN faults at calls 3 and 5, CTA with Adam) equals JAX's output at
  every call within 1e-12 x max|param|, the ring walk and its exhausted
  error in JAX's words, and the rollback writes into the caller's own
  tensors;
* ``regrow_world`` and its kin raise, naming ROADMAP queue 1, item 10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
from bluefog_tpu import diagnostics as jdiag
from bluefog_tpu import optimizers as jopt
from bluefog_tpu import resilience as jrz
from bluefog_tpu import schedule as jsch
from bluefog_tpu import topology as jtu
from bluefog_tpu.utils import chaos as jchaos
from bluefog_tpu.utils import flight as jflight
from bluefog_tpu.utils import metrics as jm
from bluefog_tpu_torch import diagnostics as tdiag
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch import resilience as trz
from bluefog_tpu_torch import schedule as tsch
from bluefog_tpu_torch import topology as ttu
from bluefog_tpu_torch.parallel import context as tctx
from bluefog_tpu_torch.utils import chaos as tchaos
from bluefog_tpu_torch.utils import flight as tflight
from bluefog_tpu_torch.utils import metrics as tm
import torch_cpu_threads  # noqa: F401  (the worker's thread share)
import torch_oracle as orc

N, D = 8, 16


@pytest.fixture(autouse=True)
def _clean():
    for m in (jm, tm):
        m.reset_metrics()
    for c in (jchaos, tchaos):
        c.uninstall()
    for r in (jrz, trz):
        r.reset()
    for d in (jdiag, tdiag):
        d.reset_peer_health()
    for f in (jflight, tflight):
        f.reset()
    yield
    for c in (jchaos, tchaos):
        c.uninstall()
    for r in (jrz, trz):
        r.reset()
    for d in (jdiag, tdiag):
        d.reset_peer_health()
    for f in (jflight, tflight):
        f.reset()


@pytest.fixture
def ctx(cpu_devices):
    jbf.init(devices=cpu_devices)
    jbf.set_topology(jtu.ExponentialTwoGraph(N), is_weighted=True)
    tctx.init(size=N, device="cpu")
    tctx.set_topology(ttu.ExponentialTwoGraph(N), is_weighted=True)
    yield
    tctx.shutdown()
    jbf.shutdown()


def _pair(name, *args, **kw):
    """The same topology in both packages."""
    return getattr(jtu, name)(*args, **kw), getattr(ttu, name)(*args, **kw)


def _W(mod, sched):
    return mod.schedule_weight_matrix(sched)


TOPOS = [("ExponentialTwoGraph", (8,)), ("RingGraph", (8,)),
         ("MeshGrid2DGraph", (9,)), ("StarGraph", (6,)),
         ("FullyConnectedGraph", (5,))]


@pytest.mark.parametrize("name,args", TOPOS, ids=[t[0] for t in TOPOS])
@pytest.mark.parametrize("weighted", [True, False])
def test_healed_and_membership_tables_equal_jax(name, args, weighted):
    jt, tt = _pair(name, *args)
    n = args[0]
    js, ts = (jsch.compile_topology(jt, weighted=weighted),
              tsch.compile_topology(tt, weighted=weighted))
    np.testing.assert_array_equal(_W(trz, ts), _W(jrz, js))
    cases = [dict(inactive=[1]), dict(inactive=[0, n - 1]),
             dict(draining=[2]), dict(entry_scale={1: 0.25}),
             dict(inactive=[3 % n], draining=[1], entry_scale={2: 0.5})]
    for kw in cases:
        np.testing.assert_array_equal(
            _W(trz, trz.membership_schedule(ts, **kw)),
            _W(jrz, jrz.membership_schedule(js, **kw)), err_msg=str(kw))
    for dead in ([1], [0, 2]):
        np.testing.assert_array_equal(_W(trz, trz.heal_schedule(ts, dead)),
                                      _W(jrz, jrz.heal_schedule(js, dead)))
        assert tsch.columns_stochastic(trz.heal_schedule(ts, dead))
    if weighted:
        from bluefog_tpu_torch import topology as ttopo
        from bluefog_tpu import topology as jtopo
        np.testing.assert_array_equal(
            ttopo.to_weight_matrix(trz.heal_topology(tt, [1])),
            jtopo.to_weight_matrix(jrz.heal_topology(jt, [1])))


def test_heal_refusals_and_dynamic_schedules():
    jt, tt = _pair("ExponentialTwoGraph", 8)
    js = jsch.compile_topology(jt, weighted=True)
    ts = tsch.compile_topology(tt, weighted=True)
    for bad in ([8], list(range(8))):
        with pytest.raises(ValueError) as je:
            jrz.heal_schedule(js, bad)
        with pytest.raises(ValueError) as te:
            trz.heal_schedule(ts, bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="entry scale"):
        trz.membership_schedule(ts, entry_scale={3: 0.0})
    jd = jsch.compile_dynamic_schedules(
        lambda r: jtu.GetDynamicOnePeerSendRecvRanks(jt, r), 8)
    td = tsch.compile_dynamic_schedules(
        lambda r: ttu.GetDynamicOnePeerSendRecvRanks(tt, r), 8)
    for a, b in zip(trz.heal_dynamic_schedules(td, [3]),
                    jrz.heal_dynamic_schedules(jd, [3])):
        np.testing.assert_array_equal(_W(trz, a), _W(jrz, b))


SEQUENCES = {
    "kill": [("mark_rank_dead", (3,), {})],
    "kill2_admit_warm": [("mark_rank_dead", (3, 5), {}),
                         ("admit_rank", (3,), {"warmup_steps": 2}),
                         ("advance_membership", (), {}),
                         ("advance_membership", (), {}),
                         ("advance_membership", (), {})],
    "retire_drain_leave": [("retire_rank", (2,), {}),
                           ("advance_membership", (), {}),
                           ("retire_rank", (6,), {"drain": False}),
                           ("admit_rank", (2, 6), {"warmup_steps": 1}),
                           ("advance_membership", (), {})],
    "dead_then_retire": [("mark_rank_dead", (1,), {}),
                         ("retire_rank", (1, 4), {}),
                         ("advance_membership", (), {}),
                         ("admit_rank", (1,), {})],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_live_membership_sequence_equals_jax(ctx, name):
    for fn, args, kw in SEQUENCES[name]:
        jr = getattr(jrz, fn)(*args, **kw)
        tr = getattr(trz, fn)(*args, **kw)
        assert tr == jr, (fn, tr, jr)
        np.testing.assert_array_equal(_W(trz, tctx.static_schedule()),
                                      _W(jrz, jbf.static_schedule()),
                                      err_msg=f"after {fn}{args}")
        assert trz.live_ranks() == jrz.live_ranks()
        assert trz.dead_ranks() == jrz.dead_ranks()
        assert trz.retired_ranks() == jrz.retired_ranks()
        assert tdiag.unhealthy_ranks() == jdiag.unhealthy_ranks()
        assert [tctx.in_neighbor_ranks(r) for r in range(N)] == \
            [list(jbf.in_neighbor_ranks(r)) for r in range(N)]
    for g in ("bluefog_dead_ranks", "bluefog_live_ranks"):
        assert tm.gauge(g).value() == jm.gauge(g).value()
    for change in ("dead", "join", "retire"):
        assert tm.counter("bluefog_membership_changes_total").value(
            change=change) == jm.counter(
                "bluefog_membership_changes_total").value(change=change)


def test_membership_refusals_equal_jax(ctx):
    for fn, args in (("retire_rank", tuple(range(N))),
                     ("mark_rank_dead", tuple(range(N))),
                     ("admit_rank", (N,)), ("retire_rank", (-1,))):
        with pytest.raises(ValueError) as je:
            getattr(jrz, fn)(*args)
        with pytest.raises(ValueError) as te:
            getattr(trz, fn)(*args)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="warmup_steps"):
        trz.admit_rank(1, warmup_steps=-1)


def _x():
    return np.random.default_rng(5).normal(size=(N, D)).astype(np.float32)


def test_bootstrap_params_pulls_jax_values(ctx):
    jrz.mark_rank_dead(3)
    trz.mark_rank_dead(3)
    x = _x()
    jout = jrz.bootstrap_params({"w": jbf.shard_distributed(
        jnp.asarray(x)), "n": jnp.arange(N)}, 3)
    tout = trz.bootstrap_params({"w": torch.from_numpy(x.copy()),
                                 "n": torch.arange(N)}, 3)
    np.testing.assert_allclose(tout["w"].numpy(), np.asarray(jout["w"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.delete(tout["w"].numpy(), 3, 0),
                                  np.delete(x, 3, 0))
    assert torch.equal(tout["n"], torch.arange(N))
    jboot = [e for e in jflight.events() if e["kind"] == "join"]
    tboot = [e for e in tflight.events() if e["kind"] == "join"]
    assert [(e["rank"], e["donors"]) for e in tboot] == \
        [(e["rank"], e["donors"]) for e in jboot]
    for mod, args in ((jrz, ({"w": jnp.asarray(x)}, 3)),
                      (trz, ({"w": torch.from_numpy(x)}, 3))):
        with pytest.raises(RuntimeError, match="bootstrap requires >= 4"):
            mod.bootstrap_params(*args, min_neighbors=4)
    with pytest.raises(ValueError, match="not live peers"):
        trz.bootstrap_params({"w": torch.from_numpy(x)}, 4, donors=[3, 5])


def test_chaos_join_runs_the_protocol_in_place(ctx):
    trz.mark_rank_dead(4)
    tchaos.install("join:step=2,rank=4,warmup=2")
    strat = topt.adapt_with_combine(
        topt.sgd(0.0), topt.neighbor_communicator(tctx.static_schedule()))
    params = {"w": torch.from_numpy(_x())}
    state = topt.init_distributed(strat, params)
    step = topt.make_train_step(
        lambda p, b: (torch.zeros(()), {"w": torch.zeros_like(p["w"])}),
        strat)
    batch = torch.zeros(N, 1)
    params, state, _ = step(params, state, batch)
    assert trz.dead_ranks() == (4,)
    params, state, _ = step(params, state, batch)        # join fires here
    held = params["w"]
    assert trz.live_ranks() == tuple(range(N))
    boots = [e for e in tflight.events()
             if e["kind"] == "join" and e.get("name") == "bootstrap"]
    assert boots and boots[0]["rank"] == 4 and len(boots[0]["donors"]) >= 2
    donors = boots[0]["donors"]
    # the joiner's row of the step's own output holds its donors' mean
    np.testing.assert_allclose(
        held[4].numpy(), held[donors].mean(0).numpy(), rtol=1e-6, atol=1e-6)
    assert trz.advance_membership()["warming"] == {4: 2 / 3}
    # an already-live rank: a no-op
    assert trz.chaos_join({"w": held}, 4)["w"] is held


def _gossip(mod_opt, mod_ctx, params, lib):
    """lr-0 CTA on the current (possibly edited) static schedule."""
    if lib == "jax":
        strat = jopt.adapt_with_combine(
            optax.sgd(0.0), jopt.neighbor_communicator(jbf.static_schedule()))
        step = jopt.make_train_step(
            lambda p, b: (jnp.zeros(()), jax.tree.map(jnp.zeros_like, p)),
            strat)
        return step, jopt.init_distributed(strat, params), \
            jnp.zeros((N, 1))
    strat = topt.adapt_with_combine(
        topt.sgd(0.0), topt.neighbor_communicator(tctx.static_schedule()))
    step = topt.make_train_step(
        lambda p, b: (torch.zeros(()), {"w": torch.zeros_like(p["w"])}),
        strat)
    return step, topt.init_distributed(strat, params), torch.zeros(N, 1)


def _kill2_join3(lib):
    rz = jrz if lib == "jax" else trz
    diag = jdiag if lib == "jax" else tdiag
    w0 = np.broadcast_to(np.arange(float(N))[:, None], (N, D)).astype(
        np.float32)
    params = ({"w": jnp.asarray(w0)} if lib == "jax"
              else {"w": torch.from_numpy(w0.copy())})
    rz.retire_rank(7, drain=False)
    rz.mark_rank_dead(3)
    rz.mark_rank_dead(5)
    gone = (3, 5, 7)
    step, state, batch = _gossip(None, None, params, lib)
    dist = [diag.diagnose_consensus(params, dead_ranks=gone)[
        "consensus_distance_max"]]
    for _ in range(6):
        params, state, _ = step(params, state, batch)
        dist.append(diag.diagnose_consensus(params, dead_ranks=gone)[
            "consensus_distance_max"])
    for r in (3, 5, 7):
        params = rz.join_rank(r, params, warmup_steps=2, min_neighbors=2)
    step, state, batch = _gossip(None, None, params, lib)
    dist2 = [diag.diagnose_consensus(params)["consensus_distance_max"]]
    for _ in range(8):
        params, state, _ = step(params, state, batch)
        if rz.advance_membership()["changed"]:
            step, state, batch = _gossip(None, None, params, lib)
        dist2.append(diag.diagnose_consensus(params)[
            "consensus_distance_max"])
    return dist, dist2, np.asarray(params["w"])


def test_kill2_join3_trajectory_equals_jax(ctx):
    jd, jd2, jw = _kill2_join3("jax")
    td, td2, tw = _kill2_join3("port")
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td2, jd2, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-5)
    assert all(b <= a + 1e-6 for a, b in zip(td, td[1:])), td
    assert all(b <= a + 1e-6 for a, b in zip(td2, td2[1:])), td2
    assert td2[-1] < 0.05 * td[0]
    assert trz.live_ranks() == tuple(range(N))


def test_check_finite_and_peer_health_equal_jax(ctx):
    x = _x()
    x[2, 3] = np.nan
    x[6, 0] = np.inf
    tree = {"a": x, "b": np.ones((N, 3), np.float32),
            "i": np.arange(N, dtype=np.int32)}
    jf = np.asarray(jdiag.check_finite(jax.tree.map(
        lambda a: jbf.shard_distributed(jnp.asarray(a)), tree)))
    tf = tdiag.check_finite({k: torch.from_numpy(v) for k, v in
                             tree.items()})
    np.testing.assert_array_equal(tf, jf)
    for mod, f in ((jdiag, jf), (tdiag, tf)):
        mod.observe_peer_finiteness(f, step=7)
        mod.observe_peer_finiteness(f, step=8)
        mod.record_peer_failure(1)
    assert tdiag.peer_health() == jdiag.peer_health()
    assert tdiag.unhealthy_ranks(streak=2) == jdiag.unhealthy_ranks(streak=2)
    for mod in (jdiag, tdiag):
        mod.clear_peer_failures([2])
    assert tdiag.peer_health() == jdiag.peer_health()
    assert tm.gauge("bluefog_peers_failed").value() == \
        jm.gauge("bluefog_peers_failed").value()


SPEC = "nan:step=3,rank=2;nan:step=5,rank=6"


def _guard_jax(cpu_devices, calls):
    x, y, p0 = orc.problem(0)
    out = []
    with jax.enable_x64(True):
        jbf.init(devices=cpu_devices[:N])
        try:
            strat = jopt.adapt_with_combine(
                optax.adam(0.05),
                jopt.neighbor_communicator(jbf.static_schedule()))
            guard = jrz.guard_step(
                jopt.make_train_step(orc.jax_grad_fn, strat, donate=False),
                depth=2)
            params = jopt.replicate(jax.tree.map(jnp.asarray, p0), N)
            state = jopt.init_distributed(strat, params)
            batch = (jnp.asarray(x), jnp.asarray(y, jnp.int32))
            jchaos.install(SPEC)
            for _ in range(calls):
                params, state, _ = guard(params, state, batch)
                out.append(orc.host(params))
            return out, (guard.calls, guard.nonfinite_steps, guard.rollbacks)
        finally:
            jchaos.uninstall()
            jbf.shutdown()


def test_guard_rollback_trajectory_equals_jax(cpu_devices):
    want, jcounts = _guard_jax(cpu_devices, 7)
    x, y, p0 = orc.problem(0)
    tctx.init(size=N, device="cpu")
    try:
        strat = topt.adapt_with_combine(
            topt.adam(0.05), topt.neighbor_communicator(
                tctx.static_schedule()))
        guard = trz.guard_step(topt.make_train_step(orc.port_grad_fn, strat),
                               depth=2)
        params = topt.replicate(orc.tensors(p0), N)
        state = topt.init_distributed(strat, params)
        batch = (torch.from_numpy(x), torch.from_numpy(y))
        tchaos.install(SPEC)
        for t in range(7):
            params, state, _ = guard(params, state, batch)
            orc.assert_params(params, want[t], f"call {t + 1}", 1e-12)
            if t + 1 in (3, 5):       # the optimizer's state restored too
                opt_state = state.opt_state.state
                assert all(torch.isfinite(v).all()
                           for st in opt_state.values()
                           for v in st.values())
        assert (guard.calls, guard.nonfinite_steps, guard.rollbacks) == \
            jcounts == (7, 2, 2)
        assert tdiag.peer_health()["last_bad_step"] == {2: 3, 6: 5}
        assert tm.counter("bluefog_nonfinite_steps_total").total() == 2
        rb = [e for e in tflight.events() if e["kind"] == "rollback"]
        assert [e["step"] for e in rb] == [3, 5]
    finally:
        tchaos.uninstall()
        tctx.shutdown()


def test_guard_walks_the_ring_and_restores_into_the_live_tensors(ctx):
    tchaos.install("nan:step=3,rank=2;nan:step=4,rank=2;nan:step=5,rank=2")
    strat = topt.adapt_with_combine(
        topt.sgd(0.1), topt.neighbor_communicator(tctx.static_schedule()))
    params = {"w": torch.from_numpy(_x())}
    state = topt.init_distributed(strat, params)
    step = topt.make_train_step(
        lambda p, b: (torch.zeros(()), {"w": p["w"] - b}), strat)
    batch = torch.zeros(N, D)
    made = []

    def recording(*a):
        out = step(*a)
        made.append(out[0]["w"])
        return out

    guard = trz.guard_step(recording, depth=2)
    params, state, _ = guard(params, state, batch)
    w1 = params["w"].clone()
    params, state, _ = guard(params, state, batch)
    w2 = params["w"].clone()
    assert not torch.equal(w1, w2)
    out = guard(params, state, batch)                     # -> S2
    assert guard.rollbacks == 1 and torch.equal(out[0]["w"], w2)
    assert out[0]["w"] is made[-1]          # written into the step's own
    assert out[1].step == 2                               # counter restored
    params, state, _ = out
    params, state, _ = guard(params, state, batch)        # -> S1
    assert guard.rollbacks == 2 and torch.equal(params["w"], w1)
    assert state.step == 1
    with pytest.raises(FloatingPointError,
                       match=r"ranks \[2\] at call 5 after 2 rollback\(s\), "
                             r"snapshot ring exhausted"):
        guard(params, state, batch)
    assert guard.nonfinite_steps == 3


def test_guard_without_snapshot_and_dead_mask(ctx):
    tchaos.install("nan:step=1,rank=0")
    strat = topt.adapt_with_combine(
        topt.sgd(0.0), topt.neighbor_communicator(tctx.static_schedule()))
    params = {"w": torch.from_numpy(_x())}
    state = topt.init_distributed(strat, params)
    step = topt.make_train_step(
        lambda p, b: (torch.zeros(()), {"w": torch.zeros_like(p["w"])}),
        strat)
    guard = trz.guard_step(step)
    with pytest.raises(FloatingPointError,
                       match=r"ranks \[0\] at call 1 with no good snapshot"):
        guard(params, state, torch.zeros(N, 1))
    tchaos.uninstall()
    # a dead rank's NaN row does not fail the verdict
    trz.mark_rank_dead(5)
    params = {"w": torch.from_numpy(_x())}
    state = topt.init_distributed(strat, params)
    tchaos.install("nan:step=1,rank=5")
    guard = trz.guard_step(step, check_every_k=2)
    params, state, _ = guard(params, state, torch.zeros(N, 1))
    params, state, _ = guard(params, state, torch.zeros(N, 1))
    assert guard.nonfinite_steps == 0 and len(guard._ring) == 1
    with pytest.raises(ValueError, match="depth must be >= 1"):
        trz.guard_step(step, depth=0)


def test_regrow_is_refused_naming_item_10():
    for fn, args in ((trz.regrow_world, (16,)), (trz.commit_regrow, ()),
                     (trz.regrow_pending, ()), (trz.RegrowHandle, ())):
        with pytest.raises(ValueError, match="ROADMAP queue 1, item 10"):
            fn(*args)
    assert trz.REGROW_PHASES == jrz.REGROW_PHASES
    e = trz.RegrowAborted("reinit", "deadline", rank=3)
    assert str(e) == str(jrz.RegrowAborted("reinit", "deadline", rank=3))
