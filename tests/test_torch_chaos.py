"""The port's fault injection (``bluefog_tpu_torch/utils/chaos.py``) held
against the JAX package's ``utils/chaos.py``:

* every fault kind parses to JAX's ``Fault`` fields (the same dataclass
  values, exactly), and every bad clause fails with JAX's message;
* a seeded ``p=`` plan draws the same fault sequence (steps, eager-op
  calls, regrow attempts) in both packages;
* the hook sites on 8 stacked ranks: an eager-op NaN hits only the
  target rank's row (JAX's eager op the same row), an eager-op kill
  raises ``RankKilled``, a train-step kill / throttle fires at JAX's
  steps with JAX's counters, a train-step NaN corrupts only the target
  row of the live params, the window moves pass the hook, the delay
  ledger moves a throttle onto its rank in the step-time table;
* across processes a rank-targeted fault fires only in the process whose
  block of rows holds the rank;
* with no plan installed the hook sites are inert: no telemetry, the
  same values as the JAX step.
Tolerances: the train steps are compared to JAX's within 1e-6 (f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
from bluefog_tpu import optimizers as jopt
from bluefog_tpu import topology as jtu
from bluefog_tpu.utils import chaos as jchaos
from bluefog_tpu.utils import metrics as jm
from bluefog_tpu_torch import api as tapi
from bluefog_tpu_torch import diagnostics as tdiag
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch import topology as ttu
from bluefog_tpu_torch.parallel import context as tctx
from bluefog_tpu_torch.parallel import windows as twin
from bluefog_tpu_torch.utils import chaos as tchaos
from bluefog_tpu_torch.utils import flight as tflight
from bluefog_tpu_torch.utils import metrics as tm
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N, D = 8, 16

SPECS = [
    "seed=42; kill:step=30,rank=3,code=7; nan:step=10,rank=2; "
    "hang:step=5,t=2.5; throttle:from=7,until=20,t=0.05; "
    "nan:op=neighbor_allreduce,call=3,rank=1",
    "seed=7;kill:step=4,rank=3;join:step=12,rank=3,warmup=2",
    "join:step=5,rank=1",
    "zones=2;preempt:step=4,zone=1,grace=2,regrant=30",
    "preempt:p=0.25,rank=3,grace=1",
    "kill_coordinator:step=1;kill_joiner:step=2,rank=5;"
    "hang_reinit:p=1.0,t=2",
    "hang:op=*,call=5,t=0.01;kill:op=allreduce,p=0.3,rank=2",
]

BAD = [
    ("explode:step=1", "unknown chaos fault kind"),
    ("hang:step=1", "needs t="),
    ("throttle:from=1,until=2", "needs t="),
    ("nan:step=1", "needs rank="),
    ("join:step=1", "needs rank="),
    ("join:op=neighbor_allreduce,rank=1", "not eager ops"),
    ("join:call=2,rank=1", "not eager ops"),
    ("join:step=1,rank=1,warmup=-1", "warmup must be >= 0"),
    ("kill:", "needs a trigger"),
    ("kill:p=1.5", "p must be in"),
    ("kill:step=1,zap=2", "unknown chaos parameter"),
    ("kill:step", "expected key=value"),
    ("seedling=3", "expected 'seed=N'"),
    ("preempt:step=1", "needs rank="),
    ("preempt:step=1,rank=1,zone=0", "rank= OR zone="),
    ("preempt:step=1,rank=1,grace=-1", "grace/regrant must be >= 0"),
    ("preempt:op=x,call=1,rank=1", "match train steps"),
    ("kill:step=1,zone=1", "only apply to preempt"),
    ("kill_coordinator:op=x,call=1", "regrow-phase attempts"),
    ("zones=2;preempt:step=1,zone=2", "out of range"),
]


@pytest.fixture(autouse=True)
def _clean():
    for m in (jm, tm):
        m.reset_metrics()
    jchaos.uninstall()
    tchaos.uninstall()
    tflight.reset()
    yield
    jchaos.uninstall()
    tchaos.uninstall()
    tflight.reset()
    for m in (jm, tm):
        m.reset_metrics()


@pytest.fixture
def ctx():
    tctx.init(size=N, device="cpu")
    tctx.set_topology(ttu.ExponentialTwoGraph(N), is_weighted=True)
    yield
    tctx.shutdown()


@pytest.fixture
def jctx(cpu_devices):
    jbf.init(devices=cpu_devices)
    jbf.set_topology(jtu.ExponentialTwoGraph(N), is_weighted=True)
    yield
    jbf.shutdown()


@pytest.mark.parametrize("spec", SPECS)
def test_every_kind_parses_to_the_jax_fields(spec):
    j, t = jchaos.ChaosPlan.parse(spec), tchaos.ChaosPlan.parse(spec)
    assert (t.seed, t.zones) == (j.seed, j.zones)
    assert [dataclasses.asdict(f) for f in t.faults] == \
        [dataclasses.asdict(f) for f in j.faults]
    assert [f.is_op_fault for f in t.faults] == \
        [f.is_op_fault for f in j.faults]
    assert tchaos._KINDS == jchaos._KINDS


@pytest.mark.parametrize("bad,msg", BAD, ids=[b for b, _ in BAD])
def test_bad_clauses_fail_with_the_jax_message(bad, msg):
    with pytest.raises(ValueError) as je:
        jchaos.ChaosPlan.parse(bad)
    with pytest.raises(ValueError, match=msg) as te:
        tchaos.ChaosPlan.parse(bad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("spec", [
    "seed=7;kill:p=0.1", "seed=8;kill:p=0.1;throttle:p=0.3,t=0.01",
    "seed=3;nan:p=0.2,rank=1;join:p=0.05,rank=2",
    "seed=11;hang:op=neighbor_allreduce,p=0.2,t=0.01;nan:op=*,p=0.1,rank=0",
    "seed=5;hang_reinit:p=0.4,t=1;kill_coordinator:p=0.3"])
def test_seeded_draws_equal_the_jax_sequence(spec):
    j, t = jchaos.ChaosPlan.parse(spec), tchaos.ChaosPlan.parse(spec)

    def steps(plan):
        return [(s, [f.kind for f in plan.match_step(s)])
                for s in range(1, 1500) if plan.match_step(s)]

    def ops(plan):
        return [(c, op, [f.kind for f in plan.match_op(op, c)])
                for op in ("neighbor_allreduce", "allreduce")
                for c in range(1, 500) if plan.match_op(op, c)]

    def regrow(plan):
        return [(p, a, [f.kind for f in plan.match_regrow(p, a)])
                for p in ("quiesce", "handshake", "reinit", "joiner_pull")
                for a in range(1, 200) if plan.match_regrow(p, a)]

    assert steps(t) == steps(j)
    assert ops(t) == ops(j)
    assert regrow(t) == regrow(j)
    assert steps(t) or ops(t) or regrow(t)
    assert [j.bump_op("x"), j.bump_op("x"), j.bump_op("y")] == \
        [t.bump_op("x"), t.bump_op("x"), t.bump_op("y")]


def test_install_uninstall_env_and_zone_victims(monkeypatch):
    assert not tchaos.active()
    plan = tchaos.install("kill:step=1")
    assert tchaos.active() and tchaos.current_plan() is plan
    tchaos.uninstall()
    with pytest.raises(TypeError):
        tchaos.install(42)
    monkeypatch.setenv(tchaos.ENV_VAR, "nan:step=2,rank=0")
    assert tchaos.maybe_install_from_env()
    assert not tchaos.maybe_install_from_env()      # already armed
    tchaos.uninstall()
    monkeypatch.delenv(tchaos.ENV_VAR)
    assert not tchaos.maybe_install_from_env()
    for z in range(4):
        assert tchaos.zone_victims(z, 16, 4) == jchaos.zone_victims(z, 16, 4)
    with pytest.raises(ValueError, match="out of range"):
        tchaos.zone_victims(4, 16, 4)


def test_init_arms_and_shutdown_disarms(monkeypatch):
    monkeypatch.setenv(tchaos.ENV_VAR, "kill:step=99")
    tctx.init(size=N, device="cpu")
    try:
        assert tchaos.active()
    finally:
        tctx.shutdown()
    assert not tchaos.active()


def _x():
    return np.random.default_rng(3).normal(size=(N, D)).astype(np.float32)


def test_eager_op_nan_hits_only_the_target_row(ctx, jctx):
    jchaos.install("nan:op=neighbor_allreduce,call=2,rank=1")
    tchaos.install("nan:op=neighbor_allreduce,call=2,rank=1")
    x = _x()
    jx = jbf.shard_distributed(jnp.asarray(x))
    outs = []
    for _ in range(2):
        j = np.asarray(jbf.synchronize(jbf.neighbor_allreduce(jx)))
        t = tapi.neighbor_allreduce(torch.from_numpy(x)).numpy()
        outs.append((j, t))
    np.testing.assert_allclose(outs[0][1], outs[0][0], rtol=1e-6, atol=1e-6)
    j2, t2 = outs[1]
    assert np.array_equal(np.isnan(t2), np.isnan(j2))
    assert np.isnan(t2[1]).all() and np.isfinite(np.delete(t2, 1, 0)).all()
    np.testing.assert_allclose(np.delete(t2, 1, 0), np.delete(j2, 1, 0),
                               rtol=1e-6, atol=1e-6)
    assert tm.counter("bluefog_faults_injected_total").value(kind="nan") \
        == jm.counter("bluefog_faults_injected_total").value(kind="nan") == 1
    chaos_ev = [e for e in tflight.events() if e["kind"] == "chaos"]
    assert [e["name"] for e in chaos_ev] == ["nan:neighbor_allreduce"]


def test_eager_op_kill_raises(ctx):
    tchaos.install("kill:op=allreduce,call=1,rank=2")
    with pytest.raises(tchaos.RankKilled) as ei:
        tapi.allreduce(torch.ones(N, D))
    assert ei.value.rank == 2 and ei.value.code == tchaos.DEFAULT_KILL_CODE
    assert str(ei.value) == str(jchaos.RankKilled(2, 1))


def _step_pair(sgd_lr=0.0):
    """The same lr-0 (or lr) CTA step in both packages over 8 ranks."""
    w0 = np.broadcast_to(np.arange(float(N))[:, None], (N, D)).astype(
        np.float32)
    jstrat = jopt.adapt_with_combine(
        optax.sgd(sgd_lr), jopt.neighbor_communicator(jbf.static_schedule()))
    jp = {"w": jnp.asarray(w0)}
    jstate = jopt.init_distributed(jstrat, jp)
    jstep = jopt.make_train_step(
        lambda p, b: (jnp.mean((p["w"] - b) ** 2),
                      jax.grad(lambda q: jnp.mean((q["w"] - b) ** 2))(p)),
        jstrat)

    def tgrad(p, b):
        w = p["w"].detach().requires_grad_()
        loss = torch.mean((w - b) ** 2)
        return loss.detach(), {"w": torch.autograd.grad(loss, w)[0]}

    tstrat = topt.adapt_with_combine(
        topt.sgd(sgd_lr), topt.neighbor_communicator(tctx.static_schedule()))
    tp = {"w": torch.from_numpy(w0.copy())}
    tstate = topt.init_distributed(tstrat, tp)
    tstep = topt.make_train_step(tgrad, tstrat)
    batch = np.zeros((N, D), np.float32)
    return (jstep, jp, jstate, jnp.asarray(batch)), \
        (tstep, tp, tstate, torch.from_numpy(batch))


def test_train_step_kill_and_throttle_as_jax(ctx, jctx):
    spec = "throttle:from=1,until=2,t=0.01;kill:step=3,rank=5"
    jchaos.install(spec)
    tchaos.install(spec)
    (js, jp, jst, jb), (ts, tp, tst, tb) = _step_pair()
    for _ in range(2):
        jp, jst, _ = js(jp, jst, jb)
        tp, tst, _ = ts(tp, tst, tb)
    for step, args, mod in ((js, (jp, jst, jb), jchaos),
                            (ts, (tp, tst, tb), tchaos)):
        with pytest.raises(mod.RankKilled) as ei:
            step(*args)
        assert ei.value.rank == 5 and ei.value.step == 3
    for m in (jm, tm):
        c = m.counter("bluefog_faults_injected_total")
        assert c.value(kind="throttle") == 2 and c.value(kind="kill") == 1
    # the failure landed in the flight ring before the exception unwound
    fail = [e for e in tflight.events() if e["kind"] == "failure"]
    assert fail and "RankKilled" in fail[-1]["detail"]


def test_train_step_nan_corrupts_only_the_target_row(ctx, jctx):
    jchaos.install("nan:step=2,rank=4")
    tchaos.install("nan:step=2,rank=4")
    (js, jp, jst, jb), (ts, tp, tst, tb) = _step_pair(0.05)
    for i in range(2):
        jp, jst, jl = js(jp, jst, jb)
        tp, tst, tl = ts(tp, tst, tb)
        jw, tw = np.asarray(jp["w"]), tp["w"].numpy()
        assert np.array_equal(np.isnan(tw), np.isnan(jw))
        np.testing.assert_allclose(tw[np.isfinite(jw)],
                                   jw[np.isfinite(jw)], rtol=1e-6, atol=1e-6)
    assert np.isnan(tw[4]).all() and np.isfinite(np.delete(tw, 4, 0)).all()
    # the loss row too, as JAX's corruption maps over every output leaf
    assert np.isnan(tl[4].item()) and np.isnan(np.asarray(jl)[4])


def test_window_moves_pass_the_hook(ctx):
    tchaos.install("nan:op=win_put,call=1,rank=6")
    x = torch.ones(N, D)
    twin.win_create(x, "w")
    try:
        twin.win_put(x, "w")
        value = twin.win_update("w")
        assert tm.counter("bluefog_faults_injected_total").value(
            kind="nan") == 1
        v = value.numpy()
        assert np.isnan(v[6]).all() and np.isfinite(np.delete(v, 6, 0)).all()
    finally:
        twin.win_free("w")


def test_delay_ledger_moves_the_throttle_onto_its_rank(ctx, jctx):
    tchaos.install("throttle:from=1,until=9,t=0.05,rank=6")
    (_, _, _, _), (ts, tp, tst, tb) = _step_pair()
    tp, tst, _ = ts(tp, tst, tb)
    table = tdiag.last_step_times()
    assert table.shape == (N,) and int(np.argmax(table)) == 6
    others = np.delete(table, 6)
    np.testing.assert_allclose(table[6] - others, 0.05, atol=1e-6)
    assert np.all(others == others[0])
    assert tchaos.consume_step_delays() == {}      # consumed by the step


def test_rank_faults_fire_only_in_the_owning_process(monkeypatch, ctx):
    """Two processes x 4 rows: process 1 holds ranks 4..7, so a kill of
    rank 2 does nothing there, one of rank 5 fires, and a NaN of rank 5
    writes row 1 of its block."""
    c = tctx.get_context()
    monkeypatch.setattr(c, "world", 2)
    monkeypatch.setattr(c, "process", 1)
    assert tchaos._ambient_rank() == 4 and tchaos._owns(5)
    assert not tchaos._owns(2)
    f2 = tchaos.Fault(kind="kill", step=1, rank=2)
    tchaos._enact(f2, "train_step", 1)                  # not ours: nothing
    with pytest.raises(tchaos.RankKilled):
        tchaos._enact(tchaos.Fault(kind="kill", step=1, rank=5),
                      "train_step", 1)
    x = torch.zeros(c.rows, 3)
    tchaos._corrupt_tree({"x": x}, 5)
    assert torch.isnan(x[1]).all() and not torch.isnan(x[[0, 2, 3]]).any()
    y = torch.zeros(c.rows, 3)
    tchaos._corrupt_tree([y], 2)                        # another block's
    assert not torch.isnan(y).any()
    # an untargeted throttle's delay lands on the process's first rank
    tchaos._attribute_delay(None, 0.5)
    assert tchaos.consume_step_delays() == {4: 0.5}


def test_unset_plan_is_inert(ctx, jctx):
    assert tchaos.current_plan() is None
    (js, jp, jst, jb), (ts, tp, tst, tb) = _step_pair(0.05)
    for _ in range(3):
        jp, jst, _ = js(jp, jst, jb)
        tp, tst, _ = ts(tp, tst, tb)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-6)
    tapi.neighbor_allreduce(torch.ones(N, D))
    assert tm.counter("bluefog_faults_injected_total").total() == 0
    assert not [e for e in tflight.events() if e["kind"] == "chaos"]
    assert tchaos.consume_step_delays() == {}
    assert "resilience" not in tm.metrics_summary()
