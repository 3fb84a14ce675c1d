"""The port's mesh regrowth (``bluefog_tpu_torch/resilience.py::regrow_world``
over ``parallel/context.py::reinit``) held against the JAX package's
(``tests/test_regrow.py``'s battery, wherever the port has the behaviour):

* ``reinit``: grow and shrink (the topology JAX's), a size below 1 (JAX's
  text), the compose carving rebuilt at the new dp, an indivisible world
  refused before teardown (JAX's text, nothing torn down), and open named
  windows refused before teardown (the port's mailboxes are shaped by the
  rank count);
* ``regrow_world``: lossless survivor rows, the joiners' pulled rows
  equal JAX's, the pending guard, the warm-up ramp, the dead set carried
  across, the flight trail's phases in JAX's order;
* every chaos abort (``kill_coordinator``, ``kill_joiner`` with and
  without a rank, ``hang_reinit`` under ``BLUEFOG_REGROW_TIMEOUT``) in
  the phase JAX aborts in, blaming JAX's rank, the old world stepping
  after it; back-to-back aborts; a failure during the rollback; the
  capsule's immunity to later registry edits;
* a float64 trajectory 4 -> 6 -> 4 ranks of gossip steps equal to JAX's
  within 1e-12, and the first step on the regrown world bit for bit a
  fresh 6-rank world's started from the carried state;
* a whole train state (params, an optimizer's moments, plain values)
  carried through the snapshot form and written into a trainer built at
  the new size;
* the port's flight bundle read by the repo's ``tools/postmortem.py``
  (its ``regrow`` block), as JAX's fixture is.

The AutoScaler's cases are ``tests/test_torch_serve_estate.py``'s.
"""
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import bluefog_tpu as jbf
from bluefog_tpu import resilience as jrz
from bluefog_tpu import topology as jtu
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu.parallel import context as jctx
from bluefog_tpu.utils import chaos as jchaos
from bluefog_tpu.utils import flight as jflight
from bluefog_tpu.utils import metrics as jm
from bluefog_tpu_torch import api as tapi
from bluefog_tpu_torch import resilience as trz
from bluefog_tpu_torch.ops import _build
from bluefog_tpu_torch.parallel import compose as tcompose
from bluefog_tpu_torch.parallel import context as tctx
from bluefog_tpu_torch.parallel import windows as twin
from bluefog_tpu_torch.utils import chaos as tchaos
from bluefog_tpu_torch.utils import flight as tflight
from bluefog_tpu_torch.utils import metrics as tm
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean():
    for m in (jm, tm):
        m.reset_metrics()
    for c in (jchaos, tchaos):
        c.uninstall()
    for r in (jrz, trz):
        r.reset()
    for f in (jflight, tflight):
        f.reset()
    yield
    for c in (jchaos, tchaos):
        c.uninstall()
    for r in (jrz, trz):
        r.reset()
    for f in (jflight, tflight):
        f.reset()
    if tctx.is_initialized():
        tctx.shutdown()


@pytest.fixture
def both4(cpu_devices):
    """A 4-rank world on each side."""
    jbf.init(devices=cpu_devices[:4])
    tctx.init(size=4, device="cpu")
    yield cpu_devices
    jbf.shutdown()
    tctx.shutdown()


@pytest.fixture
def world4():
    tctx.init(size=4, device="cpu")
    yield tctx.get_context()
    tctx.shutdown()


def _rows(n=4, d=8, seed=3):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _jax_params(arr):
    ctx = jbf.get_context()
    w = jax.device_put(arr, NamedSharding(ctx.mesh, P("rank")))
    return {"w": w, "step": 5}


def _port_params(arr):
    return {"w": torch.tensor(arr), "step": 5}


# ---------------------------------------------------------------------------
# context.reinit
# ---------------------------------------------------------------------------

def test_reinit_grows_world_and_topology(both4):
    jnew = jctx.reinit(6)
    tnew = tctx.reinit(6)
    assert tnew.size == jnew.size == 6
    assert tctx.get_context() is tnew
    assert set(tnew.topology.edges) == set(jnew.topology.edges)
    assert tnew.nodes_per_machine == jnew.nodes_per_machine == 6
    assert np.array_equal(tctx.static_schedule().self_weight,
                          np.asarray(jbf.static_schedule().self_weight))


def test_reinit_shrink_keeps_low_ranks(both4):
    jnew = jctx.reinit(2)
    tnew = tctx.reinit(2)
    assert tnew.size == jnew.size == 2 and tnew.rows == 2
    assert set(tnew.topology.edges) == set(jnew.topology.edges)
    assert tnew.device == torch.device("cpu")


def test_reinit_rejects_a_size_below_one(both4):
    with pytest.raises(ValueError) as je:
        jctx.reinit(0)
    with pytest.raises(ValueError) as te:
        tctx.reinit(0)
    assert str(te.value) == str(je.value)
    assert tctx.get_context().size == 4


def test_reinit_rebuilds_compose_carving(both4):
    cpu = both4
    jm_ = jcompose.compose_parallelism(2, 2, 1, 1, devices=list(cpu[:4]))
    tm_ = tcompose.compose_parallelism(2, 2, 1, 1, device="cpu")
    assert tctx.get_compose() is tm_ and jctx.get_compose() is jm_
    jctx.reinit(6)
    tctx.reinit(6)
    j2, t2 = jctx.get_compose(), tctx.get_compose()
    assert (t2.dp, t2.pp, t2.tp, t2.sp) == (j2.dp, j2.pp, j2.tp, j2.sp) \
        == (3, 2, 1, 1)
    assert set(t2.topology.edges) == set(j2.topology.edges)


def test_reinit_indivisible_world_rejected_before_teardown(both4):
    cpu = both4
    jm_ = jcompose.compose_parallelism(2, 2, 1, 1, devices=list(cpu[:4]))
    tm_ = tcompose.compose_parallelism(2, 2, 1, 1, device="cpu")
    old = tctx.get_context()
    with pytest.raises(ValueError, match="not a multiple") as je:
        jctx.reinit(5)
    with pytest.raises(ValueError, match="not a multiple") as te:
        tctx.reinit(5)
    assert str(te.value) == str(je.value)
    assert tctx.get_context() is old and tctx.get_compose() is tm_
    assert jctx.get_compose() is jm_


def test_reinit_refuses_open_named_windows(world4):
    twin.win_create(torch.zeros(4, 3), "w")
    try:
        with pytest.raises(ValueError, match="named windows"):
            tctx.reinit(6)
        assert tctx.get_context() is world4
    finally:
        twin.win_free("w")
    assert tctx.reinit(6).size == 6


# ---------------------------------------------------------------------------
# regrow_world: the protocol
# ---------------------------------------------------------------------------

def test_regrow_carries_survivors_and_pulls_jax_joiners(both4):
    arr = _rows()
    jp, jh = jrz.regrow_world(6, _jax_params(arr))
    b0 = _build.build_counts()
    tp, th = trz.regrow_world(6, _port_params(arr))
    assert _build.build_counts() == b0          # nothing built or loaded
    assert tctx.get_context().size == 6
    assert (th.world_before, th.world_after, th.joiners, th.coordinator) \
        == (jh.world_before, jh.world_after, jh.joiners, jh.coordinator)
    got = tp["w"].numpy()
    assert got.shape == (6, 8)
    np.testing.assert_array_equal(got[:4], arr)      # byte for byte
    np.testing.assert_allclose(got, np.asarray(jp["w"]), rtol=1e-6,
                               atol=1e-6)
    assert not np.array_equal(got[4], arr[0])        # really pulled
    assert tp["step"] == 5
    assert th.bytes_carried == 6 * 8 * 4
    assert trz.regrow_pending() and not th.committed
    tapi.neighbor_allreduce(tp["w"])
    assert th.commit() and th.committed
    assert not trz.regrow_pending()
    assert trz.commit_regrow() is False               # idempotent
    jh.commit()


def test_regrow_pending_guard_blocks_second_regrow(world4):
    params = _port_params(_rows())
    _, handle = trz.regrow_world(6, params)
    with pytest.raises(RuntimeError, match="already pending"):
        trz.regrow_world(8, params)
    handle.commit()
    assert trz.commit_regrow() is False


def test_regrow_target_checks_match_jax(both4):
    arr = _rows()
    for target in (1, 4):
        with pytest.raises(ValueError) as je:
            jrz.regrow_world(target, _jax_params(arr))
        with pytest.raises(ValueError) as te:
            trz.regrow_world(target, _port_params(arr))
        assert str(te.value) == str(je.value)


def test_regrow_joiner_warmup_ramp(both4):
    arr = _rows()
    _, jh = jrz.regrow_world(6, _jax_params(arr), warmup_steps=3)
    _, th = trz.regrow_world(6, _port_params(arr), warmup_steps=3)
    assert trz._warmup == jrz._warmup == {4: [1, 4], 5: [1, 4]}
    np.testing.assert_array_equal(
        tctx.static_schedule().self_weight,
        np.asarray(jbf.static_schedule().self_weight))
    jh.commit()
    th.commit()


def test_regrow_carries_dead_set_across(both4):
    arr = _rows()
    jrz.mark_rank_dead(2)
    trz.mark_rank_dead(2)
    jp, jh = jrz.regrow_world(6, _jax_params(arr))
    tp, th = trz.regrow_world(6, _port_params(arr))
    assert trz.dead_ranks() == jrz.dead_ranks() == (2,)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-6)
    jh.commit()
    th.commit()


def test_regrow_flight_trail_names_phases(both4):
    arr = _rows()
    names = {}
    for side, rz, fl, params in (("jax", jrz, jflight, _jax_params(arr)),
                                 ("port", trz, tflight, _port_params(arr))):
        fl.configure(4096)
        _, handle = rz.regrow_world(6, params)
        handle.commit()
        evs = [e for e in fl.events() if e.get("kind") == "regrow"]
        names[side] = ([e.get("name") for e in evs],
                       [e["phase"] for e in evs if e.get("name") == "phase"])
    assert names["port"] == names["jax"]
    assert names["port"][0][0] == "begin" and names["port"][0][-1] == \
        "commit"
    assert names["port"][1] == list(trz.REGROW_PHASES)


# ---------------------------------------------------------------------------
# chaos: hostile scale events abort and roll back
# ---------------------------------------------------------------------------

def _assert_old_world_alive(params):
    assert tctx.get_context().size == 4
    assert not trz.regrow_pending()
    assert tapi.neighbor_allreduce(params["w"]).shape == (4, 8)


@pytest.mark.parametrize("plan", ["kill_coordinator:step=1",
                                  "kill_joiner:step=1",
                                  "kill_joiner:step=1,rank=5"])
def test_chaos_kill_aborts_where_jax_aborts(both4, plan):
    arr = _rows()
    got = {}
    for side, rz, ch, fl, params in (
            ("jax", jrz, jchaos, jflight, _jax_params(arr)),
            ("port", trz, tchaos, tflight, _port_params(arr))):
        fl.configure(4096)
        ch.install(plan)
        with pytest.raises(rz.RegrowAborted) as ei:
            rz.regrow_world(6, params)
        ch.uninstall()
        kills = [e for e in fl.events() if e.get("kind") == "chaos"
                 and str(e.get("name", "")).startswith("kill_")]
        aborts = [e for e in fl.events() if e.get("kind") == "regrow"
                  and e.get("name") == "abort"]
        got[side] = (ei.value.phase, ei.value.rank,
                     [(k["name"], k["rank"]) for k in kills],
                     [a["phase"] for a in aborts])
    assert got["port"] == got["jax"]
    _assert_old_world_alive(_port_params(arr))
    assert jbf.get_context().size == 4


def test_hang_reinit_exhausts_deadline_and_rolls_back(both4, monkeypatch):
    arr = _rows()
    monkeypatch.setenv("BLUEFOG_REGROW_TIMEOUT", "0.01")
    for rz, ch, params in ((jrz, jchaos, _jax_params(arr)),
                           (trz, tchaos, _port_params(arr))):
        ch.install("hang_reinit:t=0.05,p=1")
        with pytest.raises(rz.RegrowAborted) as ei:
            rz.regrow_world(6, params, retries=1, backoff=0.001)
        ch.uninstall()
        assert ei.value.phase == "reinit"
        assert isinstance(ei.value.__cause__, TimeoutError)
    _assert_old_world_alive(_port_params(arr))


def test_back_to_back_aborts_leave_old_world_atomic(world4, monkeypatch):
    params = _port_params(_rows())
    trz.mark_rank_dead(3)
    snap0 = trz._snapshot_registry()
    monkeypatch.setattr(tctx, "reinit", lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("zone reclaimed mid-reinit")))
    for _ in range(2):
        with pytest.raises(trz.RegrowAborted) as ei:
            trz.regrow_world(6, params, retries=1, backoff=0.001)
        assert ei.value.phase == "reinit"
        assert tctx.get_context() is world4
        assert not trz.regrow_pending()
        snap = trz._snapshot_registry()
        assert snap["dead"] == snap0["dead"] == {3}
        assert snap["retired"] == snap0["retired"]
        assert snap["warmup"] == snap0["warmup"]
        tapi.neighbor_allreduce(params["w"])
    monkeypatch.undo()
    _, handle = trz.regrow_world(6, params)
    handle.commit()
    assert tctx.get_context().size == 6


def test_second_failure_mid_rollback_still_converges(world4, monkeypatch):
    params = _port_params(_rows())
    tflight.configure(4096)
    monkeypatch.setattr(tctx, "reinit", lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("zone reclaimed mid-reinit")))
    real_install = tctx._install
    calls = {"n": 0}

    def flaky_install(ctx, compose):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("second spot reclaim mid-rollback")
        return real_install(ctx, compose)

    monkeypatch.setattr(tctx, "_install", flaky_install)
    with pytest.raises(trz.RegrowAborted):
        trz.regrow_world(6, params, retries=1, backoff=0.001)
    monkeypatch.undo()
    assert calls["n"] == 2                  # the retry re-ran BOTH halves
    _assert_old_world_alive(params)
    retries = [e for e in tflight.events() if e.get("kind") == "regrow"
               and e.get("name") == "rollback_retry"]
    assert len(retries) == 1
    assert any(e.get("name") == "abort" for e in tflight.events()
               if e.get("kind") == "regrow")


def test_abort_capsule_registry_immune_to_restore_mutation(world4):
    trz.mark_rank_dead(1)
    snap = trz._snapshot_registry()
    trz._restore_registry(snap)
    trz.mark_rank_dead(2)
    assert snap["dead"] == {1}
    trz._restore_registry(snap)
    assert trz.dead_ranks() == (1,)


def test_regrow_chaos_kinds_reject_eager_site_matchers():
    spec = "kill_coordinator:step=1,op=neighbor_allreduce"
    with pytest.raises(ValueError) as je:
        jchaos.ChaosPlan.parse(spec)
    with pytest.raises(ValueError) as te:
        tchaos.ChaosPlan.parse(spec)
    assert str(te.value) == str(je.value)


def test_abort_keeps_the_callers_tensors(world4):
    """The carry never writes the caller's tree: after an abort the old
    world's state is the one passed in, untouched."""
    arr = _rows()
    params = _port_params(arr)
    tchaos.install("kill_joiner:step=1")
    with pytest.raises(trz.RegrowAborted):
        trz.regrow_world(6, params)
    np.testing.assert_array_equal(params["w"].numpy(), arr)


# ---------------------------------------------------------------------------
# float64: the 4 -> 6 -> 4 trajectory, and the fresh-world oracle
# ---------------------------------------------------------------------------

def test_float64_trajectory_4_6_4_matches_jax(cpu_devices):
    arr = np.random.default_rng(11).standard_normal((4, 16))
    with jax.enable_x64(True):
        jbf.init(devices=cpu_devices[:4])
        tctx.init(size=4, device="cpu")
        try:
            jw = jax.device_put(arr, NamedSharding(jbf.get_context().mesh,
                                                   P("rank")))
            tw = torch.tensor(arr)
            for target in (6, 4, None):
                for _ in range(2):
                    jw = jbf.neighbor_allreduce(jw)
                    tw = tapi.neighbor_allreduce(tw)
                    ref = np.asarray(jw)
                    assert ref.dtype == np.float64
                    err = np.abs(tw.numpy() - ref).max()
                    assert err <= 1e-12 * np.abs(ref).max(), (target, err)
                if target is None:
                    break
                jp, jh = jrz.regrow_world(target, {"w": jw})
                tp, th = trz.regrow_world(target, {"w": tw})
                jw, tw = jp["w"], tp["w"]
                np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                                           rtol=0, atol=1e-12)
                jh.commit()
                th.commit()
        finally:
            jbf.shutdown()
            tctx.shutdown()


def test_float64_regrow_matches_fresh_world():
    """Grow 4 -> 6 then step: bit for bit a fresh 6-rank world seeded
    from the same carried state (no checkpoint file anywhere)."""
    tctx.init(size=4, device="cpu")
    w = torch.tensor(np.random.default_rng(11).standard_normal((4, 16)))
    for _ in range(2):
        w = tapi.neighbor_allreduce(w)
    newp, handle = trz.regrow_world(6, {"w": w})
    carried = newp["w"].clone()
    grown = tapi.neighbor_allreduce(newp["w"])
    handle.commit()
    tctx.shutdown()
    trz.reset()
    tctx.init(size=6, device="cpu")
    fresh = tapi.neighbor_allreduce(carried)
    assert torch.equal(grown, fresh)


def test_whole_train_state_carries_into_a_new_trainer(world4):
    """Params, an optimizer's per-parameter moments and plain values ride
    one tree: the carry has the snapshot's form, survivors byte for byte,
    joiner moments pulled like the params, and ``restore_into`` writes it
    into a state built at the new size."""
    from bluefog_tpu_torch.utils.snapshot import restore_into

    def build(n, seed):
        g = torch.Generator().manual_seed(seed)
        p = torch.nn.Parameter(torch.randn(n, 5, generator=g))
        opt = torch.optim.Adam([p], lr=0.1)
        p.grad = torch.randn(n, 5, generator=g)
        opt.step()
        return {"params": p, "opt": opt, "tick": 3}

    old = build(4, 0)
    m0 = old["opt"].state[old["params"]]["exp_avg"].clone()
    newt, handle = trz.regrow_world(6, old)
    assert isinstance(newt["opt"], list)
    st = newt["opt"][0]
    assert st["exp_avg"].shape == (6, 5) and newt["tick"] == 3
    assert torch.equal(st["exp_avg"][:4], m0)
    donors = trz._pristine["sched"].in_neighbors[4]
    want = sum(m0[d].double() for d in donors) / len(donors)
    assert torch.allclose(st["exp_avg"][4].double(), want, atol=1e-6)
    live = build(6, 1)
    restore_into(live, newt)
    assert torch.equal(live["opt"].state[live["params"]]["exp_avg"],
                       st["exp_avg"])
    assert torch.equal(live["params"].detach(), newt["params"])
    handle.commit()


# ---------------------------------------------------------------------------
# postmortem: the port's regrow block
# ---------------------------------------------------------------------------

def _postmortem():
    spec = importlib.util.spec_from_file_location(
        "postmortem_mod", ROOT / "tools" / "postmortem.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_postmortem_reads_the_ports_regrow_block(world4, tmp_path):
    tflight.configure(4096)
    params = _port_params(_rows())
    tchaos.install("kill_coordinator:step=1")
    with pytest.raises(trz.RegrowAborted):
        trz.regrow_world(6, params)
    tchaos.uninstall()
    _, handle = trz.regrow_world(6, params)
    handle.commit()
    path = tflight.dump(str(tmp_path / "flight_rank0.json"),
                        reason="regrow_test")
    bundle = json.loads(Path(path).read_text())
    assert bundle["regrow"]["committed"] is True
    report = _postmortem().report_from_files([path])
    assert report["ok"]
    rg = report["regrow"]
    assert rg["world_before"] == 4 and rg["world_after"] == 6
    assert rg["coordinator"] == 0 and rg["committed"]
    names = [e["name"] for e in rg["timeline"]]
    assert names.count("abort") == 1 and names[-1] == "commit"
