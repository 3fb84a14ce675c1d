"""The port across processes: ``torch.distributed`` (gloo) under the
stacked ranks, against the one-process port and the JAX package.

Two processes x 4 rows mirror ``tests/test_multihost.py``'s two processes
x 4 virtual devices: launched with torchrun's variables by
``bluefog_tpu_torch/tools/world_check.py`` (each process with its own
time limit, so a hung rendezvous fails the test), each runs the checks of
``run_checks`` on its block of the 8 ranks: weighted ring gossip (also
with every round in one message under ``set_round_parallel``), the
wire codecs (bf16, fp8, int8@4, fp8@4), Exp2 gossip, the new collectives
(neighbor_allgather, ragged_neighbor_allgather, pair_gossip across and
inside the blocks), allreduce / allgather / ragged_allgather /
broadcast, hierarchical gossip over a ring of the two processes'
machines, a sequence of window ops (plain and int8) with win_pull, ZeRO-1
over 5 steps of make_train_step, GPipe across the boundary with its
gradients, 1F1B, the interleaved ring (its S-1 -> 0 wrap crosses too) and
a stage list (embed | blocks | head).

* Every result equals the one-process port (``init(size=8)``) bit for
  bit, except the sums through the process group (allreduce and the
  ZeRO loss mean it reports): gloo adds the two processes' partial sums,
  one process adds the 8 rows in torch's order, so those agree to 1e-6.
* The JAX rows on the 8-device mesh agree at the tolerance of
  ``tests/test_torch_collectives.py`` (atol 1e-6) for the collectives,
  windows and ZeRO; the pipelines agree with the JAX functions and the
  sequential composition at rtol 1e-5 / atol 1e-6.
* ``BLUEFOG_HIERARCHICAL=1`` groups the ranks by process (a machine a
  process, the weighted ExponentialTwoGraph over the machines).

The four-process x 2 rows and eight x 1 row launches run under ``slow``.
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
from bluefog_tpu import optimizers as jopt
from bluefog_tpu import schedule as jsch
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import windows as jwin
from bluefog_tpu.parallel import pipeline as jpipe
import bluefog_tpu_torch as tbf
from bluefog_tpu_torch.parallel import context as tctx
from bluefog_tpu_torch.tools import world_check as wc
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N = 8
THROUGH_GROUP = ("allreduce", "allreduce_sum", "zero_loss_mean", "layout",
                 "p2p_calls")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    got = wc.spawn(2, N, tmp_path_factory.mktemp("world2"), timeout=120,
                   env={"BLUEFOG_HIERARCHICAL": "1"})
    return got, wc.reference(N, N // 2)


@pytest.fixture(scope="module")
def jax_rows(cpu_devices):
    """The JAX package's results on the 8-device mesh, by key."""
    data = wc.inputs(N)
    out = {}
    jbf.init(devices=cpu_devices[:N], nodes_per_machine=N // 2)
    try:
        def d(key):
            return jbf.shard_distributed(jnp.asarray(data[key]))

        jbf.set_topology(jtopo.RingGraph(N), is_weighted=True)
        out["ring"] = jbf.neighbor_allreduce(d("ramp3"))
        for w in wc.WIRES:
            out["ring_" + w] = jbf.neighbor_allreduce(d("ramp8"), wire=w)
            out["rand_" + w] = jbf.neighbor_allreduce(d("rand"), wire=w)
        jbf.set_topology(jtopo.ExponentialTwoGraph(N))
        out["expo2"] = jbf.neighbor_allreduce(d("rand"))
        out["nag"] = jbf.neighbor_allgather(d("gather"))
        out["rnag"], out["rnag_len"] = jbf.ragged_neighbor_allgather(
            d("ragged"), data["lengths"])
        out["pair"] = jbf.pair_gossip(d("rand"), wc.PARTNERS,
                                      self_weight=0.25, pair_weight=0.75)
        out["allreduce"] = jbf.allreduce(d("rand"))
        out["allreduce_sum"] = jbf.allreduce(d("rand"), average=False)
        out["allgather"] = jbf.allgather(d("gather"))
        out["rag"], out["rag_len"] = jbf.ragged_allgather(d("ragged"),
                                                          data["lengths"])
        out["broadcast"] = jbf.broadcast(d("rand"), wc.ROOT)
        jbf.set_machine_topology(jtopo.RingGraph(2), is_weighted=True)
        out["hier"] = jbf.hierarchical_neighbor_allreduce(d("rand"))
        # ZeRO-1, tests/test_multihost.py's 5 steps
        strat = jopt.zero_gradient_allreduce(optax.sgd(0.2))

        def grad_fn(params, batch):
            return jax.value_and_grad(
                lambda p: jnp.mean((p["w"] - batch) ** 2))(params)

        params = {"w": jbf.shard_distributed(jnp.broadcast_to(
            jnp.arange(float(N))[:, None], (N, 5)))}
        state = jax.tree.map(jbf.shard_distributed,
                             jopt.init_distributed(strat, params))
        step = jopt.make_train_step(grad_fn, strat)
        target = jbf.shard_distributed(jnp.full((N, 5), 2.0))
        for k in range(5):
            params, state, loss = step(params, state, target)
            out[f"zero_loss_{k}"] = loss
        out["zero_w"] = params["w"]
        out = {k: np.asarray(jbf.synchronize(v)) for k, v in out.items()}
    finally:
        jbf.shutdown()
    mesh = Mesh(np.array(cpu_devices[:N]), ("rank",))
    for kind, wire in (("ring", None), ("expo2", "int8")):
        topo = jtopo.RingGraph(N) if kind == "ring" else \
            jtopo.ExponentialTwoGraph(N)
        sched = jsch.compile_topology(topo, kind == "ring")

        def per_rank(b, sched=sched, wire=wire):
            return tuple(v[None] for v in
                         wc.window_sequence(jwin, sched, b[0], wire))

        fn = jax.jit(jax.shard_map(per_rank, mesh=mesh, in_specs=P("rank"),
                                   out_specs=(P("rank"),) * 9))
        for i, v in enumerate(fn(jnp.asarray(data["window"]))):
            out[f"win_{kind}_{i}"] = np.asarray(v)
    return out


def test_two_processes_equal_one_process_bit_for_bit(world):
    got, ref = world
    assert set(got) == set(ref)
    for key in ref:
        if key in THROUGH_GROUP:
            continue
        assert got[key].dtype == ref[key].dtype, key
        assert torch.equal(got[key], ref[key]), key
    for key in THROUGH_GROUP[:-2]:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   rtol=0, atol=1e-6, err_msg=key)


def test_round_parallel_moves_every_round_in_one_message(world):
    """``set_round_parallel(True)`` / ``concurrent=True`` change no result
    and move every round's crossing rows in one ``batch_isend_irecv``;
    ZeRO-1's reduce-scatter and all-gather are one call each a step."""
    got, ref = world
    assert torch.equal(got["ring_rp"], ref["ring"])
    assert torch.equal(got["rand_int8@4_rp"], ref["rand_int8@4"])
    rounds = tbf.schedule.compile_topology(tbf.topology.RingGraph(N),
                                           True).num_rounds
    assert rounds > 1
    assert got["p2p_calls"].tolist() == [rounds, 1, 1, 2 * 5]
    assert ref["p2p_calls"].tolist() == [0, 0, 0, 0]


def test_hierarchical_auto_groups_by_process(world):
    got, ref = world
    # world 2, 4 rows a process, a machine a process, 2 machines, "auto",
    # the weighted ExponentialTwoGraph over them
    assert got["layout"].tolist() == [2, 4, 4, 2, 1, 1]
    assert ref["layout"].tolist() == [1, 8, 4, 2, 0, 0]


def test_gossip_codecs_and_collectives_match_jax(world, jax_rows):
    got, _ = world
    keys = (["ring", "expo2", "nag", "rnag", "rnag_len", "pair",
             "allreduce", "allreduce_sum", "allgather", "rag", "rag_len",
             "broadcast", "hier"]
            + [p + w for p in ("ring_", "rand_") for w in wc.WIRES])
    for key in keys:
        want = jax_rows[key]
        assert got[key].shape == want.shape, key
        np.testing.assert_allclose(got[key].numpy(), want, rtol=0,
                                   atol=1e-6, err_msg=key)
    # tests/test_multihost.py's own expectations
    for r in range(N):
        exp = (r + (r - 1) % N + (r + 1) % N) / 3.0
        assert abs(float(got["ring"][r, 0]) - exp) < 1e-5
        for w in ("fp8", "int8@4", "fp8@4"):
            assert abs(float(got["ring_" + w][r, 0]) - exp) < 0.1, (w, r)


def test_windows_and_zero_match_jax(world, jax_rows):
    got, _ = world
    for kind in ("ring", "expo2"):
        for i in range(9):
            key = f"win_{kind}_{i}"
            np.testing.assert_allclose(got[key].numpy(), jax_rows[key],
                                       rtol=0, atol=1e-6, err_msg=key)
    x = wc.inputs(N)["window"]
    sched = jsch.compile_topology(jtopo.RingGraph(N), True)
    W = np.diag(sched.self_weight.astype(np.float64))
    for r in range(sched.num_rounds):
        for d in range(N):
            if sched.recv_src[r, d] >= 0:
                W[sched.recv_src[r, d], d] += sched.recv_weight[r, d]
    np.testing.assert_allclose(got["pull_ring"].numpy(), W.T @ x, atol=1e-6)
    for key in [f"zero_loss_{k}" for k in range(5)] + ["zero_w"]:
        np.testing.assert_allclose(got[key].numpy(), jax_rows[key], rtol=0,
                                   atol=1e-6, err_msg=key)
    assert got["zero_loss_mean"][-1] < got["zero_loss_mean"][0]


def test_pipelines_across_the_boundary_match_jax(world, cpu_devices):
    got, _ = world
    data = wc.inputs(N)
    w, mb, tgt = data["pp_w"], data["pp_mb"], data["pp_tgt"]
    mesh = Mesh(np.array(cpu_devices[:N]), ("rank",))

    def pp_f(wl, mbs):
        out = jpipe.pipeline_apply(lambda p, x: jnp.tanh(x @ p[0]), wl, mbs,
                                   axis="rank")
        return jpipe.last_stage_value(out, axis="rank")

    jout = jax.jit(jax.shard_map(pp_f, mesh=mesh,
                                 in_specs=(P("rank"), P(None)),
                                 out_specs=P(None)))(w, mb)
    np.testing.assert_allclose(got["pp_out"].numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)

    def seq(ws, x):
        for s in range(ws.shape[0]):
            x = jnp.tanh(x @ ws[s])
        return x

    def mse(ws):
        return jnp.mean((seq(ws, mb) - tgt) ** 2)

    loss, g = jax.value_and_grad(mse)(jnp.asarray(w))
    np.testing.assert_allclose(got["pp_loss"].item(), float(loss),
                               rtol=1e-5)
    np.testing.assert_allclose(got["pp_grad"].numpy(), np.asarray(g),
                               rtol=1e-5, atol=1e-6)

    def mb_sum(ws):
        y = seq(ws, mb)
        return sum(jnp.mean((y[i] - tgt[i]) ** 2) for i in range(3))

    l1, g1 = jax.value_and_grad(mb_sum)(jnp.asarray(w))
    np.testing.assert_allclose(got["f1b_loss"][-1].item(), float(l1),
                               rtol=1e-5)
    assert not got["f1b_loss"][:-1].any()
    np.testing.assert_allclose(got["f1b_grad"].numpy(), np.asarray(g1),
                               rtol=1e-5, atol=1e-6)
    # interleaved: virtual stage k*S + d holds il_w[d, k]
    iw = data["il_w"]

    def il_loss(cw):
        x = mb
        for k in range(cw.shape[1]):
            for d in range(N):
                x = jnp.tanh(x @ cw[d, k])
        return jnp.mean(x ** 2), x

    (_, iy), ig = jax.value_and_grad(il_loss, has_aux=True)(jnp.asarray(iw))
    np.testing.assert_allclose(got["il_out"].numpy(), np.asarray(iy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["il_grad"].numpy(), np.asarray(ig),
                               rtol=1e-5, atol=1e-6)
    # the stage list, against JAX's pack_stage_params layout
    trees = ([{"embed": jnp.asarray(data["st_embed"])}]
             + [{"w": jnp.asarray(x)} for x in data["st_w"]]
             + [{"head": jnp.asarray(data["st_head"])}])
    packed, unpacks = jpipe.pack_stage_params(trees)
    toks = jnp.asarray(data["st_tokens"])

    def st_loss(buf):
        x = unpacks[0](buf[0])["embed"][toks]
        for s in range(1, N - 1):
            x = x + jnp.tanh(x @ unpacks[s](buf[s])["w"])
        y = x @ unpacks[N - 1](buf[N - 1])["head"]
        return jnp.mean(y ** 2), y

    (_, sy), sg = jax.value_and_grad(st_loss, has_aux=True)(packed)
    np.testing.assert_allclose(got["st_out"].numpy(), np.asarray(sy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["st_grad"].numpy(), np.asarray(sg),
                               rtol=1e-5, atol=1e-6)


def _fake_world(monkeypatch, rows=4, world=2, npm=None):
    """A context that says it is process 0 of ``world`` (no group is made:
    the refusals below raise before any message)."""
    ctx = tctx.BlueFogTorchContext(
        rows * world, torch.device("cpu"),
        tbf.topology.RingGraph(rows * world),
        nodes_per_machine=npm or rows, process=0, world=world)
    monkeypatch.setattr(tctx, "_context", ctx)
    return ctx


def test_a_replica_or_machine_split_across_processes_is_refused(monkeypatch):
    from bluefog_tpu_torch.ops import collectives as tcoll
    from bluefog_tpu_torch import optimizers as topt
    from bluefog_tpu_torch.parallel.compose import compose_parallelism
    _fake_world(monkeypatch)
    with pytest.raises(ValueError, match="ROADMAP queue 1, item 12"):
        compose_parallelism(dp=1, pp=8, device="cpu")
    assert compose_parallelism(dp=2, pp=2, tp=2, device="cpu").dp == 2
    _fake_world(monkeypatch, npm=8)
    sched = tbf.schedule.compile_topology(tbf.topology.RingGraph(1), False)
    with pytest.raises(ValueError, match="spans processes"):
        tcoll.hierarchical_neighbor_allreduce(torch.zeros(4, 3), sched)
    strat = topt.zero_gradient_allreduce(topt.sgd(0.1), axis="local",
                                         axis_size=8)
    with pytest.raises(ValueError, match="item 12"):
        strat.update({"w": torch.zeros(4, 3)}, strat.init(
            {"w": torch.zeros(4, 3)}), {"w": torch.zeros(4, 3)})
    # a block of the global tables, and the checks on the local block
    assert tcoll._local(np.arange(8), 4).tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match=r"stacked \[n=4"):
        tcoll.neighbor_allreduce(torch.zeros(8, 2), tbf.schedule
                                 .compile_topology(tbf.topology
                                                   .RingGraph(8), False))


@pytest.mark.slow
@pytest.mark.parametrize("nproc", [4, 8])
def test_more_processes_equal_one_process(tmp_path, nproc):
    got = wc.spawn(nproc, N, tmp_path, timeout=240)
    ref = wc.reference(N, N // nproc)
    for key in ref:
        if key in THROUGH_GROUP:
            continue
        assert torch.equal(got[key], ref[key]), key
    assert got["layout"].tolist()[:4] == [nproc, N // nproc, N // nproc,
                                          nproc]
