"""The port's single-process context and op API against the JAX package's,
on the CPU.

The JAX context runs over the 8 virtual CPU devices (one rank each); the
port's stacks the same 8 ranks on dim 0 of one CPU tensor
(``init(size=8, device="cpu")``).  Both must agree on the size, the
default topology, ``set_topology`` (weighted or not), the neighbor
queries, ``static_schedule``'s tables, the error texts, the schedules
``resolve_schedule`` compiles, and ``neighbor_allreduce``: JAX row r
equals port rank r (f32; the same products summed in the same order, atol
1e-6).  The average-consensus example's MSE history equals the JAX
example's loop, static and ``--dynamic``.
"""
import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
from bluefog_tpu import schedule as jsch
from bluefog_tpu import topology as jtopo
import bluefog_tpu_torch as tbf
from bluefog_tpu_torch import schedule as tsch
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.examples import average_consensus
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N = 8
TOPOLOGIES = ["ExponentialGraph", "ExponentialTwoGraph", "RingGraph",
              "StarGraph", "MeshGrid2DGraph", "FullyConnectedGraph",
              "SymmetricExponentialGraph"]
TABLES = ("recv_weight", "recv_src", "recv_slot", "send_scale",
          "slot_weight", "self_weight", "in_degree", "out_degree")


@pytest.fixture
def both(cpu_devices):
    jbf.init(devices=cpu_devices[:N])
    tbf.init(size=N, device="cpu")
    yield
    jbf.shutdown()
    tbf.shutdown()


def _same_schedule(a, b):
    assert a.size == b.size and a.rounds == b.rounds
    assert a.in_neighbors == b.in_neighbors
    assert a.uses_dst_weighting == b.uses_dst_weighting
    for t in TABLES:
        assert np.array_equal(getattr(a, t), getattr(b, t)), t


def _weights(topo_mod, topo):
    return topo_mod.to_weight_matrix(topo)


def test_size_and_default_topology(both):
    assert jbf.size() == tbf.size() == N
    assert jbf.is_initialized() and tbf.is_initialized()
    assert tbf.get_context().device.type == "cpu"
    assert np.array_equal(_weights(jtopo, jbf.load_topology()),
                          _weights(ttopo, tbf.load_topology()))
    assert jbf.is_topology_weighted() is tbf.is_topology_weighted() is False
    _same_schedule(jbf.static_schedule(), tbf.static_schedule())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_set_topology_neighbors_and_schedule(both, name, weighted):
    assert jbf.set_topology(getattr(jtopo, name)(N), is_weighted=weighted)
    assert tbf.set_topology(getattr(ttopo, name)(N), is_weighted=weighted)
    assert tbf.is_topology_weighted() is weighted
    for r in range(N):
        assert jbf.in_neighbor_ranks(r) == tbf.in_neighbor_ranks(r)
        assert jbf.out_neighbor_ranks(r) == tbf.out_neighbor_ranks(r)
    _same_schedule(jbf.static_schedule(), tbf.static_schedule())
    # None goes back to the default Exponential graph
    jbf.set_topology(None)
    tbf.set_topology(None)
    _same_schedule(jbf.static_schedule(), tbf.static_schedule())


def _error(fn, *args, **kw):
    with pytest.raises(Exception) as e:
        fn(*args, **kw)
    return type(e.value), str(e.value)


def test_error_texts_are_jax_texts(cpu_devices):
    jbf.shutdown()
    tbf.shutdown()
    assert _error(jbf.get_context) == _error(tbf.get_context)
    assert _error(jbf.size) == _error(tbf.size)
    jbf.init(devices=cpu_devices[:N])
    tbf.init(size=N, device="cpu")
    try:
        assert _error(jbf.set_topology, jtopo.RingGraph(4)) == \
            _error(tbf.set_topology, ttopo.RingGraph(4))
        assert _error(jbf.shard_distributed, np.zeros((3, 2))) == \
            _error(tbf.shard_distributed, np.zeros((3, 2)))
    finally:
        jbf.shutdown()
        tbf.shutdown()
    assert _error(tbf.init, lambda: ttopo.RingGraph(3), size=4,
                  device="cpu") == _error(jbf.init, lambda: jtopo.RingGraph(3),
                                          devices=cpu_devices[:4])
    jbf.shutdown()


LAUNCH = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def test_init_refuses_a_multiprocess_launch(monkeypatch):
    """A launch of several processes without torchrun's variables raises
    a named error (it never falls back to one process); WORLD_SIZE=1
    alone is one process."""
    for v in LAUNCH:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match=r"missing \['RANK', "
                       r"'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT'\]"):
        tbf.init(size=2, device="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(RuntimeError, match=r"missing \['MASTER_ADDR'\]"):
        tbf.init(size=2, device="cpu")
    assert not tbf.is_initialized()
    for v in LAUNCH:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    ctx = tbf.init(size=2, device="cpu")
    assert (ctx.size, ctx.world, ctx.rows, ctx.owns_group) == (2, 1, 2, False)
    tbf.shutdown()


def test_init_checks_the_process_layout(monkeypatch):
    """RANK must lie in the world, and the ranks must split evenly over
    the processes (checked before any process group is made)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(ValueError, match="RANK 2 out of range"):
        tbf.init(size=4, device="cpu")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="not a whole number of ranks"):
        tbf.init(size=3, device="cpu")
    assert not tbf.is_initialized()


def test_round_parallel_and_async_knobs_match_jax(both, monkeypatch):
    from bluefog_tpu.ops import collectives as jcoll
    from bluefog_tpu_torch.ops import collectives as tcoll
    for mod in (jbf.parallel.context, tbf.parallel.context):
        assert mod.round_parallel() is None
    monkeypatch.setenv("BLUEFOG_ROUND_PARALLEL", "1")
    assert jcoll._default_concurrent() is tcoll._default_concurrent() is True
    for value in (False, True, None):
        jbf.parallel.context.set_round_parallel(value)
        tbf.set_round_parallel(value)
        assert jbf.parallel.context.round_parallel() is \
            tbf.round_parallel() is value
        assert jcoll._default_concurrent() == tcoll._default_concurrent()
    # the async staleness knob: the context's value, else BLUEFOG_ASYNC,
    # else the default 4, as JAX resolves it (async_window_gossip reads it)
    jctx = jbf.parallel.context
    monkeypatch.delenv("BLUEFOG_ASYNC", raising=False)
    assert jctx.async_gossip_bound() == tbf.async_gossip_bound() == \
        tbf.parallel.context._DEFAULT_ASYNC_BOUND == 4
    monkeypatch.setenv("BLUEFOG_ASYNC", "6")
    for value in (3, 0, None):
        jctx.set_async_gossip(value)
        tbf.set_async_gossip(value)
        assert jctx.async_gossip_bound() == tbf.async_gossip_bound() == \
            (6 if value is None else value)
    assert tbf.suspend() is None and tbf.resume() is None
    assert jctx.suspend() is None and jctx.resume() is None


@pytest.mark.parametrize("npm", [None, 2, 4])
def test_hierarchical_auto_matches_jax_in_one_process(cpu_devices, npm):
    """One process: ``hierarchical="auto"`` groups by nodes_per_machine,
    else a rank a machine, and installs the weighted ExponentialTwoGraph
    over the machines, as JAX's init does without slices."""
    jctx = jbf.init(devices=cpu_devices[:N], hierarchical="auto",
                    nodes_per_machine=npm)
    tctx = tbf.init(size=N, device="cpu", hierarchical="auto",
                    nodes_per_machine=npm)
    try:
        assert tctx.hierarchical == jctx.hierarchical == "auto"
        assert tbf.local_size() == jbf.local_size()
        assert tbf.machine_size() == jbf.machine_size()
        assert tbf.is_machine_topology_weighted() is \
            jbf.is_machine_topology_weighted() is True
        assert np.array_equal(
            _weights(jtopo, jbf.load_machine_topology()),
            _weights(ttopo, tbf.load_machine_topology()))
    finally:
        jbf.shutdown()
        tbf.shutdown()


def test_hierarchical_auto_groups_by_process():
    """Across processes a machine is a process's block of ranks, as JAX's
    init groups by process locality; an explicit nodes_per_machine that
    contradicts it raises.  (The 2-process run of
    tests/test_torch_world.py checks the grouping end to end.)"""
    from bluefog_tpu_torch.parallel.context import _auto_hierarchy
    assert _auto_hierarchy(4, 2, None) == 4
    assert _auto_hierarchy(4, 2, 4) == 4
    assert _auto_hierarchy(1, 8, None) == 1
    with pytest.raises(ValueError, match="contradicts the process layout"):
        _auto_hierarchy(4, 2, 2)
    assert _auto_hierarchy(8, 1, None) == 1
    assert _auto_hierarchy(8, 1, 2) == 2


def _policies(n):
    rng = np.random.default_rng(0)
    src = [{(r - 1) % n: 0.25, (r + 2) % n: 0.25} for r in range(n)]
    return {
        "default": {},
        "self_scalar": {"self_weight": 0.5, "src_weights": src},
        "self_per_rank": {"self_weight": list(rng.uniform(0.3, 0.6, n)),
                          "src_weights": src},
        "dst_dicts": {"self_weight": 0.5, "src_weights": src,
                      "dst_weights": [{(r + 1) % n: 0.5, (r - 2) % n: 2.0}
                                      for r in range(n)]},
        "dst_lists": {"self_weight": 0.5, "src_weights": src,
                      "dst_weights": [[(r + 1) % n, (r - 2) % n]
                                      for r in range(n)]},
    }


@pytest.mark.parametrize("policy", list(_policies(N)))
def test_resolve_schedule_and_neighbor_allreduce(both, policy):
    from bluefog_tpu import api as japi
    from bluefog_tpu_torch import api as tapi
    jbf.set_topology(jtopo.ExponentialTwoGraph(N), is_weighted=True)
    tbf.set_topology(ttopo.ExponentialTwoGraph(N), is_weighted=True)
    kw = _policies(N)[policy]
    _same_schedule(japi.resolve_schedule(**kw), tapi.resolve_schedule(**kw))
    x = np.random.default_rng(1).normal(size=(N, 5, 3)).astype(np.float32)
    want = np.asarray(jbf.neighbor_allreduce(jbf.shard_distributed(x), **kw))
    got = tbf.neighbor_allreduce(tbf.shard_distributed(x), **kw)
    assert got.dtype == torch.float32
    for r in range(N):
        np.testing.assert_allclose(got[r].numpy(), want[r], rtol=0,
                                   atol=1e-6)


def test_resolve_schedule_errors_and_dynamic_schedules(both):
    from bluefog_tpu import api as japi
    from bluefog_tpu_torch import api as tapi
    src = [{(r - 1) % N: 0.5} for r in range(N)]
    bad = [{"self_weight": 0.5},
           {"src_weights": src},
           {"dst_weights": [[1]] * N},
           {"self_weight": 0.5, "src_weights": {1: 0.5}},
           {"schedule": jbf.static_schedule(), "self_weight": 0.5}]
    for kw in bad:
        tkw = dict(kw)
        if "schedule" in tkw:
            tkw["schedule"] = tbf.static_schedule()
        assert _error(japi.resolve_schedule, **kw) == \
            _error(tapi.resolve_schedule, **tkw)
    topo_j, topo_t = jtopo.ExponentialTwoGraph(N), ttopo.ExponentialTwoGraph(N)
    js = jsch.compile_dynamic_schedules(
        lambda r: jtopo.GetDynamicOnePeerSendRecvRanks(topo_j, r), N)
    ts = tsch.compile_dynamic_schedules(
        lambda r: ttopo.GetDynamicOnePeerSendRecvRanks(topo_t, r), N)
    x = np.random.default_rng(2).normal(size=(N, 4)).astype(np.float32)
    for a, b in zip(js, ts):
        _same_schedule(a, b)
        want = np.asarray(jbf.neighbor_allreduce(jbf.shard_distributed(x),
                                                 schedule=a))
        got = tbf.neighbor_allreduce(tbf.shard_distributed(x), schedule=b)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_sync_barrier_and_shard_on_the_cpu(both):
    x = tbf.shard_distributed(np.ones((N, 2), np.float32))
    assert x.device.type == "cpu" and x.shape == (N, 2)
    assert tbf.synchronize(x) is x and tbf.hard_sync({"a": x}) == {"a": x}
    tbf.barrier()


def _jax_consensus(cpu_devices, dynamic, data_size, max_iters=200,
                   seed=2020):
    """examples/average_consensus.py's loop (expo2, weighted), kept as the
    example runs it on the 8 virtual devices."""
    import jax.numpy as jnp
    jbf.init(devices=cpu_devices[:N])
    try:
        topo = jtopo.ExponentialTwoGraph(N)
        jbf.set_topology(topo, is_weighted=True)
        rng = np.random.default_rng(seed)
        x = jnp.asarray(rng.normal(size=(N, data_size)), dtype=jnp.float32)
        x = jbf.shard_distributed(x)
        global_mean = np.asarray(x).mean(axis=0)
        scheds = jsch.compile_dynamic_schedules(
            lambda r: jtopo.GetDynamicOnePeerSendRecvRanks(topo, r), N) \
            if dynamic else None
        hist = []
        for it in range(max_iters):
            if scheds is not None:
                x = jbf.neighbor_allreduce(
                    x, schedule=scheds[it % len(scheds)])
            else:
                x = jbf.neighbor_allreduce(x)
            x = jbf.synchronize(x)
            hist.append(float(((np.asarray(x) - global_mean) ** 2).mean()))
            if hist[-1] < 1e-10:
                break
        return hist
    finally:
        jbf.shutdown()


@pytest.mark.parametrize("dynamic", [False, True])
def test_consensus_example_matches_jax(cpu_devices, dynamic):
    want = _jax_consensus(cpu_devices, dynamic, data_size=100)
    got = average_consensus.consensus("expo2", dynamic=dynamic, ranks=N,
                                      data_size=100, device="cpu")
    tbf.shutdown()
    assert len(got) == len(want) and got[-1] < 1e-10
    assert got == want


def test_consensus_example_cli_runs_every_topology():
    for topo in sorted(average_consensus.TOPOLOGIES):
        assert average_consensus.main(["--device", "cpu", "--data-size",
                                       "50", "--topology", topo]) == 0
    tbf.shutdown()
