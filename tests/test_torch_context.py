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


def test_init_refuses_a_multiprocess_launch(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="ROADMAP queue 1, item 5"):
        tbf.init(size=2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tbf.init(size=2, device="cpu").size == 2
    tbf.shutdown()


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
