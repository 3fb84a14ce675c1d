"""The port's stacked collectives vs the JAX ops under ``shard_map``.

JAX runs one block per virtual CPU device (the ``cpu_devices`` fixture);
the port holds the same 8 blocks stacked on dim 0.  Row r of the JAX
result must equal port rank r (atol 1e-6: the same f32 multiply-adds in
the same round order), and both must equal the dense mixing ``W^T X``
read off the compiled tables.  Fusion into ``[n, total]`` buffers must
not mix ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from bluefog_tpu import schedule as jsch
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import collectives as jcoll
from bluefog_tpu_torch import fusion as tfusion
from bluefog_tpu_torch import schedule as tsch
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import collectives as tcoll
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N = 8
TOPOS = ["ExponentialTwoGraph", "RingGraph", "StarGraph", "MeshGrid2DGraph",
         "FullyConnectedGraph"]


def _jax_op(devices, op):
    mesh = Mesh(np.array(devices[:N]), ("rank",))
    return jax.jit(jax.shard_map(op, mesh=mesh, in_specs=P("rank"),
                                 out_specs=P("rank")))


def _dense(sched):
    """``W[src, dst]`` the schedule applies (send scales folded in)."""
    W = np.diag(sched.self_weight.astype(np.float64))
    for r in range(sched.num_rounds):
        for d in range(sched.size):
            s = sched.recv_src[r, d]
            if s >= 0:
                scale = (sched.send_scale[r, s] if sched.uses_dst_weighting
                         else 1.0)
                W[s, d] += sched.recv_weight[r, d] * scale
    return W


def _x(seed, shape=(N, 3, 5)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("concurrent", [False, True])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("gen", TOPOS)
def test_neighbor_allreduce_matches_jax_row_for_row(cpu_devices, gen,
                                                    weighted, concurrent):
    jsched = jsch.compile_topology(getattr(jtopo, gen)(N), weighted)
    tsched = tsch.compile_topology(getattr(ttopo, gen)(N), weighted)
    x = _x(1)
    fn = _jax_op(cpu_devices, lambda b: jcoll.neighbor_allreduce(
        b, jsched, axis="rank", concurrent=concurrent))
    want = np.asarray(fn(jnp.asarray(x)))
    got = tcoll.neighbor_allreduce(torch.from_numpy(x), tsched,
                                   concurrent=concurrent).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    dense = np.einsum("sd,s...->d...", _dense(tsched), x.astype(np.float64))
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-6)


def test_dst_weighted_and_irregular_schedule_matches_jax(cpu_devices):
    srcs = [{(d - 1) % N: 0.3} for d in range(N)]
    srcs[2] = {}                              # rank 2 receives nothing
    dsts = [dict() for _ in range(N)]
    for d, s in enumerate(srcs):
        for src in s:
            dsts[src][d] = 0.5 + 0.1 * src
    selfw = [0.7] * N
    selfw[2] = 1.0
    jsched = jsch.compile_from_weights(N, selfw, srcs, dsts)
    tsched = tsch.compile_from_weights(N, selfw, srcs, dsts)
    assert tsched.uses_dst_weighting
    x = _x(2)
    fn = _jax_op(cpu_devices, lambda b: jcoll.neighbor_allreduce(
        b, jsched, axis="rank"))
    want = np.asarray(fn(jnp.asarray(x)))
    got = tcoll.neighbor_allreduce(torch.from_numpy(x), tsched).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the wire codecs ride the dst-scaled sends (tests/test_torch_wire.py
    # holds every codec to JAX; here bf16 on this schedule)
    wfn = _jax_op(cpu_devices, lambda b: jcoll.neighbor_allreduce(
        b, jsched, axis="rank", wire="bf16"))
    np.testing.assert_allclose(
        tcoll.neighbor_allreduce(torch.from_numpy(x), tsched,
                                 wire="bf16").numpy(),
        np.asarray(wfn(jnp.asarray(x))), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match=r"stacked \[n=8"):
        tcoll.neighbor_allreduce(torch.from_numpy(x[:4]), tsched)


@pytest.mark.parametrize("average", [True, False])
def test_allreduce_allgather_broadcast_match_jax(cpu_devices, average):
    x = _x(3)
    want = np.asarray(_jax_op(cpu_devices, lambda b: jcoll.allreduce(
        b, average=average, axis="rank"))(jnp.asarray(x)))
    got = tcoll.allreduce(torch.from_numpy(x), average=average).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    mesh = Mesh(np.array(cpu_devices[:N]), ("rank",))
    gather = jax.jit(jax.shard_map(
        lambda b: jcoll.allgather(b[0], axis="rank")[None], mesh=mesh,
        in_specs=P("rank"), out_specs=P("rank")))
    np.testing.assert_array_equal(
        tcoll.allgather(torch.from_numpy(x)).numpy(),
        np.asarray(gather(jnp.asarray(x))))
    bcast = _jax_op(cpu_devices, lambda b: jcoll.broadcast(b, 5,
                                                           axis="rank"))
    np.testing.assert_array_equal(
        tcoll.broadcast(torch.from_numpy(x), 5).numpy(),
        np.asarray(bcast(jnp.asarray(x))))


def test_fused_tree_keeps_ranks_apart():
    tree = {"b": torch.from_numpy(_x(4, (N, 2, 3))),
            "a": [torch.from_numpy(_x(5, (N, 7))),
                  torch.arange(N * 2, dtype=torch.int32).reshape(N, 2)]}
    fused = tfusion.fuse_tree(tree)
    assert [tuple(b.shape) for b in fused.buffers] == [(N, 13), (N, 2)]
    back = fused.unfuse()
    assert torch.equal(back["b"], tree["b"])
    assert torch.equal(back["a"][0], tree["a"][0])
    assert torch.equal(back["a"][1], tree["a"][1])
    sched = tsch.compile_topology(ttopo.RingGraph(N))
    op = lambda t: tcoll.neighbor_allreduce(t, sched)      # noqa: E731
    fl = tfusion.fused_leaf_op(op)({"b": tree["b"], "a": tree["a"][0]})
    assert torch.allclose(fl["b"], op(tree["b"]), rtol=0, atol=1e-7)
    assert torch.allclose(fl["a"], op(tree["a"][0]), rtol=0, atol=1e-7)
