"""The port's wire-byte ledger (``bluefog_tpu_torch/utils/wire_bytes.py``)
against the JAX counters (``bluefog_tpu/utils/hlo_bytes.py``), collective
kind by collective kind and codec by codec, on the CPU:

* over the rank axis of 8 devices (one replica block a rank, so every
  move is DCN): gossip (``neighbor_allreduce`` on Exp2) at every wire
  codec, the allreduce, the allgather and the broadcast tree: the
  ledger's ``stablehlo_wire_stats`` equals the JAX function's on the
  lowered ``shard_map`` program (counts, bytes, dtypes, side), and its
  ``wire_stats`` bytes equal the compiled program's where the CPU backend
  keeps the op as written;
* over a peer axis (a 2 x 4 mesh, the collectives over the inner axis,
  replica blocks of 4): ``psum``, ``ppermute`` and ``all_to_all`` are ICI
  with the per-device payload, and a gossip permute over the outer axis is
  DCN;
* the ledger's own rules: disarmed nothing is kept, a backward records
  the transpose, a paused block records nothing, ``steps`` cuts a call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu import schedule as jsch
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import collectives as jcoll
from bluefog_tpu.utils.hlo_bytes import stablehlo_wire_stats, wire_stats
from bluefog_tpu_torch import schedule as psch
from bluefog_tpu_torch import topology as ptopo
from bluefog_tpu_torch.ops import collectives as pcoll
from bluefog_tpu_torch.utils import wire_bytes as wb
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N = 8
ROW = (3, 40)                 # one rank's block: 120 f32


def _jax_stats(fn, x, devices, slice_size=1, mesh_shape=None,
               axes=("rank",), spec=None):
    """``(stablehlo stats, compiled wire_stats)`` of ``fn`` per device."""
    devs = np.array(devices).reshape(mesh_shape or (len(devices),))
    mesh = Mesh(devs, axes)
    spec = spec if spec is not None else P(axes[0])
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,),
                              out_specs=spec, check_vma=False))
    low = f.lower(x)
    return (stablehlo_wire_stats(low.as_text(), slice_size),
            wire_stats(low.compile().as_text()))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _same_shlo(got, want):
    for side in ("ici", "dcn"):
        assert got[side] == want[side], (side, got[side], want[side])
    for key in ("ici_bytes", "dcn_bytes", "ici_dtypes", "dcn_dtypes"):
        assert got[key] == want[key], (key, got[key], want[key])


@pytest.mark.parametrize("wire", [None, "bf16", "int8", "fp8", "int8@64",
                                  "fp8@64"])
def test_gossip_permutes_match_stablehlo(cpu_devices, wire):
    """Exp2 gossip, one row a rank: a permute a round and encoded array
    (codes + f32 scales for the quantizers), DCN, the codec's dtypes."""
    x = _x((N,) + ROW)
    jsched = jsch.compile_topology(jtopo.ExponentialTwoGraph(N),
                                   weighted=True)
    want, _ = _jax_stats(
        lambda v: jcoll.neighbor_allreduce(v[0], jsched, wire=wire)[None],
        x, cpu_devices)
    psched = psch.compile_topology(ptopo.ExponentialTwoGraph(N),
                                   weighted=True)
    with wb.ledger() as led:
        pcoll.neighbor_allreduce(torch.from_numpy(x), psched, wire=wire)
    _same_shlo(led.stablehlo_wire_stats(), want)
    assert want["dcn_bytes"] > 0


def test_gossip_f32_matches_compiled_hlo(cpu_devices):
    """Full width: the compiled program's per-chip permute bytes too."""
    x = _x((N,) + ROW, 1)
    jsched = jsch.compile_topology(jtopo.ExponentialTwoGraph(N),
                                   weighted=True)
    _, (jcounts, jbytes) = _jax_stats(
        lambda v: jcoll.neighbor_allreduce(v[0], jsched)[None], x,
        cpu_devices)
    psched = psch.compile_topology(ptopo.ExponentialTwoGraph(N),
                                   weighted=True)
    with wb.ledger() as led:
        pcoll.neighbor_allreduce(torch.from_numpy(x), psched)
    counts, bytes_ = led.wire_stats()
    assert bytes_ == jbytes and counts == jcounts
    assert bytes_ == {"collective-permute": 3 * 120 * 4}


@pytest.mark.parametrize("op", ["allreduce", "allgather", "broadcast"])
def test_rank_axis_collectives_match(cpu_devices, op):
    """allreduce: one all_reduce of the payload; allgather: the gathered
    result, ``out * (n-1) / n`` on the wire; broadcast: the JAX tree's
    log2(n) permute rounds."""
    x = _x((N,) + ROW, 2)
    jfn = {"allreduce": lambda v: jcoll.allreduce(v[0])[None],
           "allgather": lambda v: jcoll.allgather(v[0])[None],
           "broadcast": lambda v: jcoll.broadcast(v[0], 3)[None]}[op]
    want, (_, jbytes) = _jax_stats(jfn, x, cpu_devices)
    with wb.ledger() as led:
        t = torch.from_numpy(x)
        {"allreduce": lambda: pcoll.allreduce(t),
         "allgather": lambda: pcoll.allgather(t),
         "broadcast": lambda: pcoll.broadcast(t, 3)}[op]()
    _same_shlo(led.stablehlo_wire_stats(), want)
    _, bytes_ = led.wire_stats()
    assert bytes_ == jbytes
    if op == "allgather":
        assert bytes_ == {"all-gather": 120 * 4 * (N - 1)}


@pytest.mark.parametrize("op", ["psum", "ppermute", "all_to_all"])
def test_peer_axis_collectives_are_ici(cpu_devices, op):
    """A 2 x 4 carving, the op over the inner axis: ICI, each device's
    own block as the payload (the stacked tensor ``[2, 4, ...]`` with both
    dims stacking chips)."""
    x = _x((2, 4, 4, 6), 3)
    perm = [(i, (i + 1) % 4) for i in range(4)]

    def jfn(v):
        b = v[0, 0]
        if op == "psum":
            y = jax.lax.psum(b, "in")
        elif op == "ppermute":
            y = jax.lax.ppermute(b, "in", perm)
        else:
            y = jax.lax.all_to_all(b, "in", 0, 1, tiled=True)
        return y[None, None]

    want, _ = _jax_stats(jfn, x, cpu_devices, slice_size=4,
                         mesh_shape=(2, 4), axes=("out", "in"),
                         spec=P("out", "in"))
    t = torch.from_numpy(x)
    with wb.ledger(slice_size=4) as led:
        if op == "psum":
            pcoll.psum(t, 1)
        elif op == "ppermute":
            pcoll.ppermute(t, 1, perm)
        else:
            pcoll.all_to_all(t, 1, 2, 3)
    _same_shlo(led.stablehlo_wire_stats(), want)
    assert want["ici_bytes"] == 4 * 6 * 4 and want["dcn_bytes"] == 0


def test_replica_gossip_is_dcn_with_peer_shares(cpu_devices):
    """Gossip over the outer axis of a 2 x 4 carving (each replica's 4
    peers in one row, ``lead=2``): DCN, one device's block a round."""
    x = _x((2, 4, 5), 4)

    def jfn(v):
        return jax.lax.ppermute(v[0, 0], "out", [(0, 1), (1, 0)])[None,
                                                                  None]

    want, _ = _jax_stats(jfn, x, cpu_devices, slice_size=4,
                         mesh_shape=(2, 4), axes=("out", "in"),
                         spec=P("out", "in"))
    sched = psch.compile_topology(ptopo.ExponentialTwoGraph(2),
                                  weighted=True)
    with wb.ledger(slice_size=4) as led:
        pcoll.neighbor_allreduce(torch.from_numpy(x), sched, lead=2)
    _same_shlo(led.stablehlo_wire_stats(), want)
    assert want["dcn_bytes"] == 5 * 4


def test_disarmed_paused_transpose_and_steps():
    t = torch.ones(4, 2, 3, requires_grad=True)
    pcoll.psum(t, 1)                          # disarmed: nothing kept
    assert wb._armed is None
    with wb.ledger() as led:
        y = pcoll.psum(t, 1, lead=2)
        assert len(led.events) == 1
        y.sum().backward()                   # the transpose's all_reduce
        assert len(led.events) == 2
        with wb.paused():
            pcoll.psum(t, 1)
        assert len(led.events) == 2
        pcoll.psum(t.detach(), 1, lead=2)
    assert led.stablehlo_wire_stats()["ici"]["all_reduce"] == {
        "count": 3, "bytes": 3 * 3 * 4}
    first, second, third = led.steps(3)
    assert len(first.events) == 1
    with pytest.raises(ValueError):
        led.steps(2)
    # a peer dim of one moves nothing
    with wb.ledger() as led:
        pcoll.psum(torch.ones(2, 1, 3), 1)
    assert led.events == []
