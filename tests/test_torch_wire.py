"""The port's wire codecs, their gossip and the machine level against the
JAX package on the CPU.

* ``_wire_encode`` for ``bf16``, ``int8``, ``int8@256``, ``fp8`` and
  ``fp8@64``: payload bytes and scales bit-equal to the JAX function as
  it runs compiled (``jax.jit``; every JAX gossip path is compiled, and
  XLA turns ``amax / qmax`` into ``amax * (1 / qmax)`` there), decoding
  bit-equal too, on buffers whose sizes do not divide the blocks; the
  stacked form (``lead=1``: one scale set a rank) equals the per-rank
  encode row for row.  An all-zero row and a subnormal row are pinned as
  in ``tests/test_torch_kv_cache.py``: XLA on the CPU flushes the
  subnormal amax to zero (scale 1), the port keeps it (floored scale);
  both store and decode a zero row.
* ``neighbor_allreduce(wire=)`` per codec, on a static and on a
  dst-weighted schedule, and ``hierarchical_neighbor_allreduce`` with
  and without a machine wire, row for row against the JAX ops (the
  same decoded values; the f32 combine to 1e-6); the DCN-wire default
  (context knob, ``BLUEFOG_DCN_WIRE``, ``"off"``); the grammar's and the
  non-float input's error texts.
* ``compose_parallelism(..., wire="bf16")``: the composed trainer at
  (dp, pp, tp, sp) = (2, 1, 1, 1) against the JAX trainer for one step.
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
from bluefog_tpu import schedule as jsch
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import collectives as jcoll
from bluefog_tpu.parallel import compose as jcompose
import bluefog_tpu_torch as tbf
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch import schedule as tsch
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.fusion import tree_flatten
from bluefog_tpu_torch.ops import collectives as tcoll
from bluefog_tpu_torch.parallel import compose as tcompose
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N = 8
CODECS = ["bf16", "int8", "int8@256", "fp8", "fp8@64"]


def _bits(a):
    """Raw bits of a codec part (bf16 / f32 / int8 / e4m3fn)."""
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            return a.view(torch.uint8 if a.element_size() == 1
                          else torch.int16).numpy()
        return np.atleast_1d(a.numpy()).view(np.uint8)
    a = np.atleast_1d(np.asarray(a))
    return a.view(np.uint8 if a.dtype.itemsize == 1 else
                  np.int16 if a.dtype.itemsize == 2 else np.uint8)


def _buffers():
    rng = np.random.default_rng(0)
    out = []
    for shape, mag in (((1000,), 1e-3), ((3, 333), 1.0), ((4097,), 1e4)):
        x = rng.normal(size=shape) * mag
        x.reshape(-1)[7] = 40 * mag        # an outlier in the first block
        out.append(x.astype(np.float32))
    return out


@pytest.mark.parametrize("wire", CODECS)
def test_encode_decode_bit_equal_to_compiled_jax(wire):
    enc = jax.jit(lambda x: jcoll._wire_encode(wire, x))
    for x in _buffers():
        jparts = enc(jnp.asarray(x))
        tparts = tcoll._wire_encode(wire, torch.from_numpy(x))
        assert len(jparts) == len(tparts)
        for j, t in zip(jparts, tparts):
            assert tuple(t.shape) == tuple(j.shape)
            np.testing.assert_array_equal(_bits(t), _bits(j))
        dec = jax.jit(lambda *p: jcoll._wire_decode(
            wire, p, jnp.float32, shape=x.shape))
        np.testing.assert_array_equal(
            tcoll._wire_decode(wire, tparts, torch.float32,
                               shape=x.shape).numpy(),
            np.asarray(dec(*jparts)))


@pytest.mark.parametrize("wire", CODECS)
def test_stacked_encode_is_per_rank(wire):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(N, 3, 70)) * np.logspace(-3, 3, N)[:, None, None]
         ).astype(np.float32)
    stacked = tcoll._wire_encode(wire, torch.from_numpy(x), lead=1)
    for r in range(N):
        rows = tcoll._wire_encode(wire, torch.from_numpy(x[r]))
        for s, one in zip(stacked, rows):
            np.testing.assert_array_equal(
                _bits(s[r].contiguous()).reshape(-1),
                _bits(one).reshape(-1))
    back = tcoll._wire_decode(wire, stacked, torch.float32, shape=x.shape,
                              lead=1)
    assert back.shape == x.shape


@pytest.mark.parametrize("wire", ["int8", "int8@4", "fp8", "fp8@4"])
def test_zero_and_subnormal_rows_store_zeros(wire):
    x = np.zeros((2, 8), np.float32)
    x[1, 3] = 1e-41                        # subnormal amax
    tparts = tcoll._wire_encode(wire, torch.from_numpy(x), lead=1)
    back = tcoll._wire_decode(wire, tparts, torch.float32, shape=x.shape,
                              lead=1)
    assert not back.abs().max()
    assert not tparts[0].view(torch.uint8).any()
    for r in range(2):
        jparts = jax.jit(lambda v: jcoll._wire_encode(wire, v))(
            jnp.asarray(x[r]))
        np.testing.assert_array_equal(_bits(np.asarray(jparts[0])), 0)
    # the subnormal amax: XLA flushes it (scale 1), the port floors it
    assert tparts[1][1].reshape(-1)[0].item() == np.finfo(np.float32).tiny


def test_wire_grammar_texts():
    for bad, want in (("bf16@4", "bf16 is a plain cast"),
                      ("int8@", "bad wire block size"),
                      ("int8@0", "bad wire block size"),
                      (8, "unknown wire codec")):
        with pytest.raises(ValueError) as tj:
            jcoll._parse_wire(bad)
        with pytest.raises(ValueError) as tt:
            tcoll._parse_wire(bad)
        assert str(tt.value) == str(tj.value) and want in str(tt.value)
    for bad in ("int7", "fp16@4"):
        with pytest.raises(ValueError) as tj:
            jcoll._check_wire(bad)
        with pytest.raises(ValueError) as tt:
            tcoll._check_wire(bad)
        assert str(tt.value) == str(tj.value)
    with pytest.raises(ValueError, match="choose from"):
        tcoll._wire_encode("int4", torch.zeros(3))
    sched = tsch.compile_topology(ttopo.RingGraph(N), True)
    with pytest.raises(ValueError, match="needs a real float input"):
        tcoll.neighbor_allreduce(torch.zeros(N, 3, dtype=torch.int32),
                                 sched, wire="int8")


def _jax_op(devices, op):
    mesh = Mesh(np.array(devices[:N]), ("rank",))
    return jax.jit(jax.shard_map(op, mesh=mesh, in_specs=P("rank"),
                                 out_specs=P("rank")))


def _dst_weighted(mod):
    srcs = [{(r - 1) % N: 0.25, (r + 2) % N: 0.25} for r in range(N)]
    dsts = [{(r + 1) % N: 0.5, (r - 2) % N: 2.0} for r in range(N)]
    return mod.compile_from_weights(N, [0.5] * N, srcs, dsts)


@pytest.mark.parametrize("dst", [False, True], ids=["static", "dst"])
@pytest.mark.parametrize("wire", CODECS)
def test_neighbor_allreduce_wire_matches_jax(cpu_devices, wire, dst):
    if dst:
        jsched, tsched = _dst_weighted(jsch), _dst_weighted(tsch)
    else:
        jsched = jsch.compile_topology(jtopo.ExponentialTwoGraph(N), True)
        tsched = tsch.compile_topology(ttopo.ExponentialTwoGraph(N), True)
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(N, 5, 61)) * np.logspace(-2, 2, N)[:, None, None]
         ).astype(np.float32)
    fn = _jax_op(cpu_devices, lambda b: jcoll.neighbor_allreduce(
        b[0], jsched, axis="rank", wire=wire)[None])
    want = np.asarray(fn(jnp.asarray(x)))
    got = tcoll.neighbor_allreduce(torch.from_numpy(x), tsched,
                                   wire=wire).numpy()
    scale = np.abs(want).reshape(N, -1).max(axis=1)[:, None, None]
    assert (np.abs(got - want) <= 1e-6 * scale).all(), \
        np.abs(got - want).max()
    exact = tcoll.neighbor_allreduce(torch.from_numpy(x), tsched).numpy()
    assert not np.array_equal(got, exact)


def _hier_ctx(cpu_devices):
    jbf.init(devices=cpu_devices[:N], nodes_per_machine=2)
    jbf.set_machine_topology(jtopo.RingGraph(4), is_weighted=True)
    tbf.init(size=N, device="cpu", nodes_per_machine=2)
    tbf.set_machine_topology(ttopo.RingGraph(4), is_weighted=True)


@pytest.mark.parametrize("wire", [None, "int8", "fp8@64"])
def test_hierarchical_matches_jax(cpu_devices, wire):
    _hier_ctx(cpu_devices)
    try:
        assert (tbf.local_size(), tbf.machine_size()) == (2, 4)
        assert tbf.in_neighbor_machine_ranks(0) == \
            jbf.in_neighbor_machine_ranks(0)
        x = np.random.default_rng(3).normal(size=(N, 100)).astype(
            np.float32)
        want = np.asarray(jbf.hierarchical_neighbor_allreduce(
            jnp.asarray(x), wire=wire))
        got = tbf.hierarchical_neighbor_allreduce(torch.from_numpy(x),
                                                  wire=wire).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        # every local rank of a machine holds its machine's result
        np.testing.assert_array_equal(got[0::2], got[1::2])
    finally:
        jbf.shutdown()
        tbf.shutdown()


def test_dcn_wire_default(cpu_devices, monkeypatch):
    _hier_ctx(cpu_devices)
    try:
        x = torch.from_numpy(np.random.default_rng(4).normal(
            size=(N, 50)).astype(np.float32))
        explicit = tbf.hierarchical_neighbor_allreduce(x, wire="int8")
        exact = tbf.hierarchical_neighbor_allreduce(x)
        tbf.set_dcn_wire("int8")
        assert tbf.dcn_wire() == "int8"
        assert torch.equal(tbf.hierarchical_neighbor_allreduce(x), explicit)
        assert torch.equal(tbf.hierarchical_neighbor_allreduce(
            x, wire="off"), exact)
        tbf.set_dcn_wire(None)
        with pytest.raises(ValueError, match="wire codec"):
            tbf.set_dcn_wire("float7")
        monkeypatch.setenv("BLUEFOG_DCN_WIRE", "bf16")
        assert tcoll._default_dcn_wire() == "bf16"
        monkeypatch.setenv("BLUEFOG_DCN_WIRE", "off")
        assert tcoll._default_dcn_wire() is None
        monkeypatch.setenv("BLUEFOG_DCN_WIRE", "int7")
        with pytest.raises(ValueError, match="wire codec"):
            tcoll._default_dcn_wire()
    finally:
        jbf.shutdown()
        tbf.shutdown()
    with pytest.raises(ValueError, match="not divisible by "
                                         "nodes_per_machine 3"):
        tbf.init(size=N, device="cpu", nodes_per_machine=3)


_CFG = dict(vocab=32, d_model=16, heads=2, layers=2, seq_len=16, micro=2,
            batch=2, lag=2)


def test_compose_wire_bf16_step_matches_jax(cpu_devices):
    jm = jcompose.compose_parallelism(2, 1, 1, 1, devices=cpu_devices[:2],
                                      wire="bf16")
    jcfg = jcompose.LMConfig(**_CFG)
    jstep, jstrat = jcompose.make_train_step(
        jm, jcompose.make_lm_grad_fn(jcfg, jm), optax.sgd(0.5),
        delayed=False)
    jparams = jcompose.init_lm_params(jcfg, jm)
    jstate = jopt.init_distributed(jstrat, jparams)
    toks = jcompose.make_lm_batch(jcfg, jm)
    jparams = jcompose.device_put(jm, jparams)
    tparams_np = jax.tree.map(np.asarray, jparams)
    jparams, _, jloss = jstep(jparams, jstate, toks)

    tm = tcompose.compose_parallelism(2, device="cpu", wire="bf16")
    assert tm.wire == "bf16" and tm.describe()["wire"] == "bf16"
    tcfg = tcompose.LMConfig(**_CFG)
    tstep, tstrat = tcompose.make_train_step(
        tm, tcompose.make_lm_grad_fn(tcfg, tm), topt.sgd(0.5),
        delayed=False)
    tparams = tcompose.init_lm_train_params(tcfg, tm)
    for a, b in zip(jax.tree.leaves(tparams_np), tree_flatten(tparams)[0]):
        np.testing.assert_array_equal(b.numpy(), a)
    tstate = topt.init_distributed(tstrat, tparams)
    ttoks = tcompose.make_lm_batch(tcfg, tm)
    tparams, _, tloss = tstep(tparams, tstate, ttoks)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jparams), tree_flatten(tparams)[0]):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=2e-5 * max(np.abs(a).max(), 1e-3))
    with pytest.raises(ValueError, match="unknown wire codec"):
        tcompose.compose_parallelism(2, device="cpu", wire="int7")


def test_lm_bench_wire_flag():
    """``tools/lm_bench.py --wire`` carves the gossip's codec (the JAX
    tool's flag) and the carving's description names it."""
    from bluefog_tpu_torch.tools import lm_bench
    doc = lm_bench.main(["--device", "cpu", "--pp", "1", "--tp", "1",
                         "--iters", "1", "--steps-per-call", "1",
                         "--wire", "fp8@64"])
    assert doc["mesh"]["wire"] == "fp8@64" and doc["mesh"]["dp"] == 2
    assert np.isfinite(doc["losses"]).all()
