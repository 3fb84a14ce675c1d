"""The port's pipeline schedules against the JAX functions on the CPU:
``pipeline_interleaved_apply``, ``pipeline_1f1b_grad``,
``pack_stage_params`` and ``pipeline_apply_stages``.

JAX runs each function under ``shard_map`` over the conftest's virtual
CPU devices, one stage a device; the port stacks the same stages on dim
0 of one tensor.  Inputs come from a numpy seed (the sizes of
``tests/test_pipeline.py``: 4 stages, 2 x 5 activations).  Forward values
and gradients agree to rtol 1e-5 / atol 1e-6 in f32 (the same products,
summed in orders that differ between XLA's fused program and torch's
batched calls).  The refusals (``M > S``, mixed parameter dtypes, a stage
output that contradicts its declared shape, list lengths) raise the JAX
texts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu.parallel import pipeline as jpipe
from bluefog_tpu_torch.parallel import pipeline as tpipe
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

S, M, B, D = 4, 6, 2, 5
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _mesh(cpu_devices):
    return Mesh(np.array(cpu_devices[:S]), ("stage",))


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _port_fn(p, x):                  # k stages at once: x [k, B, D]
    return torch.tanh(torch.bmm(x, p["w"]) + p["b"][:, None])


def _error(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


# -- interleaved ------------------------------------------------------------

V = 2


def _chunked(seed, m):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(V * S, D, D)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(V * S, D)) * 0.1).astype(np.float32)
    mb = rng.normal(size=(m, B, D)).astype(np.float32)
    tgt = rng.normal(size=(m, B, D)).astype(np.float32)
    # Megatron placement: [V*S, ...] -> [S, V, ...], [d, k] = k*S + d
    chunk = {k: np.moveaxis(v.reshape((V, S) + v.shape[1:]), 1, 0).copy()
             for k, v in (("w", w), ("b", b))}
    return chunk, mb, tgt


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("m", [1, 4])
def test_interleaved_matches_jax(cpu_devices, m, remat):
    chunk, mb, tgt = _chunked(2, m)

    def f(params, mbs, tgts):
        local = jax.tree.map(lambda p: p[0], params)            # [V, ...]

        def loss(p):
            out = jpipe.pipeline_interleaved_apply(
                lambda q, x: jnp.tanh(x @ q["w"] + q["b"]), p, mbs[0],
                remat=remat)
            return jnp.mean((jpipe.last_stage_value(out) - tgts[0]) ** 2), \
                out
        (l, out), g = jax.value_and_grad(loss, has_aux=True)(local)
        return l[None], out[None], jax.tree.map(lambda x: x[None], g)

    jl, jout, jg = jax.jit(jax.shard_map(
        f, mesh=_mesh(cpu_devices), in_specs=(P("stage"), P(None), P(None)),
        out_specs=(P("stage"),) * 3))(chunk, mb[None], tgt[None])
    tp = {k: _t(v, grad=True) for k, v in chunk.items()}
    out = tpipe.pipeline_interleaved_apply(_port_fn, tp, _t(mb),
                                           remat=remat)
    loss = ((out - _t(tgt)) ** 2).mean()
    loss.backward()
    _close(out.detach(), np.asarray(jout)[S - 1], "out")
    _close(loss.item(), np.asarray(jl)[0], "loss")
    for k in ("w", "b"):
        _close(tp[k].grad, jg[k], k)


def test_interleaved_refuses_too_many_microbatches(cpu_devices):
    chunk, _, _ = _chunked(0, 1)
    mb = np.zeros((S + 1, B, D), np.float32)

    def f(params, mbs):
        return jpipe.pipeline_interleaved_apply(
            lambda q, x: jnp.tanh(x @ q["w"] + q["b"]),
            jax.tree.map(lambda p: p[0], params), mbs[0])[None]

    fn = jax.jit(jax.shard_map(f, mesh=_mesh(cpu_devices),
                               in_specs=(P("stage"), P(None)),
                               out_specs=P("stage")))
    want = _error(fn, chunk, mb[None])
    assert "M <= S" in want
    got = _error(tpipe.pipeline_interleaved_apply, _port_fn,
                 {k: _t(v) for k, v in chunk.items()}, _t(mb))
    assert got == want


# -- 1F1B -------------------------------------------------------------------

def _stages(seed, m):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(S, D, D)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(S, D)) * 0.1).astype(np.float32)
    mb = rng.normal(size=(M, B, D)).astype(np.float32)
    tgt = rng.normal(size=(M, B, D)).astype(np.float32)
    reps = -(-m // M)
    return ({"w": w, "b": b}, np.tile(mb, (reps, 1, 1))[:m],
            np.tile(tgt, (reps, 1, 1))[:m])


def _mse(y, t):
    return ((y - t) ** 2).mean()


@pytest.mark.parametrize("m", [1, 3, 12])
def test_1f1b_matches_jax_and_gpipe(cpu_devices, m):
    """M 1 and 3 shrink the stash ring to M slots, 12 wraps the 7-slot
    ring (the stage-0 same-tick slot reuse)."""
    params, mb, tgt = _stages(3, m)

    def f(p, mbs, tgts):
        loss, g = jpipe.pipeline_1f1b_grad(
            lambda q, x: jnp.tanh(x @ q["w"][0] + q["b"][0]),
            lambda y, t: jnp.mean((y - t) ** 2), p, mbs[0], tgts[0])
        return loss[None], g

    jl, jg = jax.jit(jax.shard_map(
        f, mesh=_mesh(cpu_devices), in_specs=(P("stage"), P(None), P(None)),
        out_specs=(P("stage"), P("stage"))))(params, mb[None], tgt[None])
    tp = {k: _t(v) for k, v in params.items()}
    loss, g = tpipe.pipeline_1f1b_grad(_port_fn, _mse, tp, _t(mb), _t(tgt))
    _close(loss, jl, "loss")
    assert loss.shape == (S,) and not loss[:-1].any()
    for k in ("w", "b"):
        assert g[k].dtype == torch.float32
        _close(g[k], jg[k], k)
    # and the port's GPipe under autograd, microbatch losses summed
    tg = {k: _t(v, grad=True) for k, v in params.items()}
    out = tpipe.pipeline_apply(_port_fn, tg, _t(mb))
    total = sum(_mse(out[i], _t(tgt[i])) for i in range(m))
    total.backward()
    _close(loss[-1].item(), total.item(), "gpipe loss")
    for k in ("w", "b"):
        _close(g[k], tg[k].grad, "gpipe " + k)


def test_1f1b_keeps_the_stash_to_its_ring():
    """The stash is ``min(M, 2S - 1)`` stage inputs a stage however many
    microbatches flow, and nothing of a backward tick outlives it."""
    params, mb, tgt = _stages(5, 20)
    seen = []
    real_zeros = torch.Tensor.new_zeros

    def spy(self, size, *a, **kw):
        seen.append(tuple(size))
        return real_zeros(self, size, *a, **kw)

    torch.Tensor.new_zeros = spy
    try:
        tpipe.pipeline_1f1b_grad(_port_fn, _mse,
                                 {k: _t(v) for k, v in params.items()},
                                 _t(mb), _t(tgt))
    finally:
        torch.Tensor.new_zeros = real_zeros
    assert (S, 2 * S - 1, B, D) in seen
    assert not [s for s in seen if len(s) == 4 and s[1] > 2 * S - 1]


# -- stage lists --------------------------------------------------------------

Tt, Dm, VOC = 6, 8, 16


def _hetero(seed):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)

    trees = [{"embed": w(VOC, Dm)},
             {"w1": w(Dm, Dm), "b1": w(Dm)},
             {"w2": w(Dm, Dm), "b2": w(Dm)},
             {"head": w(Dm, VOC)}]
    shapes = [(B, Tt, Dm)] * 3 + [(B, Tt, VOC)]
    tokens = rng.integers(0, VOC, size=(M, B, Tt))
    return trees, shapes, tokens


JAX_FNS = [lambda p, t: p["embed"][t],
           lambda p, x: x + jnp.tanh(x @ p["w1"] + p["b1"]),
           lambda p, x: x + jnp.tanh(x @ p["w2"] + p["b2"]),
           lambda p, x: x @ p["head"]]
PORT_FNS = [lambda p, t: p["embed"][t],
            lambda p, x: x + torch.tanh(x @ p["w1"] + p["b1"]),
            lambda p, x: x + torch.tanh(x @ p["w2"] + p["b2"]),
            lambda p, x: x @ p["head"]]


@pytest.mark.parametrize("remat", [False, True])
def test_stages_match_jax(cpu_devices, remat):
    trees, shapes, tokens = _hetero(0)
    tgt = np.random.default_rng(1).normal(
        size=(M, B, Tt, VOC)).astype(np.float32)
    jstacked, junpacks = jpipe.pack_stage_params(
        [jax.tree.map(jnp.asarray, t) for t in trees])

    def f(params, toks, tgts):
        def loss(buf):
            out = jpipe.pipeline_apply_stages(
                JAX_FNS, junpacks, buf, toks[0], boundary_shapes=shapes,
                remat=remat)
            return jnp.mean((jpipe.last_stage_value(out) - tgts[0]) ** 2), \
                out
        (l, out), g = jax.value_and_grad(loss, has_aux=True)(params[0])
        return l[None], out[None], g[None]

    jl, jout, jg = jax.jit(jax.shard_map(
        f, mesh=_mesh(cpu_devices), in_specs=(P("stage"), P(None), P(None)),
        out_specs=(P("stage"),) * 3))(
        jstacked, jnp.asarray(tokens, jnp.int32)[None], tgt[None])
    stacked, unpacks = tpipe.pack_stage_params(
        [{k: _t(v) for k, v in t.items()} for t in trees])
    np.testing.assert_array_equal(stacked.numpy(), np.asarray(jstacked))
    stacked.requires_grad_()
    out = tpipe.pipeline_apply_stages(PORT_FNS, unpacks, stacked,
                                      _t(tokens), boundary_shapes=shapes,
                                      remat=remat)
    loss = ((out - _t(tgt)) ** 2).mean()
    loss.backward()
    assert out.shape == (M, B, Tt, VOC) and out.dtype == torch.float32
    _close(out.detach(), np.asarray(jout)[S - 1], "out")
    _close(loss.item(), np.asarray(jl)[0], "loss")
    _close(stacked.grad, jg, "grads")


def test_stages_refusals_are_jax_texts(cpu_devices):
    trees, shapes, tokens = _hetero(0)
    jstacked, junpacks = jpipe.pack_stage_params(
        [jax.tree.map(jnp.asarray, t) for t in trees])
    stacked, unpacks = tpipe.pack_stage_params(
        [{k: _t(v) for k, v in t.items()} for t in trees])
    bad = list(shapes)
    bad[1] = (B, Tt, Dm + 1)                      # lie about stage 1

    def run(fns, unp, sh):
        def f(params, toks):
            return jpipe.pipeline_apply_stages(
                fns, unp, params[0], toks[0], boundary_shapes=sh)[None]
        return jax.jit(jax.shard_map(
            f, mesh=_mesh(cpu_devices), in_specs=(P("stage"), P(None)),
            out_specs=P("stage")))(jstacked, jnp.asarray(tokens)[None])

    want = _error(run, JAX_FNS, junpacks, bad)
    assert "stage 1 returned" in want
    assert _error(tpipe.pipeline_apply_stages, PORT_FNS, unpacks, stacked,
                  _t(tokens), boundary_shapes=bad) == want
    assert _error(tpipe.pipeline_apply_stages, PORT_FNS[:3], unpacks,
                  stacked, _t(tokens), boundary_shapes=shapes) == \
        _error(run, JAX_FNS[:3], junpacks, shapes)
    # four stage functions on a 2-stage axis
    two = Mesh(np.array(cpu_devices[:2]), ("stage",))

    def f2(params, toks):
        return jpipe.pipeline_apply_stages(
            JAX_FNS, junpacks, params[0], toks[0],
            boundary_shapes=shapes)[None]

    want = _error(jax.jit(jax.shard_map(
        f2, mesh=two, in_specs=(P("stage"), P(None)), out_specs=P("stage"))),
        jstacked[:2], jnp.asarray(tokens)[None])
    assert _error(tpipe.pipeline_apply_stages, PORT_FNS, unpacks,
                  stacked[:2], _t(tokens), boundary_shapes=shapes) == want


def test_pack_stage_params_matches_jax():
    trees, _, _ = _hetero(3)
    js, junp = jpipe.pack_stage_params(
        [jax.tree.map(jnp.asarray, t) for t in trees])
    ts, tunp = tpipe.pack_stage_params(
        [{k: _t(v) for k, v in t.items()} for t in trees])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for s in range(S):
        for k, v in junp[s](js[s]).items():
            np.testing.assert_array_equal(tunp[s](ts[s])[k].numpy(),
                                          np.asarray(v))
    for pair in ([{"a": (jnp.float32, torch.float32),
                   "b": (jnp.bfloat16, torch.bfloat16)}],
                 [{"a": (jnp.float32, torch.float32)},
                  {"a": (jnp.bfloat16, torch.bfloat16)}]):
        want = _error(jpipe.pack_stage_params, [
            {k: jnp.zeros((2,), jd) for k, (jd, _) in t.items()}
            for t in pair])
        assert "single param dtype" in want
        assert _error(tpipe.pack_stage_params, [
            {k: torch.zeros(2, dtype=td) for k, (_, td) in t.items()}
            for t in pair]) == want
    assert _error(jpipe.pack_stage_params, [{}]) == \
        _error(tpipe.pack_stage_params, [{}])
