"""The port's window ops (``ops/windows.py``) against the JAX ops under
``shard_map`` on 8 virtual devices.

One sequence of every op, on three schedules (weighted ring, uniform
Exp2, and a dst-weighted schedule with irregular in-degrees) and with
and without an int8 wire: ``win_create`` (mailboxes seeded from the
rank's own tensor), ``win_put`` of a scaled tensor, ``win_update`` with
the schedule's weights and with overrides, ``win_accumulate``,
``win_get``, ``win_update_then_collect`` (which clears the mailboxes).
Every combined value and every mailbox equals JAX's row for row (atol
1e-6: the same f32 products; the slot sums in the same order).

``win_pull`` meets its contract on its own (``tests/test_win_ops.py``'s
test of it fails on the JAX package itself, ROADMAP queue 3): it calls
no ``win_create`` and builds no ``[n, K, ...]`` block, and its result is
the weighted neighbor combine ``W^T x``.  Push-sum's mailboxes keep the
mass: a rank's kept share plus what it accumulated out sums to n.
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
from bluefog_tpu.ops import windows as jwin
from bluefog_tpu_torch import schedule as tsch
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import windows as twin
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N, DIM = 8, 6


def _scheds(kind):
    if kind == "ring":
        return (jsch.compile_topology(jtopo.RingGraph(N), True),
                tsch.compile_topology(ttopo.RingGraph(N), True))
    if kind == "exp2":
        return (jsch.compile_topology(jtopo.ExponentialTwoGraph(N), False),
                tsch.compile_topology(ttopo.ExponentialTwoGraph(N), False))
    # dst-weighted, rank 0 receiving from three, rank 5 from none
    srcs = [{(r - 1) % N: 0.25, (r + 3) % N: 0.25} for r in range(N)]
    srcs[0] = {1: 0.2, 2: 0.2, 7: 0.2}
    srcs[5] = {}
    dsts = [{} for _ in range(N)]
    for d, row in enumerate(srcs):
        for s in row:
            dsts[s][d] = 0.5 + 0.1 * d
    selfw = [0.5] * N
    selfw[5] = 1.0
    return tuple(mod.compile_from_weights(N, selfw, srcs, dsts)
                 for mod in (jsch, tsch))


def _sequence(ops, sched, x, wire):
    """Every window op once; returns the combined values and mailboxes."""
    K = max(sched.max_in_degree, 1)
    sw = np.linspace(0.3, 0.6, N).astype(np.float32)
    slot_w = (np.arange(K * N, dtype=np.float32).reshape(K, N) % 3) / 10
    win = ops.win_create(x, sched, zero_init=False)
    out = [win.recv]
    win = ops.win_put(win, 2 * x, sched, wire=wire)
    out.append(win.recv)
    c1, win = ops.win_update(win, sched)
    c2, win = ops.win_update(win, sched, self_weight=sw, slot_weights=slot_w)
    win = ops.win_accumulate(win, x + 1, sched, wire=wire)
    out.append(win.recv)
    win = ops.win_get(win, sched, wire=wire)
    out.append(win.recv)
    c3, win = ops.win_update_then_collect(win, sched)
    out.append(win.recv)
    return [c1, c2, c3, win.value] + out


@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("kind", ["ring", "exp2", "dst"])
def test_window_ops_match_jax(cpu_devices, kind, wire):
    jsched, tsched = _scheds(kind)
    x = np.random.default_rng(0).normal(size=(N, DIM)).astype(np.float32)
    mesh = Mesh(np.array(cpu_devices[:N]), ("rank",))

    def per_rank(b):
        return tuple(v[None] for v in _sequence(jwin, jsched, b[0], wire))

    n_out = 9
    fn = jax.jit(jax.shard_map(per_rank, mesh=mesh, in_specs=P("rank"),
                               out_specs=(P("rank"),) * n_out))
    want = [np.asarray(v) for v in fn(jnp.asarray(x))]
    got = [v.numpy() for v in _sequence(twin, tsched, torch.from_numpy(x),
                                        wire)]
    assert len(got) == len(want) == n_out
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=str(i))
    assert not got[-1].any()           # collect clears the mailboxes


def test_window_ops_are_functional():
    _, sched = _scheds("ring")
    x = torch.randn(N, DIM)
    win = twin.win_create(x, sched)
    before = win.recv.clone()
    twin.win_put(win, x, sched)
    twin.win_accumulate(win, x, sched)
    assert torch.equal(win.recv, before)
    with pytest.raises(ValueError, match=r"stacked \[n=8"):
        twin.win_create(x[:3], sched)


@pytest.mark.parametrize("kind", ["ring", "exp2", "dst"])
@pytest.mark.parametrize("wire", [None, "bf16"])
def test_win_pull_allocates_no_window(monkeypatch, kind, wire):
    """The pull contract of ``tests/test_win_ops.py`` on the port: no
    ``win_create`` call, no zero-filled ``[n, K, ...]`` mailbox block, and
    the weighted neighbor combine as the result."""
    _, sched = _scheds(kind)
    K = max(sched.max_in_degree, 1)

    def boom(*a, **k):
        raise AssertionError("win_pull must not allocate a window")

    monkeypatch.setattr(twin, "win_create", boom)
    made = []
    real_zeros = torch.zeros

    def zeros(*shape, **kw):
        made.append(tuple(shape[0]) if len(shape) == 1 and isinstance(
            shape[0], (tuple, list)) else tuple(shape))
        return real_zeros(*shape, **kw)

    monkeypatch.setattr(torch, "zeros", zeros)
    x = torch.arange(N, dtype=torch.float32)[:, None].expand(N, DIM) \
        .contiguous()
    out = twin.win_pull(x, sched, wire=wire).numpy()
    assert (N, K, DIM) not in made
    W = np.diag(sched.self_weight.astype(np.float64))
    for r in range(sched.num_rounds):
        for d in range(N):
            if sched.recv_src[r, d] >= 0:
                W[sched.recv_src[r, d], d] += sched.recv_weight[r, d]
    want = W.T @ np.arange(N, dtype=np.float64)
    np.testing.assert_allclose(out, np.repeat(want[:, None], DIM, 1),
                               rtol=1e-5 if wire is None else 1e-2)


def test_push_sum_mailboxes_keep_the_mass():
    sched = tsch.compile_topology(ttopo.ExponentialTwoGraph(N), False)
    p = torch.ones(N, dtype=torch.float64)
    win = twin.win_create(p, sched)
    share = torch.from_numpy(1.0 / (sched.out_degree + 1.0))
    for _ in range(5):
        win = twin.win_accumulate(win, win.value * share, sched)
        win = twin.Window(value=win.value * share, recv=win.recv)
        _, win = twin.win_update_then_collect(win, sched)
    assert abs(float(win.value.sum()) - N) < 1e-12
