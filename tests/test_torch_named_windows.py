"""The port's named-window API (``bluefog_tpu_torch/parallel/windows.py``)
against the JAX package's on 8 ranks (8 virtual devices on the JAX side).

One script of window calls runs on both sides: creation with and without
zeroed mailboxes, puts (the schedule's edges, partial destinations with
dst weights, the wire codecs), a put to a non-edge refused, accumulate
and collect, get, the combine with default and given weights, versions,
stamps and staleness, the associated-p channel and its de-biasing, and
``win_mutex``.  After each call the windows' values and mailboxes equal
JAX's (moves bit for bit, combines within 1e-6), and so do the host
tables.  A JAX window carried across mid-script (``window_from_jax``)
continues as JAX's does.  One 2-process x 4-row gloo run of the named
windows and async gossip (``tools/world_check.py --only windows``)
equals one process bit for bit.
"""
import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import jax.numpy as jnp
from bluefog_tpu import topology as jtopo
from bluefog_tpu.parallel import windows as jnw
import bluefog_tpu_torch as tbf
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.parallel import context as tctx
from bluefog_tpu_torch.parallel import windows as tnw
from bluefog_tpu_torch.tools import world_check as wc
from bluefog_tpu_torch.utils import metrics as tmetrics
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N, D = 8, 6


def _data():
    rng = np.random.default_rng(3)
    return [rng.normal(size=(N, D)).astype(np.float32) for _ in range(4)]


def _dst(n):
    """Each rank puts to its two lowest out-neighbors of Exp2(8), scaled."""
    outs = [[(r + 2 ** k) % n for k in range(3)] for r in range(n)]
    return [{d: 0.25 + 0.125 * (d % 3) for d in sorted(o)[:2]} for o in outs]


def _script(mod, arr, windows):
    """The calls on ``mod`` (``jbf`` or ``tbf``); ``arr`` makes a stacked
    tensor; ``windows`` reads a window's ``(value, recv)``.  Yields a
    record after each call."""
    x0, x1, x2, x3 = (arr(x) for x in _data())
    mod.win_create(x0, "w")
    mod.win_create(x1, "a", zero_init=True)
    yield "create", windows("w"), windows("a")
    mod.win_put(x1, "w")
    yield "put", windows("w")
    yield "update", mod.win_update("w"), windows("w")
    mod.win_put(x2, "w", dst_weights=_dst(N))
    yield "put_dst", windows("w"), mod.get_win_version("w")
    sw = [0.5 + 0.05 * r for r in range(N)]
    nbr = [{s: 0.1 * (1 + (s + r) % 3) for s in mod.in_neighbor_ranks(r)}
           for r in range(N)]
    yield "update_given", mod.win_update("w", self_weight=sw,
                                         neighbor_weights=nbr), windows("w")
    yield "update_scalar", mod.win_update(
        "w", self_weight=0.5,
        neighbor_weights=[{s: 0.5 / len(mod.in_neighbor_ranks(r))
                           for s in mod.in_neighbor_ranks(r)}
                          for r in range(N)], reset=True), windows("w")
    for wire in ("bf16", "int8", "fp8@4"):
        mod.win_put(x3, "w", wire=wire)
        yield "put_" + wire, windows("w")
    mod.win_accumulate(x2, "a")
    mod.win_accumulate(x3, "a", dst_weights=_dst(N))
    yield "accumulate", windows("a"), mod.get_win_version("a")
    yield "collect", mod.win_update_then_collect("a"), windows("a")
    mod.win_get("w", wire="int8")
    yield ("get", windows("w"), mod.get_win_version("w"),
           mod.get_win_stamps("w"), mod.win_staleness("w"))
    mod.turn_on_win_ops_with_associated_p()
    try:
        mod.win_accumulate(x1, "a", dst_weights=_dst(N))
        mod.win_put(x0, "a")
        yield "p_moves", windows("a"), mod.win_associated_p("a")
        v = mod.win_update("a")
        yield "p_update", v, mod.win_associated_p("a")
        yield "p_debiased", v / mod.win_associated_p("a")[:, None]
    finally:
        mod.turn_off_win_ops_with_associated_p()
    with mod.win_mutex("w", for_self=True, ranks=[1, 2]):
        mod.win_put(x0, "w")
    yield "mutex_put", windows("w"), mod.get_win_stamps("w")
    mod.win_free("a")
    yield "free", sorted((jnw if mod is jbf else tnw)._registry)


def _flat(rec):
    out = []
    for v in rec:
        if isinstance(v, tuple):
            out += _flat(v)
        elif isinstance(v, (list, str)):
            out.append(v)
        else:
            out.append(np.asarray(v.detach().numpy() if torch.is_tensor(v)
                                  else v))
    return out


def _compare(got, want):
    for (tag, *g), (wtag, *w) in zip(got, want):
        assert tag == wtag
        for a, b in zip(_flat(g), _flat(w)):
            if isinstance(b, (list, str)):
                assert a == b, tag
            elif np.issubdtype(np.asarray(b).dtype, np.integer):
                np.testing.assert_array_equal(a, b, tag)
            else:
                # moves are bit for bit; the combines within 1e-6
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                           err_msg=tag)
    assert len(got) == len(want)


def _jax_records(cpu_devices, stop=None):
    jbf.init(devices=cpu_devices[:N])
    try:
        jbf.set_topology(jtopo.ExponentialTwoGraph(N))
        recs = []

        def windows(name):
            w = jnw._registry[name].window
            return (np.asarray(w.value), np.asarray(w.recv))

        for rec in _script(jbf, jnp.asarray, windows):
            recs.append(jax_host(rec))
            if rec[0] == stop:
                carry = (jnw._registry["w"], jnw._assoc_p["w"])
                return recs, carry
        return recs, None
    finally:
        jnw.win_free()
        jbf.shutdown()


def jax_host(rec):
    return tuple(np.asarray(v) if hasattr(v, "shape") and not isinstance(
        v, tuple) else v for v in rec)


def _windows_t(name):
    w = tnw._registry[name].window
    return (w.value, w.recv)


def test_named_windows_match_jax(cpu_devices):
    want, _ = _jax_records(cpu_devices)
    tmetrics.reset_metrics()
    tctx.init(size=N, device="cpu")
    try:
        tctx.set_topology(ttopo.ExponentialTwoGraph(N))
        got = list(_script(tbf, torch.from_numpy, _windows_t))
        # record_op: 7 puts of N x D f32 payloads, 3 accumulates, 1 get
        ops = tmetrics.counter("bluefog_ops_total")
        assert [ops.value(op="win_" + k) for k in ("put", "acc", "get")] \
            == [7, 3, 1]
        assert tmetrics.counter("bluefog_op_bytes_total").value(
            op="win_put") == 7 * N * D * 4
    finally:
        tnw.win_free()
        tctx.shutdown()
    _compare(got, want)
    # the puts of the inputs moved the same bits into the mailboxes (the
    # get moves combined values, equal to 1e-6)
    for rec_t, rec_j in zip(got, want):
        if rec_t[0] in ("put", "put_bf16", "put_int8", "put_fp8@4"):
            np.testing.assert_array_equal(_flat(rec_t[1:])[1],
                                          _flat(rec_j[1:])[1], rec_t[0])


def test_refusals_keep_the_jax_texts(cpu_devices):
    def run(mod, arr, reg):
        msgs = []
        mod.win_create(arr(np.zeros((N, D), np.float32)), "w")
        bad = [{(r + 3) % N: 1.0} for r in range(N)]   # 3 is no Exp2 hop
        for call in (lambda: mod.win_put(arr(np.ones((N, D), np.float32)),
                                         "w", dst_weights=bad),
                     lambda: mod.win_update("w", self_weight=0.5),
                     lambda: mod.win_update(
                         "w", self_weight=0.5,
                         neighbor_weights=[{(r + 3) % N: 1.0}
                                           for r in range(N)]),
                     lambda: mod.win_put(arr(np.ones((N, D), np.float32)),
                                         "nope"),
                     lambda: mod.win_create(arr(np.ones((3, D), np.float32)),
                                            "short")):
            with pytest.raises(Exception) as e:
                call()
            msgs.append((type(e.value), str(e.value).split(", got")[0]))
        mod.win_free()
        return msgs

    jbf.init(devices=cpu_devices[:N])
    try:
        jbf.set_topology(jtopo.ExponentialTwoGraph(N))
        want = run(jbf, jnp.asarray, jnw._registry)
    finally:
        jbf.shutdown()
    tctx.init(size=N, device="cpu")
    try:
        tctx.set_topology(ttopo.ExponentialTwoGraph(N))
        got = run(tbf, torch.from_numpy, tnw._registry)
    finally:
        tctx.shutdown()
    assert got == want


def test_window_carried_from_jax_continues_as_jax(cpu_devices):
    want, _ = _jax_records(cpu_devices)
    head, (jentry, jp) = _jax_records(cpu_devices, stop="update_given")
    tctx.init(size=N, device="cpu")
    try:
        tctx.set_topology(ttopo.ExponentialTwoGraph(N))
        gen = _script(tbf, torch.from_numpy, _windows_t)
        got = []
        for rec in gen:
            got.append(rec)
            if rec[0] == "update_given":
                # from here on, the window "w" is JAX's carried across
                tnw.window_from_jax("w", jentry, jp)
                break
        got += list(gen)
    finally:
        tnw.win_free()
        tctx.shutdown()
    _compare(got, want)
    assert tnw._registry == {}


def test_two_processes_equal_one_process_bit_for_bit(tmp_path):
    ref = wc.reference(N, 4, only="windows")
    got = wc.spawn(2, N, tmp_path, only="windows", timeout=150)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        assert torch.equal(got[key], ref[key]), key
    # the async run's forced sync-ups crossed the processes (a MAX)
    assert bool(ref["async_force"].any())
    assert ref["async_local_steps"].tolist()[3] < 6
