"""The port's input pipeline (``bluefog_tpu_torch/data.py``) and its
native row gather (``bluefog_tpu_torch/_native``) against the JAX
package's ``data.py`` and ``_native``:

* for the same seed the port's ``ShardedLoader`` yields JAX's batches
  exactly: every rank's rows at every step of every epoch, shuffled and
  not, through ``__iter__`` and ``epoch_arrays`` (``[n, steps, B, ...]``);
  across processes a process's block of rows is its slice of them;
* the native gather equals numpy's ``a[idx]`` (dtypes, the threaded
  path, negative indices) and refuses the layouts JAX's refuses (object
  dtype, non-contiguous, bool and float indices: ``None``), raising on
  an index out of range, and gives the loader's batches (which numpy
  gathers);
* the background producer matches the inline one, re-raises a
  producer's error at the consumer and stops after the consumer leaves;
  ``prefetch_to_device`` keeps the order.
"""
import threading
import time

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
from bluefog_tpu import _native as jnative
from bluefog_tpu.data import ShardedLoader as JLoader
from bluefog_tpu_torch import _native as tnative
from bluefog_tpu_torch.data import ShardedLoader, _background, \
    prefetch_to_device
from bluefog_tpu_torch.parallel import context as tctx
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N = 8


@pytest.fixture
def ctx(cpu_devices):
    jbf.init(devices=cpu_devices, nodes_per_machine=1)
    tctx.init(size=N, device="cpu")
    yield
    tctx.shutdown()
    jbf.shutdown()


def _arrays(n=N * 16):
    rng = np.random.default_rng(0)
    return [rng.normal(size=(n, 3, 2)).astype(np.float32),
            rng.integers(0, 10, size=(n,)).astype(np.int32)]


@pytest.mark.parametrize("shuffle,seed,batch", [(False, 0, 4), (True, 0, 4),
                                                (True, 7, 3), (True, 3, 16)])
def test_batches_equal_jax_for_the_same_seed(ctx, shuffle, seed, batch):
    arrays = _arrays()
    j = JLoader(arrays, batch, shuffle=shuffle, seed=seed)
    t = ShardedLoader(arrays, batch, shuffle=shuffle, seed=seed)
    assert t.steps_per_epoch() == j.steps_per_epoch()
    for _ in range(2):                                   # two epochs
        got = [tuple(x.numpy() for x in b) for b in t]
        want = [tuple(np.asarray(x) for x in b) for b in j]
        assert len(got) == len(want) == j.steps_per_epoch()
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    ja, ta = j.epoch_arrays(), t.epoch_arrays()          # the third epoch
    for a, b in zip(ta, ja):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_every_sample_once_and_shards_disjoint(ctx):
    x = np.arange(16 * N, dtype=np.float32)
    loader = ShardedLoader([x, x * 10], batch_size=4, shuffle=False)
    seen = []
    for xb, yb in loader:
        assert tuple(xb.shape) == (N, 4)
        torch.testing.assert_close(yb, xb * 10)
        seen.append(xb.numpy())
    assert sorted(np.concatenate(seen).ravel().tolist()) == x.tolist()
    for r in range(N):
        assert np.all((seen[0][r] >= r * 16) & (seen[0][r] < (r + 1) * 16))
    with pytest.raises(ValueError, match="samples < one global batch"):
        list(ShardedLoader([x[:8]], batch_size=4)._host_batches())
    with pytest.raises(NotImplementedError):
        ShardedLoader([x], 4, drop_remainder=False)


def test_a_process_gets_its_block_of_rows(ctx, monkeypatch):
    arrays = _arrays()
    full = [tuple(b) for b in ShardedLoader(arrays, 4, seed=5)._host_batches()]
    c = tctx.get_context()
    monkeypatch.setattr(c, "world", 2)
    monkeypatch.setattr(c, "process", 1)
    part = [tuple(b) for b in ShardedLoader(arrays, 4, seed=5)._host_batches()]
    for f, p in zip(full, part):
        for a, b in zip(f, p):
            np.testing.assert_array_equal(b, a[4:])


def test_native_gather_equals_numpy_and_jax():
    assert tnative.available(), tnative.build_error()
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.uint8, np.int64, np.float16):
        src = rng.normal(size=(64, 3, 5)).astype(dtype)
        idx = rng.integers(0, 64, size=(4, 7))
        np.testing.assert_array_equal(tnative.gather_rows_native(src, idx),
                                      src[idx])
    src = rng.normal(size=(512, 64, 64)).astype(np.float32)   # > 4 MB
    idx = rng.integers(0, 512, size=(600,))
    np.testing.assert_array_equal(
        tnative.gather_rows_native(src, idx, threads=8), src[idx])
    with pytest.raises(IndexError):
        tnative.gather_rows_native(src, np.array([512]))


def test_native_gather_refuses_the_layouts_jax_refuses():
    big = np.arange(24, dtype=np.float32).reshape(4, 6)
    cases = [(np.array([{"a": 1}, {"b": 2}], dtype=object), [0, 1]),
             (big.T, [0]), (big, np.array([True, False, True, False])),
             (big, np.array([0.5, 1.5]))]
    for src, idx in cases:
        assert tnative.gather_rows_native(src, idx) is None
        if jnative.available():
            assert jnative.gather_rows_native(src, idx) is None
    np.testing.assert_array_equal(
        tnative.gather_rows_native(big, np.array([-1, 0])), big[[-1, 0]])


def test_native_colorer_equals_the_python_path():
    """The native colorer gives ``schedule.color_edges``' rounds (the
    Python path the port's schedules take) on a small graph and on one
    of 16,256 edges."""
    from bluefog_tpu_torch import schedule as tsch
    from bluefog_tpu_torch import topology as tu
    for topo, n in ((tu.ExponentialTwoGraph(16), 16),
                    (tu.FullyConnectedGraph(128), 128)):
        edges = [(u, v) for u, v in topo.edges() if u != v]
        native = tnative.color_edges_native(edges, n)
        assert [sorted(r) for r in native] == \
            [sorted(r) for r in tsch.color_edges(edges, n)]
    assert len(native) == 127


def test_loader_native_and_python_paths_agree(ctx):
    """The loader gathers with numpy; the native gather over the same
    indices (the examples' layout: 8 ranks x batch rows) gives its
    batches."""
    x = np.arange(N * 6 * 4, dtype=np.float32).reshape(N * 6, 4)
    y = np.arange(N * 6, dtype=np.int32)
    loader = ShardedLoader([x, y], batch_size=3, seed=7)
    order = np.random.default_rng(7).permutation(N * 6)
    for s, (xb, yb) in enumerate(loader._host_batches()):
        idx = np.stack([order[r * 6 + s * 3: r * 6 + (s + 1) * 3]
                        for r in range(N)])
        np.testing.assert_array_equal(tnative.gather_rows_native(x, idx), xb)
        np.testing.assert_array_equal(tnative.gather_rows_native(y, idx), yb)


def test_background_producer_matches_inline(ctx):
    x = np.random.default_rng(1).normal(size=(N * 8, 3)).astype(np.float32)
    inline = ShardedLoader([x], batch_size=2, seed=3, host_workers=0)
    threaded = ShardedLoader([x], batch_size=2, seed=3, host_workers=1)
    got_i = [b[0].numpy() for b in inline]
    got_t = [b[0].numpy() for b in threaded]
    assert len(got_i) == len(got_t) == inline.steps_per_epoch()
    for bi, bt in zip(got_i, got_t):
        np.testing.assert_array_equal(bi, bt)


def test_background_producer_propagates_errors():
    def boom():
        yield 1
        raise RuntimeError("producer failed")

    it = _background(boom(), size=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        list(it)


def test_background_producer_stops_after_consumer_break():
    started = threading.Event()
    produced = []

    def slow_source():
        started.set()
        for i in range(1000):
            produced.append(i)
            yield np.zeros((2, 2)) + i

    it = _background(slow_source(), size=1)
    next(it), next(it)
    it.close()
    assert started.wait(5)
    n_after_close = None
    for _ in range(50):
        time.sleep(0.05)
        if n_after_close == len(produced):
            break
        n_after_close = len(produced)
    assert len(produced) < 20


def test_prefetch_preserves_order(ctx):
    batches = [{"i": np.full((N, 1), i, np.float32)} for i in range(6)]
    out = list(prefetch_to_device(iter(batches), size=3))
    assert [int(b["i"][0, 0]) for b in out] == list(range(6))
    assert all(isinstance(b["i"], torch.Tensor) for b in out)
    assert [int(b[0][0]) for b in prefetch_to_device(
        iter([(torch.full((2,), float(i)),) for i in range(4)]),
        torch.device("cpu"), size=1)] == [0, 1, 2, 3]
