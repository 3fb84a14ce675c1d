"""Sharded input pipeline: host batching plus asynchronous device
prefetch (the port's counterpart of ``bluefog_tpu/data.py``).

The reference feeds each rank through a torch ``DataLoader`` worker
process; here one host process feeds every stacked rank, so the pipeline
(a) cuts each global batch into the ranks' shards (``[rows, B, ...]``,
this process's rows of the rank axis), (b) assembles batch t+1 on a
producer thread while batch t trains, and (c) stages
host-to-device copies ahead of compute: pinned host buffers, copies with
``non_blocking`` on a side stream, and the consumer's stream waits on an
event before it reads a batch.

For the same seed the batches are JAX's ``ShardedLoader``'s: the same
rows for every rank, epoch and step, shuffled by
``np.random.default_rng(seed + epoch)``.

The row gather is numpy's ``a[idx]``.  JAX's loader takes the native
gather of ``_native/loader.cc`` when it loads; the port keeps that
engine (``_native.gather_rows_native``) but not on this path: at the
examples' batches (8 ranks x 32 rows, under its 4 MB threading
threshold) it is one memcpy loop behind a ctypes call, and chip_smoke's
phase 21 times it against ``a[idx]`` there.
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .fusion import tree_flatten, tree_unflatten
from .parallel import context as _ctx

__all__ = ["ShardedLoader", "prefetch_to_device"]


class ShardedLoader:
    """Iterate ``(x, y, ...)`` arrays as rank-sharded device batches.

    Each epoch yields ``steps_per_epoch`` tuples whose tensors are
    ``[rows, batch_size, ...]`` on the context's device (rank r's shard
    in row r; this process's block of rows across processes).  Distinct
    ranks see distinct shards; ``shuffle`` draws a new permutation every
    epoch.
    """

    def __init__(
        self,
        arrays: Sequence[np.ndarray],
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        prefetch: int = 2,
        host_workers: int = 1,
    ):
        if not arrays:
            raise ValueError("need at least one array")
        n0 = len(arrays[0])
        if any(len(a) != n0 for a in arrays):
            raise ValueError("arrays must share their first dimension")
        self.arrays = [np.asarray(a) for a in arrays]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        # host_workers: 0 assembles batches inline; 1 (default) runs the
        # gather loop in a producer thread (the reference's num_workers)
        self.host_workers = host_workers
        if not drop_remainder:
            raise NotImplementedError(
                "every step takes a full batch: drop_remainder must be True")
        self._epoch = 0

    @property
    def num_samples(self) -> int:
        return len(self.arrays[0])

    def steps_per_epoch(self) -> int:
        return self.num_samples // _ctx.size() // self.batch_size

    def epoch_arrays(self) -> Tuple[torch.Tensor, ...]:
        """One epoch as stacked tensors ``[rows, steps, batch, ...]`` per
        source on the context's device: the shape
        ``make_train_step(steps_per_call=steps)`` takes.  Advances the
        epoch counter (a fresh shuffle a call), as one ``__iter__`` pass
        does."""
        dev = _ctx.get_context().device
        batches = list(self._host_batches())
        return tuple(
            torch.from_numpy(np.stack([b[i] for b in batches], axis=1)).to(
                dev)
            for i in range(len(self.arrays)))

    def _host_batches(self):
        ctx = _ctx.get_context()
        n = ctx.size
        steps = self.steps_per_epoch()
        if steps == 0:
            raise ValueError(
                f"{self.num_samples} samples < one global batch "
                f"({n} ranks x {self.batch_size})")
        order = np.arange(self.num_samples)
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + self._epoch).permutation(order)
        self._epoch += 1
        per_rank = self.num_samples // n
        ranks = range(ctx.first_rank, ctx.first_rank + ctx.rows)
        for s in range(steps):
            idx = np.stack([
                order[r * per_rank + s * self.batch_size:
                      r * per_rank + (s + 1) * self.batch_size]
                for r in ranks
            ])
            yield tuple(a[idx] for a in self.arrays)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        host = self._host_batches()
        if self.host_workers > 0:
            host = _background(host, size=self.prefetch)
        yield from prefetch_to_device(host, _ctx.get_context().device,
                                      size=self.prefetch)


def _background(iterator: Iterator[Any], *, size: int = 2) -> Iterator[Any]:
    """Run ``iterator`` in a producer thread with a bounded queue.

    The ctypes gather and ``np.stack`` release the GIL for their copies,
    so one producer thread overlaps batch assembly with the consumer's
    device work.  Exceptions re-raise at the consumer; a consumer that
    stops early stops the producer."""
    q: _queue.Queue = _queue.Queue(maxsize=max(1, size))
    end = object()
    stop = threading.Event()
    failure: list = []

    def run():
        try:
            for item in iterator:
                # bounded put that notices consumer abandonment — otherwise
                # an early `break` in the training loop leaks this thread
                # blocked in put() plus every batch it holds
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except _queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as exc:   # noqa: BLE001 — re-raised below
            failure.append(exc)
        finally:
            # the sentinel must not be dropped while a live consumer could
            # block on q.get() forever — same stop-aware bounded put
            while not stop.is_set():
                try:
                    q.put(end, timeout=0.2)
                    break
                except _queue.Full:
                    continue

    threading.Thread(target=run, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()


class _Staged:
    """One batch in flight: its device tensors, the pinned host buffers
    they were copied from, and the event that marks the copy done."""

    __slots__ = ("treedef", "dev", "host", "event")

    def __init__(self, treedef, dev, host, event):
        self.treedef, self.dev, self.host, self.event = (treedef, dev, host,
                                                         event)


def prefetch_to_device(
    iterator: Iterator[Any],
    device: Optional[torch.device] = None,
    *,
    size: int = 2,
) -> Iterator[Any]:
    """Stage host trees (numpy arrays or tensors) onto ``device`` (the
    context's by default) ``size`` batches ahead, in order.

    On a card each batch is written into pinned host buffers and copied
    with ``non_blocking`` on a side stream, so the copy of batch t+1
    overlaps the step on batch t; the consumer's stream waits on the
    copy's event before the batch is handed out, and a pinned buffer is
    reused only after the copy out of it has completed.  On the CPU the
    batch is converted in place."""
    dev = torch.device(device) if device is not None else \
        _ctx.get_context().device
    if dev.type != "cuda":
        for batch in iterator:
            leaves, treedef = tree_flatten(batch)
            yield tree_unflatten(treedef, [
                torch.as_tensor(a).to(dev) for a in leaves])
        return

    stream = torch.cuda.Stream(dev)
    free: List[Tuple[List[torch.Tensor], torch.cuda.Event]] = []
    queue: collections.deque = collections.deque()

    def pinned_for(leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        for i, (bufs, ev) in enumerate(free):
            if len(bufs) == len(leaves) and all(
                    b.shape == a.shape and b.dtype == a.dtype
                    for b, a in zip(bufs, leaves)):
                ev.synchronize()            # its copy out has completed
                del free[i]
                return bufs
        return [torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                for a in leaves]

    def stage(batch) -> _Staged:
        leaves, treedef = tree_flatten(batch)
        leaves = [torch.as_tensor(a) for a in leaves]
        host = pinned_for(leaves)
        for b, a in zip(host, leaves):
            b.copy_(a)
        with torch.cuda.stream(stream):
            out = [b.to(dev, non_blocking=True) for b in host]
            ev = torch.cuda.Event()
            ev.record(stream)
        return _Staged(treedef, out, host, ev)

    def hand_out(st: _Staged):
        cur = torch.cuda.current_stream(dev)
        cur.wait_event(st.event)
        for t in st.dev:
            t.record_stream(cur)            # allocated on the side stream
        free.append((st.host, st.event))
        return tree_unflatten(st.treedef, st.dev)

    for batch in iterator:
        queue.append(stage(batch))
        if len(queue) > size:
            yield hand_out(queue.popleft())
    while queue:
        yield hand_out(queue.popleft())
