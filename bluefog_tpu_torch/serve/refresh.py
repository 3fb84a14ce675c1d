"""Live weight refresh: serving replicas as pull-only leaves of training
(counterpart of ``bluefog_tpu/serve/refresh.py``).

The refresher extends the training fleet's rank space to ``n_train +
n_serve`` rows and compiles a pull schedule
(:func:`bluefog_tpu_torch.schedule.compile_from_weights`) whose only
edges run from training rows to serving rows: serve row ``q * slice + o``
(replica q, slice offset o) averages the training replicas' rows ``r *
slice + o``, so (stage, tp, expert-block) shards line up.  Training rows
keep self weight 1 and have no in-edges.  A pull runs
:func:`bluefog_tpu_torch.ops.windows.win_pull` on every leaf of the
stacked training tree, on the device the tree lives on: no weight goes
through the host.

What differs from JAX, and why:

- The engine holds a :class:`~bluefog_tpu_torch.parallel.compose.
  ServingParams`, not a stacked serving tree.  So the serve rows enter
  the pull as zeros (live rows have self weight 0 and take only the
  training mean), the pulled rows are converted with the engine's loader
  (``params_from_jax(tree, cfg, m=m)`` / ``moe_params_from_jax``) and
  :meth:`ServeEngine.update_params` rebinds them.  A dead replica keeps
  self weight 1 in JAX, i.e. its own weights: here its slices of the
  served :class:`ServingParams` are copied over the new ones.
- JAX checks that the training and serving carvings use disjoint
  devices, because its pull is one program over a combined mesh.  Here
  both fleets are stacked rows on one device, so there is nothing to
  check.
- JAX brackets the first pull out of its retrace sentinel; nothing here
  compiles a program.

Staleness is first-class: ``bluefog_serve_staleness_steps`` gauges
``current train step - step last pulled``; :meth:`maybe_refresh` pulls
whenever it reaches ``BLUEFOG_REFRESH_EVERY`` (or the ``every=``
override).  :meth:`mark_dead_serve_replica` rebuilds the schedule
without a dead replica's in-edges, so the survivors keep pulling.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch

from ..ops.windows import win_pull
from ..schedule import compile_from_weights
from ..utils import flight as _flight
from ..utils import metrics as _metrics
from .engine import ServeEngine

__all__ = ["WeightRefresher", "DEFAULT_REFRESH_EVERY"]

DEFAULT_REFRESH_EVERY = 10


def _staleness_gauge():
    return _metrics.gauge(
        "bluefog_serve_staleness_steps",
        "train steps between the training frontier and the weights "
        "currently serving")


class WeightRefresher:
    """Periodically pull training params into a :class:`ServeEngine`.

    ``train_m`` is the training carving (a :class:`~bluefog_tpu_torch.
    parallel.compose.Mesh3D`); its intra-slice layout (pp, tp, sp, ep)
    and ``num_experts`` must match the serving carving's, so that row
    ``r * slice_size + o`` of the training tree and row ``q * slice_size
    + o`` of the serving carving hold the same shard.  The training tree
    is the stacked ``[n_train, ...]`` tree the port's trainer steps
    (``init_lm_train_params`` / ``init_moe_train_params``, JAX's layout);
    the router and expert tables are pulled like any block weight."""

    def __init__(self, engine: ServeEngine, train_m, *,
                 every: Optional[int] = None):
        sm = engine.m
        if (train_m.pp, train_m.tp, train_m.sp, train_m.ep) != (
                sm.pp, sm.tp, sm.sp, sm.ep):
            raise ValueError(
                f"training slice layout (pp={train_m.pp}, tp={train_m.tp}, "
                f"sp={train_m.sp}, ep={train_m.ep}) != serving layout "
                f"(pp={sm.pp}, tp={sm.tp}, sp={sm.sp}, "
                f"ep={sm.ep}); a pull copies same-shard rows and "
                "cannot re-shard — an ep mismatch would hand a serve peer "
                "another peer's expert-table block")
        if (train_m.num_experts or 0) != (sm.num_experts or 0):
            raise ValueError(
                f"training carving num_experts={train_m.num_experts} != "
                f"serving num_experts={sm.num_experts}; the expert "
                "tables being pulled must slice identically")
        if every is None:
            every = int(os.environ.get("BLUEFOG_REFRESH_EVERY",
                                       DEFAULT_REFRESH_EVERY))
        if every < 1:
            raise ValueError(f"refresh period must be >= 1 (got {every})")
        self.engine = engine
        self.train_m = train_m
        self.every = every
        self.n_train = train_m.size
        self.n_serve = sm.dp * train_m.slice_size
        self._dead: set = set()
        self._last_pulled_step: Optional[int] = None
        self._train_step = 0
        self.pulls = 0
        self._rebuild()
        _staleness_gauge().set(0.0)

    # ------------------------------------------------------------------

    def _rebuild(self) -> None:
        n = self.n_train + self.n_serve
        slice_sz = self.train_m.slice_size
        dp_train = self.train_m.dp
        self_w = [1.0] * n
        src: list = [dict() for _ in range(n)]
        for j in range(self.n_serve):
            if j // slice_sz in self._dead:
                continue                       # dead replica: identity row
            o = j % slice_sz
            self_w[self.n_train + j] = 0.0
            src[self.n_train + j] = {
                r * slice_sz + o: 1.0 / dp_train for r in range(dp_train)}
        self.schedule = compile_from_weights(n, self_w, src)

    def mark_dead_serve_replica(self, replica: int) -> None:
        """Heal the pull topology after a serving replica dies: its rows
        keep their (stale) weights and no training row feeds them."""
        if not 0 <= replica < self.engine.m.dp:
            raise ValueError(f"serve replica {replica} out of range")
        if replica in self._dead:
            return
        self._dead.add(replica)
        self._rebuild()
        _flight.record("serve", name="refresh_heal", replica=replica)

    # ------------------------------------------------------------------

    def note_train_step(self, step: int) -> None:
        """Advance the training frontier (drives the staleness gauge)."""
        self._train_step = int(step)
        if self._last_pulled_step is not None:
            _staleness_gauge().set(
                float(self._train_step - self._last_pulled_step))

    def staleness(self) -> Optional[float]:
        g = _metrics.get_metric("bluefog_serve_staleness_steps")
        return None if g is None else g.value()

    def _pull_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if (not torch.is_tensor(t) or t.shape[0] != self.n_train
                or not t.is_floating_point()):
            raise ValueError(
                f"training leaf {name} must be a floating [n_train="
                f"{self.n_train}, ...] tensor of the training carving; got "
                f"{type(t).__name__} {tuple(getattr(t, 'shape', ()))}")
        serve = t.new_zeros((self.n_serve,) + tuple(t.shape[1:]))
        combined = torch.cat([t.detach(), serve])
        # the serve rows alone outlive the call (the training rows come
        # back unchanged, self weight 1)
        return win_pull(combined, self.schedule)[self.n_train:].clone()

    def pull(self, train_params: Any, train_step: Optional[int] = None
             ) -> None:
        """Fetch the training params into the engine, mid-traffic.

        ``train_params``: the ``[n_train, ...]``-stacked training tree
        (``{group: {name: tensor}}``), on the engine's device for a pull
        that never leaves it."""
        if train_step is not None:
            self._train_step = int(train_step)
        tree = {g: {k: self._pull_leaf(f"{g}/{k}", v)
                    for k, v in leaves.items()}
                for g, leaves in train_params.items()}
        eng = self.engine
        if "experts" in tree:
            from ..moe.model import moe_params_from_jax as load
        else:
            from ..parallel.compose import params_from_jax as load
        new = load(tree, eng.cfg, m=eng.m, device=eng.device)
        if self._dead:
            with torch.no_grad():
                for (_, old), (_, fresh) in zip(eng.params.tensors(),
                                                new.tensors()):
                    for r in self._dead:
                        fresh[r].copy_(old[r])
        eng.update_params(new)
        self.pulls += 1
        self._last_pulled_step = self._train_step
        _staleness_gauge().set(0.0)
        _flight.record("serve", name="refresh_pull", step=self._train_step,
                       pulls=self.pulls, dead=sorted(self._dead))

    def maybe_refresh(self, train_params: Any, train_step: int) -> bool:
        """Pull iff the staleness budget (``every``) is spent; returns
        whether a pull happened."""
        self.note_train_step(train_step)
        if (self._last_pulled_step is not None
                and self._train_step - self._last_pulled_step < self.every):
            return False
        self.pull(train_params)
        return True
