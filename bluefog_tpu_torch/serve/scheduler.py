"""Continuous batching over one :class:`ServeEngine` (counterpart of the
admission, decode and retirement path of
``bluefog_tpu/serve/scheduler.py``).

Each :meth:`Scheduler.step` admits queued requests into free slots
(prefilling each one), runs one fused decode call at the smallest
declared batch bucket that fits the active lanes, and retires requests
that reached ``max_new_tokens`` or the KV-cache length ceiling.

Replica failure, preemption, autoscaling and the metrics / tracing /
flight-recorder hooks come with later slices.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from .engine import ServeEngine
from .kv_cache import SlotAllocator

__all__ = ["Request", "Scheduler"]


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle state."""
    id: int
    prompt: List[int]
    max_new_tokens: int
    state: str = "queued"            # queued -> running -> done
    replica: int = -1
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def next_pos(self) -> int:
        """KV position the pending (last generated) token will occupy."""
        return len(self.prompt) + len(self.generated) - 1

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


class Scheduler:
    """Continuous batching over one :class:`ServeEngine`.

    ``decode_calls``, ``decode_steps`` and ``decode_seconds`` count the
    fused decode calls, the token steps they ran (each step runs every
    layer once) and their host wall time, which ends with the tokens on
    the host."""

    def __init__(self, engine: ServeEngine):
        self.engine = engine
        self.replicas = engine.replicas
        self._queue: Deque[Request] = deque()
        self._alloc = [SlotAllocator(engine.scfg.slots, replica=r)
                       for r in range(self.replicas)]
        self._active: List[Dict[int, Request]] = [
            {} for _ in range(self.replicas)]
        self._next_id = 0
        self.completed: List[Request] = []
        self.decode_calls = 0
        self.decode_steps = 0
        self.decode_seconds = 0.0

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 8,
               now: Optional[float] = None) -> Request:
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # reject unservable prompts at submit, not mid-stream
        self.engine.scfg.prefill_bucket_for(len(prompt))
        req = Request(id=self._next_id, prompt=list(prompt),
                      max_new_tokens=max_new_tokens,
                      submitted_at=time.monotonic() if now is None else now)
        self._next_id += 1
        self._queue.append(req)
        return req

    @property
    def in_flight(self) -> int:
        return sum(len(a) for a in self._active)

    @property
    def done(self) -> bool:
        return not self._queue and self.in_flight == 0

    def step(self) -> List[Request]:
        """One admit -> decode -> retire cycle; returns the requests
        retired by the decode."""
        self._admit()
        return self._decode_once()

    def drain(self, max_steps: int = 10_000) -> None:
        """Run until every submitted request is done."""
        for _ in range(max_steps):
            if self.done:
                return
            self.step()
        raise RuntimeError(f"scheduler did not drain in {max_steps} steps")

    def _prefill_request(self, req: Request) -> int:
        first, _ = self.engine.prefill(req.replica, req.slot, req.prompt)
        req.first_token_at = time.monotonic()
        return first

    def _admit(self) -> None:
        # a lane needs a free KV slot AND a decode lane: never admit past
        # the largest declared batch bucket
        scfg = self.engine.scfg
        lane_cap = min(scfg.slots, scfg.batch_buckets[-1])
        while self._queue:
            candidates = [r for r in range(self.replicas)
                          if (self._alloc[r].in_use < scfg.slots
                              and len(self._active[r]) < lane_cap)]
            if not candidates:
                return
            target = min(candidates, key=lambda r: (len(self._active[r]), r))
            req = self._queue.popleft()
            slot = self._alloc[target].alloc()
            req.replica, req.slot, req.state = target, slot, "running"
            req.admitted_at = time.monotonic()
            req.generated.append(self._prefill_request(req))
            self._active[target][slot] = req
            self._maybe_retire(req)

    def _decode_once(self) -> List[Request]:
        lanes = [sorted(self._active[r]) for r in range(self.replicas)]
        busiest = max((len(l) for l in lanes), default=0)
        if busiest == 0:
            return []
        S = self.engine.scfg.batch_bucket_for(busiest)
        idle_tok, idle_slot, idle_len = self.engine.idle_lane()
        R = self.replicas
        toks = np.full((R, S), idle_tok, np.int32)
        slots = np.full((R, S), idle_slot, np.int32)
        lens = np.full((R, S), idle_len, np.int32)
        for r in range(R):
            for i, slot in enumerate(lanes[r]):
                req = self._active[r][slot]
                toks[r, i] = req.generated[-1]
                slots[r, i] = slot
                lens[r, i] = req.next_pos
        t0 = time.monotonic()
        gen = self.engine.decode(toks, slots, lens)         # [R, steps, S]
        self.decode_seconds += time.monotonic() - t0
        self.decode_calls += 1
        self.decode_steps += gen.shape[1]
        retired: List[Request] = []
        for r in range(R):
            for i, slot in enumerate(lanes[r]):
                req = self._active[r][slot]
                room = req.max_new_tokens - len(req.generated)
                req.generated.extend(int(t) for t in gen[r, :room, i])
                if self._maybe_retire(req):
                    retired.append(req)
        return retired

    def _maybe_retire(self, req: Request) -> bool:
        # the next fused call appends at next_pos .. next_pos + window - 1,
        # all of which must fit under the per-slot capacity
        window = self.engine.scfg.decode_window
        if (len(req.generated) < req.max_new_tokens
                and req.next_pos + window <= self.engine.scfg.max_len):
            return False
        req.state = "done"
        req.finished_at = time.monotonic()
        self._active[req.replica].pop(req.slot, None)
        self._alloc[req.replica].free(req.slot)
        self.completed.append(req)
        return True
