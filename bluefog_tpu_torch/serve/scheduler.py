"""Continuous batching over one :class:`ServeEngine` (counterpart of the
admission, decode and retirement path of
``bluefog_tpu/serve/scheduler.py``).

Each :meth:`Scheduler.step` admits queued requests into free slots of
the engine's replicas (prefilling each one on its replica), runs one
engine call for every replica at the smallest declared batch bucket that
fits the busiest replica's lanes, and retires requests that reached
``max_new_tokens`` or the KV-cache length ceiling.

With prefix pages armed, each replica keeps a
:class:`~bluefog_tpu_torch.serve.kv_cache.PrefixCache`: a prompt whose
shareable prefix is sealed attaches to it and prefills only its
remainder (one chunk call); a shareable miss seals its prefix on the way
in, so the next request with the same system prompt hits.  Admission
prefers the replica holding the longest sealed prefix of the head
request, then the least loaded, then (MoE) the least skewed last batch.
With ``spec_decode=k`` armed the decode call is one speculative round
and each lane advances by its own accepted count.

Replica failure, preemption, autoscaling and the metrics / tracing /
flight-recorder hooks come with later slices (the hot-expert gauges with
the metrics port).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from .engine import ServeEngine
from .kv_cache import PrefixCache, SlotAllocator

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
    prefix_row: int = -1             # sealed page this request reads through
    prefix_len: int = 0              # tokens served by that page
    prefix_hit: bool = False         # read a page another request sealed
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
    decode calls (speculative rounds when armed), the token steps they
    ran (a plain step runs every layer once; a round counts its largest
    accepted count) and their host wall time, which ends with the tokens
    on the host."""

    def __init__(self, engine: ServeEngine):
        self.engine = engine
        self.replicas = engine.replicas
        self._queue: Deque[Request] = deque()
        self._alloc = [SlotAllocator(engine.scfg.slots, replica=r)
                       for r in range(self.replicas)]
        scfg = engine.scfg
        self._prefix: List[Optional[PrefixCache]] = [
            PrefixCache(scfg.prefix_pages, scfg.prefix_page_tokens,
                        first_row=scfg.slots, replica=r)
            if scfg.prefix_pages else None
            for r in range(self.replicas)]
        self._active: List[Dict[int, Request]] = [
            {} for _ in range(self.replicas)]
        self._moe_load = None            # last ServeEngine.moe_load()
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
        """Prefill one admitted request, through a sealed prefix page when
        one matches, and return its first token.  A shareable miss seals
        its prefix first and reads through it itself (the "copy" of
        copy-on-write is the suffix landing in the private slot)."""
        r, pc = req.replica, self._prefix[req.replica]
        if pc is not None:
            got = pc.acquire(req.prompt)
            if got is None:
                adm = pc.admit(req.prompt)
                if adm is not None:
                    row, plen = adm
                    self.engine.seal_prefix(r, row, req.prompt[:plen])
                    pc.seal(row)
                    pc.attach(row)
                    req.prefix_row, req.prefix_len = row, plen
            else:
                req.prefix_row, req.prefix_len = got
                req.prefix_hit = True
        if req.prefix_row >= 0:
            first = self.engine.chunk_prefill(
                r, req.slot, req.prompt[req.prefix_len:], req.prefix_len,
                req.prefix_row)
        else:
            first, _ = self.engine.prefill(r, req.slot, req.prompt)
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
            # prefix-affine routing: the longest sealed match of the head
            # request's prompt first, then load, then the MoE skew
            head = self._queue[0]

            def _rank(r):
                pc = self._prefix[r]
                got = pc.match(head.prompt) if pc is not None else None
                return (-(got[1] if got else 0), len(self._active[r]),
                        self._expert_skew(r), r)
            target = min(candidates, key=_rank)
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
        prows = np.full((R, S), idle_slot, np.int32)
        plens = np.zeros((R, S), np.int32)
        for r in range(R):
            for i, slot in enumerate(lanes[r]):
                req = self._active[r][slot]
                toks[r, i] = req.generated[-1]
                slots[r, i] = slot
                lens[r, i] = req.next_pos
                if req.prefix_row >= 0:
                    prows[r, i] = req.prefix_row
                    plens[r, i] = req.prefix_len
        pargs = (prows, plens) if self._prefix[0] is not None else (None,
                                                                    None)
        t0 = time.monotonic()
        if self.engine.scfg.spec_decode:
            emitted, counts = self.engine.spec_decode(toks, slots, lens,
                                                      *pargs)
            new = lambda r, i: emitted[r, i, :counts[r, i]]   # noqa: E731
            steps = int(counts.max())
        else:
            gen = self.engine.decode(toks, slots, lens, *pargs)  # [R,steps,S]
            new = lambda r, i: gen[r, :, i]                   # noqa: E731
            steps = gen.shape[1]
        self.decode_seconds += time.monotonic() - t0
        self.decode_calls += 1
        self.decode_steps += steps
        self._moe_load = self.engine.moe_load()
        retired: List[Request] = []
        for r in range(R):
            for i, slot in enumerate(lanes[r]):
                req = self._active[r][slot]
                room = req.max_new_tokens - len(req.generated)
                req.generated.extend(int(t) for t in new(r, i)[:room])
                if self._maybe_retire(req):
                    retired.append(req)
        return retired

    def _expert_skew(self, r: int) -> int:
        """Quantized routing skew of replica ``r``'s last engine call: the
        hottest expert's excess top-1 fraction over perfect balance, in
        eighths (0 for dense engines, balanced batches, or no data yet).
        Admission breaks load ties with it."""
        load = self._moe_load
        if not load or r >= len(load) or not load[r]["tokens"]:
            return 0
        frac = load[r]["fractions"]
        return int((float(frac.max()) - 1.0 / len(frac)) * 8)

    def _maybe_retire(self, req: Request) -> bool:
        # the next call appends at next_pos .. next_pos + window - 1 (a
        # speculative round's k + 1 when armed), all of which must fit
        # under the per-slot capacity
        window = self.engine.scfg.decode_window
        if (len(req.generated) < req.max_new_tokens
                and req.next_pos + window <= self.engine.scfg.max_len):
            return False
        req.state = "done"
        req.finished_at = time.monotonic()
        self._active[req.replica].pop(req.slot, None)
        self._alloc[req.replica].free(req.slot)
        if req.prefix_row >= 0:
            self._prefix[req.replica].release(req.prefix_row)
        self.completed.append(req)
        return True
