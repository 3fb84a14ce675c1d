"""Continuous batching over one :class:`ServeEngine` (counterpart of
``bluefog_tpu/serve/scheduler.py``: the scheduler, its replica failure
and restore paths, its observability hooks, and the autoscaler).

Each :meth:`Scheduler.step` admits queued requests into free slots of
the engine's live replicas (prefilling each one on its replica), runs
one engine call for every replica at the smallest declared batch bucket
that fits the busiest replica's lanes, and retires requests that reached
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

A replica leaves the rotation by :meth:`Scheduler.fail_replica` (a kill,
a health eviction, or an autoscale park with ``park=True``) or
:meth:`Scheduler.preempt_replica`; its in-flight requests go back to the
head of the queue in arrival order, and :meth:`Scheduler.restore_replica`
brings it back (its prefix directory rebuilt empty unless it was
parked).  :class:`AutoScaler` parks and regrows replicas from the queue
depth and the trailing p99 token latency, writing the scale file in
ranks.

Request metrics go to the registry under the JAX names
(``bluefog_requests_total{status=...}``,
``bluefog_tokens_generated_total``, the
``bluefog_serve_token_latency_seconds`` histogram, the
``bluefog_serve_ttft_{hit,cold}_seconds`` histograms, the queue-depth
gauge and the MoE hot-expert gauges), each request gets a span tree when
tracing is armed (:mod:`bluefog_tpu_torch.utils.tracing`), and a
``serve`` flight block names the requests a failed replica held.  None
of this reads a device value: the decode call's tokens reach the host
anyway, and the latency histogram takes at most 64 observations a call,
as in JAX.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from ..utils import flight as _flight
from ..utils import metrics as _metrics
from ..utils import timeseries as _ts
from ..utils import tracing as _tracing
from .engine import ServeEngine
from .kv_cache import PrefixCache, SlotAllocator

__all__ = ["Request", "Scheduler", "AutoScaler"]

LATENCY_BUCKETS = (.0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5,
                   1.0, 2.5)

_REQ_HELP = ("serve request events by status (done/failed are terminal "
             "and count once; requeued counts once per eviction)")
_TOK_HELP = "tokens produced by serve decode steps"
_LAT_HELP = "per-token serve latency (prefill + decode)"


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle state."""
    id: int
    prompt: List[int]
    max_new_tokens: int
    state: str = "queued"            # queued -> running -> done | failed
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
    requeued: int = 0                # replica-failure evictions survived
    requeued_at: Optional[float] = None   # last eviction time (queue spans)
    trace_id: str = ""               # request-scoped trace (utils.tracing)

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
        self._prefix: List[Optional[PrefixCache]] = [
            self._new_prefix(r) for r in range(self.replicas)]
        self._active: List[Dict[int, Request]] = [
            {} for _ in range(self.replicas)]
        self._dead: set = set()
        self._parked: set = set()        # autoscale-parked subset of _dead
        self._next_id = 0
        self._last_ids: List[List[int]] = [[] for _ in range(self.replicas)]
        self._moe_load = None            # last ServeEngine.moe_load()
        self._slo = None                 # diagnostics.SLOEngine, if attached
        self.completed: List[Request] = []
        self.failed: List[Request] = []
        self.requeued_total = 0
        self.decode_calls = 0
        self.decode_steps = 0
        self.decode_seconds = 0.0
        _flight.register_block("serve", self._flight_block)

    def _new_prefix(self, r: int) -> Optional[PrefixCache]:
        scfg = self.engine.scfg
        if not scfg.prefix_pages:
            return None
        return PrefixCache(scfg.prefix_pages, scfg.prefix_page_tokens,
                           first_row=scfg.slots, replica=r)

    # ------------------------------------------------------------------

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
        # a process-wide trace id, not req.id: several schedulers can
        # live in one process and each restarts its ids at 0
        req.trace_id = _tracing.new_trace("req")
        _tracing.mark(req.trace_id, "submit", cat="serve", req=req.id,
                      prompt_len=len(req.prompt),
                      max_new_tokens=req.max_new_tokens)
        self._queue.append(req)
        return req

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        return sum(len(a) for a in self._active)

    @property
    def done(self) -> bool:
        return not self._queue and self.in_flight == 0

    def live_replicas(self) -> List[int]:
        return [r for r in range(self.replicas) if r not in self._dead]

    # ------------------------------------------------------------------

    def fail_replica(self, replica: int, reason: str = "failed",
                     park: bool = False) -> List[Request]:
        """Take a replica out of rotation (a kill, a health eviction, an
        autoscale retire).

        Its in-flight requests are not lost: their KV (and any shared
        prefix pages) lived on the failed replica, so each one is reset
        to its prompt and requeued at the head of the admission queue,
        the evicted in their arrival order, with ``requeued`` stamped
        into the request and ``bluefog_requests_total{status="requeued"}``
        counted.  That label counts events, not requests: a request
        evicted twice is counted twice, so ``requeued`` does not sum with
        the terminal ``done`` / ``failed`` statuses.  ``generated`` is
        cleared, so a streaming consumer sees the tokens again when the
        request re-runs.

        ``park=True`` marks an autoscale park: the replica's state (KV
        pages, sealed prefixes) stays intact, merely unscheduled, so
        :meth:`restore_replica` re-admits traffic to it as it is.  Kills
        and health evictions leave ``park=False``."""
        if replica in self._dead:
            return []
        self._dead.add(replica)
        if park:
            self._parked.add(replica)
        lost = list(self._active[replica].values())
        for req in lost:
            self._alloc[replica].free(req.slot)
            if req.prefix_row >= 0 and self._prefix[replica] is not None:
                self._prefix[replica].release(req.prefix_row)
            req.state = "queued"
            req.replica = req.slot = req.prefix_row = -1
            req.prefix_len = 0
            req.prefix_hit = False
            req.generated.clear()          # the KV died with the replica
            req.first_token_at = None
            req.requeued += 1
            req.requeued_at = time.monotonic()
            self.requeued_total += 1
            _metrics.counter("bluefog_requests_total",
                             _REQ_HELP).inc(status="requeued")
        self._active[replica].clear()
        self._queue.extendleft(reversed(lost))
        _flight.record("serve", name=f"replica_{reason}", replica=replica,
                       requeued_requests=[r.id for r in lost])
        if not self.live_replicas():
            raise RuntimeError("every serving replica has failed")
        return lost

    def preempt_replica(self, replica: int, *, zone: Optional[int] = None,
                        grace: float = 0.0) -> List[Request]:
        """Evict a replica whose capacity was reclaimed: a kill
        (``park=False``: its prefix directory is rebuilt empty on a later
        :meth:`restore_replica`) whose flight event says *preempted*,
        with the zone and the grace window."""
        lost = self.fail_replica(replica, reason="preempted", park=False)
        _flight.record("serve", name="replica_preempt_notice",
                       replica=replica, zone=zone, grace=float(grace),
                       requeued=len(lost))
        return lost

    def restore_replica(self, replica: int) -> bool:
        """Bring a failed replica back into rotation; True if it was out.

        A parked replica re-admits traffic as it is: its sealed prefix
        pages are still backed by its KV.  A replica that failed lost
        that KV, so its prefix directory is rebuilt empty: re-attaching
        the old sealed rows would serve stale KV to every later hit."""
        if replica not in self._dead:
            return False
        self._dead.discard(replica)
        parked = replica in self._parked
        self._parked.discard(replica)
        if not parked and self._prefix[replica] is not None:
            self._prefix[replica] = self._new_prefix(replica)
        _flight.record("serve", name="replica_restored", replica=replica,
                       parked=parked)
        return True

    # ------------------------------------------------------------------

    def step(self) -> List[Request]:
        """One admit -> decode -> retire cycle; returns the requests
        retired by the decode."""
        self._admit()
        retired = self._decode_once()
        _metrics.gauge("bluefog_serve_queue_depth",
                       "admission-queue depth after each scheduler step"
                       ).set(self.pending)
        if self._slo is not None:
            self._slo.observe(self)
        return retired

    def attach_slo(self, engine) -> None:
        """Attach an SLO engine (:class:`bluefog_tpu_torch.diagnostics.
        SLOEngine`); its ``observe(sched)`` runs after every step."""
        self._slo = engine

    def drain(self, max_steps: int = 10_000) -> None:
        """Run until every submitted request reaches a terminal state."""
        for _ in range(max_steps):
            if self.done:
                return
            self.step()
        raise RuntimeError(f"scheduler did not drain in {max_steps} steps")

    # ------------------------------------------------------------------

    def _prefill_request(self, req: Request) -> int:
        """Prefill one admitted request, through a sealed prefix page when
        one matches, and return its first token.  A shareable miss seals
        its prefix first and reads through it itself (the "copy" of
        copy-on-write is the suffix landing in the private slot).
        Observes the TTFT histogram of the hit / cold outcome."""
        t0 = time.monotonic()
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
        _metrics.histogram(
            "bluefog_serve_ttft_hit_seconds" if req.prefix_hit
            else "bluefog_serve_ttft_cold_seconds",
            "time to first token, by prefix-cache outcome",
            buckets=LATENCY_BUCKETS).observe(
                req.first_token_at - req.submitted_at)
        _tracing.add_span(req.trace_id, "prefill", t0, req.first_token_at,
                          cat="serve", hit=req.prefix_hit, replica=r,
                          prompt_len=len(req.prompt),
                          prefix_len=req.prefix_len)
        return first

    def _admit(self) -> None:
        # a lane needs a free KV slot AND a decode lane: never admit past
        # the largest declared batch bucket
        scfg = self.engine.scfg
        lane_cap = min(scfg.slots, scfg.batch_buckets[-1])
        while self._queue:
            candidates = [r for r in self.live_replicas()
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
            t0 = time.monotonic()
            req.admitted_at = t0
            # a requeued request's second wait starts at its eviction
            q0 = (req.requeued_at if req.requeued_at is not None
                  else req.submitted_at)
            _tracing.add_span(req.trace_id, "queue", q0, t0, cat="serve",
                              replica=target, requeued=req.requeued)
            req.generated.append(self._prefill_request(req))
            _metrics.counter("bluefog_tokens_generated_total",
                             _TOK_HELP).inc()
            _metrics.histogram(
                "bluefog_serve_token_latency_seconds", _LAT_HELP,
                buckets=LATENCY_BUCKETS).observe(req.first_token_at - t0)
            self._active[target][slot] = req
            self._last_ids[target] = (self._last_ids[target] + [req.id])[-8:]
            self._maybe_retire(req)

    def _decode_once(self) -> List[Request]:
        lanes = [sorted(self._active[r]) for r in range(self.replicas)]
        busiest = max((len(l) for l in lanes), default=0)
        if busiest == 0:
            return []
        scfg = self.engine.scfg
        S = scfg.batch_bucket_for(busiest)
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
        if scfg.spec_decode:
            emitted, counts = self.engine.spec_decode(toks, slots, lens,
                                                      *pargs)
            new = lambda r, i: emitted[r, i, :counts[r, i]]   # noqa: E731
            steps = int(counts.max())
        else:
            gen = self.engine.decode(toks, slots, lens, *pargs)  # [R,steps,S]
            new = lambda r, i: gen[r, :, i]                   # noqa: E731
            steps = gen.shape[1]
        dt = time.monotonic() - t0
        self.decode_seconds += dt
        self.decode_calls += 1
        self.decode_steps += steps
        self._note_moe_load()
        traced = _tracing.enabled()
        n_tokens = 0
        retired: List[Request] = []
        for r in range(R):
            for i, slot in enumerate(lanes[r]):
                req = self._active[r][slot]
                room = req.max_new_tokens - len(req.generated)
                got = [int(t) for t in new(r, i)[:room]]
                req.generated.extend(got)
                n_tokens += len(got)
                if traced:
                    # one call covers every lane: each rider gets the same
                    # [t0, t0 + dt) span, tagged with its own yield
                    extra = ({"accepted": int(counts[r, i]),
                              "rejected": int(scfg.spec_decode
                                              - counts[r, i] + 1)}
                             if scfg.spec_decode else {})
                    _tracing.add_span(
                        req.trace_id, "decode", t0, t0 + dt, cat="serve",
                        call=self.decode_calls, tokens=len(got), **extra)
                if self._maybe_retire(req):
                    retired.append(req)
        if n_tokens:
            _metrics.counter("bluefog_tokens_generated_total",
                             _TOK_HELP).inc(n_tokens)
            h = _metrics.histogram("bluefog_serve_token_latency_seconds",
                                   _LAT_HELP, buckets=LATENCY_BUCKETS)
            for _ in range(min(steps, 64)):   # bounded observer cost
                h.observe(dt / max(steps, 1))
        return retired

    def _note_moe_load(self) -> None:
        """Keep the engine's per-replica routing load of the last call
        (None for dense engines) and publish the hot-expert gauges: the
        hottest expert's top-1 dispatch fraction, the mean router
        entropy, and every (replica, expert) fraction."""
        self._moe_load = load = self.engine.moe_load()
        if load is None:
            return
        hot = _metrics.gauge(
            "bluefog_serve_hot_expert_fraction",
            "top-1 dispatch fraction of the hottest expert in the last "
            "fused MoE batch, per replica")
        ent = _metrics.gauge(
            "bluefog_serve_router_entropy",
            "mean live-token router entropy (nats) of the last fused MoE "
            "batch, per replica")
        per = _metrics.gauge(
            "bluefog_serve_expert_load_fraction",
            "top-1 dispatch fraction per (replica, expert) in the last "
            "fused MoE batch")
        for r, row in enumerate(load):
            if not row["tokens"]:
                continue
            hot.set(float(row["fractions"].max()), replica=r)
            ent.set(row["entropy"], replica=r)
            for e, f in enumerate(row["fractions"]):
                per.set(float(f), replica=r, expert=e)

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
        # the root span: [submitted_at, finished_at) is the request's
        # measured end-to-end latency
        _tracing.add_span(req.trace_id, "request", req.submitted_at,
                          req.finished_at, cat="serve",
                          tokens=len(req.generated), replica=req.replica,
                          requeued=req.requeued)
        self.completed.append(req)
        _metrics.counter("bluefog_requests_total",
                         _REQ_HELP).inc(status="done")
        return True

    # ------------------------------------------------------------------

    def _flight_block(self) -> dict:
        """The ``serve`` bundle block a postmortem reads after a kill."""
        now = time.monotonic()
        block = {
            "replicas": self.replicas,
            "dead_replicas": sorted(self._dead),
            "parked_replicas": sorted(self._parked),
            "pending": self.pending,
            "in_flight": {str(r): sorted(req.id
                                         for req in self._active[r].values())
                          for r in range(self.replicas) if self._active[r]},
            "in_flight_traces": {
                str(r): [{"id": req.id, "trace": req.trace_id,
                          "age_s": round(now - req.submitted_at, 6),
                          "queue_s": round(
                              (req.admitted_at if req.admitted_at is not None
                               else now) - req.submitted_at, 6)}
                         for _, req in sorted(self._active[r].items())]
                for r in range(self.replicas) if self._active[r]},
            "queued": [{"id": q.id, "trace": q.trace_id,
                        "age_s": round(now - q.submitted_at, 6)}
                       for q in list(self._queue)[:16]],
            "last_request_ids": {str(r): ids for r, ids
                                 in enumerate(self._last_ids) if ids},
            "completed": len(self.completed),
            "failed": [r.id for r in self.failed],
            "requeued": self.requeued_total,
        }
        if self._prefix[0] is not None:
            block["prefix_pages"] = {
                str(r): self._prefix[r].describe()
                for r in self.live_replicas() if self._prefix[r].in_use}
        if self._moe_load is not None:
            block["moe"] = {
                str(r): {
                    "fractions": [round(float(f), 6)
                                  for f in row["fractions"]],
                    "entropy": round(row["entropy"], 6),
                    "tokens": row["tokens"],
                    "skew_eighths": self._expert_skew(r),
                }
                for r, row in enumerate(self._moe_load) if row["tokens"]}
        return block

    def close(self) -> None:
        _flight.unregister_block("serve")


# the AutoScaler's trailing p99 window (s) and the weight of its fallback
# EWMA over the histogram's reservoir percentile (JAX's defaults)
WINDOW_S = 60.0
ALPHA = 0.2


class AutoScaler:
    """SLO-driven serve autoscaling: breaches write the scale file.

    Watches two signals after every :meth:`Scheduler.step` — the
    admission-queue depth and a trailing-window p99 of
    ``bluefog_serve_token_latency_seconds`` read from the time-series
    store (:mod:`bluefog_tpu_torch.utils.timeseries`; the scaler arms the
    ring itself, and falls back to an EWMA over the histogram's
    reservoir percentile for observations that predate arming) — and
    closes the
    elastic loop: a sustained breach *grows* the serving fleet (restores
    the lowest PARKED replica — one retired by this scaler, whose slice
    is intact; a chaos-killed replica's KV died with it and is never
    re-admitted here — AND writes the new target into the bfrun scale
    file so the supervisor regrows the world under it), a quiet queue
    well under the SLO *retires* the highest live replica after a
    cooldown.  Retirement uses the requeue path, so shrinking never
    fails a request.

    The scale file speaks the supervisor's unit: RANKS (world size), not
    replicas.  Each serve replica is a PP×TP×SP slice of the engine
    mesh's ``slice_size`` ranks, so every action writes
    ``live_replicas * ranks_per_replica``.

    ``BLUEFOG_SLO_P99_MS`` sets the p99 target when ``slo_p99_s`` is not
    given (default 250 ms).  ``cooldown_steps`` applies between any two
    scale actions in either direction.  The trailing window
    (:data:`WINDOW_S`) and the fallback EWMA's weight (:data:`ALPHA`)
    are JAX's defaults.
    """

    def __init__(self, sched: Scheduler, *,
                 slo_p99_s: Optional[float] = None,
                 queue_high: Optional[int] = None,
                 cooldown_steps: int = 50,
                 scale_file: Optional[str] = None,
                 min_replicas: int = 1):
        from ..utils.config import env_float
        if slo_p99_s is None:
            slo_p99_s = env_float("BLUEFOG_SLO_P99_MS", 250.0) / 1000.0
        if slo_p99_s <= 0:
            raise ValueError(f"slo_p99_s must be > 0, got {slo_p99_s}")
        if queue_high is None:
            # headroom of one full refill of every live replica's slots
            queue_high = 2 * sched.engine.scfg.slots * max(
                1, len(sched.live_replicas()))
        self.sched = sched
        self.slo_p99_s = float(slo_p99_s)
        self.queue_high = int(queue_high)
        self.cooldown_steps = int(cooldown_steps)
        self.scale_file = scale_file
        self.min_replicas = max(1, int(min_replicas))
        # replicas -> ranks: each serve replica is one PP*TP*SP slice
        self.ranks_per_replica = int(getattr(
            getattr(sched.engine, "m", None), "slice_size", 1))
        # every future latency observation also lands in a bounded ring;
        # observe() scores the trailing window instead of the lifetime
        # reservoir
        _ts.arm("bluefog_serve_token_latency_seconds")
        self.ewma_p99: Optional[float] = None
        self.events: List[dict] = []
        self._step = 0
        self._last_action_step = -cooldown_steps

    # ------------------------------------------------------------------

    def _write_scale(self, target: int) -> None:
        if self.scale_file is None:
            return
        from ..run.launcher import _write_scale
        _write_scale(self.scale_file, target)

    def _record(self, action: str, replica: int) -> None:
        live = len(self.sched.live_replicas())
        target_world = live * self.ranks_per_replica
        ev = {"step": self._step, "action": action, "replica": replica,
              "live_replicas": live,
              "target_world": target_world,
              "pending": self.sched.pending,
              "ewma_p99_s": self.ewma_p99}
        self.events.append(ev)
        self._last_action_step = self._step
        # the supervisor's unit is ranks, not replicas
        self._write_scale(target_world)
        _metrics.counter(
            "bluefog_autoscale_events_total",
            "autoscale actions by direction").inc(action=action)
        _flight.record("autoscale", name=action, replica=replica,
                       live_replicas=live, target_world=target_world,
                       pending=self.sched.pending,
                       ewma_p99_s=self.ewma_p99)

    # ------------------------------------------------------------------

    def observe(self) -> Optional[dict]:
        """Fold in one scheduler step; returns the scale event if one
        fired.  Call once per :meth:`Scheduler.step`."""
        self._step += 1
        # primary: exact p99 over the trailing window of the armed ring
        p99 = _ts.percentile("bluefog_serve_token_latency_seconds", 99,
                             window_s=WINDOW_S)
        if p99 is None:
            # ring empty (observations predate arming): EWMA over the
            # lifetime reservoir percentile, the pre-timeseries behavior
            raw = _metrics.histogram(
                "bluefog_serve_token_latency_seconds",
                "per-token serve latency (prefill + decode)",
                buckets=LATENCY_BUCKETS).percentile(99)
            if raw is not None:
                p99 = (raw if self.ewma_p99 is None else
                       ALPHA * raw + (1.0 - ALPHA) * self.ewma_p99)
        if p99 is not None:
            self.ewma_p99 = p99
            _ts.append("bluefog_serve_p99_s", p99)
            # also a registry gauge: the fleet-view carrier gossips it,
            # so every rank's scaler scores the fleet's worst p99
            _metrics.gauge(
                "bluefog_serve_p99_s",
                "trailing-window p99 of per-token serve latency (s)"
                ).set(p99)
        if self._step - self._last_action_step < self.cooldown_steps:
            return None
        sched = self.sched
        # fleet re-basing: with a gossiped fleet view armed, a queue or
        # p99 breach anywhere in the fleet is scored here too — the rank
        # holding the parked replica acts even when its local signals are
        # calm (the retire path stays strictly local)
        fleet_pending = fleet_p99 = None
        from ..utils import fleetview as _fleetview
        fv = _fleetview.active()
        if fv is not None:
            fleet_pending, _ = fv.fleet_max("bluefog_serve_queue_depth")
            fleet_p99, _ = fv.fleet_max("bluefog_serve_p99_s")
        eff_pending = max(sched.pending, int(fleet_pending or 0))
        eff_p99 = max((x for x in (self.ewma_p99, fleet_p99)
                       if x is not None), default=None)
        breach = (eff_pending > self.queue_high
                  or (eff_p99 is not None and eff_p99 > self.slo_p99_s))
        if breach and sched._parked:
            # only autoscale-parked replicas re-admit traffic: a
            # chaos-killed/health-evicted one lost its KV with the slice
            replica = min(sched._parked)
            sched.restore_replica(replica)
            self._record("grow", replica)
            return self.events[-1]
        live = sched.live_replicas()
        calm = (not breach and sched.pending == 0
                and (self.ewma_p99 is None
                     or self.ewma_p99 < 0.5 * self.slo_p99_s))
        if calm and len(live) > self.min_replicas:
            replica = max(live)
            sched.fail_replica(replica, reason="retired", park=True)
            self._record("retire", replica)
            return self.events[-1]
        return None
