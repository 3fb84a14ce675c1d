"""Tier-3 evidence: live micro-trials of the top-K candidates
(counterpart of ``bluefog_tpu/autotune/trials.py``).

A trial runs the candidate's probe update (the strategy update on zero
grads, the same call tier 1 counted bytes from) once to warm up, then
``iters`` times, each between ``torch.cuda.synchronize()`` calls on the
card, and takes the median wall-clock per step.  Each trial's artifact is
banked to ``docs/measured/`` the moment it finishes (a mid-search death
loses nothing), marked ``on_accelerator`` only when it ran on the card,
so a CPU trial can never steer a later tune.
"""
from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional

import torch

from ..parallel import context as _mesh
from .bank import bank_trial
from .candidates import Candidate
from .cost_model import build_probe_strategy, probe_inputs


def trial_id(cand: Candidate, device_kind: str, n: int) -> str:
    h = hashlib.sha256(
        f"{cand.key}|{device_kind}|{n}".encode()).hexdigest()
    return h[:12]


def device_kind(dev: torch.device) -> str:
    """The bank's device kind: the card's name, or ``"cpu"``."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_trials(
    cands: List[Candidate],
    params,
    n: int,
    opt_factory,
    *,
    iters: int = 5,
    mdir: Optional[str] = None,
    bank: bool = True,
) -> Dict[str, float]:
    """Measure ``seconds_per_step`` for each candidate; returns key->s.

    The timed call is the strategy *update* (gossip + optimizer math, zero
    grads): the communication cost under comparison, without a user
    model's compute drowning the signal on small probes.  A trial that
    fails to run is skipped (its candidate keeps its tier-1 score).
    """
    dev = _mesh.get_context().device
    kind = device_kind(dev)
    on_accel = dev.type == "cuda"

    def sync():
        if on_accel:
            torch.cuda.synchronize(dev)

    out: Dict[str, float] = {}
    for cand in cands:
        try:
            strategy = build_probe_strategy(cand, n, opt_factory)
            p, s, g = probe_inputs(strategy, params, n)
            with torch.no_grad():
                sync()
                p, s = strategy.update(g, s, p)              # warm-up
                sync()
                samples = []
                for _ in range(max(iters, 1)):
                    t0 = time.perf_counter()
                    p, s = strategy.update(g, s, p)
                    sync()
                    samples.append(time.perf_counter() - t0)
            samples.sort()
            sec = samples[len(samples) // 2]
        except Exception:                                # noqa: BLE001
            continue
        out[cand.key] = sec
        if bank:
            bank_trial({
                "schema": "bluefog-autotune-trial-1",
                "trial_id": trial_id(cand, kind, n),
                "key": cand.key,
                "algorithm": cand.algorithm,
                "config": cand.config(),
                "seconds_per_step": round(sec, 9),
                "iters": iters,
                "device": kind,
                "n_chips": n,
                "ok": True,
                "on_accelerator": on_accel,
            }, mdir)
    return out
