"""``autotune()``: pick (algorithm, topology, wire, fused-k, overlap,
concurrent) from a cost model + banked measurements + optional trials
(counterpart of ``bluefog_tpu/autotune/tuner.py``; same signatures,
defaults, audit and plan documents).

Three evidence tiers feed the ranking, strongest last:

1. **Analytic** (always): per-step wire bytes counted by the wire-byte
   ledger over one run of every candidate group's update on the
   context's device (:mod:`~bluefog_tpu_torch.autotune.cost_model`) +
   consensus quality via ``topology.spectral_gap``.  Deterministic — no
   clocks, no RNG.
2. **Banked** (when ``docs/measured/`` has matching hardware artifacts):
   strategy-aware measured seconds override the analytic pseudo-seconds
   (:mod:`~bluefog_tpu_torch.autotune.bank`).
3. **Trials** (opt-in, ``trials=`` or ``BLUEFOG_AUTOTUNE_TRIALS``): the
   top-K candidates' probe updates are timed live and each measurement
   is banked the moment it lands
   (:mod:`~bluefog_tpu_torch.autotune.trials`).

Contract-violating combinations never reach a probe: they are filtered
by the constructor metadata in ``optimizers.STRATEGIES`` with the
rejection reason recorded in the plan's audit trail.  A probe or a
carving step that raises becomes an audited rejection, as a failed
compile does in JAX.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

from ..parallel import context as _mesh
from . import bank as _bank
from . import cost_model as _cm
from . import trials as _trials
from .candidates import (CarvingCandidate, carving_violation,
                         enumerate_candidates, enumerate_carvings)
from .plan import Plan, make_plan_doc


def _default_params():
    """Tiny two-leaf probe tree: enough structure to exercise fusion and
    per-dtype bucketing without making ~50 group probes expensive."""
    import torch
    return {"w": torch.zeros((256, 64), dtype=torch.float32),
            "b": torch.zeros((64,), dtype=torch.float32)}


def _default_opt_factory():
    from .. import optimizers as bfopt
    return lambda: bfopt.sgd(0.05, momentum=0.9)


def autotune(
    params=None,
    *,
    objective="step_time",
    trials=0,
    algorithms: Optional[Sequence[str]] = None,
    topologies: Optional[Sequence[dict]] = None,
    wires: Optional[Sequence[Optional[str]]] = None,
    fused_k: Sequence[int] = (1, 4),
    include_delayed: bool = True,
    include_concurrent: bool = True,
    opt_factory=None,
    measured_dir: Optional[str] = None,
    bank_trials: bool = True,
) -> Plan:
    """Search the strategy space and return the winning :class:`Plan`.

    Args:
      params: parameter tree (one rank's tensors) the probes run on,
        moved to the context's device (defaults to a tiny two-leaf tree;
        pass your real tree for honest byte counts).
      objective: ``"step_time"``, ``"consensus_per_byte"``, or a weight
        dict blending both (see ``cost_model.objective_score``).
      trials: ``0`` (pure cost model + bank), an int K (time the top-K
        live), or ``"auto"`` (K from ``BLUEFOG_AUTOTUNE_TRIALS``,
        default 3).
      algorithms / topologies / wires / fused_k / include_delayed /
        include_concurrent: restrict the enumerated space (tests and the
        smoke target shrink it; the default space is the full zoo).
      opt_factory: zero-arg callable returning the inner optimizer
        factory for probes/trials (default
        ``bluefog_tpu_torch.optimizers.sgd(0.05, momentum=0.9)``).
      measured_dir: override the banked-artifact directory
        (default ``BLUEFOG_MEASURED_DIR`` or ``docs/measured``).
      bank_trials: write trial artifacts as they land (disable in tests
        that must not touch the bank).

    Returns a deterministic plan: with ``trials=0`` the same inputs always
    produce byte-identical plan JSON.
    """
    ctx = _mesh.get_context()
    n = ctx.size
    device_kind = _trials.device_kind(ctx.device)
    on_accel = ctx.device.type == "cuda"
    if params is None:
        params = _default_params()
    if opt_factory is None:
        opt_factory = _default_opt_factory()
    if trials == "auto":
        trials = int(os.environ.get("BLUEFOG_AUTOTUNE_TRIALS", "3"))
    trials = int(trials)

    cands, rejected = enumerate_candidates(
        n, algorithms=algorithms, topologies=topologies, wires=wires,
        fused_k=fused_k, include_delayed=include_delayed,
        include_concurrent=include_concurrent)
    # total enumerated, fixed now: probe failures below MOVE a candidate
    # from cands into rejected, they don't add a new one
    considered = len(cands) + len(rejected)

    # tier 1: one probe run per group -> per-step bytes for every member
    group_bytes, group_counts, group_fail = {}, {}, {}
    for cand in cands:
        g = cand.compile_group
        if g in group_bytes or g in group_fail:
            continue
        try:
            counts, b = _cm.group_wire_bytes(cand, params, n, opt_factory)
            group_bytes[g], group_counts[g] = b, counts
        except Exception as e:                           # noqa: BLE001
            group_fail[g] = f"probe failed: {type(e).__name__}: {e}"[:300]

    scored, survivors = [], []
    for cand in cands:
        g = cand.compile_group
        if g in group_fail:
            rejected.append({"key": cand.key, "config": cand.config(),
                             "reason": group_fail[g]})
            continue
        survivors.append(cand)
        gap = _cm.consensus_gap(cand)
        rounds = _cm.num_schedule_rounds(cand, n)
        step_s = _cm.predicted_step_time_s(cand, group_bytes[g], rounds)
        evidence = "analytic"
        source = None
        banked = _bank.banked_step_time(cand.algorithm, device_kind, n,
                                        measured_dir, key=cand.key)
        if banked is not None:
            banked_s, source, exact = banked
            # coarse (algorithm-level) evidence ranks the algorithm; the
            # analytic model keeps ordering candidates *within* it through
            # a 1/1000-weight residual that can never outvote a measurement
            step_s = banked_s if exact else banked_s + step_s * 1e-3
            evidence = "banked" if exact else "banked_coarse"
        scored.append({"cand": cand, "bytes": group_bytes[g], "gap": gap,
                       "rounds": rounds, "step_time_s": step_s,
                       "evidence": evidence, "source": source})

    if not scored:
        raise RuntimeError(
            "autotune: every candidate was rejected or its probe failed "
            f"({len(rejected)} rejections; see the reasons)")

    def score_of(e):
        return _cm.objective_score(objective, e["step_time_s"], e["gap"],
                                   e["bytes"])
    scored.sort(key=lambda e: (score_of(e), e["cand"].key))

    # tier 3: live-time the current top-K; measured seconds override
    if trials > 0:
        top = [e["cand"] for e in scored[:trials]]
        measured = _trials.run_trials(
            top, params, n, opt_factory, mdir=measured_dir,
            bank=bank_trials)
        for e in scored:
            if e["cand"].key in measured:
                e["step_time_s"] = measured[e["cand"].key]
                e["evidence"] = "trial"
                e["source"] = None
        scored.sort(key=lambda e: (score_of(e), e["cand"].key))

    best = scored[0]
    cfg = best["cand"].config()
    coll = {k: int(v)
            for k, v in sorted(group_counts[best["cand"].compile_group]
                               .items())}
    predicted = {
        "wire_bytes_per_step_per_chip": int(best["bytes"]),
        "collectives": coll,
        "spectral_gap": round(best["gap"], 9),
        "schedule_rounds": best["rounds"],
        "step_time_s": round(best["step_time_s"], 9),
        "score": round(score_of(best), 12),
        "evidence": best["evidence"],
        "evidence_source": best["source"],
        "backend": "accelerator" if on_accel else "cpu",
    }
    audit = {
        "considered": considered,
        "scored": [
            {"key": e["cand"].key,
             "wire_bytes_per_step_per_chip": int(e["bytes"]),
             "spectral_gap": round(e["gap"], 9),
             "step_time_s": round(e["step_time_s"], 9),
             "score": round(score_of(e), 12),
             "evidence": e["evidence"],
             **({"source": e["source"]} if e["source"] else {})}
            for e in scored],
        "rejected": [{"key": r["key"], "reason": r["reason"]}
                     for r in rejected],
    }
    return Plan(make_plan_doc(
        config=cfg, objective=objective, n_chips=n,
        device_kind=device_kind, predicted=predicted, audit=audit))


CARVING_PLAN_SCHEMA = "bluefog-carving-plan-1"


def tune_carving(
    cfg,
    *,
    wire: Optional[str] = "bf16",
    objective: str = "dcn_bytes",
    carvings: Optional[Sequence[Sequence[int]]] = None,
    require_gossip: bool = True,
    remat: bool = False,
    max_pp: Optional[int] = None,
    max_tp: Optional[int] = None,
    max_sp: Optional[int] = None,
    max_ep: Optional[int] = None,
) -> dict:
    """Learn the mesh carving — the ``(dp, pp, tp, sp, ep)`` axis split —
    for one model config over the context's ranks.

    The expert axis is part of the search: when ``cfg`` is a
    :class:`~bluefog_tpu_torch.moe.model.MoELMConfig` every legal ``ep``
    shows up as a candidate (``ep > 1`` on a dense config is an *audited
    rejection*, as is ``num_experts % ep != 0`` — the same contract
    ``compose_parallelism`` enforces eagerly).  Every surviving carving
    runs one real optimizer step on the context's device with the
    wire-byte ledger armed (:func:`cost_model.carving_wire_bytes`) and is
    ranked by

    * ``"dcn_bytes"`` (default): cross-slice bytes per chip per step,
      ICI bytes as tie-break — the paper's objective, gossip being the
      only DCN-crossing axis;
    * ``"step_time"``: analytic pseudo-seconds over both byte classes
      (:func:`cost_model.predicted_carving_step_time_s`).

    For MoE configs the **dispatch scheme is a second scored axis**: every
    surviving carving is lowered under both the padded capacity path and
    the dropless grouped path (audit keys gain ``|disp=dropless``; the
    winner's ``best.config`` carries a ``dispatch`` field), so the plan
    learns when dropless's worst-case wire blocks beat capacity padding.
    Model-contract violations (``cfg.validate``) and failed steps move
    candidates into the rejection audit rather than raising, so the
    returned plan accounts for every enumerated carving.  Pass
    ``carvings=[(dp, pp, tp, sp, ep), ...]`` to restrict the space (tests
    and the smoke target do), or the ``max_*`` bounds to prune it.

    Returns a deterministic JSON-ready dict (schema
    ``bluefog-carving-plan-1``) whose ``best.config`` feeds
    ``compose_parallelism`` directly.
    """
    ctx = _mesh.get_context()
    n = ctx.size
    num_experts = getattr(cfg, "num_experts", None)
    if objective not in ("dcn_bytes", "step_time"):
        raise ValueError(f"unknown objective {objective!r}: "
                         "'dcn_bytes' or 'step_time'")

    if carvings is not None:
        accepted, rejected = [], []
        for axes in carvings:
            cand = CarvingCandidate(*(int(v) for v in axes))
            reason = carving_violation(cand, n, num_experts,
                                       require_gossip=require_gossip)
            if reason is None:
                accepted.append(cand)
            else:
                rejected.append({"key": cand.key, "config": cand.config(),
                                 "reason": reason})
    else:
        accepted, rejected = enumerate_carvings(
            n, num_experts=num_experts, require_gossip=require_gossip,
            max_pp=max_pp, max_tp=max_tp, max_sp=max_sp, max_ep=max_ep)
    # MoE configs are scored along a second axis: every carving under BOTH
    # dispatch schemes (padded capacity vs sort-based dropless), so the
    # plan learns when the grouped path's worst-case buffers beat the
    # capacity padding.  Dense configs keep the single (mode=None) pass.
    if num_experts is not None and hasattr(cfg, "dispatch"):
        modes = ("capacity", "dropless")
    else:
        modes = (None,)
    considered = len(accepted) * len(modes) + len(rejected)

    def mode_cfg(mode):
        if mode is None:
            return cfg
        if mode == "capacity":
            # expert-choice routing has no capacity variant: the twin is
            # always the padded top-k scheme
            return dataclasses.replace(cfg, dispatch="capacity",
                                       router_mode="topk")
        return dataclasses.replace(cfg, dispatch=mode)

    def mode_key(cand, mode):
        return cand.key if mode in (None, "capacity") \
            else f"{cand.key}|disp={mode}"

    scored = []
    for cand in accepted:
        for mode in modes:
            key = mode_key(cand, mode)
            mcfg = mode_cfg(mode)
            config = cand.config() if mode is None \
                else {**cand.config(), "dispatch": mode}
            try:
                stats = _cm.carving_wire_bytes(cand, mcfg, wire=wire,
                                               remat=remat)
            except ValueError as e:           # model/carving contract
                rejected.append({"key": key, "config": config,
                                 "reason": f"contract: {e}"[:300]})
                continue
            except Exception as e:            # noqa: BLE001 — the step
                rejected.append({"key": key, "config": config,
                                 "reason": f"step failed: "
                                           f"{type(e).__name__}: {e}"[:300]})
                continue
            step_s = _cm.predicted_carving_step_time_s(stats)
            scored.append({"cand": cand, "key": key, "config": config,
                           "dispatch": mode,
                           "dcn_bytes": int(stats["dcn_bytes"]),
                           "ici_bytes": int(stats["ici_bytes"]),
                           "dcn_dtypes": stats["dcn_dtypes"],
                           "step_time_s": step_s})
    if not scored:
        raise RuntimeError(
            "tune_carving: every carving was rejected or its step "
            f"failed ({len(rejected)} rejections; see the reasons)")

    def sort_key(e):
        if objective == "dcn_bytes":
            return (e["dcn_bytes"], e["ici_bytes"], e["key"])
        return (e["step_time_s"], e["key"])

    scored.sort(key=sort_key)
    best = scored[0]
    return {
        "schema": CARVING_PLAN_SCHEMA,
        "objective": objective,
        "n_chips": n,
        "device_kind": _trials.device_kind(ctx.device),
        "wire": wire,
        "model": {"n_params": cfg.n_params,
                  "num_experts": num_experts,
                  "capacity_factor": getattr(cfg, "capacity_factor", None),
                  "top_k": getattr(cfg, "top_k", None),
                  "router_mode": getattr(cfg, "router_mode", None)},
        "best": {
            "config": best["config"],
            "dcn_bytes_per_step_per_chip": best["dcn_bytes"],
            "ici_bytes_per_step_per_chip": best["ici_bytes"],
            "dcn_dtypes": best["dcn_dtypes"],
            "step_time_s": round(best["step_time_s"], 9),
        },
        "audit": {
            "considered": considered,
            "scored": [
                {"key": e["key"],
                 **({"dispatch": e["dispatch"]}
                    if e["dispatch"] is not None else {}),
                 "dcn_bytes": e["dcn_bytes"],
                 "ici_bytes": e["ici_bytes"],
                 "step_time_s": round(e["step_time_s"], 9)}
                for e in scored],
            "rejected": [{"key": r["key"], "reason": r["reason"]}
                         for r in rejected],
        },
    }
