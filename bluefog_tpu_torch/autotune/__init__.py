"""Strategy autotuning (counterpart of ``bluefog_tpu/autotune``):
``bluefog_tpu_torch.autotune()``.

Searches {algorithm x topology x wire codec x fused-k x delayed overlap x
concurrent emission}, ranks candidates with three evidence tiers (wire
bytes counted by the port's ledger over one run of each group's update +
spectral gap; banked ``docs/measured/`` artifacts of the same device
kind; optional live trials), and returns a deterministic
JSON-serializable :class:`Plan` (schema ``bluefog-autotune-plan-1``, the
JAX package's ``plan_id``) that reconstructs the configured optimizer and
context knobs anywhere — see :func:`autotune`.

:func:`tune_carving` extends the search to the carving itself: it
enumerates ``(dp, pp, tp, sp, ep)`` carvings — the expert axis included,
with the MoE contract rules surfaced as audited rejections — and ranks
them by the cross-replica (DCN) bytes per chip of one real step
(schema ``bluefog-carving-plan-1``).

CLI: ``python -m bluefog_tpu_torch.autotune --device cpu --smoke``.
"""
from .candidates import (
    Candidate, CarvingCandidate, carving_violation, default_topologies,
    enumerate_candidates, enumerate_carvings, schedule_for,
    two_level_split,
)
from .plan import PLAN_SCHEMA, Plan, load_plan, plan_id_of
from .tuner import CARVING_PLAN_SCHEMA, autotune, tune_carving

__all__ = [
    "autotune", "Plan", "load_plan", "plan_id_of", "PLAN_SCHEMA",
    "Candidate", "enumerate_candidates", "default_topologies",
    "schedule_for", "two_level_split",
    "CarvingCandidate", "carving_violation", "enumerate_carvings",
    "tune_carving", "CARVING_PLAN_SCHEMA",
]
