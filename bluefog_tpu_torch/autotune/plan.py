"""The Plan: a deterministic, JSON-serializable tuning decision.

A plan is pure data — the chosen knob dict, the evidence that ranked it
(predicted bytes, consensus gap, score, evidence tier), and the audit
trail of everything considered or rejected — plus constructors that turn
it back into a configured :class:`~bluefog_tpu_torch.optimizers
.DecentralizedOptimizer` and context state.  ``plan_id`` is a content
hash of the chosen configuration, so two identical decisions are
identical artifacts and ``tools/bench.py --plan`` replay is exact.  The
schema and the hash are the JAX package's (``bluefog_tpu/autotune/
plan.py``), so the same chosen config has the same ``plan_id`` in both.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Optional

PLAN_SCHEMA = "bluefog-autotune-plan-1"


def _canonical(doc: Any) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def plan_id_of(config: dict) -> str:
    """Content hash of a chosen config (the plan's identity)."""
    return hashlib.sha256(_canonical(config).encode()).hexdigest()[:12]


class Plan:
    """Wrapper over the plan document (``.doc`` is plain JSON data)."""

    def __init__(self, doc: dict):
        if doc.get("schema") != PLAN_SCHEMA:
            raise ValueError(
                f"not an autotune plan (schema={doc.get('schema')!r}, "
                f"expected {PLAN_SCHEMA!r})")
        self.doc = doc

    # -- identity / persistence --------------------------------------------
    @property
    def plan_id(self) -> str:
        return self.doc["plan_id"]

    @property
    def config(self) -> dict:
        return self.doc["config"]

    @property
    def algorithm(self) -> str:
        return self.config["algorithm"]

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.doc, sort_keys=True, indent=indent)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "Plan":
        with open(path) as f:
            return cls(json.load(f))

    # -- reconstruction -----------------------------------------------------
    def build_schedule(self):
        """The compiled :class:`~bluefog_tpu_torch.schedule.CommSchedule` the
        chosen candidate gossips over (None for schedule-free algorithms)."""
        from .candidates import schedule_for
        cfg = self.config
        return schedule_for(cfg["topology"], cfg["weights"],
                            int(self.doc["n_chips"]))

    def build_strategy(self, opt):
        """Construct the configured optimizer strategy around ``opt`` (an
        optimizer factory such as :func:`bluefog_tpu_torch.optimizers.sgd`
        or :func:`~bluefog_tpu_torch.optimizers.adam`)."""
        from ..optimizers import STRATEGIES
        cfg = self.config
        return STRATEGIES[cfg["algorithm"]].build(
            opt, schedule=self.build_schedule(), wire=cfg["wire"],
            concurrent=cfg["concurrent"], delayed=cfg["delayed"],
            num_steps_per_communication=1)

    def train_step_kwargs(self) -> dict:
        """Keyword arguments for :func:`~bluefog_tpu_torch.optimizers
        .make_train_step` matching the plan's fused-k / overlap choices."""
        cfg = self.config
        k = int(cfg["fused_k"])
        return {"steps_per_call": k, "reuse_batch": k > 1,
                "overlap": bool(cfg["delayed"])}

    def apply(self) -> "Plan":
        """Apply the plan's context knobs (topology, round-parallel
        default) to the live process.  Returns self for chaining."""
        from ..parallel import context as _mesh
        _mesh.apply_plan(self)
        return self


def make_plan_doc(
    *,
    config: dict,
    objective,
    n_chips: int,
    device_kind: str,
    predicted: dict,
    audit: dict,
) -> dict:
    """Assemble the plan document (deterministic field set, no clocks)."""
    return {
        "schema": PLAN_SCHEMA,
        "plan_id": plan_id_of(config),
        "config": config,
        "objective": objective,
        "n_chips": int(n_chips),
        "device_kind": device_kind,
        "predicted": predicted,
        "audit": audit,
    }


def load_plan(path: str) -> Plan:
    """Load a plan JSON from ``path`` (counterpart of ``Plan.save``)."""
    return Plan.load(path)
