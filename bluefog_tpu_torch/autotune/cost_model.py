"""Tier-1 evidence: wire bytes counted from one real run + spectral-gap
consensus (counterpart of ``bluefog_tpu/autotune/cost_model.py``).

The JAX cost model lowers each compile group's strategy update and counts
the bytes of the compiled XLA program.  The port compiles no program, so
it *runs* the update once, on the context's device, with the wire-byte
ledger armed (:mod:`bluefog_tpu_torch.utils.wire_bytes`): the bytes are
what the port's own collectives moved, never a guess from shapes.  Each
compile group (one per ``(algorithm, topology, wire, weights)``, the
knobs that change what crosses the wire) is probed once a context.
Scoring is pure arithmetic on those bytes: no wall clock, no RNG, so the
same inputs always produce the same plan (pinned by tests).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import topology as topo_util
from ..parallel import context as _mesh
from ..utils import wire_bytes as _wb
from .candidates import Candidate, CarvingCandidate, schedule_for

# Pseudo-cost constants (seconds).  These are NOT measurements of any
# link or chip: they are a fixed preference order, kept equal to the JAX
# reference's constants so that both packages rank candidates alike.
# Bytes dominate, DCN bytes (between replica blocks) weigh 16x ICI bytes,
# each sequential gossip round adds latency, each host dispatch adds
# overhead amortized by fused-k.  Tier-2/3 measured seconds override the
# pseudo-seconds wholesale.
_BYTES_PER_SEC = 4.0e10          # intra-block bytes
_DCN_BYTES_PER_SEC = 2.5e9       # bytes between replica blocks
_ROUND_LATENCY_S = 2.0e-6        # per sequential permute round
_DISPATCH_S = 50.0e-6            # per host call, / fused_k
_EXPOSED_WHEN_DELAYED = 0.25     # fraction of comm left exposed when the
                                 # one-step-delayed pipeline hides the rest


def _params_struct_key(params) -> tuple:
    from ..fusion import tree_flatten
    return tuple((tuple(x.shape), str(x.dtype))
                 for x in tree_flatten(params)[0])


def build_probe_strategy(cand: Candidate, n: int, opt_factory):
    """The candidate's strategy as its compile group probes it: at
    ``fused_k=1`` / ``delayed=False`` / default emission (the group's
    members only rescale or rearrange that update, never change its
    payloads), the schedule passed explicitly so probing never changes
    the process context."""
    from ..optimizers import STRATEGIES
    sched = schedule_for(cand.topology, cand.weights, n)
    return STRATEGIES[cand.algorithm].build(
        opt_factory(), schedule=sched, wire=cand.wire, concurrent=None,
        delayed=False, num_steps_per_communication=1)


def probe_inputs(strategy, params, n: int):
    """``(dist_params, dist_state, zero grads)`` of a probe on the
    context's device: ``replicate(params, n)`` and ``init_distributed``."""
    from ..fusion import tree_map
    from ..optimizers import init_distributed, replicate
    dev = _mesh.get_context().device
    dist_params = replicate(tree_map(lambda x: x.to(dev), params), n)
    dist_state = init_distributed(strategy, dist_params)
    return dist_params, dist_state, tree_map(torch.zeros_like, dist_params)


def probe_update(strategy, params, n: int):
    """Run the strategy's update (zero grads) once over ``replicate(params,
    n)`` with the ledger armed; returns the :class:`~bluefog_tpu_torch.
    utils.wire_bytes.Ledger` (the counterpart of ``probe_compiled`` and
    the byte count of its program)."""
    p, s, g = probe_inputs(strategy, params, n)
    with torch.no_grad(), _wb.ledger() as led:
        strategy.update(g, s, p)
    return led


def group_wire_bytes(cand: Candidate, params, n: int,
                     opt_factory) -> Tuple[Dict[str, int], int]:
    """``(collective counts, per-step wire bytes per chip)`` for the
    candidate's compile group, from one run of its update on the
    context's device, kept in the context (a group is probed once a
    context, as JAX lowers it once).  Raises whatever the update raises;
    the tuner converts that into a rejection with reason."""
    cache = _mesh.get_context().autotune_probes
    key = ("autotune-probe", cand.compile_group, n,
           _params_struct_key(params))
    if key not in cache:
        led = probe_update(build_probe_strategy(cand, n, opt_factory),
                           params, n)
        counts, bytes_ = led.wire_stats()
        cache[key] = (counts, int(sum(bytes_.values())))
    counts, total = cache[key]
    return dict(counts), total


def consensus_gap(cand: Candidate) -> float:
    """Consensus contraction rate of the candidate's mixing step.

    ``allreduce`` averages exactly (gap 1.0); gossip candidates take
    :func:`bluefog_tpu_torch.topology.spectral_gap` of the topology's
    built-in (doubly-stochastic) weights — the graph governs the
    consensus rate for the push family too, since their de-biased iterate
    contracts on the same graph.
    """
    if cand.topology is None:
        return 1.0
    return topo_util.spectral_gap(
        topo_util.topology_from_spec(cand.topology))


def predicted_step_time_s(cand: Candidate, bytes_per_step: int,
                          num_rounds: int) -> float:
    """Analytic pseudo-seconds per optimizer step (tier-1 fallback)."""
    comm = bytes_per_step / _BYTES_PER_SEC
    rounds = 1 if cand.concurrent else max(num_rounds, 1)
    lat = rounds * _ROUND_LATENCY_S if bytes_per_step else 0.0
    if cand.delayed:
        comm, lat = (comm * _EXPOSED_WHEN_DELAYED,
                     lat * _EXPOSED_WHEN_DELAYED)
    return comm + lat + _DISPATCH_S / max(cand.fused_k, 1)


def objective_score(objective, step_time_s: float, gap: float,
                    bytes_per_step: int) -> float:
    """Lower-is-better score under the requested objective.

    ``"step_time"`` ranks by (predicted or measured) seconds;
    ``"consensus_per_byte"`` ranks by wire bytes paid per unit of
    consensus contraction (allreduce pays full payload for gap 1.0, a
    sparse gossip graph pays less for a smaller gap); a dict blends the
    two with the given weights, each term in its own units (a preference
    order, not a physical sum).
    """
    per_byte = (bytes_per_step + 1.0) / max(gap, 1e-9)
    if objective == "step_time":
        return step_time_s
    if objective == "consensus_per_byte":
        return per_byte
    if isinstance(objective, dict):
        unknown = set(objective) - {"step_time", "consensus_per_byte"}
        if unknown:
            raise ValueError(f"unknown objective terms {sorted(unknown)}")
        return (float(objective.get("step_time", 0.0)) * step_time_s
                + float(objective.get("consensus_per_byte", 0.0))
                * per_byte)
    raise ValueError(
        f"unknown objective {objective!r}: 'step_time', "
        "'consensus_per_byte', or a weight dict over those")


def carving_wire_bytes(carve: CarvingCandidate, cfg, *,
                       wire: Optional[str] = None,
                       remat: bool = False) -> dict:
    """ICI-vs-DCN byte attribution for one 5-axis carving, from one real
    optimizer step run with the ledger armed (never a shape guess).

    Composes the carving on the context's device, builds the LM step —
    the routed-MoE one when ``cfg`` is a :class:`~bluefog_tpu_torch.moe.
    model.MoELMConfig`, the dense one otherwise — with ``sgd(0.05)`` under
    ``delayed=True`` adapt-with-combine, initializes params and a batch,
    and runs one step.  The ledger counts every call the step makes, so
    the ICI bytes include the pipeline ticks' and layers' trips, which the
    JAX counter (static StableHLO occurrences) counts once; the DCN bytes
    (the gossip, once a step) are the JAX counter's.  The model contract
    (``cfg.validate``) and the carving contract both raise here; the
    carving tuner converts that into an audited rejection.  The process
    context's active carving is restored on exit."""
    from .. import optimizers as bfopt
    from ..parallel import compose

    carve_kw = {}
    num_experts = getattr(cfg, "num_experts", None)
    is_moe = num_experts is not None
    if is_moe:
        carve_kw = {"num_experts": num_experts,
                    "capacity_factor": cfg.capacity_factor}
    prior = _mesh.get_compose()
    try:
        m = compose.compose_parallelism(
            carve.dp, carve.pp, carve.tp, carve.sp, carve.ep, wire=wire,
            device=_mesh.get_context().device, **carve_kw)
        cfg.validate(m)
        if is_moe:
            from ..moe import model as moe_model
            grad_fn = moe_model.make_moe_grad_fn(cfg, m, remat=remat)
            params = moe_model.init_moe_train_params(cfg, m)
            toks = moe_model.make_moe_batch(cfg, m)
        else:
            grad_fn = compose.make_lm_grad_fn(cfg, m, remat=remat)
            params = compose.init_lm_train_params(cfg, m)
            toks = compose.make_lm_batch(cfg, m)
        step, strategy = compose.make_train_step(
            m, grad_fn, bfopt.sgd(0.05), delayed=True)
        state = bfopt.init_distributed(strategy, params)
        with _wb.ledger(m.slice_size) as led:
            step(params, state, toks)
        stats = led.stablehlo_wire_stats()
        stats["slice_size"] = m.slice_size
        return stats
    finally:
        _mesh.set_compose(prior)


def predicted_carving_step_time_s(stats: dict) -> float:
    """Analytic pseudo-seconds for a carving's per-step wire bill: DCN
    bytes over the DCN constant + ICI bytes over the ICI constant.  Same
    caveat as the strategy constants above — a preference order (DCN
    bytes dominate), not a measurement."""
    return (stats["dcn_bytes"] / _DCN_BYTES_PER_SEC
            + stats["ici_bytes"] / _BYTES_PER_SEC)


def num_schedule_rounds(cand: Candidate, n: int) -> int:
    """Sequential permute rounds the candidate's schedule executes."""
    if cand.topology is None or cand.weights is None:
        return 0
    sched = schedule_for(cand.topology, cand.weights, n)
    return int(np.asarray(len(sched.rounds)))
