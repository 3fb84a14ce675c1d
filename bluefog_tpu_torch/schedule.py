"""Topology -> gossip-round schedule compiler (counterpart of
``bluefog_tpu/schedule.py``; pure numpy).

A copy of the JAX package's compiler, so the port's tables are the JAX
tables bit for bit.  A virtual topology compiles, once, into a static
list of permutation rounds (each round a partial permutation: distinct
senders, distinct receivers) plus dense ``[rounds, size]`` weight tables
(receive weight, sender id, receive slot, send scale).  The stacked
backend (:mod:`bluefog_tpu_torch.ops.collectives`) applies round ``r`` as
a gather along the rank axis by ``recv_src[r]``.

Circulant graphs (the ring / exponential families) decompose into one
full permutation per nonzero offset; the greedy colourer handles
arbitrary digraphs with at most ``2*max_degree-1`` rounds.  Dynamic
topologies compile to a *list* of schedules
(:func:`compile_dynamic_schedules`).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import networkx as nx

from . import topology as topo_util

Edge = Tuple[int, int]


# ---------------------------------------------------------------------------
# Edge -> round partitioning
# ---------------------------------------------------------------------------

def color_edges(edges: Sequence[Edge], size: int) -> List[List[Edge]]:
    """Partition directed edges into partial permutations (gossip rounds).

    Greedy interval coloring: each edge gets the smallest round index where
    its source is not yet sending and its destination not yet receiving.
    Edges are processed grouped by circulant offset ``(dst - src) mod size``
    so that complete offset groups (full permutations) land in one round each.
    """
    for src, dst in edges:
        if src == dst:
            raise ValueError("self-loops must be handled via self_weight")
        if not (0 <= src < size and 0 <= dst < size):
            raise ValueError(f"edge ({src}, {dst}) out of range for size {size}")

    ordered = sorted(set(edges), key=lambda e: ((e[1] - e[0]) % size, e[0]))
    rounds: List[List[Edge]] = []
    senders: List[set] = []
    receivers: List[set] = []
    for src, dst in ordered:
        for r in range(len(rounds)):
            if src not in senders[r] and dst not in receivers[r]:
                rounds[r].append((src, dst))
                senders[r].add(src)
                receivers[r].add(dst)
                break
        else:
            rounds.append([(src, dst)])
            senders.append({src})
            receivers.append({dst})
    return rounds


def rounds_edge_disjoint(sched: "CommSchedule") -> bool:
    """True iff the schedule's rounds partition the edge set cleanly.

    Each round must be a partial permutation (no source sends twice, no
    destination receives twice — one permutation's contract) and no
    directed edge may appear in more than one round.  This is the invariant
    that makes round-parallel emission
    (``neighbor_allreduce(concurrent=True)``) semantically identical to the
    sequential chain: every round reads the SAME input, so rounds commute.
    :func:`color_edges` guarantees it by construction; this check exists for
    hand-built schedules and as the tested witness of that guarantee.
    """
    seen = set()
    for round_ in sched.rounds:
        srcs = [s for s, _ in round_]
        dsts = [d for _, d in round_]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            return False
        for e in round_:
            if e in seen:
                return False
            seen.add(e)
    return True


def columns_stochastic(sched: "CommSchedule", atol: float = 1e-6) -> bool:
    """True iff every rank's received mass (self + in-edges) sums to 1.

    Column-stochasticity of the effective mixing matrix is what makes
    neighbor averaging a *consensus* operator (the all-equal state is a fixed
    point and the global mean is preserved for doubly-stochastic weights).
    The compilers preserve it from the topology by construction — including
    the composed two-level family (``topology.TwoLevelGraph``), where the
    Kronecker product of column-stochastic levels is column-stochastic —
    and healing folds dead-rank mass into self-loops to keep it; this check
    is the tested witness of that guarantee, the column counterpart of
    :func:`rounds_edge_disjoint`.
    """
    mass = sched.self_weight.astype(np.float64).copy()
    for r in range(sched.num_rounds):
        w = sched.recv_weight[r].astype(np.float64)
        if sched.uses_dst_weighting:
            # the sender scales before the permute: the mass that actually
            # arrives is recv_weight * send_scale[sender]
            src = sched.recv_src[r]
            w = w * np.where(
                src >= 0,
                sched.send_scale[r][np.clip(src, 0, None)].astype(np.float64),
                0.0)
        mass += w
    return bool(np.allclose(mass, 1.0, atol=atol, rtol=0.0))


# ---------------------------------------------------------------------------
# Compiled schedule
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CommSchedule:
    """A topology compiled to permutation rounds + per-rank weight tables.

    Tables are indexed ``[round, rank]``.  A rank that receives nothing in
    a round gets a zero-filled value and a ``recv_weight`` entry of 0, so
    no masking is needed.
    """
    size: int
    # tuple of rounds; each round is a tuple of (src, dst) pairs
    rounds: Tuple[Tuple[Edge, ...], ...]
    # weight applied by the receiver to the value received in round r
    recv_weight: np.ndarray          # [R, size] float
    # rank that sent to this device in round r (-1 = nothing received)
    recv_src: np.ndarray             # [R, size] int32
    # position of round-r received tensor among this device's sorted in-neighbors
    recv_slot: np.ndarray            # [R, size] int32
    # scale the SENDER applies before sending in round r (dst-weighting)
    send_scale: np.ndarray           # [R, size] float
    # weight per in-neighbor slot (sorted-src order; 0 beyond in_degree) —
    # used by window updates, where received values live in slot buffers
    slot_weight: np.ndarray          # [max_in_degree, size] float
    # per-device self weight
    self_weight: np.ndarray          # [size] float
    in_degree: np.ndarray            # [size] int32
    out_degree: np.ndarray           # [size] int32
    # sorted in-neighbors per device: the canonical mailbox-slot layout
    # (slot k of device d belongs to in_neighbors[d][k])
    in_neighbors: Tuple[Tuple[int, ...], ...] = ()
    uses_dst_weighting: bool = False
    key: str = field(default="")     # content hash for jit-cache identity

    def __post_init__(self):
        if not self.key:
            h = hashlib.sha1()
            h.update(repr(self.rounds).encode())
            for arr in (self.recv_weight, self.recv_src, self.recv_slot,
                        self.send_scale, self.slot_weight, self.self_weight):
                h.update(np.ascontiguousarray(arr).tobytes())
            object.__setattr__(self, "key", h.hexdigest())

    def __hash__(self):
        return hash((self.size, self.key))

    def __eq__(self, other):
        return isinstance(other, CommSchedule) and self.key == other.key

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    @property
    def max_in_degree(self) -> int:
        return int(self.in_degree.max(initial=0))


def _build_tables(
    size: int,
    edge_weights: Dict[Edge, float],
    self_weight: np.ndarray,
    send_scales: Optional[Dict[Edge, float]] = None,
) -> CommSchedule:
    """Compile an explicit weighted edge set into a :class:`CommSchedule`."""
    edges = list(edge_weights.keys())
    rounds = color_edges(edges, size) if edges else []
    R = len(rounds)

    recv_weight = np.zeros((R, size), dtype=np.float32)
    recv_src = np.full((R, size), -1, dtype=np.int32)
    recv_slot = np.zeros((R, size), dtype=np.int32)
    send_scale = np.ones((R, size), dtype=np.float32)
    in_degree = np.zeros(size, dtype=np.int32)
    out_degree = np.zeros(size, dtype=np.int32)

    in_neighbors: List[List[int]] = [[] for _ in range(size)]
    for src, dst in edges:
        in_neighbors[dst].append(src)
        in_degree[dst] += 1
        out_degree[src] += 1
    slot_of = [
        {src: i for i, src in enumerate(sorted(srcs))} for srcs in in_neighbors
    ]

    for r, round_edges in enumerate(rounds):
        for src, dst in round_edges:
            recv_weight[r, dst] = edge_weights[(src, dst)]
            recv_src[r, dst] = src
            recv_slot[r, dst] = slot_of[dst][src]
            if send_scales is not None:
                send_scale[r, src] = send_scales.get((src, dst), 1.0)

    max_in = max(int(in_degree.max(initial=0)), 1)
    slot_weight = np.zeros((max_in, size), dtype=np.float32)
    for dst in range(size):
        for src, slot in slot_of[dst].items():
            slot_weight[slot, dst] = edge_weights[(src, dst)]

    return CommSchedule(
        size=size,
        rounds=tuple(tuple(re) for re in rounds),
        recv_weight=recv_weight,
        recv_src=recv_src,
        recv_slot=recv_slot,
        send_scale=send_scale,
        slot_weight=slot_weight,
        self_weight=np.asarray(self_weight, dtype=np.float32),
        in_degree=in_degree,
        out_degree=out_degree,
        in_neighbors=tuple(tuple(sorted(srcs)) for srcs in in_neighbors),
        uses_dst_weighting=send_scales is not None,
    )


def compile_topology(
    topo: nx.DiGraph,
    weighted: bool = True,
) -> CommSchedule:
    """Compile a static topology graph into a neighbor-allreduce schedule.

    ``weighted=True`` uses the graph's mixing weights (the generators in
    :mod:`bluefog_tpu.topology` all produce doubly-stochastic weights);
    ``weighted=False`` reproduces the reference's unweighted default of
    uniform ``1 / (in_degree + 1)`` averaging (``mpi_ops.py:505-511``).
    """
    size = topo.number_of_nodes()
    W = topo_util.to_weight_matrix(topo)

    self_weight = np.zeros(size, dtype=np.float32)
    edge_weights: Dict[Edge, float] = {}
    if weighted:
        # read weights off the dense matrix computed once above —
        # GetRecvWeights rebuilds W per call, which turns pod-scale compiles
        # (4096 ranks) into an O(n^3) stall
        for dst in range(size):
            for src in topo.predecessors(dst):
                if src == dst:
                    self_weight[dst] = float(W[dst, dst])
                else:
                    edge_weights[(src, dst)] = float(W[src, dst])
    else:
        for dst in range(size):
            # graph in-neighbors, not nonzero weights: an explicit zero-weight
            # edge still counts as a neighbor for the uniform default
            srcs = [s for s in topo.predecessors(dst) if s != dst]
            uniform = 1.0 / (len(srcs) + 1)
            self_weight[dst] = uniform
            for src in srcs:
                edge_weights[(src, dst)] = uniform
    return _build_tables(size, edge_weights, self_weight)


def compile_from_weights(
    size: int,
    self_weights: Sequence[float],
    src_weights_per_rank: Sequence[Dict[int, float]],
    dst_weights_per_rank: Optional[Sequence[Dict[int, float]]] = None,
) -> CommSchedule:
    """Compile explicit per-rank weights (the dynamic-topology API path).

    Mirrors the reference weight policy (``mpi_ops.py:482-535``): each rank
    declares its self weight, the weights it applies to values *received* from
    each source, and optionally per-destination *send* scales (dst-weighting,
    used by push-sum style algorithms where outgoing mass is split).
    """
    self_weight = np.asarray(list(self_weights), dtype=np.float32)
    if self_weight.shape != (size,):
        raise ValueError(f"need one self weight per rank (got {self_weight.shape})")

    edge_weights: Dict[Edge, float] = {}
    for dst, srcs in enumerate(src_weights_per_rank):
        for src, w in srcs.items():
            if src == dst:
                raise ValueError("self weight must go in self_weights")
            edge_weights[(src, dst)] = float(w)

    send_scales: Optional[Dict[Edge, float]] = None
    if dst_weights_per_rank is not None:
        send_scales = {}
        declared: set = set()
        for src, dsts in enumerate(dst_weights_per_rank):
            for dst, scale in dsts.items():
                declared.add((src, dst))
                send_scales[(src, dst)] = float(scale)
        if declared != set(edge_weights.keys()):
            raise ValueError(
                "dst_weights and src_weights describe different edge sets; "
                "send/recv neighbors must match (cf. reference "
                "CheckNeighborSendRecvPattern, mpi_controller.cc:364)")
        if all(np.isclose(v, 1.0) for v in send_scales.values()):
            send_scales = None
    return _build_tables(size, edge_weights, self_weight, send_scales)


# ---------------------------------------------------------------------------
# Dynamic topologies
# ---------------------------------------------------------------------------

def dynamic_schedule_period(generator_factory, size: int, probe: int = 256) -> int:
    """Detect the period of a per-rank dynamic generator family.

    ``generator_factory(rank)`` must return the reference-style iterator
    yielding ``([send_ranks], [recv_ranks])``.  All shipped generators are
    periodic with a small period (lcm of per-rank degrees / log2 terms).

    Each step's *global* edge set is signatured once (a tuple over all
    ranks' yields) and the period is detected on the signature sequence:
    O(size * probe) generator pulls plus O(probe^2) integer-hash compares,
    instead of the naive per-candidate-period rescan of every rank's raw
    tuples — O(size * probe^2) elementwise comparisons, a multi-second
    init stall at pod sizes (4096 ranks x probe 256).  The winning
    candidate is confirmed against the raw signatures, so a hash collision
    can never shorten the detected period.
    """
    step_sig: List[Tuple] = []
    gens = [generator_factory(rank) for rank in range(size)]
    for _ in range(probe):
        step_sig.append(tuple(
            (tuple(send), tuple(recv))
            for send, recv in (next(gen) for gen in gens)))
    step_hash = [hash(sig) for sig in step_sig]
    for period in range(1, probe // 2 + 1):
        if all(step_hash[t] == step_hash[t % period] for t in range(probe)):
            # hashes matched — confirm on the raw signatures once
            if all(step_sig[t] == step_sig[t % period] for t in range(probe)):
                return period
    raise ValueError(f"no period <= {probe // 2} detected; pass schedules explicitly")


def compile_dynamic_schedules(
    generator_factory,
    size: int,
    num_steps: Optional[int] = None,
    uniform: bool = True,
) -> List[CommSchedule]:
    """Batch per-rank one-peer generators into per-step compiled schedules.

    Where the reference hands each MPI process its own ``(send, recv)`` lists
    per iteration (``topology_util.py:315-554``), the SPMD program needs the
    *global* exchange per step.  We pull one tuple from every rank's generator
    per step and compile the resulting edge set; with one outgoing peer per
    rank each step is already a permutation -> exactly one round per step.

    Weights follow the reference's dynamic default: uniform
    ``1 / (num_recv + 1)`` over received values plus self.
    """
    if num_steps is None:
        num_steps = dynamic_schedule_period(generator_factory, size)
    gens = [generator_factory(rank) for rank in range(size)]
    schedules = []
    for _ in range(num_steps):
        edge_weights: Dict[Edge, float] = {}
        recv_count = np.zeros(size, dtype=np.int64)
        for rank, gen in enumerate(gens):
            send_ranks, _recv_ranks = next(gen)
            for dst in send_ranks:
                edge_weights[(rank, dst)] = 1.0
                recv_count[dst] += 1
        self_weight = 1.0 / (recv_count + 1.0)
        if uniform:
            for (src, dst) in edge_weights:
                edge_weights[(src, dst)] = float(self_weight[dst])
        schedules.append(_build_tables(size, edge_weights, self_weight))
    return schedules


def ring_schedule(size: int, shift: int = 1) -> Tuple[Edge, ...]:
    """The full-permutation ring ``i -> (i + shift) % size``.

    Exposed as a reusable primitive: this is the same rotation ring
    attention uses (see :mod:`bluefog_tpu_torch.ops.ring`).
    """
    return tuple((i, (i + shift) % size) for i in range(size))
