"""Virtual-topology generators and utilities (counterpart of
``bluefog_tpu/topology.py``; pure numpy/networkx, device-free).

A copy of the JAX package's module, kept separate so the port imports
nothing of it.  Topologies are ``networkx.DiGraph`` objects whose edge
attribute ``weight`` holds the mixing weight of each directed edge
``src -> dst`` (row index = sender), exactly as in the reference Bluefog
topology layer; :mod:`bluefog_tpu_torch.schedule` compiles them into the
per-round weight tables the stacked gossip backend applies.

* static generators: :func:`ExponentialTwoGraph`, :func:`ExponentialGraph`,
  :func:`SymmetricExponentialGraph`, :func:`MeshGrid2DGraph`,
  :func:`StarGraph`, :func:`RingGraph`, :func:`FullyConnectedGraph`,
  :func:`TwoLevelGraph`
* predicates / accessors: :func:`IsTopologyEquivalent`, :func:`IsRegularGraph`,
  :func:`GetRecvWeights`, :func:`GetSendWeights`, :func:`to_weight_matrix`,
  :func:`spectral_gap`, :func:`compose_two_level`, :func:`topology_from_spec`
* dynamic one-peer schedule generators:
  :func:`GetDynamicOnePeerSendRecvRanks`,
  :func:`GetExp2DynamicSendRecvMachineRanks`,
  :func:`GetInnerOuterRingDynamicSendRecvRanks`,
  :func:`GetInnerOuterExpo2DynamicSendRecvRanks`
* adjacency inference: :func:`InferSourceFromDestinationRanks`,
  :func:`InferDestinationFromSourceRanks`.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import networkx as nx

__all__ = [
    "IsTopologyEquivalent",
    "IsRegularGraph",
    "GetRecvWeights",
    "GetSendWeights",
    "GetInNeighbors",
    "GetOutNeighbors",
    "ExponentialTwoGraph",
    "ExponentialGraph",
    "SymmetricExponentialGraph",
    "MeshGrid2DGraph",
    "StarGraph",
    "RingGraph",
    "FullyConnectedGraph",
    "TwoLevelGraph",
    "compose_two_level",
    "spectral_gap",
    "GetDynamicOnePeerSendRecvRanks",
    "GetExp2DynamicSendRecvMachineRanks",
    "GetInnerOuterRingDynamicSendRecvRanks",
    "GetInnerOuterExpo2DynamicSendRecvRanks",
    "InferSourceFromDestinationRanks",
    "InferDestinationFromSourceRanks",
    "to_weight_matrix",
    "topology_from_spec",
]


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _graph_from_matrix(weights: np.ndarray) -> nx.DiGraph:
    """Directed graph whose edge (i, j) carries mixing weight ``weights[i, j]``."""
    return nx.from_numpy_array(weights, create_using=nx.DiGraph)


def _circulant(size: int, row0: np.ndarray) -> nx.DiGraph:
    """Circulant mixing matrix: row ``i`` is ``row0`` rotated right by ``i``.

    ``row0[d]`` is the weight each node sends to the node ``d`` hops ahead
    (mod size).  All the reference's ring/exponential families are circulant,
    which is exactly the property that lets :mod:`bluefog_tpu_torch.schedule`
    lower each nonzero offset to ONE full-permutation round.
    """
    rows = [np.roll(row0, shift) for shift in range(size)]
    return _graph_from_matrix(np.stack(rows))


def to_weight_matrix(topo: nx.DiGraph) -> np.ndarray:
    """Dense ``[size, size]`` mixing matrix W with ``W[src, dst]``."""
    return nx.to_numpy_array(topo, nodelist=sorted(topo.nodes))


# ---------------------------------------------------------------------------
# Predicates and weight accessors  (reference: topology_util.py:23-63, 306-313)
# ---------------------------------------------------------------------------

def IsTopologyEquivalent(topo1: Optional[nx.DiGraph],
                         topo2: Optional[nx.DiGraph]) -> bool:
    """True iff the two digraphs have identical weighted adjacency matrices.

    This is an *adjacency* check, not an isomorphism check, matching the
    reference semantics (``topology_util.py:23-37``).
    """
    if topo1 is None or topo2 is None:
        return False
    if topo1.number_of_nodes() != topo2.number_of_nodes():
        return False
    if topo1.number_of_edges() != topo2.number_of_edges():
        return False
    return bool(np.array_equal(to_weight_matrix(topo1), to_weight_matrix(topo2)))


def IsRegularGraph(topo: nx.DiGraph) -> bool:
    """True iff every node has the same (total) degree (reference :306-313)."""
    degrees = {topo.degree(r) for r in range(topo.number_of_nodes())}
    return len(degrees) == 1


def GetRecvWeights(topo: nx.DiGraph, rank: int) -> Tuple[float, Dict[int, float]]:
    """``(self_weight, {in_neighbor: weight})`` for averaging received values."""
    W = to_weight_matrix(topo)
    self_weight = 0.0
    neighbor_weights: Dict[int, float] = {}
    for src in topo.predecessors(rank):
        if src == rank:
            self_weight = float(W[rank, rank])
        else:
            neighbor_weights[src] = float(W[src, rank])
    return self_weight, neighbor_weights


def GetSendWeights(topo: nx.DiGraph, rank: int) -> Tuple[float, Dict[int, float]]:
    """``(self_weight, {out_neighbor: weight})`` for outgoing edges."""
    W = to_weight_matrix(topo)
    self_weight = 0.0
    neighbor_weights: Dict[int, float] = {}
    for dst in topo.successors(rank):
        if dst == rank:
            self_weight = float(W[rank, rank])
        else:
            neighbor_weights[dst] = float(W[rank, dst])
    return self_weight, neighbor_weights


def GetInNeighbors(topo: nx.DiGraph, rank: int) -> List[int]:
    """Sorted in-neighbor ranks, excluding self."""
    return sorted(r for r in topo.predecessors(rank) if r != rank)


def GetOutNeighbors(topo: nx.DiGraph, rank: int) -> List[int]:
    """Sorted out-neighbor ranks, excluding self."""
    return sorted(r for r in topo.successors(rank) if r != rank)


# ---------------------------------------------------------------------------
# Static graph generators  (reference: topology_util.py:66-303)
# ---------------------------------------------------------------------------

def _powers_below(base: int, limit: int) -> List[int]:
    """All exact powers of ``base`` (including base**0 == 1) below ``limit``."""
    powers, p = [], 1
    while p < limit:
        powers.append(p)
        p *= base
    return powers


def ExponentialTwoGraph(size: int) -> nx.DiGraph:
    """Each node sends to nodes 2**k hops ahead (k = 0, 1, ...), uniform weights.

    Reference: ``topology_util.py:66-87``.  This is Bluefog's flagship static
    topology: log2(size) out-edges per node.
    """
    assert size > 0
    row0 = np.zeros(size)
    row0[0] = 1.0
    for offset in _powers_below(2, size):
        row0[offset] = 1.0
    row0 /= row0.sum()
    return _circulant(size, row0)


def ExponentialGraph(size: int, base: int = 2) -> nx.DiGraph:
    """Like :func:`ExponentialTwoGraph` with a configurable base (reference :99-125)."""
    assert size > 0
    row0 = np.zeros(size)
    row0[0] = 1.0
    for offset in _powers_below(base, size):
        row0[offset] = 1.0
    row0 /= row0.sum()
    return _circulant(size, row0)


def SymmetricExponentialGraph(size: int, base: int = 4) -> nx.DiGraph:
    """Exponential offsets mirrored around size//2 (reference :128-157)."""
    assert size > 0
    powers = set(_powers_below(base, size))
    row0 = np.zeros(size)
    row0[0] = 1.0
    for i in range(1, size):
        mirrored = i if i <= size // 2 else size - i
        if mirrored in powers:
            row0[i] = 1.0
    row0 /= row0.sum()
    return _circulant(size, row0)


def MeshGrid2DGraph(size: int, shape: Optional[Tuple[int, int]] = None) -> nx.DiGraph:
    """2-D grid with Metropolis–Hastings weights (reference :160-211).

    Node i <-> i+1 within a row, i <-> i+ncol across rows.  Weight on edge
    (i, j) is 1/max(|N(i)|, |N(j)|) counting self, with the self-loop weight
    absorbing the remainder so each row sums to 1 (doubly stochastic).
    """
    assert size > 0
    if shape is None:
        nrow = int(np.sqrt(size))
        while size % nrow != 0:
            nrow -= 1
        shape = (nrow, size // nrow)
    nrow, ncol = shape
    assert nrow * ncol == size, "shape does not match size"

    adj = np.eye(size, dtype=bool)
    for i in range(size):
        if (i + 1) % ncol != 0:           # right neighbor, same row
            adj[i, i + 1] = adj[i + 1, i] = True
        if i + ncol < size:               # neighbor one row down
            adj[i, i + ncol] = adj[i + ncol, i] = True

    nbr_count = adj.sum(axis=1)           # |N(i)| including self
    W = np.zeros((size, size))
    for i in range(size):
        for j in np.nonzero(adj[i])[0]:
            if i != j:
                W[i, j] = 1.0 / max(nbr_count[i], nbr_count[j])
        W[i, i] = 1.0 - W[i].sum()
    return _graph_from_matrix(W)


def StarGraph(size: int, center_rank: int = 0) -> nx.DiGraph:
    """Bidirectional star around ``center_rank`` (reference :214-237).

    Leaves keep self-weight 1 - 1/size and exchange 1/size with the center;
    the center row/column is uniformly 1/size.
    """
    assert size > 0
    W = np.zeros((size, size))
    np.fill_diagonal(W, 1.0 - 1.0 / size)
    W[center_rank, :] = 1.0 / size
    W[:, center_rank] = 1.0 / size
    return _graph_from_matrix(W)


def RingGraph(size: int, connect_style: int = 0) -> nx.DiGraph:
    """Ring topology (reference :240-281).

    ``connect_style``: 0 = bidirectional (weights 1/3 self/left/right),
    1 = left-connected only, 2 = right-connected only (weights 1/2).
    """
    assert size > 0
    if connect_style not in (0, 1, 2):
        raise ValueError("connect_style has to be an integer in {0, 1, 2}")
    if size == 1:
        return _graph_from_matrix(np.ones((1, 1)))
    if size == 2:
        return _graph_from_matrix(np.full((2, 2), 0.5))

    row0 = np.zeros(size)
    if connect_style == 0:
        row0[[0, 1, -1]] = 1.0 / 3
    elif connect_style == 1:
        row0[[0, -1]] = 0.5
    else:
        row0[[0, 1]] = 0.5
    return _circulant(size, row0)


def FullyConnectedGraph(size: int) -> nx.DiGraph:
    """Complete graph, uniform 1/size weights (reference :284-303)."""
    assert size > 0
    return _circulant(size, np.full(size, 1.0 / size))


# ---------------------------------------------------------------------------
# Two-level (hierarchical) topology family and spectral utilities
# ---------------------------------------------------------------------------

_INTER_FAMILY = {
    "exp2": ExponentialTwoGraph,
    "ring": RingGraph,
    "full": FullyConnectedGraph,
}

_INTRA_FAMILY = {
    "dense": lambda size: _graph_from_matrix(np.full((size, size), 1.0 / size)),
    "exp2": ExponentialTwoGraph,
    "ring": RingGraph,
}


def compose_two_level(machine_topo, local_topo) -> np.ndarray:
    """Effective mixing matrix of one hierarchical gossip step.

    ``hierarchical_neighbor_allreduce`` first mixes within each machine
    (``W_local`` over the ICI axis), then gossips the per-machine value across
    machines (``W_machine`` over the DCN axis) with the same local index on
    every machine exchanging in lockstep.  With rank ``= machine * L + local``
    the composition is exactly the Kronecker product::

        W_eff[(m, l0), (m', l)] = W_machine[m, m'] * W_local[l0, l]

    i.e. ``kron(W_machine, W_local)``.  The default intra-machine ``pmean``
    is ``W_local = J/L`` (uniform averaging), whose spectrum {1, 0, ...}
    makes ``spectral_gap(W_eff) == spectral_gap(W_machine)``: the composed
    consensus rate is governed entirely by the cross-machine graph while the
    per-step DCN bytes are governed by its degree — the frontier
    ``tools/gossip_bench.py --frontier`` grades.

    Args accept ``nx.DiGraph`` or dense ``[n, n]`` matrices; an ``int`` for
    ``local_topo`` means uniform ``J/L`` (the pmean path).
    """
    Wm = to_weight_matrix(machine_topo) if isinstance(machine_topo, nx.DiGraph) \
        else np.asarray(machine_topo, dtype=float)
    if isinstance(local_topo, (int, np.integer)):
        L = int(local_topo)
        assert L > 0
        Wl = np.full((L, L), 1.0 / L)
    elif isinstance(local_topo, nx.DiGraph):
        Wl = to_weight_matrix(local_topo)
    else:
        Wl = np.asarray(local_topo, dtype=float)
    return np.kron(Wm, Wl)


def TwoLevelGraph(
    num_machines: int,
    local_size: int,
    intra: str = "dense",
    inter: str = "exp2",
) -> nx.DiGraph:
    """Composed two-level topology over ``num_machines * local_size`` ranks.

    The pod-scale family from the reference's hierarchical operators
    (``mpi_controller.cc:452-507``): a cheap high-bandwidth graph *inside*
    each machine/slice (ICI) composed with a sparse gossip graph *across*
    machines (DCN).  ``intra``: ``"dense"`` (uniform all-to-all average, the
    ``pmean`` the hierarchical op executes), ``"exp2"`` or ``"ring"``.
    ``inter``: ``"exp2"`` (default — log2(M) out-edges per machine),
    ``"ring"`` or ``"full"``.  The returned graph's weight matrix is
    :func:`compose_two_level` of the two levels, so
    :func:`spectral_gap` / :func:`bluefog_tpu.schedule.compile_topology`
    treat it like any flat topology.
    """
    assert num_machines > 0 and local_size > 0
    if inter not in _INTER_FAMILY:
        raise ValueError(f"unknown inter-machine family {inter!r}: "
                         f"one of {sorted(_INTER_FAMILY)}")
    if intra not in _INTRA_FAMILY:
        raise ValueError(f"unknown intra-machine family {intra!r}: "
                         f"one of {sorted(_INTRA_FAMILY)}")
    Wm = (np.ones((1, 1)) if num_machines == 1
          else to_weight_matrix(_INTER_FAMILY[inter](num_machines)))
    Wl = (np.ones((1, 1)) if local_size == 1
          else to_weight_matrix(_INTRA_FAMILY[intra](local_size)))
    return _graph_from_matrix(compose_two_level(Wm, Wl))


def _circulant_row(W: np.ndarray, atol: float = 1e-12) -> Optional[np.ndarray]:
    """First row of ``W`` if every row i is ``row0`` rotated right by i."""
    n = W.shape[0]
    row0 = W[0]
    shifts = (np.arange(n)[:, None] - np.arange(n)[None, :]) % n
    # circulant iff W[i, j] == row0[(j - i) % n] for all i, j
    if np.allclose(W, row0[(-shifts) % n], atol=atol, rtol=0.0):
        return row0
    return None


def spectral_gap(topo, atol: float = 1e-6) -> float:
    """``1 - |lambda_2|`` of a mixing matrix — the consensus contraction rate.

    Accepts a topology graph or a dense ``[n, n]`` matrix ``W[src, dst]``.
    Verifies column-stochasticity first (every receiver's weights — self plus
    in-edges — must sum to 1, the invariant
    :func:`bluefog_tpu.schedule.columns_stochastic` witnesses on compiled
    schedules) and raises ``ValueError`` otherwise: a non-stochastic matrix
    has no consensus fixed point, so its "gap" would be meaningless.

    Circulant matrices (all the ring/exponential families) take an exact
    FFT fast path — the eigenvalues of a circulant are the DFT of its first
    row — so flat pod-scale graphs (4096+ ranks) grade in milliseconds;
    everything else falls back to a dense eigendecomposition.
    """
    W = to_weight_matrix(topo) if isinstance(topo, nx.DiGraph) \
        else np.asarray(topo, dtype=float)
    if W.ndim != 2 or W.shape[0] != W.shape[1]:
        raise ValueError(f"mixing matrix must be square, got shape {W.shape}")
    n = W.shape[0]
    col_sums = W.sum(axis=0)
    if not np.allclose(col_sums, 1.0, atol=atol, rtol=0.0):
        worst = int(np.abs(col_sums - 1.0).argmax())
        raise ValueError(
            f"mixing matrix is not column-stochastic: column {worst} sums to "
            f"{col_sums[worst]:.6f} (mass arriving at each rank must be 1)")
    if n == 1:
        return 1.0
    row0 = _circulant_row(W)
    if row0 is not None:
        moduli = np.abs(np.fft.fft(row0))
    else:
        moduli = np.abs(np.linalg.eigvals(W))
    moduli = np.sort(moduli)[::-1]
    return float(1.0 - moduli[1])


def topology_from_spec(spec: dict) -> nx.DiGraph:
    """Rebuild a topology from its JSON-serializable spec dict.

    The inverse of the specs :mod:`bluefog_tpu.autotune` writes into plans:
    ``{"family": "exp2"|"ring"|"full"|"star"|"mesh2d", "size": n}`` or
    ``{"family": "two_level", "num_machines": m, "local_size": l,
    "intra": ..., "inter": ...}``.  Plans store the spec rather than the
    graph so a plan applied on a different host reconstructs the identical
    topology (same weights, same schedule key).
    """
    family = spec["family"]
    if family == "two_level":
        return TwoLevelGraph(
            int(spec["num_machines"]), int(spec["local_size"]),
            intra=spec.get("intra", "dense"), inter=spec.get("inter", "exp2"))
    flat = {"exp2": ExponentialTwoGraph, "ring": RingGraph,
            "full": FullyConnectedGraph, "star": StarGraph,
            "mesh2d": MeshGrid2DGraph}
    if family not in flat:
        raise ValueError(f"unknown topology family {family!r}: one of "
                         f"{sorted(flat) + ['two_level']}")
    return flat[family](int(spec["size"]))


# ---------------------------------------------------------------------------
# Dynamic one-peer schedule generators  (reference: topology_util.py:315-554)
#
# Each generator yields ``([send_ranks], [recv_ranks])`` per iteration for one
# ``self_rank`` — the exact reference contract, so training scripts written
# against Bluefog's dynamic-topology API port verbatim.  For the SPMD path,
# bluefog_tpu_torch.schedule batches all ranks' generators into per-step
# permutation tables instead.
# ---------------------------------------------------------------------------

def _clockwise_out_neighbors(topo: nx.DiGraph) -> List[List[int]]:
    """Per rank: out-neighbors (self excluded) sorted by clockwise distance."""
    size = topo.number_of_nodes()
    table = []
    for rank in range(size):
        nbrs = sorted(
            (r for r in topo.successors(rank) if r != rank),
            key=lambda r, rk=rank: (r - rk) % size,
        )
        table.append(nbrs)
    return table


def GetDynamicOnePeerSendRecvRanks(
        topo: nx.DiGraph, self_rank: int) -> Iterator[Tuple[List[int], List[int]]]:
    """Cycle through the base topology's out-edges one peer at a time.

    At step t each rank sends to its (t mod out_degree)-th clockwise
    out-neighbor; recv ranks are whoever targets us that step
    (reference :315-357).
    """
    size = topo.number_of_nodes()
    sends = _clockwise_out_neighbors(topo)
    for rank, nbrs in enumerate(sends):
        if not nbrs:
            raise ValueError(
                f"rank {rank} has no out-neighbors besides itself in the base "
                "topology; every rank needs out-degree >= 1 (excluding self) "
                "for a one-peer dynamic schedule")

    def _gen():
        index = 0
        while True:
            send_rank = sends[self_rank][index % len(sends[self_rank])]
            recv_ranks = [
                other for other in range(size)
                if other != self_rank
                and sends[other][index % len(sends[other])] == self_rank
            ]
            yield [send_rank], recv_ranks
            index += 1

    return _gen()


def GetExp2DynamicSendRecvMachineRanks(
        world_size: int, local_size: int, self_rank: int, local_rank: int,
) -> Iterator[Tuple[List[int], List[int]]]:
    """Machine-level one-peer Exp2 schedule (reference :360-396).

    Yields machine ids (not ranks): at step t each machine sends to the
    machine 2**(t mod (log2(M-1)+1)) ahead and receives from the mirror.
    """
    assert self_rank % local_size == local_rank, "homogeneous environment only"
    assert world_size % local_size == 0, "homogeneous environment only"
    assert world_size > local_size, "needs at least two machines"

    machine_id = self_rank // local_size
    num_machines = world_size // local_size
    exp2_size = int(np.log2(num_machines - 1)) if num_machines > 1 else 0
    index = 0
    while True:
        dist = 2 ** (index % (exp2_size + 1))
        yield [(machine_id + dist) % num_machines], [(machine_id - dist) % num_machines]
        index += 1


def GetInnerOuterRingDynamicSendRecvRanks(
        world_size: int, local_size: int, self_rank: int,
) -> Iterator[Tuple[List[int], List[int]]]:
    """Inner-ring/outer-ring one-peer schedule (reference :399-463).

    At step t the local rank ``t mod local_size`` on each machine talks around
    the outer (machine) ring; everyone else walks the inner (intra-machine)
    ring, skipping the outgoing rank.
    """
    assert world_size % local_size == 0, "homogeneous environment only"
    assert local_size > 2, "needs more than 2 nodes per machine"
    num_machines = world_size // local_size

    machine_id, local_id = divmod(self_rank, local_size)
    index = 0
    while True:
        outside_id = index % local_size
        if outside_id == local_id:
            send_rank = ((machine_id + 1) % num_machines) * local_size + local_id
            recv_rank = ((machine_id - 1) % num_machines) * local_size + local_id
        else:
            tgt = (local_id + 1) % local_size
            if tgt == outside_id:
                tgt = (tgt + 1) % local_size
            send_rank = machine_id * local_size + tgt
            src = (local_id - 1) % local_size
            if src == outside_id:
                src = (src - 1) % local_size
            recv_rank = machine_id * local_size + src
        yield [send_rank], [recv_rank]
        index += 1


def GetInnerOuterExpo2DynamicSendRecvRanks(
        world_size: int, local_size: int, self_rank: int,
) -> Iterator[Tuple[List[int], List[int]]]:
    """Inner-Exp2/outer-Exp2 one-peer schedule (reference :466-554).

    Like the inner/outer ring, but both the intra-machine hop and the
    machine-level hop walk exponential-2 distances; the inner hop distance is
    bumped by one when it would land on (or pass) the outgoing local rank.
    """
    assert world_size % local_size == 0, "homogeneous environment only"
    assert local_size > 2, "needs more than 2 nodes per machine"
    num_machines = world_size // local_size

    exp2_out = int(np.log2(num_machines - 1))
    exp2_in = 0 if local_size == 2 else int(np.log2(local_size - 2))

    machine_id, local_id = divmod(self_rank, local_size)
    index = 0
    while True:
        outside_id = index % local_size
        if outside_id == local_id:
            dist = 2 ** (index % (exp2_out + 1))
            send_rank = ((machine_id + dist) % num_machines) * local_size + local_id
            recv_rank = ((machine_id - dist) % num_machines) * local_size + local_id
        else:
            fwd = 2 ** (index % (exp2_in + 1))
            if fwd >= (outside_id - local_id) % local_size:
                fwd += 1
            send_rank = machine_id * local_size + (local_id + fwd) % local_size

            back = 2 ** (index % (exp2_in + 1))
            if back >= (local_id - outside_id) % local_size:
                back += 1
            recv_rank = machine_id * local_size + (local_id - back) % local_size
        yield [send_rank], [recv_rank]
        index += 1


# ---------------------------------------------------------------------------
# Adjacency inference (reference: bluefog/torch/topology_util.py:22-108)
#
# The reference implements these as MPI collectives (allgather of per-rank
# lists).  Under SPMD the full per-rank picture is already host-visible, so
# they are pure list inversions.
# ---------------------------------------------------------------------------

def _invert_rank_lists(lists: List[List[int]], size: int) -> List[List[int]]:
    inverted: List[List[int]] = [[] for _ in range(size)]
    for rank, targets in enumerate(lists):
        for t in targets:
            inverted[t].append(rank)
    return [sorted(v) for v in inverted]


def InferSourceFromDestinationRanks(
        dst_ranks_per_rank: List[List[int]]) -> List[List[int]]:
    """Given every rank's destination list, return every rank's source list."""
    return _invert_rank_lists(dst_ranks_per_rank, len(dst_ranks_per_rank))


def InferDestinationFromSourceRanks(
        src_ranks_per_rank: List[List[int]]) -> List[List[int]]:
    """Given every rank's source list, return every rank's destination list."""
    return _invert_rank_lists(src_ranks_per_rank, len(src_ranks_per_rank))
