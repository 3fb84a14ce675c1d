"""The port's topology generators and schedule compiler vs the JAX package.

Both are pure numpy/networkx copies, so everything here is exact: weight
matrices, every compiled table (``self_weight``, ``recv_weight``,
``recv_src``, ``recv_slot``, ``send_scale``, ``slot_weight``, ``rounds``,
``key``) for every generator at n in {4, 8, 16}, weighted and not, the
explicit-weights and dynamic compilers, and ``spectral_gap`` to 1e-12.
"""
import numpy as np
import pytest

from bluefog_tpu import schedule as jsch
from bluefog_tpu import topology as jtopo
from bluefog_tpu_torch import schedule as tsch
from bluefog_tpu_torch import topology as ttopo
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

GENERATORS = ["ExponentialTwoGraph", "ExponentialGraph",
              "SymmetricExponentialGraph", "MeshGrid2DGraph", "StarGraph",
              "RingGraph", "FullyConnectedGraph"]
SIZES = [4, 8, 16]
TABLES = ("self_weight", "recv_weight", "recv_src", "recv_slot",
          "send_scale", "slot_weight", "in_degree", "out_degree")


def _same_schedule(a, b):
    assert a.size == b.size and a.rounds == b.rounds
    for name in TABLES:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.in_neighbors == b.in_neighbors
    assert a.uses_dst_weighting == b.uses_dst_weighting
    assert a.key == b.key


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("gen", GENERATORS)
def test_generator_and_compiled_tables_match(gen, n):
    jt, tt = getattr(jtopo, gen)(n), getattr(ttopo, gen)(n)
    assert np.array_equal(ttopo.to_weight_matrix(tt),
                          jtopo.to_weight_matrix(jt))
    assert ttopo.IsRegularGraph(tt) == jtopo.IsRegularGraph(jt)
    assert ttopo.IsTopologyEquivalent(tt, getattr(ttopo, gen)(n))
    for r in (0, n - 1):
        assert ttopo.GetRecvWeights(tt, r) == jtopo.GetRecvWeights(jt, r)
        assert ttopo.GetSendWeights(tt, r) == jtopo.GetSendWeights(jt, r)
        assert ttopo.GetInNeighbors(tt, r) == jtopo.GetInNeighbors(jt, r)
    for weighted in (True, False):
        ts = tsch.compile_topology(tt, weighted)
        _same_schedule(ts, jsch.compile_topology(jt, weighted))
        assert tsch.rounds_edge_disjoint(ts)
        assert tsch.columns_stochastic(ts)
    assert abs(ttopo.spectral_gap(tt) - jtopo.spectral_gap(jt)) <= 1e-12


@pytest.mark.parametrize("n", SIZES)
def test_compile_from_weights_matches(n):
    rng = np.random.default_rng(n)
    srcs = [{(d - 1) % n: 0.25, (d + 2) % n: 0.25} for d in range(n)]
    dsts = [dict() for _ in range(n)]
    for d, s in enumerate(srcs):
        for src in s:
            dsts[src][d] = float(rng.uniform(0.5, 1.5))
    selfw = [0.5] * n
    for dst in (None, dsts):
        _same_schedule(tsch.compile_from_weights(n, selfw, srcs, dst),
                       jsch.compile_from_weights(n, selfw, srcs, dst))
    with pytest.raises(ValueError, match="different edge sets"):
        tsch.compile_from_weights(n, selfw, srcs, [dict() for _ in range(n)])
    with pytest.raises(ValueError, match="self weight"):
        tsch.compile_from_weights(n, selfw, [{0: 1.0}] + srcs[1:])


@pytest.mark.parametrize("n", [8, 16])
def test_dynamic_generators_and_schedules_match(n):
    base = ttopo.ExponentialTwoGraph(n)
    jbase = jtopo.ExponentialTwoGraph(n)
    cases = [
        (lambda r: ttopo.GetDynamicOnePeerSendRecvRanks(base, r),
         lambda r: jtopo.GetDynamicOnePeerSendRecvRanks(jbase, r)),
        (lambda r: ttopo.GetInnerOuterRingDynamicSendRecvRanks(n, 4, r),
         lambda r: jtopo.GetInnerOuterRingDynamicSendRecvRanks(n, 4, r)),
        (lambda r: ttopo.GetInnerOuterExpo2DynamicSendRecvRanks(n, 4, r),
         lambda r: jtopo.GetInnerOuterExpo2DynamicSendRecvRanks(n, 4, r)),
        (lambda r: ttopo.GetExp2DynamicSendRecvMachineRanks(n, 2, r, r % 2),
         lambda r: jtopo.GetExp2DynamicSendRecvMachineRanks(n, 2, r, r % 2)),
    ]
    for tf, jf in cases:
        for r in (0, n - 1):
            tg, jg = tf(r), jf(r)
            assert [next(tg) for _ in range(12)] == \
                [next(jg) for _ in range(12)]
    for tf, jf in cases[:3]:
        ts = tsch.compile_dynamic_schedules(tf, n)
        js = jsch.compile_dynamic_schedules(jf, n)
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            _same_schedule(a, b)


def test_two_level_specs_and_gap_match():
    for spec in ({"family": "two_level", "num_machines": 4, "local_size": 4,
                  "intra": "ring", "inter": "exp2"},
                 {"family": "mesh2d", "size": 8}, {"family": "star",
                                                   "size": 16}):
        tt, jt = ttopo.topology_from_spec(spec), jtopo.topology_from_spec(spec)
        assert np.array_equal(ttopo.to_weight_matrix(tt),
                              jtopo.to_weight_matrix(jt))
        _same_schedule(tsch.compile_topology(tt), jsch.compile_topology(jt))
        assert abs(ttopo.spectral_gap(tt) - jtopo.spectral_gap(jt)) <= 1e-12
    W = ttopo.compose_two_level(ttopo.RingGraph(4), 2)
    assert np.array_equal(W, jtopo.compose_two_level(jtopo.RingGraph(4), 2))
    with pytest.raises(ValueError, match="column-stochastic"):
        ttopo.spectral_gap(np.array([[0.5, 0.5], [0.6, 0.4]]))
    with pytest.raises(ValueError, match="unknown topology family"):
        ttopo.topology_from_spec({"family": "torus", "size": 4})
    assert ttopo.InferSourceFromDestinationRanks([[1], [2], [0]]) == \
        jtopo.InferSourceFromDestinationRanks([[1], [2], [0]])
