"""K4's forward routes, on the CPU.

The port's expert FFN K4 (``bluefog_tpu_torch/ops/grouped_ffn.py``) has
two forward routes on the card: ``expert_rows`` (expert-major blocks for
the serving shapes) and ``forward_gemm`` (the routing plan that the
backward builds, then two persistent wgmma GEMMs over its row blocks of
up to 128 rows, for training row counts).  :func:`ffn_route` picks one
from host integers alone (``tests/test_torch_kernel_plans.py`` holds it
to reading no device value).  The kernels run only on the card
(``tests/test_torch_gpu_kernels.py -m gpu -k grouped_ffn``); here the
``forward_gemm`` route's walk, :func:`_plain_by_blocks` (each row block of
:func:`backward_plan_plain` through its expert's weights, u kept in f32),
is held against :func:`grouped_ffn_plain` and the JAX
``grouped_ffn_pallas`` in interpret mode.

Tolerances: f32 1e-5 absolute at these scales (the same f32 products
summed in other orders over D 16 and F 24); bf16 one bf16 ulp of each
output (8e-3 x |reference|) on top, since both sides compute in f32 and
round the output once, and two orders of f32 sums may straddle a bf16
rounding boundary.  Trash tiles (id -1) have no counterpart in JAX: the
reference is the JAX kernel on the same layout with those tiles clamped
onto a real expert and their rows zero, as the dispatch leaves them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.ops.pallas_moe import grouped_ffn_pallas
from bluefog_tpu_torch.ops import grouped_ffn as gf
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

# ROUTE_ROWS rows an expert, as the tiles of a prefill (8 experts, tile 8)
_AT = gf.ROUTE_ROWS


@pytest.mark.parametrize("args,route", [
    ((12, 2, 8), "expert_rows"),                 # decode, 8 lanes top-2
    ((5, 2, 8), "expert_rows"),                  # decode, 1 lane
    ((11, 16, 8), "expert_rows"),                # tile 16, 22 rows
    ((8192, 8, 32), "forward_gemm"),             # the trainer's tick
    ((71, 8, 8), "forward_gemm"),                # a 256-token prefill
    ((135, 8, 8), "forward_gemm"),               # a 512-token prefill
    ((_AT, 8, 8), "forward_gemm"),               # ROUTE_ROWS an expert
    ((_AT - 1, 8, 8), "expert_rows"),            # one row an expert less
    ((_AT, 8, 8, 8 * _AT - 8), "expert_rows"),   # fewer live rows
    ((4104, 8, 8, 16384), "forward_gemm"),       # an ep-2 fold
])
def test_ffn_route_by_rows_an_expert(args, route):
    """``forward_gemm`` from an even share of ``ROUTE_ROWS`` rows an
    expert (the live-row hint when given), ``expert_rows`` below it: the
    engine's decode shapes and tile-16 chunks stay on ``expert_rows``,
    prefills from 256 tokens and the MoE trainer's steady tick (65,536
    rows over 32 folded experts) take the GEMMs."""
    assert gf.ffn_route(*args) == route


def test_route_threshold_and_the_decode_plan():
    """The threshold the card's crossover set (52 rows an expert), and
    the engine's decode shape (8 lanes top-2, tile 2) keeps
    ``expert_rows``' plan."""
    assert gf.ROUTE_ROWS == 52
    assert gf.ffn_route(12, 2, 8) == "expert_rows"
    assert gf.ffn_plan(12, 2, 8, 1024, 4096) == (16, 1, 64, 16)


def _plain_by_blocks(xt, tile_eid, w1, w2):
    """``(out, s)``: the ``forward_gemm`` route's walk in plain PyTorch.
    :func:`backward_plan_plain` lists the row blocks (up to 128 rows of
    one run of an expert's tiles), and each block's rows go through its
    expert's weights, read in place: ``s = x @ w1[e]`` and ``out =
    gelu(s) @ w2[e]``, both in f32 with ``u = gelu(s)`` kept in f32 (the
    kernel's and the TPU kernel's rounding points), out rounded once to
    xt's type; trash tiles hold zero rows of both."""
    G, tile, D = xt.shape
    W1, W2 = gf._flat(w1), gf._flat(w2)
    blocks = gf.backward_plan_plain(tile_eid, tile, W1.shape[0], D,
                                    W1.shape[-1])["row_blocks"].tolist()
    x = xt.reshape(G * tile, D).float()
    s = x.new_zeros((G * tile, W1.shape[-1]))
    out = x.new_zeros((G * tile, D))
    for first, n, e in blocks:
        s[first:first + n] = x[first:first + n] @ W1[e].float()
        out[first:first + n] = gf._gelu(s[first:first + n]) @ W2[e].float()
    return out.reshape(G, tile, D).to(xt.dtype), s.reshape(G, tile, -1)


def _inputs(case, dtype):
    """``(xt, tile_eid, w1, w2, jax_eid, jax_xt)`` as numpy arrays of
    values ``dtype`` holds: the operands, and the JAX kernel's ids and
    rows (trash tiles clamped onto their owner's last expert, their rows
    zero)."""
    rng = np.random.default_rng(len(case))
    E, D, F, tile = 4, 16, 24, 4
    eid = np.sort(rng.integers(0, E, 40))
    if case == "hostile":                   # all but one tile on expert 2
        eid = np.array([0] + [2] * 45)
    elif case == "tile1":
        tile, eid = 1, rng.integers(0, E, 300)
    elif case == "trash_tiles":             # two owners, their tails -1
        eid = np.concatenate([np.sort(rng.integers(0, 2, 20)),
                              np.full(9, -1), np.sort(rng.integers(2, 4, 24)),
                              np.full(7, -1)])
    G = len(eid)
    xt = rng.normal(size=(G, tile, D)).astype(np.float32)
    w1 = (rng.normal(size=(E, D, F)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(E, F, D)) * 0.3).astype(np.float32)
    if dtype == torch.bfloat16:             # values a bf16 holds
        xt, w1, w2 = (torch.from_numpy(a).bfloat16().float().numpy()
                      for a in (xt, w1, w2))
    jeid, jxt = eid.copy(), xt.copy()
    if case == "trash_tiles":
        owner_last = np.where(np.arange(G) < 29, 1, 3)
        jeid = np.where(eid < 0, owner_last, eid)
        jxt[eid < 0] = 0
    return xt, eid, w1, w2, jeid, jxt


def _torch_args(xt, eid, w1, w2, case, dtype):
    x = torch.from_numpy(xt).to(dtype)
    a, b = torch.from_numpy(w1).to(dtype), torch.from_numpy(w2).to(dtype)
    if case == "peers":                     # [2 peers, 2 layers, 2, ...]
        E, D, F = w1.shape
        big1 = torch.zeros((2, 2, E // 2, D, F), dtype=dtype)
        big2 = torch.zeros((2, 2, E // 2, F, D), dtype=dtype)
        big1[:, 1], big2[:, 1] = a.reshape(2, E // 2, D, F), \
            b.reshape(2, E // 2, F, D)
        a, b = big1[:, 1], big2[:, 1]
    return x, torch.tensor(eid, dtype=torch.int32), a, b


def _close(got, want, dtype):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    tol = 1e-5 + (8e-3 * np.abs(want) if dtype == torch.bfloat16 else 0)
    assert np.all(np.abs(got - want) <= tol), float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["sorted", "trash_tiles", "peers",
                                  "hostile", "tile1"])
def test_block_walk_matches_plain_and_jax(case, dtype):
    """The forward_gemm route's walk over the plan's row blocks equals the
    plain version and the JAX Pallas kernel (interpret mode), in f32 and
    in bf16 (u kept in f32 on every side: no rounding of u), with trash
    tiles, stacked-peer weights read in place, hostile routing and
    one-row tiles (blocks of 128 rows across many tiles)."""
    xt, eid, w1, w2, jeid, jxt = _inputs(case, dtype)
    x, ids, a, b = _torch_args(xt, eid, w1, w2, case, dtype)
    got, s = _plain_by_blocks(x, ids, a, b)
    assert got.dtype == dtype and got.shape == x.shape
    assert s.dtype == torch.float32
    _close(got, gf.grouped_ffn_plain(x, ids, a, b), dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = grouped_ffn_pallas(
        jnp.asarray(jxt, jdt), jnp.asarray(jeid, jnp.int32),
        jnp.asarray(w1, jdt), jnp.asarray(w2, jdt), interpret=True)
    _close(got, np.asarray(want.astype(jnp.float32)), dtype)
    live = torch.from_numpy(eid >= 0)
    assert not got[~live].any() and not s[~live].any()
    np.testing.assert_allclose(
        s[live].numpy(), gf._plain(x, ids, a, b)[1][live].numpy(),
        rtol=0, atol=1e-5)


def test_block_walk_covers_every_live_row_once():
    """The row blocks the walk (and the kernel) take cover each live row
    exactly once, in blocks of at most 128 rows of one expert, so every
    output row is written by one item and none by two."""
    xt, eid, w1, w2, _, _ = _inputs("trash_tiles", torch.float32)
    tile = xt.shape[1]
    blocks = gf.backward_plan_plain(torch.tensor(eid, dtype=torch.int32),
                                    tile, 4, 16, 24)["row_blocks"].tolist()
    seen = np.zeros(len(eid) * tile, int)
    for first, n, e in blocks:
        assert 1 <= n <= 128 and all(
            eid[r // tile] == e for r in range(first, first + n))
        seen[first:first + n] += 1
    assert np.array_equal(seen, np.repeat(eid >= 0, tile).astype(int))
