"""Grouped expert FFN for dropless MoE (counterpart of
``bluefog_tpu/ops/pallas_moe.py``).

:func:`grouped_ffn` takes the JAX ``grouped_ffn_pallas`` arguments:
``xt [G, tile, D]`` expert-grouped rows, ``tile_eid [G]`` the expert of
each tile, ``w1 [E, D, F]`` and ``w2 [E, F, D]``, and returns
``gelu_tanh(xt[g] @ w1[eid[g]]) @ w2[eid[g]]`` per tile as ``[G, tile,
D]`` in xt's dtype, computed in f32 (f64 inputs stay f64 on the CPU).
On CUDA tensors it launches the hand-written Hopper kernel in
``csrc/grouped_ffn.cu`` (see its header for the design and what bounds
it); on CPU tensors it runs :func:`grouped_ffn_plain`.  A CUDA tensor
never takes the plain version: the kernel launches or the call raises.

The weights may also be stacked peers, ``w1 [P, E, D, F]`` and ``w2 [P,
E, F, D]`` with any stride between peers (a layer's slice of a stacked
parameter), with ids in ``[0, P * E)``: id ``i`` is peer ``i // E``'s
expert ``i % E``.  The composed trainer folds every live peer of a tick
into one call this way, and the kernel reads each peer's block in place.

A tile whose id is ``-1`` is trash: the dropless dispatch marks so the
tiles past each owner's last group, which hold only zero rows (about
half of an expert-parallel owner's buffer, sized for the worst case).
Every path skips them and writes zeros there: the forward's blocks never
take them and its output rows there are zeros, the backward's plan gives
them no row block and no rows of any expert, and the dgrad writes zero
rows of ``dxt`` there.  ``rows`` (optional, a host int) is how many rows
the live tiles may hold; :func:`ffn_plan` sizes the forward's blocks by
it instead of by the whole buffer.

Under autograd (any operand requiring grad) the call is
:class:`GroupedFFN`: on the card the forward also keeps the
pre-activation ``s = xt @ w1`` (f32) and the backward is hand-written
too: :func:`backward_plan_cuda` builds the routing plan on the device,
then :func:`grouped_ffn_dgrad_cuda` (``dxt``, with ``u = gelu(s)``
rebuilt in its epilogue) and :func:`grouped_ffn_wgrad_cuda` (``dw1``,
``dw2`` per expert, no atomics) run on it; on the CPU the backward is
:func:`grouped_ffn_backward_plain`, the same formulas in plain PyTorch.
The backward takes f32 or bf16 (the trainer's types).  In bf16 ``s``
stays f32 (the exact pre-activation the forward computed), and the
backward rounds only where JAX's ``_grouped_bwd`` rounds too (JAX also
rounds ``s``, ``du`` and each tile's weight gradient): ``ds`` and ``u``
(the operands of the next products), ``dxt``, and each expert's ``dw1``
/ ``dw2`` once after its f32 sum.

The forward takes one of two routes, which :func:`ffn_route` picks from
the shapes alone: below an even share of ``ROUTE_ROWS`` (52) rows an
expert (decode, small prefills), expert-major blocks by the host-side
plan :func:`ffn_plan` (``expert_rows``); from it
(prefills of 256 tokens and up, training row counts),
the backward's routing plan and two persistent wgmma GEMMs over its row
blocks (``forward_gemm``), whose plan a trained call's backward then
takes.  The backward follows the routing: its plan
(:func:`backward_plan_cuda`, with the plain version
:func:`backward_plan_plain`) lists each expert's runs of tiles, the row
blocks of up to 128 rows and the wgrad's parts on the device, and the
host sizes the plan's buffer and the wgrad's scratch from the shapes
alone (:func:`plan_sizes`).  Nothing on this path reads ``tile_eid`` or
any other device value back to the host.

``grouped_ffn_cuda.launches`` counts calls that launched the forward (one
per call, either route; each call is two GEMM launches, up- and
down-projection), ``grouped_ffn_cuda.gemm_launches`` those on the
``forward_gemm`` route (each also counted by
``backward_plan_cuda.launches``), ``backward_plan_cuda.launches``,
``grouped_ffn_dgrad_cuda.launches`` and
``grouped_ffn_wgrad_cuda.launches`` the backward's, so a run can show
that its expert FFNs went through them.
:func:`grouped_ffn_plain_by_expert` and
:func:`grouped_ffn_backward_plain_by_expert` are second plain versions,
for the card: they read the tile layout on the host and run one product
per run of an expert's tiles, with no weight gather, so they hold the
kernels to account at training shapes.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention import _aligned

__all__ = ["grouped_ffn", "grouped_ffn_plain", "grouped_ffn_cuda",
           "ffn_route",
           "grouped_ffn_plain_by_expert", "grouped_ffn_backward_plain",
           "grouped_ffn_backward_plain_by_expert",
           "grouped_ffn_dgrad_cuda", "grouped_ffn_wgrad_cuda", "GroupedFFN",
           "ffn_plan", "plan_sizes", "BackwardPlan", "backward_plan_cuda",
           "backward_plan_plain", "unpack_plan", "build"]

_LIB = "grouped_ffn"
_SOURCES = ("grouped_ffn.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_EXPERTS = 65535        # the kernel's grid y
SMS = 132                   # streaming multiprocessors of an H100
BLOCKS_PER_SM = 2           # the plan's target for each launch
_WIDTH = 8                  # D and F are copied 16 bytes at a time
_TILE = 128                 # the backward GEMM's output tile is 128 x 128
_STAGE = 32                 # rows (the wgrad's reduction) a staged slab
_MIN_PART = 256             # least rows of a wgrad part
WGRAD_TARGET = 4 * SMS      # wgrad items a launch aims for (see plan_sizes)
ROUTE_ROWS = 52             # rows an expert from which the forward takes
#                             the GEMMs on the plan (see ffn_route)
_ROUTES = ("expert_rows", "forward_gemm")
# the plan's format as bf_grouped_ffn_backward_layout gives it
_LAYOUT = ("tile", "stage", "n_runs", "n_row_blocks", "n_parts",
           "n_part_sums", "n_slots", "fault", "expert_rows",
           "expert_runs_ptr", "cursor", "runs", "expert_runs", "row_blocks",
           "parts", "part_sums", "total")


def build() -> ctypes.CDLL:
    """Compile (at the first call in a checkout) and load the kernels."""
    lib = _build.load_library(_LIB, _SOURCES)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bf_grouped_ffn.argtypes = [p] * 7 + [i] * 4 + [ll] * 2 + [i] * 7 \
        + [p]
    lib.bf_grouped_ffn_gemm.argtypes = [p] * 8 + [i] * 4 + [ll] * 2 \
        + [i] * 5 + [p]
    lib.bf_grouped_ffn_backward_plan.argtypes = [p] * 2 + [i] * 11 + [p]
    lib.bf_grouped_ffn_backward_layout.argtypes = [i] * 4 + [p]
    lib.bf_grouped_ffn_dgrad.argtypes = [p] * 9 + [i] * 4 + [ll] * 2 \
        + [i] * 5 + [p]
    lib.bf_grouped_ffn_wgrad.argtypes = [p] * 8 + [i] * 8 + [p]
    for fn in (lib.bf_grouped_ffn, lib.bf_grouped_ffn_gemm,
               lib.bf_grouped_ffn_backward_plan,
               lib.bf_grouped_ffn_backward_layout, lib.bf_grouped_ffn_dgrad,
               lib.bf_grouped_ffn_wgrad):
        fn.restype = ctypes.c_int
    return lib


def ffn_plan(G: int, tile: int, E: int, D: int, F: int,
             live_rows: int = 0) -> Tuple[int, int, int, int]:
    """``(rows, slots, up_cols, down_cols)`` for ``G`` tiles of ``tile``
    rows over ``E`` experts: the chunk of an expert's rows a block
    multiplies at once (16, 32 or 64: the least that holds an even share
    ``G * tile / E``, or ``live_rows / E`` when the caller knows that at
    most ``live_rows`` > 0 rows lie in live tiles), the blocks that share an
    expert's chunks (enough for an even share), and each launch's output
    columns per block, the widest of 64, 32 and 16 that still gives
    ``BLOCKS_PER_SM`` blocks on each SM (16 when none does).  Host
    integers only: the plan never reads ``tile_eid``.  The forward's
    alone: the backward follows the routing (:func:`backward_plan_cuda`)."""
    total = min(G * tile, live_rows) if live_rows > 0 else G * tile
    share = -(-max(total, 1) // E)
    rows = 16 if share <= 16 else 32 if share <= 32 else 64
    slots = -(-share // rows)

    def cols(n: int) -> int:
        for c in (64, 32):
            if E * slots * -(-n // c) >= BLOCKS_PER_SM * SMS:
                return c
        return 16

    return rows, slots, cols(F), cols(D)


def ffn_route(G: int, tile: int, E: int, live_rows: int = 0) -> str:
    """The forward's route for ``G`` tiles of ``tile`` rows over ``E``
    experts: ``"forward_gemm"`` (the routing plan, then two persistent
    wgmma GEMMs over its row blocks of up to 128 rows) when an even share
    of the rows, ``G * tile / E`` (or ``live_rows / E`` when the caller
    knows that at most ``live_rows`` > 0 rows lie in live tiles), reaches
    ``ROUTE_ROWS`` = 52 rows an expert; else ``"expert_rows"``
    (expert-major blocks by :func:`ffn_plan`), which serves the decode
    and small prefill shapes.  The threshold is the card's crossover
    (``chip_smoke.py`` phase 7 in three runs, both routes forced at each
    shape, cold, ms, ``expert_rows`` / ``forward_gemm``; D 1024, F 4096,
    8 experts, tile 8; NVIDIA H100 80GB HBM3, 700.00 W).  f32, the last
    run: 32 rows an expert 0.2437 / 0.4077, 48 0.3740 / 0.4085, 56
    0.4195 / 0.4086, 64 0.5212 / 0.4076, the same within 4 % in the
    others: the lines cross at about 52.  bf16: 48 0.2137 / 0.2593, 56
    0.2316 / 0.2598, 64 0.3277 / 0.2553, 71 (a 256-token prefill) 0.2647
    / 0.2572; in the first run 64 gave 0.2355 / 0.2593, so bf16's
    crossover lies between 56 and 71 and moves from run to run, and one
    threshold serves both types (bf16 loses up to ~11 % between 52 and
    ~60 rows an expert).  At the MoE trainer's steady tick (2,048 rows
    an expert, F 2048, ``s`` kept) ``forward_gemm`` takes 8.2639 ms
    against 27.4740 in f32 and 4.2098 against 15.1671 in bf16.  Host
    integers only: it never reads ``tile_eid``."""
    total = min(G * tile, live_rows) if live_rows > 0 else G * tile
    return "forward_gemm" if total >= ROUTE_ROWS * E else "expert_rows"


def plan_sizes(G: int, tile: int, E: int, D: int, F: int,
               splits: int = 0) -> Tuple[int, int, int]:
    """``(rb_max, p_max, slots)``: the most row blocks, wgrad parts and
    scratch slots the backward's plan can hold for ``G`` tiles of
    ``tile`` rows over ``E`` experts and a ``D x F`` weight, whatever the
    routing.  Host integers only: the wrappers size the plan and the
    wgrad's scratch with them and never read the plan back.  The plan
    kernel writes nothing past these sizes: a routing that needed more
    would set the plan's fault word, on which the GEMMs trap.

    Row blocks: at most one partial block per run, ``G`` runs at most.
    Parts (``splits`` 0): an expert holding ``rows`` of the ``G * tile``
    rows gets ``ceil(rows * WGRAD_TARGET / (G * tile * tiles))`` parts,
    ``tiles`` the 128 x 128 tiles of its weight, so at most ``WGRAD_TARGET
    / tiles`` beyond one a non-empty expert; only experts above that
    share are split, fewer than ``WGRAD_TARGET / tiles`` of them, so the
    split ones hold fewer than twice that many parts (scratch slots).
    With ``splits`` > 0 every expert with rows gets at most ``splits``."""
    tiles = -(-D // _TILE) * -(-F // _TILE)
    rb_max = -(-G * tile // _TILE) + G
    filled = min(E, G)
    if splits:
        return rb_max, splits * filled, splits * filled if splits > 1 else 0
    share = -(-WGRAD_TARGET // tiles)
    slots = 0 if WGRAD_TARGET <= tiles else -(-2 * WGRAD_TARGET // tiles)
    return rb_max, share + filled, slots


def _plan_layout(G: int, E: int, rb_max: int, p_max: int) -> Dict[str, int]:
    """The plan's format as the library defines it: the header words, the
    int32 offsets of its lists and its total length.  Raises when the
    library's GEMM tile or stage differs from the sizes' (``_TILE``,
    ``_STAGE``)."""
    out = (ctypes.c_int * len(_LAYOUT))()
    if build().bf_grouped_ffn_backward_layout(G, E, rb_max, p_max, out):
        raise ValueError(f"backward plan layout: G={G} E={E} "
                         f"rb_max={rb_max} p_max={p_max}")
    layout = dict(zip(_LAYOUT, out))
    if (layout["tile"], layout["stage"]) != (_TILE, _STAGE):
        raise RuntimeError(f"the built backward GEMM takes {layout['tile']}"
                           f"-row tiles and {layout['stage']}-row stages; "
                           f"plan_sizes assumes {_TILE} and {_STAGE}")
    return layout


class BackwardPlan(NamedTuple):
    """K4's backward plan on the card (``buf``, int32) and the shapes it
    was built for; ``slots`` is the scratch the wgrad allocates."""
    buf: torch.Tensor
    G: int
    tile: int
    E: int
    D: int
    F: int
    rb_max: int
    p_max: int
    slots: int


def backward_plan_cuda(tile_eid: torch.Tensor, tile: int, E: int, D: int,
                       F: int, splits: int = 0) -> BackwardPlan:
    """Launch the plan kernel (one block) on ``tile_eid``: each expert's
    rows and runs of tiles in tile order, the dgrad's row blocks (up to
    128 rows of one run each), the wgrad's parts (``splits`` > 0 forces
    that many on every expert with rows) and the experts whose weight
    gradient the wgrad's part sum writes.  Sized by :func:`plan_sizes`;
    nothing is read back."""
    dev = tile_eid.device
    if dev.type != "cuda":
        raise RuntimeError(f"backward_plan_cuda needs CUDA tensors, got "
                           f"{dev}")
    if tile_eid.dtype != torch.int32 or tile_eid.ndim != 1 \
            or not tile_eid.is_contiguous():
        raise TypeError(f"tile_eid must be contiguous int32 [G], got "
                        f"{tile_eid.dtype} {tuple(tile_eid.shape)}")
    G = tile_eid.shape[0]
    if min(G, tile, E, D, F) < 1 or E > _MAX_EXPERTS or splits < 0:
        raise ValueError(f"backward plan: G={G} tile={tile} E={E} D={D} "
                         f"F={F} splits={splits}")
    rb_max, p_max, slots = plan_sizes(G, tile, E, D, F, splits)
    buf = torch.empty(_plan_layout(G, E, rb_max, p_max)["total"],
                      dtype=torch.int32, device=dev)
    err = build().bf_grouped_ffn_backward_plan(
        tile_eid.data_ptr(), buf.data_ptr(), G, tile, E, D, F,
        WGRAD_TARGET, _MIN_PART, splits, rb_max, p_max, slots,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped ffn backward plan launch failed: CUDA "
                           f"error {err} (G={G} tile={tile} E={E})")
    backward_plan_cuda.launches += 1
    return BackwardPlan(buf, G, tile, E, D, F, rb_max, p_max, slots)


backward_plan_cuda.launches = 0


def backward_plan_plain(tile_eid: torch.Tensor, tile: int, E: int, D: int,
                        F: int, splits: int = 0) -> Dict[str, torch.Tensor]:
    """The plan kernel's lists in plain PyTorch (``bincount``, ``cumsum``
    and a stable sort over ``tile_eid``), int32 on tile_eid's device:
    ``expert_rows [E]``; ``runs [R, 2]`` (expert, first tile) in tile
    order, trash tiles (id -1) forming runs of expert -1 that hold no rows
    and enter no other list; ``expert_runs_ptr [E + 1]`` and ``expert_runs [R, 2]`` (first
    row, rows) grouped by expert, in tile order within one; ``row_blocks
    [B, 3]`` (first row, rows, expert) for the dgrad; ``parts [P, 4]``
    (expert, first and end offset into the expert's rows, scratch slot
    or -1) for the wgrad; ``part_sums [S, 3]`` (expert, first slot,
    parts) for the experts whose gradient the part sum writes (0 parts:
    no rows, exact zeros); and ``slots``."""
    ids = tile_eid.long()
    G, dev = ids.numel(), ids.device
    head = torch.ones(G, dtype=torch.bool, device=dev)
    head[1:] = ids[1:] != ids[:-1]
    first_all = head.nonzero().flatten()
    rexp_all = ids[first_all]
    rrows_all = torch.diff(first_all,
                           append=first_all.new_tensor([G])) * tile
    live = rexp_all >= 0                       # trash runs hold no rows
    first, rexp, rrows = first_all[live], rexp_all[live], rrows_all[live]
    erows = torch.bincount(ids[ids >= 0], minlength=E) * tile
    eptr = torch.zeros(E + 1, dtype=torch.long, device=dev)
    eptr[1:] = torch.cumsum(torch.bincount(rexp, minlength=E), 0)
    order = torch.argsort(rexp, stable=True)

    def spread(counts):        # (owner, index within the owner) of items
        owner = torch.repeat_interleave(
            torch.arange(counts.numel(), device=dev), counts)
        start = torch.cumsum(counts, 0) - counts
        return owner, torch.arange(owner.numel(), device=dev) - start[owner]

    run, k = spread(-(-rrows // _TILE))
    row_blocks = torch.stack([first[run] * tile + k * _TILE,
                              (rrows[run] - k * _TILE).clamp(max=_TILE),
                              rexp[run]], 1)
    if splits:
        s = torch.clamp(-(-erows // _STAGE), max=splits)
    else:
        den = G * tile * (-(-D // _TILE) * -(-F // _TILE))
        s = torch.minimum(-(-(erows * WGRAD_TARGET) // den),
                          -(-erows // _MIN_PART))
    s = s.clamp(min=1)
    psize = -(-(-(-erows // s)) // _STAGE) * _STAGE
    nparts = torch.where(erows > 0, -(-erows // psize.clamp(min=1)), 0)
    multi = torch.where(nparts > 1, nparts, 0)
    first_slot = torch.cumsum(multi, 0) - multi
    e, k = spread(nparts)
    parts = torch.stack([e, k * psize[e],
                         torch.minimum(erows[e], (k + 1) * psize[e]),
                         torch.where(nparts[e] > 1, first_slot[e] + k, -1)],
                        1)
    summed = (nparts != 1).nonzero().flatten()
    part_sums = torch.stack([summed, first_slot[summed], nparts[summed]], 1)
    i32 = torch.int32
    return {"expert_rows": erows.to(i32),
            "runs": torch.stack([rexp_all, first_all], 1).to(i32),
            "expert_runs_ptr": eptr.to(i32),
            "expert_runs": torch.stack([first[order] * tile, rrows[order]],
                                       1).to(i32),
            "row_blocks": row_blocks.to(i32), "parts": parts.to(i32),
            "part_sums": part_sums.to(i32),
            "slots": torch.tensor(int(multi.sum()), dtype=i32)}


def unpack_plan(plan: BackwardPlan) -> Dict[str, torch.Tensor]:
    """The device plan's lists as :func:`backward_plan_plain` gives them,
    on the CPU.  It reads the plan back, so it is for checks only; it
    raises when the plan's fault word is set."""
    buf = plan.buf.cpu()
    off = _plan_layout(plan.G, plan.E, plan.rb_max, plan.p_max)
    runs, blocks, parts, sums, slots, fault = (int(buf[off[k]]) for k in (
        "n_runs", "n_row_blocks", "n_parts", "n_part_sums", "n_slots",
        "fault"))
    if fault:
        raise RuntimeError(f"the backward plan outgrew its room: {blocks} "
                           f"row blocks, {parts} parts, {slots} slots "
                           f"against {plan.rb_max}, {plan.p_max}, "
                           f"{plan.slots}")

    def rows(name, n, width):
        return buf[off[name]:off[name] + n * width].reshape(n, width)

    eptr = buf[off["expert_runs_ptr"]:][:plan.E + 1]
    return {"expert_rows": buf[off["expert_rows"]:][:plan.E],
            "runs": rows("runs", runs, 2),      # trash runs (-1) included
            "expert_runs_ptr": eptr,
            "expert_runs": rows("expert_runs", int(eptr[-1]), 2),
            "row_blocks": rows("row_blocks", blocks, 3),
            "parts": rows("parts", parts, 4),
            "part_sums": rows("part_sums", sums, 3),
            "slots": torch.tensor(slots, dtype=torch.int32)}


def _pad_widths(xt: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The operands with D and F zero-padded up to multiples of 8 (the
    kernel copies 16 bytes at a time); unchanged when they already are.
    Exact: a zero column of x or w1 adds nothing, gelu(0) = 0, and the
    caller cuts the padded output columns (and, under autograd, the pad's
    backward cuts the gradients back)."""
    D, Fd = xt.shape[2], w1.shape[-1]
    Dp, Fp = -(-D // _WIDTH) * _WIDTH, -(-Fd // _WIDTH) * _WIDTH
    if (Dp, Fp) == (D, Fd):
        return xt, w1, w2
    return (F.pad(xt, (0, Dp - D)), F.pad(w1, (0, Fp - Fd, 0, Dp - D)),
            F.pad(w2, (0, Dp - D, 0, Fp - Fd)))


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for f32 and narrower types (as the TPU kernel computes), f64
    for f64 (the float64 oracles)."""
    return torch.promote_types(dtype, torch.float32)


def _flat(w: torch.Tensor) -> torch.Tensor:
    """Stacked peers' ``[P, E, a, b]`` weights as ``[P * E, a, b]`` (a
    copy when the peers are not contiguous); 3-D weights unchanged."""
    return w if w.ndim == 3 else w.reshape((-1,) + tuple(w.shape[2:]))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _live(tile_eid: torch.Tensor):
    """``(ids with trash tiles on expert 0, [G, 1, 1] mask of live
    tiles)``."""
    live = tile_eid >= 0
    return torch.where(live, tile_eid, 0).long(), live[:, None, None]


def _plain(xt, tile_eid, w1, w2):
    """``(out, s)``: the plain forward and its pre-activation (zeros on
    trash tiles)."""
    ct = _compute_dtype(xt.dtype)
    idx, live = _live(tile_eid)
    s = torch.einsum("gtd,gdf->gtf", xt.to(ct), _flat(w1)[idx].to(ct))
    s = torch.where(live, s, 0)
    out = torch.einsum("gtf,gfd->gtd", _gelu(s), _flat(w2)[idx].to(ct))
    return torch.where(live, out, 0).to(xt.dtype), s


def grouped_ffn_plain(xt: torch.Tensor, tile_eid: torch.Tensor,
                      w1: torch.Tensor, w2: torch.Tensor,
                      rows: Optional[int] = None) -> torch.Tensor:
    """The plain version: gather each tile's expert weights, then two
    batched einsums with the tanh gelu between (the JAX
    ``grouped_ffn_xla``), in f32 as the TPU kernel computes (f64 for f64
    inputs), cast back to xt's dtype.  The gather materializes ``[G, D,
    F]`` copies of the weights (about 4.5 GB in f32 for the 135 tiles of
    a 512-token prefill at D 1024, F 4096), which is acceptable for the
    CPU tests and the card-side comparisons that use it, and why the
    card's main path never does; at training shapes the card compares
    against :func:`grouped_ffn_plain_by_expert` instead.  ``rows`` (the
    kernel's plan hint) is taken and unused, so either plain version can
    stand in for :func:`grouped_ffn`."""
    return _plain(xt, tile_eid, w1, w2)[0]


def grouped_ffn_plain_by_expert(xt: torch.Tensor, tile_eid: torch.Tensor,
                                w1: torch.Tensor, w2: torch.Tensor,
                                rows: Optional[int] = None) -> torch.Tensor:
    """The same function as one product pair per run of consecutive tiles
    of one expert (the dropless layout holds one run per expert), the
    expert's weights read in place: no gather, differentiable by
    autograd.  It reads ``tile_eid`` on the host, so it is a reference
    for the card's checks and never on the main path (``rows`` unused)."""
    G, tile, D = xt.shape
    ids = tile_eid.cpu().tolist()
    E = w1.shape[1] if w1.ndim == 4 else None
    ct = _compute_dtype(xt.dtype)
    x = xt.reshape(G * tile, D).to(ct)
    parts, g0 = [], 0
    while g0 < G:
        g1 = g0 + 1
        while g1 < G and ids[g1] == ids[g0]:
            g1 += 1
        e = ids[g0]
        rows = x[g0 * tile:g1 * tile]
        if e < 0:                              # trash tiles: zeros
            parts.append(rows.new_zeros(rows.shape[:-1] + (w2.shape[-1],)))
            g0 = g1
            continue
        a, b = (w1[e], w2[e]) if E is None else (w1[e // E, e % E],
                                                 w2[e // E, e % E])
        parts.append(torch.matmul(_gelu(torch.matmul(rows, a.to(ct))),
                                  b.to(ct)))
        g0 = g1
    return torch.cat(parts).reshape(G, tile, -1).to(xt.dtype)


def _dgelu(du: torch.Tensor, s: torch.Tensor, dtype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ds, u)``: ``du * gelu'(s)`` and ``gelu(s)`` in ``du``'s type,
    each rounded once to ``dtype`` (the operands' type) and widened back:
    the backward's first rounding points (no-ops for f32 and f64)."""
    ct = du.dtype
    ds = torch.ops.aten.gelu_backward(du, s, approximate="tanh")
    return ds.to(dtype).to(ct), _gelu(s).to(dtype).to(ct)


def grouped_ffn_backward_plain(xt: torch.Tensor, tile_eid: torch.Tensor,
                               w1: torch.Tensor, w2: torch.Tensor,
                               s: torch.Tensor, g: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """``(dxt, dw1, dw2)`` from the kept pre-activation ``s`` and the
    output's cotangent ``g``, the formulas of the kernels (and the values
    of the JAX ``_grouped_bwd``): ``ds = (g @ w2^T) * gelu'(s)``, ``dxt =
    ds @ w1^T``, ``dw1[e]`` / ``dw2[e]`` the sums of ``xt^T ds`` / ``gelu(
    s)^T g`` over e's tiles (``index_add_`` in tile order).  Trash tiles
    add nothing and get zero rows of ``dxt``.  Computed in f32 (f64 for
    f64); bf16 operands round ``ds`` and ``gelu(s)`` to bf16 once, then
    ``dxt`` and each expert's summed ``dw1`` / ``dw2`` (the kernels'
    rounding points)."""
    ct = _compute_dtype(xt.dtype)
    idx, live = _live(tile_eid)
    W1, W2 = _flat(w1), _flat(w2)
    w1g, w2g = W1[idx].to(ct), W2[idx].to(ct)
    g, s = torch.where(live, g.to(ct), 0), s.to(ct)
    du = torch.einsum("gtd,gfd->gtf", g, w2g)
    ds, u = _dgelu(du, s, xt.dtype)
    dxt = torch.einsum("gtf,gdf->gtd", ds, w1g)
    dw1 = torch.zeros(W1.shape, dtype=ct).index_add_(
        0, idx, torch.einsum("gtd,gtf->gdf", xt.to(ct), ds))
    dw2 = torch.zeros(W2.shape, dtype=ct).index_add_(
        0, idx, torch.einsum("gtf,gtd->gfd", u, g))
    return (dxt.to(xt.dtype), dw1.reshape(w1.shape).to(w1.dtype),
            dw2.reshape(w2.shape).to(w2.dtype))


def grouped_ffn_backward_plain_by_expert(
        xt: torch.Tensor, tile_eid: torch.Tensor, w1: torch.Tensor,
        w2: torch.Tensor, s: torch.Tensor, g: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`grouped_ffn_backward_plain` as ``torch.matmul`` per run of
    one expert's tiles, the weights read in place (no gather): the same
    formulas and rounding points, for the card's checks at training
    shapes.  It reads ``tile_eid`` on the host (never on the main
    path)."""
    G, tile, D = xt.shape
    ct = _compute_dtype(xt.dtype)
    W1, W2 = _flat(w1), _flat(w2)
    ids = tile_eid.cpu().tolist()
    x2, g2, s2 = (t.reshape(G * tile, -1) for t in (xt, g, s))
    dxt = torch.zeros((G * tile, D), dtype=ct, device=xt.device)
    dw1 = torch.zeros(W1.shape, dtype=ct, device=xt.device)
    dw2 = torch.zeros(W2.shape, dtype=ct, device=xt.device)
    g0 = 0
    while g0 < G:
        g1 = g0 + 1
        while g1 < G and ids[g1] == ids[g0]:
            g1 += 1
        e, r0, r1 = ids[g0], g0 * tile, g1 * tile
        g0 = g1
        if e < 0:                               # trash tiles: zero rows
            continue
        gs, xs = g2[r0:r1].to(ct), x2[r0:r1].to(ct)
        ds, u = _dgelu(torch.matmul(gs, W2[e].to(ct).t()), s2[r0:r1].to(ct),
                       xt.dtype)
        dxt[r0:r1] = torch.matmul(ds, W1[e].to(ct).t())
        dw1[e] += torch.matmul(xs.t(), ds)
        dw2[e] += torch.matmul(u.t(), gs)
    return (dxt.reshape(xt.shape).to(xt.dtype),
            dw1.reshape(w1.shape).to(w1.dtype),
            dw2.reshape(w2.shape).to(w2.dtype))


def _check(xt: torch.Tensor, tile_eid: torch.Tensor, w1: torch.Tensor,
           w2: torch.Tensor) -> None:
    if xt.ndim != 3 or tile_eid.shape != (xt.shape[0],):
        raise ValueError(
            f"grouped_ffn: xt must be [n_tiles, tile, D] with tile_eid "
            f"[n_tiles], got {tuple(xt.shape)} / {tuple(tile_eid.shape)}")
    D = xt.shape[2]
    lead = tuple(w1.shape[:-2])
    if (w1.ndim not in (3, 4) or w2.ndim != w1.ndim or w1.shape[-2] != D
            or w2.shape != lead + (w1.shape[-1], D)):
        raise ValueError(
            f"grouped_ffn: want w1 [(P,) E, D={D}, F] and w2 [(P,) E, F, "
            f"D], got {tuple(w1.shape)} / {tuple(w2.shape)}")


def _experts(w: torch.Tensor) -> Tuple[int, int, int]:
    """``(experts, experts a peer, elements between peers)`` of a 3-D
    contiguous or 4-D stacked-peer weight whose blocks are contiguous."""
    if w.ndim == 3:
        if not w.is_contiguous():
            raise ValueError("grouped_ffn weights must be contiguous")
        return w.shape[0], w.shape[0], w.numel()
    P, E, a, b = w.shape
    if w[0].is_contiguous() and (P == 1 or w.stride(0) >= E * a * b):
        return P * E, E, w.stride(0) if P > 1 else E * a * b
    raise ValueError(f"grouped_ffn stacked weights {tuple(w.shape)} need "
                     f"contiguous [E, a, b] blocks, got strides "
                     f"{w.stride()}")


def _cuda_operands(xt, tile_eid, w1, w2, dtypes):
    dev = xt.device
    if dev.type != "cuda":
        raise RuntimeError(f"grouped_ffn_cuda needs CUDA tensors, got {dev}")
    _check(xt, tile_eid, w1, w2)
    if xt.dtype not in dtypes or w1.dtype != xt.dtype \
            or w2.dtype != xt.dtype:
        raise TypeError(f"grouped_ffn dtypes {xt.dtype}/{w1.dtype}/"
                        f"{w2.dtype}: expected all alike, one of "
                        f"{list(dtypes)}")
    if tile_eid.dtype != torch.int32:
        raise TypeError(f"tile_eid must be int32, got {tile_eid.dtype}")
    for t in (xt, tile_eid, w1, w2):
        if t.device != dev:
            raise ValueError(f"grouped_ffn operands must all be on {dev}; "
                             f"got one on {t.device}")
    for t in (xt, tile_eid):
        if not t.is_contiguous():
            raise ValueError("grouped_ffn xt and tile_eid must be "
                             "contiguous")
    G, tile, D = xt.shape
    Fd = w1.shape[-1]
    E, epp, p1 = _experts(w1)
    p2 = _experts(w2)[2]
    if E > _MAX_EXPERTS or 0 in (G, tile, D, Fd, E):
        raise ValueError(f"grouped_ffn takes 1 .. {_MAX_EXPERTS} experts "
                         f"and non-empty tiles/widths, got G={G} "
                         f"tile={tile} D={D} F={Fd} E={E}")
    return G, tile, D, Fd, E, epp, p1, p2


def _forward_cuda(xt, tile_eid, w1, w2, keep_s: bool,
                  live_rows: Optional[int] = None,
                  route: Optional[str] = None):
    """``(out, s or None, plan or None)`` on padded operands (D, F
    multiples of 8), by the route :func:`ffn_route` picks from the shapes;
    the ``forward_gemm`` route returns the plan it built, for the
    backward.  ``route`` forces one (the card's checks compare the two;
    the main path never passes it)."""
    dev = xt.device
    xt, w1, w2 = _aligned(xt), _aligned(w1), _aligned(w2)
    G, tile, D, Fd, E, epp, p1, p2 = _cuda_operands(xt, tile_eid, w1, w2,
                                                    _DTYPES)
    route = route or ffn_route(G, tile, E, live_rows or 0)
    if route not in _ROUTES:
        raise ValueError(f"grouped ffn route {route!r}: one of {_ROUTES}")
    lib = build()
    u = torch.empty((G, tile, Fd), dtype=torch.float32, device=dev)
    s = torch.empty_like(u) if keep_s else None
    out = torch.empty_like(xt)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (xt.data_ptr(), tile_eid.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), u.data_ptr(),
            None if s is None else s.data_ptr(), out.data_ptr())
    plan = None
    if route == "forward_gemm":
        plan = backward_plan_cuda(tile_eid, tile, E, D, Fd)
        err = lib.bf_grouped_ffn_gemm(
            *args, plan.buf.data_ptr(), G, tile, E, epp, p1, p2, D, Fd,
            plan.rb_max, plan.p_max, _DTYPES[xt.dtype], stream)
    else:
        rows, slots, up_cols, down_cols = ffn_plan(G, tile, E, D, Fd,
                                                    live_rows or 0)
        err = lib.bf_grouped_ffn(
            *args, G, tile, E, epp, p1, p2, D, Fd, rows, slots, up_cols,
            down_cols, _DTYPES[xt.dtype], stream)
    if err != 0:
        raise RuntimeError(f"grouped ffn kernel launch failed ({route}): "
                           f"CUDA error {err} (G={G} tile={tile} E={E} "
                           f"D={D} F={Fd})")
    grouped_ffn_cuda.launches += 1
    if route == "forward_gemm":
        grouped_ffn_cuda.gemm_launches += 1
    return out, s, plan


def grouped_ffn_cuda(xt: torch.Tensor, tile_eid: torch.Tensor,
                     w1: torch.Tensor, w2: torch.Tensor,
                     rows: Optional[int] = None) -> torch.Tensor:
    """Launch the forward kernel; raises on anything it does not take.
    The ids in ``tile_eid`` must lie in ``[-1, E)`` (the layout guarantees
    it; checking would cost a host sync)."""
    if xt.device.type != "cuda":
        raise RuntimeError(f"grouped_ffn_cuda needs CUDA tensors, got "
                           f"{xt.device}")
    D = xt.shape[-1]
    out = _forward_cuda(*_padded(xt, tile_eid, w1, w2), keep_s=False,
                        live_rows=rows)[0]
    return out if out.shape[2] == D else out[..., :D].contiguous()


grouped_ffn_cuda.launches = 0       # forward calls, either route
grouped_ffn_cuda.gemm_launches = 0  # of them on the forward_gemm route


def _padded(xt, tile_eid, w1, w2):
    xt, w1, w2 = _pad_widths(xt, w1, w2)
    return xt, tile_eid, w1, w2


def _plan_for(plan: Optional[BackwardPlan], tile_eid: torch.Tensor,
              tile: int, E: int, D: int, F: int,
              splits: int = 0) -> BackwardPlan:
    """``plan`` when it was built for these shapes (else a ValueError), or
    a new one."""
    if plan is None:
        return backward_plan_cuda(tile_eid, tile, E, D, F, splits)
    want = (tile_eid.shape[0], tile, E, D, F)
    if tuple(plan[1:6]) != want or plan.buf.device != tile_eid.device:
        raise ValueError(f"grouped_ffn backward: the plan was built for "
                         f"(G, tile, E, D, F) = {tuple(plan[1:6])} on "
                         f"{plan.buf.device}, not {want} on "
                         f"{tile_eid.device}")
    return plan


def grouped_ffn_dgrad_cuda(g: torch.Tensor, tile_eid: torch.Tensor,
                           w1: torch.Tensor, w2: torch.Tensor,
                           s: torch.Tensor,
                           plan: Optional[BackwardPlan] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """``(dxt, ds, u)``: the dgrad launches on padded f32 or bf16 operands
    (D, F multiples of 8; ``s`` f32 either way): ``ds = (g @ w2^T) *
    gelu'(s)``, ``u = gelu(s)``, ``dxt = ds @ w1^T`` in g's type, over
    the row blocks of ``plan`` (built here when none is given); ``dxt`` is
    zero on trash tiles, where ``ds`` and ``u`` are left unwritten (no
    expert's rows lie there)."""
    dev = g.device
    g, w1, w2 = _aligned(g), _aligned(w1), _aligned(w2)
    G, tile, D, Fd, E, epp, p1, p2 = _cuda_operands(g, tile_eid, w1, w2,
                                                    _DTYPES)
    if s.shape != (G, tile, Fd) or s.dtype != torch.float32 \
            or not s.is_contiguous():
        raise ValueError(f"grouped_ffn dgrad: s must be contiguous f32 "
                         f"{(G, tile, Fd)}, got {tuple(s.shape)} {s.dtype}")
    s = _aligned(s)
    plan = _plan_for(plan, tile_eid, tile, E, D, Fd)
    lib = build()
    ds = torch.empty(s.shape, dtype=g.dtype, device=dev)
    u = torch.empty_like(ds)
    dxt = torch.empty_like(g)
    err = lib.bf_grouped_ffn_dgrad(
        g.data_ptr(), tile_eid.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        s.data_ptr(), ds.data_ptr(), u.data_ptr(), dxt.data_ptr(),
        plan.buf.data_ptr(), G, tile, E, epp, p1, p2, D, Fd, plan.rb_max,
        plan.p_max, _DTYPES[g.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped ffn dgrad launch failed: CUDA error "
                           f"{err} (G={G} tile={tile} E={E} D={D} F={Fd})")
    grouped_ffn_dgrad_cuda.launches += 1
    return dxt, ds, u


grouped_ffn_dgrad_cuda.launches = 0


def grouped_ffn_wgrad_cuda(xt: torch.Tensor, ds: torch.Tensor,
                           u: torch.Tensor, g: torch.Tensor,
                           tile_eid: torch.Tensor, num_experts: int,
                           splits: Optional[int] = None,
                           plan: Optional[BackwardPlan] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dw1 [E, D, F], dw2 [E, F, D])`` in the operands' type (f32 or
    bf16): per expert, the sums over its rows of ``xt^T ds`` and ``u^T
    g``, in tile order, with no atomics, over the parts of ``plan`` (built
    here when none is given; ``splits`` then forces that many parts on
    every expert with rows).  A split expert's parts go to an f32 scratch
    that a second launch adds in part order (then rounds once); it also
    writes exact zeros for experts without rows."""
    dev = xt.device
    if dev.type != "cuda":
        raise RuntimeError(f"grouped_ffn_wgrad_cuda needs CUDA tensors, "
                           f"got {dev}")
    G, tile, D = xt.shape
    Fd = ds.shape[2]
    E = num_experts
    if xt.dtype not in _DTYPES:
        raise TypeError(f"grouped_ffn wgrad takes f32 or bf16, got "
                        f"{xt.dtype}")
    for t, shape in ((xt, (G, tile, D)), (ds, (G, tile, Fd)),
                     (u, (G, tile, Fd)), (g, (G, tile, D))):
        if t.shape != shape or t.device != dev or not t.is_contiguous() \
                or t.dtype != xt.dtype:
            raise ValueError(f"grouped_ffn wgrad operands must be "
                             f"contiguous {xt.dtype} on {dev}; want {shape}"
                             f", got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if tile_eid.dtype != torch.int32 or tile_eid.shape != (G,):
        raise TypeError(f"tile_eid must be int32 [{G}], got "
                        f"{tile_eid.dtype} {tuple(tile_eid.shape)}")
    width = 16 // xt.element_size()          # TMA rows: 16-byte strides
    if D % width or Fd % width or not 1 <= E <= _MAX_EXPERTS:
        raise ValueError(f"grouped_ffn wgrad takes D, F multiples of "
                         f"{width} and 1 .. {_MAX_EXPERTS} experts, got "
                         f"D={D} F={Fd} E={E}")
    if plan is not None and splits is not None:
        raise ValueError("grouped_ffn wgrad: give splits or a plan, not "
                         "both")
    plan = _plan_for(plan, tile_eid, tile, E, D, Fd, splits or 0)
    xt, ds, u, g = (_aligned(t) for t in (xt, ds, u, g))
    lib = build()
    dw1 = torch.empty((E, D, Fd), dtype=xt.dtype, device=dev)
    dw2 = torch.empty((E, Fd, D), dtype=xt.dtype, device=dev)
    scratch = torch.empty((plan.slots, D * Fd), dtype=torch.float32,
                          device=dev) if plan.slots else None
    err = lib.bf_grouped_ffn_wgrad(
        xt.data_ptr(), ds.data_ptr(), u.data_ptr(), g.data_ptr(),
        plan.buf.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
        None if scratch is None else scratch.data_ptr(), G, tile, E, D, Fd,
        plan.rb_max, plan.p_max, _DTYPES[xt.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped ffn wgrad launch failed: CUDA error "
                           f"{err} (G={G} tile={tile} E={E} D={D} F={Fd} "
                           f"slots={plan.slots})")
    grouped_ffn_wgrad_cuda.launches += 1
    return dw1, dw2


grouped_ffn_wgrad_cuda.launches = 0


class GroupedFFN(torch.autograd.Function):
    """K4 with its gradient: on the card the forward keeps ``s`` and the
    backward is the plan, dgrad and wgrad kernels (one plan for both, the
    forward's own on its ``forward_gemm`` route); on the CPU the plain
    forward and :func:`grouped_ffn_backward_plain`.  Takes operands whose
    widths are multiples of 8 on the card (:func:`grouped_ffn` pads
    them); no gradient for ``tile_eid``."""

    @staticmethod
    def forward(ctx, xt, tile_eid, w1, w2, rows=None):
        ctx.plan = None
        if xt.device.type == "cuda":
            out, s, ctx.plan = _forward_cuda(xt, tile_eid, w1, w2,
                                             keep_s=True, live_rows=rows)
        else:
            out, s = _plain(xt, tile_eid, w1, w2)
        ctx.save_for_backward(xt, tile_eid, w1, w2, s)
        return out

    @staticmethod
    def backward(ctx, g):
        xt, tile_eid, w1, w2, s = ctx.saved_tensors
        if g.device.type != "cuda":
            dxt, dw1, dw2 = grouped_ffn_backward_plain(xt, tile_eid, w1, w2,
                                                       s, g)
            return dxt, None, dw1, dw2, None
        g = g.contiguous()
        G, tile, D = xt.shape
        E = _experts(w1)[0]
        plan = ctx.plan or backward_plan_cuda(tile_eid, tile, E, D,
                                              w1.shape[-1])
        dxt, ds, u = grouped_ffn_dgrad_cuda(g, tile_eid, w1, w2, s, plan)
        dw1, dw2 = grouped_ffn_wgrad_cuda(xt, ds, u, g, tile_eid, E,
                                          plan=plan)
        return dxt, None, dw1.view(w1.shape), dw2.view(w2.shape), None


def grouped_ffn(xt: torch.Tensor, tile_eid: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors; under
    autograd, :class:`GroupedFFN` (widths padded to multiples of 8 on the
    card, the gradients cut back by the pad's own backward).  ``rows``:
    see the module docstring (the forward plan's hint)."""
    if xt.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"grouped_ffn runs on CUDA or the CPU, not "
                           f"{xt.device}")
    _check(xt, tile_eid, w1, w2)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xt, w1, w2))
    if not grad:
        if xt.device.type == "cuda":
            return grouped_ffn_cuda(xt, tile_eid, w1, w2, rows)
        return grouped_ffn_plain(xt, tile_eid, w1, w2)
    if xt.device.type == "cpu":
        return GroupedFFN.apply(xt, tile_eid, w1, w2)
    D = xt.shape[2]
    out = GroupedFFN.apply(*_padded(xt, tile_eid, w1, w2), rows)
    return out if out.shape[2] == D else out[..., :D]
