"""Host-side plans and build of the port's serving kernels, on the CPU.

The flash-decode kernel K3 splits each (lane, kv head) across CTAs
(:func:`bluefog_tpu_torch.ops.flash_decode.split_plan`), and the grouped
expert FFN K4 runs expert-major blocks
(:func:`bluefog_tpu_torch.ops.grouped_ffn.ffn_plan`).  Both plans are
host integer arithmetic on shapes: they must fill the card (at least two
CTAs per SM at the engine's shapes), never split finer than the work
allows, and never read a device value (the engine's decode path does not
wait for the device).  K4's backward builds its plan on the card from
the routing; its plain version
(:func:`bluefog_tpu_torch.ops.grouped_ffn.backward_plan_plain`) is held
here to what the kernels rely on, and the host sizes it from shapes
alone (:func:`bluefog_tpu_torch.ops.grouped_ffn.plan_sizes`).  The
kernels themselves run only on the card (tests/test_torch_gpu_kernels.py).
"""
import inspect
import re
import stat

import numpy as np
import pytest
import torch

from bluefog_tpu_torch.ops import _build
from bluefog_tpu_torch.ops import flash_decode as fd
from bluefog_tpu_torch.ops import grouped_ffn as gf
import torch_plan_routings as routings
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

SMS = 132
# device-to-host reads that would stall the engine's decode path
_HOST_READS = re.compile(
    r"\.(item|tolist|cpu|numpy)\(|torch\.unique|\.nonzero\(|\bbool\(|"
    r"\bint\((lengths|tile_eid|slots)")


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("Hkv", [16, 4, 1])
@pytest.mark.parametrize("L", [1024, 256, 40])
def test_split_plan_fills_the_card_within_the_keys(S, Hkv, L):
    splits, chunk = fd.split_plan(S, Hkv, L)
    chunks = -(-L // fd.MIN_CHUNK)
    assert chunk % fd.MIN_CHUNK == 0 and chunk >= fd.MIN_CHUNK
    assert splits * chunk >= L > (splits - 1) * chunk   # no empty split
    assert 1 <= splits <= chunks
    assert S * Hkv * splits >= 2 * SMS or splits == chunks


def test_split_plan_at_the_engines_shapes():
    # the dense and MoE engines' decode: 8 lanes x 16 kv heads, 1024 keys
    splits, chunk = fd.split_plan(8, 16, 1024)
    assert 8 * 16 * splits >= fd.CTAS_PER_SM * SMS
    assert (splits, chunk) == (5, 224)
    # one lane over 4 kv heads: every 32-key chunk its own CTA
    assert fd.split_plan(1, 4, 1024) == (32, 32)


@pytest.mark.parametrize("G,tile,note", [
    (12, 2, "decode, 8 lanes x top-2 over 8 experts"),
    (5, 2, "decode, 1 lane"),
    (135, 8, "512-token prefill"),
    (72, 16, "tile 16"),
    (16, 1, "tile 1")])
def test_ffn_plan_fills_the_card(G, tile, note):
    E, D, F = 8, 1024, 4096
    rows, slots, up_cols, down_cols = gf.ffn_plan(G, tile, E, D, F)
    share = -(-G * tile // E)
    assert rows in (16, 32, 64) and up_cols in (16, 32, 64) \
        and down_cols in (16, 32, 64)
    assert rows * slots >= share > rows * (slots - 1) or rows == 16
    for n, cols in ((F, up_cols), (D, down_cols)):
        assert E * slots * -(-n // cols) >= 2 * SMS
        if cols < 64:        # never narrower than the fill needs
            assert E * slots * -(-n // (2 * cols)) < 2 * SMS


def test_ffn_plan_at_the_engines_shapes():
    # decode: up-projection 512 blocks of 64 columns, down 512 of 16
    assert gf.ffn_plan(12, 2, 8, 1024, 4096) == (16, 1, 64, 16)
    # prefill: chunks of 64 rows shared by 3 blocks per column slice
    assert gf.ffn_plan(135, 8, 8, 1024, 4096) == (64, 3, 64, 64)


def test_plans_and_wrappers_read_no_device_value():
    for fn in (fd.split_plan, gf.ffn_plan, gf.ffn_route,
               fd.flash_decode_cuda, gf.grouped_ffn_cuda, gf._pad_widths):
        src = inspect.getsource(fn)
        assert not _HOST_READS.search(src), (fn.__name__,
                                             _HOST_READS.search(src))
    for fn in (fd.split_plan, gf.ffn_plan, gf.ffn_route):
        assert all(p.annotation in (int, "int") for p in
                   inspect.signature(fn).parameters.values())


def test_k4_backward_and_moe_trainer_read_no_device_value():
    """K4's backward and the MoE training path launch without reading a
    device value: the wrappers, the autograd function, the dropless
    sublayer and the replica machinery (the plain per-expert version,
    a reference read on the host, is not on the path)."""
    from bluefog_tpu_torch.moe import layers, model
    from bluefog_tpu_torch.parallel import compose, expert
    for fn in (gf.plan_sizes, gf.backward_plan_cuda, gf._plan_for,
               gf._forward_cuda, gf.grouped_ffn_dgrad_cuda,
               gf.grouped_ffn_wgrad_cuda, gf.GroupedFFN, gf.grouped_ffn,
               layers.moe_dropless_combine, layers.moe_ffn_dropless,
               layers._router_stats, layers.router_topk,
               expert.dropless_dispatch, compose._replica_fns,
               model._moe_replica):
        src = inspect.getsource(fn)
        if fn is compose._replica_fns:      # its probe reads no value
            src = src[:src.index("    def probe(")]
        assert not _HOST_READS.search(src), (fn.__name__,
                                             _HOST_READS.search(src))
    assert all(p.annotation in (int, "int") for p in
               inspect.signature(gf.plan_sizes).parameters.values())
    # the trainer's steady tick: 65,536 rows over 32 experts, D 1024, F
    # 2048 (128 dw tiles an expert): no expert can be split twice over
    assert gf.plan_sizes(8192, 8, 32, 1024, 2048) == (8704, 37, 9)
    # one dw tile an expert: up to 528 parts beyond one per expert
    assert gf.plan_sizes(512, 8, 2, 64, 64) == (544, 530, 1056)
    assert gf.plan_sizes(512, 8, 2, 64, 64, splits=5) == (544, 10, 10)


@pytest.mark.parametrize("case", routings.CASES)
def test_backward_plan_covers_every_row_once_in_tile_order(case):
    """The dgrad's row blocks and the wgrad's parts (walked through the
    expert's runs) each cover every row of every expert exactly once, in
    tile order; no row block crosses a run's end."""
    eid, tile, E, D, F, splits = routings.routing(case)
    plan = gf.backward_plan_plain(eid, tile, E, D, F, splits)
    ids = eid.long().tolist()
    rows_of = {e: [g * tile + r for g, x in enumerate(ids) if x == e
                   for r in range(tile)] for e in range(E)}
    runs = plan["runs"].tolist()
    ends = [first for _, first in runs[1:]] + [len(ids)]
    run_rows = {(first * tile, (end - first) * tile): x
                for (x, first), end in zip(runs, ends)}
    # dgrad: blocks of at most 128 rows, inside one run of their expert
    seen = {e: [] for e in range(E)}
    for first, n, e in plan["row_blocks"].tolist():
        assert 1 <= n <= 128
        assert any(r0 <= first and first + n <= r0 + m and x == e
                   for (r0, m), x in run_rows.items())
        seen[e] += list(range(first, first + n))
    assert seen == rows_of
    # the expert's runs, grouped by expert, in tile order
    ptr, eruns = plan["expert_runs_ptr"].tolist(), plan["expert_runs"]
    for e in range(E):
        mine = eruns[ptr[e]:ptr[e + 1]].tolist()
        assert [r for first, n in mine for r in range(first, first + n)] \
            == rows_of[e]
    # wgrad: the parts of an expert tile its rows in order, part by part
    covered = {e: [] for e in range(E)}
    for e, r0, r1, slot in plan["parts"].tolist():
        assert covered[e] == list(range(r0)) and r0 < r1 and r0 % 32 == 0
        covered[e] += list(range(r0, r1))
    assert all(len(covered[e]) == len(rows_of[e]) for e in range(E))


@pytest.mark.parametrize("case", routings.CASES)
def test_backward_plan_follows_the_routing(case):
    """Item counts follow the routing, within the host's shape-only
    sizes: one row block per 128 rows of a run (none for a run of trash
    tiles), experts without rows
    listed for exact zeros and given no part, split experts' parts on
    their own scratch slots and listed for the ordered sum."""
    eid, tile, E, D, F, splits = routings.routing(case)
    plan = gf.backward_plan_plain(eid, tile, E, D, F, splits)
    rb_max, p_max, slots_max = gf.plan_sizes(len(eid), tile, E, D, F,
                                             splits)
    counts = torch.bincount(eid[eid >= 0].long(), minlength=E) * tile
    assert torch.equal(plan["expert_rows"], counts.int())
    runs = plan["runs"].tolist()
    ends = [first for _, first in runs[1:]] + [len(eid)]
    assert len(plan["row_blocks"]) == sum(     # trash runs (id -1): none
        -(-(end - first) * tile // 128) for (x, first), end in
        zip(runs, ends) if x >= 0) <= rb_max
    parts, sums = plan["parts"].tolist(), plan["part_sums"].tolist()
    assert len(parts) <= p_max and int(plan["slots"]) <= slots_max
    nparts = [sum(p[0] == e for p in parts) for e in range(E)]
    empty = [e for e in range(E) if counts[e] == 0]
    split = [e for e in range(E) if nparts[e] > 1]
    assert [e for e in range(E) if nparts[e] == 0] == empty
    assert sums == sorted(sums) and [s[0] for s in sums] == sorted(
        empty + split)
    slots = [p[3] for p in parts if p[3] >= 0]
    assert slots == list(range(len(slots))) == list(
        range(int(plan["slots"])))
    for e, first, n in sums:
        assert n == nparts[e]
        assert [p[3] for p in parts if p[0] == e and n > 1] == list(
            range(first, first + n)) or n == 0
    for e in range(E):             # equal parts on 32-row boundaries
        sizes = [p[2] - p[1] for p in parts if p[0] == e]
        assert all(s == sizes[0] and s % 32 == 0 for s in sizes[:-1])
        assert not splits or len(sizes) <= splits
    if case == "hostile":          # the hot expert: 4088 rows, 32 blocks
        assert sum(b[2] == 5 for b in plan["row_blocks"].tolist()) == 32
    if case in ("random", "stacked_peers"):
        assert not split           # an even share is never split


@pytest.mark.parametrize("D,F", [(96, 200), (100, 202), (8, 12)])
def test_width_padding_is_exact(D, F):
    """K4 pads D and F to multiples of 8; the padded problem's output,
    cut back to D columns, equals the original's."""
    rng = np.random.default_rng(D + F)
    E, G, tile = 3, 5, 2
    xt = torch.from_numpy(rng.normal(size=(G, tile, D)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(size=(E, D, F)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(E, F, D)).astype(np.float32))
    eid = torch.tensor([0, 2, 2, 1, 0], dtype=torch.int32)
    px, p1, p2 = gf._pad_widths(xt, w1, w2)
    assert px.shape[2] % 8 == 0 and p1.shape[2] % 8 == 0
    assert p1.shape[1] == px.shape[2] and p2.shape == (E, p1.shape[2],
                                                       px.shape[2])
    want = gf.grouped_ffn_plain(xt, eid, w1, w2)
    got = gf.grouped_ffn_plain(px, eid, p1, p2)[..., :D]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if D % 8 == 0 and F % 8 == 0:
        assert gf._pad_widths(xt, w1, w2)[0] is xt


def test_build_includes_csrc_and_hashes_its_headers(monkeypatch, tmp_path):
    """Every csrc/*.cuh is on nvcc's include path and in the source hash:
    an edit to a shared header builds a new library."""
    csrc, home = tmp_path / "csrc", tmp_path / "cuda"
    csrc.mkdir()
    (home / "bin").mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    log = tmp_path / "nvcc.log"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ $# -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi\n'
        '  shift\n'
        'done\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    assert _build.headers() == [csrc / "common.cuh"]
    first = _build.load_library("k", ("k.cu",))
    calls = log.read_text().splitlines()
    assert len(calls) == 1 and f"-I {csrc}" in calls[0]
    monkeypatch.setattr(_build, "_LIBS", {})
    assert _build.load_library("k", ("k.cu",)) == first   # cached build
    assert len(log.read_text().splitlines()) == 1
    (csrc / "common.cuh").write_text("// v2\n")
    monkeypatch.setattr(_build, "_LIBS", {})
    second = _build.load_library("k", ("k.cu",))
    assert second != first
    assert len(log.read_text().splitlines()) == 2


def test_flash_decode_head_dim_buckets():
    """K3 takes every head dim from 1 up to 256 at run time inside a built
    bucket of 32, 64, 128 or 256 (odd ones too); anything else is refused
    by name."""
    assert [fd.head_dim_bucket(d) for d in (2, 8, 32, 34, 64, 66, 128, 7,
                                            130, 136, 256, 1)] == \
        [32, 32, 32, 64, 64, 128, 128, 32, 256, 256, 256, 32]
    for bad in (0, 258):
        with pytest.raises(ValueError, match=f"head_dim {bad}: .* up to 256"):
            fd.head_dim_bucket(bad)
