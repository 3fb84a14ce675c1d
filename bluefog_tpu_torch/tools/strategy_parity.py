"""The strategy layer on the card against the same code on the CPU:
``chip_smoke.py`` phases 15a-15b and the card tests of
``tests/test_torch_gpu_strategies.py`` run :func:`codec_parity` and
:func:`strategy_parity`, then :func:`check_codecs` and
:func:`check_strategies`.

* Codecs (15a): seeded f32 buffers ``[8, 2^20]`` (rows from 1e-3 to 1e4
  in magnitude, an all-zero row, a row of subnormals) encoded for every
  codec on both devices, one scale set a rank.  Payload bytes, scales
  and decodes must be bit-identical; the subnormal row's scale may
  differ (a device that flushes the subnormal amax rides scale 1, one
  that keeps it the floored scale), but both quantizers must store and
  decode a zero row (bf16 keeps the subnormals, bit for bit).
* Strategies (15b): the benchmark example's ``--model mlp`` (features
  256, 128, 10 on 64 inputs) at 8 ranks with seeded data that differs by
  rank, 5 steps of each of :data:`VARIANTS`, on the card (TF32 off) and
  on the CPU, plus a float64 CPU run as the reference.  Each leaf of the
  card's params is within 1e-5 x max|leaf| of the CPU's, or within twice
  the CPU f32 run's own distance from the reference (the floor: where a
  quantized wire rounds a value at a tie on one side and not the other,
  one code step moves a leaf by far more than 1e-5, and the f32 CPU run
  shows the same kind of step against the float64 one); push-sum's
  weights sum to n within 1e-6 x n; ``zero_allreduce`` equals
  ``gradient_allreduce`` within 1e-6 x max|param|; and the
  gradient-averaging strategies (``gradient_allreduce``,
  ``zero_allreduce``, ``powersgd``) leave every rank bit-equal.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..examples import benchmark as ex
from ..fusion import tree_flatten
from ..ops import collectives as coll
from ..parallel import context as ctx

CODECS = ("bf16", "int8", "int8@256", "fp8", "fp8@64")
# (id, --dist-optimizer, --atc, --dynamic-topology, --wire)
VARIANTS = (
    ("awc", "neighbor_allreduce", False, False, None),
    ("atc", "neighbor_allreduce", True, False, None),
    ("dynamic", "neighbor_allreduce", False, True, None),
    ("wire_bf16", "neighbor_allreduce", False, False, "bf16"),
    ("wire_int8", "neighbor_allreduce", False, False, "int8"),
    ("gradient_allreduce", "gradient_allreduce", False, False, None),
    ("allreduce", "allreduce", False, False, None),
    ("empty", "empty", False, False, None),
    ("hierarchical", "hierarchical_neighbor_allreduce", False, False, None),
    ("win_put", "win_put", False, False, None),
    ("pull_get", "pull_get", False, False, None),
    ("push_sum", "push_sum", False, False, None),
    ("choco", "choco", False, False, None),
    ("zero_allreduce", "zero_allreduce", False, False, None),
    ("powersgd", "powersgd", False, False, None),
)
GRADIENT_AVERAGING = ("gradient_allreduce", "zero_allreduce", "powersgd")
LEAF_TOL = 1e-5
PUSH_SUM_TOL = 1e-6
ZERO_TOL = 1e-6


def argv(variant, *extra: str) -> list:
    """The example's command line for a variant."""
    _, name, atc, dynamic, wire = variant
    return (["--dist-optimizer", name] + (["--atc"] if atc else [])
            + (["--dynamic-topology"] if dynamic else [])
            + (["--wire", wire] if wire else []) + list(extra))


# ---------------------------------------------------------------------------
# 15a: codecs
# ---------------------------------------------------------------------------

def codec_buffers(width: int = 2 ** 20, seed: int = 0) -> np.ndarray:
    """``[8, width]`` f32: rows 0-5 at magnitudes 1e-3 ... 1e4, row 6 all
    zero, row 7 subnormals."""
    rng = np.random.default_rng(seed)
    x = np.empty((8, width))
    x[:6] = rng.normal(size=(6, width)) * np.logspace(-3, 4, 6)[:, None]
    x[6] = 0.0
    x[7] = rng.normal(size=width) * 1e-42
    x = x.astype(np.float32)
    assert 0 < np.abs(x[7]).max() < np.finfo(np.float32).tiny
    return x


def _raw(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        t = t.view(torch.int16 if t.element_size() == 2 else torch.uint8)
    return t.numpy()


def codec_parity(device, width: int = 2 ** 20) -> Dict:
    """Every codec's parts and decode on ``device`` against the CPU,
    rank by rank; the subnormal row (7) is reported apart."""
    x = codec_buffers(width)
    out = {"width": width, "codecs": {}}
    for wire in CODECS:
        parts = {}
        for where in (device, "cpu"):
            xt = torch.from_numpy(x).to(where)
            enc = coll._wire_encode(wire, xt, lead=1)
            dec = coll._wire_decode(wire, enc, torch.float32, shape=xt.shape,
                                    lead=1)
            parts[str(where)] = [_raw(p) for p in enc] + [_raw(dec)]
        card, cpu = parts[str(device)], parts["cpu"]
        names = (["payload"] + (["scale"] if len(card) == 3 else [])
                 + ["decode"])
        rows = {}
        for name, a, b in zip(names, card, cpu):
            diff = (a.reshape(8, -1) != b.reshape(8, -1)).any(axis=1)
            rows[name] = [int(r) for r in np.flatnonzero(diff)]
        dec7 = card[-1].reshape(8, -1)[7], cpu[-1].reshape(8, -1)[7]
        out["codecs"][wire] = {
            "rows_differing": rows,
            # the quantizers' floor; bf16 keeps subnormals (its payload
            # is held bit for bit above)
            "subnormal_row_decodes_zero": wire == "bf16" or bool(
                not np.any(dec7[0]) and not np.any(dec7[1])),
            "zero_row_decodes_zero": bool(
                not np.any(card[-1].reshape(8, -1)[6])),
        }
    return out


def check_codecs(summary: Dict) -> None:
    for wire, row in summary["codecs"].items():
        for name, bad in row["rows_differing"].items():
            allowed = [7] if name == "scale" else []
            if any(r not in allowed for r in bad):
                raise AssertionError(f"codec {wire}: {name} differs between "
                                     f"the card and the CPU on rows {bad}")
        if not (row["subnormal_row_decodes_zero"]
                and row["zero_row_decodes_zero"]):
            raise AssertionError(f"codec {wire}: the zero or subnormal row "
                                 f"does not decode to zeros: {row}")


# ---------------------------------------------------------------------------
# 15b: every strategy, card against CPU
# ---------------------------------------------------------------------------

def mlp_batch(n: int, batch: int, seed: int, dtype, device):
    """Rank-varying data for the example's MLP: ``[n, batch, 64]`` images
    and ``[n, batch]`` labels from ``seed``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, batch, 64))).to(dtype)
    y = torch.from_numpy(rng.integers(0, 10, size=(n, batch)))
    return x.to(device), y.to(device)


def run_variant(variant, device, dtype=torch.float32, steps: int = 5,
                n: int = 8, batch: int = 32, seed: int = 0) -> Dict:
    """``steps`` steps of the example's MLP under ``variant``; the final
    params (float64, on the host), the losses and push-sum's weights."""
    args = ex.parse(["--model", "mlp", "--ranks", str(n), "--batch-size",
                     str(batch), "--device", str(device)] + argv(variant))
    try:
        b = ex.build(args, batch=mlp_batch(n, batch, seed, dtype, device),
                     dtype=dtype)
        params, state = b.params, b.state
        losses = []
        for _ in range(steps):
            params, state, loss = b.step(params, state, b.batch)
            losses.append(loss.detach().double().cpu())
        out = {"params": [p.detach().double().cpu()
                          for p in tree_flatten(params)[0]],
               "losses": torch.stack(losses)}
        if variant[1] == "push_sum":
            out["p"] = [w.value.detach().double().cpu()
                        for w in state.comm_state[1]]
        return out
    finally:
        ctx.shutdown()


def _rank_spread(leaves) -> float:
    return max(float((x - x[:1]).abs().max()) for x in leaves)


def strategy_parity(device, variants: Sequence = VARIANTS,
                    steps: int = 5) -> Dict:
    """Each variant on ``device`` and on the CPU (f32), and on the CPU in
    float64: per variant the worst leaf error against the CPU over the
    allowed bound, the floor, push-sum's mass, the rank spread."""
    rows, card_runs = {}, {}
    for v in variants:
        card = run_variant(v, device, steps=steps)
        cpu = run_variant(v, "cpu", steps=steps)
        ref = run_variant(v, "cpu", torch.float64, steps=steps)
        worst, worst_leaf = 0.0, None
        for i, (a, b, r) in enumerate(zip(card["params"], cpu["params"],
                                          ref["params"])):
            err = float((a - b).abs().max())
            floor = float((b - r).abs().max())
            bound = max(LEAF_TOL * float(b.abs().max()), 2 * floor)
            ratio = err / bound if bound else (0.0 if err == 0 else np.inf)
            if ratio >= worst:
                worst, worst_leaf = ratio, {"leaf": i, "err": err,
                                            "floor": floor, "bound": bound}
        row = {"worst_err_over_bound": worst, "worst_leaf": worst_leaf,
               "loss_first": float(card["losses"][0].mean()),
               "loss_last": float(card["losses"][-1].mean()),
               "rank_spread": _rank_spread(card["params"])}
        if "p" in card:
            row["p_sum_minus_n"] = max(abs(float(p.sum()) - 8)
                                       for p in card["p"])
        rows[v[0]] = row
        card_runs[v[0]] = card
    if "zero_allreduce" in card_runs and "gradient_allreduce" in card_runs:
        z, g = card_runs["zero_allreduce"], card_runs["gradient_allreduce"]
        rows["zero_allreduce"]["vs_gradient_allreduce_rel"] = max(
            float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(z["params"], g["params"]))
    return {"device": str(device), "steps": steps, "variants": rows}


def check_strategies(summary: Dict, n: int = 8) -> None:
    for tag, row in summary["variants"].items():
        if not row["worst_err_over_bound"] <= 1.0:
            raise AssertionError(f"{tag}: a leaf differs between the card "
                                 f"and the CPU past its bound: "
                                 f"{row['worst_leaf']}")
        if not np.isfinite(row["loss_last"]):
            raise AssertionError(f"{tag}: the loss is not finite")
        if "p_sum_minus_n" in row and not \
                row["p_sum_minus_n"] <= PUSH_SUM_TOL * n:
            raise AssertionError(f"{tag}: push-sum's weights sum to n + "
                                 f"{row['p_sum_minus_n']}")
        if tag in GRADIENT_AVERAGING and row["rank_spread"] != 0.0:
            raise AssertionError(f"{tag}: the ranks differ by "
                                 f"{row['rank_spread']}")
    z = summary["variants"].get("zero_allreduce", {})
    if "vs_gradient_allreduce_rel" in z and not \
            z["vs_gradient_allreduce_rel"] <= ZERO_TOL:
        raise AssertionError(f"zero_allreduce differs from "
                             f"gradient_allreduce by "
                             f"{z['vs_gradient_allreduce_rel']}")


def flat_summary(summary: Dict) -> Dict:
    """The summary without the per-leaf details, for a log line."""
    return {**summary, "variants": {
        tag: {k: v for k, v in row.items() if k != "worst_leaf"}
        for tag, row in summary["variants"].items()}}
