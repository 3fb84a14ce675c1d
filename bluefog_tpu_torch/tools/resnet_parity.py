"""A ResNet's first training step on the card against the same step on
the CPU: ``chip_smoke.py`` phase 14a (ResNet-50, 224 x 224) and the card
tests of ``tests/test_torch_gpu_models.py`` (ResNet18/50, 64 x 64) run
:func:`compare` and :func:`check`.

The step is ``bench.py``'s loss (train-mode logits into mean softmax
cross-entropy) with its logits and the gradient of every parameter.
Every model starts from :func:`live_variables`: the model's own init
with every BatchNorm scale and bias drawn from a seed.  The zero-init
last scale of each block would give every conv and BatchNorm inside the
residual branches a gradient of exactly 0 on both sides, so
:func:`check` also refuses a compared gradient leaf that is all zero.
The reference is the CPU's float64 run (every conv and BatchNorm in
float64; the head and the logits in f32, as the model defines them).
The gates:

* f32 (cuDNN's TF32 off): the card's error against the reference, of
  the loss (relative), the logits and each gradient leaf (each over its
  own max), within 1e-5 (loss) or 1e-4, or within twice the CPU f32
  run's own error against the reference where that is larger: the
  floor is set by the reference side alone.  The f32 pair's direct gaps
  are reported beside;
* bf16: the card-against-CPU gap of the loss, the logits and each leaf
  at most twice the card's own bf16-against-f32 gap.

A pre-activation within rounding of 0, or two max-pool inputs within
rounding of each other, can fall on either side in two runs that sum in
other orders, and one such flip moves gradient leaves by up to
percents.  Both f32 runs therefore replay the reference's ReLU masks
and max-pool picks (:class:`KinkReplay`); every element where a run's
own side differs must be a near tie (:data:`NEAR_TIE`), and such
elements few (:data:`MAX_FLIP_SHARE` of the kink elements).  The bf16
runs are free: their rounding moves pre-activations by far more than a
near tie, so no replay could be checked.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from ..fusion import tree_flatten, tree_map
from ..models.layers import BatchNorm

# How near a tie (|x| / max|x| of a ReLU input, |gap| / max|x| of a pool
# pick) an f32 run's element that left the reference's side may be, and
# the most such elements, as a share of all ReLU and max-pool elements
# of the step.  Set from the readings: on an H100 (chip_smoke.py phase
# 14a and the card tests, card and CPU runs) at most 2.74e-5 (about 460
# f32 ulps of max|x|) and a share of at most 3.75e-6 (121-129 of 39.2 M
# elements in 14a); in the CPU tests against flax one element of
# 200,192 (5.0e-6) at 1.18e-6.  The limits are about 3.6x and 2x the
# largest.
NEAR_TIE = 1e-4
MAX_FLIP_SHARE = 1e-5
F32_LOSS_RTOL, F32_REL = 1e-5, 1e-4


class KinkReplay:
    """ReLU masks and max-pool picks of one ResNet run (recorded when
    built without ``masks``), forced onto others (built with them, as
    :meth:`replayer` does).  Where a replayed run's own side differs, it
    records how many elements flipped (``flipped``) and how near the tie
    was (``flip_max_rel``); it counts every kink element it sees
    (``elements``)."""

    def __init__(self, masks=None, picks=None):
        self.replay = masks is not None
        self.masks = [] if masks is None else masks
        self.picks = [] if picks is None else picks
        self.i = self.j = 0
        self.flipped, self.elements, self.flip_max_rel = 0, 0, 0.0

    def replayer(self) -> "KinkReplay":
        """A replay of this run's kinks, with counts of its own."""
        return KinkReplay(self.masks, self.picks)

    def _flip(self, n: int, rel: float) -> None:
        self.flipped += n
        self.flip_max_rel = max(self.flip_max_rel, rel)

    def relu(self, x):
        if not self.replay:
            self.masks.append((x > 0).cpu())
            return torch.relu(x)
        mask = self.masks[self.i].to(x.device)
        self.i += 1
        self.elements += x.numel()
        xd = x.detach()
        diff = (xd > 0) != mask
        if diff.any():
            self._flip(int(diff.sum()), float(xd[diff].abs().max()
                                              / xd.abs().max()))
        return x * mask.to(x.dtype)

    def max_pool2d(self, x, kernel_size, stride, padding=0):
        own, idx = F.max_pool2d_with_indices(x, kernel_size, stride,
                                             padding)
        if not self.replay:
            self.picks.append(idx.cpu())
            return own
        pick = self.picks[self.j].to(x.device)
        self.j += 1
        self.elements += own.numel()
        y = x.flatten(2).gather(2, pick.flatten(2)).view_as(own)
        diff = pick != idx
        if diff.any():
            self._flip(int(diff.sum()), float((y - own).detach().abs().max()
                                              / x.detach().abs().max()))
        return y

    @contextlib.contextmanager
    def patched(self):
        from ..models import resnet
        with mock.patch.object(resnet.F, "relu", self.relu), \
                mock.patch.object(resnet.F, "max_pool2d", self.max_pool2d):
            yield


@contextlib.contextmanager
def cudnn_tf32(allow: bool):
    """cuDNN's TF32 convolutions on or off for the block."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def live_variables(model, seed: int = 0) -> Dict:
    """``model.variables()`` (copies) with every BatchNorm scale drawn
    from U(0.5, 1.5) and every bias from 0.1 N(0, 1), seeded."""
    v = tree_map(lambda t: t.clone(), model.variables())
    rng = np.random.default_rng(seed)
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            node = v["params"]
            for part in name.split("."):
                node = node[part]
            c = m.scale.shape
            node["scale"] = torch.from_numpy(
                rng.uniform(0.5, 1.5, c).astype(np.float32))
            node["bias"] = torch.from_numpy(
                (0.1 * rng.normal(size=c)).astype(np.float32))
    return v


def leaf_names(tree, prefix=()) -> List[str]:
    """``a/b/c`` names of a nested dict's leaves, in ``tree_flatten``
    order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += leaf_names(tree[k], prefix + (k,))
        else:
            out.append("/".join(prefix + (k,)))
    return out


def step1(model, variables, x, labels, device,
          kinks: Optional[KinkReplay] = None):
    """bench.py's loss at step 1 on ``device``: ``(loss, logits, grads)``
    as float64 numpy (grads a list in the params' leaf order)."""
    v = tree_map(lambda t: t.to(device), variables)
    params = tree_map(lambda p: p.detach().requires_grad_(), v["params"])
    with kinks.patched() if kinks else contextlib.nullcontext():
        logits, _ = model.apply({"params": params,
                                 "batch_stats": v["batch_stats"]},
                                x.to(device), train=True)
    loss = F.cross_entropy(logits, labels.to(device))
    grads = torch.autograd.grad(loss, tree_flatten(params)[0])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    as64 = lambda t: t.detach().double().cpu().numpy()
    return as64(loss), as64(logits), [as64(g) for g in grads]


def _gap(a, b) -> float:
    return float(np.abs(a - b).max())


def _rel(a, b) -> float:
    return _gap(a, b) / max(float(np.abs(b).max()), 1e-30)


def compare(models: Dict[str, torch.nn.Module], variables, x, labels,
            device) -> Dict:
    """Run ``models["f64"]`` on the CPU (the reference, recording its
    kinks), ``models["f32"]`` on ``device`` and on the CPU (both
    replaying the reference's kinks) and ``models["bf16"]`` on both (free
    runs), all on ``variables``; the summary of every gap, its gate and
    the kink flips, with the gates' failures under ``"failures"``."""
    names = leaf_names(variables["params"])
    card = "cpu" if torch.device(device).type == "cpu" else "card"
    runs, secs, kinks = {}, {}, {}
    ref = KinkReplay()
    as64 = lambda t: t.double()
    plan = [("f64", "cpu", ref)] + [
        ("f32", dev, ref.replayer()) for dev in (device, "cpu")] + [
        ("bf16", dev, None) for dev in (device, "cpu")]
    for dt, dev, k in plan:
        where = "cpu" if dev == "cpu" else card
        key = f"{dt}_{where}"
        v = tree_map(as64, variables) if dt == "f64" else variables
        t0 = time.monotonic()
        with cudnn_tf32(dt == "bf16"):
            runs[key] = step1(models[dt], v, as64(x) if dt == "f64" else x,
                              labels, dev, k)
        secs[key] = time.monotonic() - t0
        if k is not None and dt == "f32":
            kinks[key] = k
    c32, h32, h64 = runs[f"f32_{card}"], runs["f32_cpu"], runs["f64_cpu"]
    cbf, hbf = runs[f"bf16_{card}"], runs["bf16_cpu"]
    # the card's f32 error against the float64 reference, and the CPU's
    f32_leaf = [(_rel(a, r), _rel(b, r), _rel(a, b))
                for a, b, r in zip(c32[2], h32[2], h64[2])]
    bf_leaf = [(_gap(a, b), _gap(a, r))
               for a, b, r in zip(cbf[2], hbf[2], c32[2])]
    zero = [n for n, a, b in zip(names, c32[2], h64[2])
            if not (a.any() and b.any())]
    s = {
        "seconds": secs,
        "loss": {key: float(v[0]) for key, v in runs.items()},
        "kink_elements": {key: k.elements for key, k in kinks.items()},
        "kink_flipped": {key: k.flipped for key, k in kinks.items()},
        "kink_flip_share": {key: k.flipped / max(k.elements, 1)
                            for key, k in kinks.items()},
        "kink_flip_max_rel": {key: k.flip_max_rel
                              for key, k in kinks.items()},
        "near_tie": NEAR_TIE, "max_flip_share": MAX_FLIP_SHARE,
        "f32_loss_err": _rel(c32[0], h64[0]),
        "f32_loss_floor": _rel(h32[0], h64[0]),
        "f32_logits_err": _rel(c32[1], h64[1]),
        "f32_logits_floor": _rel(h32[1], h64[1]),
        "f32_logits_pair": _rel(c32[1], h32[1]),
        "f32_grad_err_max": max(e for e, _, _ in f32_leaf),
        "f32_grad_floor_max": max(f for _, f, _ in f32_leaf),
        "f32_grad_pair_max": max(p for _, _, p in f32_leaf),
        "f32_grad_err_over_gate_max": max(
            e / max(F32_REL, 2 * f) for e, f, _ in f32_leaf),
        "zero_grad_leaves": zero,
        "bf16_loss_gap": _gap(cbf[0], hbf[0]),
        "bf16_loss_floor": _gap(cbf[0], c32[0]),
        "bf16_logits_gap": _gap(cbf[1], hbf[1]),
        "bf16_logits_floor": _gap(cbf[1], c32[1]),
        "bf16_grad_ratio_max": max(g / f if f else (0.0 if g == 0 else
                                                    float("inf"))
                                   for g, f in bf_leaf),
        "per_leaf": {n: {"f32_err": e, "f32_floor": f, "f32_pair": p,
                         "bf16_gap": g, "bf16_floor": fl}
                     for n, (e, f, p), (g, fl) in zip(names, f32_leaf,
                                                      bf_leaf)}}
    fail = []
    for key in kinks:
        if s["kink_flip_max_rel"][key] > NEAR_TIE:
            fail.append(f"{key}: a ReLU / max-pool kink differs from the "
                        f"float64 run's away from a near tie: "
                        f"{s['kink_flip_max_rel'][key]} > {NEAR_TIE}")
        if s["kink_flip_share"][key] > MAX_FLIP_SHARE:
            fail.append(f"{key}: {s['kink_flipped'][key]} of "
                        f"{s['kink_elements'][key]} kink elements differ "
                        f"from the float64 run's (> {MAX_FLIP_SHARE} of "
                        f"them)")
    if zero:
        fail.append(f"gradient leaves all zero: {zero[:5]}")
    for what, err, floor, gate in [
            ("loss", s["f32_loss_err"], s["f32_loss_floor"], F32_LOSS_RTOL),
            ("logits", s["f32_logits_err"], s["f32_logits_floor"], F32_REL)
    ] + [(n, e, f, F32_REL) for n, (e, f, _) in zip(names, f32_leaf)]:
        if err > max(gate, 2 * floor):
            fail.append(f"f32 {what}: the card's error against float64 "
                        f"{err} x max > {gate} and > twice the CPU's "
                        f"{floor}")
    for what, g, f in [("loss", s["bf16_loss_gap"], s["bf16_loss_floor"]),
                       ("logits", s["bf16_logits_gap"],
                        s["bf16_logits_floor"])] + [
            (n, g, f) for n, (g, f) in zip(names, bf_leaf)]:
        if g > 2 * f:
            fail.append(f"bf16 {what}: card-vs-CPU gap {g} > twice the "
                        f"bf16-vs-f32 gap {f}")
    s["failures"] = fail
    return s


def check(summary: Dict) -> None:
    """Raise if any gate of :func:`compare` failed."""
    if summary["failures"]:
        raise AssertionError("; ".join(summary["failures"]))
