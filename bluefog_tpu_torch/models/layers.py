"""flax.linen layers as torch modules, and the variables of a flax model.

The model zoo (:mod:`.mlp`, :mod:`.cnn`, :mod:`.vgg`, :mod:`.resnet`)
builds on these counterparts of ``nn.Dense``, ``nn.Conv``,
``nn.BatchNorm`` and ``nn.Dropout``:

* Parameters keep flax's names (``kernel``, ``bias``, ``scale``) and
  submodules flax's auto names (``Conv_0``, ``BatchNorm_1``, ``Dense_0``),
  so a dotted state-dict name is a flax path.  Layouts are torch's: a conv
  kernel is ``[O, I, kH, kW]`` (flax: HWIO), a dense kernel ``[out, in]``
  (flax: ``[in, out]``).  :func:`variables_from_jax` and
  :func:`variables_to_jax` move a flax ``{"params", "batch_stats"}`` tree
  across.
* Activations are NHWC, as in JAX: BatchNorm, ReLU, the residual adds,
  pooling means and flattens act on contiguous ``[B, H, W, C]`` tensors
  (per-channel vectors broadcast along the innermost dim), and a conv or
  a max pool sees the same bytes as an NCHW tensor in ``channels_last``
  memory (``x.permute(0, 3, 1, 2)``), which is the layout cuDNN wants.
* ``dtype`` is flax's computation dtype: the input and the f32 parameters
  are cast to it and the layer runs in it.  ``None`` is the promoted type
  of input and parameters.
* "SAME" padding is flax's, asymmetric where the stride needs it: ``total
  = max((out - 1) * s + k - in, 0)``, ``lo = total // 2``, ``hi = total -
  lo`` (a 3x3 stride-2 conv on an even input pads (0, 1)).
* BatchNorm is flax's: statistics over N, H and W in f32 (f64 stays
  f64), the fast variance
  ``mean(x^2) - mean(x)^2`` clipped at 0, ``momentum=0.9`` meaning ``ra
  <- 0.9 ra + 0.1 batch`` with the biased batch variance, ``epsilon``
  1e-5, output in that type.  In training the new running statistics are returned
  as new tensors (flax's ``mutable=["batch_stats"]``), never written into
  the module.
* Initialisation draws flax's distributions from an explicit generator:
  truncated LeCun normal (fan in, truncated at two standard deviations)
  for conv and dense kernels, zero biases, BatchNorm scale 1 (or 0 where
  the model says so) and bias 0, running mean 0 and variance 1.

A model's :meth:`FlaxModel.apply` runs it functionally on a variables
tree (``torch.func.functional_call``), so a stacked trainer can hand it
one rank's leaves without copying them into the module.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv", "Dense", "BatchNorm", "Dropout", "FlaxModel",
           "dropout_mask", "same_padding", "nchw",
           "variables_from_jax", "variables_to_jax"]

Padding = Union[str, Sequence[Tuple[int, int]]]

# the standard normal's std once truncated to [-2, 2] (flax's constant)
_TRUNC_STD = 0.87962566103423978


def _trunc_lecun_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal()``: variance_scaling(1, "fan_in",
    "truncated_normal"), so the samples' std is ``1 / sqrt(fan_in)``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


def same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax's "SAME" padding of one spatial dim: ``(lo, hi)``."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def nchw(fn, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """``fn`` (an NCHW op: a conv, a pool) on an NHWC tensor: it sees the
    NCHW view of the same bytes (``channels_last``) and returns NHWC."""
    return fn(x.permute(0, 3, 1, 2), *args, **kwargs).permute(0, 2, 3, 1)


def _compute_dtype(dtype, *tensors) -> torch.dtype:
    if dtype is not None:
        return dtype
    return torch.result_type(*tensors) if len(tensors) > 1 \
        else tensors[0].dtype


class Dense(nn.Module):
    """``flax.linen.Dense``: ``y = x @ kernel.T + bias`` in ``dtype``; the
    bias is added after the product, as flax does."""

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator=None) -> None:
        _trunc_lecun_(self.kernel, self.kernel.shape[1], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.kernel)
        y = F.linear(x.to(dt), self.kernel.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv(nn.Module):
    """``flax.linen.Conv`` over an NHWC input (run as NCHW in
    ``channels_last`` memory): the input and the kernel are cast to
    ``dtype`` and the conv runs in it; the bias (if any) is added after.
    ``padding`` is ``"SAME"``, ``"VALID"`` or explicit ``[(lo, hi), (lo,
    hi)]`` for H and W."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), *,
                 padding: Padding = "SAME", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.kernel = nn.Parameter(
            torch.empty(features, in_features, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator=None) -> None:
        o, i, kh, kw = self.kernel.shape
        _trunc_lecun_(self.kernel, i * kh * kw, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def _pads(self, h: int, w: int) -> Tuple[Tuple[int, int], ...]:
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        if self.padding == "SAME":
            return tuple(same_padding(n, k, s) for n, k, s in zip(
                (h, w), self.kernel_size, self.strides))
        return tuple(tuple(p) for p in self.padding)

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        (hl, hh), (wl, wh) = self._pads(x.shape[2], x.shape[3])
        if hl == hh and wl == wh:
            pad = (hl, wl)
        else:
            x = F.pad(x, (wl, wh, hl, hh))
            pad = (0, 0)
        return F.conv2d(x, w, stride=self.strides, padding=pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.kernel)
        w = self.kernel.to(dtype=dt, memory_format=torch.channels_last)
        y = nchw(self._conv, x.to(dt), w)
        return y if self.bias is None else y + self.bias.to(dt)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5,
    dtype=float32)`` over the channels (last dim) of an NHWC input.

    ``forward(x, train, updates)``: with ``train`` the batch's statistics
    normalise ``x`` and the new running averages go into ``updates[path]``
    as ``{"mean", "var"}`` (detached: flax returns them as aux values);
    without it the running averages normalise ``x``."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, zero_scale: bool = False):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.path = ""                # its dotted name, set by the model

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool,
                updates: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
                ) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            mean = xf.mean((0, 1, 2))
            mean2 = (xf * xf).mean((0, 1, 2))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if updates is not None:
                m = self.momentum
                updates[self.path] = {
                    "mean": (m * self.mean + (1 - m) * mean).detach(),
                    "var": (m * self.var + (1 - m) * var).detach()}
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (xf - mean) * mul + self.bias


def dropout_mask(shape: Sequence[int], keep: float,
                 generator: torch.Generator) -> torch.Tensor:
    """The kept positions of one dropout draw: ``uniform[0, 1) < keep``,
    drawn on the generator's device."""
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device) < keep


class Dropout(nn.Module):
    """``flax.linen.Dropout(rate)``: in training kept values are scaled by
    ``1 / (1 - rate)`` and the rest are 0; otherwise the identity.  The
    mask comes from an explicit generator (flax's ``dropout`` rng)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training needs a torch.Generator "
                             "(generator=...), as flax needs a 'dropout' "
                             "rng")
        keep = 1.0 - self.rate
        mask = dropout_mask(x.shape, keep, generator).to(x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Variables: nested flax-shaped trees of a model's parameters and buffers
# ---------------------------------------------------------------------------

_COLLECTIONS = ("params", "batch_stats")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


def _unflatten(flat: Iterable[Tuple[str, Any]]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, v in flat:
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


class FlaxModel(nn.Module):
    """A model of the zoo: its variables as a flax-shaped tree, and a
    functional ``apply`` on such a tree."""

    def _finish(self, generator: Optional[torch.Generator]) -> None:
        """Draw every layer's initial values and name the BatchNorms."""
        for name, m in self.named_modules():
            if isinstance(m, (Conv, Dense, BatchNorm)):
                m.reset_parameters(generator)
            if isinstance(m, BatchNorm):
                m.path = name

    def variables(self) -> Dict[str, Dict[str, Any]]:
        """``{"params": ..., "batch_stats": ...}`` (the second only if the
        model has BatchNorm) of the module's own tensors, nested by flax
        path."""
        out = {"params": _unflatten(
            (n, p.detach()) for n, p in self.named_parameters())}
        stats = list(self.named_buffers())
        if stats:
            out["batch_stats"] = _unflatten(stats)
        return out

    def load_variables(self, variables: Mapping) -> None:
        """Copy a variables tree into the module's parameters and buffers."""
        flat = {}
        for coll in variables.values():
            flat.update(_flatten(coll))
        self.load_state_dict(flat, strict=True)

    def apply(self, variables: Mapping, *args, **kwargs):
        """``forward`` on the tensors of ``variables`` in place of the
        module's own (``torch.func.functional_call``; nothing is copied)."""
        flat = {}
        for coll in variables.values():
            flat.update(_flatten(coll))
        return torch.func.functional_call(self, flat, args, kwargs)

    def _stats_tree(self, updates: Dict[str, Dict[str, torch.Tensor]]
                    ) -> Dict[str, Any]:
        return _unflatten((f"{path}.{k}", v) for path, d in updates.items()
                          for k, v in d.items())


def _layouts(model: nn.Module) -> Dict[str, str]:
    """Each tensor name of ``model`` -> ``conv`` / ``dense`` / ``plain``."""
    kinds = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            kinds[name] = ("conv" if isinstance(m, Conv)
                           and pname == "kernel" else
                           "dense" if isinstance(m, Dense)
                           and pname == "kernel" else "plain")
    for name, _ in model.named_buffers():
        kinds[name] = "plain"
    return kinds


def _to_port(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":            # [kH, kW, I, O] -> [O, I, kH, kW]
        return arr.transpose(3, 2, 0, 1)
    return arr.T if kind == "dense" else arr     # [in, out] -> [out, in]


def _to_jax(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return arr.transpose(2, 3, 1, 0)
    return arr.T if kind == "dense" else arr


def _check_names(model: nn.Module, variables: Mapping
                 ) -> Dict[str, Tuple[str, np.ndarray]]:
    """Flat ``name -> (collection, array)`` of a flax tree, checked against
    the model's names and (torch-layout) shapes."""
    kinds = _layouts(model)
    own = dict(model.state_dict())
    flat = {}
    for coll in _COLLECTIONS:
        if coll in variables:
            for name, v in _flatten(variables[coll]).items():
                flat[name] = (coll, np.asarray(v))
    unknown = [c for c in variables if c not in _COLLECTIONS]
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if unknown or missing or extra:
        raise ValueError(f"variables do not fit {type(model).__name__}: "
                         f"unknown collections {unknown}, missing "
                         f"{missing[:5]}, extra {extra[:5]}")
    for name, (coll, arr) in flat.items():
        want = tuple(own[name].shape)
        if _to_port(arr, kinds[name]).shape != want:
            raise ValueError(f"{coll}/{name.replace('.', '/')}: shape "
                             f"{arr.shape} does not fit {want} (torch "
                             f"layout)")
    return flat


def variables_from_jax(model: nn.Module, variables: Mapping
                       ) -> Dict[str, Dict[str, Any]]:
    """A flax ``{"params", "batch_stats"}`` tree (numpy-convertible leaves)
    -> the port's variables for ``model``: the same nesting, CPU tensors
    in torch layout (conv HWIO -> OIHW, dense ``[in, out]`` -> ``[out,
    in]``).  Names and shapes must fit the model."""
    kinds = _layouts(model)
    flat = _check_names(model, variables)
    out: Dict[str, Dict[str, Any]] = {}
    for coll in _COLLECTIONS:
        items = [(name, torch.from_numpy(np.array(
                    _to_port(arr, kinds[name]), copy=True)))
                 for name, (c, arr) in flat.items() if c == coll]
        if items:
            out[coll] = _unflatten(items)
    return out


def variables_to_jax(model: nn.Module, variables: Mapping
                     ) -> Dict[str, Dict[str, Any]]:
    """Inverse of :func:`variables_from_jax`: numpy arrays in flax layout."""
    kinds = _layouts(model)
    out: Dict[str, Dict[str, Any]] = {}
    for coll in _COLLECTIONS:
        if coll in variables:
            out[coll] = _unflatten(
                (name, np.ascontiguousarray(_to_jax(
                    v.detach().cpu().numpy(), kinds[name])))
                for name, v in _flatten(variables[coll]).items())
    return out
