"""The port's model zoo against the flax models, on the CPU.

Every model of ``bluefog_tpu/models`` (MLP, MnistCNN, VGG11 at hidden 64,
ResNet18/34/50 at ``num_filters=8``; 32 x 32 images, 10 classes) runs on
``variables_from_jax`` of the same seeded variables in the tree of flax's
own init, and the same seeded inputs (distinct images in every row:
identical ones make the last stage's train-mode BatchNorm see zero
variance).  Tolerances:

* f32: logits within 1e-5 x max|ref| of flax's f32 model (MLP,
  MnistCNN, VGG11).  For the ResNets, the port's f32 error against the
  same flax model run in float64 (every ``float32`` of the model's
  module read as ``float64`` under ``jax.enable_x64``), logits and new
  ``batch_stats``, is within 1e-5 x max|ref| or twice flax's own f32
  error, whichever is larger, so the reference alone sets the floor;
  through train-mode BatchNorm over 4 images flax's error is up to
  ~5e-4 x max|ref| for a ResNet-50 with BatchNorm scales away from 0;
* bf16: the port's gap to flax's bf16 model at most twice flax's own
  bf16-against-f32 gap on the same input;
* gradients of bench.py's loss (f32, ResNet18 and ResNet50, every
  BatchNorm scale and bias drawn so that no gradient leaf is 0), the
  port's ReLUs and max pool taking the sides of flax's f32 run: each
  leaf's error against flax's float64 gradient within 1e-5 x max|g| or
  twice flax's own f32 error of that leaf, whichever is larger.

Dropout cannot share JAX's random stream, so the train-mode cases of the
dropout models hand flax the masks the port's generator draws (in the
same order, through ``layers.dropout_mask``).  Also: flax's asymmetric
"SAME" padding at stride 2, flax's BatchNorm (momentum 0.9 meaning ``ra
<- 0.9 ra + 0.1 batch``, the biased fast variance), the round trip of
``variables_from_jax`` / ``variables_to_jax`` and the port's own init.
"""
import types
from unittest import mock

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bluefog_tpu import models as jm
from bluefog_tpu.models import resnet as jresnet
from bluefog_tpu.models import vgg as jvgg
from bluefog_tpu_torch import models as tm
from bluefog_tpu_torch.models import layers as tl
from bluefog_tpu_torch.tools import resnet_parity
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

CLASSES, NF, B = 10, 8, 4
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f64": jnp.float64}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
RESNETS = {"resnet18": (jm.ResNet18, tm.ResNet18),
           "resnet34": (jm.ResNet34, tm.ResNet34),
           "resnet50": (jm.ResNet50, tm.ResNet50)}


def _models(name, dt="f32"):
    """(flax model, port model, input shape, train kwarg?)"""
    if name == "mlp":
        return jm.MLP(), tm.MLP(in_features=32 * 32 * 3), (B, 32, 32, 3), \
            False
    if name == "cnn":
        return jm.MnistCNN(num_classes=CLASSES), tm.MnistCNN(CLASSES), \
            (B, 28, 28, 1), True
    if name == "vgg11":
        return (jm.VGG11(hidden=64, num_classes=CLASSES, dtype=JDT[dt]),
                tm.VGG11(hidden=64, num_classes=CLASSES, dtype=TDT[dt],
                         image_size=32), (B, 32, 32, 3), True)
    jcls, tcls = RESNETS[name]
    return (jcls(num_classes=CLASSES, num_filters=NF, dtype=JDT[dt]),
            tcls(num_classes=CLASSES, num_filters=NF, dtype=TDT[dt]),
            (B, 32, 32, 3), True)


def _images(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _draw(path, shape, rng):
    """A seeded value for one flax leaf: kernels at the LeCun scale, and
    BatchNorm scales, biases and statistics away from their init (flax's
    own init zeroes each block's last scale, which would leave the block's
    branch out of the output)."""
    leaf = path[-1].key
    if leaf == "kernel":
        return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
    if leaf in ("scale", "var"):
        return rng.uniform(0.5, 1.5, size=shape)
    return 0.1 * rng.normal(size=shape)


@pytest.fixture(scope="module")
def flax_vars():
    """Every model's variables in flax's tree (the structure of its own
    ``init``, by ``jax.eval_shape``) with seeded values."""
    cache = {}

    def get(name):
        if name not in cache:
            jmod, _, shape, has_train = _models(name)
            kw = {"train": False} if has_train else {}
            tree = jax.eval_shape(lambda: jmod.init(
                jax.random.key(0), jnp.zeros(shape), **kw))
            rng = np.random.default_rng(len(name))
            cache[name] = jax.tree_util.tree_map_with_path(
                lambda p, a: _draw(p, a.shape, rng).astype(np.float32),
                tree)
        return cache[name]
    return get


def _exact_jit(fn, *args):
    """``jax.jit(fn)(*args)`` compiled without XLA's excess precision, so
    every bf16 op rounds as it does op by op (and as in the port); at
    backend optimization level 0, which compiles these models ~3x
    faster."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False,
         "xla_backend_optimization_level": 0})(*args)


class _Numpy64(types.SimpleNamespace):
    """``jax.numpy`` with ``float32`` read as ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _flax64(fn, *args):
    """``fn(*args)`` with jax's float64 on and the flax models' fixed
    ``float32`` layers (BatchNorm, the heads, the logits' cast) in
    float64; float inputs and variables go in as float64."""
    as64 = lambda a: (np.asarray(a, np.float64)
                      if np.issubdtype(np.asarray(a).dtype, np.floating)
                      else np.asarray(a))
    with jax.enable_x64(True), \
            mock.patch.object(jresnet, "jnp", _Numpy64()), \
            mock.patch.object(jvgg, "jnp", _Numpy64()):
        return fn(*jax.tree.map(as64, args))


def _run_flax(jmod, v, x, has_train, trains, masks):
    """flax's (logits, new batch_stats or None) for each of ``trains``,
    from one program; dropout draws the port's ``masks``."""
    def run(v, x):
        out = []
        for train in trains:
            if not has_train:
                out.append((jmod.apply(v, x), None))
            elif not train:
                out.append((jmod.apply(v, x, train=False), None))
            elif "batch_stats" in v:
                logits, new = jmod.apply(v, x, train=True,
                                         mutable=["batch_stats"])
                out.append((logits, new))
            else:
                out.append((jmod.apply(v, x, train=True, rngs={
                    "dropout": jax.random.key(1)}), None))
        return out
    real = jax.random.bernoulli
    it = iter(masks)
    jax.random.bernoulli = lambda key, p, shape: jnp.asarray(next(it))
    try:
        out = _exact_jit(run, v, x)
    finally:
        jax.random.bernoulli = real
    return [jax.tree.map(np.asarray, o) for o in out]


def _run_port(tmod, v, x, has_train, train, seed=5):
    """The port's logits and new batch_stats as numpy."""
    kw = {}
    if has_train:
        kw["train"] = train
        if "batch_stats" not in v and train:
            kw["generator"] = torch.Generator().manual_seed(seed)
    x = torch.from_numpy(x)
    with torch.no_grad():
        out = tmod.apply(v, x, **kw)
    if isinstance(out, tuple):
        logits, new = out
        return logits.numpy(), jax.tree.map(lambda t: t.numpy(), new)
    return out.numpy(), None


def _masks(name, seed=5):
    """The dropout masks the port draws (same generator, same order)."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"cnn": [((B, 12, 12, 64), 0.75), ((B, 128), 0.5)],
              "vgg11": [((B, 64), 0.5), ((B, 64), 0.5)]}.get(name, [])
    return [tl.dropout_mask(s, keep, g).numpy() for s, keep in shapes]


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


CASES = ([("mlp", "f32", False)]
         + [("cnn", "f32", t) for t in (True, False)]
         + [(m, dt, t) for m in ("vgg11", *RESNETS) for dt in ("f32", "bf16")
            for t in (True, False)])


@pytest.fixture(scope="module")
def flax_outputs(flax_vars):
    """flax's logits and new batch_stats for every case of a model, on the
    same input (the f32 ones are the bf16 cases' references too), and
    the f32 cases' float64 runs (the f32 cases' floors)."""
    cache = {}

    def get(name):
        if name not in cache:
            v = flax_vars(name)
            out = {}
            for dt in ("f32", "bf16", "f64"):
                trains = [t for n, d, t in CASES
                          if n == name and d == ("f32" if dt == "f64"
                                                 else dt)]
                if not trains or (dt == "f64" and name not in RESNETS):
                    continue
                jmod, _, shape, has_train = _models(name, dt)
                run = (lambda v, x: _run_flax(jmod, v, x, has_train, trains,
                                              _masks(name)))
                x = _images(shape, seed=1)
                outs = _flax64(run, v, x) if dt == "f64" else run(v, x)
                out.update({(dt, t): o for t, o in zip(trains, outs)})
            cache[name] = out
        return cache[name]
    return get


def _leaves(out):
    logits, stats = out
    return [logits] + (jax.tree.leaves(stats) if stats is not None else [])


@pytest.mark.parametrize("name,dt,train", CASES)
def test_forward_and_batch_stats_match_flax(flax_vars, flax_outputs, name,
                                            dt, train):
    _, tmod, shape, has_train = _models(name, dt)
    pv = tm.variables_from_jax(tmod, flax_vars(name))
    x = _images(shape, seed=1)
    want = flax_outputs(name)[dt, train]
    got = _run_port(tmod, pv, x, has_train, train)
    assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
    if want[1] is not None:
        assert jax.tree.structure(got[1]) == jax.tree.structure(want[1])
    if dt == "f32" and name not in RESNETS:
        assert _gap(got[0], want[0]) <= 1e-5 * np.abs(want[0]).max()
        return
    if dt == "f32":
        # the port's f32 error against flax's float64 run of the same
        # model, at most twice flax's own
        ref = flax_outputs(name)["f64", train]
        for a, b, r in zip(_leaves(got), _leaves(want), _leaves(ref)):
            scale = np.abs(r).max()
            assert _gap(b, r) <= 2e-3 * scale
            tol = max(1e-5 * scale, 2 * _gap(b, r))
            assert _gap(a, r) <= tol, (name, train, _gap(a, r), tol)
        return
    for a, b, r in zip(_leaves(got), _leaves(want),
                       _leaves(flax_outputs(name)["f32", train])):
        floor = _gap(b, r)
        assert floor > 0
        assert _gap(a, b) <= 2 * floor, (name, train, _gap(a, b), floor)


class _KinkRecorder(types.SimpleNamespace):
    """``flax.linen`` with ``relu`` recording where its input is positive
    and ``max_pool`` recording its input, in call order."""

    def __init__(self):
        super().__init__(masks=[], pools=[])

    def __getattr__(self, name):
        return getattr(nn, name)

    def relu(self, x):
        self.masks.append(x > 0)
        return nn.relu(x)

    def max_pool(self, x, *args, **kwargs):
        self.pools.append(x)
        return nn.max_pool(x, *args, **kwargs)


def _bench_loss_grads_flax(jmod, v, x, labels):
    """bench.py's loss and gradients, and the kinks of the run: its ReLU
    masks and the stem's max-pool input."""
    def loss_fn(p):
        rec = _KinkRecorder()
        with mock.patch.object(jresnet, "nn", rec):
            logits, _ = jmod.apply({"params": p,
                                    "batch_stats": v["batch_stats"]}, x,
                                   train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean(), (rec.masks, rec.pools)
    (loss, kinks), g = _exact_jit(jax.value_and_grad(loss_fn, has_aux=True),
                                  v["params"])
    return float(loss), jax.tree.map(np.asarray, g), \
        jax.tree.map(np.asarray, kinks)


def _port_bench_grads(tmod, v, x, labels, kinks):
    """The port's bench loss and gradients, its ReLUs and max pool taking
    flax's sides (``kinks``)."""
    from bluefog_tpu_torch.tools.bench import make_grad_fn
    pv = tm.variables_from_jax(tmod, v)
    with kinks.patched():
        loss, grads = make_grad_fn(tmod)(
            {"params": pv["params"], "bs": pv["batch_stats"]},
            (torch.from_numpy(x), torch.from_numpy(labels)))
    for leaf in jax.tree.leaves(grads["bs"]):
        assert not leaf.any()
    return float(loss), tm.variables_to_jax(
        tmod, {"params": grads["params"]})["params"]


def _replay(masks, pools):
    """flax's kinks for the port: its ReLU masks, and the picks of a 3 x 3
    stride-2 max pool padded (1, 1) on its pool inputs."""
    return resnet_parity.KinkReplay(
        [torch.from_numpy(m) for m in masks],
        [torch.nn.functional.max_pool2d_with_indices(
            torch.from_numpy(p).permute(0, 3, 1, 2), 3, 2, 1)[1]
         for p in pools])


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_bench_loss_gradients_match_flax(name):
    """bench.py's loss and its gradients (f32) at its step 1: the port's
    own init (flax's distributions) with every BatchNorm scale and bias
    drawn (the zero-init last scales would leave every gradient inside
    the residual branches at 0), in flax's layout; 8 seeded images and
    labels.  A ReLU input within f32 rounding of 0 can land on either
    side in two f32 runs, and one such flip moves gradient leaves by
    percents, so the port's ReLUs and max pool take the sides of flax's
    f32 run; where the port's own side differs it must be a near tie,
    and such elements few (``resnet_parity.NEAR_TIE`` and
    ``MAX_FLIP_SHARE``).  No leaf of flax's gradient is all zero, and
    each leaf of the port's is within 1e-5 x max|g| of flax's, or within
    twice that leaf's flax f32-against-float64 gap where that is larger;
    that gap must itself stay under 1e-3 x max|g|."""
    jcls, tcls = RESNETS[name]
    own = tcls(num_classes=CLASSES, num_filters=NF, dtype=torch.float32,
               generator=torch.Generator().manual_seed(4))
    v = tm.variables_to_jax(own, resnet_parity.live_variables(own, seed=4))
    x = _images((8, 32, 32, 3), seed=2)
    labels = np.random.default_rng(3).integers(0, CLASSES, 8)
    run = (lambda dt: lambda v, x, labels: _bench_loss_grads_flax(
        jcls(num_classes=CLASSES, num_filters=NF, dtype=JDT[dt]), v,
        jnp.asarray(x), jnp.asarray(labels)))
    want_loss, want, (masks, pools) = run("f32")(v, x, labels)
    loss64, ref, _ = _flax64(run("f64"), v, x, labels)
    kinks = _replay(masks, pools)
    loss, got = _port_bench_grads(own, v, x, labels, kinks)
    assert kinks.i == len(masks) and kinks.j == len(pools) == 1
    assert kinks.flip_max_rel <= resnet_parity.NEAR_TIE
    assert kinks.flipped <= resnet_parity.MAX_FLIP_SHARE \
        * kinks.elements
    assert abs(loss - loss64) <= max(1e-6 * abs(loss64),
                                     2 * abs(want_loss - loss64))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b, r in zip(jax.tree_util.tree_leaves_with_path(got),
                               jax.tree.leaves(want), jax.tree.leaves(ref)):
        scale = np.abs(r).max()
        where = jax.tree_util.keystr(path)
        assert scale > 0 and np.abs(b).max() > 0, where
        assert _gap(b, r) <= 1e-3 * scale, (where, _gap(b, r), scale)
        tol = max(1e-5 * scale, 2 * _gap(b, r))
        assert _gap(a, r) <= tol, (where, _gap(a, r), scale, tol)


@pytest.mark.parametrize("size", [7, 8])
def test_same_padding_at_stride_2(size):
    """flax pads a 3x3 stride-2 "SAME" conv (0, 1) on an even input and
    (1, 1) on an odd one; the 1x1 stride-2 projection pads nothing."""
    assert tl.same_padding(size, 3, 2) == ((0, 1) if size % 2 == 0
                                           else (1, 1))
    assert tl.same_padding(size, 1, 2) == (0, 0)
    x = _images((2, size, size, 4), seed=size)
    for k in (3, 1):
        jconv = nn.Conv(6, (k, k), (2, 2), padding="SAME", use_bias=False)
        v = jax.tree.map(np.asarray, jconv.init(jax.random.key(k),
                                                jnp.asarray(x)))
        want = np.asarray(jconv.apply(v, jnp.asarray(x)))
        conv = tl.Conv(4, 6, (k, k), (2, 2), use_bias=False)
        with torch.no_grad():
            conv.kernel.copy_(torch.from_numpy(
                np.transpose(v["params"]["kernel"], (3, 2, 0, 1))))
            got = conv(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        assert _gap(got, want) <= 1e-5 * np.abs(want).max()
        if k == 3 and size % 2 == 0:
            # the symmetric padding of torch's own conv is another result
            sym = torch.nn.functional.conv2d(
                torch.from_numpy(x).permute(0, 3, 1, 2), conv.kernel,
                stride=2, padding=1).permute(0, 2, 3, 1).detach().numpy()
            assert _gap(sym, want) > 0.1


def test_batch_norm_is_flax_batch_norm():
    """momentum 0.9 means ``0.9 ra + 0.1 batch``, the running variance
    takes the biased batch variance (not torch's unbiased one), epsilon
    1e-5; output and statistics as flax's ``nn.BatchNorm``, the module's
    own buffers untouched."""
    rng = np.random.default_rng(7)
    x = (0.5 + rng.normal(size=(4, 5, 5, 6))).astype(np.float32)
    jbn = nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    v = {"params": {"scale": jnp.asarray(rng.normal(size=6), jnp.float32),
                    "bias": jnp.asarray(rng.normal(size=6), jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(rng.normal(size=6),
                                             jnp.float32),
                         "var": jnp.asarray(1 + rng.random(6), jnp.float32)}}
    want, new = jbn.apply(v, jnp.asarray(x), use_running_average=False,
                          mutable=["batch_stats"])
    want_eval = jbn.apply(v, jnp.asarray(x), use_running_average=True)
    bn = tl.BatchNorm(6)
    bn.path = "bn"
    with torch.no_grad():
        for k, a in {**v["params"], **v["batch_stats"]}.items():
            getattr(bn, k).copy_(torch.from_numpy(np.asarray(a)))
        updates = {}
        xt = torch.from_numpy(x)
        got = bn(xt, True, updates).numpy()
        evals = bn(xt, False).numpy()
    assert _gap(got, want) <= 1e-5 * np.abs(want).max()
    assert _gap(evals, want_eval) <= 1e-5 * np.abs(want_eval).max()
    for k in ("mean", "var"):
        ref = new["batch_stats"][k]
        assert _gap(updates["bn"][k].numpy(), ref) <= \
            1e-6 * np.abs(ref).max()
    xd = x.astype(np.float64)
    ra_var = np.asarray(v["batch_stats"]["var"], np.float64)
    for ddof, same in ((0, True), (1, False)):
        assert np.allclose(updates["bn"]["var"].numpy(), 0.9 * ra_var
                           + 0.1 * xd.var(axis=(0, 1, 2), ddof=ddof),
                           rtol=1e-5, atol=0) is same
    assert _gap(bn.var.numpy(), v["batch_stats"]["var"]) == 0


NAMES = ["mlp", "cnn", "vgg11", *RESNETS]


@pytest.mark.parametrize("name", NAMES)
def test_variables_round_trip(flax_vars, name):
    _, tmod, _, _ = _models(name)
    v = flax_vars(name)
    back = tm.variables_to_jax(tmod, tm.variables_from_jax(tmod, v))
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        assert a.shape == b.shape and np.array_equal(a, b)
    # the module's own variables have flax's names and torch's layouts
    own = tm.variables_to_jax(tmod, tmod.variables())
    assert jax.tree.structure(own) == jax.tree.structure(v)
    assert [a.shape for a in jax.tree.leaves(own)] == \
        [b.shape for b in jax.tree.leaves(v)]
    # and load back into the module
    tmod.load_variables(tm.variables_from_jax(tmod, v))
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(tm.variables_to_jax(tmod, tmod.variables())),
        jax.tree.leaves(v)))


def test_variables_from_jax_refuses_what_does_not_fit(flax_vars):
    _, tmod, _, _ = _models("resnet18")
    v = flax_vars("resnet18")
    bad = jax.tree.map(lambda a: a, v)
    bad["params"]["stem"]["kernel"] = np.zeros((3, 3, 3, 8), np.float32)
    with pytest.raises(ValueError, match="params/stem/kernel"):
        tm.variables_from_jax(tmod, bad)
    missing = {"params": v["params"]}
    with pytest.raises(ValueError, match="missing"):
        tm.variables_from_jax(tmod, missing)


def test_own_init_follows_flax_distributions():
    """Truncated LeCun normal kernels (std 1 / sqrt(fan_in) within 10 %,
    nothing past two of flax's pre-truncation std), zero biases, BatchNorm
    scale 1 but 0 on each block's last, bias 0, mean 0, var 1; the draw is
    the generator's."""
    model = tm.ResNet50(num_classes=1000, num_filters=16,
                        generator=torch.Generator().manual_seed(0))
    zero_scale = 0
    for name, m in model.named_modules():
        if isinstance(m, tl.BatchNorm):
            last = name.endswith("BatchNorm_2")
            assert torch.all(m.scale == (0.0 if last else 1.0)), name
            zero_scale += last
            assert not m.bias.any() and not m.mean.any()
            assert torch.all(m.var == 1.0)
        if isinstance(m, (tl.Conv, tl.Dense)):
            w = m.kernel.detach().double()
            want = w[0].numel() ** -0.5
            assert float(w.abs().max()) <= 2 * want / 0.87962566103423978 \
                * (1 + 1e-6), name
            if w.numel() >= 4096:
                assert abs(float(w.std()) / want - 1) < 0.1, name
            assert m.bias is None or not m.bias.any()
    assert zero_scale == 16
    small = [tm.ResNet18(num_classes=10, num_filters=8,
                         generator=torch.Generator().manual_seed(seed))
             for seed in (1, 1, 2)]
    assert all(torch.all(getattr(small[0], n).BatchNorm_1.scale == 0)
               for n in small[0].block_names)
    assert torch.equal(small[0].stem.kernel, small[1].stem.kernel)
    assert not torch.equal(small[0].stem.kernel, small[2].stem.kernel)


def test_dropout_is_identity_in_eval_and_needs_a_generator():
    model = tm.MnistCNN(CLASSES, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images((2, 28, 28, 1)))
    with torch.no_grad():
        a = model(x, train=False)
        b = model(x, train=False, generator=torch.Generator())
        assert torch.equal(a, b)
        with pytest.raises(ValueError, match="generator"):
            model(x, train=True)
        g1 = model(x, train=True, generator=torch.Generator().manual_seed(3))
        g2 = model(x, train=True, generator=torch.Generator().manual_seed(3))
        assert torch.equal(g1, g2) and not torch.equal(g1, a)
