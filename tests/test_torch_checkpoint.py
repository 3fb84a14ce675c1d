"""The port's checkpoints (``bluefog_tpu_torch/checkpoint.py``: its own
format, a ``torch.save`` of the tree's host snapshot that
``torch.load(weights_only=True)`` reads, under JAX's directory names and
completion marker) against the JAX package's ``checkpoint.py``:

* the round trip of a tree of tensors (f32, bf16, int, 0-dim) and of a
  whole training state (params, ``DecentralizedState`` with its
  ``torch.optim`` optimizer, the delayed carry), restored into a fresh
  trainer (copied into its tensors): a resume equal bit for bit to the uninterrupted
  run (the 16-16-5 MLP x 8 ranks, CTA + Adam, f32);
* ``keep`` pruning, torn and in-flight (unmarked) directories, which are
  never restored from or deleted; ``restore_latest`` on an empty
  directory;
* ``AsyncSaver``: its snapshot is taken before ``save`` returns (the
  in-place step after it does not reach the file), a background failure
  surfaces at the next ``save`` / ``wait`` and its directory stays
  unmarked;
* ``resize_distributed`` equal to JAX's on the same arrays in every mode,
  exactly (the mean through numpy's float32 mean, as JAX's);
* the serving snapshot, its scan beside the training one, and its
  refusals in JAX's words.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu import checkpoint as jckpt
from bluefog_tpu_torch import checkpoint as ckpt
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch.parallel import context as tctx
import torch_cpu_threads  # noqa: F401  (the worker's thread share)
import torch_oracle as orc

N = 8


def _tree():
    g = torch.Generator().manual_seed(3)
    return {"w": torch.randn(N, 4, 3, generator=g),
            "h": torch.randn(N, 5, generator=g).to(torch.bfloat16),
            "i": torch.arange(N, dtype=torch.int32),
            "s": torch.tensor(7), "n": (1, 2.5, None, "x")}


def _equal(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b


def test_roundtrip_and_weights_only_format(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), tree, step=3)
    assert path.endswith("step_3") and ckpt.is_complete(path)
    doc = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert doc["format"] == ckpt.FORMAT
    _equal(ckpt.restore(path), tree)
    tmpl = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}
    _equal(ckpt.restore(path, template=tmpl), tree)
    with pytest.raises(TypeError, match="cannot checkpoint"):
        ckpt.save(str(tmp_path), {"f": object()}, step=4)


def _trainer():
    x, y, p0 = orc.problem(0)
    strat = topt.adapt_with_combine(
        topt.adam(0.05), topt.neighbor_communicator(
            tctx.static_schedule()), delayed=True)
    params = topt.replicate(
        {k: {n: t.float() for n, t in v.items()}
         for k, v in orc.tensors(p0).items()}, N)
    state = topt.init_distributed(strat, params)
    step = topt.make_train_step(orc.port_grad_fn, strat)
    batch = (torch.from_numpy(x).float(), torch.from_numpy(y))
    return step, params, state, batch


@pytest.fixture
def ctx():
    tctx.init(size=N, device="cpu")
    yield
    tctx.shutdown()


@pytest.mark.parametrize("saver", ["sync", "async"])
def test_resume_equals_the_uninterrupted_run(tmp_path, ctx, saver):
    step, params, state, batch = _trainer()
    for _ in range(2):
        params, state, loss = step(params, state, batch)
    tree = {"params": params, "state": state}
    if saver == "sync":
        ckpt.save(str(tmp_path), tree, step=2, keep=1)
    else:
        s = ckpt.AsyncSaver()
        s.save(str(tmp_path), tree, step=2)
    for _ in range(2):                  # in place: must not reach the file
        params, state, loss = step(params, state, batch)
    if saver == "async":
        s.close()
    # a fresh trainer from another start, then the checkpoint into it
    fstep, fparams, fstate, _ = _trainer()
    for _ in range(3):
        fparams, fstate, _ = fstep(fparams, fstate, batch)
    restored, at = ckpt.restore_latest(
        str(tmp_path), template={"params": fparams, "state": fstate})
    assert at == 2
    rp, rs = restored["params"], restored["state"]
    assert rs.opt_state is fstate.opt_state          # loaded in place
    assert rs.step == 2
    for _ in range(2):
        rp, rs, rl = fstep(rp, rs, batch)
    _equal(rp, params)
    torch.testing.assert_close(rl, loss, rtol=0, atol=0)
    from bluefog_tpu_torch.utils.snapshot import live_tensors
    got, want = live_tensors(rs), live_tensors(state)
    assert len(got) == len(want) > 8
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_keep_prunes_and_never_touches_unmarked_dirs(tmp_path):
    tree = {"x": torch.zeros(N, 2)}
    inflight = tmp_path / "step_0"
    inflight.mkdir()
    (inflight / "partial").write_text("another process, still writing")
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), tree, step=s, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4]
    assert inflight.is_dir()
    with pytest.raises(ValueError, match="keep must be >= 1"):
        ckpt.save(str(tmp_path), tree, step=5, keep=0)
    out, step = ckpt.restore_latest(str(tmp_path / "nothing"))
    assert out is None and step is None


def test_torn_checkpoint_skipped(tmp_path):
    tree = {"x": torch.arange(2 * N, dtype=torch.float32).reshape(N, 2)}
    ckpt.save(str(tmp_path), tree, step=1)
    ckpt.save(str(tmp_path), {"x": tree["x"] + 1}, step=2)
    torn = tmp_path / "step_3"
    torn.mkdir()
    (torn / "state.pt").write_text("truncated mid-write")
    assert ckpt.all_steps(str(tmp_path)) == [1, 2]
    assert ckpt.all_steps(str(tmp_path), include_incomplete=True) == [1, 2, 3]
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert not ckpt.is_complete(str(torn))
    out, at = ckpt.restore_latest(str(tmp_path))
    assert at == 2 and torch.equal(out["x"], tree["x"] + 1)


def test_async_saver_snapshots_before_returning(tmp_path):
    x = torch.ones(N, 3)
    with ckpt.AsyncSaver() as saver:
        p1 = saver.save(str(tmp_path), {"x": x}, step=1)
        x.add_(5)                       # the next step, in place
        saver.save(str(tmp_path), {"x": x}, step=2)
        assert not ckpt.is_complete(os.path.join(str(tmp_path), "step_2"))
    assert ckpt.all_steps(str(tmp_path)) == [1, 2]
    assert torch.equal(ckpt.restore(p1)["x"], torch.ones(N, 3))
    assert torch.equal(ckpt.restore_latest(str(tmp_path))[0]["x"],
                       torch.full((N, 3), 6.0))


def test_async_saver_surfaces_background_errors(tmp_path, monkeypatch):
    real = ckpt._write
    fail = {"on": True}

    def write(path, doc):
        if fail["on"]:
            os.makedirs(path, exist_ok=True)
            raise OSError("disk full on background write")
        real(path, doc)

    monkeypatch.setattr(ckpt, "_write", write)
    saver = ckpt.AsyncSaver()
    tree = {"x": torch.zeros(N, 2)}
    p1 = saver.save(str(tmp_path), tree, step=1)
    with pytest.raises(RuntimeError, match="disk full"):
        saver.save(str(tmp_path), tree, step=2)
    assert not ckpt.is_complete(p1)
    assert ckpt.all_steps(str(tmp_path)) == []
    fail["on"] = False
    saver.save(str(tmp_path), tree, step=3)
    saver.wait()
    assert ckpt.all_steps(str(tmp_path)) == [3]
    fail["on"] = True
    saver.save(str(tmp_path), tree, step=4)
    with pytest.raises(RuntimeError, match="disk full"):
        saver.wait()
    assert ckpt.all_steps(str(tmp_path)) == [3]


RESIZE = [(np.float32, 4), (np.float32, 12), (np.int32, 4),
          (np.float16, 3), (np.bool_, 5)]


@pytest.mark.parametrize("mode", ["slice", "mean", "rank0"])
@pytest.mark.parametrize("dtype,new", RESIZE,
                         ids=[f"{d.__name__}-{n}" for d, n in RESIZE])
def test_resize_distributed_equals_jax(mode, dtype, new):
    rng = np.random.default_rng(4)
    a = rng.normal(size=(N, 3, 2)) * 10
    a = a.astype(dtype) if dtype is not np.bool_ else a > 0
    tree = {"a": a, "step": np.asarray(5, np.int32)}
    want = jckpt.resize_distributed(
        {"a": jnp.asarray(a), "step": jnp.asarray(5, jnp.int32)}, new,
        mode=mode)
    got = ckpt.resize_distributed(
        {"a": torch.from_numpy(a.copy()), "step": torch.tensor(5)}, new,
        mode=mode)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    assert got["a"].dtype == torch.from_numpy(a).dtype
    assert int(got["step"]) == 5 and tree
    with pytest.raises(ValueError, match="unknown resize mode"):
        ckpt.resize_distributed(tree, 4, mode="median")


def test_serving_snapshots_and_refusals(tmp_path):
    params = {"w": torch.randn(N, 3)}
    ckpt.save(str(tmp_path), {"params": params}, step=1)
    path = ckpt.save_for_serving(str(tmp_path), params, step=2)
    assert path.endswith("serving_step_2")
    assert ckpt.all_steps(str(tmp_path)) == [1]
    assert ckpt.all_serving_steps(str(tmp_path)) == [2]
    out, at = ckpt.load_for_serving(str(tmp_path))
    assert at == 2 and torch.equal(out["w"], params["w"])
    torn = tmp_path / "serving_step_5"
    torn.mkdir()
    assert ckpt.latest_serving_step(str(tmp_path)) == 2
    for bad in ((params, {}), {"params": params, "opt_state": {}},
                {"w": params["w"], "comm": 1}):
        with pytest.raises(ValueError) as je:
            jckpt.save_for_serving(str(tmp_path / "j"), bad, 3)
        with pytest.raises(ValueError) as te:
            ckpt.save_for_serving(str(tmp_path / "t"), bad, 3)
        assert str(te.value) == str(je.value)
    assert ckpt.load_for_serving(str(tmp_path / "none")) == (None, None)
