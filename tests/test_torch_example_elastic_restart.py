"""The port's ``examples/elastic_restart.py`` against the JAX example on
the CPU, at the defaults (8 ranks, 120 steps, a checkpoint every 30
through ``AsyncSaver``; restore, ``resize_distributed`` to 4 ranks, 60
more steps; a wrecked rank re-seeded by ``broadcast_parameters``): the
JAX example in a subprocess (``tests/torch_example_twins.py``), the port
in process.  The numpy draws are the JAX example's, so every line the
JAX example prints is the port's, numbers to their printed digits
(the 8-rank loss to 4 decimals, the checkpoint steps, the restored step,
the 4-rank error to 3); both end conditions hold.  ``--steps`` below
twice ``--checkpoint-every`` is refused with the JAX text.
"""
import pytest

from bluefog_tpu_torch.examples import elastic_restart
import torch_cpu_threads  # noqa: F401  (the worker's thread share)
import torch_example_twins as twins


def test_elastic_restart_matches_the_jax_example(tmp_path, capsys):
    proc = twins.start("elastic_restart", ["--dir", str(tmp_path / "j")])
    with twins.one_thread():
        res = elastic_restart.run(elastic_restart.parse(
            ["--device", "cpu", "--dir", str(tmp_path / "t")]))
    lines = capsys.readouterr().out.strip().splitlines()
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    assert lines == out.strip().splitlines()
    assert res["restored_step"] == 60 and res["err"] < 0.35
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        ["step_30", "step_60"]


def test_steps_refused_below_two_checkpoints(capsys):
    with pytest.raises(SystemExit):
        elastic_restart.parse(["--steps", "50", "--checkpoint-every", "30"])
    assert "--steps must be at least 2x --checkpoint-every" in \
        capsys.readouterr().err
