"""The port's ``pipeline_lm`` example against the JAX one on the CPU, at
the same seed: the JAX example runs in a subprocess with
``--virtual-cpu`` while the port trains in process.  The port prints its
JAX twin's step lines: the step-0 loss equals JAX's print to its 4
decimals and the last printed loss (step 20) agrees within rtol 1e-3
(the same f32 products; Adam's and the block's rounding part the runs by
a few 1e-5 over 21 steps), in each model path: GPipe,
``--interleaved 2 --micro 4`` and ``--hetero`` (embedding and head as
stages of their own).  Both end assertions hold (JAX's exit code, the
port's ``main``), and the final lines agree up to their numbers.  The
parameter layouts carry across by ``params_from_jax``.
"""
import numpy as np
import pytest
import torch

from bluefog_tpu_torch.examples import pipeline_lm
import torch_cpu_threads  # noqa: F401  (the worker's thread share)
import torch_example_twins as twins

CASES = [[], ["--interleaved", "2", "--micro", "4"], ["--hetero"]]


@pytest.mark.parametrize("argv", CASES, ids=["gpipe", "interleaved",
                                              "hetero"])
def test_example_matches_the_jax_example(argv, capsys):
    argv = argv + ["--steps", "21"]
    proc = twins.start("pipeline_lm", argv)
    with twins.one_thread():
        assert pipeline_lm.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    jax_steps, jax_last = twins.finish(proc)
    twins.check(lines, jax_steps, 1e-3)
    assert lines[-1].split(":")[0].split(" loss ")[0] == \
        jax_last.split(":")[0].split(" loss ")[0]


def test_params_from_jax_and_the_refusals():
    """``params_from_jax`` keeps the stacked, chunked and packed layouts;
    the CLI refuses what the JAX example refuses."""
    rng = np.random.default_rng(0)
    tree = pipeline_lm.init_params(rng, 4, 2, 8, 16, hetero=False)
    got = pipeline_lm.params_from_jax(tree, "cpu")
    assert got["stage"]["wqkv"].shape == (4, 2, 16, 48)
    assert torch.equal(got["stage"]["w1"],
                       torch.from_numpy(tree["stage"]["w1"]))
    packed = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert torch.equal(pipeline_lm.params_from_jax(packed, "cpu"),
                       torch.from_numpy(packed))
    for bad in (["--lag", "0"], ["--heads", "3"],
                ["--interleaved", "2"], ["--hetero", "--interleaved", "2",
                                         "--micro", "4"],
                ["--hetero", "--stages", "2"]):
        with pytest.raises(SystemExit):
            pipeline_lm.main(bad + ["--device", "cpu"])
