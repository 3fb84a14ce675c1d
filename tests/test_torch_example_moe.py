"""The port's MoE examples against the JAX ones on the CPU, at the same
seed: each JAX example runs in a subprocess with ``--virtual-cpu`` while
its port trains in process.  Each port prints its JAX twin's step lines:
the step-0 loss equals JAX's print to its 4 decimals, the last printed
loss agrees within the rtol stated per case, and both end assertions
hold (JAX's exit code, the port's ``main``).

* ``moe`` and ``moe --top2`` (4 experts on 4 stacked ranks; the numpy
  draws are JAX's own): rtol 1e-2, since argmax / top-k routing can flip
  on an f32 near tie and the runs then part;
* ``moe_lm`` (ring attention x one expert a rank over 8 stacked ranks):
  rtol 2e-2 for the same reason (the two runs agree to 1e-6 until a
  routing flip near step 22, then part by up to 0.5 %);
* ``llm_3d --tp 1 --ep 2 --experts 4 --steps 40`` (the routed MoE LM,
  capacity dispatch): rtol 1e-3.
"""
import pytest

from bluefog_tpu_torch.examples import llm_3d, moe, moe_lm
import torch_cpu_threads  # noqa: F401  (the worker's thread share)
import torch_example_twins as twins

CASES = [("moe", moe, [], 1e-2), ("moe", moe, ["--top2"], 1e-2),
         ("moe_lm", moe_lm, [], 2e-2),
         ("llm_3d", llm_3d, ["--tp", "1", "--ep", "2", "--experts", "4",
                             "--steps", "40"], 1e-3)]


@pytest.mark.parametrize("name,mod,argv,rtol", CASES,
                         ids=["moe", "moe_top2", "moe_lm", "llm_3d_ep2"])
def test_example_matches_the_jax_example(name, mod, argv, rtol, capsys):
    proc = twins.start(name, argv)
    with twins.one_thread():
        assert mod.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    jax_steps, jax_last = twins.finish(proc)
    twins.check(lines, jax_steps, rtol)
    assert lines[-1].split(":")[0].split(" on ")[0] == \
        jax_last.split(":")[0].split(" on ")[0]
