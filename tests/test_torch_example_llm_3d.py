"""``bluefog_tpu_torch.examples.llm_3d`` against ``examples/llm_3d.py``
on the CPU, at the same seed: the JAX example runs in a subprocess with
``--virtual-cpu`` while the port trains in process.  The port prints the
JAX example's step lines: the step-0 loss equals JAX's print to its 4
decimals, the last printed loss agrees within the rtol stated per case,
and both end assertions hold (JAX's exit code, the port's ``main``).

* the default carving dp 2 x pp 2 x tp 2 (100 steps; both sides sum in
  f32 in other orders: rtol 1e-3);
* ``--sp 2 --tp 1 --wire fp8@64`` (the gossip in the fp8 codec, whose
  rounding points amplify f32-order differences over the run: rtol
  1e-2).

The expert-parallel case (``--tp 1 --ep 2 --experts 4 --steps 40``) is in
``tests/test_torch_example_moe.py``, so that each file stays short.
"""
import pytest

from bluefog_tpu_torch.examples import llm_3d
import torch_cpu_threads  # noqa: F401  (the worker's thread share)
import torch_example_twins as twins


@pytest.mark.parametrize("argv,rtol", [
    ([], 1e-3),
    (["--sp", "2", "--tp", "1", "--wire", "fp8@64"], 1e-2)],
    ids=["default", "sp2_fp8"])
def test_llm_3d_matches_the_jax_example(argv, rtol, capsys):
    proc = twins.start("llm_3d", argv)
    with twins.one_thread():
        assert llm_3d.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    jax_steps, jax_last = twins.finish(proc)
    assert lines[0].startswith("[llm_3d] carving {'dp': 2")
    twins.check(lines, jax_steps, rtol)
    assert lines[-1].split(": loss")[0] == jax_last.split(": loss")[0]
