"""The port's ``decentralized_optimization`` example against the JAX
example on the CPU: the JAX example runs in a subprocess
(``--virtual-cpu``, 8 virtual devices) while the port runs in process at
the same flags.  Both print the same methods, each one's ``max |w -
w_opt|`` agrees within 1e-6 (the data is float32 on both sides), and both
pass their own end assertion (every method within 0.05 of ``w_opt``).
"""
import re

import pytest

from bluefog_tpu_torch.examples import decentralized_optimization as ex
import torch_cpu_threads  # noqa: F401  (the worker's thread share)
import torch_example_twins as twins

LINE = re.compile(r"^\[(\w+)\] max \|([\w/]+) - w_opt\| = ([0-9.e+-]+) "
                  r"after (\d+) iters")


def _errors(text):
    return {m.group(1): (m.group(2), float(m.group(3)), int(m.group(4)))
            for m in map(LINE.match, text.splitlines()) if m}


@pytest.mark.parametrize("argv", [[], ["--method", "push_diging", "--seed",
                                       "7", "--max-iters", "120"]],
                         ids=["all", "push_diging_seed7"])
def test_example_matches_the_jax_example(argv, capsys):
    proc = twins.start("decentralized_optimization", argv)
    with twins.one_thread():
        assert ex.main(argv + ["--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    got, want = _errors(port_out), _errors(out)
    assert set(got) == set(want) and got
    for name, (label, e, iters) in want.items():
        assert got[name][0] == label and got[name][2] == iters, name
        assert abs(got[name][1] - e) <= 1e-6, (name, got[name], e)
        assert got[name][1] <= 0.05
    last = "all methods converged to the global optimum"
    assert port_out.strip().splitlines()[-1] == out.strip().splitlines()[-1] \
        == last


def test_problem_and_refusal():
    """The data is the JAX example's draws; a method that does not reach
    0.05 fails the run's assertion."""
    import numpy as np
    A, b, w_opt = ex.problem(2020, 8, "cpu")
    assert tuple(A.shape) == (8, 30, 10) and tuple(b.shape) == (8, 30)
    rng = np.random.default_rng(2020)
    rng.normal(size=(10,))
    np.testing.assert_array_equal(
        A.numpy(), rng.normal(size=(8, 30, 10)).astype(np.float32))
    with pytest.raises(AssertionError, match="failed to converge"):
        ex.main(["--device", "cpu", "--method", "diffusion",
                 "--max-iters", "2"])
    with pytest.raises(SystemExit):
        ex.parse(["--method", "nope"])
