"""Runs a JAX example (``examples/<name>.py --virtual-cpu``) in a
subprocess beside its port, for the port's example tests.  Imports no
JAX itself.

:func:`start` launches the JAX example (it runs while the port trains
in the test's own process, under :func:`one_thread`); :func:`finish`
waits for it and returns its printed ``step i: loss x`` values by step
and its last line.
"""
import contextlib
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEP = re.compile(r"^step (\d+): loss ([0-9.]+)")


def start(name, argv):
    # 8 virtual devices, as every one of these examples asks for; one
    # Eigen thread a device keeps the subprocess from contending with the
    # port for the cores (and is faster at these widths)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false")
    return subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"),
         "--virtual-cpu", *argv], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@contextlib.contextmanager
def one_thread():
    """The port's tiny examples on one torch thread (they take the same
    time on one as on eight), leaving the other cores to the JAX
    subprocess."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def finish(proc, timeout=240):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return parse(out), out.strip().splitlines()[-1]


def parse(text):
    """``{step: loss}`` of the ``step i: loss x`` lines in ``text``."""
    got = {}
    for line in text.splitlines():
        m = STEP.match(line)
        if m:
            got[int(m.group(1))] = float(m.group(2))
    return got


def check(port_lines, jax_steps, rtol):
    """The port printed the JAX example's steps; its step-0 loss equals
    JAX's print to its 4 decimals and its last within ``rtol``."""
    got = parse("\n".join(port_lines))
    assert sorted(got) == sorted(jax_steps), (got, jax_steps)
    first, last = min(got), max(got)
    assert got[first] == jax_steps[first], (got[first], jax_steps[first])
    assert abs(got[last] - jax_steps[last]) <= rtol * jax_steps[last], \
        (got[last], jax_steps[last])
