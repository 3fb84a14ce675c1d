"""Mesh regrowth across gloo processes (``tests/torch_regrow_worker.py``
under ``bfrun-torch``), each held to the same regrowth in one process
(``torch_regrow_worker.reference``) bit for bit:

* 2 processes x 2 rows -> 2 processes x 3 rows: the survivors' rows move
  between processes through the carry's gather, the joiners are pulled
  across processes;
* 2 -> 3 processes through ``--elastic``'s join: process 0 writes the
  scale file, the supervisor publishes the re-formed group's port and
  starts the joiner, the survivors re-form the process group
  (``destroy_process_group`` then ``init_process_group`` at 3) and send
  the carried rows to the joiner, which takes its pull with them.

The JAX package's cross-process regrowth re-forms ``jax.distributed``;
the port's is held to its own single-process oracle, which
``tests/test_torch_regrow.py`` holds to JAX.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_cpu_threads  # noqa: F401  (the worker's thread share)
import torch_regrow_worker

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(torch_regrow_worker.__file__).resolve()


def _launch(args, timeout=120):
    p = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.launcher"] + args,
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    return p


def _blocks(out: Path, procs: int):
    meta = [(out / f"block{i}.txt").read_text().split() for i in
            range(procs)]
    return np.concatenate([np.load(out / f"block{i}.npy")
                           for i in range(procs)]), meta


@pytest.mark.parametrize("mode", ["rows", "processes"])
def test_regrow_across_processes_equals_one_process(tmp_path, mode):
    out = tmp_path / "out"
    scale = tmp_path / "scale"
    args = ["-np", "2"]
    if mode == "processes":
        args += ["--elastic", "--scale-file", str(scale)]
    p = _launch(args + [
        "--", sys.executable, str(WORKER),
        "--mode", mode, "--scale-file", str(scale), "--out", str(out)])
    procs, rows = (2, 3) if mode == "rows" else (3, 2)
    got, meta = _blocks(out, procs)
    assert meta == [[str(i * rows), "6", str(procs)] for i in range(procs)]
    want = torch_regrow_worker.reference(2, 2, procs, rows)
    assert got.shape == want.shape == (6, 16)
    assert np.array_equal(got, want)
    if mode == "processes":
        assert "elastic join: starting rank 2 (target 3)" in p.stderr
        count, port = Path(str(scale) + ".port").read_text().split()
        assert count == "3" and int(port) > 0
