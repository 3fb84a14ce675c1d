"""The torch thread share of one pytest worker, set when the port's CPU
test files import this module.

Under ``pytest -n W`` every worker keeps its own torch intra-op pool, by
default a thread a core: W pools contend for the cores, and the port's
small CPU tests (many tiny ops each) then spend most of their time in
contended OpenMP barriers, tens of times their time alone.  Each worker
takes ``cores // W`` threads instead (at least one); without xdist,
torch's default stands.
"""
import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
