"""Routings for K4's backward plan, shared by the CPU tests of its plain
version (``test_torch_kernel_plans.py``) and the card's tests of the plan
kernel (``test_torch_gpu_kernels.py``).  Imports no JAX.

Each case is ``(tile_eid, tile, E, D, F, splits)``: random, shuffled tile
order, hostile (all but one tile on one expert), one expert empty, all
rows on one expert, stacked-peer ids over ``[0, P * E)``, one-row tiles in
a shuffled order, Zipf-skewed (exponent 1.2) at the trainer's steady-tick
width, and forced wgrad splits.
"""
import numpy as np
import torch

CASES = ["random", "shuffled", "hostile", "one_expert_empty",
         "all_on_one_expert", "stacked_peers", "tile_1_shuffled", "skewed",
         "forced_splits"]


def routing(case):
    """``(tile_eid [G] int32 on the CPU, tile, E, D, F, splits)``."""
    rng = np.random.default_rng(CASES.index(case))
    w = 1.0 / np.arange(1, 33) ** 1.2
    ids, tile, E, D, F, splits = {
        "random": (np.sort(rng.integers(0, 8, 300)), 8, 8, 1024, 2048, 0),
        "shuffled": (rng.integers(0, 8, 300), 8, 8, 1024, 2048, 0),
        "hostile": (np.array([2] * 1 + [5] * 511), 8, 8, 1024, 4096, 0),
        "one_expert_empty": (np.sort(rng.choice([0, 1, 3, 4], 64)), 4, 5,
                             256, 512, 0),
        "all_on_one_expert": (np.full(40, 3), 16, 4, 128, 256, 0),
        "stacked_peers": (np.sort(rng.integers(0, 4 * 8, 200)), 8, 32,
                          1024, 1024, 0),
        "tile_1_shuffled": (rng.integers(0, 6, 700), 1, 6, 64, 64, 0),
        "skewed": (np.sort(rng.choice(32, 8192, p=w / w.sum())), 8, 32,
                   1024, 2048, 0),
        "forced_splits": (np.sort(rng.integers(0, 4, 90)), 4, 4, 64, 128,
                          3)}[case]
    return torch.tensor(ids, dtype=torch.int32), tile, E, D, F, splits
