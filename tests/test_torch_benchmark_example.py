"""The port of ``examples/benchmark.py`` on the CPU, in process
(``bluefog_tpu_torch.examples.benchmark.main``).

* Every ``--dist-optimizer`` choice at ``--device cpu --model mlp
  --num-iters 2`` (8 stacked ranks, batch 32, the example's all-ones
  images), plus ``--atc``, ``--dynamic-topology`` (flat and
  hierarchical) and ``--wire bf16|int8|fp8@64`` where the JAX example
  takes them, and ``--steps-per-call 2``: exit 0 and the JAX example's
  two lines.
* ``--wire`` with a strategy that does not gossip parameters exits with
  the JAX example's text; ``--profile`` writes the timeline (the
  ``TRAIN`` span of the timed iterations and the step's phases).
* The bytes a rank puts on the wire a step, counted from the schedule
  tables and the codecs' widths, for the MLP's one f32 buffer.
"""
import json
import re

import pytest

from bluefog_tpu_torch.examples import benchmark as ex
from bluefog_tpu_torch.parallel import context as ctx
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

BASE = ["--device", "cpu", "--model", "mlp", "--num-iters", "2"]
RUNS = [[name] for name in ex.STRATEGIES] + [
    ["neighbor_allreduce", "--atc"],
    ["neighbor_allreduce", "--dynamic-topology"],
    ["hierarchical_neighbor_allreduce", "--dynamic-topology"],
    ["neighbor_allreduce", "--wire", "bf16"],
    ["neighbor_allreduce", "--atc", "--wire", "int8"],
    ["hierarchical_neighbor_allreduce", "--wire", "fp8@64"],
    ["win_put", "--wire", "fp8@64"],
    ["pull_get", "--wire", "int8"],
    ["choco", "--wire", "fp8"],
    ["push_sum", "--steps-per-call", "2"],
]


@pytest.mark.parametrize("run", RUNS, ids=["-".join(r) for r in RUNS])
def test_example_runs_on_the_cpu(run, capsys):
    argv = BASE + ["--dist-optimizer"] + run
    assert ex.main(argv) == 0
    assert not ctx.is_initialized()
    lines = capsys.readouterr().out.strip().splitlines()
    name = run[0]
    label = (name + ("+dynamic" if "--dynamic-topology" in run else "")
             + (" (ATC)" if "--atc" in run else ""))
    assert lines[0] == f"Model: mlp, optimizer: {label}"
    m = re.fullmatch(r"Total img/sec on 8 device\(s\): ([0-9.]+) "
                     r"\(([0-9.]+) per device\)", lines[1])
    assert m and float(m.group(1)) > 0


@pytest.mark.parametrize("name", ex.NO_WIRE)
def test_wire_refused_with_the_jax_text(name):
    with pytest.raises(SystemExit) as e:
        ex.main(BASE + ["--dist-optimizer", name, "--wire", "bf16"])
    assert str(e.value) == (
        "--wire applies to the gossip strategies (neighbor/"
        f"hierarchical/win_put/pull_get/choco), not {name}")
    assert not ctx.is_initialized()


def test_profile_is_not_ported(tmp_path):
    # the name is kept from when --profile was refused; it now writes the
    # timeline the JAX example writes (examples/benchmark.py:183, :202)
    prefix = str(tmp_path / "tl")
    assert ex.main(BASE + ["--dist-optimizer", "neighbor_allreduce",
                           "--profile", prefix]) == 0
    with open(prefix + ".activities.json") as f:
        events = json.load(f)["traceEvents"]
    names = {(e["cat"], e["name"]) for e in events}
    assert ("benchmark", "TRAIN") in names
    assert {("train_step", "COMMUNICATE"), ("train_step", "ADAPT"),
            ("train_step", "GRADIENT")} <= names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)


P = 64 * 256 + 256 + 256 * 128 + 128 + 128 * 10 + 10    # the MLP's floats


@pytest.mark.parametrize("run,want", [
    (["neighbor_allreduce"], 3 * 4 * P),           # Exp2 out-degree 3
    (["neighbor_allreduce", "--wire", "int8"], 3 * (P + 4)),
    (["neighbor_allreduce", "--wire", "fp8@64"],
     3 * (-(-P // 64) * (64 + 4))),
    (["neighbor_allreduce", "--dynamic-topology"], 4 * P),   # one peer
    (["allreduce"], 2 * 7 * 4 * P // 8),           # a ring's 2 (n-1)/n
    (["empty"], 0),
    (["hierarchical_neighbor_allreduce"], 2 * 3 * 4 * P // 4 + 4 * P),
    (["push_sum"], 3 * (4 * P + 4)),
    (["choco"], 3 * (P + 4)),                      # int8 by default
])
def test_wire_bytes_per_rank(run, want):
    args = ex.parse(BASE + ["--dist-optimizer"] + run)
    try:
        b = ex.build(args)
        assert ex.wire_bytes_per_rank(args, b.params, b.schedules) == want
    finally:
        ctx.shutdown()


def test_card_parity_machinery_on_the_cpu():
    """``tools/strategy_parity.py`` (chip_smoke phases 15a-15b) with the
    CPU on both sides: every gate passes at zero error, push-sum's mass
    and the gradient-averaging ranks included."""
    from bluefog_tpu_torch.tools import strategy_parity as sp
    codecs = sp.codec_parity("cpu", width=1000)
    sp.check_codecs(codecs)
    assert set(codecs["codecs"]) == set(sp.CODECS)
    picked = [v for v in sp.VARIANTS if v[0] in (
        "push_sum", "zero_allreduce", "gradient_allreduce", "wire_int8")]
    summary = sp.strategy_parity("cpu", picked, steps=2)
    sp.check_strategies(summary)
    rows = summary["variants"]
    assert all(r["worst_err_over_bound"] == 0.0 for r in rows.values())
    assert rows["zero_allreduce"]["vs_gradient_allreduce_rel"] <= 1e-6
    assert rows["push_sum"]["p_sum_minus_n"] <= 1e-6 * 8
    assert rows["wire_int8"]["rank_spread"] > 0
