"""The port's ``tools/gossip_bench.py`` and ``tools/strategy_bench.py`` on
the CPU, against the JAX tools and the schedule tables:

* gossip_bench's ``--frontier`` report (host math) equals the JAX tool's
  JSON at two shape lists and codecs;
* its default mode's rounds and "x model sent" columns are the schedule
  tables' (rounds, mean out-degree; ``2 (n - 1) / n`` for the allreduce),
  equal to the JAX package's tables, with a finite ms a step; its
  ``--train-step`` comparison runs each communicator;
* ``--async-frontier`` runs both arms (the synchronous one through a
  chaos ``throttle`` fault) to the target and writes the JAX report;
* strategy_bench runs the JAX tool's 10 strategies, and its bytes are
  the tables' and the codecs': an allreduce (and ZeRO-1) ``2 (n - 1) / n``
  of the model, gossip the busiest rank's out-degree in copies, bf16 2
  bytes an element, CHOCO's int8 1 byte plus an f32 scale, push-sum a
  mass scalar more, PowerSGD its factors, and the dynamic one-peer row's
  period counted and divided out.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from bluefog_tpu import schedule as jsch
from bluefog_tpu import topology as jtopo
from bluefog_tpu_torch.tools import gossip_bench as gb
from bluefog_tpu_torch.tools import strategy_bench as sb
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

ROOT = Path(__file__).resolve().parents[1]
N = 8


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_gossip_bench", ROOT / "tools" / "gossip_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shapes,wire", [("32x32,32x128", "bf16"),
                                         ("4x8,16x4,2x2", "int8")])
def test_frontier_report_equals_jax(tmp_path, shapes, wire, capsys):
    argv = ["--frontier", "--shapes", shapes, "--wire", wire,
            "--params", "262144"]
    got = gb.run(gb.parse(argv + ["--out", str(tmp_path / "t.json")]))
    port_text = capsys.readouterr().out
    jtool = _jax_tool()
    import sys
    old = sys.argv
    sys.argv = ["gossip_bench.py"] + argv + ["--out",
                                             str(tmp_path / "j.json")]
    try:
        jtool.main()
    finally:
        sys.argv = old
    jax_text = capsys.readouterr().out
    want = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()) == want
    assert json.loads(json.dumps(got)) == want
    assert port_text.replace("t.json", "j.json") == jax_text


def test_gossip_rows_are_the_schedule_tables(capsys):
    doc = gb.run(gb.parse(["--device", "cpu", "--params", "512",
                           "--iters", "2", "--train-step"]))
    jtops = {"ring": jtopo.RingGraph(N), "expo2": jtopo.ExponentialTwoGraph(N),
             "mesh2d": jtopo.MeshGrid2DGraph(N), "star": jtopo.StarGraph(N),
             "full": jtopo.FullyConnectedGraph(N)}
    rows = {r["topology"]: r for r in doc["rows"]}
    for name, topo in jtops.items():
        s = jsch.compile_topology(topo, weighted=True)
        assert rows[name]["rounds"] == s.num_rounds, name
        assert rows[name]["x_model_sent"] == float(np.mean(s.out_degree))
    dyn = jsch.compile_dynamic_schedules(
        lambda r: jtopo.GetDynamicOnePeerSendRecvRanks(
            jtopo.ExponentialTwoGraph(N), r), N)
    one = rows["expo2-dynamic(1peer)"]
    assert (one["rounds"], one["x_model_sent"]) == \
        (dyn[0].num_rounds, float(np.mean(dyn[0].out_degree)))
    assert rows["global allreduce"]["x_model_sent"] == 2 * (N - 1) / N
    assert all(np.isfinite(r["ms_per_step"]) and r["ms_per_step"] > 0
               for r in doc["rows"])
    assert [r["communicator"] for r in doc["train_step"]] == [
        "gossip fused", "gossip unfused", "no comm (floor)",
        "global allreduce"]
    out = capsys.readouterr().out
    assert "x model sent/step" in out and "global allreduce" in out


def test_async_frontier_refuses_and_names_item_8(tmp_path):
    # the name is kept from when the mode was refused; it now runs
    from bluefog_tpu_torch.utils import chaos
    out = tmp_path / "af.json"
    rep = gb.run(gb.parse(["--async-frontier", "--device", "cpu",
                           "--params", "1024", "--out", str(out)]))
    assert rep == json.loads(out.read_text())
    assert rep["schema"] == "bluefog-gossip-async-1"
    assert rep["throttle"]["rank"] == 3 and rep["throttle"]["factor"] == 10
    assert rep["throttle"]["t_s"] >= 0.02
    assert rep["sync"]["reached_target"] and rep["async"]["reached_target"]
    # the sync arm slept the throttle on every tick it ran
    assert rep["sync"]["wall_s"] >= rep["sync"]["ticks"] * \
        rep["throttle"]["t_s"]
    assert rep["async"]["staleness_max"] <= 4 + 1
    assert not chaos.active()


def test_strategy_bench_bytes(capsys):
    dim = 48
    doc = sb.run(sb.parse(["--device", "cpu", "--dim", str(dim),
                           "--iters", "1"]))
    rows = {r["strategy"]: r for r in doc["rows"]}
    assert list(rows) == list(sb.ACCOUNTING)
    numel = doc["params_per_rank"]
    assert numel == 4 * dim * dim + 13 * dim + 10
    model = 4 * numel / 2 ** 20                      # MiB, f32
    s = jsch.compile_topology(jtopo.ExponentialTwoGraph(N), weighted=True)
    deg = float(s.out_degree.max())
    ring = 2 * (N - 1) / N

    def mib(name):
        return rows[name]["wire_mib_per_step_per_chip"]

    assert mib("allreduce") == pytest.approx(ring * model, rel=1e-9)
    assert mib("zero-1 allreduce") == mib("allreduce")
    for name in ("neighbor (CTA)", "neighbor (ATC)", "win_put"):
        assert mib(name) == pytest.approx(deg * model, rel=1e-9), name
    assert mib("neighbor bf16 wire") == pytest.approx(deg * model / 2,
                                                      rel=1e-9)
    assert mib("choco (int8 wire)") == pytest.approx(
        deg * (numel + 4) / 2 ** 20, rel=1e-9)
    assert mib("push_sum") == pytest.approx(deg * (4 * numel + 4) / 2 ** 20,
                                            rel=1e-9)
    # the two hidden kernels are PowerSGD's matrices (rank 4 factors of
    # (m + k) rows each); the head's 10 x 48 kernel (< 2048) and the
    # biases are allreduced exactly
    factors = 2 * (dim + 2 * dim) * 4 * 4
    exact = (2 * dim + dim + 10 + 10 * dim) * 4
    assert mib("powersgd r=4") == pytest.approx(
        ring * (factors + exact) / 2 ** 20, rel=1e-9)
    dyn = rows["dynamic one-peer"]
    period = doc["dynamic_period"]
    assert period == 3
    assert dyn["wire_mib_per_step_per_chip"] == pytest.approx(
        dyn["wire_mib"] / period, rel=1e-12)
    assert dyn["wire_mib_per_step_per_chip"] == pytest.approx(model,
                                                              rel=1e-9)
    assert rows["allreduce"]["collectives"] == "all-reducex1"
    assert rows["neighbor (CTA)"]["collectives"] == f"permutex{s.num_rounds}"
    assert rows["push_sum"]["collectives"] == f"permutex{2 * s.num_rounds}"
    assert rows["zero-1 allreduce"]["collectives"] == \
        "all-gatherx1, reduce-scatterx1"
    assert rows["powersgd r=4"]["collectives"] == "all-reducex5"
    out = capsys.readouterr().out
    assert "executes 1 of 3 branches/step" in out
    sb.report(doc, as_json=True)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["strategy"] for x in lines] == list(rows)
