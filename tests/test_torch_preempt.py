"""The port's preemptible-fleet story held against the JAX package's
(``tests/test_preempt.py``):

* ``tools/preempt_trace.py``'s documents — the port's
  ``bluefog_tpu_torch/tools/preempt_trace.py`` gives JAX's tool's JSON,
  key for key, for every pattern (the same seeded Python draws);
* the launcher's ``_load_preempt_trace`` normalises and refuses as JAX's
  does, and ``--preempt-trace`` needs ``-np``;
* the chaos ``preempt`` fault's notice, victims and 143 exit code equal
  JAX's;
* the launcher's replay: SIGTERM notice, a drain inside the grace window
  counted as a clean retirement, and the re-grant respawn as a fresh
  join (children are small Python scripts without torch, as in JAX's
  tests, reading torchrun's variables);
* a regrow back to a size already seen builds and loads no kernel
  (``ops/_build.py``'s counts), where JAX's pins zero fresh compiles;
* a ``preempt_bench`` run on a small trace: its gates and the bundle it
  dumps blamed as "preempted" by the repo's ``tools/postmortem.py``.

JAX's three executable-pool and compilation-cache tests
(``tests/test_preempt.py:390-444``: the ``BLUEFOG_EXEC_CACHE`` gate, the
world-shape keys of ``parallel/exec_cache.py``, the
``DeserializeLoadedExecutable`` probe) have no counterpart: the port
compiles no program for a world shape, so there is no pool and no cache
to gate.
"""
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bluefog_tpu.run import launcher as jlauncher
from bluefog_tpu.utils import chaos as jchaos
from bluefog_tpu.utils import flight as jflight
from bluefog_tpu_torch import api as tapi
from bluefog_tpu_torch import resilience as trz
from bluefog_tpu_torch.ops import _build
from bluefog_tpu_torch.parallel import context as tctx
from bluefog_tpu_torch.run import launcher as tlauncher
from bluefog_tpu_torch.tools import preempt_bench, preempt_trace
from bluefog_tpu_torch.utils import chaos as tchaos
from bluefog_tpu_torch.utils import flight as tflight
from bluefog_tpu_torch.utils import metrics as tm
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

ROOT = Path(__file__).resolve().parents[1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_mod", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _clean():
    tm.reset_metrics()
    for c in (jchaos, tchaos):
        c.uninstall()
    trz.reset()
    for f in (jflight, tflight):
        f.reset()
    yield
    for c in (jchaos, tchaos):
        c.uninstall()
    trz.reset()
    for f in (jflight, tflight):
        f.reset()
    if tctx.is_initialized():
        tctx.shutdown()


@pytest.fixture
def world4():
    tctx.init(size=4, device="cpu")
    yield tctx.get_context()
    tctx.shutdown()


# ---------------------------------------------------------------------------
# the trace grammar
# ---------------------------------------------------------------------------

_TRACE_ARGS = [
    ["--pattern", "diurnal", "--world", "8", "--zones", "4",
     "--duration", "20", "--seed", "7"],
    ["--pattern", "mass", "--world", "8", "--zones", "4", "--seed", "3"],
    ["--pattern", "mass", "--world", "8", "--zones", "4",
     "--fraction", "0.75"],
    ["--pattern", "slow-regrant", "--world", "8", "--zones", "4",
     "--regrant", "5", "--slow-factor", "6", "--seed", "11",
     "--events", "6"],
    ["--pattern", "slow-regrant", "--world", "16", "--zones", "8",
     "--duration", "45", "--grace", "1.5"],
]


@pytest.mark.parametrize("argv", _TRACE_ARGS,
                         ids=lambda a: "-".join(a[1:2] + a[-2:]))
def test_preempt_trace_documents_equal_jax(tmp_path, argv):
    jt = _tool("preempt_trace")
    docs = []
    for i, tool in enumerate((jt, preempt_trace)):
        out = tmp_path / f"t{i}.json"
        assert tool.main(argv + ["--out", str(out)]) == 0
        docs.append(out.read_text())
    assert docs[0] == docs[1]                     # byte for byte
    doc = json.loads(docs[1])
    ts = [e["t"] for e in doc["events"]]
    assert ts == sorted(ts) and doc["events"]


def test_preempt_trace_refusals_match_jax():
    jt = _tool("preempt_trace")
    for argv in (["--pattern", "mass", "--world", "2", "--zones", "4"],
                 ["--pattern", "mass", "--fraction", "0"]):
        with pytest.raises(SystemExit) as je:
            jt.main(argv)
        with pytest.raises(SystemExit) as te:
            preempt_trace.main(argv)
        assert str(te.value) == str(je.value)


def test_load_preempt_trace_normalizes_and_refuses_as_jax(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({
        "schema": "bluefog-preempt-trace-1", "zones": 2, "world": 4,
        "grace": 9.0,
        "events": [{"t": 5.0, "zone": 1, "regrant": 2},
                   {"t": 1.0, "victims": [0], "grace": 0.5}]}))
    got = tlauncher._load_preempt_trace(str(path), default_grace=3.0)
    assert got == jlauncher._load_preempt_trace(str(path),
                                                default_grace=3.0)
    assert [e["t"] for e in got["events"]] == [1.0, 5.0]
    assert got["events"][1]["grace"] == pytest.approx(9.0)
    for bad in ({"schema": "nope", "events": []},
                {"schema": "bluefog-preempt-trace-1",
                 "events": [{"t": 1.0}]}):
        path.write_text(json.dumps(bad))
        with pytest.raises(SystemExit) as je:
            jlauncher._load_preempt_trace(str(path))
        with pytest.raises(SystemExit) as te:
            tlauncher._load_preempt_trace(str(path))
        assert str(te.value) == str(je.value)


def test_preempt_trace_flag_requires_np(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({
        "schema": "bluefog-preempt-trace-1",
        "events": [{"t": 0.1, "victims": [0]}]}))
    with pytest.raises(SystemExit, match="requires -np"):
        tlauncher.main(["--preempt-trace", str(path), "--",
                        sys.executable, "-c", "pass"])


# ---------------------------------------------------------------------------
# the chaos preempt fault
# ---------------------------------------------------------------------------

def test_preempt_fires_with_notice_and_spot_exit_code(world4, cpu_devices):
    import bluefog_tpu as jbf
    jbf.init(devices=cpu_devices[:4])
    try:
        got = {}
        for side, ch, fl in (("jax", jchaos, jflight),
                             ("port", tchaos, tflight)):
            fl.configure(1024)
            ch.install("zones=2;preempt:step=5,zone=1,grace=1.5,regrant=4")
            with pytest.raises(ch.RankPreempted) as ei:
                for step in range(1, 8):
                    ch.on_train_step(step)
            e = ei.value
            kinds = [ev["kind"] for ev in fl.events()
                     if ev["kind"] in ("preempt_notice", "chaos")]
            ev = [x for x in fl.events() if x["kind"] == "chaos"][0]
            got[side] = (e.ranks, e.zone, e.step, e.grace, e.regrant,
                         e.code, kinds, ev["victims"], ev["zone"])
        assert got["port"] == got["jax"]
        assert got["port"][5] == tchaos.DEFAULT_PREEMPT_CODE == 143
    finally:
        jbf.shutdown()


# ---------------------------------------------------------------------------
# the launcher's replay: notice -> grace drain -> kill -> re-grant
# ---------------------------------------------------------------------------

def test_preempt_sigterm_grace_drain_and_regrant(tmp_path, capsys):
    # the re-grant lands after the event's grace window (2 s here; JAX's
    # test waits out 30), while --preempt-grace is the budget exported to
    # the children
    drain_marker = tmp_path / "drain"
    join_marker = tmp_path / "join"
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({
        "schema": "bluefog-preempt-trace-1", "zones": 2, "world": 2,
        "events": [{"t": 0.3, "zone": 1, "grace": 2, "regrant": 0.1}]}))
    prog = (
        "import os, signal, sys, time\n"
        "if os.environ.get('BLUEFOG_JOIN_COUNT'):\n"
        "    open(%r, 'w').write('JOIN_COUNT=%%s WORLD=%%s RANK=%%s' %% (\n"
        "        os.environ['BLUEFOG_JOIN_COUNT'],\n"
        "        os.environ['WORLD_SIZE'], os.environ['RANK']))\n"
        "    sys.exit(0)\n"
        "def drain(signum, frame):\n"
        "    open(%r, 'w').write(\n"
        "        'grace=%%s' %% os.environ.get('BLUEFOG_PREEMPT_GRACE'))\n"
        "    sys.exit(7)\n"
        "if os.environ['RANK'] == '1':\n"
        "    signal.signal(signal.SIGTERM, drain)\n"
        "    time.sleep(600)\n"
        "for _ in range(1200):\n"
        "    if os.path.exists(%r): sys.exit(0)\n"
        "    time.sleep(0.05)\n"
        "sys.exit(1)\n" % (str(join_marker), str(drain_marker),
                           str(join_marker)))
    t0 = time.perf_counter()
    code = tlauncher.main(
        ["-np", "2", "--preempt-trace", str(trace), "--preempt-grace", "30",
         "--scale-file", str(tmp_path / "scale"),
         "--", sys.executable, "-c", prog])
    assert code == 0
    assert time.perf_counter() - t0 < 60
    err = capsys.readouterr().err
    assert "bfrun-torch: preempt: zone 1 reclaiming rank(s) [1]" in err
    assert "rank 1 preempted (exit code 7)" in err
    assert "preempt re-grant: starting rank 2 (fresh identity, join 1)" \
        in err
    assert "grace expired" not in err
    assert drain_marker.read_text() == "grace=30.0"
    assert join_marker.read_text() == "JOIN_COUNT=1 WORLD=2 RANK=2"


def test_preempt_stubborn_victim_killed_after_grace(tmp_path, capsys):
    join_marker = tmp_path / "join"
    ready = tmp_path / "ready"
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({
        "schema": "bluefog-preempt-trace-1",
        "events": [{"t": 1.5, "victims": [1], "grace": 0.4,
                    "regrant": 0.1}]}))
    # the victim ignores SIGTERM from its first line, well before t
    prog = (
        "import os, signal, sys, time\n"
        "if os.environ.get('BLUEFOG_JOIN_COUNT'):\n"
        "    open(%r, 'w').write('joined')\n"
        "    sys.exit(0)\n"
        "if os.environ['RANK'] == '1':\n"
        "    signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
        "    open(%r, 'w').write('ignoring')\n"
        "    time.sleep(600)\n"
        "for _ in range(1200):\n"
        "    if os.path.exists(%r): sys.exit(0)\n"
        "    time.sleep(0.05)\n"
        "sys.exit(1)\n" % (str(join_marker), str(ready), str(join_marker)))
    code = tlauncher.main(
        ["-np", "2", "--preempt-trace", str(trace),
         "--scale-file", str(tmp_path / "scale"),
         "--", sys.executable, "-c", prog])
    assert code == 0
    err = capsys.readouterr().err
    assert ready.read_text() == "ignoring"
    assert "preempt: grace expired, killing rank 1" in err
    assert "rank 1 preempted (exit code" in err
    assert join_marker.read_text() == "joined"


# ---------------------------------------------------------------------------
# the build-counter invariant
# ---------------------------------------------------------------------------

def test_warm_regrow_to_seen_size_builds_and_loads_nothing(world4):
    w = torch.tensor(np.random.default_rng(0).standard_normal((4, 8)))
    b0 = _build.build_counts()
    for target in (6, 4, 6, 4):
        newp, handle = trz.regrow_world(target, {"w": w})
        w = tapi.neighbor_allreduce(newp["w"])
        handle.commit()
    assert _build.build_counts() == b0
    assert tctx.get_context().size == 4


# ---------------------------------------------------------------------------
# the bench and the postmortem blame
# ---------------------------------------------------------------------------

def test_preempt_bench_small_trace(tmp_path, capsys):
    trace = tmp_path / "mass.json"
    assert preempt_trace.main(
        ["--pattern", "mass", "--world", "4", "--zones", "2",
         "--duration", "8", "--grace", "1", "--regrant", "3",
         "--out", str(trace)]) == 0
    assert preempt_bench.main(
        ["--trace", str(trace), "--virtual-cpu", "4", "--device", "cpu",
         "--flight-dir", str(tmp_path / "flight")]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["schema"] == "bluefog-preempt-bench-1" and doc["ok"]
    assert doc["continuity_ok"] and doc["warm_fresh_builds"] == 0
    assert doc["goodput_fraction"] >= doc["goodput_floor"]
    assert doc["victims_total"] >= 2 and "exec_cache" not in doc
    # the JAX bench's goodput arithmetic on the same trace: 2 cycles of
    # (2 full steps, a reclaimed step, 3 outage steps at half width, 2
    # full steps), then 2 full steps
    assert doc["achieved_rank_steps"] == 52
    assert doc["ideal_rank_steps"] == 64
    report = _tool("postmortem").report_from_files([doc["flight_bundle"]])
    assert report["verdict"]["failure_kind"] == "preempted"
