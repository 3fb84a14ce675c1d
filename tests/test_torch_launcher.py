"""The port's launcher (``bluefog_tpu_torch/run/launcher.py``,
``bfrun-torch``) held against the JAX package's (``tests/test_launcher.py``):

* ``-x`` / ``--timeline-filename`` / ``--fleet-view`` / the serve flags
  set the env JAX's ``_child_env`` sets;
* ``parse_hosts`` / ``parse_hostfile`` equal JAX's, refusals in JAX's
  words;
* ``build_multihost_plan``'s command lines equal JAX's but for the
  bootstrap variables (torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
  ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` in place of JAX's
  ``BLUEFOG_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID``), and
  never embed the session token;
* the stub-shell fan-out end to end, a failure propagated, the survivors
  killed;
* the supervisor: a failure named by rank and code, restart respawn with
  ``BLUEFOG_RESTART_COUNT``, restart exhaustion, JAX's pinned backoff
  schedule, the scale file's warnings, ``--scale`` signalling, an elastic
  join (a fresh rank with ``BLUEFOG_JOIN_COUNT``, the grown
  ``WORLD_SIZE`` and the master port published in ``$BLUEFOG_PORT_FILE``)
  and an elastic retire;
* ``--version`` and ``check_environment``.

The children are small Python scripts that do not import torch, as in
JAX's tests.  JAX's XLA-flag and compilation-cache tests have no
counterpart: the port adds no XLA flags and compiles no programs.
"""
import os
import random
import shlex
import sys
import time

import pytest
import torch

from bluefog_tpu.run import launcher as jl
from bluefog_tpu_torch.run import launcher as tl
from bluefog_tpu_torch.utils import metrics as tm
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

_JAX_BOOT = ("BLUEFOG_COORDINATOR", "BLUEFOG_NUM_PROCESSES",
             "BLUEFOG_PROCESS_ID")


def _env(mod, argv):
    args = mod.build_parser().parse_args(argv + ["python", "x.py"])
    return mod._child_env(args)


@pytest.mark.parametrize("argv", [
    ["-x", "FOO=bar", "-x", "BAZ=1"],
    ["--timeline-filename", "/tmp/tl", "--metrics-filename", "/tmp/m",
     "--metrics-port", "9100"],
    ["--fleet-view", "3", "--flight-dir", "fl"],
    ["--serve", "--serve-buckets", "1,2@16", "--spec-decode", "2@1",
     "--kv-dtype", "int8", "--prefix-pages", "4x16", "--refresh-every",
     "5", "--serve-moe", "8x2@2:4", "--preempt-grace", "3"],
])
def test_child_env_matches_jax(monkeypatch, argv):
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    for k in ("TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    assert _env(tl, argv) == _env(jl, argv)


def test_child_env_refusals_match_jax():
    for argv in (["-x", "MALFORMED"], ["--fleet-view", "0"]):
        with pytest.raises(SystemExit) as je:
            _env(jl, argv)
        with pytest.raises(SystemExit) as te:
            _env(tl, argv)
        assert str(te.value) == str(je.value)


def test_coordinator_requires_process_id():
    with pytest.raises(SystemExit, match="--process-id is required"):
        tl.main(["--coordinator", "h:1", "--num-processes", "2", "true"])


def test_coordinator_maps_onto_torchrun_variables(monkeypatch):
    env = {}
    args = tl.build_parser().parse_args(
        ["--coordinator", "h0:1234", "--num-processes", "4",
         "--process-id", "3", "python", "x.py"])
    tl._apply_coordinator_env(args, env)
    assert env == {"MASTER_ADDR": "h0", "MASTER_PORT": "1234",
                   "WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "0"}


def test_parse_hosts_matches_jax():
    spec = "h1,h2:2, h3:4"
    assert tl.parse_hosts(spec) == jl.parse_hosts(spec) == [
        ("h1", 1), ("h2", 2), ("h3", 4)]
    for mod in (jl, tl):
        with pytest.raises(SystemExit):
            mod.parse_hosts(" , ")


def test_parse_hostfile_matches_jax(tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("# cluster\nh1 slots=4\n\nh2   # default one slot\n"
                  "h3 slots=2\n")
    assert tl.parse_hostfile(str(hf)) == jl.parse_hostfile(str(hf)) == [
        ("h1", 4), ("h2", 1), ("h3", 2)]
    for bad in ("h1 gpus=4\n", "# nothing\n", "h1 slots=abc\n",
                "h1 slots=0\n"):
        hf.write_text(bad)
        with pytest.raises(SystemExit) as je:
            jl.parse_hostfile(str(hf))
        with pytest.raises(SystemExit) as te:
            tl.parse_hostfile(str(hf))
        assert str(te.value) == str(je.value)


def _split(remote):
    """``cd X && exec env K=V ... cmd`` -> (cd part, env dict, cmd)."""
    head, _, rest = remote.partition(" && exec env ")
    words = shlex.split(rest)
    env, i = {}, 0
    while i < len(words) and "=" in words[i] and \
            words[i].split("=", 1)[0].isupper():
        k, v = words[i].split("=", 1)
        env[k] = v
        i += 1
    return head, env, words[i:]


def test_multihost_plan_differs_from_jax_only_in_bootstrap_vars():
    kw = dict(cwd="/work dir",
              base_env={"BLUEFOG_LOG_LEVEL": "debug", "HOME": "/root",
                        "BLUEFOG_SESSION_TOKEN": "s3cret"},
              extra_env=["FOO=a b"], remote_shell="ssh", ssh_port=2222)
    hosts = [("alice@h1", 1), ("h2", 2)]
    cmd = ["python", "train.py", "--lr", "0.1"]
    jp = jl.build_multihost_plan(hosts, cmd, **kw)
    tp = tl.build_multihost_plan(hosts, cmd, **kw)
    assert [(h, p) for h, p, _ in tp] == [(h, p) for h, p, _ in jp] == [
        ("alice@h1", 0), ("h2", 1), ("h2", 2)]
    for (_, pid, ta), (_, _, ja), local in zip(tp, jp, (0, 0, 1)):
        assert ta[:-1] == ja[:-1] == ["ssh", "-p", "2222", ta[3]]
        th, tenv, tcmd = _split(ta[-1])
        jh, jenv, jcmd = _split(ja[-1])
        assert (th, tcmd) == (jh, jcmd)
        assert tcmd == cmd
        assert {k: v for k, v in jenv.items() if k not in _JAX_BOOT} == \
            {k: v for k, v in tenv.items() if k not in tl.LAUNCH_VARS}
        assert jenv["BLUEFOG_COORDINATOR"] == "h1:48292"
        assert {k: tenv[k] for k in tl.LAUNCH_VARS} == {
            "MASTER_ADDR": "h1", "MASTER_PORT": "48292", "WORLD_SIZE": "3",
            "RANK": str(pid), "LOCAL_RANK": str(local)}
        assert "s3cret" not in ta[-1] and "HOME=" not in ta[-1]
    plans = tl.build_multihost_plan([("h1", 1)], ["true"], cwd="/",
                                    coordinator="c0:7777")
    assert "MASTER_ADDR=c0 MASTER_PORT=7777" in plans[0][2][-1]


def _stub(tmp_path, log=None):
    stub = tmp_path / "fake_ssh"
    rec = f'echo "$@" >> {log}\n' if log else ""
    stub.write_text(f'#!/bin/sh\n{rec}host="$1"; shift\nexec sh -c "$@"\n')
    stub.chmod(0o755)
    return stub


def test_multihost_fanout_e2e_with_stub_shell(tmp_path):
    log = tmp_path / "calls.log"
    stub = _stub(tmp_path, log)
    out = tmp_path / "ranks"
    code = tl.main(
        ["-H", "hostA,hostB:2", "--remote-shell", str(stub), "--",
         sys.executable, "-c",
         "import os,pathlib; pathlib.Path("
         f"'{out}' + os.environ['RANK']).write_text(' '.join("
         "os.environ[k] for k in ('WORLD_SIZE', 'LOCAL_RANK', "
         "'MASTER_ADDR', 'MASTER_PORT')))"])
    assert code == 0
    calls = log.read_text().splitlines()
    assert sorted(c.split()[0] for c in calls) == ["hostA", "hostB",
                                                   "hostB"]
    assert (out.parent / "ranks0").read_text() == "3 0 hostA 48292"
    assert (out.parent / "ranks1").read_text() == "3 0 hostA 48292"
    assert (out.parent / "ranks2").read_text() == "3 1 hostA 48292"


def test_multihost_fanout_propagates_failure(tmp_path):
    code = tl.main(
        ["-H", "h1,h2", "--remote-shell", str(_stub(tmp_path)), "--",
         sys.executable, "-c",
         "import os,sys; sys.exit(3 if os.environ['RANK'] == '1' else 0)"])
    assert code == 3


def test_multihost_fanout_kills_survivors_on_failure(tmp_path):
    t0 = time.perf_counter()
    code = tl.main(
        ["-H", "h1,h2", "--remote-shell", str(_stub(tmp_path)), "--",
         sys.executable, "-c",
         "import os,sys,time\n"
         "sys.exit(2) if os.environ['RANK'] == '0' else time.sleep(600)"])
    assert code == 2
    assert time.perf_counter() - t0 < 60


def test_multihost_restart_respawns_remote_argv(tmp_path, capsys):
    marker = tmp_path / "died_once"
    code = tl.main(
        ["-H", "h1,h2", "--remote-shell", str(_stub(tmp_path)),
         "--restart-limit", "1", "--restart-backoff", "0.01", "--",
         sys.executable, "-c",
         "import os,sys,pathlib\n"
         f"m = pathlib.Path('{marker}')\n"
         "if os.environ['RANK'] == '1' and not m.exists():\n"
         "    m.write_text('x'); sys.exit(11)\n"
         "sys.exit(0)"])
    assert code == 0
    err = capsys.readouterr().err
    assert "bfrun-torch: rank 1 on h2 exited with code 11" in err
    assert "restarting rank 1 on h2" in err


def test_version_flag(capsys):
    assert tl.main(["--version"]) == 0
    assert "bluefog_tpu_torch 0." in capsys.readouterr().out


def test_check_environment(capsys):
    """No card on this machine: the diagnosis is printed whole and the
    check fails, since the port runs on CUDA unless asked."""
    assert tl.check_environment() == 1
    out = capsys.readouterr().out
    assert "bluefog_tpu_torch 0." in out
    assert "torch " in out and "nvcc: " in out
    assert "native (C++) components" in out
    assert out.strip().splitlines()[-1].startswith(
        "devices: no CUDA device visible")


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def test_local_failure_names_rank_and_code(capsys):
    t0 = time.perf_counter()
    code = tl.main(
        ["-np", "2", "--", sys.executable, "-c",
         "import os,sys,time\n"
         "sys.exit(5) if os.environ['RANK'] == '0' else time.sleep(600)"])
    assert code == 5
    assert time.perf_counter() - t0 < 60
    err = capsys.readouterr().err
    assert "rank 0 exited with code 5" in err
    assert "job failed: rank 0 exited with code 5" in err


def test_restart_limit_respawns_dead_rank(capsys):
    tm.reset_metrics()
    code = tl.main(
        ["-np", "1", "--restart-limit", "2", "--restart-backoff", "0.01",
         "--", sys.executable, "-c",
         "import os,sys; sys.exit(0 if os.environ.get("
         "'BLUEFOG_RESTART_COUNT') == '1' and os.environ['RANK'] == '0' "
         "and os.environ['WORLD_SIZE'] == '1' else 9)"])
    assert code == 0
    err = capsys.readouterr().err
    assert "rank 0 exited with code 9" in err
    assert "restarting rank 0 (attempt 1/2)" in err
    assert tm.counter("bluefog_rank_restarts_total").total() == 1
    tm.reset_metrics()


def test_restart_limit_exhausted_fails_with_count(capsys):
    code = tl.main(
        ["-np", "1", "--restart-limit", "1", "--restart-backoff", "0.01",
         "--", sys.executable, "-c", "import sys; sys.exit(7)"])
    assert code == 7
    err = capsys.readouterr().err
    assert "job failed: rank 0 exited with code 7 after 1 restart(s)" in err


def test_restart_backoff_schedule_pinned(monkeypatch, capsys):
    """JAX's schedule: attempt a sleeps ``backoff * 2**(a-1)`` scaled by
    +0..25 % from ``random.Random(f"bfrun:{rank}:{a}")``."""
    base_backoff = 0.5
    slept = []
    real_sleep = time.sleep
    monkeypatch.setattr(
        time, "sleep",
        lambda d: slept.append(d) if d >= base_backoff else real_sleep(d))
    code = tl.main(
        ["-np", "1", "--restart-limit", "3",
         "--restart-backoff", str(base_backoff),
         "--", sys.executable, "-c", "import sys; sys.exit(7)"])
    assert code == 7
    err = capsys.readouterr().err
    expected = []
    for attempt in (1, 2, 3):
        base = base_backoff * (2 ** (attempt - 1))
        delay = base * (
            1.0 + 0.25 * random.Random(f"bfrun:0:{attempt}").random())
        expected.append(delay)
        assert (f"restarting rank 0 (attempt {attempt}/3) "
                f"after {delay:.2f} s backoff") in err
    assert slept == pytest.approx(expected)


def test_read_scale_warns_once(tmp_path, capsys):
    tl._warned_scale.clear()
    scale = tmp_path / "scale"
    scale.write_text("six\n")
    assert tl._read_scale(str(scale)) is None
    assert tl._read_scale(str(scale)) is None
    err = capsys.readouterr().err
    assert err.count("bfrun-torch: ignoring malformed scale file") == 1
    assert "'six'" in err and str(scale) in err
    scale.write_text("0")
    assert tl._read_scale(str(scale), min_world=1) is None
    assert tl._read_scale(str(scale), min_world=1) is None
    assert capsys.readouterr().err.count(
        "target 0 is below the minimum world size 1") == 1
    assert tl._read_scale(str(tmp_path / "absent")) is None
    assert capsys.readouterr().err == ""
    tl._warned_scale.clear()


def test_scale_signalling_mode(tmp_path, capsys):
    scale = tmp_path / "scale"
    assert tl.main(["--scale", "3", "--scale-file", str(scale)]) == 0
    assert scale.read_text().strip() == "3"
    assert f"scale target 3 written to {scale}" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="positive"):
        tl.main(["--scale", "0", "--scale-file", str(scale)])


def test_elastic_join_spawns_fresh_rank_and_publishes_port(tmp_path,
                                                           capsys):
    scale = tmp_path / "scale"
    marker = tmp_path / "marker"
    prog = (
        "import os, sys, time\n"
        "rank = os.environ['RANK']\n"
        "jc = os.environ.get('BLUEFOG_JOIN_COUNT')\n"
        "if jc:\n"
        "    line = open(os.environ['BLUEFOG_PORT_FILE']).read().split()\n"
        "    open(%r, 'w').write('JOIN_COUNT=%%s RANK=%%s WORLD_SIZE=%%s '\n"
        "        'PUBLISHED=%%s' %% (jc, rank, os.environ['WORLD_SIZE'],\n"
        "        line == [os.environ['WORLD_SIZE'],\n"
        "                 os.environ['MASTER_PORT']]))\n"
        "    sys.exit(0)\n"
        "if rank == '0':\n"
        "    open(%r, 'w').write('3')\n"
        "    for _ in range(600):\n"
        "        if os.path.exists(%r): sys.exit(0)\n"
        "        time.sleep(0.05)\n"
        "    sys.exit(1)\n"
        "sys.exit(0)\n" % (str(marker), str(scale), str(marker)))
    # a port an earlier job left for the same count is never taken
    (tmp_path / "scale.port").write_text("3 1\n")
    code = tl.main(["-np", "2", "--elastic", "--scale-file", str(scale),
                    "--", sys.executable, "-c", prog])
    assert code == 0
    assert "elastic join: starting rank 2 (target 3)" in \
        capsys.readouterr().err
    assert marker.read_text() == \
        "JOIN_COUNT=1 RANK=2 WORLD_SIZE=3 PUBLISHED=True"


def test_supervisor_empties_the_port_file_at_start(tmp_path):
    scale = tmp_path / "scale"
    marker = tmp_path / "marker"
    (tmp_path / "scale.port").write_text("2 1\n")
    prog = ("import os\n"
            "open(%r, 'w').write(str(os.path.exists(\n"
            "    os.environ['BLUEFOG_PORT_FILE'])))\n" % str(marker))
    assert tl.main(["-np", "1", "--elastic", "--scale-file", str(scale),
                    "--", sys.executable, "-c", prog]) == 0
    assert marker.read_text() == "False"


def test_next_master_port_takes_only_its_process_count(tmp_path,
                                                       monkeypatch):
    from bluefog_tpu_torch.parallel import context as tctx
    port_file = tmp_path / "scale.port"
    monkeypatch.setenv("MASTER_PORT", "5000")
    monkeypatch.setenv(tctx.PORT_FILE_ENV, str(port_file))
    port_file.write_text("2 5001\n")
    with pytest.raises(RuntimeError, match="no MASTER_PORT for 3 "
                                           "processes"):
        tctx._next_master_port(3, timeout=0.2)
    port_file.write_text("3 5000\n")        # the port torn down from
    with pytest.raises(RuntimeError, match="no MASTER_PORT for 3"):
        tctx._next_master_port(3, timeout=0.2)
    tl._publish_port(str(port_file), 3, 5002)
    assert tctx._next_master_port(3, timeout=0.2) == "5002"


def test_unpublished_shrink_is_refused_before_teardown(tmp_path,
                                                       monkeypatch):
    from bluefog_tpu_torch.parallel import context as tctx
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "5000")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv(tctx.PORT_FILE_ENV, str(tmp_path / "scale.port"))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="publishes a port only for an "
                                           "elastic join"):
        tctx._rebootstrap_distributed(2, 0, torch.device("cpu"))
    assert time.perf_counter() - t0 < 1.0
    assert os.environ["WORLD_SIZE"] == "3"


def test_elastic_retire_sigterms_highest_ranks(tmp_path, capsys):
    scale = tmp_path / "scale"
    prog = (
        "import os, sys, time\n"
        "rank = os.environ['RANK']\n"
        "if rank == '0':\n"
        "    time.sleep(0.3)\n"
        "    open(%r, 'w').write('1')\n"
        "    sys.exit(0)\n"
        "if rank == '1':\n"
        "    sys.exit(0)\n"
        "time.sleep(600)\n" % str(scale))
    t0 = time.perf_counter()
    code = tl.main(["-np", "3", "--elastic", "--scale-file", str(scale),
                    "--", sys.executable, "-c", prog])
    assert code == 0
    assert time.perf_counter() - t0 < 60
    err = capsys.readouterr().err
    assert "elastic retire: stopping rank 2 (target 1)" in err
    assert "rank 2 retired (exit code" in err
