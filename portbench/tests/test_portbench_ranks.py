"""The rank launcher (portbench/ranks.py) through `run_cell`, on a throwaway
four-rank gloo cell whose files lie in a temporary directory (its
workload, and its traffic kind: a copy of tests/ranked.py), so a cell over
several cards is added without an edit to the harness. A clean run, the
fullest rank's peak, the ranks' spans, and the refusals, each test within
its own time limit and with no worker left alive; and run.py's pinning
of each rank's cores, in a child process."""

from __future__ import annotations

import contextlib
import copy
import json
import multiprocessing
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import uuid
from pathlib import Path

import pytest

from portbench import ranks
from portbench.harness import HERE, Bench, Refused, run_cell
from portbench.tests.conftest import ROOT, add_cell, manifest

SEED = 2**31 + 1234
TIMEOUT_S = 6.0
SETUP_TIMEOUT_S = 120.0
RANKED = {"kind": "ranked",
          "params": {"length": 64, "fault": "", "fault_rank": 2, "peak": 0, "trace_units": 2},
          "limits": {"sum_gap": 1e-9}}


@pytest.fixture(autouse=True)
def short_timeouts(monkeypatch):
    """The launcher's waits, cut to the tests' size."""
    monkeypatch.setattr(ranks, "TIMEOUT_S", TIMEOUT_S)
    monkeypatch.setattr(ranks, "SETUP_TIMEOUT_S", SETUP_TIMEOUT_S)


def quiet(*args, **kwargs):
    pass


@contextlib.contextmanager
def within(seconds: float):
    """Fail the test once `seconds` have passed."""
    def over(*_):
        raise TimeoutError(f"the test ran past its limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, over)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def spawned(mark: str | None = None) -> list[str]:
    """Live processes of the rank launcher: this process's children that
    run multiprocessing's spawn_main, or, with `mark`, any process whose
    environment holds it."""
    me, found = str(os.getpid()), []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
            cmd = (d / "cmdline").read_bytes()
            env = (d / "environ").read_bytes() if mark else b""
        except OSError:
            continue
        parent = stat.rsplit(")", 1)[1].split()[1]
        if (mark and mark.encode() in env) or (parent == me and b"spawn_main" in cmd):
            found.append(f"{d.name}: {cmd[:80]!r}")
    return found


def left_after(mark: str, seconds: float = 5.0) -> list[str]:
    """The processes marked `mark` still alive `seconds` on (multiprocessing's
    resource tracker ends a moment after the last process it served)."""
    due = time.monotonic() + seconds
    while (found := spawned(mark)) and time.monotonic() < due:
        time.sleep(0.1)
    return found


def assert_no_worker_left():
    assert multiprocessing.active_children() == []
    assert spawned() == []


def ranked(tmp_path: Path, **params) -> tuple[dict, Path]:
    """The manifest with the four-rank cell `tiny.x4` added as files under
    `tmp_path`, reporting what `cover.fit` reports."""
    m = copy.deepcopy(manifest())
    spec = copy.deepcopy(RANKED)
    spec["params"].update(params)
    (tmp_path / "traffic").mkdir()
    shutil.copy(HERE / "tests" / "ranked.py", tmp_path / "traffic" / "ranked.py")
    add_cell(tmp_path, m, "tiny.x4", "cover488", spec, "cover.fit", chips=4)
    return m, tmp_path


def run(tmp_path: Path, trace: bool = False, **params) -> dict:
    m, d = ranked(tmp_path, **params)
    return run_cell(Bench(m, [d, HERE]), "tiny.x4", SEED, 0.5, trace, "cpu",
                    time.perf_counter(), log=quiet)


def test_a_clean_run_is_correct(tmp_path):
    with within(90):
        out = run(tmp_path)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["sum_gap"]["value"] <= 1e-9
    # no rank read a peak (the CPU's is 0), so memory_peak_gb reads nothing
    assert set(out["metrics"]) == {"setup_s"}
    assert_no_worker_left()


def test_peak_is_the_fullest_ranks(tmp_path):
    """Rank r reports r * 1000 bytes (rank 0: the CPU's 0): the line gives
    the largest."""
    with within(90):
        out = run(tmp_path, peak=1000)
    assert out["correct"] is True
    assert out["device"]["memory_peak_bytes"] == 3000
    assert out["metrics"]["memory_peak_gb"]["value"] == 3000 / 1e9
    assert_no_worker_left()


def test_traced_run_gives_every_ranks_spans(tmp_path):
    """A metric added as a file reads the spans that each rank's job timed,
    which come back at release."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "ranks_timed.py").write_text(
        "def read(run):\n    return sum(1 for s in run.rank_spans if s.get('unit'))\n")
    m, d = ranked(tmp_path)
    m["per_layer"].append({"name": "ranks_timed", "unit": "ranks", "better": "higher",
                           "source": "program_span", "layer": "ranks", "moves": "memory_peak_gb",
                           "workloads": ["tiny.x4"]})
    with within(90):
        out = run_cell(Bench(m, [d, HERE]), "tiny.x4", SEED, 5.0, True, "cpu",
                       time.perf_counter(), log=quiet)
    assert out["correct"] is True
    assert out["metrics"]["ranks_timed"]["value"] == 4
    assert_no_worker_left()


FAULTS = {"raise": r"rank 2 raised:\n(.|\n)*ValueError: a planted fault",
          "die": r"rank 2 died \(exit code 3\)",
          "sleep": r"rank\(s\) ([0-9, ]*, )?2(, [0-9, ]*)? did not answer in time"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_faulty_rank_refuses_the_run(tmp_path, monkeypatch, fault):
    """A rank that raises, dies or sleeps past the timeout at the window's
    first unit: no result, the rank named (and its traceback), within the
    timeout and 10 s of that unit's start, and no worker left."""
    starts = []
    unit = ranks.World.unit

    def timed(world):
        starts.append(time.monotonic())
        unit(world)

    monkeypatch.setattr(ranks.World, "unit", timed)
    with within(120):
        with pytest.raises(Refused) as got:
            run(tmp_path, fault=fault)
        late = time.monotonic() - starts[-1]
    assert re.search(FAULTS[fault], str(got.value)), str(got.value)
    assert late < TIMEOUT_S + 10
    assert_no_worker_left()


def test_a_worker_that_loads_jax_refuses_the_run(tmp_path, monkeypatch):
    """Rank 2 imports a stub `jax` at set-up: the launcher's look at each
    worker's modules refuses the run."""
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    with within(90):
        with pytest.raises(Refused, match="forbidden modules loaded: rank 2: jax"):
            run(tmp_path, fault="jax")
    assert "jax" not in sys.modules
    assert_no_worker_left()


HARD = """
import json, sys, time
from portbench import ranks
from portbench.harness import HERE, Bench, run_cell
ranks.EXIT_ON_FAULT = {"gloo"}
ranks.TIMEOUT_S, ranks.SETUP_TIMEOUT_S = float(sys.argv[4]), float(sys.argv[5])
m = json.loads(sys.argv[1])
out = run_cell(Bench(m, [sys.argv[2], HERE]), "tiny.x4", int(sys.argv[3]), 0.5, False, "cpu",
               time.perf_counter())
print(json.dumps(out))
"""


def test_a_dead_rank_ends_the_process_where_waits_cannot_be_left(tmp_path):
    """Under NCCL rank 0 cannot leave a collective whose peer is gone; the
    watch thread ends the run. Shown on gloo in a child process: exit code
    1, no result, the dead rank named, and no worker left behind."""
    m, d = ranked(tmp_path, fault="die")
    mark = f"PORTBENCH_TEST_{uuid.uuid4().hex}"
    env = dict(os.environ, **{mark: "1"})
    with within(150):
        res = subprocess.run([sys.executable, "-c", HARD, json.dumps(m), str(d), str(SEED),
                              str(TIMEOUT_S), str(SETUP_TIMEOUT_S)],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=140)
    assert res.returncode == 1, res.stderr[-3000:]
    assert res.stdout == ""
    assert "rank 2 died (exit code 3)" in res.stderr
    assert left_after(mark) == []


def test_the_workers_die_with_rank_0(tmp_path):
    """Rank 0 killed (SIGKILL, as at a time limit) while rank 2 sleeps in
    a unit and the others wait in its collective: every worker ends with
    it."""
    m, d = ranked(tmp_path, fault="sleep")
    mark = f"PORTBENCH_TEST_{uuid.uuid4().hex}"
    env = dict(os.environ, **{mark: "1"})
    with within(150):
        proc = subprocess.Popen([sys.executable, "-c", HARD, json.dumps(m), str(d), str(SEED),
                                 "600", str(SETUP_TIMEOUT_S)], cwd=ROOT, env=env,
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        try:
            while sum(b"spawn_main" in s.encode() for s in spawned(mark)) < 3:
                assert proc.poll() is None, "the run ended before its workers started"
                time.sleep(0.2)
            time.sleep(5.0)
        finally:
            proc.kill()
            proc.wait()
    assert left_after(mark) == []


PIN = """
import json, os
from portbench.run import core_plan, steady_host
have = sorted(os.sched_getaffinity(0))
one = steady_host(1)
pinned_one = sorted(os.sched_getaffinity(0))
os.sched_setaffinity(0, have)
four = steady_host(4)
pinned_four = sorted(os.sched_getaffinity(0))
print(json.dumps({"have": have, "one": one, "pinned_one": pinned_one, "four": four,
                  "pinned_four": pinned_four, "wide": core_plan(list(range(32)), 4),
                  "narrow": core_plan(list(range(8)), 4)}))
"""


def test_each_rank_gets_its_own_cores():
    """In a child process (this one's affinity stays as it is): a one-chip
    cell pins cores[1:3] as before; four ranks get disjoint pairs on a
    host with enough cores, rank 0 the same pair, and share round robin
    (said on standard error) on one without."""
    with within(60):
        res = subprocess.run([sys.executable, "-c", PIN], cwd=ROOT, capture_output=True,
                             text=True, timeout=50)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout)
    have = got["have"]
    assert got["one"] == [got["pinned_one"]]
    assert got["pinned_one"] == (have[1:3] if len(have) >= 3 else have)
    assert got["pinned_four"] == got["pinned_one"] and got["four"][0] == got["pinned_one"]
    wide, shared = got["wide"]
    assert wide == [[1, 2], [3, 4], [5, 6], [7, 8]] and shared is False
    narrow, shared = got["narrow"]
    assert narrow == [[1, 2], [3, 4], [5, 6], [1, 7]] and shared is True
    if len(have) >= 9:
        flat = [c for pair in got["four"] for c in pair]
        assert len(flat) == len(set(flat)) == 8
    else:
        assert "share the cores" in res.stderr
