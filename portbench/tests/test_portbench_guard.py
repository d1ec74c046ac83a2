"""The import guard, and the command's refusal to run without a card or
without the program."""

from __future__ import annotations

import shutil
import subprocess
import sys
import types

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla", "flax", "raytracingproject_tpu.render"])
def test_guard_refuses_forbidden_modules(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    with pytest.raises(harness.Refused):
        harness.guard()


def test_guard_compares_whole_top_level_names(monkeypatch):
    loaded = {"raytracingproject_tpu_torch": None, "raytracingproject_tpu_torch.render": None,
              "jax_like": None, "flaxen.x": None, "torch": None}
    monkeypatch.setattr(harness.sys, "modules", loaded)
    assert harness.forbidden_modules() == []
    loaded["raytracingproject_tpu.ops"] = None
    assert harness.forbidden_modules() == ["raytracingproject_tpu"]


def test_reference_imports_nothing_of_the_program(tmp_path):
    assert harness.reference_imports() == []
    bad = tmp_path / "ref"
    shutil.copytree(harness.HERE / "reference", bad)
    (bad / "leak.py").write_text("from raytracingproject_tpu_torch.render import render\n")
    assert harness.reference_imports(bad) == ["leak.py: raytracingproject_tpu_torch.render"]


IMPORTS = {"static": "import jax\n",
           "hidden": "import importlib\nimportlib.import_module('ja' + 'x')\n"}


@pytest.mark.parametrize("how", sorted(IMPORTS))
def test_metric_that_loads_jax_refuses_the_run(tiny, tmp_path, monkeypatch, how):
    """A metric reader, loaded after the window, that imports a (stub)
    `jax`: statically, which the scan of the sources sees, or hidden from
    it, which the last look at the loaded modules sees. No result either
    way."""
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    metrics = tiny.dirs[0] / "metrics"
    metrics.mkdir()
    (metrics / "loads_jax.py").write_text(IMPORTS[how] + "\n\ndef read(run):\n    return 1.0\n")
    tiny.manifest["end_to_end"].append({"name": "loads_jax", "unit": "s", "better": "lower",
                                        "bound": 0.25, "source": "host_clock",
                                        "workloads": ["tiny.frame"]})
    had = sys.modules.pop("jax", None)
    try:
        with pytest.raises(harness.Refused, match="JAX|jax"):
            harness.run_cell(tiny, "tiny.frame", 5, 0.2, False, "cpu", 0.0,
                             log=lambda *a, **k: None)
    finally:
        sys.modules.pop("jax", None)
        if had is not None:
            sys.modules["jax"] = had


def run_command(cwd, *args):
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "cover.preview",
                           "--seed", "1", "--seconds", "1", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_command_fails_without_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = run_command(ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "needs 1 card" in res.stderr


def test_command_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = run_command(tmp_path)
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.cuda
def test_command_runs_a_cell_on_the_card(card):
    import json

    res = run_command(ROOT, "--trace", "0")
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["kind"] == card
    assert set(out["metrics"]) == {"frame_p90_s", "setup_s"}
