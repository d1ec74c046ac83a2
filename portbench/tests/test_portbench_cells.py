"""A cell, a configuration and a metric added as files run without an
edit to any file of the harness; and every traffic kind makes the same
inputs from the same seed."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from portbench.harness import HERE, Bench, Run, run_cell
from portbench.tests.conftest import TINY_FRAME, add_cell, manifest

SEED = 2**31 + 977  # beyond 32 signed bits: seeds may be


def quiet(*args, **kwargs):
    pass


def test_cell_config_and_metric_added_as_files(tmp_path):
    m = manifest()
    (tmp_path / "configs").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = json.loads((HERE / "configs" / "random50k.json").read_text())
    cfg.update(name="random200", spheres=200)
    (tmp_path / "configs" / "random200.json").write_text(json.dumps(cfg))
    (tmp_path / "metrics" / "frames_done.py").write_text(
        "def read(run):\n    return len(run.latencies) if run.latencies else None\n")
    m["configs"].append({"name": "random200", "source": "test", "file": "x", "reduced": [],
                         "why": "test"})
    m["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                            "bound": 0.25, "source": "host_clock", "workloads": ["tiny.r200"]})
    add_cell(tmp_path, m, "tiny.r200", "random200", TINY_FRAME, "rand50k.preview")
    out = run_cell(Bench(m, [tmp_path, HERE]), "tiny.r200", SEED, 0.5, False, "cpu",
                   time.perf_counter(), log=quiet)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"frame_s", "frame_p90_s", "setup_s", "frames_done"}
    assert out["metrics"]["frames_done"]["value"] == out["attempted"] >= 1
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny.frame", "tiny.fit"])
def test_traced_run_reads_its_layer_metrics(tiny, cell):
    out = run_cell(tiny, cell, SEED, 5.0, True, "cpu", time.perf_counter(), log=quiet)
    assert out["correct"] is True
    # on the CPU no device metric has anything to read; the host ones do
    expected = {"tiny.frame": {"prep_ms.frame"}, "tiny.fit": {"replay_ms.fit", "step_ms.fit"}}[cell]
    assert set(out["metrics"]) == expected
    assert out["device"]["window_s"] > 0 and out["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("peak,gb", [(0, None), (3_010_962_432, 3.010962432)])
def test_memory_peak_reads_the_fullest_card(peak, gb):
    """The run's peak in 10**9 bytes, every digit kept; nothing where no
    peak was read (a CPU run)."""
    read = Bench(manifest()).module("metrics", "memory_peak_gb").read
    assert read(Run(setup_s=1.0, memory_peak_bytes=peak)) == gb


@pytest.mark.parametrize("config", ["cover488", "random50k"])
def test_scene_from_seed(config):
    bench = Bench(manifest())
    cfg = bench.data("configs", config)
    if config == "random50k":
        cfg = dict(cfg, spheres=5000)
    a, b, c = (bench.scene_arrays(cfg, s) for s in (SEED, SEED, SEED + 1))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["center0"], c["center0"])
    counts = [np.bincount(x["mat_type"][1:], minlength=3) for x in (a, c)]
    if config == "random50k":  # exact shares: the same work on every seed
        assert np.array_equal(counts[0], counts[1]) and counts[0].sum() == 4999
    assert a["radius"][0] == 1000.0 and a["center0"].dtype == np.float32


@pytest.mark.parametrize("cell", ["tiny.frame", "tiny.fit"])
def test_inputs_from_seed(tiny, cell):
    c = tiny.cell(cell)
    traffic = tiny.module("traffic", c.kind)
    jobs = [traffic.prepare(tiny, c, s, "cpu") for s in (SEED, SEED, SEED + 1)]
    if c.kind == "frame":
        draw = [torch.rand(4, generator=j.generator(3)) for j in jobs]
        sample = [j.sample(3) for j in jobs]
        same = [np.array_equal(j.arrays["albedo"], jobs[0].arrays["albedo"]) for j in jobs]
    else:
        draw = [j.target for j in jobs]
        sample = [j.losses for j in jobs]
        same = [np.array_equal(j.start["albedo"], jobs[0].start["albedo"]) for j in jobs]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    assert np.array_equal(sample[0], sample[1])
    assert same == [True, True, False]
