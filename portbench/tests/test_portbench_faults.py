"""The comparison that decides `correct`, shown to fail: the control (the
plain reference in bfloat16 in the program's place) and the planted
faults, at a size a test run holds, on the CPU. Each fault drives a whole
run of a throwaway cell (set-up, window, check) with the timed path
broken underneath."""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import pytest
import torch

from portbench.harness import run_cell
from portbench.reference import frame as ref_frame
from portbench.tests.conftest import TINY_FIT

SEED = 2**31 + 4242


def quiet(*args, **kwargs):
    pass


def run(bench, cell):
    return run_cell(bench, cell, SEED, 0.5, False, "cpu", time.perf_counter(), log=quiet)


def test_sound_runs_are_correct(tiny):
    assert run(tiny, "tiny.frame")["correct"] and run(tiny, "tiny.fit")["correct"]


def test_frame_control_fails(tiny, monkeypatch):
    """The plain reference computed in bfloat16, rendering every pixel."""
    port = importlib.import_module("raytracingproject_tpu_torch.render")

    cfg = tiny.cell("tiny.frame").config

    def control(scene, camera, gen, settings):
        arrays = {k: getattr(scene, k).cpu().numpy() for k in
                  ("center0", "center_delta", "radius", "mat_type", "albedo", "fuzz", "ior")}
        w, h = camera.image_size()
        img = ref_frame.pixels(arrays, cfg["camera"], w, h, camera.samples_per_pixel,
                               camera.max_depth, gen, np.arange(w * h), torch.bfloat16)
        return img.reshape(h, w, 3)

    monkeypatch.setattr(port, "render", control)
    out = run(tiny, "tiny.frame")
    assert out["correct"] is False
    assert out["checks"]["pixel_mean_gap"]["value"] > 10 * out["checks"]["pixel_mean_gap"]["limit"]


def test_fit_control_fails(tiny):
    from portbench.traffic import fit

    job = fit.prepare(tiny, tiny.cell("tiny.fit"), SEED, "cpu")
    ctl = job.reference(torch.bfloat16)
    got = fit.readings(ctl["loss"], ctl["grad"][0], fit.change_of(ctl), job.reference())
    assert any(got[k] > lim for k, lim in TINY_FIT["limits"].items())


def scaled_pass(port, factor):
    orig = port.render_pass

    def broken(*args, **kwargs):
        return orig(*args, **kwargs) * factor
    return broken


def half_the_samples(render):
    def broken(scene, camera, gen, settings):
        half = dataclasses.replace(camera, samples_per_pixel=camera.samples_per_pixel // 2)
        return render(scene, half, gen, settings)
    return broken


@pytest.mark.parametrize("fault", ["answer_altered", "half_the_batch"])
def test_frame_faults_fail(tiny, monkeypatch, fault):
    port = importlib.import_module("raytracingproject_tpu_torch.render")

    if fault == "answer_altered":  # every pass's radiance 2% high where the pass makes it
        monkeypatch.setattr(port, "render_pass", scaled_pass(port, 1.02))
    else:  # the first half of the samples alone, their mean the image
        monkeypatch.setattr(port, "render", half_the_samples(port.render))
    assert run(tiny, "tiny.frame")["correct"] is False


def radiance_wrapper(make, change):
    def wrapped(*args, **kwargs):
        fn = make(*args, **kwargs)
        return lambda *a, **k: change(fn(*a, **k))
    return wrapped


def first_half_twice(rad):
    half = rad.shape[0] // 2
    return torch.cat([rad[:half], rad[:half]])


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_fit_faults_fail(tiny, monkeypatch, fault):
    fast = importlib.import_module("raytracingproject_tpu_torch.grad.fast")

    if fault == "state_unchanged":  # the step returns its parameters as they came
        monkeypatch.setattr(fast, "apply_updates", lambda *a, **k: None)
    elif fault == "half_the_batch":  # the second sample's rays left out, the mean the first's
        monkeypatch.setattr(fast, "make_fast_radiance",
                            radiance_wrapper(fast.make_fast_radiance, first_half_twice))
    else:  # the radiance 2% high where the forward makes it
        monkeypatch.setattr(fast, "make_fast_radiance",
                            radiance_wrapper(fast.make_fast_radiance, lambda r: r * 1.02))
    assert run(tiny, "tiny.fit")["correct"] is False
