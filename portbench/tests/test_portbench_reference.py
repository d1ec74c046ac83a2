"""The plain reference against the port's plain versions on the CPU, at a
tiny size. (The reference itself imports nothing of the port; this test
does.)"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from portbench.reference import camera, philox
from portbench.tests.conftest import TINY_FIT
from portbench.traffic import fit as fit_traffic

SEED = 4_000_000_001


def test_block_order_matches_the_port():
    port = importlib.import_module("raytracingproject_tpu_torch.render")

    for w, h, c in ((24, 13, 1), (40, 22, 2), (9, 7, 3)):
        slot_pix, gather = camera.block_order(w, h, c)
        p_slot, p_gather = port._block_order(w, h, c, port.TILE)
        assert np.array_equal(slot_pix, p_slot) and np.array_equal(gather, p_gather)
        assert camera.pass_chunk(w, h, 30) == max(1, min(30, (1 << 17) // (w * h)))


def test_frame_pixels_equal_the_port(tiny):
    job = tiny.module("traffic", "frame").prepare(tiny, tiny.cell("tiny.frame"), SEED, "cpu")
    job.unit()
    i, img = job.kept[0]
    pix = np.arange(img.shape[0] * img.shape[1])
    ref = job.reference(i, pix)
    assert torch.equal(img.reshape(-1, 3), ref)
    assert img.shape[:2] == job.size()[::-1]


def test_fit_steps_follow_the_port(tiny):
    job = fit_traffic.prepare(tiny, tiny.cell("tiny.fit"), SEED, "cpu")
    ref = job.reference()
    assert job.losses[0] == ref["loss"][0]
    np.testing.assert_allclose(job.losses, ref["loss"], rtol=1e-5)
    got = fit_traffic.readings(job.losses, job.grad1, job.change, ref)
    assert got["grad1_gap"] < 1e-4 and got["change_gap"] < 1e-4
    assert got["grad1_norm_gap"] < 1e-4 and got["change_norm_gap"] < 1e-4
    assert TINY_FIT["params"]["check_steps"] == len(ref["loss"]) == 3


def test_philox_matches_the_port():
    from raytracingproject_tpu_torch.ops import rng as port_rng

    slot = torch.arange(0, 5000, 7, dtype=torch.int64)
    for seed, bounce in ((0, 0), (2**31 - 2, 7), (123456789, 49)):
        ours = philox.bounce_uniforms(seed, slot, bounce)
        theirs = port_rng.bounce_uniforms(seed, slot, bounce)
        assert all(torch.equal(a, b) for a, b in zip(ours, theirs))
    per_ray = philox.bounce_uniforms(torch.full_like(slot, 99), slot, 3)
    assert all(torch.equal(a, b) for a, b in zip(per_ray, philox.bounce_uniforms(99, slot, 3)))
