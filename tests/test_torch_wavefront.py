"""The wavefront renderer (wavefront.py) against the JAX package's and
against the port's `render`, statistically at the JAX tests' bounds
(tests/test_wavefront.py), and its work accounting exactly: every work
item consumed once, camera rays keyed by the work item alone, images
reproducible bit for bit. On the CPU the closest hit is
`ops.intersect.closest_hit` (the card's is K4); no kernel runs here.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from raytracingproject_tpu import scene as jscene
from raytracingproject_tpu.camera import Camera as JCamera
from raytracingproject_tpu.wavefront import render_wavefront_image as jrender_wavefront_image

from raytracingproject_tpu_torch import wavefront
from raytracingproject_tpu_torch.__main__ import main as cli_main
from raytracingproject_tpu_torch.camera import Camera, rays_from_uniforms
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.ops.cuda import trace
from raytracingproject_tpu_torch.ops.intersect import closest_hit
from raytracingproject_tpu_torch.render import render, sky_color
from raytracingproject_tpu_torch.scene import make_minimal_scene, make_three_sphere_scene
from raytracingproject_tpu_torch.utils.ppm import read_ppm
from raytracingproject_tpu_torch.wavefront import (
    render_wavefront, render_wavefront_image, wavefront_pool_size, work_uniforms,
)

CPU = RenderSettings(device="cpu")
ORACLE = RenderSettings(device="cpu", use_megakernel=False, use_bvh=False)


def cam_kw(spp=32, depth=8, width=48):
    """tests/test_wavefront.py's camera."""
    return dict(aspect_ratio=16.0 / 9.0, image_width=width, samples_per_pixel=spp,
                max_depth=depth, vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
                defocus_angle=0.0, focus_dist=1.0)


def cam(**kw):
    return Camera(**cam_kw(**kw))


def _sky_only():
    b = make_minimal_scene()
    return dataclasses.replace(b, center0=b.center0 + 1e6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread for this module: its shapes are too small to
    split, and it keeps the workers of a parallel test run from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def three_48spp():
    """The port's wavefront image of the three-sphere scene at 48 spp."""
    return render_wavefront_image(make_three_sphere_scene(), cam(spp=48),
                                  torch.Generator().manual_seed(0), CPU).numpy()


def test_matches_jax_wavefront_statistics(three_48spp):
    """Against JAX's render_wavefront_image: tests/test_wavefront.py's
    bounds (mean |diff| < 0.02, 99th percentile < 0.16)."""
    want = np.asarray(jrender_wavefront_image(jscene.make_three_sphere_scene(),
                                              JCamera(**cam_kw(spp=48)), jax.random.PRNGKey(1)))
    diff = np.abs(three_48spp - want)
    assert diff.mean() < 0.02, diff.mean()
    assert np.quantile(diff, 0.99) < 0.16, np.quantile(diff, 0.99)


def test_matches_render_statistics(three_48spp):
    """Against the port's `render` (the oracle, the JAX package's default
    path), at the same bounds."""
    mk = render(make_three_sphere_scene(), cam(spp=48), torch.Generator().manual_seed(1),
                ORACLE).numpy()
    diff = np.abs(three_48spp - mk)
    assert diff.mean() < 0.02, diff.mean()
    assert np.quantile(diff, 0.99) < 0.16, np.quantile(diff, 0.99)


def test_small_pool_still_completes():
    """A 4096-ray pool for 9,216 work items on a sky-only scene: the queue
    drains (a lost sample would darken pixels by 1/spp = 0.06), within
    the JAX test's 0.02 of `render`."""
    c = cam(spp=16, width=32)
    img = render_wavefront_image(_sky_only(), c, torch.Generator().manual_seed(2),
                                 RenderSettings(rays_per_batch=4096, device="cpu")).numpy()
    ref = render(_sky_only(), c, torch.Generator().manual_seed(3), ORACLE).numpy()
    np.testing.assert_allclose(img, ref, atol=0.02)


@pytest.mark.parametrize("pool", [4096, 1 << 14])
def test_every_work_item_consumed_once(monkeypatch, pool):
    """With a sky of radiance 1, every pixel of a sky-only scene sums
    exactly spp: each work item terminates once, whatever the pool."""
    monkeypatch.setattr(wavefront, "sky_color", lambda d: torch.ones_like(d))
    c = cam(spp=16, width=32)
    w, h = c.image_size()
    stats = {}
    acc = render_wavefront(_sky_only(), c.derive(), torch.Generator().manual_seed(4), width=w,
                           height=h, spp=16, max_depth=8, pool_size=pool, stats=stats)
    assert torch.equal(acc, torch.full((h, w, 3), 16.0))
    # one bounce each: the pool drains in ceil(work / pool) iterations
    assert stats == {"iterations": -(-w * h * 16 // pool)}


def test_camera_rays_keyed_by_work_item():
    """A work item's camera ray depends on the key and its id alone: a
    sky-only image is the same at pool 4096 and 65536, and equals the sum
    over samples of the sky along each work item's ray made directly from
    `work_uniforms`."""
    c = cam(spp=8, width=40)
    w, h = c.image_size()
    kw = dict(width=w, height=h, spp=8, max_depth=4)
    small = render_wavefront(_sky_only(), c.derive(), torch.Generator().manual_seed(6),
                             pool_size=4096, **kw)
    big = render_wavefront(_sky_only(), c.derive(), torch.Generator().manual_seed(6),
                           pool_size=65536, **kw)
    assert torch.equal(small, big)
    key = int(torch.randint(0, 2**62, (1,), generator=torch.Generator().manual_seed(6)))
    work = torch.arange(w * h * 8)
    pix = work % (w * h)
    _, d, _ = rays_from_uniforms(c.derive(), pix % w, pix // w, *work_uniforms(work, key))
    want = sky_color(d).reshape(8, h, w, 3).sum(dim=0)
    np.testing.assert_allclose(big.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_work_uniforms_ranges():
    """The five draws lie in their ranges and are not constant."""
    offset, disk_u, theta, time = work_uniforms(torch.arange(50000), 12345)
    assert offset.min() >= -0.5 and offset.max() < 0.5
    for u, hi in ((disk_u, 1.0), (theta, 2 * np.pi), (time, 1.0)):
        assert u.min() >= 0.0 and u.max() < hi and u.std() > 0.2 * hi
    assert abs(float(time.mean()) - 0.5) < 0.01


def test_deterministic():
    """Equal seeds give equal images, bit for bit; another seed another."""
    c = cam(spp=8, width=32)
    a = render_wavefront_image(make_minimal_scene(), c, torch.Generator().manual_seed(5), CPU)
    b = render_wavefront_image(make_minimal_scene(), c, torch.Generator().manual_seed(5), CPU)
    d = render_wavefront_image(make_minimal_scene(), c, torch.Generator().manual_seed(6), CPU)
    assert torch.equal(a, b) and not torch.equal(a, d)


def test_depth_limit_kills_on_the_last_bounce():
    """A ray that hits on its max_depth-th bounce dies with nothing: at
    depth 1 the image is the sum over samples of the sky along each work
    item's camera ray where it misses every sphere, and 0 where it hits."""
    c = cam(spp=4, width=32, depth=1)
    w, h = c.image_size()
    scene = make_three_sphere_scene()
    wf = render_wavefront(scene, c.derive(), torch.Generator().manual_seed(7), width=w,
                          height=h, spp=4, max_depth=1, pool_size=4096)
    key = int(torch.randint(0, 2**62, (1,), generator=torch.Generator().manual_seed(7)))
    work = torch.arange(w * h * 4)
    pix = work % (w * h)
    o, d, t = rays_from_uniforms(c.derive(), pix % w, pix // w, *work_uniforms(work, key))
    hit = closest_hit(o, d, t, scene.center0, scene.center_delta, scene.radius).hit
    want = torch.where(hit[:, None], 0.0, sky_color(d)).reshape(4, h, w, 3).sum(dim=0)
    np.testing.assert_allclose(wf.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert 0.1 < float(hit.float().mean()) < 0.9


def test_pool_rule_is_jax():
    """raytracingproject_tpu/wavefront.py:224's rule."""
    for total, rpb in ((100, 1 << 17), (5000, 1 << 17), (1 << 20, 1 << 17), (9216, 4096)):
        want = max(4096, min(rpb, 1 << (total - 1).bit_length()))
        assert wavefront_pool_size(total, rpb) == want


def test_cpu_route_is_the_brute_closest_hit():
    """On the CPU the bounce's closest hit is ops.intersect.closest_hit:
    no K4 launch, and the wavefront raises for a device it has no route on
    rather than fall back."""
    before = trace.LAUNCHES["closest_hit"]
    render_wavefront_image(make_minimal_scene(), cam(spp=2, width=16), None, CPU)
    assert trace.LAUNCHES["closest_hit"] == before
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        wavefront.pool_closest_hit(o, o, o[:, 0], make_minimal_scene().to("meta"))


def test_cli_wavefront_matches_megakernel_cli(tmp_path):
    """`--wavefront --device cpu` at 32 px, 2 spp, depth 3 writes a PPM
    whose mean is within the wavefront test's 0.02 of the megakernel
    CLI's."""
    args = ["--width", "32", "--spp", "2", "--depth", "3", "--device", "cpu"]
    wf, mk = tmp_path / "wf.ppm", tmp_path / "mk.ppm"
    assert cli_main([*args, "--wavefront", "-o", str(wf)]) == 0
    assert cli_main([*args, "-o", str(mk)]) == 0
    a, b = read_ppm(wf), read_ppm(mk)
    assert a.shape == b.shape == (18, 32, 3)
    assert abs(a.mean() / 255.0 - b.mean() / 255.0) < 0.02, (a.mean(), b.mean())
