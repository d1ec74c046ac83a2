"""Per-material-region statistics with a planted fault, in the port
(tests/test_tpu_lane.py:180-254 of the JAX package).

The megakernel's radiance, grouped by the sphere each camera sample hits
first (the three-sphere scene: 0 ground, 1 lambertian, 2 dielectric,
3 metal; -1 sky), must match the oracle `ray_color` region by region
within 5 standard errors; with `inject_bug="schlick3"` (Schlick's
reflectance with the exponent 3 instead of 5) the dielectric region must
fail that test. The two use different random numbers (the megakernel's
Philox stream, the oracle's generator), so they agree in distribution
only. On the CPU the megakernel is its plain version; the `cuda` case runs
the `<BRUTE, SCHLICK3>` kernel on the card. Shape: 160x90, 64 spp, depth
16, as in the JAX package.
"""

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.camera import Camera, generate_rays
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
from raytracingproject_tpu_torch.ops.intersect import closest_hit
from raytracingproject_tpu_torch.render import ray_color
from raytracingproject_tpu_torch.scene import make_three_sphere_scene

SPP = 64
DEPTH = 16
# On the card the statistic takes 4x the samples: at 64 spp the planted
# fault moves the dielectric region by z ~ 5.7 (5.67 measured here on the
# CPU), close enough to 5 that another random stream could miss it.
SPP_CARD = 256


def _region_stats(scene, rays, radiance):
    """{region: (samples, mean rgb, std rgb)} by primary-hit sphere (-1 sky)."""
    o, d, t = rays
    rec = closest_hit(o, d, t, scene.center0, scene.center_delta, scene.radius)
    region = torch.where(rec.hit, rec.idx, -1).cpu().numpy()
    rad = radiance.double().cpu().numpy()
    return {int(r): (int((region == r).sum()), rad[region == r].mean(axis=0),
                     rad[region == r].std(axis=0)) for r in np.unique(region)}


def _material_rays(device, spp=SPP):
    """The three-sphere scene and its 160x90 camera samples, `spp` a pixel."""
    scene = make_three_sphere_scene(device=device)
    cam = Camera(aspect_ratio=16 / 9, image_width=160, samples_per_pixel=spp,
                 max_depth=DEPTH, vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0))
    w, h = cam.image_size()
    pix = torch.arange(w * h, device=device).repeat(spp)
    rays = generate_rays(cam.derive(torch.float32, device), (pix % w).to(torch.int32),
                         (pix // w).to(torch.int32), torch.Generator(device=device).manual_seed(3))
    return scene, rays


def _region_compare(scene, rays, oracle_stats, inject_bug=None):
    """(region stats of the megakernel, z-scores per region) against the
    oracle's stats."""
    rad = mk.trace_paths(*rays, scene, 21, DEPTH, inject_bug=inject_bug)
    sp = _region_stats(scene, rays, rad)
    z = {}
    for r, (n, mp, dp) in sp.items():
        _, mx, dx = oracle_stats[r]
        z[r] = np.abs(mp - mx) / (np.sqrt((dp**2 + dx**2) / n) + 1e-6)
    return sp, z


def _oracle_stats(scene, rays):
    rad = ray_color(scene, *rays, torch.Generator(device=rays[0].device).manual_seed(9), DEPTH,
                    early_exit=True)
    return _region_stats(scene, rays, rad)


@pytest.fixture(scope="module")
def cpu_material():
    """Scene, rays and the oracle's region stats on the CPU (one thread:
    several test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    scene, rays = _material_rays(torch.device("cpu"))
    yield scene, rays, _oracle_stats(scene, rays)
    torch.set_num_threads(n)


def _check_clean(scene, rays, oracle):
    sp, z = _region_compare(scene, rays, oracle)
    print({r: round(float(zr.max()), 2) for r, zr in z.items()})
    for r, zr in z.items():
        assert sp[r][0] > 1000, f"region {r} too small to test"
        assert zr.max() < 5.0, f"region {r}: z={zr}"


def _check_caught(scene, rays, oracle):
    _, z = _region_compare(scene, rays, oracle, inject_bug="schlick3")
    print({r: round(float(zr.max()), 2) for r, zr in z.items()})
    assert z[2].max() > 5.0, f"injected schlick3 bug not detected: z={z[2]}"


def test_material_region_statistics(cpu_material):
    """Each material's region of the megakernel's plain version within 5
    standard errors of the oracle's: its Schlick sampling, fuzz and
    lambertian cosine, one at a time."""
    _check_clean(*cpu_material)


def test_material_region_statistics_detects_injected_bug(cpu_material):
    """The same statistic fails under the planted fault: a test that cannot
    catch a planted bug proves nothing."""
    _check_caught(*cpu_material)


@pytest.mark.cuda
def test_material_region_statistics_on_the_card():
    """Both, with the megakernel on the card (at SPP_CARD): the clean brute
    scan and `<CHUNKED, SCHLICK3>` (every brute scan is the chunked kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    scene, rays = _material_rays(dev, SPP_CARD)
    oracle = _oracle_stats(scene, rays)
    before = mk.LAUNCHES["brute_chunked_schlick3"]
    _check_clean(scene, rays, oracle)
    _check_caught(scene, rays, oracle)
    assert mk.LAUNCHES["brute_chunked_schlick3"] == before + 1
