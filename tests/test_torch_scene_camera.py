"""The port's deterministic host parts against the JAX package: scenes,
camera frame and rays, colour quantisation, PPM bytes, the ray feed order
and the random-number specification."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu import camera as jcamera, color as jcolor, scene as jscene
from raytracingproject_tpu.render import _block_order as j_block_order
from raytracingproject_tpu.utils import ppm as jppm

from raytracingproject_tpu_torch import camera as pcamera, color as pcolor, scene as pscene
from raytracingproject_tpu_torch.ops import rng
from raytracingproject_tpu_torch.render import _block_order as p_block_order
from raytracingproject_tpu_torch.utils import ppm as pppm

FIELDS = ("center0", "center_delta", "radius", "mat_type", "albedo", "fuzz", "ior")
COVER = dict(aspect_ratio=16.0 / 9.0, image_width=96, samples_per_pixel=4, max_depth=8,
             vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
             defocus_angle=0.6, focus_dist=10.0)


def _assert_scene_equal(js, ps):
    for f in FIELDS:
        a = np.asarray(getattr(js, f))
        b = getattr(ps, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("name,args", [
    ("make_cover_scene", {"seed": 0}),
    ("make_cover_scene", {"seed": 11}),
    ("make_cover_scene_reference", {}),
    ("make_cover_scene_reference", {"arg_order": "lr"}),
    ("make_three_sphere_scene", {}),
    ("make_minimal_scene", {}),
    ("make_ground_scene", {}),
    ("make_random_scene", {"n": 150, "seed": 3}),
])
def test_scene_makers_equal(name, args):
    _assert_scene_equal(getattr(jscene, name)(**args), getattr(pscene, name)(**args))


def test_pad_to_equal():
    _assert_scene_equal(jscene.make_three_sphere_scene().pad_to(9),
                        pscene.make_three_sphere_scene().pad_to(9))


def test_cover_scene_size():
    assert pscene.make_cover_scene(0).num_spheres == jscene.make_cover_scene(0).num_spheres


@pytest.mark.parametrize("kw", [COVER, dict(COVER, defocus_angle=0.0, vfov=90.0,
                                            lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0))])
def test_camera_derive_bit_equal(kw):
    jd = jcamera.Camera(**kw).derive()
    pd = pcamera.Camera(**kw).derive()
    assert pcamera.Camera(**kw).image_size() == jcamera.Camera(**kw).image_size()
    for name in jd._fields:
        np.testing.assert_array_equal(getattr(pd, name).numpy(), np.asarray(getattr(jd, name)),
                                      err_msg=name)


def test_generate_rays_given_jax_uniforms():
    """The port's ray core, fed the uniforms JAX's generate_rays draws
    (replayed from camera.py:118-144 and sampling.py:26-33), gives JAX's
    rays to 1e-6."""
    cam = jcamera.Camera(**COVER)
    w, h = cam.image_size()
    n = 2048
    rs = np.random.default_rng(1)
    i = rs.integers(0, w, n).astype(np.int32)
    j = rs.integers(0, h, n).astype(np.int32)
    key = jax.random.PRNGKey(3)
    o, d, t = jcamera.generate_rays(cam.derive(), jnp.asarray(i), jnp.asarray(j), key)

    k_px, k_disk, k_time = jax.random.split(key, 3)
    off = jax.random.uniform(k_px, (n, 2), minval=-0.5, maxval=0.5)
    k1, k2 = jax.random.split(k_disk)
    disk_u = jax.random.uniform(k1, (n,))
    disk_theta = jax.random.uniform(k2, (n,), minval=0.0, maxval=2.0 * jnp.pi)
    time = jax.random.uniform(k_time, (n,))
    np.testing.assert_array_equal(np.asarray(time), np.asarray(t))  # the replay is JAX's

    T = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    po, pd, pt = pcamera.rays_from_uniforms(pcamera.Camera(**COVER).derive(), T(i), T(j),
                                            T(off), T(disk_u), T(disk_theta), T(time))
    np.testing.assert_allclose(po.numpy(), np.asarray(o), atol=1e-6)
    np.testing.assert_allclose(pd.numpy(), np.asarray(d), atol=1e-6)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(t))


def test_generate_rays_draws_from_the_generator():
    cam = pcamera.Camera(**COVER).derive()
    i = torch.arange(64, dtype=torch.int32)
    a = pcamera.generate_rays(cam, i, i, torch.Generator().manual_seed(5))
    b = pcamera.generate_rays(cam, i, i, torch.Generator().manual_seed(5))
    c = pcamera.generate_rays(cam, i, i, torch.Generator().manual_seed(6))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert float(a[2].min()) >= 0.0 and float(a[2].max()) < 1.0


def test_to_u8_and_ppm_bytes_equal():
    img = np.random.default_rng(0).uniform(-0.2, 1.3, (9, 13, 3)).astype(np.float32)
    ju8 = np.asarray(jcolor.to_u8(jnp.asarray(img)))
    pu8 = pcolor.to_u8(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(pu8, ju8)
    # XLA's CPU sqrt is not always correctly rounded: 1 ulp of slack
    np.testing.assert_allclose(pcolor.linear_to_gamma(torch.from_numpy(img)).numpy(),
                               np.asarray(jcolor.linear_to_gamma(jnp.asarray(img))),
                               rtol=2.4e-7, atol=0)
    assert pppm.encode_ppm(pu8) == jppm.encode_ppm(ju8)


def test_ppm_python_path_and_read_back(tmp_path, monkeypatch):
    img = np.random.default_rng(1).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    native = pppm.encode_ppm(img)
    monkeypatch.setattr(pppm, "_encode_native", lambda *a: None)
    assert pppm.encode_ppm(img) == native
    pppm.write_ppm(torch.from_numpy(img), tmp_path / "x.ppm")
    np.testing.assert_array_equal(pppm.read_ppm(tmp_path / "x.ppm"), img)


@pytest.mark.parametrize("w,h,spp,tile", [
    (32, 18, 1, 1024), (32, 18, 2, 256), (400, 225, 4, 256), (33, 17, 3, 128), (64, 36, 1, 1024),
])
def test_block_order_equal(w, h, spp, tile):
    js, jg = j_block_order(w, h, spp, tile)
    ps, pg = p_block_order(w, h, spp, tile)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pg, jg)
    assert ps.size % tile == 0


# ---- the random-number specification (ops/rng.py) ----

def _philox_scalar(ctr, key):
    """Philox-4x32-10 on Python ints (Salmon et al., SC'11)."""
    c = list(ctr)
    k0, k1 = key
    m = 0xFFFFFFFF
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + 0x9E3779B9) & m, (k1 + 0xBB67AE85) & m
        p0 = 0xD2511F53 * c[0]
        p1 = 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & m, p1 & m, ((p0 >> 32) ^ c[3] ^ k1) & m, p0 & m]
    return c


def test_philox_known_answers():
    """Random123's known-answer vectors for philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        assert tuple(_philox_scalar(ctr, key)) == want
        got = rng.philox4x32_10(*(torch.tensor([v], dtype=torch.int64) for v in ctr), *key)
        assert tuple(int(x) for x in got) == want


@pytest.mark.parametrize("seed,bounce", [(0, 0), (7, 3), (2**31 - 2, 49)])
def test_twin_generator_bit_equal_to_scalar_reference(seed, bounce):
    rays = np.random.default_rng(seed % 1000).integers(0, 2**32, 64, dtype=np.uint64)
    rays = np.concatenate([rays, [0, 1, 2**32 - 1]]).astype(np.int64)
    got = torch.stack(rng.bounce_bits(seed, torch.from_numpy(rays), bounce), dim=1)
    want = [_philox_scalar((int(r), bounce, 0, 0), (seed, 0)) for r in rays]
    assert got.tolist() == want


def test_uniform_and_ball_radius_formulas():
    bits = torch.tensor([0, 255, 256, 2**31, 2**32 - 1], dtype=torch.int64)
    u = rng.bits_to_uniform(bits)
    want = [(int(b) >> 8) / 2**24 for b in bits]
    assert u.dtype == torch.float32 and u.tolist() == want
    assert float(u.max()) < 1.0
    uu = torch.linspace(0.0, 0.999, 1001)
    torch.testing.assert_close(rng.ball_radius(uu)[1:], uu[1:] ** (1.0 / 3.0),
                               rtol=2e-6, atol=1e-7)
    assert float(rng.ball_radius(torch.zeros(1))) == pytest.approx(1e-10, rel=1e-5)
    x, y, z = rng.unit_vector(uu, uu.flip(0))
    torch.testing.assert_close(x * x + y * y + z * z, torch.ones_like(uu), rtol=0, atol=2e-6)
    torch.testing.assert_close(z, 2.0 * uu - 1.0, rtol=0, atol=0)
    zero = rng.bounce_uniforms(5, torch.arange(4), 0, zero_draws=True)
    assert all(float(v.abs().sum()) == 0.0 for v in zero)
    real = rng.bounce_uniforms(5, torch.arange(4096), 0)
    assert all(abs(float(v.mean()) - 0.5) < 0.02 for v in real)
    s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    torch.testing.assert_close(x, s * torch.cos((2.0 * math.pi) * uu.flip(0)), rtol=0, atol=0)
