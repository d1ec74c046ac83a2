"""The port's megakernel (plain PyTorch versions of K1, K2, K3) against the
JAX package's Pallas megakernel in interpret mode, ray for ray.

The TPU interpreter's PRNG returns zeros, so `pallas_trace_paths(...,
interpret=True)` is deterministic at any depth; the port's `zero_draws`
mode gives the same all-zero uniforms. Both packages get the same rays,
made by JAX and passed as numpy arrays, and the same scene arrays
(`bridge`). The CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.bvh import build_bvh as jbuild_bvh, reorder_scene as jreorder
from raytracingproject_tpu.camera import Camera as JCamera, generate_rays as jgenerate_rays
from raytracingproject_tpu.ops.pallas.megakernel import (
    front_tables as jfront_tables, pallas_trace_paths,
)
from raytracingproject_tpu import scene as jscene

from raytracingproject_tpu_torch import bridge
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk

THREE_CAM = dict(aspect_ratio=16.0 / 9.0, image_width=64, samples_per_pixel=1, max_depth=8,
                 vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
                 defocus_angle=0.0, focus_dist=1.0)
COVER_CAM = dict(aspect_ratio=16.0 / 9.0, image_width=64, samples_per_pixel=1, max_depth=8,
                 vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                 defocus_angle=0.6, focus_dist=10.0)


def _rays(cam_kw, n, seed):
    """n camera rays at random pixels, made by the JAX package (numpy)."""
    cam = JCamera(**cam_kw)
    w, h = cam.image_size()
    key = jax.random.PRNGKey(seed)
    idx = jax.random.randint(key, (n,), 0, w * h)
    o, d, t = jgenerate_rays(cam.derive(), (idx % w).astype(jnp.int32),
                             (idx // w).astype(jnp.int32), jax.random.fold_in(key, 1))
    return np.asarray(o), np.asarray(d), np.asarray(t)


def _port_scene(js):
    return bridge.scene_from_arrays(*(np.asarray(x) for x in js))


def _port_front(jf):
    return bridge.front_from_arrays(jf.sph, jf.ff, jf.fi, jf.wf, jf.sf, jf.remap, jf.repack)


def _scene_and_front(name):
    """(JAX scene in leaf order, JAX front) for the named test scene."""
    if name == "three":
        s = jscene.make_three_sphere_scene()
        bvh = jbuild_bvh(s, leaf_size=2)
        rs = jreorder(s, bvh)
        return rs, jfront_tables(rs, bvh)
    if name == "cover":
        s = jscene.make_cover_scene(seed=0)
        bvh = jbuild_bvh(s, leaf_size=8)
        rs = jreorder(s, bvh)
        return rs, jfront_tables(rs, bvh, order_point=(13.0, 2.0, 3.0), repack=2)
    if name == "random2w":  # two words: the word-level cull runs
        s = jscene.make_random_scene(150, seed=3)
        bvh = jbuild_bvh(s, leaf_size=2)
        rs = jreorder(s, bvh)
        f = jfront_tables(rs, bvh, max_nodes=48, order_point=(13.0, 2.0, 3.0))
        assert f.wf.shape == (8, 2)
        return rs, f
    raise ValueError(name)


def _both(name, path, rays, depth, seed=7):
    """(JAX interpret radiance, port twin radiance) as numpy."""
    js, jf = _scene_and_front(name)
    o, d, t = rays
    jfront = jf if path == "front" else None
    ref = np.asarray(pallas_trace_paths(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), js,
                                        jnp.int32(seed), max_depth=depth, interpret=True,
                                        front=jfront))
    ps = _port_scene(js)
    pf = _port_front(jf) if path == "front" else None
    got = mk.trace_paths(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t), ps,
                         seed, depth, front=pf, zero_draws=True).numpy()
    return ref, got


@pytest.mark.parametrize("name,path", [
    ("three", "brute"), ("three", "front"), ("cover", "brute"), ("cover", "front"),
])
def test_depth1_matches_jax(name, path):
    """Depth 1 is draw-free: every ray within 5e-5 (as the JAX package's
    own depth-1 megakernel check)."""
    rays = _rays(THREE_CAM if name == "three" else COVER_CAM, 1024, seed=4)
    ref, got = _both(name, path, rays, depth=1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_sky_only_matches_jax():
    """Rays that miss everything: the sky gradient within 2e-5."""
    js = jscene.make_minimal_scene()
    js = js._replace(center0=js.center0 + 1e6)
    rng = np.random.default_rng(0)
    n = 2048
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    t = rng.random(n).astype(np.float32)
    ref = np.asarray(pallas_trace_paths(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), js,
                                        jnp.int32(1), max_depth=4, interpret=True))
    got = mk.trace_paths(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t),
                         _port_scene(js), 1, 4, zero_draws=True).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("name,path,min_frac", [
    ("three", "brute", 0.999), ("three", "front", 0.999), ("random2w", "front", 0.99),
])
def test_zero_draw_depth8_matches_jax(name, path, min_frac):
    """Zero draws at depth 8: rays within 1e-4 of JAX, all finite. The
    slack is for last-ulp differences (XLA contracts products into FMAs)
    that the bounce loop amplifies. On the three-sphere scene at least
    99.9% of rays agree. On the random scene, seen from the cover camera
    13 units away, the reference quadratic loses ~12 bits to cancellation
    against its 0.1-0.3 radius spheres: both packages' first-hit t are
    ~1e-5 off float64 and grazing reflections amplify that, so 99.0-99.8%
    agree (0.9961 at this seed); the bound is 99%."""
    rays = _rays(THREE_CAM if name == "three" else COVER_CAM, 1024, seed=6)
    ref, got = _both(name, path, rays, depth=8)
    assert np.isfinite(got).all()
    close = np.all(np.abs(got - ref) <= 1e-4, axis=1)
    frac = close.mean()
    print(f"{name}/{path}: {frac:.5f} of rays within 1e-4")
    assert frac >= min_frac, frac


def test_front_twin_equals_brute_twin_two_words():
    """The two-level front (word cull, then subtree cull) drops no winner:
    with zero draws at depth 8 it gives exactly the brute scan's radiance."""
    js, jf = _scene_and_front("random2w")
    o, d, t = (torch.from_numpy(x) for x in _rays(COVER_CAM, 1024, seed=6))
    ps, pf = _port_scene(js), _port_front(jf)
    brute = mk.trace_paths(o, d, t, ps, 7, 8, zero_draws=True)
    front = mk.trace_paths(o, d, t, ps, 7, 8, front=pf, zero_draws=True)
    torch.testing.assert_close(front, brute, rtol=0, atol=0)


def test_front_twin_matches_brute_twin_real_rng():
    """With the real RNG, the front-culled closest hit equals the brute
    scan up to last-ulp ties: at most 0.1% of cover-scene rays differ."""
    js, jf = _scene_and_front("cover")
    o, d, t = (torch.from_numpy(x) for x in _rays(COVER_CAM, 2048, seed=9))
    ps, pf = _port_scene(js), _port_front(jf)
    brute = mk.trace_paths(o, d, t, ps, 12345, 8)
    front = mk.trace_paths(o, d, t, ps, 12345, 8, front=pf)
    differ = (torch.abs(brute - front) > 1e-4).any(dim=1).double().mean().item()
    assert torch.isfinite(front).all()
    assert differ <= 1e-3, differ


def test_trace_paths_is_independent_of_chunking(monkeypatch):
    """The RNG is keyed by the global ray slot: tracing in small chunks
    gives the same radiance as one chunk."""
    js, jf = _scene_and_front("three")
    o, d, t = (torch.from_numpy(x) for x in _rays(THREE_CAM, 1024, seed=2))
    ps = _port_scene(js)
    whole = mk.trace_paths(o, d, t, ps, 99, 6)
    monkeypatch.setattr(mk, "_twin_chunk", lambda n_cols: mk.TILE)
    chunked = mk.trace_paths(o, d, t, ps, 99, 6)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
