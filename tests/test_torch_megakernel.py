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


# ---- K1's record_miss ----

@pytest.fixture
def one_torch_thread():
    """One PyTorch CPU thread for a small-shape test: faster alone, and no
    oversubscription when the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", ["brute", "front"])
@pytest.mark.usefixtures("one_torch_thread")
def test_record_miss_matches_jax(path):
    """The plain version with record_miss against
    pallas_trace_paths(record_miss=True, interpret=True) on the
    three-sphere scene, zero draws, depth 6: radiance (without the sky),
    miss direction and miss throughput within 5e-5 on >= 99.9% of rays."""
    js, jf = _scene_and_front("three")
    o, d, t = _rays(THREE_CAM, 2048, seed=3)
    jfront = jf if path == "front" else None
    ref = pallas_trace_paths(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), js, jnp.int32(5),
                             max_depth=6, interpret=True, front=jfront, record_miss=True)
    got = mk.trace_paths(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t),
                         _port_scene(js), 5, 6, front=_port_front(jf) if jfront else None,
                         zero_draws=True, record_miss=True)
    for name, r, g in zip(("rad", "mdir", "mthr"), ref, got):
        close = np.all(np.abs(g.numpy() - np.asarray(r)) <= 5e-5, axis=1).mean()
        print(f"{path} {name}: {close:.5f} of rays within 5e-5")
        assert close >= 0.999, (name, close)


def _identity_route(mode, js, jf, monkeypatch):
    """trace_paths' keyword arguments for one closest hit of the port on
    the leaf-ordered three-sphere scene."""
    from raytracingproject_tpu_torch import bvh as pbvh

    ps = _port_scene(js)
    tree = pbvh.build_bvh(ps, leaf_size=2)
    if mode == "chunked":
        monkeypatch.setattr(mk, "SMEM_BUDGET_BYTES", 0)
        monkeypatch.setattr(mk, "_twin_chunk", lambda n_cols: mk.TILE)
        return {}
    return {"brute": {}, "front": {"front": _port_front(jf)}, "bvh": {"bvh": tree},
            "hbm": {"front": mk.front_tables_hbm(ps, tree)}}[mode]


@pytest.mark.parametrize("mode", ["brute", "chunked", "front", "bvh", "hbm"])
@pytest.mark.parametrize("zero_draws", [True, False])
@pytest.mark.usefixtures("one_torch_thread")
def test_record_miss_identity(mode, zero_draws, monkeypatch):
    """On every closest hit, rad + mthr * sky(mdir) equals the run without
    miss recording within 2e-6 (the same paths, the sky added outside),
    and a ray that never missed keeps both planes exactly 0."""
    from raytracingproject_tpu_torch.render import sky_color

    js, jf = _scene_and_front("three")
    o, d, t = (torch.from_numpy(x) for x in _rays(THREE_CAM, 1024, seed=8))
    ps = _port_scene(js)
    kw = _identity_route(mode, js, jf, monkeypatch)
    plain = mk.trace_paths(o, d, t, ps, 21, 6, zero_draws=zero_draws, **kw)
    rad, mdir, mthr = mk.trace_paths(o, d, t, ps, 21, 6, zero_draws=zero_draws,
                                     record_miss=True, **kw)
    assert torch.abs(rad + mthr * sky_color(mdir) - plain).max().item() <= 2e-6
    never = (mdir == 0).all(dim=1)
    assert bool((mthr[never] == 0).all())
    assert never.any() or zero_draws  # glass or mirrors hold some rays past depth 6
    assert not never.all()


@pytest.mark.usefixtures("one_torch_thread")
def test_record_miss_env_map_matches_ray_color():
    """tests/test_sky_texture.py's mirror-metal scene and 12x24 texture: the
    megakernel's plain version with record_miss plus the texture lookup
    equals the port's ray_color(sky_tex=) and the JAX package's
    ray_color(sky_tex=) within 2e-5 (metal of fuzz 0 consumes no draws)."""
    from raytracingproject_tpu.render import ray_color as jray_color

    from raytracingproject_tpu_torch import scene as pscene
    from raytracingproject_tpu_torch.render import ray_color, sky_color

    mirrors = lambda sb: (sb.add_metal(center=(0.0, 0.0, -1.5), radius=0.5,  # noqa: E731
                                       albedo=(0.9, 0.8, 0.7), fuzz=0.0)
                          .add_metal(center=(1.1, 0.2, -2.0), radius=0.4,
                                     albedo=(0.6, 0.7, 0.9), fuzz=0.0).build())
    js = mirrors(jscene.SceneBuilder())
    ps = mirrors(pscene.SceneBuilder())
    tex = np.random.default_rng(5).random((12, 24, 3)).astype(np.float32) * 0.9 + 0.05
    # the JAX test's rays: every pixel of the 64x36 image once. (On random
    # rays a grazing mirror bounce can split the JAX package's own kernel
    # and ray_color by 1e-3.)
    cam = JCamera(**dict(THREE_CAM, max_depth=4))
    w, h = cam.image_size()
    jj, ii = jnp.meshgrid(jnp.arange(h, dtype=jnp.int32), jnp.arange(w, dtype=jnp.int32),
                          indexing="ij")
    o, d, t = (np.array(x) for x in jgenerate_rays(cam.derive(), ii.reshape(-1), jj.reshape(-1),
                                                   jax.random.PRNGKey(2)))
    rad, mdir, mthr = mk.trace_paths(*(torch.from_numpy(x) for x in (o, d, t)), ps, 3, 4,
                                     zero_draws=True, record_miss=True)
    total = (rad + mthr * sky_color(mdir, torch.from_numpy(tex))).numpy()
    mine = ray_color(ps, *(torch.from_numpy(x) for x in (o, d, t)), torch.Generator(), 4,
                     sky_tex=torch.from_numpy(tex)).numpy()
    ref = np.asarray(jray_color(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                                jax.random.PRNGKey(9), 4, sky_tex=jnp.asarray(tex)))
    assert (mdir != 0).any(dim=1).all()  # every path leaves the mirrors
    np.testing.assert_allclose(total, mine, atol=2e-5)
    np.testing.assert_allclose(total, ref, atol=2e-5)
