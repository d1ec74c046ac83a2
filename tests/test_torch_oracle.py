"""The oracle renderer of the port (render.ray_color and the
use_megakernel=False branches of render_pass and render) as a whole:
ray for ray against the JAX package's ray_color on shared draws,
statistically against the float64 numpy oracle (tests/oracle.py) as
tests/test_render.py holds the JAX package, and the three closest hits
(brute, BVH walk, fused K4) and the early exit against the plain loop."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu import bvh as jbvh, scene as jscene
from raytracingproject_tpu.render import ray_color as jray_color, sky_color as jsky_color

from raytracingproject_tpu_torch import bvh as pbvh, camera as pcamera, scene as pscene
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.ops.intersect import closest_hit
from raytracingproject_tpu_torch.render import ray_color, render, render_pass, sky_color
from oracle import render_np, scene_to_numpy, trace_np
from test_torch_materials import jax_scatter_draws
from test_torch_megakernel import COVER_CAM, THREE_CAM, _port_scene, _rays

SCENES = {  # JAX scene, camera of its rays
    "three": (jscene.make_three_sphere_scene, THREE_CAM),
    "minimal": (jscene.make_minimal_scene, THREE_CAM),
    "cover": (lambda: jscene.make_cover_scene(0), COVER_CAM),
}


def jax_path_draws(key, n, depth, dtype=torch.float32):
    """The draws JAX's ray_color consumes: bounce k scatters with
    fold_in(key, k) (render.py:170, 177)."""
    return [jax_scatter_draws(jax.random.fold_in(key, k), n, dtype) for k in range(depth)]


def small_camera(**overrides):
    kw = dict(aspect_ratio=16.0 / 9.0, image_width=64, samples_per_pixel=32, max_depth=8,
              vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
              defocus_angle=0.0, focus_dist=1.0)
    kw.update(overrides)
    return pcamera.Camera(**kw)


ORACLE = dict(device="cpu", use_megakernel=False)


@pytest.mark.parametrize("depth", [1, 2, 8])
@pytest.mark.parametrize("name", list(SCENES))
def test_ray_color_matches_jax_on_shared_draws(name, depth):
    """ray_color fed the JAX draws bounce by bounce against JAX's
    ray_color, 512 camera rays: at depth 1 and 2 every ray within 1e-4
    (three-sphere, minimal) or >= 99% (cover: XLA's FMA rounding moves
    grazing hits, ROADMAP Queue 3); at depth 8 >= 99% (three-sphere,
    minimal; measured 100%) and >= 95% (cover; measured ~98%). The mean
    radiance agrees within 2e-3 everywhere."""
    make, cam = SCENES[name]
    js = make()
    o, d, t = _rays(cam, 512, seed=3)
    key = jax.random.PRNGKey(21)
    ref = np.asarray(jray_color(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), key, depth))
    got = ray_color(_port_scene(js), *(torch.from_numpy(np.array(x)) for x in (o, d, t)), None, depth,
                    draws=jax_path_draws(key, 512, depth)).numpy()
    assert got.shape == (512, 3) and np.isfinite(got).all()
    close = (np.abs(got - ref).max(axis=1) <= 1e-4).mean()
    print(f"{name} depth {depth}: {close:.4f} of rays within 1e-4")
    need = {("cover", 8): 0.95, ("cover", 1): 0.99, ("cover", 2): 0.99}.get(
        (name, depth), 1.0 if depth <= 2 else 0.99)
    assert close >= need
    assert abs(got.mean() - ref.mean()) <= 2e-3


def test_sky_only_and_depth_exhausted():
    """tests/test_render.py's deterministic cases: a ray that misses
    returns the sky gradient exactly; a ray that hits with max_depth 1
    returns black; max_depth 0 traces nothing."""
    scene = pscene.make_minimal_scene()
    gen = torch.Generator().manual_seed(0)
    o = torch.tensor([[0.0, 5.0, 0.0]])
    for d, want in (([0.0, 1.0, 0.0], [0.5, 0.7, 1.0]), ([1.0, 0.0, 0.0], [0.75, 0.85, 1.0])):
        rad = ray_color(scene, o, torch.tensor([d]), torch.zeros(1), gen, 4)
        np.testing.assert_allclose(rad[0].numpy(), want, atol=1e-6)
    hit = ray_color(scene, torch.zeros((1, 3)), torch.tensor([[0.0, 0.0, -1.0]]), torch.zeros(1),
                    gen, 1)
    np.testing.assert_allclose(hit[0].numpy(), [0.0, 0.0, 0.0], atol=1e-7)
    none = ray_color(scene, o, torch.tensor([[0.0, 1.0, 0.0]]), torch.zeros(1), gen, 0)
    assert none.shape == (1, 3) and float(none.abs().sum()) == 0.0


@pytest.mark.parametrize("name,spp,depth,mean_tol,q99_tol", [
    ("minimal", 64, 8, 0.015, 0.12), ("three", 96, 16, 0.02, 0.15)])
def test_oracle_render_matches_numpy_oracle(name, spp, depth, mean_tol, q99_tol):
    """render() on the oracle path against the float64 numpy oracle at
    matched spp, with tests/test_render.py's bounds (mean |diff| and its
    0.99 quantile, a few sigma of the pixel-mean estimator)."""
    scene = getattr(pscene, f"make_{name}_scene" if name != "three"
                    else "make_three_sphere_scene")()
    cam = small_camera(samples_per_pixel=spp, max_depth=depth)
    img = render(scene, cam, torch.Generator().manual_seed(7),
                 RenderSettings(**ORACLE, use_bvh=False)).numpy()
    ref = render_np(scene, cam, spp=spp)
    diff = np.abs(img - ref)
    print(name, diff.mean(), np.quantile(diff, 0.99))
    assert diff.mean() < mean_tol and np.quantile(diff, 0.99) < q99_tol


def test_golden_pixel_ground_scene():
    """tests/test_render.py's golden-pixel expectation on the port: the
    centre pixel of the ground-sphere world (`make_ground_scene`, the
    reference unit test's) under the cover camera, 4,096 samples at depth
    50 through `ray_color`, against the float64 oracle's expectation on
    the same rays (atol 0.02), and within 0.12 of the reference's
    single-sample golden (0.253, 0.3518, 0.5)."""
    scene = pscene.make_ground_scene()
    cam = pcamera.Camera(aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=30,
                         max_depth=50, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
                         lookat=(0.0, 0.0, 0.0), defocus_angle=0.6, focus_dist=10.0)
    n = 4096
    gen = torch.Generator().manual_seed(42)
    i = torch.full((n,), 200, dtype=torch.int32)
    j = torch.full((n,), 112, dtype=torch.int32)
    origin, direction, time = pcamera.generate_rays(cam.derive(), i, j, gen)
    mean = ray_color(scene, origin, direction, time, gen, max_depth=50).numpy().mean(axis=0)
    ref = trace_np(scene_to_numpy(scene), origin.double().numpy(), direction.double().numpy(),
                   time.double().numpy(), np.random.default_rng(99), 50).mean(axis=0)
    np.testing.assert_allclose(mean, ref, atol=0.02)
    assert np.all(np.abs(mean - np.array([0.253, 0.3518, 0.5])) < 0.12), mean


def test_render_pass_oracle_branch_layout_and_determinism():
    """render_pass(use_megakernel=False): rays are the image tiled
    spp_chunk times in row-major order (the sum over samples of a sky-only
    scene is spp_chunk * sky of each pixel's direction, up to the jitter);
    equal seeds give equal images; raw_slots is refused."""
    cam = small_camera(image_width=32, samples_per_pixel=3)
    w, h = cam.image_size()
    scene = pscene.make_minimal_scene()
    far = dataclasses.replace(scene, center0=scene.center0 + 1e7)
    kw = dict(width=w, height=h, max_depth=4, spp_chunk=3, use_megakernel=False)
    img = render_pass(far, cam.derive(), torch.Generator().manual_seed(1), **kw)
    assert img.shape == (h, w, 3)
    jj, ii = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    zero = torch.zeros(h * w)
    _, dd, _ = pcamera.rays_from_uniforms(cam.derive(), ii.reshape(-1), jj.reshape(-1),
                                          torch.zeros(h * w, 2), zero, zero, zero)
    np.testing.assert_allclose(img.numpy(), 3 * sky_color(dd).reshape(h, w, 3).numpy(), atol=0.06)
    a = render_pass(scene, cam.derive(), torch.Generator().manual_seed(5), **kw)
    b = render_pass(scene, cam.derive(), torch.Generator().manual_seed(5), **kw)
    c = render_pass(scene, cam.derive(), torch.Generator().manual_seed(6), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="raw_slots"):
        render_pass(scene, cam.derive(), torch.Generator().manual_seed(5), raw_slots=True, **kw)


@pytest.mark.parametrize("use_bvh", [False, True], ids=["brute", "bvh"])
def test_early_exit_equals_the_full_loop(use_bvh):
    """tests/test_render_early_exit.py: bounce k consumes the k-th set of
    draws whether or not the loop stops early, so the images are equal
    bit for bit."""
    scene = pscene.make_three_sphere_scene()
    bvh = None
    if use_bvh:
        bvh = pbvh.build_bvh(scene)
        scene = pbvh.reorder_scene(scene, bvh)
    cam = small_camera(image_width=48, samples_per_pixel=4, max_depth=12)
    kw = dict(width=48, height=27, max_depth=12, spp_chunk=4, use_megakernel=False, bvh=bvh)
    a = render_pass(scene, cam.derive(), torch.Generator().manual_seed(11), early_exit=False, **kw)
    b = render_pass(scene, cam.derive(), torch.Generator().manual_seed(11), early_exit=True, **kw)
    assert torch.equal(a, b) and float(a.sum()) > 0


@pytest.mark.parametrize("option", ["use_bvh", "use_pallas"])
@pytest.mark.parametrize("name", ["three", "cover"])
def test_bvh_and_pallas_equal_the_brute_loop(name, option):
    """render() with the BVH walk, and with the fused closest hit (its
    plain version here), against the brute loop from equal generator
    seeds: they consume equal draws, so >= 99.9% of pixels agree within
    1e-4 (ties in the closest hit aside)."""
    cam = pcamera.Camera(**dict(SCENES[name][1], image_width=40, samples_per_pixel=2,
                                max_depth=6))
    scene = _port_scene(SCENES[name][0]())
    ref = render(scene, cam, torch.Generator().manual_seed(3),
                 RenderSettings(**ORACLE, use_bvh=False))
    got = render(scene, cam, torch.Generator().manual_seed(3),
                 RenderSettings(**ORACLE, use_bvh=option == "use_bvh",
                                use_pallas=option == "use_pallas"))
    frac = (torch.abs(got - ref) <= 1e-4).all(dim=-1).double().mean().item()
    print(name, option, frac)
    assert frac >= 0.999 and torch.isfinite(got).all()


@pytest.mark.parametrize("leaf_size", [2, 4, 8])
def test_bvh_closest_hit_equals_brute(leaf_size):
    """The port's walk takes its leaf window from the tree it is given:
    equal to the brute scan (hit mask, idx but for ties, t to 1e-6) at
    leaf sizes 2, 4 and 8, on the native and the Python build."""
    js = jscene.make_cover_scene(0)
    o, d, t = (torch.from_numpy(x) for x in _rays(COVER_CAM, 400, seed=5))
    scene = _port_scene(js)
    for build in (pbvh.build_bvh, pbvh._build_bvh_python):
        bvh = build(scene, leaf_size)
        rs = pbvh.reorder_scene(scene, bvh)
        got = pbvh.bvh_closest_hit(o, d, t, rs, bvh)
        ref = closest_hit(o, d, t, rs.center0, rs.center_delta, rs.radius)
        assert torch.equal(got.hit, ref.hit) and got.hit.any()
        tie = torch.abs(got.t - ref.t) <= 1e-6 * torch.abs(ref.t)
        assert bool(((got.idx == ref.idx) | tie)[ref.hit].all())
        np.testing.assert_allclose(got.t[ref.hit].numpy(), ref.t[ref.hit].numpy(), rtol=1e-6)
        same = (got.idx == ref.idx) & ref.hit
        np.testing.assert_allclose(got.normal[same].numpy(), ref.normal[same].numpy(), atol=1e-5)


def test_jax_bvh_walk_window_is_its_leaf_size():
    """The JAX bvh_closest_hit gathers a fixed window of LEAF_SIZE = 4
    spheres per leaf. With the tree `render` builds by default
    (bvh_leaf_size 4) it equals its own brute scan; with a larger leaf it
    can only see each leaf's first four spheres. The port's walk covers
    both (test_bvh_closest_hit_equals_brute); this documents the
    reference's limit (ROADMAP Queue 3) and leaves it as it is."""
    from raytracingproject_tpu.ops.intersect import closest_hit as jclosest_hit

    js = jscene.make_cover_scene(0)
    o, d, t = (jnp.asarray(x) for x in _rays(COVER_CAM, 400, seed=5))
    missed = {}
    for leaf in (4, 8):
        tree = jbvh.build_bvh(js, leaf_size=leaf)
        rs = jbvh.reorder_scene(js, tree)
        got = jbvh.bvh_closest_hit(o, d, t, rs, tree)
        ref = jclosest_hit(o, d, t, rs.center0, rs.center_delta, rs.radius)
        hit = np.asarray(ref.hit)
        missed[leaf] = int((np.abs(np.asarray(got.t)[hit] - np.asarray(ref.t)[hit])
                            > 1e-3 * np.asarray(ref.t)[hit]).sum())
        assert int(np.asarray(tree.leaf_count).max()) <= leaf
    print("JAX bvh walk: rays whose t differs from the brute scan", missed)
    assert missed[4] == 0
    assert missed[8] > 0


def test_sky_texture_matches_jax():
    """The equirect lookup against the JAX package's on
    tests/test_sky_texture.py's cardinal directions and on random ones
    (1e-5), and its gradient is finite at the poles."""
    ht, wt = 8, 16
    tex = np.zeros((ht, wt, 3), np.float32)
    tex[0, :] = (1.0, 0.0, 0.0)
    tex[-1, :] = (0.0, 1.0, 0.0)
    tex[ht // 2, wt // 2] = (0.0, 0.0, 1.0)
    rng = np.random.default_rng(0)
    tex2 = rng.random((5, 9, 3)).astype(np.float32)
    dirs = np.concatenate([[[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, -3]],
                           rng.normal(size=(300, 3))]).astype(np.float32)
    for tx in (tex, tex2):
        got = sky_color(torch.from_numpy(dirs), torch.from_numpy(tx)).numpy()
        ref = np.asarray(jsky_color(jnp.asarray(dirs), jnp.asarray(tx)))
        np.testing.assert_allclose(got, ref, atol=1e-5)
    up = sky_color(torch.tensor([[0.0, 1.0, 0.0]]), torch.from_numpy(tex))
    np.testing.assert_allclose(up[0].numpy(), [1, 0, 0], atol=1e-6)
    d = torch.from_numpy(dirs[:8]).clone().requires_grad_(True)
    (g,) = torch.autograd.grad(sky_color(d, torch.from_numpy(tex2)).sum(), d)
    assert torch.isfinite(g).all()
