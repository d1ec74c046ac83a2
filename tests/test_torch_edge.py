"""The silhouette estimator (grad/edge.py) against the JAX package's and
against its own finite differences: the streaming top-k candidates, the
value and gradients of `soft_primary_radiance` at depth 1 (where the
estimator draws nothing that reaches its result), top-k against dense,
central differences over the full frame in float64, and the two-sphere
geometry recovery of tests/test_edge_grad.py at its own frame size.

Rays are made by the JAX package and handed over as numpy arrays; the
scenes come from the same builders in both packages. No kernel runs here
(the estimator is plain PyTorch, as the JAX one is jnp).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu import scene as jscene
from raytracingproject_tpu.camera import Camera as JCamera, generate_rays as jgenerate_rays
from raytracingproject_tpu.grad import inverse as jinv
from raytracingproject_tpu.grad.edge import (
    _topk_candidates as jtopk, soft_primary_radiance as jsoft,
)

from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.grad import (
    SceneParams, extract_params, make_soft_train_step, soft_primary_radiance,
)
from raytracingproject_tpu_torch.grad.edge import _topk_candidates
from raytracingproject_tpu_torch.ops.vecmath import dot
from raytracingproject_tpu_torch.render import ray_color, render, sky_color
from raytracingproject_tpu_torch.scene import SceneBuilder
from test_torch_megakernel import _port_scene

W, H, SPP, DEPTH, SOFT = 64, 36, 2, 3, 0.02  # tests/test_edge_grad.py's frame
EDGE_CAM = dict(aspect_ratio=16.0 / 9.0, image_width=W, samples_per_pixel=SPP, max_depth=DEPTH,
                vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0))
COVER_CAM = dict(aspect_ratio=16.0 / 9.0, image_width=48, samples_per_pixel=1, max_depth=3,
                 vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread for this module: its shapes are too small to
    split, and it keeps the workers of a parallel test run from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_spheres(builder, albedo=(0.1, 0.2, 0.7), center=(0.0, 0.0, -1.0), radius=0.5,
                 **build):
    """tests/test_edge_grad.py's scene: a ground sphere and a small one."""
    return (builder.add_lambertian((0.0, -100.5, -1.0), 100.0, (0.6, 0.6, 0.2))
            .add_lambertian(center, radius, albedo).build(**build))


def _jax_scene(name):
    if name == "two":
        return _two_spheres(jscene.SceneBuilder())
    return jscene.make_cover_scene(0)


def _full_frame_rays(cam_kw, spp):
    """Every pixel of the frame `spp` times ([spp, H, W] order), made by the
    JAX package (test_edge_grad.py's `_full_frame_rays`)."""
    cam = JCamera(**cam_kw)
    w, h = cam.image_size()
    jj, ii = jnp.meshgrid(jnp.arange(h, dtype=jnp.int32), jnp.arange(w, dtype=jnp.int32),
                          indexing="ij")
    o, d, t = jgenerate_rays(cam.derive(), jnp.tile(ii.reshape(-1), spp),
                             jnp.tile(jj.reshape(-1), spp), jax.random.PRNGKey(1))
    return np.asarray(o), np.asarray(d), np.asarray(t)


def _torch(*xs, dtype=torch.float32):
    return tuple(torch.from_numpy(np.array(x)).to(dtype) for x in xs)


def _params(scene, dtype=None):
    p = extract_params(scene)
    return SceneParams(*(x.detach().clone().to(dtype or x.dtype).requires_grad_(True) for x in p))


@pytest.mark.parametrize("name,k,chunk", [("two", 4, 512), ("cover", 8, 64), ("cover", 8, 512)])
def test_topk_candidates_match_jax(name, k, chunk):
    """`_topk_candidates` against the JAX package's on the same rays: per
    ray the same candidate set (compared sorted, since torch.topk orders
    slots as it likes), or where a set differs, the same silhouette
    distances (ties at the k-th place); empty slots are -1 in both."""
    js = _jax_scene(name)
    cam = EDGE_CAM if name == "two" else COVER_CAM
    o, d, t = _full_frame_rays(cam, 1)
    ref = np.sort(np.asarray(jtopk(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), k,
                                   chunk=chunk)), axis=1)
    ps = _port_scene(js)
    rays = _torch(o, d, t)
    got = np.sort(_topk_candidates(ps, *rays, k, chunk=chunk).numpy(), axis=1)
    assert got.shape == ref.shape
    np.testing.assert_array_equal((got < 0).sum(axis=1), (ref < 0).sum(axis=1))
    same = (got == ref).all(axis=1)
    print(f"{name}, k {k}, chunk {chunk}: {same.mean():.4f} of rays with the same set")
    assert same.mean() >= 0.99
    if name == "two":
        assert (got < 0).any()  # fewer contributing spheres than slots
    # where the sets differ, their silhouette distances tie
    center = ps.center0[None] + rays[2][:, None, None] * ps.center_delta[None]
    oc = rays[0][:, None, :] - center
    a = dot(rays[1], rays[1])[:, None]
    hb = (oc * rays[1][:, None, :]).sum(-1)
    sd = (hb * hb - a * ((oc * oc).sum(-1) - ps.radius ** 2)) / (a * 2 * ps.radius.abs())
    for r in np.flatnonzero(~same):
        gv = np.sort(sd[r, got[r][got[r] >= 0]].numpy())
        rv = np.sort(sd[r, ref[r][ref[r] >= 0]].numpy())
        np.testing.assert_allclose(gv, rv, rtol=1e-5)


def _jax_value_and_grads(js, rays, w, depth, k=None):
    def loss(p):
        rad = jsoft(p, js, *(jnp.asarray(x) for x in rays), jax.random.PRNGKey(3), depth, SOFT,
                    candidates_k=k)
        return jnp.sum(rad * w) / rays[0].shape[0]
    return jax.value_and_grad(loss)(jinv.extract_params(js))


@pytest.mark.parametrize("name,k", [("two", None), ("two", 2), ("cover", None), ("cover", 8)])
def test_soft_radiance_depth1_matches_jax(name, k):
    """Value and gradients at max_depth 1 against jax.grad of the JAX
    estimator (dense, and top-k), the same rays and weights: there the
    continuation has no bounce and the estimator is deterministic. Value
    within rtol 1e-5; each field's gradient within a relative-norm 1e-4
    (albedo, fuzz and ior get none at depth 1: zero in both)."""
    js = _jax_scene(name)
    rays = _full_frame_rays(EDGE_CAM if name == "two" else COVER_CAM, SPP if name == "two" else 1)
    w = np.random.default_rng(4).random((rays[0].shape[0], 3)).astype(np.float32)
    val, g_ref = _jax_value_and_grads(js, rays, w, 1, k)
    ps = _port_scene(js)
    pp = _params(ps)
    rad = soft_primary_radiance(pp, ps, *_torch(*rays), torch.Generator().manual_seed(0), 1,
                                SOFT, candidates_k=k)
    value = (rad * torch.from_numpy(w)).sum() / rays[0].shape[0]
    grads = torch.autograd.grad(value, list(pp), allow_unused=True)
    np.testing.assert_allclose(value.item(), float(val), rtol=1e-5)
    for f, a, b in zip(SceneParams._fields, g_ref, grads):
        a = np.asarray(a, np.float64)
        b = np.zeros_like(a) if b is None else b.numpy().astype(np.float64)
        err = np.linalg.norm(b - a) / (np.linalg.norm(a) + 1e-12)
        print(f"{name} k={k} {f}: |g| {np.linalg.norm(a):.4e}, relative error {err:.2e}")
        if f in ("albedo", "fuzz", "ior"):
            assert not b.any() and not a.any(), f
        else:
            assert err <= 1e-4, f


def test_rays_that_see_nothing_get_the_sky_and_no_nan():
    """A ray with no sphere ahead has every silhouette distance at -inf:
    argmax picks column 0 (as jnp.argmax does), v_i is exactly 0, so the
    radiance is the sky's exactly and every gradient is finite (zero), in
    both packages alike."""
    js = _two_spheres(jscene.SceneBuilder())
    n = 64
    rng = np.random.default_rng(2)
    d = np.concatenate([rng.normal(size=(n, 3)) * 0.1 + [0.0, 1.0, 0.0]]).astype(np.float32)
    o = np.zeros((n, 3), np.float32)
    o[:, 1] = 200.0  # above the ground sphere, looking up
    t = rng.random(n).astype(np.float32)
    ps = _port_scene(js)
    for k in (None, 2):
        pp = _params(ps)
        rad = soft_primary_radiance(pp, ps, *_torch(o, d, t), torch.Generator().manual_seed(0),
                                    2, SOFT, candidates_k=k)
        assert torch.equal(rad, sky_color(torch.from_numpy(d)))
        ref = jsoft(jinv.extract_params(js), js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                    jax.random.PRNGKey(0), 2, SOFT, candidates_k=k)
        np.testing.assert_allclose(rad.detach().numpy(), np.asarray(ref), atol=1e-6)
        grads = torch.autograd.grad(rad.sum(), list(pp), allow_unused=True)
        assert all(g is None or torch.isfinite(g).all() for g in grads)
    assert (_topk_candidates(ps, *_torch(o, d, t), 2) == -1).all()


def test_continuation_at_depth_0_is_black():
    """`ray_color(..., max_depth=0)` is zeros, as the JAX package's: so at
    max_depth 1 the soft estimator is (1 - v) * sky."""
    o, d, t = _torch(*_full_frame_rays(EDGE_CAM, 1))
    scene = _two_spheres(SceneBuilder())
    out = ray_color(scene, o, d, t, torch.Generator().manual_seed(0), 0)
    assert torch.equal(out, torch.zeros_like(o))


def test_topk_estimator_equals_dense():
    """With k covering the scene the candidate estimator equals the dense
    one exactly in value, and in gradient to float rounding
    (tests/test_edge_grad.py:157-190), at the full depth with the same
    draws."""
    ps = _two_spheres(SceneBuilder())
    rays = _torch(*_full_frame_rays(EDGE_CAM, SPP))

    def run(k):
        pp = _params(ps)
        rad = soft_primary_radiance(pp, ps, *rays, torch.Generator().manual_seed(5), DEPTH, SOFT,
                                    candidates_k=k)
        return rad, torch.autograd.grad(rad.mean(), list(pp), allow_unused=True)

    dense, gd = run(None)
    topk, gt = run(2)
    assert torch.equal(dense, topk)
    for f, a, b in zip(SceneParams._fields, gd, gt):
        a = torch.zeros(1) if a is None else a
        b = torch.zeros(1) if b is None else b
        scale = max(a.abs().max().item(), 1e-3)
        assert (a - b).abs().max().item() < 5e-3 * scale, f


def _fd_case(depth, field, coord, eps):
    """(central difference, autograd) of a weighted full-frame loss of the
    port's estimator in float64, for the small sphere's `field`[coord]."""
    scene = _two_spheres(SceneBuilder(), dtype=torch.float64)
    rays = _torch(*_full_frame_rays(EDGE_CAM, SPP), dtype=torch.float64)
    w = torch.from_numpy(np.random.default_rng(4).random((rays[0].shape[0], 3)))

    def loss(p):
        rad = soft_primary_radiance(p, scene, *rays, torch.Generator().manual_seed(3), depth,
                                    SOFT)
        return (rad * w).sum() / rays[0].shape[0]

    pp = _params(scene)
    g = torch.autograd.grad(loss(pp), list(pp), allow_unused=True)
    an = (g[2][1] if field == "radius" else g[0][1, coord]).item()

    def shifted(sign):
        p = SceneParams(*(x.detach().clone() for x in pp))
        if field == "radius":
            p.radius[1] += sign * eps
        else:
            p.center0[1, coord] += sign * eps
        return loss(p).item()

    return (shifted(1) - shifted(-1)) / (2 * eps), an


@pytest.mark.parametrize("field,coord", [
    ("center0", 0), ("center0", 1), ("center0", 2), ("radius", None),
])
def test_full_frame_central_differences_depth1(field, coord):
    """d(loss)/d(centre, radius) of the small sphere by autograd against
    central differences of the port's own estimator over the whole frame,
    no window (tests/test_edge_grad.py:86-116), in float64 at eps 1e-6:
    at depth 1 the estimator is smooth and deterministic, so they agree to
    1e-6 relative; the radius gradient is the silhouette's and not 0."""
    fd, an = _fd_case(1, field, coord, 1e-6)
    print(f"{field}[{coord}]: fd {fd:.9f}, autograd {an:.9f}")
    assert abs(fd - an) < 1e-6 * max(abs(fd), abs(an), 1e-3)
    if field == "radius":
        assert abs(an) > 1e-3


@pytest.mark.parametrize("field", ["center0", "radius"])
def test_full_frame_central_differences_full_depth_signal(field):
    """At the full depth (3) finite differences also see the boundary terms
    the estimator leaves out (secondary silhouettes, object-over-object
    edges), so the test is tests/test_edge_grad.py:119-135's: the same
    sign and between 0.2 and 2 times the finite difference's size (eps
    2e-4, float64)."""
    fd, an = _fd_case(DEPTH, field, 1 if field == "center0" else None, 2e-4)
    print(f"{field}: fd {fd:.6f}, autograd {an:.6f}")
    assert fd * an > 0
    assert 0.2 * abs(fd) < abs(an) < 2.0 * abs(fd)


def test_geometry_recovery_demo():
    """tests/test_edge_grad.py:138-173 at its own frame (64x36, 4 spp,
    depth 3) and step count (300 steps of Adam(1e-2), softness annealed
    0.03 -> 0.004): from a moved, shrunk grey sphere, the soft loss
    against a hard oracle render of the truth recovers centre and radius
    within 0.02 and albedo within 0.1."""
    true = _two_spheres(SceneBuilder())
    cam = Camera(**dict(EDGE_CAM))
    oracle = RenderSettings(device="cpu", use_megakernel=False, use_bvh=False)
    target = render(true, cam, torch.Generator().manual_seed(0), oracle)
    wrong = _two_spheres(SceneBuilder(), albedo=(0.4, 0.4, 0.4), center=(0.12, -0.08, -1.05),
                         radius=0.38)
    params, opt, step = make_soft_train_step(
        wrong, cam, optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2), spp=4, softness=0.03,
        trainable=("center0", "radius", "albedo"), device="cpu",
        generator=torch.Generator().manual_seed(7))
    n_iter = 300
    for it in range(n_iter):
        params, opt, loss, _ = step(params, opt, None, target,
                                    0.03 * (0.004 / 0.03) ** (it / n_iter))
    c_err = (params.center0[1] - true.center0[1]).abs().max().item()
    r_err = abs(params.radius[1].item() - true.radius[1].item())
    a_err = (params.albedo[1] - true.albedo[1]).abs().max().item()
    print(f"after {n_iter} steps: loss {loss.item():.6f}, centre error {c_err:.4f}, radius "
          f"error {r_err:.4f}, albedo error {a_err:.4f}")
    assert c_err < 0.02 and r_err < 0.02 and a_err < 0.10
    assert math.isfinite(loss.item())
