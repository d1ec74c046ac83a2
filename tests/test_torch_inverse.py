"""The oracle's reverse mode (grad/inverse.py render_loss and
make_train_step, autograd through render.ray_color) and its recorder
(grad/replay.py xla_trace_record) against the JAX package on shared draws,
against finite differences as tests/test_grad.py holds the JAX package,
and against the path replay; the NaN sweep of the guarded operations."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from raytracingproject_tpu import scene as jscene
from raytracingproject_tpu.camera import Camera as JCamera
from raytracingproject_tpu.grad import inverse as jinv
from raytracingproject_tpu.grad.replay import xla_trace_record as jxla_trace_record
from raytracingproject_tpu.render import render as jrender

from raytracingproject_tpu_torch import scene as pscene
from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.grad import (
    DEAD, SceneParams, apply_params, extract_params, make_train_step, render_loss,
    replay_radiance, trainable_mask, xla_trace_record,
)
from raytracingproject_tpu_torch.materials import (
    ScatterDraws, draw_scatter, schlick_reflectance,
)
from raytracingproject_tpu_torch.ops.vecmath import refract
from raytracingproject_tpu_torch.render import ray_color, render_pass
from test_torch_grad import _adam_reference, _port_params, _rel_errors
from test_torch_megakernel import COVER_CAM, THREE_CAM, _port_scene, _rays
from test_torch_oracle import jax_path_draws

F64 = torch.float64
TINY = dict(aspect_ratio=1.0, image_width=24, samples_per_pixel=8, max_depth=4, vfov=50.0,
            lookfrom=(0.0, 0.0, 2.0), lookat=(0.0, 0.0, 0.0), defocus_angle=0.0)


def tiny_camera(**overrides):
    return Camera(**{**TINY, **overrides})


def single_sphere(albedo=(0.6, 0.3, 0.2), dtype=torch.float32):
    return pscene.SceneBuilder().add_lambertian((0.0, 0.0, 0.0), 0.7, albedo).build(dtype=dtype)


def as_dtype(scene, dtype):
    return dataclasses.replace(scene, **{f: getattr(scene, f).to(dtype)
                                         for f in SceneParams._fields})


def mean_image(scene, cam, seed, spp=8, dtype=F64):
    """tests/test_grad.py's mean_image: one oracle pass over `spp` samples,
    every draw from a generator seeded with `seed` (a matched key)."""
    w, h = cam.image_size()
    return render_pass(scene, cam.derive(dtype), torch.Generator().manual_seed(seed), width=w,
                       height=h, max_depth=cam.max_depth, spp_chunk=spp,
                       use_megakernel=False) / spp


def jax_camera_uniforms(k_ray, n):
    """The draws of the JAX generate_rays under its own key splits
    (camera.py:118-144), as the port's `ray_uniforms`."""
    k_px, k_disk, k_time = jax.random.split(k_ray, 3)
    k1, k2 = jax.random.split(k_disk)
    T = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return (T(jax.random.uniform(k_px, (n, 2), minval=-0.5, maxval=0.5)),
            T(jax.random.uniform(k1, (n,))),
            T(jax.random.uniform(k2, (n,), minval=0.0, maxval=2.0 * jnp.pi)),
            T(jax.random.uniform(k_time, (n,))))


# ---------------------------------------------------------------------------
# against the JAX package on shared draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cam_kw,spp,loss_tol,grad_tol", [
    ("three", dict(THREE_CAM, image_width=32, max_depth=4), 4, 1e-3, 2e-3),
    ("cover", dict(COVER_CAM, image_width=32, max_depth=3), 2, 1e-3, 5e-2),
])
def test_render_loss_gradient_matches_jax(name, cam_kw, spp, loss_tol, grad_tol):
    """render_loss and its gradient in all six fields against
    jax.value_and_grad of the JAX render_loss, float32, the camera's and
    every bounce's draws replayed from the JAX key. Relative loss error
    and relative-norm gradient error per field: three-sphere <= 1e-3 and
    <= 2e-3 (measured 1.2e-4 and <= 5.3e-4: one path of 2,304 differs);
    cover <= 1e-3 and <= 5e-2 (measured 6.2e-5 and <= 1.8e-2: XLA's FMA
    rounding moves a few grazing paths of the far scene, ROADMAP Queue 3,
    and each one is a whole ray's gradient)."""
    js = jscene.make_three_sphere_scene() if name == "three" else jscene.make_cover_scene(0)
    jcam, cam = JCamera(**cam_kw), Camera(**cam_kw)
    w, h = cam.image_size()
    n, depth = w * h * spp, cam.max_depth
    key = jax.random.PRNGKey(9)
    target = np.random.default_rng(2).random((h, w, 3)).astype(np.float32)
    kw = dict(width=w, height=h, max_depth=depth, spp_chunk=spp)
    jloss, jg = jax.value_and_grad(jinv.render_loss)(
        jinv.extract_params(js), js, jcam.derive(), key, jnp.asarray(target), **kw)

    k_ray, k_path = jax.random.split(key)
    params = _port_params(jinv.extract_params(js))
    loss = render_loss(params, _port_scene(js), cam.derive(), None, torch.from_numpy(target),
                       ray_uniforms=jax_camera_uniforms(k_ray, n),
                       path_draws=jax_path_draws(k_path, n, depth), **kw)
    grads = torch.autograd.grad(loss, list(params))
    assert all(torch.isfinite(g).all() for g in grads)
    rel_loss = abs(float(loss) - float(jloss)) / float(jloss)
    errs = _rel_errors(js.fuzz, jg, grads)
    print(name, "loss", rel_loss, "grads", errs)
    assert rel_loss <= loss_tol
    for f, e in errs.items():
        # a field whose gradient is zero in both (static spheres' delta)
        if np.abs(np.asarray(getattr(jg, f))).max() == 0.0:
            assert float(getattr(SceneParams(*grads), f).abs().max()) == 0.0, f
        else:
            assert e <= grad_tol, (f, e)


@pytest.mark.parametrize("name,cam_kw,need,tol0,q99,rad_tol", [
    ("three", THREE_CAM, 0.99, 1e-5, 1e-4, 1e-4), ("cover", COVER_CAM, 0.97, 1e-2, 5e-3, 2e-3)])
def test_xla_trace_record_matches_jax(name, cam_kw, need, tol0, q99, rad_tol):
    """xla_trace_record on the JAX draws against the JAX recorder, 512
    rays, depth 6. Whole paths (every bounce's idx) are equal on >= 99%
    of rays (three-sphere; measured 99.8%) or >= 97% (cover; measured
    99.2%: XLA's FMA rounding moves grazing hits). On those rays refl is
    equal; ndir agrees at the first bounce within 1e-5 (three-sphere;
    measured 3e-6) or 1e-2 (cover; measured 5.6e-3: a 2e-4 difference in
    the hit point over a 0.2 radius, then refraction), and at every bounce
    its 0.99 quantile within 1e-4 (measured 1.8e-5) or 5e-3 (measured
    2.2e-3), since each bounce off a small sphere magnifies the
    difference; the radiance within 1e-4 (measured 2.9e-6) or 2e-3
    (measured 7.9e-4). And the radiance is ray_color's, bit for bit."""
    js = jscene.make_three_sphere_scene() if name == "three" else jscene.make_cover_scene(0)
    o, d, t = _rays(cam_kw, 512, seed=6)
    key, depth = jax.random.PRNGKey(17), 6
    jrad, jres = jxla_trace_record(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), key, depth)
    ps = _port_scene(js)
    rays = [torch.from_numpy(np.array(x)) for x in (o, d, t)]
    draws = jax_path_draws(key, 512, depth)
    rad, res = xla_trace_record(ps, *rays, None, depth, draws=draws)
    assert res.idx.shape == (depth, 512) and res.idx.dtype == torch.int32
    assert res.ndir.shape == (depth, 512, 3) and res.refl.dtype == torch.bool
    same = (res.idx.numpy() == np.asarray(jres.idx)).all(axis=0)
    print(name, "paths equal:", same.mean())
    assert same.mean() >= need
    np.testing.assert_array_equal(res.refl.numpy()[:, same], np.asarray(jres.refl)[:, same])
    err = np.abs(res.ndir.numpy()[:, same] - np.asarray(jres.ndir)[:, same]).max(axis=-1)
    print(name, "ndir: first bounce", err[0].max(), "0.99 quantiles", np.quantile(err, 0.99, axis=1))
    assert err[0].max() <= tol0 and (np.quantile(err, 0.99, axis=1) <= q99).all()
    np.testing.assert_allclose(rad.numpy()[same], np.asarray(jrad)[same], atol=rad_tol)
    assert (res.idx == DEAD).any() and (res.idx >= 0).any()
    assert torch.equal(rad, ray_color(ps, *rays, None, depth, draws=draws))


# ---------------------------------------------------------------------------
# autograd through the oracle against the path replay
# ---------------------------------------------------------------------------

def _oracle_and_replay(name, cam_kw, dtype):
    """(radiance of ray_color, of xla_trace_record, of the replay; per
    field the relative-norm difference of the two gradients of a weighted
    radiance sum) on 400 rays at depth 6, fuzz where fuzz > 0 (the replay
    recovers the fuzz offset as (ndir - mirror) / fuzz)."""
    js = jscene.make_three_sphere_scene() if name == "three" else jscene.make_cover_scene(0)
    scene = as_dtype(_port_scene(js), dtype)
    o, d, t = (torch.from_numpy(np.array(x)).to(dtype) for x in _rays(cam_kw, 400, seed=8))
    depth = 6
    gen = torch.Generator().manual_seed(12)
    draws = [draw_scatter(gen, (400,), dtype) for _ in range(depth)]
    wts = torch.from_numpy(np.random.default_rng(3).normal(size=(400, 3))).to(dtype)

    params = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
    rad_oracle = ray_color(apply_params(scene, params), o, d, t, None, depth, draws=draws)
    g_oracle = torch.autograd.grad((rad_oracle * wts).sum(), list(params), allow_unused=True)
    rad_rec, res = xla_trace_record(scene, o, d, t, None, depth, draws=draws)
    rad_replay = replay_radiance(params, scene, o, d, t, res)
    g_replay = torch.autograd.grad((rad_replay * wts).sum(), list(params), allow_unused=True)
    assert float(rad_oracle.detach().abs().sum()) > 0
    rel = {}
    for f, a, b in zip(SceneParams._fields, g_oracle, g_replay):
        a = torch.zeros_like(getattr(params, f)) if a is None else a
        b = torch.zeros_like(getattr(params, f)) if b is None else b
        if f == "fuzz":
            a, b = a[scene.fuzz > 0], b[scene.fuzz > 0]
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), f
        rel[f] = float(torch.linalg.norm((a - b).double()) / (torch.linalg.norm(a.double()) + 1e-30))
        print(name, dtype, f, rel[f])
    return rad_oracle.detach().numpy(), rad_rec.numpy(), rad_replay.detach().numpy(), rel


@pytest.mark.parametrize("name,cam_kw", [("three", THREE_CAM), ("cover", COVER_CAM)])
def test_oracle_autograd_equals_replay_of_its_record(name, cam_kw):
    """In float64, for the same draws: ray_color's radiance, the radiance
    xla_trace_record returns and replay_radiance on its residuals are
    equal to 1e-10, and so are the gradients of a weighted radiance sum in
    all six fields (relative-norm <= 1e-9; measured ~1e-15; fuzz where
    fuzz > 0, as tests/test_replay.py compares it). Two
    independent differentiations of one function: autograd through the
    whole bounce loop, and the replay of recorded decisions."""
    rad_oracle, rad_rec, rad_replay, rel = _oracle_and_replay(name, cam_kw, F64)
    np.testing.assert_allclose(rad_rec, rad_oracle, atol=1e-10)
    np.testing.assert_allclose(rad_replay, rad_oracle, atol=1e-10)
    assert max(rel.values()) <= 1e-9, rel


@pytest.mark.parametrize("name,cam_kw", [("three", THREE_CAM), ("cover", COVER_CAM)])
def test_oracle_autograd_near_replay_in_float32(name, cam_kw):
    """The same in float32, where training runs. The replay re-solves the
    winner's quadratic in the recorder's operation order (`dot3`, times
    1/a), so it lands on the recorded hit points: the radiance within
    1e-6 (measured: bit-equal on the CPU) and every field's gradient
    within 1e-5 relative-norm of the oracle's (measured <= 4e-7). (With the dot products as reductions a card's reduction
    order alone moved the geometry gradients by 1e-2 to 0.7 on the cover
    scene.)"""
    rad_oracle, rad_rec, rad_replay, rel = _oracle_and_replay(name, cam_kw, torch.float32)
    np.testing.assert_array_equal(rad_rec, rad_oracle)
    print(name, "max |replay - oracle|", np.abs(rad_replay - rad_oracle).max())
    np.testing.assert_allclose(rad_replay, rad_oracle, atol=1e-6)
    assert max(rel.values()) <= 1e-5, rel


# ---------------------------------------------------------------------------
# tests/test_grad.py's analytic and finite-difference cases, on the port
# ---------------------------------------------------------------------------

def test_albedo_gradient_analytic():
    """One lambertian sphere, depth 2: the red sum is linear in the red
    albedo, so its gradient equals f(1) - f(0) (matched draws), 1e-9 in
    float64."""
    cam = tiny_camera(max_depth=2)

    def red_sum(albedo_red):
        scene = single_sphere(dtype=F64)
        albedo = torch.stack([albedo_red, *torch.tensor([0.2, 0.2], dtype=F64)])[None]
        return mean_image(dataclasses.replace(scene, albedo=albedo), cam, 0)[..., 0].sum()

    a = torch.tensor(0.6, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(red_sum(a), a)
    slope = red_sum(torch.tensor(1.0, dtype=F64)) - red_sum(torch.tensor(0.0, dtype=F64))
    assert float(slope) > 0
    np.testing.assert_allclose(float(g), float(slope), rtol=1e-9)


def _fd_check(scene, cam, seed, weights, field, idx, eps, tol):
    params = extract_params(scene)

    def loss(p):
        return torch.sum(mean_image(apply_params(scene, p), cam, seed, spp=16) * weights)

    leaves = SceneParams(*(x.clone().requires_grad_(True) for x in params))
    g_val = float(getattr(SceneParams(*torch.autograd.grad(loss(leaves), list(leaves),
                                                           allow_unused=True)), field)[idx])

    def perturbed(delta):
        arr = getattr(params, field).clone()
        arr[idx] += delta
        return float(loss(params._replace(**{field: arr})))

    fd = (perturbed(eps) - perturbed(-eps)) / (2 * eps)
    print(field, idx, "autograd", g_val, "finite difference", fd)
    assert abs(g_val - fd) / max(abs(fd), abs(g_val), 1e-3) < tol, (field, idx, g_val, fd)


@pytest.mark.parametrize("field,idx,interior_only", [
    ("albedo", (1, 0), False), ("radius", (1,), True), ("center0", (1, 2), True)])
def test_grad_matches_finite_difference(field, idx, interior_only):
    """tests/test_grad.py's three cases: central differences with matched
    draws. Geometry takes the interior window at depth 2 (the estimator
    omits silhouette terms); the albedo the whole image at depth 5. In
    float64 with eps 1e-6, so that no secondary-bounce path flips inside
    the difference (at the JAX test's float32 eps of 1e-3 one does for
    half of the seeds): 1e-4 relative (measured ~1e-7), against the JAX
    test's 5%."""
    scene = as_dtype(pscene.make_three_sphere_scene(), F64)
    cam = tiny_camera(image_width=32, max_depth=2 if interior_only else 5,
                      lookfrom=(0, 0.3, 2.5), lookat=(0, 0, -1))
    w, h = cam.image_size()
    mask = np.ones((h, w, 3))
    if interior_only:
        mask = np.zeros((h, w, 3))
        mask[h // 2 - 3: h // 2 + 3, w // 2 - 3: w // 2 + 3, :] = 1.0
    weights = torch.from_numpy(mask * np.cos(np.arange(mask.size).reshape(mask.shape)))
    _fd_check(scene, cam, 1, weights, field, idx, 1e-6, 1e-4)


def test_fuzz_grad_matches_finite_difference():
    """A single metal sphere, depth 2, interior window: the radiance is
    smooth in fuzz where the hemisphere test does not flip (float64, eps
    1e-6: 1e-4 relative, measured 2e-7)."""
    scene = pscene.SceneBuilder().add_metal((0.0, 0.0, 0.0), 0.7, (0.8, 0.7, 0.6),
                                            fuzz=0.3).build(dtype=F64)
    cam = tiny_camera(image_width=32, max_depth=2)
    w, h = cam.image_size()
    mask = np.zeros((h, w, 3))
    mask[h // 2 - 4: h // 2 + 4, w // 2 - 4: w // 2 + 4, :] = 1.0
    _fd_check(scene, cam, 4, torch.from_numpy(mask), "fuzz", (0,), 1e-6, 1e-4)


def test_ior_grad_unit_level():
    """refract and Schlick are the smooth channels through which ior moves
    the radiance: their autograd derivatives against central differences
    (1e-6 relative in float64)."""
    uv = torch.tensor([[np.sin(0.4), -np.cos(0.4), 0.0]], dtype=F64)
    n = torch.tensor([[0.0, 1.0, 0.0]], dtype=F64)
    out_x = lambda r: refract(uv, n, r)[0, 0]  # noqa: E731
    schlick = lambda ior: schlick_reflectance(torch.tensor(np.cos(0.4), dtype=F64), 1.0 / ior)  # noqa: E731
    for fn, at in ((out_x, 1 / 1.5), (out_x, 1 / 1.2), (out_x, 1.1), (schlick, 1.5)):
        x = torch.tensor(at, dtype=F64, requires_grad=True)
        (g,) = torch.autograd.grad(fn(x), x)
        eps = 1e-5
        fd = (fn(torch.tensor(at + eps, dtype=F64)) - fn(torch.tensor(at - eps, dtype=F64))) / (2 * eps)
        assert abs(float(g)) > 1e-3
        np.testing.assert_allclose(float(g), float(fd), rtol=1e-6)


# ---------------------------------------------------------------------------
# NaN sweep: a zero cotangent times the unselected branch of a `where`
# ---------------------------------------------------------------------------

def _cover_case():
    cam = Camera(**dict(COVER_CAM, image_width=40, samples_per_pixel=4))
    return pscene.make_cover_scene(0), cam, None


def _padded_case():
    return pscene.make_three_sphere_scene().pad_to(8), tiny_camera(lookfrom=(0, 0.3, 2.5),
                                                                   lookat=(0, 0, -1)), None


def _axis_rays(n):
    o = torch.tensor([[0.0, 0.0, 2.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1)
    return o, d, torch.zeros(n)


def _head_on_glass_case():
    """Rays along the axis of a glass ball: cos_theta == 1 exactly, the
    sqrt of sin_theta and refract's sqrt sit at their guards."""
    scene = pscene.SceneBuilder().add_dielectric((0.0, 0.0, 0.0), 0.7, 1.5).build()
    return scene, None, (*_axis_rays(16), None)


def _zero_scatter_case():
    """A lambertian scatter whose unit draw is exactly -normal: the next
    direction is the zero vector (no near_zero fix, as in the reference),
    which must read as a miss with finite gradients."""
    n, depth = 16, 3
    unit = torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1)
    draws = [ScatterDraws(unit, torch.zeros(n, 3), torch.zeros(n)) for _ in range(depth)]
    return single_sphere(), None, (*_axis_rays(n), draws)


def _zero_radius_and_fuzz_case():
    scene = pscene.make_three_sphere_scene()
    radius = scene.radius.clone()
    radius[1] = 0.0
    scene = dataclasses.replace(scene, radius=radius, fuzz=torch.zeros_like(scene.fuzz))
    return scene, tiny_camera(lookfrom=(0, 0.3, 2.5), lookat=(0, 0, -1)), None


@pytest.mark.parametrize("case", [_cover_case, _padded_case, _head_on_glass_case,
                                  _zero_scatter_case, _zero_radius_and_fuzz_case],
                         ids=["cover", "padded", "head_on_glass", "zero_scatter", "zero_radius_fuzz"])
def test_oracle_gradients_are_finite(case):
    """The loss and the gradient in every field are finite (float32), and
    the gradient is not identically zero."""
    scene, cam, rays = case()
    params = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
    if rays is None:
        w, h = cam.image_size()
        loss = render_loss(params, scene, cam.derive(), torch.Generator().manual_seed(2),
                           torch.zeros((h, w, 3)), width=w, height=h, max_depth=8, spp_chunk=4)
    else:
        o, d, t, draws = rays
        depth = 4 if draws is None else len(draws)
        rad = ray_color(apply_params(scene, params), o, d, t, torch.Generator().manual_seed(2),
                        depth, draws=draws)
        assert torch.isfinite(rad).all() and float(rad.sum()) > 0
        loss = torch.mean(rad ** 2)
    grads = torch.autograd.grad(loss, list(params), allow_unused=True)
    assert torch.isfinite(loss)
    total = 0.0
    for f, g in zip(SceneParams._fields, grads):
        if g is not None:
            assert torch.isfinite(g).all(), f"non-finite gradient in {f}"
            total += float(g.abs().sum())
    assert total > 0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def test_inverse_rendering_recovers_albedo():
    """tests/test_grad.py's recovery through the oracle: a single sphere,
    24x24, 16 spp, depth 3, 60 steps of Adam(5e-2) from albedo 0.4 toward
    a 32-spp render of albedo (0.8, 0.2, 0.5). The frozen fields stay
    bit-unchanged."""
    cam = tiny_camera(max_depth=3)
    target = mean_image(single_sphere((0.8, 0.2, 0.5)), cam, 3, spp=32, dtype=torch.float32)
    start = single_sphere((0.4, 0.4, 0.4))
    params, opt, step = make_train_step(start, cam, spp=16, learning_rate=5e-2,
                                        trainable=("albedo",), device="cpu",
                                        generator=torch.Generator().manual_seed(4))
    losses = []
    for _ in range(60):
        params, opt, loss, grads = step(params, opt, None, target)
        losses.append(float(loss))
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; albedo {params.albedo[0].tolist()}")
    assert losses[-1] < 0.1 * losses[0]
    np.testing.assert_allclose(params.albedo[0].detach().numpy(), [0.8, 0.2, 0.5], atol=0.08)
    for f in SceneParams._fields:
        if f != "albedo":
            assert torch.equal(getattr(params, f).detach(), getattr(start, f)), f
    assert float(grads.radius.abs().sum()) > 0  # computed for every field, applied to albedo only


def test_train_step_adam_matches_optax():
    """Five oracle train steps on the three-sphere scene, trainable albedo
    + center0 + radius: the parameters follow Adam in float64 on the
    step's own gradients (1e-6 relative) and optax.adam under
    multi_transform / set_to_zero, as the JAX make_train_step builds it,
    fed the same gradients (1e-5: optax rounds its bias corrections to
    float32, tests/test_torch_grad.py); frozen fields stay bit-unchanged;
    the loss and the gradients are finite and the draws change from step
    to step."""
    js = jscene.make_three_sphere_scene()
    ps = _port_scene(js)
    trainable, lr = ("albedo", "center0", "radius"), 2e-2
    cam = tiny_camera(image_width=16, max_depth=3, lookfrom=(0.0, 0.5, 1.5), lookat=(0.0, 0.0, -1.0))
    params, opt, step = make_train_step(ps, cam, spp=2, learning_rate=lr, trainable=trainable,
                                        device="cpu")
    assert isinstance(opt, torch.optim.Adam)
    mask = trainable_mask(trainable)
    labels = jinv.SceneParams(**{f: ("train" if getattr(mask, f) else "freeze")
                                 for f in SceneParams._fields})
    tx = optax.multi_transform({"train": optax.adam(lr), "freeze": optax.set_to_zero()}, labels)
    jparams = jinv.extract_params(js)
    state = tx.init(jparams)
    start = SceneParams(*(x.detach().clone() for x in params))
    target = torch.full((16, 16, 3), 0.5)
    seq, losses = [], []
    for _ in range(5):
        params, opt, loss, grads = step(params, opt, None, target)
        assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
        losses.append(float(loss))
        seq.append([g.numpy().copy() for g in grads])
        updates, state = tx.update(jinv.SceneParams(*map(jnp.asarray, seq[-1])), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    assert len(set(losses)) == 5
    for k, f in enumerate(SceneParams._fields):
        got = getattr(params, f).detach().numpy()
        if not getattr(mask, f):
            assert torch.equal(getattr(params, f).detach(), getattr(start, f)), f
            continue
        exact = _adam_reference(getattr(start, f).numpy(), [gs[k] for gs in seq], lr, False)
        scale = np.abs(exact).max()
        np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-6 * scale, err_msg=f)
        np.testing.assert_allclose(got, np.asarray(getattr(jparams, f)), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=f)
    with pytest.raises(ValueError, match="unknown trainable"):
        make_train_step(ps, cam, trainable=("albedo", "colour"), device="cpu")
    with pytest.raises(ValueError, match="not the tensors the optimizer holds"):
        step(SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(ps))), opt,
             None, target)


@pytest.mark.parametrize("which", ["oracle", "fast"])
def test_train_steps_resolve_the_device_as_render_does(which):
    """With no `device` a train step runs where `render` runs: the card,
    whatever device the scene was built on, and without one it raises as
    `render` does, naming device="cpu"; the CPU runs only when asked for,
    and asking for the card without one raises too."""
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.grad import make_fast_train_step

    make = make_train_step if which == "oracle" else make_fast_train_step
    cam = tiny_camera(max_depth=2)
    scene = single_sphere((0.4, 0.4, 0.4))
    assert scene.device.type == "cpu"
    if torch.cuda.is_available():
        params, _, _ = make(scene, cam, spp=1, trainable=("albedo",))
        assert params.albedo.device.type == RenderSettings().resolved_device().type == "cuda"
    else:
        for fn in (lambda: make(scene, cam, spp=1, trainable=("albedo",)),
                   lambda: RenderSettings().resolved_device()):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                fn()
    params, _, _ = make(scene, cam, spp=1, trainable=("albedo",), device="cpu")
    assert params.albedo.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(scene, cam, spp=1, trainable=("albedo",), device="cuda")


@pytest.mark.parametrize("trainable,rises", [(("center0", "radius"), True), (("albedo",), False)],
                         ids=["geometry", "albedo"])
def test_train_step_from_the_true_geometry_moves_the_loss_as_in_jax(trainable, rises):
    """Twelve Adam(2e-3) steps on the three-sphere scene (64x36, 4 spp,
    depth 4) from albedo 0.5 and the *true* geometry, every step on the
    same draws, in both packages. Trained on the albedo the loss falls at
    every step. Trained on the geometry it ends above where it began, in
    the JAX package as in the port: Adam moves each coordinate by the full
    learning rate off the truth, and the gradient holds no silhouette
    term, so the pixels whose paths change (which the loss feels at first
    order) are invisible to it. The port's rise is within a factor of 3 of
    the JAX package's (their draws differ)."""
    cam_kw = dict(THREE_CAM, image_width=64, samples_per_pixel=4, max_depth=4)
    js = jscene.make_three_sphere_scene()
    jcam = JCamera(**cam_kw)
    jtarget = jrender(js, dataclasses.replace(jcam, samples_per_pixel=16), jax.random.PRNGKey(5))
    target = torch.from_numpy(np.array(jtarget))
    jstart = js._replace(albedo=jnp.full_like(js.albedo, 0.5))
    state, jstep = jinv.make_train_step(jstart, jcam, spp=4, learning_rate=2e-3,
                                        trainable=trainable)
    jparams, jlosses = jinv.extract_params(jstart), []
    for _ in range(12):
        jparams, state, loss, _ = jstep(jparams, state, jax.random.PRNGKey(99), jtarget)
        jlosses.append(float(loss))
    params, opt, step = make_train_step(_port_scene(jstart), Camera(**cam_kw), spp=4,
                                        learning_rate=2e-3, trainable=trainable, device="cpu")
    losses = []
    for _ in range(12):
        params, opt, loss, _ = step(params, opt, torch.Generator().manual_seed(99), target)
        losses.append(float(loss))
    print("port", losses, "\njax ", jlosses)
    for seq in (losses, jlosses):
        if rises:
            assert seq[-1] > seq[0]
        else:
            assert all(b < a for a, b in zip(seq, seq[1:]))
    change, jchange = losses[-1] - losses[0], jlosses[-1] - jlosses[0]
    assert jchange / 3 < change < jchange * 3 if rises else jchange * 3 < change < jchange / 3
