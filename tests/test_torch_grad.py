"""The port's gradient path (raytracingproject_tpu_torch.grad) against the
JAX package's: vector math and sky, the path replay given the JAX
package's recorded residuals, finite differences, the NaN guards, the fast
radiance (recording forward, replay backward), Adam against optax, and the
fast train step.

Inputs are made once (numpy seeds, or the JAX package's own ray and
residual generators) and handed to both packages as numpy arrays. The
CUDA recording kernel is held against the plain version used here on the
card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from raytracingproject_tpu import scene as jscene
from raytracingproject_tpu.camera import Camera as JCamera, generate_rays as jgenerate_rays
from raytracingproject_tpu.grad import inverse as jinv
from raytracingproject_tpu.grad.fast import make_fast_radiance as jmake_fast_radiance
from raytracingproject_tpu.grad.replay import replay_radiance as jreplay, xla_trace_record
from raytracingproject_tpu.ops import vecmath as jvec
from raytracingproject_tpu.ops.pallas.megakernel import pallas_trace_record
from raytracingproject_tpu.render import sky_color as jsky_color

from raytracingproject_tpu_torch import bridge
from raytracingproject_tpu_torch import scene as pscene
from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.grad import (
    DEAD, MISS, PathResiduals, SceneParams, apply_params, extract_params, make_fast_radiance,
    make_fast_train_step, make_train_step, render_loss, replay_radiance, trainable_mask,
)
from raytracingproject_tpu_torch.grad.fast import apply_updates
from raytracingproject_tpu_torch.ops import vecmath as pvec
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
from raytracingproject_tpu_torch.render import render, sky_color
from test_torch_megakernel import (
    COVER_CAM, THREE_CAM, _port_front, _port_scene, _rays, _scene_and_front,
)

DEPTH = 6  # tests/test_replay.py's recording depth
REPLAY_CAMS = {  # tests/test_replay.py's CAM3 and CAM_COVER
    "three": dict(aspect_ratio=16.0 / 9.0, image_width=120, samples_per_pixel=1,
                  max_depth=DEPTH, vfov=90.0, lookfrom=(0.0, 0.0, 0.0),
                  lookat=(0.0, 0.0, -1.0)),
    "cover": dict(aspect_ratio=16.0 / 9.0, image_width=120, samples_per_pixel=1,
                  max_depth=DEPTH, vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                  defocus_angle=0.6, focus_dist=10.0),
}


def _jax_scene(name):
    return jscene.make_three_sphere_scene() if name == "three" else jscene.make_cover_scene(0)


def _jax_rays(name, n, seed):
    """n camera rays at random pixels (test_replay.py's `_rays`)."""
    cam = JCamera(**REPLAY_CAMS[name])
    w, h = cam.image_size()
    key = jax.random.PRNGKey(seed)
    idx = jax.random.randint(key, (n,), 0, w * h)
    return jgenerate_rays(cam.derive(), (idx % w).astype(jnp.int32),
                          (idx // w).astype(jnp.int32), jax.random.fold_in(key, 1))


def _port_params(jparams, dtype=torch.float32, requires_grad=True):
    p = bridge.params_from_arrays(*(np.asarray(x) for x in jparams), dtype=dtype)
    return SceneParams(*(x.requires_grad_(requires_grad) for x in p))


def _port_residuals(res, dtype=torch.float32):
    pres = bridge.residuals_from_arrays(np.asarray(res.idx), np.asarray(res.ndir),
                                        np.asarray(res.refl))
    return pres._replace(ndir=pres.ndir.to(dtype))


def _torch(*xs, dtype=torch.float32):
    return [torch.from_numpy(np.array(x)).to(dtype) for x in xs]


def _rel_errors(scene_fuzz, g_ref, g_port, skip=()):
    """Relative-norm error per field, fuzz == 0 entries excluded
    (test_replay.py's `_assert_grads_match`)."""
    fuzz0 = np.asarray(scene_fuzz) <= 1e-6
    out = {}
    for name, a, b in zip(SceneParams._fields, g_ref, g_port):
        if name in skip:
            continue
        a = np.asarray(a, np.float64)
        b = b.detach().numpy().astype(np.float64)
        if name == "fuzz":
            a, b = a[~fuzz0], b[~fuzz0]
        out[name] = np.linalg.norm(b - a) / (np.linalg.norm(a) + 1e-6)
    return out


# ---------------------------------------------------------------------------
# vector math and sky
# ---------------------------------------------------------------------------

def test_vecmath_and_sky_match_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[0] = 0.0
    n = rng.normal(size=(64, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    uv = (v[1:] / np.linalg.norm(v[1:], axis=1, keepdims=True)).astype(np.float32)
    ratio = rng.uniform(0.5, 1.6, 63).astype(np.float32)
    pv, pn, puv, pr = _torch(v, n, uv, ratio)
    pairs = [
        (pvec.dot(pv, pn), jvec.dot(v, n)),
        (pvec.length_squared(pv), jvec.length_squared(v)),
        (pvec.normalize(pv[1:]), jvec.normalize(v[1:])),
        (pvec.normalize(pv, eps=1e-12), jvec.normalize(v, eps=1e-12)),
        (pvec.reflect(pv, pn), jvec.reflect(v, n)),
        (pvec.refract(puv, pn[1:], pr), jvec.refract(uv, n[1:], ratio)),
        (pvec.near_zero(pv), jvec.near_zero(v)),
        (sky_color(pv), jsky_color(jnp.asarray(v))),
    ]
    for k, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0,
                                   err_msg=f"pair {k}")
    tex = rng.random((4, 8, 3)).astype(np.float32)  # the equirect lookup, on the same rays
    np.testing.assert_allclose(sky_color(pv, sky_tex=torch.from_numpy(tex)).numpy(),
                               np.asarray(jsky_color(jnp.asarray(v), jnp.asarray(tex))),
                               atol=1e-5, rtol=0)


def test_vecmath_gradients_finite_at_the_guards():
    """normalize(0, eps) and refract at k == 0 (the two guards of the JAX
    package's 865700a) give finite gradients."""
    z = torch.zeros((2, 3), requires_grad=True)
    (g,) = torch.autograd.grad(pvec.normalize(z, eps=1e-12).sum(), z)
    assert torch.isfinite(g).all()
    # sin(theta) = 0.5 and ratio 2: the perpendicular part has length 1, so
    # k = |1 - |r_perp|^2| is exactly 0
    c = float(np.sqrt(np.float32(0.75)))
    uv = torch.tensor([[0.5, -c, 0.0]], requires_grad=True)
    nrm = torch.tensor([[0.0, 1.0, 0.0]], requires_grad=True)
    ratio = torch.tensor([2.0], requires_grad=True)
    out = pvec.refract(uv, nrm, ratio)
    assert float(torch.abs(1.0 - pvec.length_squared(
        ratio[:, None] * (uv + torch.clamp_max(pvec.dot(-uv, nrm), 1.0)[:, None] * nrm)))) == 0.0
    grads = torch.autograd.grad(out.sum(), (uv, nrm, ratio))
    assert all(torch.isfinite(x).all() for x in grads)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_scene_params_mirror_jax():
    assert SceneParams._fields == jinv.SceneParams._fields
    js = jscene.make_three_sphere_scene()
    ps = _port_scene(js)
    for a, b in zip(extract_params(ps), jinv.extract_params(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    scaled = extract_params(ps)._replace(radius=ps.radius * 2.0)
    assert torch.equal(apply_params(ps, scaled).radius, ps.radius * 2.0)
    assert torch.equal(apply_params(ps, scaled).mat_type, ps.mat_type)
    for t in (None, ("albedo",), ("albedo", "center0", "radius")):
        assert tuple(trainable_mask(t)) == tuple(jinv.trainable_mask(t))
    for mod in (trainable_mask, jinv.trainable_mask):
        with pytest.raises(ValueError, match="unknown trainable fields"):
            mod(("albedo", "colour"))
    # the oracle's reverse mode is ported: both run (tests/test_torch_inverse.py
    # holds them against the JAX package)
    cam = Camera(aspect_ratio=1.0, image_width=8, samples_per_pixel=1, max_depth=2,
                 vfov=60.0, lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, -1.0))
    loss = render_loss(extract_params(ps), ps, cam.derive(), torch.Generator().manual_seed(0),
                       torch.zeros((8, 8, 3)), width=8, height=8, max_depth=2, spp_chunk=1)
    assert loss.shape == () and torch.isfinite(loss)
    params0, opt, step = make_train_step(ps, cam, spp=1, trainable=("albedo",),
                                         device="cpu")
    assert isinstance(opt, torch.optim.Adam) and params0._fields == SceneParams._fields


# ---------------------------------------------------------------------------
# the replay, given the JAX package's residuals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["three", "cover"])
def test_replay_matches_jax_replay(name):
    """Radiance: >= 99.8% of 2048 rays within 2e-5 of JAX's replay on the
    same residuals (float32). Gradients of sum(rad * w): relative-norm error
    <= 1e-4 per field, in float64 (measured ~1e-12): in float32 the two
    evaluation orders drift apart through the bounce chain (measured up to
    5e-3 at depth 6, the amplification tests/test_replay.py's colT test
    describes), while in float64 both replays are the same function."""
    js = _jax_scene(name)
    o, d, t = _jax_rays(name, 2048, seed=2)
    _, res = xla_trace_record(js, o, d, t, jax.random.PRNGKey(11), DEPTH)
    jrad = np.asarray(jreplay(jinv.extract_params(js), js, o, d, t, res))
    ps = _port_scene(js)
    prad = replay_radiance(_port_params(jinv.extract_params(js), requires_grad=False), ps,
                           *_torch(o, d, t), _port_residuals(res))
    close = (np.abs(prad.numpy() - jrad).max(axis=1) <= 2e-5).mean()
    print(f"{name}: {close:.5f} of rays within 2e-5 of the JAX replay")
    assert close >= 0.998

    w = np.random.default_rng(3).random((2048, 3))
    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree.map(  # noqa: E731
            lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            tree)
        js64, res64 = f64(js), f64(res)
        o64, d64, t64 = f64((o, d, t))
        g_ref = jax.grad(lambda p: jnp.sum(jreplay(p, js64, o64, d64, t64, res64) * w))(
            jinv.extract_params(js64))
        g_ref = [np.asarray(x) for x in g_ref]
    pp = _port_params(jinv.extract_params(js), dtype=torch.float64)
    rad64 = replay_radiance(pp, ps, *_torch(o, d, t, dtype=torch.float64),
                            _port_residuals(res, torch.float64))
    g = torch.autograd.grad((rad64 * torch.from_numpy(w)).sum(), list(pp))
    rel = _rel_errors(js.fuzz, g_ref, g)
    print(f"{name}: float64 gradient relative errors {rel}")
    assert max(rel.values()) <= 1e-4


def test_grouped_replay_equals_ungrouped():
    """n_groups=8 on 1003 rays (a DEAD-padded tail slice) equals n_groups=1;
    so do skip_dead=False and extra all-DEAD bounces."""
    js = _jax_scene("cover")
    o, d, t = _jax_rays("cover", 1003, seed=17)
    _, res = xla_trace_record(js, o, d, t, jax.random.PRNGKey(19), DEPTH)
    ps, pres, rays = _port_scene(js), _port_residuals(res), _torch(o, d, t)
    w = torch.from_numpy(np.random.default_rng(23).random((1003, 3)).astype(np.float32))

    def run(res_, **kw):
        pp = _port_params(jinv.extract_params(js))
        rad = replay_radiance(pp, ps, *rays, res_, **kw)
        return rad.detach(), torch.autograd.grad((rad * w).sum(), list(pp))

    rad1, g1 = run(pres)
    extra = 10
    deep = PathResiduals(
        idx=torch.cat([pres.idx, torch.full((extra, 1003), DEAD, dtype=torch.int32)]),
        ndir=torch.cat([pres.ndir, torch.zeros((extra, 1003, 3))]),
        refl=torch.cat([pres.refl, torch.zeros((extra, 1003), dtype=torch.bool)]),
    )
    for res_, kw in ((pres, {"n_groups": 8}), (pres, {"skip_dead": False}),
                     (deep, {"n_groups": 4})):
        radk, gk = run(res_, **kw)
        np.testing.assert_allclose(radk.numpy(), rad1.numpy(), atol=1e-6, err_msg=str(kw))
        rel = _rel_errors(js.fuzz, [x.numpy() for x in g1], gk)
        assert max(rel.values()) <= 1e-5, (kw, rel)


def test_replay_gather_option():
    js = _jax_scene("three")
    with pytest.raises(ValueError, match="not ported"):
        replay_radiance(extract_params(_port_scene(js)), _port_scene(js),
                        torch.zeros((1, 3)), torch.ones((1, 3)), torch.zeros(1),
                        PathResiduals(torch.full((1, 1), MISS, dtype=torch.int32),
                                      torch.zeros((1, 1, 3)), torch.zeros((1, 1), dtype=torch.bool)),
                        gather="colT")


# ---------------------------------------------------------------------------
# finite differences and NaN guards
# ---------------------------------------------------------------------------

def test_replay_gradients_match_finite_differences():
    """The port's replay in float64 with frozen residuals, against central
    differences of the path tracer it replays: the plain bounce loop in
    float64, Philox draws, on the cover scene. Residuals are recorded by
    that loop at the base parameters; the finite differences re-trace
    with the same draws, so they differentiate the function whose draws
    the replay holds constant. The largest-gradient entries of albedo,
    center0, radius, fuzz (nonzero fuzz only) and ior agree within 1e-5
    relative (measured <= 2.7e-6)."""
    js = _jax_scene("cover")
    ps = _port_scene(js)
    rays = _torch(*(np.asarray(x) for x in _jax_rays("cover", 1024, seed=5)),
                  dtype=torch.float64)
    w = torch.from_numpy(np.random.default_rng(7).random((1024, 3)))
    base = SceneParams(*(x.detach().double() for x in extract_params(ps)))

    def trace(params, record=False):
        tab = mk.scene_table(apply_params(ps, params), torch.float64)
        return mk.bounce_loop_twin(*rays, tab, lambda *r: mk.closest_hit_brute_twin(tab, *r),
                                   4242, 4, record=record)

    rad0, planes = trace(base, record=True)
    res = mk.decode_residuals(planes, 1024, None)

    def loss(params):
        return (replay_radiance(params, ps, *rays, res) * w).sum()

    pp = SceneParams(*(x.clone().requires_grad_(True) for x in base))
    value = loss(pp)
    assert abs(value.item() - (rad0 * w).sum().item()) <= 1e-9 * abs(value.item())
    grads = SceneParams(*torch.autograd.grad(value, list(pp)))
    h = 1e-6
    checked = 0
    for field in ("albedo", "center0", "radius", "fuzz", "ior"):
        g = getattr(grads, field)
        mag = g.abs().reshape(len(g), -1).sum(dim=1)
        if field == "fuzz":
            mag = torch.where(base.fuzz > 1e-6, mag, 0.0)
        for i in torch.argsort(mag, descending=True)[:2].tolist():
            col = int(torch.argmax(g[i].abs())) if g.dim() > 1 else None
            assert float(mag[i]) > 0, f"{field}: no gradient to check"

            def shifted(s):
                x = getattr(base, field).clone()
                if col is None:
                    x[i] += s
                else:
                    x[i, col] += s
                return (trace(base._replace(**{field: x})) * w).sum().item()

            def central(s):
                return (shifted(s) - shifted(-s)) / (2 * s)

            # Richardson step: cancels the h^2 term, which near-grazing
            # hits on small spheres make large for the geometry fields
            fd = (4.0 * central(h / 2) - central(h)) / 3.0
            ad = float(g[i] if col is None else g[i, col])
            print(f"{field}[{i}{'' if col is None else f', {col}'}]: autograd {ad:.9e} "
                  f"central difference {fd:.9e}")
            assert abs(fd - ad) <= 1e-5 * abs(ad), (field, i, col, fd, ad)
            checked += 1
    assert checked == 10


def test_fast_radiance_gradients_finite():
    """NaN sweep: the fast radiance (plain recording forward, Philox draws)
    on the cover scene at depth 16, 2048 rays, four seeds: every gradient
    is finite."""
    js = _jax_scene("cover")
    ps = _port_scene(js)
    f = make_fast_radiance(ps, 16)
    w = torch.from_numpy(np.random.default_rng(1).random((2048, 3)).astype(np.float32))
    for seed in range(4):
        o, d, t = _torch(*_rays(COVER_CAM, 2048, seed=seed + 20))
        pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(ps)))
        rad = f(pp, o, d, t, 1000 + seed)
        assert torch.isfinite(rad).all()
        for name, g in zip(SceneParams._fields, torch.autograd.grad((rad * w).sum(), list(pp))):
            assert torch.isfinite(g).all(), (seed, name)


def test_degenerate_lambertian_row_has_finite_gradients():
    """A recorded lambertian scatter with u = -n (direction n + u = 0, the
    case src/vec3.h's near_zero flags) followed by a miss: the replayed
    direction is 0, and every gradient stays finite."""
    ps = pscene.SceneBuilder().add_lambertian((0.0, 0.0, 0.0), 0.7, (0.6, 0.3, 0.2)).build()
    o = torch.tensor([[0.0, 0.0, 3.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    res = PathResiduals(idx=torch.tensor([[0], [MISS]], dtype=torch.int32),
                        ndir=torch.zeros((2, 1, 3)), refl=torch.zeros((2, 1), dtype=torch.bool))
    pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(ps)))
    rad = replay_radiance(pp, ps, o, d, torch.zeros(1), res)
    assert torch.isfinite(rad).all() and float(rad.sum()) > 0
    for name, g in zip(SceneParams._fields, torch.autograd.grad(rad.sum(), list(pp))):
        assert torch.isfinite(g).all(), name


# ---------------------------------------------------------------------------
# the fast radiance against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,path,depth", [("three", "brute", 3), ("cover", "front", 2)])
def test_fast_radiance_matches_jax(name, path, depth):
    """make_fast_radiance against the JAX package's
    (make_fast_radiance(..., interpret=True)), same rays, zero draws on both
    sides. The weights keep the rays whose recorded residuals agree in
    both packages (every idx equal, every direction within 1e-4), as
    tests/test_replay.py does on the cover scene: on the others the
    reference quadratic's float32 cancellation, rounded with and without
    FMA contraction, already gives other paths (ROADMAP Queue 3). Value:
    rtol 1e-5. Gradients: relative-norm error <= 1e-4 for the materials,
    <= 5e-4 for geometry (float32 chains; measured <= 1.9e-4); fuzz is
    left out, since zero draws make the metal ball offset 0 and its
    gradient pure rounding noise in both packages."""
    js, jf = _scene_and_front(name)
    o, d, t = _rays(THREE_CAM if name == "three" else COVER_CAM, 1024, seed=4)
    jo, jd, jt = (jnp.asarray(x) for x in (o, d, t))
    jfront = jf if path == "front" else None
    ps = _port_scene(js)
    pf = _port_front(jf) if path == "front" else None
    rays = _torch(o, d, t)
    _, jres = pallas_trace_record(jo, jd, jt, js, jnp.int32(3), depth, interpret=True,
                                  front=jfront)
    _, pres = mk.trace_record(*rays, ps, 3, depth, front=pf, zero_draws=True)
    same = ((np.asarray(jres.idx) == pres.idx.numpy()).all(axis=0)
            & (np.abs(np.asarray(jres.ndir) - pres.ndir.numpy()).max(axis=2) <= 1e-4).all(axis=0))
    print(f"{name}/{path}: {same.mean():.4f} of rays with the same residuals")
    assert same.mean() >= 0.75
    w = (np.random.default_rng(1).random((1024, 3)) * same[:, None]).astype(np.float32)

    jf_rad = jmake_fast_radiance(js, depth, front=jfront, interpret=True)
    val, g_ref = jax.value_and_grad(
        lambda p: jnp.sum(jf_rad(p, jo, jd, jt, jnp.float32(3)) * w))(jinv.extract_params(js))
    pp = _port_params(jinv.extract_params(js))
    rad = make_fast_radiance(ps, depth, front=pf, zero_draws=True)(pp, *rays, 3)
    pval = (rad * torch.from_numpy(w)).sum()
    g = torch.autograd.grad(pval, list(pp))
    rel = _rel_errors(js.fuzz, g_ref, g, skip=("fuzz",))
    print(f"{name}/{path}: value {float(pval):.6f} vs {float(val):.6f}; gradient errors {rel}")
    np.testing.assert_allclose(float(pval), float(val), rtol=1e-5)
    for field, err in rel.items():
        assert err <= (5e-4 if field in ("center0", "center_delta", "radius") else 1e-4), field


# ---------------------------------------------------------------------------
# the optimizer and the train step
# ---------------------------------------------------------------------------

def _tiny_camera(**kw):
    """tests/test_grad.py's tiny_camera."""
    base = dict(aspect_ratio=1.0, image_width=24, samples_per_pixel=8, max_depth=4, vfov=50.0,
                lookfrom=(0.0, 0.0, 2.0), lookat=(0.0, 0.0, 0.0), defocus_angle=0.0)
    base.update(kw)
    return Camera(**base)


def _single_sphere(albedo):
    return pscene.SceneBuilder().add_lambertian((0.0, 0.0, 0.0), 0.7, albedo).build()


def _adam_reference(p0, grads, lr, float32_bias_correction):
    """Adam (b1 0.9, b2 0.999, eps 1e-8) in float64 numpy; optionally with
    the bias corrections 1 - b^t rounded to float32, as optax computes
    them."""
    p, m, v = p0.astype(np.float64), 0.0, 0.0
    for t, g in enumerate(grads, 1):
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g.astype(np.float64) ** 2
        c1, c2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
        if float32_bias_correction:
            c1 = float(np.float32(1.0) - np.float32(0.9) ** np.float32(t))
            c2 = float(np.float32(1.0) - np.float32(0.999) ** np.float32(t))
        p = p - lr * (m / c1) / (np.sqrt(v / c2) + 1e-8)
    return p


def test_adam_step_matches_optax():
    """The train step's optimizer (torch.optim.Adam over the trainable
    fields, applied by apply_updates) against optax.adam under
    multi_transform with set_to_zero for the frozen fields, as the JAX
    make_fast_train_step builds it, over ten identical gradient sequences.
    Frozen fields stay bit-unchanged. Trained fields: within 1e-6 relative
    of Adam computed in float64, and within 1e-5 of optax (measured
    6.2e-6): optax rounds the bias corrections 1 - b^t to float32
    (1 - 0.999 is 1.3e-5 off there), PyTorch keeps them in float64. With
    that rounding put into the float64 reference, optax meets 1e-6 too."""
    js = jscene.make_three_sphere_scene()
    ps = _port_scene(js)
    trainable = ("albedo", "center0", "radius")
    lr = 5e-2
    params, opt, _ = make_fast_train_step(ps, _tiny_camera(), learning_rate=lr,
                                          trainable=trainable, device="cpu")
    mask = trainable_mask(trainable)
    labels = jinv.SceneParams(**{f: ("train" if getattr(mask, f) else "freeze")
                                 for f in SceneParams._fields})
    tx = optax.multi_transform({"train": optax.adam(lr), "freeze": optax.set_to_zero()},
                               labels)
    jparams = jinv.extract_params(js)
    state = tx.init(jparams)
    start = SceneParams(*(x.detach().clone() for x in params))
    rng = np.random.default_rng(5)
    seq = []
    for _ in range(10):
        gs = [rng.normal(size=np.shape(x)).astype(np.float32) for x in jparams]
        seq.append(gs)
        updates, state = tx.update(jinv.SceneParams(*map(jnp.asarray, gs)), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        apply_updates(opt, params, SceneParams(*(torch.from_numpy(g) for g in gs)), mask)
    for k, f in enumerate(SceneParams._fields):
        got = getattr(params, f).detach().numpy()
        if not getattr(mask, f):
            assert torch.equal(getattr(params, f).detach(), getattr(start, f)), f
            continue
        p0 = getattr(start, f).numpy()
        want = np.asarray(getattr(jparams, f))
        exact = _adam_reference(p0, [gs[k] for gs in seq], lr, False)
        optax_like = _adam_reference(p0, [gs[k] for gs in seq], lr, True)
        scale = np.abs(exact).max()
        np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-6 * scale, err_msg=f)
        np.testing.assert_allclose(want, optax_like, rtol=1e-6, atol=1e-6 * scale, err_msg=f)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=f)


def test_fast_train_step_refuses_what_it_cannot_do():
    js, jf = _scene_and_front("three")
    ps, pf = _port_scene(js), _port_front(jf)
    cam = _tiny_camera()
    with pytest.raises(ValueError, match="FIXED geometry"):
        make_fast_train_step(ps, cam, front=pf, trainable=("albedo", "radius"), device="cpu")
    with pytest.raises(ValueError, match="FIXED geometry"):
        make_fast_train_step(ps, cam, front=pf, device="cpu")  # None trains every field
    with pytest.raises(ValueError, match="FIXED geometry"):
        make_fast_train_step(ps, cam, bvh=object(), trainable=("albedo", "center0"),
                             device="cpu")
    with pytest.raises(ValueError, match="no BVH walk"):
        make_fast_train_step(ps, cam, two_phase=2, bvh=object(), trainable=("albedo",),
                             device="cpu")
    with pytest.raises(ValueError, match="two-phase cut"):
        make_fast_train_step(ps, cam, two_phase=cam.max_depth, device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        make_fast_train_step(ps, cam, replay_gather="colT", device="cpu")
    with pytest.raises(ValueError, match="unknown trainable"):
        make_fast_train_step(ps, cam, trainable=("albedo", "colour"), device="cpu")


def test_materials_step_with_front_moves_only_materials():
    """Materials-only training with a front (the leaf-ordered three-sphere
    scene): a step gives finite loss and gradients, moves albedo, fuzz and
    ior, and leaves the geometry bit-unchanged."""
    js, jf = _scene_and_front("three")
    ps, pf = _port_scene(js), _port_front(jf)
    cam = _tiny_camera(image_width=16, max_depth=3, lookfrom=(0.0, 0.5, 1.5),
                       lookat=(0.0, 0.0, -1.0))
    target = torch.full((16, 16, 3), 0.5)
    trainable = ("albedo", "fuzz", "ior")
    params, opt, step = make_fast_train_step(ps, cam, spp=2, trainable=trainable, front=pf,
                                             device="cpu",
                                             generator=torch.Generator().manual_seed(1))
    before = SceneParams(*(x.detach().clone() for x in params))
    for _ in range(2):
        params, opt, loss, grads = step(params, opt, None, target)
        assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    for f in ("center0", "center_delta", "radius"):
        assert torch.equal(getattr(params, f).detach(), getattr(before, f)), f
    assert not torch.equal(params.albedo.detach(), before.albedo)
    assert mk.LAUNCHES["record_front"] == 0  # CPU tensors ran the plain version


def test_fast_train_step_recovers_albedo():
    """tests/test_grad.py's albedo recovery on the port's fast path: a
    single sphere, 24x24, 16 spp, depth 3, 60 steps of Adam(5e-2) from
    albedo 0.4 toward a render of albedo (0.8, 0.2, 0.5)."""
    cam = _tiny_camera(max_depth=3)
    settings = RenderSettings(device="cpu", use_bvh=False)
    target = render(_single_sphere((0.8, 0.2, 0.5)), dataclasses.replace(cam, samples_per_pixel=32),
                    torch.Generator().manual_seed(3), settings)
    params, opt, step = make_fast_train_step(_single_sphere((0.4, 0.4, 0.4)), cam, spp=16,
                                             learning_rate=5e-2, trainable=("albedo",), device="cpu",
                                             generator=torch.Generator().manual_seed(4))
    losses = []
    for _ in range(60):
        params, opt, loss, _ = step(params, opt, None, target)
        losses.append(float(loss))
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; albedo {params.albedo[0].tolist()}")
    assert losses[-1] < 0.1 * losses[0]
    np.testing.assert_allclose(params.albedo[0].detach().numpy(), [0.8, 0.2, 0.5], atol=0.08)
    assert params.radius.item() == pytest.approx(0.7)  # frozen
