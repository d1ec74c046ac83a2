"""The port's ops/intersect.py against the JAX package's, on shared inputs
made with numpy: sphere_hit_t, closest_hit and aabb_hit (values), and
closest_hit's gradients against jax.grad in float64."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu import scene as jscene
from raytracingproject_tpu.ops import intersect as jint

from raytracingproject_tpu_torch.ops import intersect as pint
from raytracingproject_tpu_torch.ops.vecmath import cross
from test_torch_megakernel import _port_scene


def _scenes():
    return {
        "three": jscene.make_three_sphere_scene(),            # static
        "cover": jscene.make_cover_scene(0),                  # moving spheres, all materials
        "random150": jscene.make_random_scene(150, seed=3),
        "padded": jscene.make_three_sphere_scene().pad_to(8),  # inert r = 0 spheres
    }


def _rays(js, m, seed):
    """m rays: random ones (test_pallas_trace.py's), rays from inside a
    sphere (far root), rays leaving a sphere's surface (the near root sits
    at ~0 and t_min rejects it) and rays that miss everything."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    t = rng.random(m).astype(np.float32)
    c0 = np.asarray(js.center0)
    cd = np.asarray(js.center_delta)
    rad = np.asarray(js.radius)
    k = m // 8
    pick = rng.integers(0, min(c0.shape[0], 4), k)
    ctr = c0[pick] + t[:k, None] * cd[pick]
    o[:k] = ctr                                            # inside: only the far root is valid
    unit = d[k:2 * k] / np.linalg.norm(d[k:2 * k], axis=1, keepdims=True)
    o[k:2 * k] = ctr + unit * rad[pick][:, None]           # on the surface, heading out
    d[k:2 * k] = unit
    o[2 * k:3 * k] = (0.0, 2000.0, 0.0)                    # above everything, heading up
    d[2 * k:3 * k, 1] = np.abs(d[2 * k:3 * k, 1]) + 0.1
    return o, d, t


def _T(*xs, dtype=torch.float32):
    return [torch.from_numpy(np.array(x)).to(dtype) for x in xs]


# Tolerance of t and p (absolute + relative) and of the normal per scene.
# Near scenes agree to 1e-5. On the far scenes (a 1000-unit ground sphere
# and 0.1-0.3 unit spheres seen from up to 14 units) the reference
# quadratic cancels, XLA rounds it through contracted FMAs and PyTorch
# rounds each product: measured max |diff| 2.0e-4 in t and p (9.5e-5
# relative) and 2.7e-4 in the normal (a p difference over a 0.2 radius).
TOL = {"three": (1e-5, 1e-5), "padded": (1e-5, 1e-5), "cover": (4e-4, 1e-3),
       "random150": (4e-4, 1e-3)}


@pytest.mark.parametrize("name", ["three", "cover", "random150", "padded"])
def test_closest_hit_matches_jax(name):
    """Hit mask equal; idx equal but for near-ties (t within the scene's
    tolerance); t, p and normal within TOL on rays whose idx agree."""
    js = _scenes()[name]
    o, d, t = _rays(js, 512, seed=1)
    ref = jint.closest_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), js.center0,
                           js.center_delta, js.radius)
    ps = _port_scene(js)
    got = pint.closest_hit(*_T(o, d, t), ps.center0, ps.center_delta, ps.radius)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert 0.2 < hit.mean() < 1.0 or name == "padded"
    assert got.idx.dtype == torch.int32 and (got.idx.numpy()[~hit] == 0).all()
    assert np.isinf(got.t.numpy()[~hit]).all()
    same = got.idx.numpy() == np.asarray(ref.idx)
    tol, tol_n = TOL[name]
    with np.errstate(invalid="ignore"):  # inf - inf on the misses
        tie = np.abs(got.t.numpy() - np.asarray(ref.t)) <= tol * (1 + np.abs(np.asarray(ref.t)))
    assert np.all(same | tie | ~hit)
    sel = hit & same
    for field in ("t", "p", "normal"):
        a, b = getattr(got, field).numpy()[sel], np.asarray(getattr(ref, field))[sel]
        print(name, field, np.abs(a - b).max())
        ft = tol_n if field == "normal" else tol
        np.testing.assert_allclose(a, b, rtol=ft, atol=ft)
    np.testing.assert_array_equal(got.front_face.numpy()[sel], np.asarray(ref.front_face)[sel])


def test_closest_hit_far_root_and_t_min():
    """The named cases one by one: from a sphere's centre the far root
    (t = r, back face); from its surface heading out, t_min rejects the
    near root and the ray leaves (no self-hit); a ray aimed away misses."""
    js = jscene.make_three_sphere_scene()
    ps = _port_scene(js)
    o = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.5, -1.0], [0.0, 5.0, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    rec = pint.closest_hit(o, d, torch.zeros(3), ps.center0, ps.center_delta, ps.radius)
    ref = jint.closest_hit(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.zeros(3),
                           js.center0, js.center_delta, js.radius)
    assert rec.hit.tolist() == [True, False, False] == np.asarray(ref.hit).tolist()
    assert rec.idx[0] == 1 and abs(float(rec.t[0]) - 0.5) < 1e-6
    assert not bool(rec.front_face[0]) and rec.normal[0].tolist() == [0.0, -1.0, 0.0]


@pytest.mark.parametrize("name", ["three", "cover"])
def test_sphere_hit_t_matches_jax(name):
    """[R, N] roots: valid mask equal but where a root sits at t_min or the
    discriminant within rounding of 0 (at most 1e-4 of the pairs; measured
    0), t within the scene's TOL where both are valid."""
    js = _scenes()[name]
    o, d, t = _rays(js, 256, seed=2)
    jc = js.center0[None] + jnp.asarray(t)[:, None, None] * js.center_delta[None]
    jt, jv = jint.sphere_hit_t(jnp.asarray(o), jnp.asarray(d), jc, js.radius)
    ps = _port_scene(js)
    po, pd, pt = _T(o, d, t)
    pc = ps.center0[None] + pt[:, None, None] * ps.center_delta[None]
    gt, gv = pint.sphere_hit_t(po, pd, pc, ps.radius)
    assert gt.shape == (256, ps.num_spheres)
    mismatch = (gv.numpy() != np.asarray(jv)).mean()
    print(name, "valid mismatches", mismatch)
    assert mismatch <= 1e-4
    both = gv.numpy() & np.asarray(jv)
    np.testing.assert_allclose(gt.numpy()[both], np.asarray(jt)[both], rtol=TOL[name][0],
                               atol=TOL[name][0])
    # static centres [N, 3] broadcast
    gt2, gv2 = pint.sphere_hit_t(po, pd, ps.center0, ps.radius)
    jt2, jv2 = jint.sphere_hit_t(jnp.asarray(o), jnp.asarray(d), js.center0, js.radius)
    assert (gv2.numpy() != np.asarray(jv2)).mean() <= 1e-4


def test_aabb_hit_and_cross_match_jax():
    rng = np.random.default_rng(5)
    o = rng.uniform(-4, 4, (400, 3)).astype(np.float32)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d[:40, 0] = 0.0  # axis-parallel rays: +-inf slabs
    lo = rng.uniform(-3, 1, (400, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 3, (400, 3)).astype(np.float32)
    ref = np.asarray(jint.aabb_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                                   jnp.asarray(hi)))
    got = pint.aabb_hit(*_T(o, d, lo, hi)).numpy()
    assert 0.02 < ref.mean() < 0.95
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(cross(*_T(o, d)).numpy(), np.cross(o, d), rtol=1e-6, atol=1e-6)


def test_closest_hit_selection_is_chunked(monkeypatch):
    """The winner selection runs in ray chunks (bounded temporaries) and
    gives the same record whatever the chunk."""
    js = jscene.make_cover_scene(0)
    ps = _port_scene(js)
    rays = _T(*_rays(js, 300, seed=4))
    whole = pint.closest_hit(*rays, ps.center0, ps.center_delta, ps.radius)
    monkeypatch.setattr(pint, "SELECT_BLOCK", 37 * ps.num_spheres)  # 37-ray chunks
    parts = pint.closest_hit(*rays, ps.center0, ps.center_delta, ps.radius)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["three", "cover"])
def test_closest_hit_gradients_match_jax(name):
    """d(sum of weighted t, p, normal over hit rays) / d(center0,
    center_delta, radius, origin, direction) against jax.grad of the JAX
    closest_hit, both in float64: relative-norm error <= 1e-9 per argument
    (measured ~1e-15). The port selects the winner without autograd and
    re-evaluates its root; the JAX function differentiates the masked
    argmin; they are the same function."""
    js = _scenes()[name]
    o, d, t = _rays(js, 384, seed=7)
    rng = np.random.default_rng(8)
    wt, wp, wn = rng.normal(size=384), rng.normal(size=(384, 3)), rng.normal(size=(384, 3))

    with jax.enable_x64(True):
        f64 = lambda x: jnp.asarray(np.asarray(x, np.float64))  # noqa: E731

        def jloss(c0, cd, rad, oo, dd):
            rec = jint.closest_hit(oo, dd, f64(t), c0, cd, rad)
            h = rec.hit
            return (jnp.sum(jnp.where(h, rec.t, 0.0) * wt)
                    + jnp.sum(jnp.where(h[:, None], rec.p * wp + rec.normal * wn, 0.0)))

        jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
            f64(js.center0), f64(js.center_delta), f64(js.radius), f64(o), f64(d))
        jg = [np.asarray(g) for g in jg]

    ps = _port_scene(js)
    args = [x.double().requires_grad_(True) for x in (ps.center0, ps.center_delta, ps.radius,
                                                     *_T(o, d))]
    rec = pint.closest_hit(args[3], args[4], torch.from_numpy(t).double(), *args[:3])
    h = rec.hit
    loss = (torch.sum(torch.where(h, rec.t, 0.0) * torch.from_numpy(wt))
            + torch.sum(torch.where(h[:, None], rec.p * torch.from_numpy(wp)
                                    + rec.normal * torch.from_numpy(wn), 0.0)))
    pg = torch.autograd.grad(loss, args)
    for nm, a, b in zip(("center0", "center_delta", "radius", "origin", "direction"), jg, pg):
        assert np.isfinite(b.numpy()).all()
        rel = np.linalg.norm(b.numpy() - a) / (np.linalg.norm(a) + 1e-30)
        print(name, nm, rel)
        assert rel <= 1e-9, (nm, rel)
    # misses and a degenerate direction keep the gradients finite
    o0 = torch.tensor([[0.0, 5.0, 0.0], [0.0, 0.0, 0.0]], dtype=torch.float64)
    d0 = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 0.0]], dtype=torch.float64,
                      requires_grad=True)
    c0 = ps.center0.double().requires_grad_(True)
    rec = pint.closest_hit(o0, d0, torch.zeros(2, dtype=torch.float64), c0,
                           ps.center_delta.double(), ps.radius.double())
    g = torch.autograd.grad(rec.p.sum() + rec.normal.sum(), (d0, c0))
    assert not rec.hit.any() and all(torch.isfinite(x).all() for x in g)
