"""Geometry training on the front-culled kernel: the port's FrontRefresher,
make_fast_radiance_dynamic_front and make_fast_geometry_train_step against
the JAX package's (ops/pallas/megakernel.py:1102-1337, grad/fast.py:168-343)
and against the port's own brute fast step.

Scenes come from the same numpy draws in both packages; rays are made by
the JAX package and handed over as numpy arrays. The recording kernel
(K5's front core) runs here as its plain version; chip_smoke.py holds the
kernel against it on refreshed tables on the card.
"""

import dataclasses
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu import scene as jscene
from raytracingproject_tpu.bvh import build_bvh as jbuild_bvh
from raytracingproject_tpu.grad import inverse as jinv
from raytracingproject_tpu.grad.fast import (
    make_fast_radiance_dynamic_front as jmake_dynamic,
)
from raytracingproject_tpu.ops.pallas.megakernel import (
    FrontRefresher as JFrontRefresher, pallas_trace_record,
)

from raytracingproject_tpu_torch import bridge
from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.grad import (
    SceneParams, extract_params, make_fast_geometry_train_step,
    make_fast_radiance_dynamic_front, make_fast_train_step,
)
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
from raytracingproject_tpu_torch.scene import SceneBuilder, make_random_scene
from test_torch_grad import _rel_errors
from test_torch_megakernel import _port_scene, _rays

ORDER_POINT = (13.0, 2.0, 3.0)
CAM = dict(aspect_ratio=16.0 / 9.0, image_width=48, samples_per_pixel=1, max_depth=3,
           vfov=20.0, lookfrom=ORDER_POINT, lookat=(0.0, 0.0, 0.0))
# (scene maker, leaf size, max_nodes): one word (tests/test_pallas_megakernel.py's
# refresh_in_jit scene), two words, 25 words (two super-words), and the
# session's scene (two spheres padded to 200 with spheres parked at y = 1e9)
SCENES = {
    "random70": (lambda: jscene.make_random_scene(70, seed=17), 4, None),
    "two_words": (lambda: jscene.make_random_scene(150, seed=3), 2, 48),
    "super_words": (lambda: jscene.make_random_scene(150, seed=3), 1, 600),
    "session": (lambda: jscene.SceneBuilder()
                .add_lambertian((0.0, 0.0, -2.0), 1.0, (0.9, 0.2, 0.2))
                .add_lambertian((1.5, 0.5, -2.5), 0.5, (0.2, 0.9, 0.2))
                .build().pad_to(200), 8, None),
}
TABLES = ("sph", "ff", "fi", "wf", "sf", "remap")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread for this module: its shapes are too small to
    split, and it keeps the workers of a parallel test run from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both_refreshers(name):
    """(JAX scene, JAX refresher, port scene, port refresher, port bvh)."""
    make, leaf, max_nodes = SCENES[name]
    js = make()
    jb = jbuild_bvh(js, leaf_size=leaf)
    jr = JFrontRefresher(js, jb, max_nodes=max_nodes, order_point=ORDER_POINT)
    ps = _port_scene(js)
    pb = bridge.bvh_from_arrays(*(np.asarray(x) for x in jb))
    pr = mk.FrontRefresher(ps, pb, max_nodes=max_nodes, order_point=ORDER_POINT)
    return js, jr, ps, pr, pb


def _moved(params):
    """tests/test_pallas_megakernel.py:464-473's move, on numpy leaves:
    sphere 5 shifted by (0.4, 0.2, -0.3), sphere 11's radius x1.3."""
    c0 = np.array(params.center0, np.float32)
    rad = np.array(params.radius, np.float32)
    c0[5] += np.float32([0.4, 0.2, -0.3])
    rad[11] *= np.float32(1.3)
    return c0, rad


@pytest.mark.parametrize("name", list(SCENES))
def test_refresh_matches_jax_and_device_matches_host(name):
    """On the moved scene: the port's `refresh_device` equals its `refresh`
    bit for bit, and both equal the JAX refresher's `refresh` and
    `refresh_in_jit` in every table (sph, ff, fi, wf, sf, remap): the same
    float32 adds, and min and max, which are exact."""
    js, jr, ps, pr, _ = _both_refreshers(name)
    jp = jinv.extract_params(js)
    c0, rad = _moved(jp)
    jp = jp._replace(center0=jnp.asarray(c0), radius=jnp.asarray(rad))
    pp = extract_params(ps)._replace(center0=torch.from_numpy(c0), radius=torch.from_numpy(rad))
    host, dev = pr.refresh(pp), pr.refresh_device(pp)
    jhost, jdev = jr.refresh(jp), jax.jit(jr.refresh_in_jit)(jp)
    assert dev.remap_order == host.remap_order == "scene"
    for f in TABLES:
        assert torch.equal(getattr(dev, f), getattr(host, f)), f
        for ref in (jhost, jdev):
            np.testing.assert_array_equal(getattr(host, f).numpy(), np.asarray(getattr(ref, f)),
                                          err_msg=f)
    assert host.repack == jhost.repack == mk.DEFAULT_REPACK
    assert host.bf is None and not host.word_earlyout


@pytest.mark.parametrize("name", ["random70", "super_words", "session"])
def test_refreshed_boxes_bound_their_spheres(name):
    """Every sphere lies in its subtree's refreshed box at t = 0 and t = 1,
    every real subtree box in its word's box, every real word box in its
    super-word's; padding entries are the 1e30 point."""
    _, _, ps, pr, _ = _both_refreshers(name)
    p = extract_params(ps)
    c0 = p.center0.clone()
    c0[5] += torch.tensor([0.9, -0.4, 0.6])
    fr = pr.refresh_device(p._replace(center0=c0, radius=p.radius * 1.1))
    owner = fr.column_subtree()
    for tt in (0.0, 1.0):
        ctr = fr.sph[0:3] + tt * fr.sph[3:6]
        r = fr.sph[6].abs()
        assert (ctr - r >= fr.ff[0:3, owner]).all() and (ctr + r <= fr.ff[3:6, owner]).all()
    real = fr.fi[1] > 0
    assert (fr.ff[0:6, ~real] == 1e30).all()
    word = torch.arange(fr.ff.shape[1]) // mk.WORD
    assert (fr.ff[0:3, real] >= fr.wf[0:3, word[real]]).all()
    assert (fr.ff[3:6, real] <= fr.wf[3:6, word[real]]).all()
    live = fr.wf[0] < 1e29
    sup = torch.arange(fr.wf.shape[1]) // mk.WORD
    assert (fr.wf[0:3, live] >= fr.sf[0:3, sup[live]]).all()
    assert (fr.wf[3:6, live] <= fr.sf[3:6, sup[live]]).all()
    assert (fr.wf[0:6, ~live] == 1e30).all() and (fr.wf[6:8] == 0).all()


def test_refreshed_remap_composes_prim_order():
    """At the build parameters: remap == prim_order[front_tables' remap]
    (tests/test_pallas_megakernel.py:292-373), and the padded table, the
    layout and the column owners are front_tables' (the boxes are not:
    front_tables takes the BVH's node boxes, the refresher exact unions)."""
    s = make_random_scene(60, seed=5)
    bvh = build_bvh(s, leaf_size=4)
    front = mk.front_tables(reorder_scene(s, bvh), bvh, order_point=ORDER_POINT)
    fr = mk.FrontRefresher(s, bvh, order_point=ORDER_POINT).refresh(extract_params(s))
    assert torch.equal(fr.remap.long(), bvh.prim_order.long()[front.remap.long()])
    assert torch.equal(fr.sph, front.sph) and torch.equal(fr.fi, front.fi)
    assert torch.equal(fr.column_subtree(), front.column_subtree())
    assert front.remap_order == "leaf"


def test_front_tables_carry_their_column_owners():
    """front_tables and the refresher hand over the column-to-subtree map
    they built; column_subtree() returns it, equal to the map rebuilt from
    `fi` for fronts that do not carry one (the bridge's)."""
    s = make_random_scene(150, seed=3)
    bvh = build_bvh(s, leaf_size=2)
    front = mk.front_tables(reorder_scene(s, bvh), bvh, max_nodes=48)
    assert front.owner is not None
    bare = bridge.front_from_arrays(*(x.numpy() for x in (front.sph, front.ff, front.fi,
                                                          front.wf, front.sf, front.remap)),
                                    front.repack)
    assert bare.owner is None
    assert torch.equal(front.column_subtree(), bare.column_subtree())
    assert torch.equal(front.to("cpu").column_subtree(), front.owner)


def test_culled_twin_equals_brute_twin_on_the_moved_scene():
    """The front-culled plain version over refreshed tables equals the brute
    plain version on the moved scene (radiance and residuals, depth 3,
    zero draws): culled subtrees hold no closer hit."""
    s = make_random_scene(40, seed=9)
    bvh = build_bvh(s, leaf_size=4)
    p = extract_params(s)
    c0 = p.center0.clone()
    c0[7] += torch.tensor([0.9, -0.4, 0.6])
    moved = p._replace(center0=c0)
    fr = mk.FrontRefresher(s, bvh).refresh(moved)
    moved_scene = dataclasses.replace(s, center0=c0)
    rays = tuple(torch.from_numpy(x) for x in _rays(CAM, 2048, seed=4))
    rad_b, res_b = mk.trace_record(*rays, moved_scene, 5, 3, zero_draws=True)
    rad_f, res_f = mk.trace_record(*rays, moved_scene, 5, 3, front=fr, zero_draws=True)
    assert torch.equal(rad_f, rad_b)
    assert all(torch.equal(a, b) for a, b in zip(res_f, res_b))


@pytest.mark.parametrize("n,fits", [(3000, True), (3500, False)])
def test_over_budget_raises_at_build(n, fits):
    """The refresher counts shared memory as front_tables does (the 227 KB
    budget): 3,000 spheres fit (223,616 B, K3's route in `render`), 3,500
    raise FrontOverBudget when the refresher is built, before any launch;
    front_tables agrees on both."""
    s = make_random_scene(n, seed=3)
    bvh = build_bvh(s, leaf_size=8)
    tables = lambda: mk.front_tables(reorder_scene(s, bvh), bvh,  # noqa: E731
                                     order_point=ORDER_POINT)
    if fits:
        fr = mk.FrontRefresher(s, bvh, order_point=ORDER_POINT).refresh(extract_params(s))
        size = lambda f: 4 * sum(getattr(f, k).numel() for k in TABLES[:5])  # noqa: E731
        assert size(fr) == size(tables()) == 223616 <= mk.SMEM_BUDGET_BYTES
    else:
        with pytest.raises(mk.FrontOverBudget, match="refreshed front tables"):
            mk.FrontRefresher(s, bvh, order_point=ORDER_POINT)
        with pytest.raises(mk.FrontOverBudget):
            tables()


def test_leaf_order_front_is_refused():
    """A front whose remap maps to BVH leaf order (front_tables') cannot be
    paired with the original-order scene of the dynamic-front paths: the
    radiance and the explicit-front step refuse it."""
    s = make_random_scene(30, seed=11)
    bvh = build_bvh(s, leaf_size=4)
    leaf_front = mk.front_tables(reorder_scene(s, bvh), bvh)
    rays = tuple(torch.from_numpy(x) for x in _rays(CAM, 64, seed=1))
    radiance = make_fast_radiance_dynamic_front(s, 2)
    with pytest.raises(ValueError, match="original scene order"):
        radiance(extract_params(s), *rays, 3, leaf_front)
    cam = Camera(**dict(CAM, image_width=8))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params, opt, step = make_fast_geometry_train_step(s, cam, spp=1, device="cpu")
    with pytest.raises(ValueError, match="original scene order"):
        step(params, opt, torch.Generator().manual_seed(0), torch.zeros(4, 8, 3), leaf_front)


def test_dynamic_front_radiance_matches_jax():
    """make_fast_radiance_dynamic_front against the JAX package's
    (interpret=True) on the same rays, zero draws on both sides, each over
    its own refresher's tables of the moved scene, at the tolerances of
    test_torch_grad.py::test_fast_radiance_matches_jax: the weights keep the
    rays whose residuals agree in both packages; value rtol 1e-5; gradients
    relative-norm <= 1e-4 for the materials, <= 5e-4 for geometry, fuzz
    left out (zero draws make its gradient rounding noise)."""
    js, jr, ps, pr, _ = _both_refreshers("random70")
    jp = jinv.extract_params(js)
    c0, rad = _moved(jp)
    jp = jp._replace(center0=jnp.asarray(c0), radius=jnp.asarray(rad))
    js = js._replace(center0=jp.center0, radius=jp.radius)
    ps = dataclasses.replace(ps, center0=torch.from_numpy(c0), radius=torch.from_numpy(rad))
    o, d, t = _rays(CAM, 512, seed=4)
    jo, jd, jt = (jnp.asarray(x) for x in (o, d, t))
    rays = tuple(torch.from_numpy(x) for x in (o, d, t))
    depth = 3
    jfront = jr.refresh(jp)
    pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(ps)))
    pfront = pr.refresh_device(SceneParams(*(x.detach() for x in pp)))
    _, jres = pallas_trace_record(jo, jd, jt, js, jnp.int32(3), depth, interpret=True,
                                  front=jfront)
    _, pres = mk.trace_record(*rays, ps, 3, depth, front=pfront, zero_draws=True)
    same = ((np.asarray(jres.idx) == pres.idx.numpy()).all(axis=0)
            & (np.abs(np.asarray(jres.ndir) - pres.ndir.numpy()).max(axis=2) <= 1e-4).all(axis=0))
    print(f"{same.mean():.4f} of rays with the same residuals")
    assert same.mean() >= 0.75
    w = (np.random.default_rng(1).random((512, 3)) * same[:, None]).astype(np.float32)

    jrad = jmake_dynamic(js, depth, interpret=True)
    val, g_ref = jax.value_and_grad(
        lambda p: jnp.sum(jrad(p, jo, jd, jt, jnp.float32(3), jfront) * w))(jp)
    prad = make_fast_radiance_dynamic_front(ps, depth, zero_draws=True)(pp, *rays, 3, pfront)
    pval = (prad * torch.from_numpy(w)).sum()
    g = torch.autograd.grad(pval, list(pp))
    rel = _rel_errors(js.fuzz, g_ref, g, skip=("fuzz",))
    print(f"value {float(pval):.6f} vs {float(val):.6f}; gradient errors {rel}")
    np.testing.assert_allclose(float(pval), float(val), rtol=1e-5)
    for field, err in rel.items():
        assert err <= (5e-4 if field in ("center0", "center_delta", "radius") else 1e-4), field


def _geometry_case():
    scene = make_random_scene(30, seed=11)
    cam = Camera(aspect_ratio=1.0, image_width=32, samples_per_pixel=1, max_depth=3,
                 vfov=20.0, lookfrom=ORDER_POINT, lookat=(0.0, 0.0, 0.0))
    refresher = mk.FrontRefresher(scene, build_bvh(scene, leaf_size=4), order_point=ORDER_POINT)
    return scene, cam, refresher, torch.zeros((32, 32, 3))


@pytest.mark.parametrize("form", ["refresher", "explicit"])
def test_geometry_step_matches_brute_step(form):
    """make_fast_geometry_train_step (tables refreshed on the device every
    step, or passed in by the caller) against the brute make_fast_train_step
    from the same generator seed (tests/test_pallas_megakernel.py:376-416):
    the same rays and Philox seed, so loss within rtol 1e-6 and gradients
    within 1e-6; a second step, from the updated parameters, is finite."""
    scene, cam, refresher, target = _geometry_case()
    trainable = ("center0", "radius", "albedo")
    bp, bo, bstep = make_fast_train_step(scene, cam, spp=1, trainable=trainable, device="cpu")
    if form == "refresher":
        gp, go, gstep = make_fast_geometry_train_step(scene, cam, refresher=refresher, spp=1,
                                                      trainable=trainable, device="cpu")
        fresh = lambda p: ()  # noqa: E731
    else:
        with pytest.warns(UserWarning, match="MUST pass fresh front tables"):
            gp, go, gstep = make_fast_geometry_train_step(scene, cam, spp=1,
                                                          trainable=trainable, device="cpu")
        fresh = lambda p: (refresher.refresh(p),)  # noqa: E731
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    _, _, bloss, bg = bstep(bp, bo, gen(6), target)
    gp, go, gloss, gg = gstep(gp, go, gen(6), target, *fresh(gp))
    np.testing.assert_allclose(float(gloss), float(bloss), rtol=1e-6)
    for f in SceneParams._fields:
        np.testing.assert_allclose(getattr(gg, f).numpy(), getattr(bg, f).numpy(), atol=1e-6,
                                   err_msg=f)
    moved = not torch.equal(gp.center0.detach(), scene.center0)
    _, _, gloss2, gg2 = gstep(gp, go, gen(7), target, *fresh(gp))
    assert moved and np.isfinite(float(gloss2))
    assert all(torch.isfinite(x).all() for x in gg2)


def test_make_fast_train_step_still_refuses_geometry_with_a_front():
    """As in the JAX package, trainable geometry with a static front is
    refused; the message names the refresher route."""
    scene, cam, _, _ = _geometry_case()
    bvh = build_bvh(scene, leaf_size=4)
    front = mk.front_tables(reorder_scene(scene, bvh), bvh)
    with pytest.raises(ValueError, match=r"make_fast_geometry_train_step\(refresher="):
        make_fast_train_step(reorder_scene(scene, bvh), cam, front=front, device="cpu",
                             trainable=("center0",))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no warning with a refresher, or for materials
        make_fast_geometry_train_step(scene, cam, refresher=mk.FrontRefresher(scene, bvh),
                                      device="cpu")
        make_fast_geometry_train_step(scene, cam, trainable=("albedo",), device="cpu")


def test_refresher_to_moves_its_maps():
    """The static maps live on the scene's device; to() moves them with the
    scene, and a refresh lands where its parameters are."""
    scene = SceneBuilder().add_lambertian((0, 0, 0), 0.5, (0.5, 0.5, 0.5)).build()
    r = mk.FrontRefresher(scene, build_bvh(scene, leaf_size=8))
    moved = r.to("cpu")
    assert moved is not r and moved.col_src.device.type == "cpu"
    fr = moved.refresh_device(extract_params(scene))
    assert fr.sph.shape == (mk.N_ROWS, mk.UNROLL) and fr.owner.device.type == "cpu"
