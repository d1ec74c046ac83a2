"""Large scenes in the port: the global-memory front (K7), the BVH walk (K8)
and the BVH recording core (K5 bvh), as their plain PyTorch versions on the
CPU, against the JAX package's Pallas kernels in interpret mode; the tables
of `front_tables_hbm` against the JAX package's; and the routes that reach
them (`render`, `make_fast_radiance`, `make_fast_train_step`).

The TPU interpreter's PRNG returns zeros, so the port runs with
`zero_draws` wherever it is held against JAX. The JAX interpreter walks a
tree node by node, so its BVH runs stay on the three-sphere scene. The CUDA
kernels are held against these plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu import bvh as jbvh, scene as jscene
from raytracingproject_tpu.camera import Camera as JCamera, generate_rays as jgenerate_rays
from raytracingproject_tpu.ops.pallas import megakernel as jmk

from raytracingproject_tpu_torch import bridge, bvh as pbvh, scene as pscene
from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.grad import (
    SceneParams, extract_params, make_fast_radiance, make_fast_train_step,
)
from raytracingproject_tpu_torch.ops.cuda import build, megakernel as mk
from raytracingproject_tpu_torch.render import prepare_scene, render

EYE = (8.0, 3.0, 8.0)
CAM = dict(aspect_ratio=16.0 / 9.0, image_width=64, samples_per_pixel=1, max_depth=4,
           vfov=40.0, lookfrom=EYE, lookat=(0.0, 0.0, 0.0), defocus_angle=0.0, focus_dist=1.0)
THREE_CAM = dict(aspect_ratio=16.0 / 9.0, image_width=64, samples_per_pixel=1, max_depth=8,
                 vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
                 defocus_angle=0.0, focus_dist=1.0)


@pytest.fixture(autouse=True, scope="module")
def _warm_thread_pool():
    """Run one large element-wise op before the first test. On this kind of
    host the first multi-threaded PyTorch op of a process can round one
    worker thread's share of its result differently (ROADMAP Queue 3: about
    one process in nine with 8 threads, none in 80 after such a warm-up),
    and the tests below compare two closest hits for exact equality."""
    x = torch.ones(1 << 22)
    float((x * 2.0 + 1.0).sqrt().sum())


def _rays(cam_kw, n, seed):
    """n camera rays at random pixels, made by the JAX package (numpy)."""
    cam = JCamera(**cam_kw)
    w, h = cam.image_size()
    key = jax.random.PRNGKey(seed)
    idx = jax.random.randint(key, (n,), 0, w * h)
    o, d, t = jgenerate_rays(cam.derive(), (idx % w).astype(jnp.int32),
                             (idx // w).astype(jnp.int32), jax.random.fold_in(key, 1))
    return np.asarray(o), np.asarray(d), np.asarray(t)


def _torch_rays(cam_kw, n, seed):
    return tuple(torch.from_numpy(x.copy()) for x in _rays(cam_kw, n, seed))


def _random_pair(n, seed=5, leaf=8):
    """(JAX scene in leaf order, JAX bvh, port scene in leaf order, port bvh)."""
    js, ps = jscene.make_random_scene(n, seed=seed), pscene.make_random_scene(n, seed=seed)
    jb, pb = jbvh.build_bvh(js, leaf_size=leaf), pbvh.build_bvh(ps, leaf_size=leaf)
    return jbvh.reorder_scene(js, jb), jb, pbvh.reorder_scene(ps, pb), pb


def _three_pair():
    js, ps = jscene.make_three_sphere_scene(), pscene.make_three_sphere_scene()
    jb, pb = jbvh.build_bvh(js, leaf_size=2), pbvh.build_bvh(ps, leaf_size=2)
    return jbvh.reorder_scene(js, jb), jb, pbvh.reorder_scene(ps, pb), pb


def _hbm_from_jax(jt):
    return bridge.front_hbm_from_arrays(
        np.asarray(jt.sph), np.asarray(jt.ff), np.asarray(jt.fi), np.asarray(jt.wf),
        np.asarray(jt.sf), np.asarray(jt.remap), jt.word_earlyout,
        None if jt.bf is None else np.asarray(jt.bf), jt.ksub)


# ---- tables ----

def test_bvh_front_with_max_count_block_equal():
    """`bvh_front(max_count=BLOCK)`, the cut of the global-memory front, on
    2,000 spheres: equal arrays, no subtree above BLOCK spheres."""
    js, ps = jscene.make_random_scene(2000, seed=3), pscene.make_random_scene(2000, seed=3)
    jf = jbvh.bvh_front(jbvh.build_bvh(js, leaf_size=8), max_nodes=8, max_count=jmk.BLOCK)
    pf = pbvh.bvh_front(pbvh.build_bvh(ps, leaf_size=8), max_nodes=8, max_count=mk.BLOCK)
    for f in jf._fields:
        np.testing.assert_array_equal(getattr(pf, f), getattr(jf, f), err_msg=f)
    assert mk.BLOCK == jmk.BLOCK and int(pf.count.max()) <= mk.BLOCK
    assert pf.count.shape[0] > 8  # max_count forced more subtrees than max_nodes


@pytest.mark.parametrize("sub_block", [False, True])
@pytest.mark.parametrize("max_nodes", [24, 48])
def test_front_tables_hbm_equal(max_nodes, sub_block):
    """Integer tables and the floats copied from the scene equal the JAX
    package's exactly; boxes within 1e-6 (they are equal too). The port
    stores the spheres transposed: compared through the transpose, and
    through `remap` against the scene."""
    rs_j, jb, rs_p, pb = _random_pair(300)
    kw = dict(max_nodes=max_nodes, order_point=EYE, sub_block=sub_block)
    jt = jmk.front_tables_hbm(rs_j, jb, **kw)
    pt = mk.front_tables_hbm(rs_p, pb, **kw)
    for f in ("fi", "remap"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(jt, f)), f)
    np.testing.assert_array_equal(pt.sph.numpy().T, np.asarray(jt.sph))
    for f in ("ff", "wf", "sf"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(jt, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    assert pt.ksub == jt.ksub == (16 if sub_block else 0)
    if sub_block:
        np.testing.assert_allclose(pt.bf.numpy(), np.asarray(jt.bf), rtol=0, atol=1e-6)
    else:
        assert pt.bf is None and jt.bf is None
    cols = pt.valid_columns()
    tab = mk.scene_table(rs_p)
    assert torch.equal(pt.sph[cols].t(), tab[:, pt.remap[cols].long()])
    assert sorted(set(pt.remap[cols].tolist())) == list(range(300))
    # the bridge rebuilds the same object from the JAX arrays
    bt = _hbm_from_jax(jt)
    for f in dataclasses.fields(pt):
        a, b = getattr(pt, f.name), getattr(bt, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name


def test_bvh_tables_pack_the_tree():
    """The kernel's node records: both children's box bits and references
    in each inner node's record (the root's under record 0), a leaf child
    as ~((start << 8) | count). tests/test_torch_bvh_groups.py holds the
    walk over them."""
    _, _, _, pb = _random_pair(300)
    nodes = mk.bvh_tables(pb, "cpu").nodes
    inner = torch.nonzero(pb.leaf_count == 0)[:, 0]
    assert nodes.shape == (1 + inner.numel(), 16) and nodes.dtype == torch.int32
    first = torch.cat([torch.zeros(1, dtype=torch.long), inner + 1])
    second = pb.miss_link.long()[inner + 1]
    assert torch.equal(nodes[:, 0:3].view(torch.float32), pb.node_min[first])
    assert torch.equal(nodes[:, 4:7].view(torch.float32), pb.node_max[first])
    assert torch.equal(nodes[1:, 8:11].view(torch.float32), pb.node_min[second])
    assert torch.equal(nodes[1:, 12:15].view(torch.float32), pb.node_max[second])
    for col, child in ((3, first), (7, second)):
        rows = slice(0, None) if col == 3 else slice(1, None)
        ref = nodes[rows, col]
        leaf = pb.leaf_count[child] > 0
        assert bool((ref[~leaf] > 0).all()) and bool((ref[leaf] < 0).all())
        assert torch.equal((~ref[leaf]) >> 8, pb.leaf_start[child][leaf])
        assert torch.equal((~ref[leaf]) & 255, pb.leaf_count[child][leaf])
        assert torch.equal(inner[ref[~leaf].long() - 1], child[~leaf])
    big = pb._replace(leaf_count=pb.leaf_count * 300)
    with pytest.raises(ValueError, match="255"):
        mk.bvh_tables(big, "cpu")


# ---- K7: the global-memory front ----

@pytest.mark.parametrize("n_spheres,max_nodes,kw,depth,min_frac", [
    (200, 48, {}, 1, 1.0), (200, 48, {}, 2, 0.99), (400, 24, {}, 2, 0.99),
    (400, 24, {"sub_block": True, "word_earlyout": True}, 2, 0.99),
])
def test_hbm_twin_matches_pallas_hbm(n_spheres, max_nodes, kw, depth, min_frac):
    """K7's plain version against `pallas_trace_paths(front=<HBM tables>,
    interpret=True)` on the JAX package's own test scenes, rays within
    5e-5: all of them at depth 1 (draw-free). At depth 2 these scenes, seen
    from 12 units away, meet the far-scene cancellation of the reference
    quadratic (XLA contracts FMAs, PyTorch does not): 99.61% (200 spheres)
    and 99.32% (400) agree, exactly the shares of the two packages' brute
    scans on the same rays, while each package's front equals its own brute
    scan on every ray. The bound is 99%."""
    rs_j, jb, rs_p, pb = _random_pair(n_spheres)
    jt = jmk.front_tables_hbm(rs_j, jb, max_nodes=max_nodes, order_point=EYE, **kw)
    pt = mk.front_tables_hbm(rs_p, pb, max_nodes=max_nodes, order_point=EYE, **kw)
    o, d, t = _rays(CAM, 1024, seed=11)
    ref = np.asarray(jmk.pallas_trace_paths(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), rs_j,
                                            jnp.int32(7), depth, interpret=True, front=jt))
    rays = tuple(torch.from_numpy(x.copy()) for x in (o, d, t))
    got = mk.trace_paths(*rays, None, 7, depth, front=pt, zero_draws=True)
    frac = (np.abs(got.numpy() - ref).max(axis=1) <= 5e-5).mean()
    print(f"hbm {n_spheres}/{max_nodes}/{kw} depth {depth}: {frac:.6f} of rays within 5e-5")
    assert torch.isfinite(got).all() and frac >= min_frac
    assert torch.equal(got, mk.trace_paths(*rays, rs_p, 7, depth, zero_draws=True))


def test_hbm_twin_options_change_nothing():
    """Plain, `word_earlyout`, `sub_block` and both: culling only, so equal
    radiance (held to 1e-6, as the JAX package holds its kernels), and
    equal to the brute scan of the same scene up to ties."""
    _, _, rs, pb = _random_pair(400)
    o, d, t = _torch_rays(CAM, 1024, seed=13)
    outs = [mk.trace_paths(o, d, t, None, 5, 3,
                           front=mk.front_tables_hbm(rs, pb, max_nodes=24, order_point=EYE, **kw))
            for kw in ({}, {"word_earlyout": True}, {"sub_block": True},
                       {"sub_block": True, "word_earlyout": True})]
    for x in outs[1:]:
        torch.testing.assert_close(x, outs[0], rtol=0, atol=1e-6)
    brute = mk.trace_paths(o, d, t, rs, 5, 3)
    differ = (torch.abs(brute - outs[0]) > 1e-4).any(dim=1).double().mean().item()
    assert differ <= 1e-3, differ


def test_super_word_hbm_front_twin_equals_brute_twin():
    """More than 576 subtrees: three culling levels in the tables, and K7's
    plain version gives the brute scan's radiance (zero draws, so only
    culling can differ)."""
    ps = pscene.make_random_scene(1300, seed=4)
    pb = pbvh.build_bvh(ps, leaf_size=2)
    rs = pbvh.reorder_scene(ps, pb)
    pt = mk.front_tables_hbm(rs, pb, max_nodes=600)
    assert pt.ff.shape[1] == 600 and pt.wf.shape[1] == 48 and pt.sf.shape[1] == 2
    assert pt.sph.shape == (600 * mk.BLOCK, 16)
    g = torch.Generator().manual_seed(0)
    n = 512
    o = torch.tensor((13.0, 2.0, 3.0)).expand(n, 3).contiguous()
    target = torch.rand((n, 3), generator=g) * torch.tensor([20.0, 0.5, 20.0]) - \
        torch.tensor([10.0, 0.0, 10.0])
    d = (target - o).contiguous()
    t = torch.rand(n, generator=g)
    brute = mk.trace_paths(o, d, t, rs, 3, 4, zero_draws=True)
    front = mk.trace_paths(o, d, t, None, 3, 4, front=pt, zero_draws=True)
    differ = (front != brute).any(dim=1)
    assert not bool(differ.any()), (
        f"front != brute on {int(differ.sum())} of {n} rays; first {int(torch.nonzero(differ)[0])}")


# ---- K8: the BVH walk, and K5's bvh core ----

@pytest.mark.parametrize("depth,atol", [(1, 5e-5), (3, 5e-5)])
def test_bvh_twin_matches_pallas_bvh(depth, atol):
    """K8's plain version against `pallas_trace_paths(bvh=, interpret=True)`
    on the three-sphere scene (leaf size 2): depth 1 is draw-free, every
    ray within 5e-5 (the JAX package's own depth-1 bound); depth 3 with
    zero draws, >= 99.9% of rays within 5e-5."""
    rs_j, jb, rs_p, pb = _three_pair()
    o, d, t = _rays(THREE_CAM, 1024, seed=4)
    ref = np.asarray(jmk.pallas_trace_paths(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), rs_j,
                                            jnp.int32(7), max_depth=depth, interpret=True, bvh=jb))
    got = mk.trace_paths(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t), rs_p, 7,
                         depth, zero_draws=True, bvh=pb).numpy()
    assert np.isfinite(got).all()
    if depth == 1:
        np.testing.assert_allclose(got, ref, atol=atol)
    else:
        assert (np.abs(got - ref).max(axis=1) <= atol).mean() >= 0.999


@pytest.mark.parametrize("leaf", [2, 8])
def test_bvh_twin_equals_brute_twin(leaf):
    """The walk against the brute scan of the same leaf-ordered scene,
    Philox draws at depth 4: equal up to ties (<= 0.1% of rays differ; none
    measured), residual idx included."""
    _, _, rs, pb = _random_pair(300, leaf=leaf)
    o, d, t = _torch_rays(CAM, 2048, seed=9)
    brute, bres = mk.trace_record(o, d, t, rs, 12345, 4)
    walk, wres = mk.trace_record(o, d, t, rs, 12345, 4, bvh=pb)
    assert torch.equal(walk, mk.trace_paths(o, d, t, rs, 12345, 4, bvh=pb))
    differ = (brute != walk).any(dim=1).double().mean().item()
    assert torch.isfinite(walk).all() and differ <= 1e-3, differ
    assert (bres.idx == wres.idx).double().mean().item() >= 0.999


def test_record_bvh_twin_matches_pallas_record_bvh():
    """K5's bvh core: radiance within 5e-5, idx equal on >= 99.9% of
    entries, ndir within 1e-4 on >= 99.9% of entries where idx is equal
    (max 2.5e-4) and refl equal there: the bounds test_torch_record.py
    holds for the brute core on this scene."""
    rs_j, jb, rs_p, pb = _three_pair()
    o, d, t = _rays(THREE_CAM, 1024, seed=5)
    jrad, jres = jmk.pallas_trace_record(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), rs_j,
                                         jnp.int32(7), max_depth=3, interpret=True, bvh=jb)
    prad, pres = mk.trace_record(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t),
                                 rs_p, 7, 3, zero_draws=True, bvh=pb)
    assert pres.idx.shape == (3, 1024) and pres.idx.dtype == torch.int32
    assert (np.abs(prad.numpy() - np.asarray(jrad)).max(axis=1) <= 5e-5).all()
    eq = pres.idx.numpy() == np.asarray(jres.idx)
    nd_err = np.abs(pres.ndir.numpy() - np.asarray(jres.ndir)).max(axis=2)[eq]
    assert eq.mean() >= 0.999
    assert (nd_err <= 1e-4).mean() >= 0.999 and nd_err.max() <= 2.5e-4
    assert (pres.refl.numpy() == np.asarray(jres.refl))[eq].all()


def test_record_given_hbm_front_raises():
    _, _, rs, pb = _random_pair(200)
    pt = mk.front_tables_hbm(rs, pb, max_nodes=24)
    o, d, t = _torch_rays(CAM, 256, seed=1)
    for fn in (mk.trace_record, mk.trace_record_twin):
        with pytest.raises(ValueError, match="FrontTablesHBM"):
            fn(o, d, t, rs, 1, 2, front=pt)


# ---- the routes ----

def test_fast_radiance_bvh_gradients_equal_brute():
    """`make_fast_radiance(bvh=)`: material gradients equal the brute
    route's on the same rays and seed (the residuals are equal, so the
    replay is the same computation)."""
    _, _, rs, pb = _random_pair(300)
    o, d, t = _torch_rays(CAM, 1024, seed=21)
    w = torch.rand((1024, 3), generator=torch.Generator().manual_seed(2))
    grads = []
    for bvh in (None, pb):
        pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(rs)))
        rad = make_fast_radiance(rs, 4, bvh=bvh)(pp, o, d, t, 77)
        grads.append(torch.autograd.grad((rad * w).sum(), [pp.albedo, pp.fuzz, pp.ior]))
    for name, a, b in zip(("albedo", "fuzz", "ior"), *grads):
        assert torch.isfinite(b).all() and float(b.abs().sum()) > 0, name
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9, msg=name)


def test_train_step_with_bvh_moves_only_materials():
    _, _, rs, pb = _random_pair(60)
    cam = Camera(aspect_ratio=1.0, image_width=12, samples_per_pixel=2, max_depth=3, vfov=40.0,
                 lookfrom=EYE, lookat=(0.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="FIXED geometry"):
        make_fast_train_step(rs, cam, bvh=pb, trainable=("albedo", "radius"), device="cpu")
    with pytest.raises(ValueError, match="FIXED geometry"):
        make_fast_train_step(rs, cam, bvh=pb, device="cpu")  # None trains every field
    params, opt, step = make_fast_train_step(rs, cam, spp=2, bvh=pb, device="cpu",
                                             trainable=("albedo", "fuzz", "ior"))
    before = SceneParams(*(x.detach().clone() for x in params))
    params, opt, loss, grads = step(params, opt, None, torch.full((12, 12, 3), 0.5))
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    assert not torch.equal(params.albedo.detach(), before.albedo)
    for f in ("center0", "center_delta", "radius"):
        assert torch.equal(getattr(params, f).detach(), getattr(before, f)), f


def test_render_takes_the_hbm_route_past_the_budget(monkeypatch):
    """With the shared-memory budget set below the scene's tables,
    `prepare_scene` returns the BVHTables of its own tree (K8, the BVH
    walk), and `render` traces through them: from the same draws, the
    image of the same rays traced through `front_tables_hbm`'s K7 twin up
    to ties, and its mean within 5% of the brute route's."""
    scene = pscene.make_random_scene(300, seed=5)
    cam = Camera(**dict(CAM, image_width=48, samples_per_pixel=4))
    settings = RenderSettings(device="cpu")
    _, front = prepare_scene(scene, cam, settings)
    assert isinstance(front, mk.FrontTables)
    monkeypatch.setattr(mk, "SMEM_BUDGET_BYTES", 8192)
    rs, tables = prepare_scene(scene, cam, settings)
    assert isinstance(tables, mk.BVHTables)
    tree = pbvh.build_bvh(scene, leaf_size=8)
    assert torch.equal(tables.nodes, mk.bvh_tables(tree, "cpu").nodes)
    hbm = mk.front_tables_hbm(pbvh.reorder_scene(scene, tree), tree)

    def k7(o, d, t, _scene, seed, depth, bvh=None, front=None, **kw):
        assert isinstance(bvh, mk.BVHTables) and front is None  # render took K8's route
        return mk.trace_paths(o, d, t, None, seed, depth, front=hbm, **kw)

    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    img = render(scene, cam, gen(), settings)
    img7 = render(scene, cam, gen(), settings, tracer=k7)
    assert (img != img7).any(dim=-1).double().mean().item() <= 1e-2
    ref = render(scene, cam, settings=RenderSettings(device="cpu", use_bvh=False))
    assert img.shape == ref.shape and torch.isfinite(img).all()
    assert abs(img.mean().item() - ref.mean().item()) <= 0.05 * ref.mean().item()


@pytest.mark.parametrize("tail", [False, True], ids=["alone", "tail"])
@pytest.mark.parametrize("n_spheres", [2900, 3100, 3300, 3500, 3632, 3633, 3700])
def test_front_bytes_floor_never_refuses_a_front_that_fits(n_spheres, tail):
    """Around the threshold (3,632 spheres of 64 B fill the 232,448 B
    budget), with and without the depth tail's live list beside the
    tables: the early bound is at most the bytes the front reaches when
    built with no budget, so `front_tables` refuses a scene exactly when
    its built front would pass the budget."""
    scene = pscene.make_random_scene(n_spheres, seed=3)
    tree = pbvh.build_bvh(scene, leaf_size=8)
    rs = pbvh.reorder_scene(scene, tree)
    kw = dict(order_point=(13.0, 2.0, 3.0), repack=1)
    front = mk.front_tables(rs, tree, smem_budget=None, **kw)
    built = 4 * sum(getattr(front, f).numel() for f in ("sph", "ff", "fi", "wf", "sf"))
    assert mk.front_bytes_floor(n_spheres) == 64 * n_spheres <= built
    budget = mk.SMEM_BUDGET_BYTES - (mk.SEGMENT_LIST_BYTES if tail else 0)
    if built <= budget:
        assert torch.equal(mk.front_tables(rs, tree, smem_budget=budget, **kw).sph, front.sph)
    else:
        with pytest.raises(mk.FrontOverBudget):
            mk.front_tables(rs, tree, smem_budget=budget, **kw)


def test_no_front_is_built_past_the_bound(monkeypatch):
    """A scene past `front_bytes_floor` builds no front: with the front cut
    (`bvh_front`), the table read (`scene_table`) and K7's builder all
    raising, `prepare_scene` still returns K8's tables."""
    from raytracingproject_tpu_torch.utils import profiling

    scene = pscene.make_random_scene(4000, seed=3)
    assert mk.front_bytes_floor(scene.num_spheres) > mk.SMEM_BUDGET_BYTES

    def refuse(*args, **kwargs):
        raise AssertionError("a front was built past the bound")

    for mod, name in ((pbvh, "bvh_front"), (mk, "scene_table"), (mk, "front_tables_hbm")):
        monkeypatch.setattr(mod, name, refuse)
    profiling.reset_counters()
    rs, tables = prepare_scene(scene, Camera(**CAM), RenderSettings(device="cpu"))
    assert isinstance(tables, mk.BVHTables) and rs.num_spheres == 4000
    c = profiling.counters()
    assert (c["front_refusals"], c["routes.bvh"], c["routes.front"]) == (1, 1, 0)
    profiling.reset_counters()


def test_prepare_scene_falls_back_to_k7_past_the_stack(monkeypatch):
    """A tree the walk refuses (here: deeper than a stack of one entry)
    keeps the global-memory front (K7), in leaf order as the JAX `render`
    builds it, and `render` traces through it."""
    from raytracingproject_tpu_torch.utils import profiling

    scene = pscene.make_random_scene(300, seed=5)
    cam = Camera(**dict(CAM, image_width=24, samples_per_pixel=2))
    monkeypatch.setattr(mk, "SMEM_BUDGET_BYTES", 8192)
    monkeypatch.setattr(mk, "BVH_STACK", 1)
    tree = pbvh.build_bvh(scene, leaf_size=8)
    with pytest.raises(mk.BVHRefused, match="depth"):
        mk.bvh_tables(tree, "cpu")
    profiling.reset_counters()
    rs, front = prepare_scene(scene, cam, RenderSettings(device="cpu"))
    assert isinstance(front, mk.FrontTablesHBM)
    want = mk.front_tables_hbm(pbvh.reorder_scene(scene, tree), tree)
    assert torch.equal(front.remap, want.remap) and torch.equal(front.ff, want.ff)
    c = profiling.counters()
    assert (c["front_refusals"], c["routes.front_hbm"], c["routes.bvh"]) == (1, 1, 0)
    profiling.reset_counters()
    img = render(scene, cam, settings=RenderSettings(device="cpu"))
    assert torch.isfinite(img).all()


def test_render_past_the_budget_under_inference_mode(monkeypatch):
    """Tensors made under torch.inference_mode keep no version counter:
    the route past the budget builds K8's node records (and the sphere
    table K8 reads) without caching them, and renders the frame that
    `render` gives outside it."""
    scene = pscene.make_random_scene(300, seed=5)
    cam = Camera(**dict(CAM, image_width=24, samples_per_pixel=2))
    monkeypatch.setattr(mk, "SMEM_BUDGET_BYTES", 8192)
    settings = RenderSettings(device="cpu")
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    want = render(scene, cam, gen(), settings)
    with torch.inference_mode():
        got = render(scene, cam, gen(), settings)
        small = pscene.make_random_scene(40, seed=2)
        tab = mk._sphere_major(small, torch.device("cpu"))
        assert torch.equal(tab, mk.scene_table(small).t())
    assert torch.equal(got, want)


def test_prepare_scene_falls_through_only_when_over_budget(monkeypatch):
    """Only `front_tables`' over-budget error changes the route: any other
    ValueError from it surfaces instead of silently building K7's tables."""
    scene = pscene.make_random_scene(60, seed=5)
    cam = Camera(**dict(CAM, image_width=16))
    assert issubclass(mk.FrontOverBudget, ValueError)

    def broken(*args, **kwargs):
        raise ValueError("malformed tree")

    monkeypatch.setattr(mk, "front_tables", broken)
    with pytest.raises(ValueError, match="malformed tree"):
        prepare_scene(scene, cam, RenderSettings(device="cpu"))


def test_render_pass_with_bvh_equals_brute_pass():
    """`render_pass(bvh=)` reaches the walk: from equal draws, the brute
    pass's image up to ties."""
    from raytracingproject_tpu_torch.render import render_pass

    _, _, rs, pb = _random_pair(300)
    cam = Camera(**dict(CAM, image_width=32))
    w, h = cam.image_size()
    kw = dict(width=w, height=h, max_depth=4, spp_chunk=1, seed=5)
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = render_pass(rs, cam.derive(torch.float32, "cpu"), gen(), bvh=pb, **kw)
    b = render_pass(rs, cam.derive(torch.float32, "cpu"), gen(), **kw)
    assert (a != b).any(dim=-1).double().mean().item() <= 1e-3


def test_brute_twin_past_the_whole_table_budget():
    """4,000 spheres, more than a whole 16-row table in shared memory can
    hold: the plain brute scan has no such limit and equals the walk."""
    ps = pscene.make_random_scene(4000, seed=3)
    assert 4 * mk.N_ROWS * ps.num_spheres > mk.SMEM_BUDGET_BYTES
    pb = pbvh.build_bvh(ps, leaf_size=8)
    rs = pbvh.reorder_scene(ps, pb)
    o, d, t = _torch_rays(dict(CAM, lookfrom=(13.0, 2.0, 3.0), vfov=20.0), 256, seed=2)
    brute = mk.trace_paths(o, d, t, rs, 9, 2)
    walk = mk.trace_paths(o, d, t, rs, 9, 2, bvh=pb)
    assert torch.isfinite(brute).all()
    assert (brute != walk).any(dim=1).double().mean().item() <= 1e-3


# ---- every kernel is bound, counted and driven ----

def test_every_entry_point_has_a_counter_and_a_chip_smoke_check():
    """Each tracing entry point of the megakernel library has its launch
    counter (the forward ones also one for their record_miss version, the
    segment ones one for each of their three kinds; the front entries
    also one for each of these with K3's options; the planted faults,
    forward only, none for record_miss), and chip_smoke.py names every
    counter (it holds each kernel against its plain version and reads
    each count after a main path)."""
    names = build.LIBRARIES["megakernel"]
    forward = {n.removeprefix("rtp_trace_") for n in names if n.startswith("rtp_trace_")}
    record = {n.removeprefix("rtp_") for n in names if n.startswith("rtp_record_")}
    segment = {f"segment_{kind}{n.removeprefix('rtp_segment_')}"
               for n in names if n.startswith("rtp_segment_")
               for kind in ("", "miss_", "record_")}
    assert len(segment) == 6  # K6 over the brute scan (chunked) and the front
    faults = {f"brute_chunked_{bug}" for bug in mk.INJECT_BUGS}
    assert faults <= forward
    with_miss = forward | {f"{k}_miss" for k in forward - faults}
    options = ({f"{k}_opts" for k in (forward | record | segment) if k.endswith("front")}
               | {f"{k}_opts_miss" for k in forward if k.endswith("front")})
    assert len(options) == 6
    assert with_miss | record | segment | options == set(mk.LAUNCHES)
    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    for key in mk.LAUNCHES:
        assert re.search(rf'"{key}"', smoke), key
    source = build.source("megakernel").read_text()
    for name in build.LIBRARIES["megakernel"]:
        assert re.search(rf"\b{name}\(", source), name
