"""K3's options (`front_tables(sub_block=, word_earlyout=)`) in the port's
plain versions against the JAX package (tables, and the interpret-mode
megakernel with the same options), and the float64 oracle `render`
(`RenderSettings.dtype`). The CUDA instantiations with the options are
held against plain K3 on the card (tests/test_torch_cuda.py,
chip_smoke.py).
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

import raytracingproject_tpu_torch as rt
from raytracingproject_tpu_torch import bridge
from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
from raytracingproject_tpu_torch.camera import rays_from_uniforms
from raytracingproject_tpu_torch.materials import draw_scatter
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
from raytracingproject_tpu_torch.render import ray_color
from raytracingproject_tpu_torch.scene import make_three_sphere_scene

ORDER = (8.0, 3.0, 8.0)  # tests/test_front_descend.py's camera position


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(n_spheres=300):
    """(JAX scene in leaf order, its FlatBVH, the port's scene and FlatBVH
    over the same arrays), as tests/test_front_descend.py builds them."""
    js = jscene.make_random_scene(n_spheres, seed=5)
    jb = jbuild_bvh(js, leaf_size=8)
    jr = jreorder(js, jb)
    ps = bridge.scene_from_arrays(*(np.array(x) for x in js))
    pb = build_bvh(ps, leaf_size=8)
    return jr, jb, reorder_scene(ps, pb), pb


@pytest.mark.parametrize("max_nodes", [24, 48, 72])
def test_front_tables_with_options_equal_jax(max_nodes):
    jr, jb, pr, pb = _pair()
    kw = dict(max_nodes=max_nodes, order_point=ORDER, sub_block=True, word_earlyout=True)
    jt = jfront_tables(jr, jb, **kw)
    pt = mk.front_tables(pr, pb, **kw)
    for f in ("sph", "ff", "fi", "wf", "sf", "remap", "bf"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(jt, f)),
                                      err_msg=f)
    assert (pt.ksub, pt.repack, pt.word_earlyout) == (jt.ksub, jt.repack, jt.word_earlyout)
    assert pt.ksub >= 1 and pt.bf.shape[1] == pt.sph.shape[1] // mk.UNROLL + pt.ksub


def _rays(n=1024, key=0):
    """tests/test_front_descend.py's rays (numpy)."""
    cam = JCamera(aspect_ratio=16.0 / 9.0, image_width=64, samples_per_pixel=1, max_depth=4,
                  vfov=40.0, lookfrom=ORDER, lookat=(0.0, 0.0, 0.0), defocus_angle=0.0,
                  focus_dist=1.0)
    idx = jax.random.randint(jax.random.PRNGKey(key), (n,), 0, 64 * 36)
    o, d, t = jgenerate_rays(cam.derive(), (idx % 64).astype(jnp.int32),
                             (idx // 64).astype(jnp.int32), jax.random.PRNGKey(key + 1))
    return np.array(o), np.array(d), np.array(t)


@pytest.mark.parametrize("options", [
    {"word_earlyout": True}, {"sub_block": True}, {"sub_block": True, "word_earlyout": True},
], ids=["word_earlyout", "sub_block", "both"])
def test_zero_draw_trace_with_options_matches(options):
    """Zero draws at depth 8 over a 48-subtree front (two words, subtrees
    of up to 16 spheres: ksub 2): the plain version with the options equals
    it without them exactly (both only cull), and JAX's
    pallas_trace_paths(interpret=True) with the same front within 1e-4 on
    >= 99% of rays, the bound test_zero_draw_depth8_matches_jax holds on
    a random scene seen from afar (the quadratic's cancellation)."""
    jr, jb, pr, pb = _pair()
    o, d, t = _rays(key=3)
    jf = jfront_tables(jr, jb, max_nodes=48, order_point=ORDER, **options)
    ref = np.asarray(pallas_trace_paths(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jr,
                                        jnp.int32(7), max_depth=8, interpret=True, front=jf))
    plain = mk.front_tables(pr, pb, max_nodes=48, order_point=ORDER)
    opts = mk.front_tables(pr, pb, max_nodes=48, order_point=ORDER, **options)
    assert opts.ksub == (2 if options.get("sub_block") else 0)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t), pr, 7, 8)
    got = mk.trace_paths(*args, front=opts, zero_draws=True)
    torch.testing.assert_close(got, mk.trace_paths(*args, front=plain, zero_draws=True),
                               rtol=0, atol=0)
    got = got.numpy()
    frac = np.all(np.abs(got - ref) <= 1e-4, axis=1).mean()
    print(f"{options}: {frac:.5f} of rays within 1e-4 of JAX")
    assert np.isfinite(got).all()
    assert frac >= 0.99, frac


def test_sub_block_twin_masks_groups():
    """The sub-block mask drops columns: on the cover scene from the cover
    camera a sub-block front keeps fewer (ray, column) pairs live than the
    subtree mask alone, and every winner of the plain scan stays live."""
    from raytracingproject_tpu_torch.scene import make_cover_scene

    s = make_cover_scene(0)
    b = build_bvh(s, leaf_size=8)
    r = reorder_scene(s, b)
    f = mk.front_tables(r, b, max_nodes=24, order_point=(13.0, 2.0, 3.0), sub_block=True)
    o, d, t = (torch.from_numpy(x) for x in _rays(512, key=5))
    ox, oy, oz, dx, dy, dz = o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]
    owner = f.column_subtree()
    sub = mk.subtree_slab_mask(f.ff, ox, oy, oz, dx, dy, dz)[:, owner]
    grp = mk.subtree_slab_mask(f.bf, ox, oy, oz, dx, dy, dz)[:, torch.arange(f.sph.shape[1])
                                                            // mk.UNROLL]
    assert (sub & grp).sum() < sub.sum()
    a = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20)
    _, win = mk.closest_hit_brute_twin(f.sph, ox, oy, oz, dx, dy, dz, t, a, 1.0 / a)
    hit = win >= 0
    assert (sub & grp)[hit.nonzero()[:, 0], win[hit]].all()


def test_inject_bug_is_checked():
    s = make_three_sphere_scene()
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    t = torch.zeros(4)
    with pytest.raises(ValueError, match="inject_bug"):
        mk.trace_paths(o, d, t, s, 1, 2, inject_bug="schlick4")
    out = mk.trace_paths(o, d, t, s, 1, 2, inject_bug="schlick3")
    assert out.shape == (4, 3) and torch.isfinite(out).all()


def test_float64_oracle_render():
    """`RenderSettings.dtype` reaches the oracle: a float64 render is
    float64 and equals the float64 `ray_color` of the same draws, taken
    from the same generator state (camera draws, then each bounce's)."""
    scene = make_three_sphere_scene()
    cam = rt.Camera(aspect_ratio=16 / 9, image_width=32, samples_per_pixel=2, max_depth=5,
                    vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0))
    settings = rt.RenderSettings(device="cpu", use_megakernel=False, use_bvh=False,
                                 dtype=torch.float64)
    img = rt.render(scene, cam, torch.Generator().manual_seed(4), settings)
    assert img.dtype == torch.float64

    w, h = cam.image_size()
    gen = torch.Generator().manual_seed(4)
    derived = cam.derive(torch.float64, "cpu")
    n = w * h * 2
    pix = torch.arange(h * w).repeat(2)
    u = (torch.rand((n, 2), generator=gen, dtype=torch.float64) - 0.5,
         *(torch.rand(n, generator=gen, dtype=torch.float64) for _ in range(3)))
    u = (u[0], u[1], u[2] * (2.0 * np.pi), u[3])
    o, d, t = rays_from_uniforms(derived, (pix % w).to(torch.int32), (pix // w).to(torch.int32),
                                 *u)
    assert o.dtype == torch.float64
    draws = [draw_scatter(gen, (n,), torch.float64) for _ in range(cam.max_depth)]
    rad = ray_color(scene, o, d, t, None, cam.max_depth, early_exit=False, draws=draws)
    want = rad.reshape(2, h, w, 3).sum(dim=0) / 2
    torch.testing.assert_close(img, want, rtol=1e-12, atol=1e-12)
    f32 = rt.render(scene, cam, torch.Generator().manual_seed(4),
                    rt.RenderSettings(device="cpu", use_megakernel=False, use_bvh=False))
    assert f32.dtype == torch.float32


def test_megakernel_render_is_float32_whatever_the_dtype():
    """The megakernel computes and returns float32 (as the JAX package's)."""
    cam = rt.Camera(aspect_ratio=16 / 9, image_width=16, samples_per_pixel=1, max_depth=3,
                    vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0))
    img = rt.render(make_three_sphere_scene(), cam, torch.Generator().manual_seed(1),
                    rt.RenderSettings(device="cpu", dtype=torch.float64))
    assert img.dtype == torch.float32
