"""The port's main path as a whole: render_pass against the same steps
composed from JAX functions, render() against JAX's render() in
distribution, the CLI, and the port's hygiene (no jax, no CPU fallback)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu import camera as jcamera, color as jcolor, scene as jscene
from raytracingproject_tpu.bvh import build_bvh as jbuild_bvh, reorder_scene as jreorder
from raytracingproject_tpu.ops.pallas.megakernel import front_tables as jfront_tables
from raytracingproject_tpu.ops.pallas.megakernel import pallas_trace_paths
from raytracingproject_tpu.render import _block_order as j_block_order, render as jrender
from raytracingproject_tpu.utils import ppm as jppm

from raytracingproject_tpu_torch import bridge, camera as pcamera, color as pcolor
from raytracingproject_tpu_torch import scene as pscene
from raytracingproject_tpu_torch.__main__ import main as cli_main
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.ops.cuda import megakernel as pmk
from raytracingproject_tpu_torch.render import render as prender, render_image, render_pass
from raytracingproject_tpu_torch.utils import ppm as pppm

ROOT = Path(__file__).resolve().parents[1]
THREE = dict(aspect_ratio=16.0 / 9.0, image_width=32, samples_per_pixel=2, max_depth=4,
             vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
             defocus_angle=0.0, focus_dist=1.0)


def test_render_pass_matches_jax_composition():
    """render_pass (front, zero draws, JAX's camera draws injected, 2 spp,
    32x18, depth 4) against render.py:289-347 composed from JAX functions
    with the interpret-mode megakernel: >= 99.9% of pixels within 1e-4,
    then equal to_u8 + PPM bytes."""
    w, h, spp, depth = 32, 18, 2, 4
    js = jscene.make_three_sphere_scene()
    jb = jbuild_bvh(js, leaf_size=2)
    rs = jreorder(js, jb)
    jf = jfront_tables(rs, jb)
    jcam = jcamera.Camera(**THREE)
    slot_pix, gather = j_block_order(w, h, spp, pmk.TILE)  # the port's feed order
    n = slot_pix.size
    i = jnp.asarray(slot_pix % w, jnp.int32)
    j = jnp.asarray(slot_pix // w, jnp.int32)
    k_ray, k_path = jax.random.split(jax.random.PRNGKey(0))
    o, d, t = jcamera.generate_rays(jcam.derive(), i, j, k_ray)
    seed = jax.random.randint(k_path, (), 0, 2**31 - 1, dtype=jnp.int32)
    rad = pallas_trace_paths(o, d, t, rs, seed, depth, front=jf, interpret=True)
    jimg = np.asarray(rad[jnp.asarray(gather)].sum(axis=0).reshape(h, w, 3))

    # the same draws, replayed from generate_rays (camera.py:118-144)
    k_px, k_disk, k_time = jax.random.split(k_ray, 3)
    k1, k2 = jax.random.split(k_disk)
    T = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    uniforms = (
        T(jax.random.uniform(k_px, (n, 2), minval=-0.5, maxval=0.5)),
        T(jax.random.uniform(k1, (n,))),
        T(jax.random.uniform(k2, (n,), minval=0.0, maxval=2.0 * jnp.pi)),
        T(jax.random.uniform(k_time, (n,))),
    )
    ps = bridge.scene_from_arrays(*(np.asarray(x) for x in rs))
    pf = bridge.front_from_arrays(jf.sph, jf.ff, jf.fi, jf.wf, jf.sf, jf.remap, jf.repack)
    pimg = render_pass(ps, pcamera.Camera(**THREE).derive(), None, width=w, height=h,
                       max_depth=depth, spp_chunk=spp, front=pf, seed=int(seed),
                       ray_uniforms=uniforms, zero_draws=True).numpy()
    assert pimg.shape == (h, w, 3) and np.isfinite(pimg).all()
    close = np.all(np.abs(pimg - jimg) <= 1e-4, axis=-1).mean()
    print(f"{close:.5f} of pixels within 1e-4")
    assert close >= 0.999
    ju8 = np.asarray(jcolor.to_u8(jnp.asarray(jimg / spp)))
    pu8 = pcolor.to_u8(torch.from_numpy(pimg / spp)).numpy()
    assert pppm.encode_ppm(pu8) == jppm.encode_ppm(ju8)


def test_render_statistics_match_jax_render():
    """The port's render() (front-culled megakernel, Philox draws, plain
    version on the CPU) against JAX's default render() (XLA path, jax.random)
    on the three-sphere scene, 48x27, 32 spp, depth 8. Different random
    streams, same distributions: the per-pixel difference has zero mean, so
    each channel's mean difference, over the whole image and over each
    material region (primary hit at the pixel centre), is within 5 standard
    errors."""
    kw = dict(THREE, image_width=48, samples_per_pixel=32, max_depth=8)
    jimg = np.asarray(jrender(jscene.make_three_sphere_scene(), jcamera.Camera(**kw),
                              jax.random.PRNGKey(1)))
    pimg = prender(pscene.make_three_sphere_scene(), pcamera.Camera(**kw),
                   torch.Generator().manual_seed(1), RenderSettings(device="cpu")).numpy()
    assert pimg.shape == jimg.shape == (27, 48, 3) and np.isfinite(pimg).all()

    # regions: the sphere hit by each pixel-centre ray (-1 = sky)
    cam = pcamera.Camera(**kw)
    jj, ii = torch.meshgrid(torch.arange(27), torch.arange(48), indexing="ij")
    n = 27 * 48
    zero = torch.zeros(n)
    o, dd, t = pcamera.rays_from_uniforms(cam.derive(), ii.reshape(-1), jj.reshape(-1),
                                          torch.zeros(n, 2), zero, zero, zero)
    a = torch.clamp_min((dd * dd).sum(1), 1e-20)
    _, win = pmk.closest_hit_brute_twin(pmk.scene_table(pscene.make_three_sphere_scene()),
                                        *o.unbind(1), *dd.unbind(1), t, a, 1.0 / a)
    region = win.reshape(27, 48).numpy()

    diff = (pimg - jimg).reshape(-1, 3)
    groups = {"image": np.ones(n, bool)}
    groups.update({f"region {r}": region.reshape(-1) == r for r in np.unique(region)})
    for name, sel in groups.items():
        if sel.sum() < 40:
            continue
        dsel = diff[sel]
        se = dsel.std(axis=0, ddof=1) / np.sqrt(sel.sum()) + 1e-6
        z = np.abs(dsel.mean(axis=0)) / se
        print(name, int(sel.sum()), z)
        assert (z < 5.0).all(), (name, z)


def test_render_chunks_and_remainder():
    """Sample chunks accumulate in slot space; a remainder chunk goes
    through the image path. Both give a finite mean image."""
    cam = pcamera.Camera(**dict(THREE, samples_per_pixel=5))
    s = RenderSettings(device="cpu", rays_per_batch=32 * 18 * 2)
    img = prender(pscene.make_three_sphere_scene(), cam, torch.Generator().manual_seed(0), s)
    assert img.shape == (18, 32, 3) and torch.isfinite(img).all()
    u8 = render_image(pscene.make_three_sphere_scene(), cam, torch.Generator().manual_seed(0), s)
    assert torch.equal(u8, pcolor.to_u8(img))


def test_brute_and_front_renders_agree():
    """use_bvh=False (brute K2) and the default front (K3) render the same
    image from the same generator, up to closest-hit ties."""
    cam = pcamera.Camera(aspect_ratio=16.0 / 9.0, image_width=32, samples_per_pixel=2,
                         max_depth=6, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
                         lookat=(0.0, 0.0, 0.0), defocus_angle=0.6, focus_dist=10.0)
    scene = pscene.make_cover_scene(0)
    a = prender(scene, cam, torch.Generator().manual_seed(2), RenderSettings(device="cpu"))
    b = prender(scene, cam, torch.Generator().manual_seed(2),
                RenderSettings(device="cpu", use_bvh=False))
    assert (torch.abs(a - b) > 1e-5).any(dim=-1).double().mean().item() <= 0.01


def test_cli_writes_the_render(tmp_path, capsys):
    out = tmp_path / "three.ppm"
    assert cli_main(["--scene", "three", "--width", "32", "--spp", "2", "--depth", "3",
                     "--device", "cpu", "-o", str(out)]) == 0
    img = pppm.read_ppm(out)
    assert img.shape == (18, 32, 3)
    cam = pcamera.Camera(**dict(THREE, max_depth=3))
    want = render_image(pscene.make_three_sphere_scene(), cam, torch.Generator().manual_seed(0),
                        RenderSettings(device="cpu"))
    np.testing.assert_array_equal(img, want.numpy())
    assert "on cpu" in capsys.readouterr().err


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import raytracingproject_tpu_torch as rt\n"
        "from raytracingproject_tpu_torch import bridge, __main__, grad\n"
        "from raytracingproject_tpu_torch.grad import edge, fast, inverse, replay\n"
        "from raytracingproject_tpu_torch import parallel, session, wavefront\n"
        "from raytracingproject_tpu_torch.parallel import launch, mesh, shard\n"
        "from raytracingproject_tpu_torch.utils import cache, checkpoint, profiling\n"
        "from raytracingproject_tpu_torch.scene import make_three_sphere_scene\n"
        "cam = rt.Camera(aspect_ratio=2.0, image_width=16, samples_per_pixel=1, max_depth=2,"
        " lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0), focus_dist=1.0)\n"
        "img = rt.render_image(make_three_sphere_scene(), cam,"
        " settings=rt.RenderSettings(device='cpu'))\n"
        "assert img.shape == (8, 16, 3)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'raytracingproject_tpu']\n"
        "print('LOADED', bad)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout
    for src in (ROOT / "raytracingproject_tpu_torch").rglob("*.py"):
        text = src.read_text()
        assert "import jax" not in text and "from jax" not in text, src
        assert "from raytracingproject_tpu." not in text and \
            "import raytracingproject_tpu\n" not in text, src


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the CPU-only behaviour")
    cam = pcamera.Camera(**THREE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prender(pscene.make_three_sphere_scene(), cam, settings=RenderSettings(device="cuda"))
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        pmk.trace_paths(o, o, torch.zeros(4, device="meta"), None, 0, 1)


def test_resolve_device_defaults_to_the_card(monkeypatch, tmp_path):
    """No device asked for means the card: `resolve_device(None)`,
    `RenderSettings().resolved_device()`, `render` and the CLI's --device
    default raise without one, naming device="cpu" (the CPU runs only when
    asked for); with a card, None is "cuda"."""
    from raytracingproject_tpu_torch.config import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = pcamera.Camera(**THREE)
    for fn in (lambda: resolve_device(None), lambda: RenderSettings().resolved_device(),
               lambda: prender(pscene.make_three_sphere_scene(), cam),
               lambda: cli_main(["--scene", "three", "--width", "16", "--spp", "1", "--depth",
                                 "1", "-o", str(tmp_path / "x.ppm")])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_unported_options_raise(monkeypatch):
    """What the port does not run raises, naming the route that does:
    segmented tracing over the global-memory front (K6 takes no
    FrontTablesHBM, nor does the JAX segment call) and use_pallas on the
    megakernel. (The CLI's wavefront renderer, refused here until it was
    ported, runs: tests/test_torch_wavefront.py.)"""
    cam = pcamera.Camera(**THREE)
    scene = pscene.make_three_sphere_scene()
    with monkeypatch.context() as m:
        # every front passes shared memory and the walk refuses every tree: K7
        m.setattr(pmk, "SMEM_BUDGET_BYTES", 0)
        m.setattr(pmk, "BVH_STACK", -1)
        with pytest.raises(ValueError, match="FrontTablesHBM"):
            prender(scene, cam, settings=RenderSettings(device="cpu", depth_segment=2))
    # use_pallas is the oracle loop's closest hit: with the megakernel it is refused
    with pytest.raises(ValueError, match="use_megakernel=False"):
        prender(scene, cam, settings=RenderSettings(device="cpu", use_pallas=True))


@pytest.mark.parametrize("kw", [{}, {"use_pallas": True}, {"use_bvh": False},
                                {"use_pallas": True, "use_bvh": False}],
                         ids=["bvh", "pallas+bvh", "brute", "pallas"])
def test_oracle_options_render(kw):
    """use_megakernel=False and use_pallas render (they raised until the
    oracle was ported): finite, of the image's shape, and the three
    closest hits give the same image from the same generator seed (they
    consume equal draws; ties aside)."""
    cam = pcamera.Camera(**THREE)
    scene = pscene.make_three_sphere_scene()
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    img = prender(scene, cam, gen(), RenderSettings(device="cpu", use_megakernel=False, **kw))
    ref = prender(scene, cam, gen(),
                  RenderSettings(device="cpu", use_megakernel=False, use_bvh=False))
    assert img.shape == (18, 32, 3) and torch.isfinite(img).all()
    assert (torch.abs(img - ref) <= 1e-5).all(dim=-1).double().mean().item() >= 0.999


def test_oracle_sky_texture_renders():
    """A constant sky texture on an all-miss render gives that constant
    (tests/test_sky_texture.py), on the oracle loop and on the megakernel
    (K1's record_miss, the texture looked up after the kernel)."""
    scene = pscene.make_minimal_scene()
    scene = dataclasses.replace(scene, center0=scene.center0 + 1e7)  # park the spheres away
    cam = pcamera.Camera(aspect_ratio=1.0, image_width=16, samples_per_pixel=2, max_depth=3,
                         vfov=60.0)
    for use_megakernel in (False, True):
        img = prender(scene, cam, settings=RenderSettings(device="cpu",
                                                          use_megakernel=use_megakernel),
                      sky_texture=np.full((4, 8, 3), 0.25, np.float32))
        np.testing.assert_allclose(img.numpy(), 0.25, atol=1e-5)
