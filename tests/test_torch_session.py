"""The port's session (raytracingproject_tpu_torch/session.py): the
contracts of tests/test_session.py case for case (bring-up, the
interactive loop, the error model of LOG_AND_THROW, textures, resize,
validation, the orbiting camera), on the CPU with device="cpu", the
session's frame against the JAX package's, the RenderSettings defaults
the port keeps, and on the card the frames in flight through K3.

The JAX package is imported inside the tests that compare with it, so
the card's case runs where there is no jax:

    RTP_BACKEND=cuda python -m pytest tests/test_torch_session.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
from raytracingproject_tpu_torch.session import (
    SPHERE_CAPACITY, RendererSession, SessionError, Sphere, orbit_camera,
)

SMALL_CAM = dict(aspect_ratio=32 / 24, image_width=32, samples_per_pixel=2, max_depth=3,
                 vfov=60.0, lookfrom=(0.0, 0.0, 4.0), lookat=(0.0, 0.0, 0.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread for this module: its shapes are too small to
    split, and it keeps the workers of a parallel test run from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def small_session(device="cpu", **settings):
    return RendererSession(RenderSettings(width=32, height=24, device=device, **settings),
                           camera=Camera(**SMALL_CAM))


def test_smoke_loop():
    """Full bring-up and interactive loop (vulkan_tests.cpp:15-31)."""
    s = small_session()
    s.init()
    s.load_preconfigured_shapes()
    s.add_spheres([Sphere(center=(0.0, -100.5, 0.0), radius=100.0, color=(0.5, 0.5, 0.5, 1.0))])
    frames = s.start_interactive_loop(duration_ms=30000, max_frames=3)
    assert frames == 3
    assert s.last_frame is not None
    assert s.last_frame.shape == (24, 32, 3)
    assert np.isfinite(s.last_frame).all()


def test_draw_before_init_raises():
    s = small_session()
    with pytest.raises(SessionError, match="init"):
        s.draw_frame()


def test_empty_scene_raises():
    s = small_session()
    s.init()
    with pytest.raises(SessionError, match="spheres"):
        s.draw_frame()


def test_sphere_capacity_enforced():
    """DataBuffer<Sphere,200> (src/vulkan/graphical_environment_vulkan.h:141)."""
    s = small_session()
    s.init()
    s.add_spheres([Sphere(center=(0, 0, -2), radius=0.5)] * SPHERE_CAPACITY)
    with pytest.raises(SessionError, match="overflow"):
        s.add_spheres([Sphere(center=(0, 0, -2), radius=0.5)])


def test_spheres_added_after_init_render():
    """Late-added spheres render (unlike the reference, whose append after
    init never re-uploads, src/vulkan/data_buffer.h:47-52)."""
    s = small_session()
    s.init()
    s.add_spheres([Sphere(center=(0.0, 0.0, 0.0), radius=1.5, color=(1.0, 0.1, 0.1, 1.0))])
    s.draw_frame()
    a = s.flush()
    h, w, _ = a.shape
    center = a[h // 2, w // 2]
    assert center[0] > center[2], center


def test_missing_texture_raises():
    s = small_session()
    with pytest.raises(SessionError, match="texture"):
        s.add_texture("/nonexistent/statue.jpg")


def test_texture_ppm_load_and_render(tmp_path):
    """A PPM texture loads bit for bit and becomes the sky of later frames
    (a frame with it differs from one without)."""
    from raytracingproject_tpu_torch.utils.ppm import write_ppm

    img = np.random.default_rng(0).integers(0, 255, (8, 8, 3), dtype=np.uint8)
    p = tmp_path / "t.ppm"
    write_ppm(img, p)
    s = small_session()
    s.add_texture(str(p))
    np.testing.assert_array_equal(s._texture, img)
    s.init()
    s.load_preconfigured_shapes()
    s.draw_frame()
    with_sky = s.flush().copy()
    s._texture = None
    s._frame_index = 0
    s.draw_frame()
    assert np.abs(s.flush() - with_sky).mean() > 1e-3


def test_settings_defaults_match_reference():
    """GraphicalEnvironmentSettings defaults (src/common_objects.h:9-15)."""
    st = RenderSettings()
    assert st.max_frames_in_flight == 2
    assert st.max_images == 2
    assert st.width == 1024
    assert st.height == 768
    assert st.sphere_count == 20


def test_render_settings_defaults_keep_the_megakernel():
    """The port's one deliberate deviation from the JAX package's defaults
    (ROADMAP Queue 3, resolved): use_megakernel and use_bvh default to True
    (the megakernel with the front-culled K3) where the JAX package has
    False and False (the oracle brute scan). The port's callers rely on it;
    a JAX-default render passes both False. Every other shared field keeps
    the JAX default."""
    from raytracingproject_tpu.config import RenderSettings as JRenderSettings

    port, ref = RenderSettings(), JRenderSettings()
    assert (ref.use_megakernel, ref.use_bvh) == (False, False)
    assert (port.use_megakernel, port.use_bvh) == (True, True)
    shared = {f.name for f in dataclasses.fields(ref)} & {f.name for f in dataclasses.fields(port)}
    for name in shared - {"use_megakernel", "use_bvh", "dtype"}:
        assert getattr(port, name) == getattr(ref, name), name


def test_device_info_dump():
    s = small_session()
    s.init()
    assert "cpu" in s.dump_device_info()


def test_resize_recreates_and_renders():
    """Swapchain recreation (graphical_environment_vulkan.cpp:404-414)."""
    s = small_session()
    s.init()
    s.load_preconfigured_shapes()
    s.draw_frame()
    s.flush()
    assert s.last_frame.shape == (24, 32, 3)
    s.resize(48, 24)
    s.draw_frame()
    s.flush()
    assert s.last_frame.shape == (24, 48, 3)


def test_resize_invalid_extent_raises():
    s = small_session()
    with pytest.raises(SessionError, match="extent"):
        s.resize(0, 10)


@pytest.mark.parametrize("validate", [True, False])
def test_enable_validation_catches_nan(validate):
    """With validation a frame holding NaN (a camera at NaN makes every ray
    NaN) raises FloatingPointError when it is finished, the exception the
    JAX package's jax_debug_nans raises; without it the frame is kept."""
    s = RendererSession(RenderSettings(width=32, height=24, device="cpu", use_megakernel=False,
                                       use_bvh=False),
                        camera=Camera(**dict(SMALL_CAM, lookfrom=(float("nan"), 0.0, 4.0))))
    if validate:
        s.enable_validation()
    s.init()
    s.load_preconfigured_shapes()
    s.draw_frame()
    if validate:
        with pytest.raises(FloatingPointError, match="non-finite"):
            s.flush()
    else:
        assert np.isnan(s.flush()).any()


def test_orbit_camera_geometry():
    """Rodrigues orbit: distance to lookat and vup height kept; 360 degrees
    returns to the start (src/vulkan/graphical_environment_vulkan.cpp:374-391)."""
    cam = Camera(lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 1.0, 0.0))
    for ang in (0.0, 37.0, 90.0, 360.0):
        c2 = orbit_camera(cam, ang)
        rel0 = np.subtract(cam.lookfrom, cam.lookat)
        rel = np.subtract(c2.lookfrom, c2.lookat)
        assert np.linalg.norm(rel) == pytest.approx(np.linalg.norm(rel0), rel=1e-12)
        assert np.dot(rel, cam.vup) == pytest.approx(np.dot(rel0, cam.vup), abs=1e-9)
    np.testing.assert_allclose(orbit_camera(cam, 360.0).lookfrom, cam.lookfrom, atol=1e-9)


def test_orbit_camera_matches_jax():
    """The same orbit as the JAX package's orbit_camera (float64 host math)."""
    from raytracingproject_tpu.camera import Camera as JCamera
    from raytracingproject_tpu.session import orbit_camera as jorbit

    for ang in (0.0, 37.0, 212.5):
        got = orbit_camera(Camera(lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 1.0, 0.0)), ang)
        want = jorbit(JCamera(lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 1.0, 0.0)), ang)
        np.testing.assert_array_equal(got.lookfrom, want.lookfrom)


def test_animated_frames_differ():
    """With animate_deg_per_s the camera orbits between frames."""
    s = RendererSession(RenderSettings(width=32, height=24, max_frames_in_flight=1,
                                       device="cpu"),
                        camera=Camera(**SMALL_CAM), animate_deg_per_s=5000.0)
    s.init()
    s.load_preconfigured_shapes()
    s.draw_frame()
    f1 = np.array(s.flush(), np.float64)
    s.draw_frame()
    f2 = np.array(s.flush(), np.float64)
    assert np.abs(f1 - f2).mean() > 1e-3
    assert np.isfinite(f2).all()


def test_session_frame_matches_the_jax_session():
    """The session's frame against the JAX session's on the same scene and
    camera, both on the JAX package's default path (the oracle brute scan,
    passed explicitly to the port): 64 spp, so the images agree within
    Monte Carlo noise (means within 2%, pixels within 0.1 on average)."""
    from raytracingproject_tpu.camera import Camera as JCamera
    from raytracingproject_tpu.config import RenderSettings as JRenderSettings
    from raytracingproject_tpu.session import RendererSession as JRendererSession

    cam = dict(SMALL_CAM, samples_per_pixel=64)
    s = RendererSession(RenderSettings(width=32, height=24, device="cpu", use_megakernel=False,
                                       use_bvh=False), camera=Camera(**cam))
    js = JRendererSession(JRenderSettings(width=32, height=24), camera=JCamera(**cam))
    for sess in (s, js):
        sess.init()
        sess.load_preconfigured_shapes()
        sess.draw_frame()
    got, want = s.flush(), np.asarray(js.flush())
    print(f"means: port {got.mean():.5f}, jax {want.mean():.5f}")
    assert abs(got.mean() - want.mean()) < 0.02 * want.mean()
    assert np.abs(got - want).mean() < 0.1


def test_init_without_a_card_raises_a_session_error():
    """With no device asked for, the session renders on the card; without
    one, init raises (naming device="cpu") instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the CPU-only behaviour")
    s = RendererSession(RenderSettings(width=32, height=24), camera=Camera(**SMALL_CAM))
    with pytest.raises(SessionError, match='device="cpu"'):
        s.init()


@pytest.mark.cuda
def test_frames_in_flight_on_the_card(cuda_device):
    """On the card with the default settings: each frame is queued behind a
    CUDA event, at most max_frames_in_flight stay queued, every frame goes
    through K3 (the front kernel), and the device info names the card."""
    s = RendererSession(RenderSettings(width=64, height=48), camera=Camera(
        **dict(SMALL_CAM, aspect_ratio=64 / 48, image_width=64)))
    s.init()
    s.load_preconfigured_shapes()
    mk.reset_launches()
    for _ in range(4):
        s.draw_frame()
        assert len(s._inflight) <= s.settings.max_frames_in_flight
        assert all(ev is not None for _, ev in s._inflight)
    assert s.flush().shape == (48, 64, 3) and np.isfinite(s.last_frame).all()
    assert mk.LAUNCHES["front"] > 0
    assert "cuda:0" in s.dump_device_info()
