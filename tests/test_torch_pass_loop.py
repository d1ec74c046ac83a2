"""The pass loop's block order on the device (render.py: `_slot_ij`,
`_slot_gather`): a render that finds it cached gives the same image, bit
for bit, as one that uploads it; `_slot_rays` gives the rays of the
uncached computation; each shape and device is one entry. The card case
checks that a warm render copies nothing from the host inside its passes.
Imports nothing of the JAX package."""

import numpy as np
import pytest
import torch

import raytracingproject_tpu_torch as rt
from raytracingproject_tpu_torch.camera import camera_uniforms, rays_from_uniforms
from raytracingproject_tpu_torch.ops.cuda.megakernel import TILE
from raytracingproject_tpu_torch.render import (
    _block_order, _device_key, _slot_gather, _slot_ij, _slot_rays,
)

CAM = dict(aspect_ratio=16 / 9, samples_per_pixel=4, max_depth=3, vfov=20.0,
           lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0), defocus_angle=0.6,
           focus_dist=10.0)


def cold_block_order():
    _slot_ij.cache_clear()
    _slot_gather.cache_clear()


def cover_render(settings, width):
    """A render of the cover scene, from one generator seed every call."""
    camera = rt.Camera(image_width=width, **CAM)
    dev = settings.resolved_device()
    scene = rt.make_cover_scene(0)
    return lambda: rt.render(scene, camera, torch.Generator(device=dev).manual_seed(7), settings)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spp_chunk", [1, 2])
def test_warm_render_is_bit_equal_to_cold(spp_chunk):
    """32 x 18 pixels, 4 spp: the cold render uploads the block order, the
    warm one reuses it, and both give the same image."""
    settings = rt.RenderSettings(device="cpu", rays_per_batch=32 * 18 * spp_chunk)
    render = cover_render(settings, 32)
    cold_block_order()
    cold, warm = render(), render()
    assert torch.isfinite(cold).all() and torch.equal(cold, warm)


def uncached_slot_rays(cam, width, height, spp_chunk, generator):
    """`_slot_rays` as it was before the block order lived on the device:
    the slot order from the host, its columns and rows taken on each call."""
    slot_pix, _ = _block_order(width, height, spp_chunk, TILE)
    pix = torch.from_numpy(slot_pix).to(torch.int64)
    i, j = (pix % width).to(torch.int32), (pix // width).to(torch.int32)
    u = camera_uniforms(pix.shape[0], generator, "cpu", cam.pixel00_loc.dtype)
    return rays_from_uniforms(cam, i, j, *u)


@pytest.mark.parametrize("width", [32, 45])
@pytest.mark.parametrize("spp_chunk", [1, 4])
def test_slot_rays_equal_the_uncached_rays(width, spp_chunk):
    camera = rt.Camera(image_width=width, **CAM)
    height = camera.image_size()[1]
    cam = camera.derive(torch.float32, torch.device("cpu"))
    cold_block_order()
    want = uncached_slot_rays(cam, width, height, spp_chunk, torch.Generator().manual_seed(3))
    for _ in range(2):  # the miss, then the hit
        got = _slot_rays(cam, width, height, spp_chunk, torch.Generator().manual_seed(3), None)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_block_order_entries_are_keyed_by_shape_and_device():
    """A repeated key returns the same tensors; another width, height or
    spp another entry; the gather is the host's, as int64."""
    cpu = _device_key("cpu")
    cold_block_order()
    i, j = _slot_ij(32, 18, 4, TILE, cpu)
    assert _slot_ij(32, 18, 4, TILE, cpu)[0] is i and _slot_ij(32, 18, 4, TILE, cpu)[1] is j
    g = _slot_gather(32, 18, 4, TILE, cpu)
    assert _slot_gather(32, 18, 4, TILE, cpu) is g
    for key in [(33, 18, 4), (32, 19, 4), (32, 18, 1)]:
        assert _slot_ij(*key, TILE, cpu)[0] is not i
        assert _slot_gather(*key, TILE, cpu) is not g
    assert _slot_ij.cache_info().currsize == 4 and _slot_gather.cache_info().currsize == 4
    slot_pix, gather = _block_order(32, 18, 4, TILE)
    assert i.dtype == j.dtype == torch.int32 and g.dtype == torch.int64
    assert np.array_equal(i.numpy(), slot_pix % 32) and np.array_equal(j.numpy(), slot_pix // 32)
    assert np.array_equal(g.numpy(), gather)


@pytest.mark.cuda
def test_warm_render_copies_nothing_from_the_host_on_the_card():
    """400 x 225 in 4 passes on the card: `cuda` and `cuda:0` are one key;
    a warm render has no host-to-device copy between its first pass's start
    and its last pass's end, and its image is the cold render's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    assert _device_key("cuda") == _device_key("cuda:0")
    settings = rt.RenderSettings(device="cuda")
    render = cover_render(settings, 400)
    cold_block_order()
    cold = render()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        warm = render()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    passes = [e.time_range for e in prof.events() if e.name == "rtp.pass"]
    start, end = min(r.start for r in passes), max(r.end for r in passes)
    copies = [e.name for e in prof.events() if e.device_type == cuda
              and "Memcpy HtoD" in e.name and e.time_range.end > start
              and e.time_range.start < end]
    assert len(passes) == 4 and any(e.device_type == cuda and "trace_kernel" in e.name
                                     for e in prof.events())
    assert not copies
    assert torch.equal(cold, warm)
