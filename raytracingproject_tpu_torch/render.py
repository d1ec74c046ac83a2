"""The megakernel renderer (counterpart of raytracingproject_tpu/render.py,
its megakernel branch).

render -> render_pass -> ops.cuda.megakernel.trace_paths: rays are fed in
compact screen blocks (`_block_order`), traced by the megakernel (K1 with
the front-culled K3, or the brute K2 without the BVH), accumulated in slot
space over sample chunks and unpermuted once per frame (`blocks_to_image`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from raytracingproject_tpu_torch.camera import (
    Camera, CameraDerived, camera_uniforms, rays_from_uniforms,
)
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.ops.cuda.megakernel import TILE, trace_paths
from raytracingproject_tpu_torch.ops.vecmath import normalize
from raytracingproject_tpu_torch.scene import Scene

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)


def sky_color(direction: torch.Tensor, sky_tex=None) -> torch.Tensor:
    """Background radiance of a miss ray: the reference's gradient
    (src/camera_cpu.h:23-25), lerp(white, (0.5, 0.7, 1.0)) by
    0.5 * (unit_dir.y + 1)."""
    if sky_tex is not None:
        raise _not_ported("sky textures (record_miss)", "K1 record_miss")
    unit = normalize(direction, eps=1e-12)
    a = 0.5 * (unit[..., 1] + 1.0)
    white = torch.tensor(SKY_WHITE, dtype=direction.dtype, device=direction.device)
    blue = torch.tensor(SKY_BLUE, dtype=direction.dtype, device=direction.device)
    return (1.0 - a)[..., None] * white + a[..., None] * blue


@lru_cache(maxsize=None)
def _block_order(width: int, height: int, spp: int = 1, tile: int = TILE):
    """(slot_pix, gather): the ray feed order, in compact screen blocks.

    Rays go block by block, all `spp` samples of one b x b pixel block in a
    row, with b chosen so a block's rays fill about one `tile` of rays: the
    rays a kernel block (and each of its warps) traces stay close on screen,
    so front culling skips more subtrees. `slot_pix[r]` is the row-major
    pixel of ray slot r (padded to a `tile` multiple with pixel 0);
    `gather[s, p]` is the slot of (sample s, pixel p)."""
    b = 32
    while b > 8 and b * b * spp > tile:
        b //= 2
    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    slots = []
    gather = np.empty((spp, width * height), np.int64)
    pos = 0
    for by in range(0, height, b):
        for bx in range(0, width, b):
            blk = idx[by : by + b, bx : bx + b].reshape(-1)
            for s in range(spp):
                gather[s, blk] = pos + np.arange(blk.size)
                slots.append(blk)
                pos += blk.size
    slot_pix = np.concatenate(slots)
    pad = (-slot_pix.size) % tile
    if pad:
        slot_pix = np.concatenate([slot_pix, np.zeros(pad, np.int64)])
    return slot_pix.astype(np.int32), gather.astype(np.int32)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to the PyTorch package yet "
                               f"(ROADMAP {item})")


def _slot_rays(cam: CameraDerived, width: int, height: int, spp_chunk: int,
               generator: torch.Generator | None, ray_uniforms):
    """Camera rays of every slot in `_block_order`."""
    dev = cam.pixel00_loc.device
    slot_pix, _ = _block_order(width, height, spp_chunk, TILE)
    pix = torch.from_numpy(slot_pix).to(dev, torch.int64)
    i = (pix % width).to(torch.int32)
    j = (pix // width).to(torch.int32)
    if ray_uniforms is None:
        ray_uniforms = camera_uniforms(pix.shape[0], generator, dev, cam.pixel00_loc.dtype)
    return rays_from_uniforms(cam, i, j, *ray_uniforms)


def render_pass(
    scene: Scene,
    cam: CameraDerived,
    generator: torch.Generator | None,
    *,
    width: int,
    height: int,
    max_depth: int,
    spp_chunk: int = 1,
    bvh=None,
    front=None,
    use_pallas: bool = False,
    use_megakernel: bool = True,
    depth_segment: int = 0,
    two_phase: int = 0,
    sky_tex=None,
    raw_slots: bool = False,
    seed: int | None = None,
    ray_uniforms=None,
    zero_draws: bool = False,
    tracer=trace_paths,
) -> torch.Tensor:
    """`spp_chunk` samples of every pixel: the radiance sum [H, W, 3] over
    the chunk, or with `raw_slots` the slot-space radiance [R_pad, 3].

    The camera draws come from `generator`, then the path seed
    (randint in [0, 2^31 - 1)). `seed` and `ray_uniforms` (the draws of
    `camera.rays_from_uniforms`, one per slot) replace them; tests use
    them to feed both packages the same numbers. `tracer` is the function
    that traces the rays (the megakernel wrapper; a check may pass the plain
    version to hold the kernel against it)."""
    if not use_megakernel:
        raise _not_ported("the XLA-style renderer (use_megakernel=False)", "P2")
    if use_pallas:
        raise _not_ported("the fused closest-hit kernel (use_pallas)", "K4")
    if bvh is not None:
        raise _not_ported("the BVH-walking megakernel", "K8")
    if sky_tex is not None:
        raise _not_ported("sky textures (record_miss)", "K1 record_miss")
    if depth_segment or two_phase:
        raise _not_ported("segmented and two-phase tracing", "P8/K6")
    origin, direction, time = _slot_rays(cam, width, height, spp_chunk, generator,
                                         ray_uniforms)
    if seed is None:
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=generator.device))
    rad = tracer(origin, direction, time, scene, seed, max_depth, front=front,
                 zero_draws=zero_draws)
    if raw_slots:
        return rad
    return blocks_to_image(rad, width, height, spp_chunk)


def blocks_to_image(slot_rad: torch.Tensor, width: int, height: int,
                    spp_chunk: int) -> torch.Tensor:
    """Slot-space radiance sum [R_pad, 3] -> row-major image sum [H, W, 3]."""
    _, gather = _block_order(width, height, spp_chunk, TILE)
    g = torch.from_numpy(gather).to(slot_rad.device, torch.int64)
    return slot_rad[g].sum(dim=0).reshape(height, width, 3)


def prepare_scene(scene: Scene, camera: Camera, settings: RenderSettings):
    """(scene, front): the scene on the render device, in BVH leaf order
    with its front tables when `use_bvh` is on; else as given, front None."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.ops.cuda.megakernel import front_tables

    device = settings.resolved_device()
    scene = scene.to(device)
    if not settings.use_bvh:
        return scene, None
    leaf = max(settings.bvh_leaf_size, 8)  # front subtrees amortise culling
    bvh = build_bvh(scene, leaf_size=leaf)
    scene = reorder_scene(scene, bvh)
    op = tuple(float(x) for x in camera.lookfrom)
    rp = 2 if camera.max_depth <= 24 else 1
    try:
        front = front_tables(scene, bvh, order_point=op, repack=rp)
    except ValueError as e:
        raise _not_ported("the global-memory front for scenes past the shared-memory "
                          "budget", "K7") from e
    return scene, front


def render(
    scene: Scene,
    camera: Camera,
    generator: torch.Generator | None = None,
    settings: RenderSettings | None = None,
    sky_texture=None,
    tracer=trace_paths,
) -> torch.Tensor:
    """Full render: mean radiance image [H, W, 3] in linear space, on
    `settings.device` (src/camera.h:32-50 minus the PPM output).

    `generator` (default: seeded with 0 on the render device) draws every
    random number of the render."""
    settings = settings or RenderSettings()
    if sky_texture is not None:
        raise _not_ported("sky textures (record_miss)", "K1 record_miss")
    device = settings.resolved_device()
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    width, height = camera.image_size()
    cam = camera.derive(torch.float32, device)
    spp = camera.samples_per_pixel
    scene, front = prepare_scene(scene, camera, settings)

    spp_chunk = max(1, min(spp, settings.rays_per_batch // max(width * height, 1)))
    acc = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    slot_acc = None
    done = 0
    while done < spp:
        chunk = min(spp_chunk, spp - done)
        raw = chunk == spp_chunk
        out = render_pass(
            scene, cam, generator, width=width, height=height,
            max_depth=camera.max_depth, spp_chunk=chunk, front=front,
            use_pallas=settings.use_pallas, use_megakernel=settings.use_megakernel,
            depth_segment=settings.depth_segment or 0, two_phase=settings.two_phase or 0,
            raw_slots=raw, tracer=tracer,
        )
        if raw:
            slot_acc = out if slot_acc is None else slot_acc + out
        else:
            acc = acc + out
        done += chunk
    if slot_acc is not None:
        acc = acc + blocks_to_image(slot_acc, width, height, spp_chunk)
    return acc / spp


def render_image(
    scene: Scene,
    camera: Camera,
    generator: torch.Generator | None = None,
    settings: RenderSettings | None = None,
    sky_texture=None,
) -> torch.Tensor:
    """Render and quantise to uint8 [H, W, 3] (src/color.h:14-35)."""
    from raytracingproject_tpu_torch.color import to_u8

    return to_u8(render(scene, camera, generator, settings, sky_texture))
