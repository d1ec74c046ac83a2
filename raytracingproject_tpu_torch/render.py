"""The renderers (counterpart of raytracingproject_tpu/render.py).

The megakernel path (the port's default): render -> render_pass ->
ops.cuda.megakernel.trace_paths. Rays are fed in compact screen blocks
(`_block_order`), traced by the megakernel (K1 with the front-culled K3,
or the BVH walk K8 when the front's tables pass the shared-memory budget
(`prepare_scene`), or the brute K2 without the BVH),
accumulated in slot space over sample chunks and unpermuted once per
frame (`blocks_to_image`). The block order lives on the device: its pixel
columns, rows and gather are uploaded once per shape and device
(`_slot_ij`, `_slot_gather`) and every later pass reuses them, so no pass
waits in a copy from the host. `RenderSettings.two_phase` and
`depth_segment` cut the trace into depth segments of K6 with the live
rays packed between them (ops/cuda/depth_tail.py); a sky texture makes
the kernel record each ray's miss, and the texture is looked up here.

The oracle path (`use_megakernel=False`, the JAX package's default):
render -> render_pass -> ray_color, a Python loop over bounce depth that
carries (origin, direction, throughput, radiance, alive) for all rays in
lockstep. Each bounce is a closest hit (`ops.intersect.closest_hit`, the
fused kernel K4 with `use_pallas`, or the BVH walk), `materials.scatter`
and the sky. It is the correctness oracle and, through PyTorch autograd,
the path that is differentiable end to end (grad/inverse.py).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Sequence

import numpy as np
import torch

from raytracingproject_tpu_torch.camera import (
    Camera, CameraDerived, camera_uniforms, rays_from_uniforms,
)
from raytracingproject_tpu_torch.config import T_MIN, RenderSettings
from raytracingproject_tpu_torch.materials import ScatterDraws, draw_scatter, scatter_from_draws
from raytracingproject_tpu_torch.ops.cuda.depth_tail import (
    trace_paths_segmented, trace_paths_twophase,
)
from raytracingproject_tpu_torch.ops.cuda.megakernel import TILE, BVHTables, trace_paths
from raytracingproject_tpu_torch.ops.intersect import closest_hit
from raytracingproject_tpu_torch.ops.vecmath import normalize
from raytracingproject_tpu_torch.scene import Scene
from raytracingproject_tpu_torch.utils.profiling import count, span, sync

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)


@lru_cache(maxsize=None)
def _sky_ends(dtype: torch.dtype, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The sky gradient's two ends on `device`, made once: a tensor made
    from host values every call is a synchronous copy to the card."""
    return (torch.tensor(SKY_WHITE, dtype=dtype, device=device),
            torch.tensor(SKY_BLUE, dtype=dtype, device=device))


def sky_color(direction: torch.Tensor, sky_tex: torch.Tensor | None = None) -> torch.Tensor:
    """Background radiance of a miss ray. Default: the reference's
    gradient (src/camera_cpu.h:23-25), lerp(white, (0.5, 0.7, 1.0)) by
    0.5 * (unit_dir.y + 1).

    With `sky_tex` ([Ht, Wt, 3] linear float): an equirectangular
    environment-map lookup, bilinear in the texture plane (u from the
    azimuth, v from the polar angle, y up)."""
    unit = normalize(direction, eps=1e-12)
    if sky_tex is None:
        a = 0.5 * (unit[..., 1] + 1.0)
        white, blue = _sky_ends(direction.dtype, direction.device)
        return (1.0 - a)[..., None] * white + a[..., None] * blue

    sky_tex = sky_tex.to(direction.device)
    ht, wt = sky_tex.shape[0], sky_tex.shape[1]
    ux, uy, uz = unit[..., 0], unit[..., 1], unit[..., 2]
    # Grad-safety: atan2 at the poles (x = z = 0) and acos at +-1 have
    # non-finite derivatives; those lanes get a finite dummy argument and
    # their exact value (0; 0 or pi) from the outer `where`.
    off_axis = (ux != 0.0) | (uz != 0.0)
    azimuth = torch.where(off_axis, torch.atan2(uz, torch.where(off_axis, ux, 1.0)), 0.0)
    u = 0.5 + azimuth / (2.0 * math.pi)
    inside = torch.abs(uy) < 1.0
    polar = torch.where(inside, torch.acos(torch.where(inside, uy, 0.0)),
                        torch.where(uy > 0.0, 0.0, math.pi))
    v = polar / math.pi
    x = u * (wt - 1)
    y = v * (ht - 1)
    x0 = torch.clamp(torch.floor(x).long(), 0, wt - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, ht - 1)
    x1 = torch.clamp_max(x0 + 1, wt - 1)
    y1 = torch.clamp_max(y0 + 1, ht - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = sky_tex.reshape(-1, 3)
    c00, c01, c10, c11 = (flat[i] for i in (y0 * wt + x0, y0 * wt + x1,
                                            y1 * wt + x0, y1 * wt + x1))
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return (top * (1 - fy) + bot * fy).to(direction.dtype)


class _PathState(NamedTuple):
    origin: torch.Tensor      # [R, 3]
    direction: torch.Tensor   # [R, 3]
    throughput: torch.Tensor  # [R, 3] product of attenuations so far
    radiance: torch.Tensor    # [R, 3] accumulated light
    alive: torch.Tensor       # [R] bool: still bouncing


def _closest_hit_of(scene: Scene, time: torch.Tensor, state: _PathState, bvh, use_pallas: bool):
    """The bounce's closest hit: the fused kernel (K4) with `use_pallas`,
    else the BVH walk with `bvh`, else the differentiable brute scan."""
    if use_pallas:
        from raytracingproject_tpu_torch.ops.cuda.trace import pallas_closest_hit

        return pallas_closest_hit(state.origin, state.direction, time, scene, t_min=T_MIN)
    if bvh is not None:
        from raytracingproject_tpu_torch.bvh import bvh_closest_hit

        return bvh_closest_hit(state.origin, state.direction, time, scene, bvh, t_min=T_MIN)
    return closest_hit(state.origin, state.direction, time, scene.center0,
                       scene.center_delta, scene.radius, t_min=T_MIN)


def _bounce(scene: Scene, time: torch.Tensor, state: _PathState, draws: ScatterDraws,
            bvh=None, use_pallas: bool = False, sky_tex=None) -> _PathState:
    """One bounce of every ray: closest hit, then scatter or sky. Dead rays
    keep their last origin and direction; they go on being intersected and
    are masked, so a ray's draws never depend on which other rays live."""
    rec = _closest_hit_of(scene, time, state, bvh, use_pallas)
    sc = scatter_from_draws(draws, state.direction, rec, scene)

    miss = state.alive & ~rec.hit
    # on a miss: add throughput * sky and retire (src/camera_cpu.h:23-25)
    radiance = state.radiance + torch.where(
        miss[..., None], state.throughput * sky_color(state.direction, sky_tex), 0.0)
    # on a hit: multiply the throughput by the attenuation; an absorbed ray
    # (metal below the hemisphere) retires with nothing (src/camera_cpu.h:20)
    hit_live = state.alive & rec.hit
    throughput = torch.where(hit_live[..., None], state.throughput * sc.attenuation,
                             state.throughput)
    alive = hit_live & sc.scattered
    origin = torch.where(hit_live[..., None], rec.p, state.origin)
    direction = torch.where(hit_live[..., None], sc.direction, state.direction)
    return _PathState(origin, direction, throughput, radiance, alive)


def ray_color(
    scene: Scene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    time: torch.Tensor,
    generator: torch.Generator | None,
    max_depth: int,
    bvh=None,
    early_exit: bool = False,
    use_pallas: bool = False,
    sky_tex: torch.Tensor | None = None,
    draws: Sequence[ScatterDraws] | None = None,
) -> torch.Tensor:
    """Radiance [R, 3] of a batch of rays: the iterative counterpart of the
    reference's depth-limited recursion (src/camera_cpu.h:8-26). Rays still
    alive after `max_depth` bounces contribute black.

    Bounce k consumes the k-th set of draws, from `generator` (on the rays'
    device) in sequence or, when given, `draws[k]` (tests hand over the JAX
    package's). Differentiable with respect to the scene's float fields on
    the brute scan; `bvh` (a FlatBVH over `scene`, which must be in leaf
    order) and `use_pallas` (K4) are forward paths.

    `early_exit` stops the loop once every ray has terminated: one host
    read of `alive.any()` per bounce. The radiance is that of the full
    loop, since a bounce with no live ray changes nothing."""
    n = origin.shape[0]
    dtype, dev = origin.dtype, origin.device
    state = _PathState(
        origin=origin, direction=direction,
        throughput=torch.ones((n, 3), dtype=dtype, device=dev),
        radiance=torch.zeros((n, 3), dtype=dtype, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
    )
    for depth in range(max_depth):
        if early_exit and not bool(state.alive.any()):
            break
        d = draws[depth] if draws is not None else draw_scatter(generator, (n,), dtype)
        state = _bounce(scene, time, state, d, bvh, use_pallas, sky_tex)
    return state.radiance


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


def _device_key(device) -> torch.device:
    """`device` with its index, so that `cuda` and `cuda:0` are one key of
    the block order's device caches."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@lru_cache(maxsize=8)
def _slot_ij(width: int, height: int, spp: int, tile: int,
             device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(i, j): the pixel column and row of each slot of `_block_order`,
    int32 [R_pad] on `device` (a `_device_key`). The slot order is uploaded
    on a miss alone, by a blocking copy, so the tensors are whole before
    any stream reads them; every later pass of the shape reuses them."""
    slot_pix, _ = _block_order(width, height, spp, tile)
    count("upload_bytes", slot_pix.nbytes)
    with sync("rtp.upload.slot_order"):
        pix = torch.from_numpy(slot_pix).to(device)
    return pix % width, pix // width


@lru_cache(maxsize=8)
def _slot_gather(width: int, height: int, spp: int, tile: int,
                 device: torch.device) -> torch.Tensor:
    """`_block_order`'s gather, int64 [spp, H*W] on `device` (a
    `_device_key`), uploaded on a miss alone, as `_slot_ij`'s slot order."""
    _, gather = _block_order(width, height, spp, tile)
    count("upload_bytes", gather.nbytes)
    with sync("rtp.upload.gather"):
        return torch.from_numpy(gather).to(device, torch.int64)


def _slot_rays(cam: CameraDerived, width: int, height: int, spp_chunk: int,
               generator: torch.Generator | None, ray_uniforms):
    """Camera rays of every slot in `_block_order`, from the slots' pixels
    kept on the rays' device (`_slot_ij`)."""
    dev = cam.pixel00_loc.device
    with span("rtp.pass.rays"):
        i, j = _slot_ij(width, height, spp_chunk, TILE, _device_key(dev))
        if ray_uniforms is None:
            ray_uniforms = camera_uniforms(i.shape[0], generator, dev, cam.pixel00_loc.dtype)
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
    early_exit: bool = False,
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
    path_draws: Sequence[ScatterDraws] | None = None,
) -> torch.Tensor:
    """`spp_chunk` samples of every pixel: the radiance sum [H, W, 3] over
    the chunk, or with `raw_slots` the slot-space radiance [R_pad, 3].

    The camera draws come from `generator`, then the path's: the
    megakernel's seed (randint in [0, 2^31 - 1)), or the oracle's scatter
    draws bounce by bounce. `ray_uniforms` (the draws of
    `camera.rays_from_uniforms`, one per ray), `seed` and `path_draws`
    (`ray_color`'s `draws`) replace them; tests use them to feed both
    packages the same numbers. `tracer` is the function that traces the
    rays (the megakernel wrapper; a check may pass the plain version to
    hold the kernel against it).

    The megakernel's closest hit is `front`'s (K3 or K7) when given, else
    the walk of `bvh` (K8; a FlatBVH over `scene` in leaf order), else the
    brute scan. Without `bvh`, `depth_segment` (when below `max_depth`)
    traces in segments of that many bounces with a compaction between
    each two, else `two_phase` (when below `max_depth`) traces the first
    `two_phase` bounces, compacts once and traces the rest
    (ops/cuda/depth_tail.py); a FrontTablesHBM has no segment kernel, so
    two-phase falls back to the monolithic trace and segmented raises, as
    in the JAX package. With `sky_tex` ([Ht, Wt, 3], on the rays' device)
    the kernel records each ray's miss direction and throughput and the
    radiance gains `mthr * sky_color(mdir, sky_tex)`.

    With `use_megakernel=False` the rays are the image tiled `spp_chunk`
    times in row-major order and go through `ray_color`, which takes `bvh`,
    `early_exit`, `use_pallas` and `sky_tex`."""
    if not use_megakernel:
        if raw_slots:
            raise ValueError("raw_slots (slot-space output) is an option of the megakernel "
                             "path; the oracle path returns [H, W, 3]")
        dev = cam.pixel00_loc.device
        pix = torch.arange(height * width, device=dev).repeat(spp_chunk)
        if ray_uniforms is None:
            ray_uniforms = camera_uniforms(pix.shape[0], generator, dev, cam.pixel00_loc.dtype)
        origin, direction, time = rays_from_uniforms(
            cam, (pix % width).to(torch.int32), (pix // width).to(torch.int32), *ray_uniforms)
        rad = ray_color(scene, origin, direction, time, generator, max_depth, bvh, early_exit,
                        use_pallas, sky_tex, draws=path_draws)
        return rad.reshape(spp_chunk, height, width, 3).sum(dim=0)
    if use_pallas:
        raise ValueError("use_pallas selects the oracle path's fused closest hit (K4); the "
                         "megakernel has its own. Set use_megakernel=False with it")
    count("passes")
    with span("rtp.pass"):
        origin, direction, time = _slot_rays(cam, width, height, spp_chunk, generator,
                                             ray_uniforms)
        if seed is None:
            drawn = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                  device=generator.device)
            with sync("rtp.sync.seed"):
                seed = int(drawn)
        record_miss = sky_tex is not None
        kw = dict(front=front, zero_draws=zero_draws, record_miss=record_miss)
        with span("rtp.pass.trace"):
            if depth_segment and max_depth > depth_segment and bvh is None:
                out = trace_paths_segmented(origin, direction, time, scene, seed, max_depth,
                                            seg_len=depth_segment, **kw)
            elif two_phase and max_depth > two_phase and bvh is None:
                out = trace_paths_twophase(origin, direction, time, scene, seed, max_depth,
                                           cuts=(two_phase,), **kw)
            else:
                out = tracer(origin, direction, time, scene, seed, max_depth, bvh=bvh, **kw)
        if record_miss:
            rad, mdir, mthr = out
            rad = rad + mthr * sky_color(mdir, sky_tex)
        else:
            rad = out
        if raw_slots:
            return rad
        return blocks_to_image(rad, width, height, spp_chunk)


def blocks_to_image(slot_rad: torch.Tensor, width: int, height: int,
                    spp_chunk: int) -> torch.Tensor:
    """Slot-space radiance sum [R_pad, 3] -> row-major image sum [H, W, 3],
    by the gather kept on the radiance's device (`_slot_gather`)."""
    with span("rtp.pass.image"):
        g = _slot_gather(width, height, spp_chunk, TILE, _device_key(slot_rad.device))
        return slot_rad[g].sum(dim=0).reshape(height, width, 3)


def prepare_scene(scene: Scene, camera: Camera, settings: RenderSettings):
    """(scene, tables) for the megakernel path: the scene on the render
    device, in BVH leaf order with the closest hit's tables when `use_bvh`
    is on; else as given, tables None.

    The tables are a FrontTables (K3) while the front fits the card's
    shared memory (with `two_phase` or `depth_segment`, beside the front
    segment's live list), ordered near-to-far from the camera. Past that
    they are the BVHTables of the same tree (K8, the BVH walk; `render`
    passes them as `render_pass(bvh=)`), and a scene whose
    `front_bytes_floor` already passes the budget is refused before any
    front is built. A tree the walk cannot take (`BVHRefused`) gets a
    FrontTablesHBM (K7), in leaf order as the JAX package builds it.
    Counted: one `routes.*` a call, and each refused front."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk

    device = settings.resolved_device()
    with span("rtp.prepare_scene"):
        scene = scene.to(device)
        if not settings.use_bvh:
            return scene, None
        leaf = max(settings.bvh_leaf_size, 8)  # front subtrees amortise culling
        with span("rtp.prep.bvh"):
            bvh = build_bvh(scene, leaf_size=leaf)
        with span("rtp.prep.reorder"):
            scene = reorder_scene(scene, bvh)
        op = tuple(float(x) for x in camera.lookfrom)
        rp = 2 if camera.max_depth <= 24 else 1
        # the depth tail's front segment keeps its live list beside the tables
        tail = settings.two_phase or settings.depth_segment
        budget = mk.SMEM_BUDGET_BYTES - (mk.SEGMENT_LIST_BYTES if tail else 0)
        try:
            with span("rtp.prep.front"):
                front = mk.front_tables(scene, bvh, order_point=op, repack=rp,
                                        smem_budget=budget)
            count("routes.front")
            return scene, front
        except mk.FrontOverBudget:
            count("front_refusals")
        try:
            with span("rtp.prep.bvh_nodes"):
                tables = mk.bvh_tables(bvh, device)
            count("routes.bvh")
            return scene, tables
        except mk.BVHRefused:
            pass
        with span("rtp.prep.front_hbm"):
            front = mk.front_tables_hbm(scene, bvh)
        count("routes.front_hbm")
        return scene, front


def prepare_oracle_scene(scene: Scene, settings: RenderSettings):
    """(scene, bvh) for the oracle path: the scene on the render device;
    with `use_bvh` in leaf order of a BVH of `bvh_leaf_size`, with the
    tree's tensors on that device too (the walk gathers from them)."""
    from raytracingproject_tpu_torch.bvh import FlatBVH, build_bvh, reorder_scene

    device = settings.resolved_device()
    scene = scene.to(device)
    if not settings.use_bvh:
        return scene, None
    bvh = build_bvh(scene, leaf_size=settings.bvh_leaf_size)
    return reorder_scene(scene, bvh), FlatBVH(*(x.to(device) for x in bvh))


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
    random number of the render. `settings.use_megakernel` picks the
    megakernel (the port's default) or the oracle loop (`ray_color`, with
    early exit); the oracle takes `use_pallas` (the fused closest hit, K4,
    which wins over the BVH walk). `sky_texture` ([Ht, Wt, 3], linear) is
    the environment map of both: the oracle looks it up at each miss, the
    megakernel records the misses and `render_pass` looks it up after the
    kernel. `settings.two_phase` and `depth_segment` pick the depth-tail
    pipelines (see `render_pass`).

    `settings.dtype` is the oracle's working type: its camera rays, bounce
    loop and accumulator (float64 for finite-difference checks). The
    megakernel computes and returns float32 whatever `dtype` says, as the
    JAX package's megakernel does (its config.py, `use_megakernel`)."""
    count("frames")
    with span("rtp.render"):
        settings = settings or RenderSettings()
        use_megakernel = settings.use_megakernel
        device = settings.resolved_device()
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        width, height = camera.image_size()
        dtype = torch.float32 if use_megakernel else settings.dtype
        cam = camera.derive(dtype, device)
        spp = camera.samples_per_pixel
        bvh = front = None
        if use_megakernel:
            scene, front = prepare_scene(scene, camera, settings)
            if isinstance(front, BVHTables):
                bvh, front = front, None
        else:
            scene, bvh = prepare_oracle_scene(scene, settings)
        if sky_texture is not None:
            sky_texture = torch.as_tensor(sky_texture, dtype=torch.float32, device=device)

        spp_chunk = max(1, min(spp, settings.rays_per_batch // max(width * height, 1)))
        acc = torch.zeros((height, width, 3), dtype=dtype, device=device)
        slot_acc = None
        done = 0
        while done < spp:
            chunk = min(spp_chunk, spp - done)
            raw = use_megakernel and chunk == spp_chunk
            out = render_pass(
                scene, cam, generator, width=width, height=height,
                max_depth=camera.max_depth, spp_chunk=chunk, bvh=bvh, front=front,
                early_exit=True, use_pallas=settings.use_pallas, use_megakernel=use_megakernel,
                depth_segment=settings.depth_segment or 0, two_phase=settings.two_phase or 0,
                sky_tex=sky_texture, raw_slots=raw, tracer=tracer,
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
