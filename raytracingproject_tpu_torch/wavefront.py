"""Wavefront path tracing with stream compaction (counterpart of
raytracingproject_tpu/wavefront.py).

The megakernel (render.py) advances every camera sample through the
bounce loop in lockstep. This renderer keeps a fixed-capacity ray *pool*
that stays dense:

  1. free slots are refilled with fresh (pixel, sample) work items from a
     global queue (a prefix sum over the free mask gives each free slot
     its rank, and the slot takes work item next_work + rank),
  2. one bounce advances the whole pool: closest hit, `materials.scatter`,
     the sky on a miss,
  3. finished rays add their radiance into their pixel and free their
     slot.

It runs until the queue drains and the pool empties: a Python loop whose
condition is read on the host once an iteration (the JAX package's
`lax.while_loop` condition); the Philox key is read once before it.
Forward only.

The closest hit is the brute function of the JAX package
(`ops.intersect.closest_hit`): on the card its hand-written counterpart,
the fused kernel K4 (`ops.cuda.trace.pallas_closest_hit`), on the CPU
`ops.intersect.closest_hit` itself. Nothing on the card gives way to the
plain version.

Random numbers: work item w = sample * npix + pixel takes its camera
draws (jitter, defocus disk, time) from one Philox-4x32-10 block
(ops/rng.py) at counter (w, 0, 0, 0) under a key drawn once from the
generator, so a work item's camera ray does not depend on the pool (the
JAX package folds the key with w). The scatter draws come from the
generator once an iteration for the whole pool (JAX keys them by the
iteration).

Accumulation: several samples of one pixel can finish in one iteration.
The per-pixel sums are taken in a fixed order (the CPU's `index_add_`
adds in slot order; on the card `index_put_(accumulate=True)` sorts the
pixel indices stably and sums each pixel's run in slot order), not with
atomics, so an image is reproducible bit for bit from its seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytracingproject_tpu_torch.camera import CameraDerived, rays_from_uniforms
from raytracingproject_tpu_torch.config import T_MIN, RenderSettings
from raytracingproject_tpu_torch.materials import scatter
from raytracingproject_tpu_torch.ops.intersect import HitRecord, closest_hit
from raytracingproject_tpu_torch.ops.rng import INV_2_24, MASK32, bits_to_uniform, philox4x32_10
from raytracingproject_tpu_torch.render import sky_color
from raytracingproject_tpu_torch.scene import Scene


class _Pool(NamedTuple):
    origin: torch.Tensor      # [C, 3]
    direction: torch.Tensor   # [C, 3]
    time: torch.Tensor        # [C]
    throughput: torch.Tensor  # [C, 3]
    pixel: torch.Tensor       # [C] int64 pixel id
    depth: torch.Tensor       # [C] int64 bounces taken so far
    work: torch.Tensor        # [C] int64 work item id
    alive: torch.Tensor       # [C] bool


def work_uniforms(work: torch.Tensor, key: int, dtype=torch.float32):
    """The draws `camera.rays_from_uniforms` takes (offset [C, 2], disk_u,
    disk_theta, time) for work items `work` (int64): the Philox block at
    counter (w, 0, 0, 0) under `key` (its low and high 32 bits). Words 0-3
    give the jitter, the disk radius and the disk angle from their top 24
    bits (`bits_to_uniform`); the time takes the low bytes of words 0-2."""
    zero = torch.zeros_like(work)
    w = philox4x32_10(work, zero, zero, zero, key & MASK32, (key >> 32) & MASK32)
    u = [bits_to_uniform(x).to(dtype) for x in w]
    low = ((w[0] & 0xFF) << 16) | ((w[1] & 0xFF) << 8) | (w[2] & 0xFF)
    time = (low.to(torch.float32) * INV_2_24).to(dtype)
    return torch.stack([u[0], u[1]], dim=1) - 0.5, u[2], u[3] * (2.0 * math.pi), time


def pool_closest_hit(origin, direction, time, scene: Scene) -> HitRecord:
    """The bounce's closest hit: `ops.intersect.closest_hit` on the CPU,
    the fused kernel K4 (`pallas_closest_hit`) on the card, which raises
    rather than fall back."""
    if origin.device.type == "cpu":
        return closest_hit(origin, direction, time, scene.center0, scene.center_delta,
                           scene.radius, t_min=T_MIN)
    from raytracingproject_tpu_torch.ops.cuda.trace import pallas_closest_hit

    return pallas_closest_hit(origin, direction, time, scene, t_min=T_MIN)


def _empty_pool(c: int, dtype, device) -> _Pool:
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return _Pool(origin=zeros(c, 3), direction=torch.ones((c, 3), dtype=dtype, device=device),
                 time=zeros(c), throughput=zeros(c, 3), pixel=zeros(c, dt=torch.int64),
                 depth=zeros(c, dt=torch.int64), work=zeros(c, dt=torch.int64),
                 alive=zeros(c, dt=torch.bool))


def refill(pool: _Pool, next_work: torch.Tensor, total: int, cam: CameraDerived, width: int,
           npix: int, key: int) -> tuple[_Pool, torch.Tensor]:
    """Stream compaction: the free slots, in slot order, take work items
    next_work, next_work + 1, ... up to `total` (a device scalar; no host
    read). Returns the pool and the next work item."""
    free = ~pool.alive
    cand = next_work + torch.cumsum(free.to(torch.int64), 0) - 1
    assign = free & (cand < total)
    work = torch.where(assign, cand, 0)
    pixel = work % npix
    origin, direction, time = rays_from_uniforms(
        cam, pixel % width, pixel // width, *work_uniforms(work, key, cam.center.dtype))
    sel = assign[:, None]
    pool = _Pool(
        origin=torch.where(sel, origin, pool.origin),
        direction=torch.where(sel, direction, pool.direction),
        time=torch.where(assign, time, pool.time),
        throughput=torch.where(sel, 1.0, pool.throughput),
        pixel=torch.where(assign, pixel, pool.pixel),
        depth=torch.where(assign, 0, pool.depth),
        work=torch.where(assign, work, pool.work),
        alive=pool.alive | assign,
    )
    return pool, next_work + assign.sum()


def accumulate(acc: torch.Tensor, pixel: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """acc[pixel[k]] += contrib[k] for every slot k, each pixel's terms in
    slot order (deterministic: see the module docstring)."""
    if acc.device.type == "cpu":
        return acc.index_add_(0, pixel, contrib)
    return acc.index_put_((pixel,), contrib, accumulate=True)


def shade(pool: _Pool, rec: HitRecord, acc: torch.Tensor, scene: Scene,
          generator: torch.Generator, max_depth: int) -> tuple[_Pool, torch.Tensor]:
    """The bounce after its closest hit `rec` (wavefront.py:166-193 of the
    JAX package): a live ray that misses adds throughput * sky to its
    pixel and frees its slot; one that hits takes the scatter, and dies
    absorbed or on its max_depth-th bounce, with nothing."""
    sc = scatter(generator, pool.direction, rec, scene)
    miss = pool.alive & ~rec.hit
    contrib = torch.where(miss[:, None], pool.throughput * sky_color(pool.direction), 0.0)
    acc = accumulate(acc, pool.pixel, contrib)
    hit_live = (pool.alive & rec.hit)[:, None]
    depth = pool.depth + 1
    pool = pool._replace(
        origin=torch.where(hit_live, rec.p, pool.origin),
        direction=torch.where(hit_live, sc.direction, pool.direction),
        throughput=torch.where(hit_live, pool.throughput * sc.attenuation, pool.throughput),
        depth=depth,
        alive=hit_live[:, 0] & sc.scattered & (depth < max_depth),
    )
    return pool, acc


def bounce(pool: _Pool, acc: torch.Tensor, scene: Scene, generator: torch.Generator,
           max_depth: int) -> tuple[_Pool, torch.Tensor]:
    """One bounce of the whole pool: `pool_closest_hit`, then `shade`."""
    rec = pool_closest_hit(pool.origin, pool.direction, pool.time, scene)
    return shade(pool, rec, acc, scene, generator, max_depth)


def render_wavefront(
    scene: Scene,
    cam: CameraDerived,
    generator: torch.Generator,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    pool_size: int = 1 << 16,
    stats: dict | None = None,
) -> torch.Tensor:
    """Wavefront render: the radiance *sum* [H, W, 3] (divide by spp for
    the mean, as src/color.h:20-22), on the device of `cam` and `scene`.

    `generator` (on that device) gives the Philox key of the camera draws
    (one host read, before the loop), then every iteration's scatter
    draws. `stats`, a dict, receives the loop's "iterations" (one host
    read of its condition each)."""
    npix = width * height
    total = npix * spp
    dtype, dev = cam.center.dtype, cam.center.device
    key = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
    acc = torch.zeros((npix, 3), dtype=dtype, device=dev)
    pool = _empty_pool(pool_size, dtype, dev)
    next_work = torch.zeros((), dtype=torch.int64, device=dev)
    iterations = 0
    running = total > 0
    while running:
        pool, next_work = refill(pool, next_work, total, cam, width, npix, key)
        pool, acc = bounce(pool, acc, scene, generator, max_depth)
        iterations += 1
        queued, live = torch.stack([next_work, pool.alive.sum()]).tolist()
        running = queued < total or live > 0
    if stats is not None:
        stats.update(iterations=iterations)
    return acc.reshape(height, width, 3)


def wavefront_pool_size(total: int, rays_per_batch: int) -> int:
    """The JAX package's pool rule: the next power of two of the work,
    capped at `rays_per_batch`, at least 4096."""
    return max(4096, min(rays_per_batch, 1 << (total - 1).bit_length()))


def render_wavefront_image(
    scene: Scene,
    camera,
    generator: torch.Generator | None = None,
    settings: RenderSettings | None = None,
    stats: dict | None = None,
) -> torch.Tensor:
    """Mean-radiance wavefront render [H, W, 3] on `settings.device` (the
    card unless it says "cpu"), in `settings.dtype`, with the JAX
    package's pool rule (`wavefront_pool_size`); `generator` defaults to
    one seeded with 0 on that device, `stats` is render_wavefront's."""
    settings = settings or RenderSettings()
    device = settings.resolved_device()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    width, height = camera.image_size()
    spp = camera.samples_per_pixel
    acc = render_wavefront(
        scene.to(device), camera.derive(settings.dtype, device), generator,
        width=width, height=height, spp=spp, max_depth=camera.max_depth,
        pool_size=wavefront_pool_size(width * height * spp, settings.rays_per_batch),
        stats=stats,
    )
    return acc / spp
