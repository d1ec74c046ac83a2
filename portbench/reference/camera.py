"""The frame's rays, frozen: the camera frame ("Ray Tracing in One
Weekend", camera::initialize and get_ray), the draws a pass takes from
the frame's generator, the pass split and the slot order in which a pass
feeds its rays.

The renderer's contract that this copies:
- a frame of W x H pixels at `spp` samples runs passes of `chunk` samples,
  chunk = max(1, min(spp, RAYS_PER_BATCH // (W * H)));
- a pass's rays go in compact screen blocks: all of a b x b block's
  samples in a row, b the largest of 32, 16, 8 with b * b * chunk <= TILE
  (8 at the least); the slot list is padded to a TILE multiple with
  pixel 0;
- a pass draws from the generator, in this order: the jitter [R, 2]
  (minus 0.5), the disk radius draw [R], the disk angle [R] (times 2 pi)
  and the ray time [R], R the padded slot count, each `torch.rand`
  float32; then the pass's path seed, `torch.randint(0, 2^31 - 1, (1,))`;
- the image is the sum of every sample's radiance over spp.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

TILE = 256
RAYS_PER_BATCH = 1 << 17


def derive(cam: dict, width: int, height: int) -> dict[str, np.ndarray]:
    """camera::initialize in float64: the frame vectors of `cam` (vfov,
    lookfrom, lookat, vup, defocus_angle, focus_dist)."""
    lookfrom = np.asarray(cam["lookfrom"], np.float64)
    lookat = np.asarray(cam["lookat"], np.float64)
    vup = np.asarray(cam.get("vup", (0.0, 1.0, 0.0)), np.float64)
    focus = float(cam["focus_dist"])
    h = math.tan(math.radians(cam["vfov"]) / 2.0)
    vh = 2.0 * h * focus
    vw = vh * (width / height)
    w = (lookfrom - lookat) / np.linalg.norm(lookfrom - lookat)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    du = vw * u / width
    dv = vh * -v / height
    upper_left = lookfrom - focus * w - vw * u / 2 - vh * -v / 2
    radius = focus * math.tan(math.radians(cam["defocus_angle"] / 2.0))
    return {"center": lookfrom, "pixel00": upper_left + 0.5 * (du + dv), "du": du, "dv": dv,
            "disk_u": u * radius, "disk_v": v * radius,
            "defocus": float(cam["defocus_angle"])}


def image_height(width: int, aspect: float) -> int:
    return max(int(width / aspect), 1)


def pass_chunk(width: int, height: int, spp: int) -> int:
    return max(1, min(spp, RAYS_PER_BATCH // max(width * height, 1)))


@lru_cache(maxsize=8)
def block_order(width: int, height: int, chunk: int):
    """(slot_pix [R_pad] int64, gather [chunk, W * H] int64): the pixel of
    each slot, and the slot of each (sample, pixel)."""
    b = 32
    while b > 8 and b * b * chunk > TILE:
        b //= 2
    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    slots, pos = [], 0
    gather = np.empty((chunk, width * height), np.int64)
    for by in range(0, height, b):
        for bx in range(0, width, b):
            blk = idx[by:by + b, bx:bx + b].reshape(-1)
            for s in range(chunk):
                gather[s, blk] = pos + np.arange(blk.size)
                slots.append(blk)
                pos += blk.size
    slot_pix = np.concatenate(slots)
    slot_pix = np.concatenate([slot_pix, np.zeros((-slot_pix.size) % TILE, np.int64)])
    return slot_pix, gather


def pass_draws(n: int, gen: torch.Generator, device) -> tuple[list[torch.Tensor], int]:
    """(camera uniforms [offset, disk_u, disk_theta, time], path seed) of
    one pass of `n` padded slots, drawn from `gen` in the renderer's
    order."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)

    offset = rand(n, 2) - 0.5
    disk_u = rand(n)
    disk_theta = rand(n) * (2.0 * math.pi)
    time = rand(n)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=device))
    return [offset, disk_u, disk_theta, time], seed


def rays(frame: dict, pix: torch.Tensor, width: int, draws, dtype=torch.float32):
    """camera::get_ray for pixels `pix` (int64, row-major) given their
    draws: (origin [R, 3], direction [R, 3], time [R]) in `dtype`."""
    dev = pix.device
    t = {k: torch.as_tensor(v, dtype=torch.float64).to(dtype).to(dev)
         for k, v in frame.items() if k != "defocus"}
    offset, disk_u, disk_theta, time = (x.to(dtype) for x in draws)
    i = (pix % width).to(dtype)[:, None]
    j = (pix // width).to(dtype)[:, None]
    center = t["pixel00"][None] + i * t["du"][None] + j * t["dv"][None]
    sample = center + offset[:, 0:1] * t["du"][None] + offset[:, 1:2] * t["dv"][None]
    r = torch.sqrt(disk_u)
    dx = (r * torch.cos(disk_theta))[:, None]
    dy = (r * torch.sin(disk_theta))[:, None]
    origin = t["center"][None] + dx * t["disk_u"][None] + dy * t["disk_v"][None]
    if frame["defocus"] <= 0.0:
        origin = t["center"][None].expand_as(origin)
    return origin.contiguous(), sample - origin, time
