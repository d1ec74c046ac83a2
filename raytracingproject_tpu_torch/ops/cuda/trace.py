"""The fused closest hit (K4): CUDA wrapper and plain PyTorch version
(counterpart of raytracingproject_tpu/ops/pallas/trace.py).

`pallas_closest_hit` keeps the JAX function's name: a drop-in for
`ops.intersect.closest_hit` on the forward path, reached through
`RenderSettings(use_megakernel=False, use_pallas=True)`. For CUDA tensors
it launches the kernel of csrc/closest_hit.cu or raises; for CPU tensors it
runs `closest_hit_fused_twin`, the same scan in the same operation order,
which the tests hold against the JAX package and chip_smoke.py holds
against the kernel on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from raytracingproject_tpu_torch.config import T_MIN
from raytracingproject_tpu_torch.ops.cuda.megakernel import (
    TILE, _first_min, _require, _sphere_disc, _sphere_t,
)
from raytracingproject_tpu_torch.ops.intersect import HitRecord, hit_geometry
from raytracingproject_tpu_torch.scene import Scene

# Spheres the plain version scans at a time: a bound on its [rays, spheres]
# temporaries. Any value gives the same result, bit for bit.
SPHERE_CHUNK = 1024

# Kernel launches, counted by the wrapper after each successful launch
# (and nowhere else).
LAUNCHES = {"closest_hit": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sphere_table(scene: Scene, dtype=torch.float32) -> torch.Tensor:
    """(8, N) table of the fused closest hit: rows cx cy cz mx my mz
    radius and a zero row (trace.py:123-130 of the JAX package)."""
    rows = [
        scene.center0[:, 0], scene.center0[:, 1], scene.center0[:, 2],
        scene.center_delta[:, 0], scene.center_delta[:, 1], scene.center_delta[:, 2],
        scene.radius, torch.zeros_like(scene.radius),
    ]
    return torch.stack(rows).detach().to(dtype).contiguous()


def closest_hit_fused_twin(origin, direction, time, tab, t_min: float = T_MIN,
                           sphere_chunk: int = SPHERE_CHUNK):
    """K4's plain version: (t [R], idx [R] int32) over the (8, N) table
    `tab`, on any device. Per sphere chunk the first minimum in sphere
    order, and a strict `<` across chunks: what the kernel's sequential
    strict-`<` scan keeps, whatever `sphere_chunk` is. Rays go in blocks
    so no [rays, spheres] temporary exceeds ~64 MB."""
    n, n_sph = origin.shape[0], tab.shape[1]
    block = max(TILE, ((1 << 24) // max(min(n_sph, sphere_chunk), 1)) // TILE * TILE)
    t_parts, idx_parts = [], []
    for r0 in range(0, max(n, 1), block):
        sl = slice(r0, r0 + block)
        ox, oy, oz = origin[sl].unbind(1)
        dx, dy, dz = direction[sl].unbind(1)
        tm = time[sl]
        a = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20)
        inv_a = 1.0 / a
        best_t = torch.full_like(tm, math.inf)
        best_idx = torch.zeros_like(tm, dtype=torch.int64)
        for c0 in range(0, n_sph, sphere_chunk):
            bt, win = _first_min(_sphere_t(tab[:, c0:c0 + sphere_chunk], ox, oy, oz, dx, dy, dz,
                                           tm, a, inv_a, t_min))
            better = bt < best_t
            best_t = torch.where(better, bt, best_t)
            best_idx = torch.where(better, win + c0, best_idx)
        t_parts.append(best_t)
        idx_parts.append(best_idx.to(torch.int32))
    return torch.cat(t_parts), torch.cat(idx_parts)


def disc_counts(origin, direction, time, tab, warp: int = 32) -> dict:
    """What K4's scan of these rays over the (8, N) table `tab` needs,
    counted with the plain version's operations (`_sphere_disc`): "pairs"
    (rays x spheres), "roots" (the pairs whose discriminant is positive,
    the only ones that take a square root and roots), "warps" ((warp of
    `warp` consecutive rays, sphere) pairs) and "warp_roots" (those in which
    some ray's discriminant is positive: the warp cannot skip the roots).
    A last, partial warp counts as a warp (its missing lanes would copy its
    last ray)."""
    n, n_sph = origin.shape[0], tab.shape[1]
    block = max(warp, ((1 << 22) // max(n_sph, 1)) // warp * warp)
    roots = warp_roots = 0
    for r0 in range(0, n, block):
        sl = slice(r0, r0 + block)
        ox, oy, oz = origin[sl].unbind(1)
        dx, dy, dz = direction[sl].unbind(1)
        a = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20)
        pos = _sphere_disc(tab, ox, oy, oz, dx, dy, dz, time[sl], a)[1] > 0.0
        roots += int(pos.sum())
        pad = -pos.shape[0] % warp
        if pad:
            pos = torch.cat([pos, pos.new_zeros((pad, n_sph))])
        warp_roots += int(pos.view(-1, warp, n_sph).any(dim=1).sum())
    return {"pairs": n * n_sph, "roots": roots, "warps": -(-n // warp) * n_sph,
            "warp_roots": warp_roots}


def closest_hit_occupancy() -> dict:
    """K4's launch on the card: {"blocks_per_sm", "threads"}, the blocks
    one SM holds and the threads (one ray each) of a block."""
    from raytracingproject_tpu_torch.ops.cuda import build

    blocks, threads = ctypes.c_int(), ctypes.c_int()
    build.check(build.load_library("closest_hit").rtp_closest_hit_occupancy(
        ctypes.byref(blocks), ctypes.byref(threads)), "closest-hit occupancy", "closest_hit")
    return {"blocks_per_sm": blocks.value, "threads": threads.value}


def closest_hit_fused(origin: torch.Tensor, direction: torch.Tensor, time: torch.Tensor,
                      tab: torch.Tensor, t_min: float = T_MIN):
    """(t [R] float32, inf on a miss; idx [R] int32, 0 on a miss) of the
    closest sphere of the (8, N) table `tab`. CUDA tensors launch the
    kernel (or raise); CPU tensors run the plain version."""
    dev = origin.device
    if dev.type == "cpu":
        return closest_hit_fused_twin(origin, direction, time, tab, t_min)
    if dev.type != "cuda":
        raise ValueError(f"the fused closest hit runs on cuda or cpu tensors, not {dev}")
    from raytracingproject_tpu_torch.ops.cuda import build

    n, n_sph = origin.shape[0], tab.shape[1]
    _require(origin, "origin", (n, 3), torch.float32, dev)
    _require(direction, "direction", (n, 3), torch.float32, dev)
    _require(time, "time", (n,), torch.float32, dev)
    _require(tab, "sphere table", (8, n_sph), torch.float32, dev)
    if n_sph == 0:
        raise ValueError("the sphere table is empty")
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, idx
    lib = build.load_library("closest_hit")
    err = lib.rtp_closest_hit(origin.data_ptr(), direction.data_ptr(), time.data_ptr(),
                              tab.data_ptr(), n, n_sph, t_min, t.data_ptr(), idx.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "closest-hit kernel launch", "closest_hit")
    LAUNCHES["closest_hit"] += 1
    return t, idx


def pallas_closest_hit(origin: torch.Tensor, direction: torch.Tensor, time: torch.Tensor,
                       scene: Scene, t_min: float = T_MIN) -> HitRecord:
    """Drop-in for ops.intersect.closest_hit on the forward path
    (pallas_closest_hit of the JAX package): the fused kernel's (t, idx),
    then the hit point, normal and face rebuilt in PyTorch.

    Forward only, as in the JAX package (no backward kernel there, and
    `grad.render_loss` never takes this route): `t` and `idx` carry no
    gradient, and the scene's parameters and the rays are read detached."""
    o, d, tm = (x.detach().contiguous() for x in (origin, direction, time))
    t, idx = closest_hit_fused(o, d, tm, sphere_table(scene, o.dtype), t_min)
    hit = torch.isfinite(t)
    p, normal, front_face = hit_geometry(o, d, tm, scene.center0.detach(),
                                         scene.center_delta.detach(), scene.radius.detach(),
                                         t, idx.long(), hit)
    return HitRecord(t=t, idx=idx, hit=hit, p=p, normal=normal, front_face=front_face)
