"""Ray-sphere and ray-AABB intersection (counterpart of
raytracingproject_tpu/ops/intersect.py; reference: src/sphere.h:30-57,
src/aabb.h:35-53).

`closest_hit` is the oracle's differentiable closest hit. XLA fuses the
JAX function's [R, N] intermediates; eager PyTorch would materialise them
and autograd would save them for every bounce. So the port computes the
same function in two steps:

1. *select* the winner (masked argmin over all spheres) without autograd,
   in ray chunks of bounded size;
2. *re-evaluate* the winner's root from `idx` with [R]-sized ops, under
   autograd.

`argmin` and `take_along_axis` pass the gradient to the winner alone, so
the value and every gradient are those of the one-step form.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytracingproject_tpu_torch.config import T_MAX, T_MIN
from raytracingproject_tpu_torch.ops.vecmath import dot

# Elements of one [rays, spheres] temporary of the selection (64 MB of
# float32); the [rays, spheres, 3] difference is three times that.
SELECT_BLOCK = 1 << 24


class HitRecord(NamedTuple):
    """SoA hit record (reference: src/hittable.h:12-22); every field has a
    leading ray axis. `idx` replaces the reference's `mat` pointer."""

    t: torch.Tensor           # [R] hit distance (T_MAX where miss)
    idx: torch.Tensor         # [R] int32 index of the hit sphere (0 where miss)
    hit: torch.Tensor         # [R] bool
    p: torch.Tensor           # [R, 3] hit point
    normal: torch.Tensor      # [R, 3] normal facing against the ray
    front_face: torch.Tensor  # [R] bool


def dot3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dot product over a last axis of 3, written out in the fused
    kernel's order, (x + y) + z. A reduction's order differs between
    devices, and the quadratic of a 1000-unit sphere cancels enough for
    that alone to move t by 4e-4 relative (measured on an H100)."""
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def _roots(oc, direction, radius, t_min: float, t_max: float):
    """(root, disc_pos, in0 | in1) of the half-b quadratic; `oc` and
    `direction` broadcast to [..., 3], `radius` to [...]."""
    # Degenerate lambertian scatter (normal + unit vector ~ 0; the
    # reference omits the near_zero fix, src/material.h:19-25) can give
    # |d|^2 == 0; the clamp makes both roots invalid: a miss.
    a = torch.clamp_min(dot3(direction, direction), 1e-20)
    half_b = dot3(oc, direction)
    c = dot3(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    # sqrt at disc <= 0 has an inf/NaN derivative that would leak through
    # `where` into the cotangents (the double-where rule)
    disc_pos = disc > 0.0
    sqrtd = torch.sqrt(torch.where(disc_pos, disc, 1.0))
    # times the reciprocal and with `dot3`, as the fused kernel (K4) and
    # the BVH walk do: the three closest hits then give the same t, and an
    # oracle render does not depend on which of them ran (the JAX function
    # divides by a, one rounding apart)
    inv_a = 1.0 / a
    root0 = (-half_b - sqrtd) * inv_a
    root1 = (-half_b + sqrtd) * inv_a
    in0 = (root0 > t_min) & (root0 < t_max)
    in1 = (root1 > t_min) & (root1 < t_max)
    return torch.where(in0, root0, root1), disc_pos, in0 | in1


def sphere_hit_t(
    origin: torch.Tensor,     # [R, 3]
    direction: torch.Tensor,  # [R, 3]
    center: torch.Tensor,     # [R, N, 3] or [N, 3]
    radius: torch.Tensor,     # [N]
    t_min: float = T_MIN,
    t_max: float = T_MAX,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest valid root per (ray, sphere) pair (src/sphere.h:30-57):
    (t [R, N], valid [R, N]); t is meaningful only where valid. The root
    test uses the *open* interval (src/interval.h:30-32)."""
    if center.ndim == 2:
        center = center[None, :, :]
    oc = origin[:, None, :] - center
    root, disc_pos, inside = _roots(oc, direction[:, None, :], radius[None, :], t_min, t_max)
    return root, disc_pos & inside


def select_closest(origin, direction, time, center0, center_delta, radius,
                   t_min: float = T_MIN, t_max: float = T_MAX):
    """(idx [R] int64, hit [R] bool): the first sphere of the smallest
    valid root per ray, 0 and False on a miss. No gradient; rays go in
    chunks so no temporary exceeds SELECT_BLOCK pairs."""
    n_rays, n_sph = origin.shape[0], max(int(radius.shape[0]), 1)
    chunk = max(1, SELECT_BLOCK // n_sph)
    idx_parts, hit_parts = [], []
    with torch.no_grad():
        for r0 in range(0, max(n_rays, 1), chunk):
            sl = slice(r0, r0 + chunk)
            center = center0[None] + time[sl, None, None] * center_delta[None]
            t_all, valid = sphere_hit_t(origin[sl], direction[sl], center, radius, t_min, t_max)
            t_masked = torch.where(valid, t_all, math.inf)
            idx = torch.argmin(t_masked, dim=-1)
            idx_parts.append(idx)
            hit_parts.append(torch.isfinite(torch.gather(t_masked, 1, idx[:, None])[:, 0]))
    return torch.cat(idx_parts), torch.cat(hit_parts)


def hit_geometry(origin, direction, time, center0, center_delta, radius, t, idx, hit):
    """(p, normal, front_face) of a closest hit (t, idx, hit): the tail of
    `closest_hit`, shared with the fused kernel's wrapper and the BVH walk."""
    # miss lanes carry t = inf; a finite dummy keeps inf/NaN out of the
    # masked lanes' cotangents. `hit` is topology: no gradient.
    t_safe = torch.where(hit, t, 1.0)
    p = origin + t_safe[:, None] * direction
    hit_center = center0.index_select(0, idx) + time[:, None] * center_delta.index_select(0, idx)
    r_sel = radius.index_select(0, idx)
    r_safe = torch.where(r_sel != 0.0, r_sel, 1.0)  # padded spheres have r = 0
    outward = (p - hit_center) / r_safe[:, None]
    front_face = dot(direction, outward) < 0.0   # src/hittable.h:15-21
    normal = torch.where(front_face[:, None], outward, -outward)
    return p, normal, front_face


def closest_hit(
    origin: torch.Tensor,        # [R, 3]
    direction: torch.Tensor,     # [R, 3]
    time: torch.Tensor,          # [R] motion-blur time in [0, 1)
    center0: torch.Tensor,       # [N, 3]
    center_delta: torch.Tensor,  # [N, 3] (zeros if static)
    radius: torch.Tensor,        # [N]
    t_min: float = T_MIN,
    t_max: float = T_MAX,
) -> HitRecord:
    """Closest hit over all spheres (src/hittable_list.h:25-39), with the
    centre of a moving sphere at the ray's time (src/sphere.h:68-72).
    Differentiable in every float argument; see the module docstring."""
    idx, hit = select_closest(origin, direction, time, center0, center_delta, radius,
                              t_min, t_max)
    center = center0.index_select(0, idx) + time[:, None] * center_delta.index_select(0, idx)
    root, _, _ = _roots(origin - center, direction, radius.index_select(0, idx), t_min, t_max)
    t = torch.where(hit, root, math.inf)
    p, normal, front_face = hit_geometry(origin, direction, time, center0, center_delta,
                                         radius, t, idx, hit)
    return HitRecord(t=t, idx=idx.to(torch.int32), hit=hit, p=p, normal=normal,
                     front_face=front_face)


def aabb_hit(
    origin: torch.Tensor,     # [..., 3]
    direction: torch.Tensor,  # [..., 3]
    box_min: torch.Tensor,    # [..., 3]
    box_max: torch.Tensor,    # [..., 3]
    t_min: float = T_MIN,
    t_max: float = T_MAX,
) -> torch.Tensor:
    """Slab test (src/aabb.h:35-53), a bool mask. A zero direction
    component gives +-inf, which min/max handle as the reference's invD
    swap does."""
    inv_d = 1.0 / direction
    t0 = (box_min - origin) * inv_d
    t1 = (box_max - origin) * inv_d
    tmin = torch.clamp_min(torch.amax(torch.minimum(t0, t1), dim=-1), t_min)
    tmax = torch.clamp_max(torch.amin(torch.maximum(t0, t1), dim=-1), t_max)
    return tmax > tmin
