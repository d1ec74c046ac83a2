"""Material scatter rules (counterpart of raytracingproject_tpu/materials.py;
reference: src/material.h).

The reference's virtual `material::scatter` becomes masked selects over
`mat_type`: all three scatter directions are computed for every ray and
the right one selected. `scatter_from_draws` is the rule on given random
draws (the tests hand it the JAX package's); `scatter` draws them from a
`torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracingproject_tpu_torch.config import DIELECTRIC, LAMBERTIAN, METAL
from raytracingproject_tpu_torch.ops.intersect import HitRecord
from raytracingproject_tpu_torch.ops.sampling import random_in_unit_sphere, random_unit_vector
from raytracingproject_tpu_torch.ops.vecmath import dot, normalize, reflect, refract
from raytracingproject_tpu_torch.scene import Scene


class ScatterResult(NamedTuple):
    direction: torch.Tensor    # [R, 3] scattered ray direction
    attenuation: torch.Tensor  # [R, 3]
    scattered: torch.Tensor    # [R] bool; False = absorbed (black)
    # [R] bool: the dielectric took the reflect branch (TIR or Schlick).
    # Meaningful on dielectric lanes only; the path replay records it.
    dielectric_reflected: torch.Tensor


class ScatterDraws(NamedTuple):
    """The random numbers of one `scatter` call."""

    unit: torch.Tensor     # [R, 3] unit vector (lambertian)
    ball: torch.Tensor     # [R, 3] point in the unit ball (metal fuzz)
    uniform: torch.Tensor  # [R] U[0, 1) (Schlick reflection)


def draw_scatter(generator: torch.Generator, shape, dtype=torch.float32) -> ScatterDraws:
    """One bounce's draws, in this order: unit vector, ball point, uniform."""
    unit = random_unit_vector(generator, shape, dtype)
    ball = random_in_unit_sphere(generator, shape, dtype)
    uniform = torch.rand(tuple(shape), generator=generator, device=generator.device,
                         dtype=dtype)
    return ScatterDraws(unit, ball, uniform)


def schlick_reflectance(cosine: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """Schlick's approximation (src/material.h:74-79)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter_from_draws(
    draws: ScatterDraws,
    in_direction: torch.Tensor,  # [R, 3] incident ray direction (unnormalised)
    rec: HitRecord,
    scene: Scene,
) -> ScatterResult:
    """Batched scatter of all three material types (src/material.h:16-81)
    on given draws. Scattered rays keep the incident ray's time; the
    caller threads it through."""
    idx = rec.idx.long()
    mat = scene.mat_type.index_select(0, idx)
    albedo = scene.albedo.index_select(0, idx)
    fuzz = scene.fuzz.index_select(0, idx)
    ior = scene.ior.index_select(0, idx)

    unit_dir = normalize(in_direction, eps=1e-12)

    # lambertian (src/material.h:19-25): normal + random unit vector. The
    # reference omits the near_zero degenerate fix; so does this.
    lam_dir = rec.normal + draws.unit

    # metal (src/material.h:36-41): mirror of the *unit* incident direction
    # + fuzz * point in the unit ball; absorbed if it leaves the hemisphere
    reflected = reflect(unit_dir, rec.normal)
    metal_dir = reflected + fuzz[..., None] * draws.ball
    metal_ok = dot(metal_dir, rec.normal) > 0.0

    # dielectric (src/material.h:55-71): refract unless total internal
    # reflection or Schlick says reflect; attenuation (1, 1, 1)
    ratio = torch.where(rec.front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp_max(dot(-unit_dir, rec.normal), 1.0)
    # grad-safe sqrt at cos == 1 (head-on rays): double where
    s2 = 1.0 - cos_theta * cos_theta
    s2_pos = s2 > 0.0
    sin_theta = torch.where(s2_pos, torch.sqrt(torch.where(s2_pos, s2, 1.0)), 0.0)
    cannot_refract = ratio * sin_theta > 1.0
    reflect_prob = schlick_reflectance(cos_theta, ratio)
    do_reflect = cannot_refract | (reflect_prob > draws.uniform)
    diel_dir = torch.where(do_reflect[..., None], reflected,
                           refract(unit_dir, rec.normal, ratio))

    is_lam = (mat == LAMBERTIAN)[..., None]
    is_metal = (mat == METAL)[..., None]
    direction = torch.where(is_lam, lam_dir, torch.where(is_metal, metal_dir, diel_dir))
    attenuation = torch.where((mat == DIELECTRIC)[..., None], torch.ones_like(albedo), albedo)
    scattered = torch.where(mat == METAL, metal_ok, True)
    return ScatterResult(direction=direction, attenuation=attenuation, scattered=scattered,
                         dielectric_reflected=do_reflect)


def scatter(generator: torch.Generator, in_direction: torch.Tensor, rec: HitRecord,
            scene: Scene) -> ScatterResult:
    """`scatter_from_draws` on draws from `generator` (which lives on the
    rays' device)."""
    draws = draw_scatter(generator, rec.t.shape, in_direction.dtype)
    return scatter_from_draws(draws, in_direction, rec, scene)
