"""Random sampling for the oracle renderer (counterpart of
raytracingproject_tpu/ops/sampling.py; reference: src/vec3.h:121-147).

The same analytic transforms as the JAX package, so the same
distributions:

- unit disk:   r = sqrt(U), angle = 2*pi*U
- unit sphere: a normalised isotropic Gaussian
- unit ball:   a direction uniform on the sphere, radius = cbrt(U)

Every function draws from a `torch.Generator` (on the device of the
result) and returns `shape + (3,)`. The megakernel's own draws (Philox,
the cylinder map) are specified in ops/rng.py and are not these.
"""

from __future__ import annotations

import math

import torch

from raytracingproject_tpu_torch.ops.vecmath import dot


def _rand(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, device=generator.device, dtype=dtype)


def random_in_unit_disk(generator: torch.Generator, shape=(),
                        dtype=torch.float32) -> torch.Tensor:
    """Uniform points in the z = 0 unit disk (src/vec3.h:121-127)."""
    r = torch.sqrt(_rand(generator, shape, dtype))
    theta = _rand(generator, shape, dtype) * (2.0 * math.pi)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1)


def random_unit_vector(generator: torch.Generator, shape=(),
                       dtype=torch.float32) -> torch.Tensor:
    """Uniform directions on the unit sphere (src/vec3.h:137-139)."""
    g = torch.randn((*shape, 3), generator=generator, device=generator.device, dtype=dtype)
    n = torch.linalg.norm(g, dim=-1, keepdim=True)
    return g / torch.clamp_min(n, 1e-12)


def random_in_unit_sphere(generator: torch.Generator, shape=(),
                          dtype=torch.float32) -> torch.Tensor:
    """Uniform points inside the unit ball (src/vec3.h:129-135)."""
    d = random_unit_vector(generator, shape, dtype)
    r = _rand(generator, shape, dtype) ** (1.0 / 3.0)
    return d * r[..., None]


def random_on_hemisphere(generator: torch.Generator, normal: torch.Tensor) -> torch.Tensor:
    """Uniform directions on the hemisphere around `normal` [..., 3]
    (src/vec3.h:141-147)."""
    v = random_unit_vector(generator, normal.shape[:-1], normal.dtype)
    same_side = dot(v, normal) > 0.0
    return torch.where(same_side[..., None], v, -v)
