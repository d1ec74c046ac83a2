"""Batched 3-vector math (counterpart of raytracingproject_tpu/ops/vecmath.py;
reference: src/vec3.h).

Vectors are tensors whose last axis has size 3; every function broadcasts
over leading batch axes. The two gradient guards of the JAX package are
kept: `normalize`'s eps sits before the square root, and `refract` takes
the square root through a double `where`.
"""

from __future__ import annotations

import torch

# Degenerate-direction threshold (reference: src/vec3.h:50-54).
NEAR_ZERO_EPS = 1e-8


def dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis (src/vec3.h:105-109)."""
    return torch.sum(u * v, dim=-1)


def cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched cross product (src/vec3.h:111-115)."""
    return torch.linalg.cross(u, v, dim=-1)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v, dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_squared(v))


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """`unit_vector` (src/vec3.h:117-119). `eps` guards 0-length inputs.

    The guard sits before the square root: `max(sqrt(x), eps)` keeps the
    value finite but its gradient is 0 * inf = NaN at x == 0, which
    degenerate recorded scatter directions reach. `max(x, eps^2)` sends the
    zero-length branch's gradient to the constant instead; the values are
    the same (max commutes with the monotone square)."""
    if eps:
        inv = torch.rsqrt(torch.clamp_min(length_squared(v), eps * eps))
        return v * inv[..., None]
    return v / length(v)[..., None]


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """True where the vector is ~zero in all components (src/vec3.h:50-54)."""
    return torch.all(torch.abs(v) < NEAR_ZERO_EPS, dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection v - 2*dot(v,n)*n (src/vec3.h:149-151)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor, etai_over_etat) -> torch.Tensor:
    """Snell refraction of unit vector `uv` about normal `n`
    (src/vec3.h:153-158). `etai_over_etat` broadcasts over batch axes."""
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)
    ratio = torch.as_tensor(etai_over_etat, dtype=uv.dtype, device=uv.device)
    ratio = torch.broadcast_to(ratio, cos_theta.shape)
    r_out_perp = ratio[..., None] * (uv + cos_theta[..., None] * n)
    # Grad-safe sqrt: its derivative at 0 is inf (double where); k == 0
    # means the parallel component vanishes, which the mask gives exactly.
    k = torch.abs(1.0 - length_squared(r_out_perp))
    k_pos = k > 0.0
    sqrt_k = torch.where(k_pos, torch.sqrt(torch.where(k_pos, k, 1.0)), 0.0)
    return r_out_perp - sqrt_k[..., None] * n
