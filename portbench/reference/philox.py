"""The path tracer's random numbers, frozen: Philox-4x32-10 keyed by
(seed, 0), counter (ray slot, bounce, 0, 0), one call a bounce giving the
four uniforms the bounce consumes (unit vector z, unit vector azimuth,
ball radius, the Schlick draw). A uniform is (bits >> 8) * 2^-24.

Plain PyTorch on int64 tensors: each 32x32-bit product is split into
16-bit halves so nothing overflows, every result masked to 32 bits.
"""

from __future__ import annotations

import math

import torch

M0 = 0xD2511F53
M1 = 0xCD9E8D57
W0 = 0x9E3779B9
W1 = 0xBB67AE85
MASK32 = 0xFFFFFFFF
INV_2_24 = 1.0 / (1 << 24)


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    p = m * (x >> 16)
    s = ((p & 0xFFFF) << 16) + m * (x & 0xFFFF)
    return ((p >> 16) + (s >> 32)) & MASK32, s & MASK32


def philox(c0, c1, c2, c3, k0, k1):
    """Ten Philox-4x32 rounds on int64 tensors of 32-bit words; the key
    words are ints or int64 tensors."""
    k0 = k0 & MASK32
    k1 = k1 & MASK32
    for rnd in range(10):
        if rnd:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bounce_uniforms(seed, slot: torch.Tensor, bounce: int) -> list[torch.Tensor]:
    """The four float32 uniforms of `bounce` for the ray slots `slot`
    (int64 tensor), keyed by `seed` (an int, or an int64 tensor a ray)."""
    zero = torch.zeros_like(slot)
    words = philox(slot & MASK32, torch.full_like(slot, bounce & MASK32), zero, zero, seed, 0)
    return [(w >> 8).to(torch.float32) * INV_2_24 for w in words]


def unit_vector(u1: torch.Tensor, u2: torch.Tensor):
    """Uniform direction on the sphere by the cylinder map."""
    z = 2.0 * u1 - 1.0
    s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    th = (2.0 * math.pi) * u2
    return s * torch.cos(th), s * torch.sin(th), z


def ball_radius(u3: torch.Tensor) -> torch.Tensor:
    """Radius of a uniform point in the unit ball, u^(1/3)."""
    return torch.exp(torch.log(torch.clamp_min(u3, 1e-30)) * (1.0 / 3.0))
