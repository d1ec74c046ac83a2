"""The megakernel's random numbers: Philox-4x32-10, specified once.

The TPU kernel seeds the core's hardware PRNG per (seed, tile)
(raytracingproject_tpu/ops/pallas/megakernel.py:61-87, :571). A card has
no such unit, so the port uses a counter-based generator: Philox-4x32-10
(Salmon et al., SC'11, the generator of Random123 and cuRAND), keyed by
(seed, 0) with counter (global ray slot, bounce, 0, 0). One call gives the
four 32-bit words one bounce consumes, in the TPU kernel's order:

  word 0 -> `unit_vector`'s z     (megakernel.py:76)
  word 1 -> `unit_vector`'s theta (megakernel.py:78)
  word 2 -> `ball_radius`         (megakernel.py:86)
  word 3 -> the Schlick draw      (megakernel.py:689)

A uniform is (bits >> 8) * 2^-24. Keying by the global ray slot makes the
draws independent of the kernel's block size.

`philox4x32_10` below is the plain PyTorch version: int64 tensors, each
32x32-bit product split into 16-bit halves so nothing overflows, every
result masked to 32 bits. csrc/megakernel.cu computes the same words with
`__umulhi`; the two must agree bit for bit.
"""

from __future__ import annotations

import math

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
MASK32 = 0xFFFFFFFF
INV_2_24 = 1.0 / (1 << 24)


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product m * x, with x an int64
    tensor of 32-bit values. m * (x >> 16) < 2^48, so no step overflows."""
    p = m * (x >> 16)
    s = ((p & 0xFFFF) << 16) + m * (x & 0xFFFF)
    return ((p >> 16) + (s >> 32)) & MASK32, s & MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox-4x32 rounds on int64 tensors of 32-bit counter words."""
    k0 &= MASK32
    k1 &= MASK32
    for rnd in range(10):
        if rnd:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bounce_bits(seed: int, ray: torch.Tensor, bounce: int):
    """The four 32-bit words (int64 tensors) of `bounce` for ray slots
    `ray` (int64 tensor)."""
    c1 = torch.full_like(ray, bounce & MASK32)
    zero = torch.zeros_like(ray)
    return philox4x32_10(ray & MASK32, c1, zero, zero, seed, 0)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """U[0,1) float32 from the top 24 bits (megakernel.py:67)."""
    return (bits >> 8).to(torch.float32) * INV_2_24


def bounce_uniforms(seed: int, ray: torch.Tensor, bounce: int,
                    zero_draws: bool = False) -> list[torch.Tensor]:
    """The four float32 uniforms of one bounce. `zero_draws` makes every
    uniform 0.0, which is what the TPU interpreter's PRNG gives."""
    if zero_draws:
        z = torch.zeros(ray.shape, dtype=torch.float32, device=ray.device)
        return [z, z, z, z]
    return [bits_to_uniform(b) for b in bounce_bits(seed, ray, bounce)]


def unit_vector(u1: torch.Tensor, u2: torch.Tensor):
    """Uniform directions on S^2 by the cylinder map (megakernel.py:70-79):
    z = 2*u1 - 1, azimuth 2*pi*u2."""
    z = 2.0 * u1 - 1.0
    s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    th = (2.0 * math.pi) * u2
    return s * torch.cos(th), s * torch.sin(th), z


def ball_radius(u3: torch.Tensor) -> torch.Tensor:
    """Radius of a uniform point in the unit ball, u^(1/3), computed as
    exp(log(max(u, 1e-30)) / 3) (megakernel.py:82-87)."""
    return torch.exp(torch.log(torch.clamp_min(u3, 1e-30)) * (1.0 / 3.0))
