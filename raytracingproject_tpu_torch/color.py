"""Color pipeline: gamma correction and 8-bit quantization
(reference: src/color.h; counterpart of raytracingproject_tpu/color.py)."""

from __future__ import annotations

import torch


def linear_to_gamma(x: torch.Tensor) -> torch.Tensor:
    """gamma 2: sqrt of the non-negative linear value (src/color.h:9-12)."""
    return torch.sqrt(torch.clamp_min(x, 0.0))


def to_u8(image: torch.Tensor) -> torch.Tensor:
    """`write_color` quantization (src/color.h:14-35): gamma, clamp to
    [0, 0.999], scale by 256, truncate. Input is the per-pixel mean."""
    g = linear_to_gamma(image)
    return (256.0 * torch.clamp(g, 0.0, 0.999)).to(torch.uint8)
