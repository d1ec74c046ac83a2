"""Configuration dataclasses (counterpart of raytracingproject_tpu/config.py).

`RenderSettings` keeps the JAX package's fields and defaults, with three
exceptions:

- `dtype` is a torch dtype;
- `device` is added: the device the render runs on;
- `use_megakernel` and `use_bvh` default to True. The port's only renderer
  so far is the megakernel (K1 with the brute K2 or the front-culled K3
  closest hit); the XLA-style oracle path arrives with ROADMAP item P2.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# Material type codes for the SoA scene (src/material.h:16-81).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2

# Shadow-acne epsilon: the reference intersects over interval(0.001, inf)
# (src/camera_cpu.h:15).
T_MIN = 1e-3
T_MAX = math.inf


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Renderer settings (reference: src/common_objects.h:9-15)."""

    max_frames_in_flight: int = 2
    max_images: int = 2
    width: int = 1024
    height: int = 768
    sphere_count: int = 20

    dtype: torch.dtype = torch.float32
    # Device of the render: "cuda" runs the hand-written kernels and raises
    # when there is no card; "cpu" runs their plain PyTorch versions. None
    # picks "cuda" when torch.cuda.is_available(), else "cpu".
    device: str | torch.device | None = None
    # Rays per sample chunk; pixels*spp are chunked to this size.
    rays_per_batch: int = 1 << 17
    # The XLA path's fused closest-hit kernel (K4); not ported yet.
    use_pallas: bool = False
    # Whole bounce loop in one kernel (K1). The only renderer of the port.
    use_megakernel: bool = True
    # With the megakernel: front-culled closest hit (K3) instead of the
    # brute scan (K2).
    use_bvh: bool = True
    # Max primitives per BVH leaf; the megakernel raises it to 8.
    bvh_leaf_size: int = 4
    # Kept for parity with the JAX settings; the port synchronises only at
    # the end of a render.
    sync_every: int = 4
    # Depth-tail pipelines (ROADMAP P8); not ported yet.
    depth_segment: int | None = None
    two_phase: int | None = None

    def resolved_device(self) -> torch.device:
        if self.device is None:
            return torch.device("cuda" if torch.cuda.is_available() else "cpu")
        return torch.device(self.device)
