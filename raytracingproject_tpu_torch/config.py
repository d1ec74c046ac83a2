"""Configuration dataclasses (counterpart of raytracingproject_tpu/config.py).

`RenderSettings` keeps the JAX package's fields and defaults, with three
exceptions:

- `dtype` is a torch dtype: the oracle loop's working type (camera rays,
  bounce loop, accumulator); the megakernel computes and returns float32
  whatever it says, as the JAX package's megakernel does;
- `device` is added: the device the render runs on;
- `use_megakernel` and `use_bvh` default to True: the port renders on the
  megakernel (K1 with the brute K2 or the front-culled K3 closest hit)
  unless asked for the oracle loop, the JAX package's default
  (`use_megakernel=False`; with `use_pallas` its closest hit is the fused
  kernel K4, with `use_bvh` alone the per-ray BVH walk).

The last deviation is deliberate and pinned by
tests/test_torch_session.py: the port's callers rely on the megakernel
default, so a caller that wants the JAX package's render passes
`RenderSettings(use_megakernel=False, use_bvh=False)`.
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


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the one asked for, else the card.
    The port's entry points run on the card unless the caller asks for the
    CPU (the kernels' plain PyTorch versions): without a card, None and
    "cuda" raise, and the error names device="cpu"."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available, and the port runs on the card unless "
                           'asked otherwise: pass device="cpu" (the CLI: --device cpu) for '
                           "the kernels' plain PyTorch versions on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Renderer settings (reference: src/common_objects.h:9-15)."""

    max_frames_in_flight: int = 2
    max_images: int = 2
    width: int = 1024
    height: int = 768
    sphere_count: int = 20

    # The oracle loop's working type (use_megakernel=False): its camera
    # rays, bounces and accumulator. The megakernel ignores it: float32.
    dtype: torch.dtype = torch.float32
    # Device of the render: "cuda" runs the hand-written kernels and raises
    # when there is no card; "cpu" runs their plain PyTorch versions. None
    # is "cuda" (`resolve_device`): the CPU only when asked for.
    device: str | torch.device | None = None
    # Rays per sample chunk; pixels*spp are chunked to this size.
    rays_per_batch: int = 1 << 17
    # The oracle loop's fused closest-hit kernel (K4); needs
    # use_megakernel=False and wins over the BVH walk.
    use_pallas: bool = False
    # Whole bounce loop in one kernel (K1). False renders on the oracle
    # loop (render.ray_color), the path autograd differentiates.
    use_megakernel: bool = True
    # With the megakernel: front-culled closest hit (K3) instead of the
    # brute scan (K2). With the oracle loop: the per-ray BVH walk instead
    # of the brute scan.
    use_bvh: bool = True
    # Max primitives per BVH leaf; the megakernel raises it to 8.
    bvh_leaf_size: int = 4
    # Kept for parity with the JAX settings; the port synchronises only at
    # the end of a render (and once a bounce for the oracle's early exit).
    sync_every: int = 4
    # Depth-tail pipelines on the megakernel (K6, ops/cuda/depth_tail.py):
    # trace in segments of `depth_segment` bounces with the live rays packed
    # between them, or `two_phase` bounces for every ray, one packing, then
    # the rest. Unused with bvh= and at or past max_depth.
    depth_segment: int | None = None
    two_phase: int | None = None

    def resolved_device(self) -> torch.device:
        return resolve_device(self.device)
