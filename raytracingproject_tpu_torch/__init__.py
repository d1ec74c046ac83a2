"""raytracingproject_tpu_torch — the path tracer on PyTorch and CUDA.

A port of `raytracingproject_tpu` (JAX, XLA and Pallas on a TPU), which
stays in the repository as the reference. Plain tensor code is PyTorch;
every Pallas kernel of the ported paths is hand-written CUDA for Hopper
(`csrc/`), with a plain PyTorch version beside it that runs on the CPU.
This package never imports jax.

So far four paths run end to end. Serving: scenes, camera, BVH and front
tables, the megakernel (bounce loop with brute or front-culled closest
hit), `render`, `render_image` and the CLI
(`python -m raytracingproject_tpu_torch`). Training: the fast
inverse-rendering step (`grad.fast.make_fast_train_step`), with the
recording megakernel forward and the path-replay backward. The oracle:
the differentiable bounce loop (`render.ray_color`, reached with
`RenderSettings(use_megakernel=False)`; `use_pallas=True` takes its
closest hit from the fused kernel), and the reverse-mode train step
through it (`grad.make_train_step`). Large scenes: past the card's
shared memory `render` takes the front with its spheres in global memory,
`bvh=` the BVH-walking kernel (`render_pass`, `make_fast_train_step`), and
the brute scan stages its table in chunks.
"""

from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import (
    DIELECTRIC, LAMBERTIAN, METAL, RenderSettings,
)
from raytracingproject_tpu_torch.render import render, render_image
from raytracingproject_tpu_torch.scene import Scene, SceneBuilder, make_cover_scene

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Scene",
    "SceneBuilder",
    "make_cover_scene",
    "RenderSettings",
    "LAMBERTIAN",
    "METAL",
    "DIELECTRIC",
    "render",
    "render_image",
    "__version__",
]
