"""raytracingproject_tpu_torch — the path tracer on PyTorch and CUDA.

A port of `raytracingproject_tpu` (JAX, XLA and Pallas on a TPU), which
stays in the repository as the reference. Plain tensor code is PyTorch;
every Pallas kernel of the ported paths is hand-written CUDA for Hopper
(`csrc/`), with a plain PyTorch version beside it that runs on the CPU.
This package never imports jax.

Five paths run end to end. Serving: scenes, camera, BVH and front
tables, the megakernel (bounce loop with brute or front-culled closest
hit), `render`, `render_image`, the CLI (`python -m
raytracingproject_tpu_torch`) and the interactive session
(`RendererSession`, `session.py`). Training: the fast inverse-rendering
step (`grad.fast.make_fast_train_step`), with the recording megakernel
forward and the path-replay backward; geometry on the front-culled
kernel through `grad.fast.make_fast_geometry_train_step`, its tables
refreshed every step by `ops.cuda.megakernel.FrontRefresher`; silhouette
gradients through `grad.edge.make_soft_train_step`. The oracle: the
differentiable bounce loop (`ray_color`, reached with
`RenderSettings(use_megakernel=False)`; `use_pallas=True` takes its
closest hit from the fused kernel), and the reverse-mode train step
through it (`grad.make_train_step`). Large scenes: past the card's
shared memory `render` takes the front with its spheres in global memory,
`bvh=` the BVH-walking kernel (`render_pass`, `make_fast_train_step`), and
the brute scan stages its table in chunks. Sharding: `parallel/`
(`make_mesh`, `render_sharded`, the sharded train steps) on
torch.distributed. The wavefront renderer: `wavefront.py` (a dense ray
pool refilled by stream compaction, `--wavefront` on the CLI). Utilities:
`utils.checkpoint` (resumable renders, training state),
`utils.profiling`, `utils.cache`.
"""

from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import (
    DIELECTRIC, LAMBERTIAN, METAL, RenderSettings,
)
from raytracingproject_tpu_torch.render import ray_color, render, render_image
from raytracingproject_tpu_torch.scene import Scene, SceneBuilder, make_cover_scene
from raytracingproject_tpu_torch.session import RendererSession

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
    "ray_color",
    "RendererSession",
    "__version__",
]
