"""Multi-rank scaling: the mesh, sharded rendering, sharded training
(counterpart of raytracingproject_tpu/parallel) on torch.distributed.

- rays/pixels sharded over the `rays` mesh axis (DP over pixels),
- samples sharded over the `samples` mesh axis (DP over spp),
- scene parameters replicated, gradients all-reduced over the mesh.

One process a rank: NCCL on the cards (one rank a card), gloo on the CPU.
`make_mesh` starts a world of one where no process group exists;
`parallel.launch.run_world` spawns a local world of several ranks.
"""

from raytracingproject_tpu_torch.parallel.mesh import make_mesh, multihost_init
from raytracingproject_tpu_torch.parallel.shard import (
    make_sharded_soft_train_step,
    make_sharded_train_step,
    render_sharded,
)

__all__ = [
    "make_mesh",
    "multihost_init",
    "render_sharded",
    "make_sharded_train_step",
    "make_sharded_soft_train_step",
]
