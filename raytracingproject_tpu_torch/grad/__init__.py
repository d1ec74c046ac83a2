"""Differentiable rendering: parameter packing, the oracle's reverse mode,
path replay and the fast inverse-rendering train step (counterpart of
raytracingproject_tpu/grad).

The state a train step carries is `SceneParams` (the six differentiable
scene fields) and, on the fast path between the forward and the backward,
`PathResiduals` (the recorded path decisions). `render_loss` and
`make_train_step` differentiate the oracle renderer with autograd;
`make_fast_train_step` records with the megakernel and differentiates the
replay; `make_fast_geometry_train_step` does the same over a front whose
tables a FrontRefresher rebuilds every step, so centres and radii train on
the culled kernel; `make_soft_train_step` differentiates the smoothed
primary visibility of `soft_primary_radiance` (silhouette gradients);
`xla_trace_record` records with the oracle.
"""

from raytracingproject_tpu_torch.grad.edge import make_soft_train_step, soft_primary_radiance
from raytracingproject_tpu_torch.grad.fast import (
    GEOMETRY_FIELDS,
    make_fast_geometry_train_step,
    make_fast_radiance,
    make_fast_radiance_dynamic_front,
    make_fast_radiance_twophase,
    make_fast_train_step,
)
from raytracingproject_tpu_torch.grad.inverse import (
    SceneParams,
    apply_params,
    extract_params,
    make_train_step,
    render_loss,
    trainable_mask,
)
from raytracingproject_tpu_torch.grad.replay import (
    DEAD, MISS, PathResiduals, PathResidualsP, replay_radiance, replay_radiance_twophase,
    xla_trace_record,
)

__all__ = [
    "SceneParams",
    "extract_params",
    "apply_params",
    "render_loss",
    "make_train_step",
    "trainable_mask",
    "PathResiduals",
    "PathResidualsP",
    "MISS",
    "DEAD",
    "replay_radiance",
    "replay_radiance_twophase",
    "xla_trace_record",
    "GEOMETRY_FIELDS",
    "make_fast_radiance",
    "make_fast_radiance_twophase",
    "make_fast_train_step",
    "make_fast_radiance_dynamic_front",
    "make_fast_geometry_train_step",
    "soft_primary_radiance",
    "make_soft_train_step",
]
