"""Inverse rendering: the scene's differentiable parameters (counterpart of
raytracingproject_tpu/grad/inverse.py).

`SceneParams` holds the six differentiable fields of a `Scene` in the JAX
package's field order; `extract_params` and `apply_params` move between
the two. The reverse mode through the full XLA-style renderer
(`render_loss`, `make_train_step`) needs the differentiable oracle, which
is not ported yet (ROADMAP P2); the fast path (grad/fast.py) trains
through the recording megakernel and the path replay instead.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from raytracingproject_tpu_torch.scene import Scene


class SceneParams(NamedTuple):
    """The differentiable leaves of a Scene (everything but mat_type)."""

    center0: torch.Tensor       # [N, 3]
    center_delta: torch.Tensor  # [N, 3]
    radius: torch.Tensor        # [N]
    albedo: torch.Tensor        # [N, 3]
    fuzz: torch.Tensor          # [N]
    ior: torch.Tensor           # [N]


def extract_params(scene: Scene) -> SceneParams:
    return SceneParams(
        center0=scene.center0,
        center_delta=scene.center_delta,
        radius=scene.radius,
        albedo=scene.albedo,
        fuzz=scene.fuzz,
        ior=scene.ior,
    )


def apply_params(scene: Scene, params: SceneParams) -> Scene:
    return dataclasses.replace(scene, **params._asdict())


def trainable_mask(trainable) -> SceneParams:
    """Boolean SceneParams mask selecting which fields receive updates.
    `trainable=None` trains everything."""
    fields = SceneParams._fields if trainable is None else tuple(trainable)
    unknown = set(fields) - set(SceneParams._fields)
    if unknown:
        raise ValueError(f"unknown trainable fields: {sorted(unknown)}")
    return SceneParams(**{f: f in fields for f in SceneParams._fields})


def _needs_oracle(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} differentiates the XLA-style renderer, which is not ported to the "
        "PyTorch package yet (ROADMAP P2, the differentiable oracle); use "
        "grad.fast.make_fast_train_step")


def render_loss(*args, **kwargs) -> torch.Tensor:
    """Mean-squared pixel loss of an oracle render (raises until P2)."""
    raise _needs_oracle("render_loss")


def make_train_step(*args, **kwargs):
    """Inverse-rendering step through the oracle renderer (raises until P2)."""
    raise _needs_oracle("make_train_step")
