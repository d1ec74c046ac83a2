"""Inverse rendering through the oracle renderer (counterpart of
raytracingproject_tpu/grad/inverse.py).

`SceneParams` holds the six differentiable fields of a `Scene` in the JAX
package's field order; `extract_params` and `apply_params` move between
the two. `render_loss` is the pixel loss of an oracle render
(`render.render_pass` with `use_megakernel=False`), and `make_train_step`
differentiates it with PyTorch autograd: the reverse mode through the
whole bounce loop. (grad/fast.py trains through the recording megakernel
and the path replay instead, with far less memory.)

Gradient formulation, as in the JAX package: hit distances are smooth
functions of the geometry (the winner's quadratic root), so shading and
position gradients flow exactly; discrete topology (which sphere is hit,
refract or reflect, metal absorption, hit or miss) is piecewise constant
and contributes no gradient. Silhouette gradients are therefore omitted.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from raytracingproject_tpu_torch.config import resolve_device
from raytracingproject_tpu_torch.render import render_pass
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


def render_loss(
    params: SceneParams,
    scene: Scene,
    cam_derived,
    generator: torch.Generator | None,
    target: torch.Tensor,  # [H, W, 3] linear radiance
    *,
    width: int,
    height: int,
    max_depth: int,
    spp_chunk: int,
    ray_uniforms=None,
    path_draws=None,
) -> torch.Tensor:
    """Mean-squared pixel loss between a `spp_chunk`-sample oracle render
    of `scene` at `params` and the target (linear space, before gamma).
    Differentiable in `params`. The draws come from `generator`: the
    camera's, then each bounce's; `ray_uniforms` and `path_draws`
    (render_pass's) replace them."""
    img = render_pass(
        apply_params(scene, params), cam_derived, generator, width=width, height=height,
        max_depth=max_depth, spp_chunk=spp_chunk, use_megakernel=False,
        ray_uniforms=ray_uniforms, path_draws=path_draws,
    ) / spp_chunk
    return torch.mean((img - target) ** 2)


def _optimizer_params(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def apply_updates(optimizer: torch.optim.Optimizer, params: SceneParams, grads: SceneParams,
                  mask: SceneParams) -> None:
    """One optimizer step on the trainable fields of `params`, in place;
    frozen fields are not touched (optax's `set_to_zero` in the JAX
    package). `optimizer` must have been built over exactly those
    tensors."""
    trained = [getattr(params, f) for f in SceneParams._fields if getattr(mask, f)]
    held = _optimizer_params(optimizer)
    if len(held) != len(trained) or any(a is not b for a, b in zip(held, trained)):
        raise ValueError("params are not the tensors the optimizer holds: pass the "
                         "SceneParams returned with the train step or by its last call "
                         "(the optimizer updates them in place)")
    for f in SceneParams._fields:
        if getattr(mask, f):
            getattr(params, f).grad = getattr(grads, f)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def init_train_state(scene: Scene, mask: SceneParams, optimizer, learning_rate: float):
    """(params0, opt_state0): the scene's parameters as fresh leaves, and
    the optimizer over the trainable ones (default: torch.optim.Adam at
    `learning_rate`, with optax.adam's b1, b2 and eps)."""
    params0 = SceneParams(*(x.detach().clone().requires_grad_(True)
                            for x in extract_params(scene)))
    trained = [getattr(params0, f) for f in SceneParams._fields if getattr(mask, f)]
    opt_state0 = (optimizer(trained) if optimizer is not None
                  else torch.optim.Adam(trained, lr=learning_rate))
    return params0, opt_state0


def make_train_step(
    scene: Scene,
    camera,
    optimizer=None,
    *,
    spp: int = 8,
    learning_rate: float = 2e-2,
    trainable: tuple[str, ...] | None = None,
    device=None,
    generator: torch.Generator | None = None,
):
    """Inverse-rendering train step through the oracle renderer
    (make_train_step of the JAX package): autograd through `render_loss`.

    Same conventions as `grad.fast.make_fast_train_step`: `optimizer` is a
    callable from the list of trainable tensors to a torch.optim.Optimizer
    (default Adam); `trainable` restricts updates to a subset of
    SceneParams fields, the rest stay bit-unchanged; the step runs on
    `device`, by default the card (without one it raises: ask for
    device="cpu"), as `render` does (`config.resolve_device`). The scene
    and each step's target are moved there.

    Returns (params0, opt_state0, step) with
    step(params, opt_state, generator, target [H, W, 3]) ->
        (params, opt_state, loss, grads).
    Each step draws the camera rays ([spp, H, W] order) and then every
    bounce's scatter draws from `generator` (default: the one given here,
    else a generator on the device seeded with 0).

    Autograd keeps every bounce's [rays]-sized intermediates until the
    backward: memory grows with rays x depth (grad/fast.py's does not)."""
    mask = trainable_mask(trainable)
    device = resolve_device(device)
    scene = scene.to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    width, height = camera.image_size()
    cam = camera.derive(scene.center0.dtype, device)

    def step(params: SceneParams, opt_state, gen: torch.Generator | None, target):
        loss = render_loss(params, scene, cam, generator if gen is None else gen,
                           target.to(device),
                           width=width, height=height, max_depth=camera.max_depth,
                           spp_chunk=spp)
        grads = SceneParams(*(
            torch.zeros_like(p) if g is None else g
            for p, g in zip(params, torch.autograd.grad(loss, list(params), allow_unused=True))))
        apply_updates(opt_state, params, grads, mask)
        return params, opt_state, loss.detach(), grads

    params0, opt_state0 = init_train_state(scene, mask, optimizer, learning_rate)
    return params0, opt_state0, step
