"""Fast differentiable rendering: the recording megakernel forward and the
path-replay backward (counterpart of raytracingproject_tpu/grad/fast.py).

  forward  - the megakernel with in-kernel residual recording
             (ops/cuda/megakernel.py `trace_record`, K5 on the card);
  backward - PyTorch autograd through the O(depth)-per-ray path replay
             (grad/replay.py), which never re-intersects the scene.

Gradients flow to SceneParams only; rays and the seed get none (camera
parameters are not trained, as in the JAX package).

A front (FrontTables) or a BVH is built over fixed geometry: its boxes go
stale when centres or radii move, so either with trainable geometry is
refused. `bvh` is how materials are trained on scenes past the front's
shared-memory budget (the BVH-walking recording kernel, K5's bvh core).
Materials are read afresh on every forward (`front_with_params`),
so a materials-only step with a front renders with the current albedo,
fuzz and ior. (The JAX package's front forward reads the table copied at
build time instead.)

`make_fast_radiance_twophase` is the same with the two-phase pipeline
(ops/cuda/depth_tail.py): K6 forward, and a replay whose depth tail runs
over the packed survivors only (`replay_radiance_twophase`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from raytracingproject_tpu_torch.camera import camera_uniforms, rays_from_uniforms
from raytracingproject_tpu_torch.config import resolve_device
from raytracingproject_tpu_torch.grad.inverse import (
    SceneParams, apply_params, apply_updates, init_train_state, trainable_mask,
)
from raytracingproject_tpu_torch.grad.replay import (
    check_gather, replay_radiance, replay_radiance_twophase,
)
from raytracingproject_tpu_torch.ops.cuda.depth_tail import (
    trace_paths_twophase, trace_record_twophase,
)
from raytracingproject_tpu_torch.ops.cuda.megakernel import (
    FrontTables, bvh_tables, front_with_params, trace_record,
)
from raytracingproject_tpu_torch.scene import Scene

GEOMETRY_FIELDS = ("center0", "center_delta", "radius")


class _Config(NamedTuple):
    scene: Scene
    max_depth: int
    front: FrontTables | None
    bvh: object
    replay_groups: int
    replay_skip_dead: bool | None
    zero_draws: bool
    tracer: Callable


class _FastRadiance(torch.autograd.Function):
    """forward = trace_record, backward = autograd through replay_radiance
    on the recorded residuals (the custom VJP of the JAX package)."""

    @staticmethod
    def forward(ctx, cfg: _Config, origin, direction, time, seed: int, *leaves):
        scene = apply_params(cfg.scene, SceneParams(*leaves))
        front = None if cfg.front is None else front_with_params(cfg.front, scene)
        rad, res = cfg.tracer(origin, direction, time, scene, seed, cfg.max_depth,
                              front=front, zero_draws=cfg.zero_draws, bvh=cfg.bvh)
        ctx.save_for_backward(origin, direction, time, *leaves)
        ctx.cfg = cfg
        ctx.res = res
        return rad

    @staticmethod
    def backward(ctx, g):
        origin, direction, time, *leaves = ctx.saved_tensors
        cfg = ctx.cfg
        grads = _replay_grads(
            lambda params: replay_radiance(params, cfg.scene, origin, direction, time, ctx.res,
                                           n_groups=cfg.replay_groups,
                                           skip_dead=cfg.replay_skip_dead),
            leaves, ctx.needs_input_grad[5:], g)
        return (None, None, None, None, None, *grads)


def _replay_grads(replay: Callable, leaves, needs, g) -> list:
    """The backward of a fast radiance: gradients of `g`-weighted
    `replay(params)` for the leaves that need one, None for the others."""
    grads = [None] * len(leaves)
    if not any(needs):
        return grads
    with torch.enable_grad():
        params = SceneParams(*(x.detach().requires_grad_(n) for x, n in zip(leaves, needs)))
        rad = replay(params)
        wanted = [k for k, n in enumerate(needs) if n]
        # a replay that reaches no parameter (every path misses at once) has
        # no graph: its gradient is zero
        got = (torch.autograd.grad(rad, [params[k] for k in wanted], g, allow_unused=True)
               if rad.requires_grad else [None] * len(wanted))
    for k, gk in zip(wanted, got):
        grads[k] = torch.zeros_like(leaves[k]) if gk is None else gk
    return grads


def make_fast_radiance(scene: Scene, max_depth: int, front: FrontTables | None = None,
                       replay_groups: int = 1, replay_skip_dead: bool | None = None,
                       zero_draws: bool = False, tracer: Callable = trace_record, bvh=None):
    """radiance_fn(params, origin, direction, time, seed) -> [R, 3], with
    the recording-megakernel forward and the replay backward.

    `scene` supplies the non-differentiable topology (mat_type, sphere
    order); with `front` or `bvh` (a FlatBVH over it, or `bvh_tables` of
    one; `front` wins) it must already be in BVH leaf order
    (bvh.reorder_scene) and `params` in the same order. `seed` is a plain
    int (the Philox key). `zero_draws` makes every draw 0.0, the TPU
    interpreter's PRNG. `replay_groups` and `replay_skip_dead` are
    replay_radiance's `n_groups` and `skip_dead`. `tracer` is the recording
    forward (the kernel wrapper; a check may pass its plain version,
    `trace_record_twin`, to hold the kernel against it on the card)."""
    cfg = _Config(scene, max_depth, front, bvh, replay_groups, replay_skip_dead, zero_draws,
                  tracer)

    def radiance_fn(params: SceneParams, origin, direction, time, seed: int):
        return _FastRadiance.apply(cfg, origin, direction, time, int(seed), *params)

    return radiance_fn


class _TwoPhaseConfig(NamedTuple):
    scene: Scene
    max_depth: int
    cut: int
    cap_frac: float
    front: FrontTables | None
    zero_draws: bool
    tracer: Callable
    recorder: Callable


class _FastRadianceTwoPhase(torch.autograd.Function):
    """forward = trace_paths_twophase, or trace_record_twophase when a
    gradient will be asked for; backward = autograd through
    replay_radiance_twophase (the custom VJP of the JAX package's
    make_fast_radiance_twophase)."""

    @staticmethod
    def forward(ctx, cfg: _TwoPhaseConfig, record: bool, origin, direction, time, seed: int,
                *leaves):
        scene = apply_params(cfg.scene, SceneParams(*leaves))
        front = None if cfg.front is None else front_with_params(cfg.front, scene)
        kw = dict(front=front, zero_draws=cfg.zero_draws)
        if not record:
            return cfg.tracer(origin, direction, time, scene, seed, cfg.max_depth,
                              cuts=(cfg.cut,), **kw)
        rad, *ctx.rec = cfg.recorder(origin, direction, time, scene, seed, cfg.max_depth,
                                     cut=cfg.cut, **kw)
        ctx.save_for_backward(origin, direction, time, *leaves)
        ctx.cfg = cfg
        return rad

    @staticmethod
    def backward(ctx, g):
        origin, direction, time, *leaves = ctx.saved_tensors
        cfg = ctx.cfg
        res1 = ctx.rec[0]
        cap = max(1, int(round(res1.idx.shape[1] * cfg.cap_frac)))
        grads = _replay_grads(
            lambda params: replay_radiance_twophase(params, cfg.scene, origin, direction, time,
                                                    *ctx.rec, cap_rays=cap),
            leaves, ctx.needs_input_grad[6:], g)
        return (None, None, None, None, None, None, *grads)


def make_fast_radiance_twophase(scene: Scene, max_depth: int, cut: int = 4,
                                cap_frac: float = 0.25, front: FrontTables | None = None,
                                zero_draws: bool = False,
                                tracer: Callable = trace_paths_twophase,
                                recorder: Callable = trace_record_twophase):
    """make_fast_radiance with the two-phase pipeline
    (make_fast_radiance_twophase of the JAX package, grad/fast.py:102-165):

    - forward: `trace_paths_twophase` (bounces [0, cut) for every ray, one
      compaction, the tail on packed rays), or `trace_record_twophase`,
      the same with each phase's residuals, when a gradient is wanted;
    - backward: `replay_radiance_twophase`: `cut` bounces for every ray,
      then the tail over a survivor capacity of `cap_frac` of the padded
      ray count, or the full width when the survivors overflow it, so the
      gradient is always exact.

    The pipelines key their random numbers as the monolithic kernel does,
    so the radiance and gradients equal make_fast_radiance's for the same
    rays and seed (up to the front's last-ulp ties). `front`: a
    FrontTables over `scene` in leaf order, as for make_fast_radiance.
    `tracer` and `recorder` are the forward pipelines (a check may pass
    their plain versions, `depth_tail.*_twin`)."""
    if not 0 < cut < max_depth:
        raise ValueError(f"two-phase cut {cut} must lie in (0, max_depth {max_depth})")
    cfg = _TwoPhaseConfig(scene, max_depth, cut, cap_frac, front, zero_draws, tracer, recorder)

    def radiance_fn(params: SceneParams, origin, direction, time, seed: int):
        record = torch.is_grad_enabled() and any(x.requires_grad for x in params)
        return _FastRadianceTwoPhase.apply(cfg, record, origin, direction, time, int(seed),
                                           *params)

    return radiance_fn


def make_fast_train_step(
    scene: Scene,
    camera,
    optimizer=None,
    *,
    spp: int = 8,
    learning_rate: float = 2e-2,
    trainable: tuple[str, ...] | None = None,
    front: FrontTables | None = None,
    bvh=None,
    replay_groups: int = 1,
    replay_skip_dead: bool | None = None,
    replay_gather: str | None = None,
    two_phase: int | None = None,
    cap_frac: float = 0.25,
    device=None,
    generator: torch.Generator | None = None,
):
    """Inverse-rendering train step on the fast path (make_fast_train_step
    of the JAX package).

    `front` (FrontTables over `scene`, which must be in BVH leaf order)
    runs the front-culled closest hit in the recording forward: the fast
    path for materials-only training. `bvh` (a FlatBVH over `scene`, in
    leaf order too) runs the BVH walk there instead: the route for scenes
    whose front does not fit shared memory. With either, any of
    GEOMETRY_FIELDS trainable raises (the boxes would be stale).

    `two_phase` (a cut depth, e.g. 4) takes the two-phase pipeline
    (make_fast_radiance_twophase) with survivor capacity `cap_frac`; it
    runs on the brute scan or `front` and refuses `bvh` (K6 has no BVH
    walk), and the replay_* options do not apply to it.

    `optimizer` is a callable that takes the list of trainable tensors and
    returns a torch.optim.Optimizer (default: torch.optim.Adam at
    `learning_rate`, with optax.adam's b1, b2 and eps; PyTorch keeps the
    bias corrections in float64 where optax rounds them to float32, 6e-6
    relative after ten steps). It updates the trainable fields in place;
    frozen fields stay bit-unchanged.

    The step runs on `device`, by default the card (without one it raises:
    ask for device="cpu"), as `render` does (`config.resolve_device`); the
    scene, the front and each step's target are moved there.

    Returns (params0, opt_state0, step) with
    step(params, opt_state, generator, target [H, W, 3]) ->
        (params, opt_state, loss, grads).
    Each step draws the camera rays, in the JAX order [spp, H, W], and
    then the path seed from `generator` (default: the one given here, else
    a generator on `device` seeded with 0)."""
    check_gather(replay_gather)
    if two_phase is not None and bvh is not None:
        raise ValueError("two_phase runs K6, which has no BVH walk: pass front= (a "
                         "FrontTables) or neither")
    if bvh is not None or front is not None:
        geo = set(GEOMETRY_FIELDS if trainable is None else trainable) & set(GEOMETRY_FIELDS)
        if geo:
            raise ValueError(
                f"bvh/front snapshot FIXED geometry but {sorted(geo)} are trainable; train "
                "materials only, or pass bvh=None and front=None for geometry training")
    mask = trainable_mask(trainable)
    device = resolve_device(device)
    scene = scene.to(device)
    if front is not None:
        front = front.to(device)
    if bvh is not None:
        bvh = bvh_tables(bvh, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    width, height = camera.image_size()
    dtype = scene.center0.dtype
    cam = camera.derive(dtype, device)
    if two_phase is not None:
        radiance_fn = make_fast_radiance_twophase(scene, camera.max_depth, cut=two_phase,
                                                  cap_frac=cap_frac, front=front)
    else:
        radiance_fn = make_fast_radiance(scene, camera.max_depth, front=front, bvh=bvh,
                                         replay_groups=replay_groups,
                                         replay_skip_dead=replay_skip_dead)
    pix = torch.arange(height * width, device=device).repeat(spp)
    i_idx = (pix % width).to(torch.int32)
    j_idx = (pix // width).to(torch.int32)

    def loss_fn(params: SceneParams, gen: torch.Generator, target: torch.Tensor):
        o, d, t = rays_from_uniforms(
            cam, i_idx, j_idx, *camera_uniforms(pix.shape[0], gen, device, dtype))
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=gen.device))
        rad = radiance_fn(params, o, d, t, seed)
        img = rad.reshape(spp, height, width, 3).mean(dim=0)
        return torch.mean((img - target) ** 2)

    def step(params: SceneParams, opt_state, gen: torch.Generator | None, target):
        loss = loss_fn(params, generator if gen is None else gen, target.to(device))
        grads = SceneParams(*torch.autograd.grad(loss, list(params)))
        apply_updates(opt_state, params, grads, mask)
        return params, opt_state, loss.detach(), grads

    params0, opt_state0 = init_train_state(scene, mask, optimizer, learning_rate)
    return params0, opt_state0, step
