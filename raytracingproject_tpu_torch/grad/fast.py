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
refused by make_fast_train_step. Geometry trains on the front through
`make_fast_geometry_train_step`, whose tables a FrontRefresher rebuilds
from the current parameters every step (`make_fast_radiance_dynamic_front`
takes them per call). `bvh` is how materials are trained on scenes past
the front's shared-memory budget (the BVH-walking recording kernel, K5's
bvh core).
Materials are read afresh on every forward (`front_with_params`),
so a materials-only step with a front renders with the current albedo,
fuzz and ior. (The JAX package's front forward reads the table copied at
build time instead.)

`make_fast_radiance_twophase` is the same with the two-phase pipeline
(ops/cuda/depth_tail.py): K6 forward, and a replay whose depth tail runs
over the packed survivors only (`replay_radiance_twophase`).
"""

from __future__ import annotations

import warnings
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
    FrontRefresher, FrontTables, bvh_tables, front_with_params, trace_record,
)
from raytracingproject_tpu_torch.scene import Scene
from raytracingproject_tpu_torch.utils.profiling import span, sync

GEOMETRY_FIELDS = ("center0", "center_delta", "radius")


class _Config(NamedTuple):
    scene: Scene
    max_depth: int
    bvh: object
    replay_groups: int
    replay_skip_dead: bool | None
    zero_draws: bool
    tracer: Callable


class _FastRadiance(torch.autograd.Function):
    """forward = trace_record (over `front` when given), backward =
    autograd through replay_radiance on the recorded residuals (the custom
    VJP of the JAX package)."""

    @staticmethod
    def forward(ctx, cfg: _Config, front: FrontTables | None, origin, direction, time,
                seed: int, *leaves):
        with span("rtp.fit.record"):
            scene = apply_params(cfg.scene, SceneParams(*leaves))
            front = None if front is None else front_with_params(front, scene)
            rad, res = cfg.tracer(origin, direction, time, scene, seed, cfg.max_depth,
                                  front=front, zero_draws=cfg.zero_draws, bvh=cfg.bvh)
        ctx.save_for_backward(origin, direction, time, *leaves)
        ctx.cfg = cfg
        ctx.res = res
        return rad

    @staticmethod
    def backward(ctx, g):
        with span("rtp.fit.replay"):
            origin, direction, time, *leaves = ctx.saved_tensors
            cfg = ctx.cfg
            grads = _replay_grads(
                lambda params: replay_radiance(params, cfg.scene, origin, direction, time,
                                               ctx.res, n_groups=cfg.replay_groups,
                                               skip_dead=cfg.replay_skip_dead),
                leaves, ctx.needs_input_grad[6:], g)
        return (None, None, None, None, None, None, *grads)


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
    cfg = _Config(scene, max_depth, bvh, replay_groups, replay_skip_dead, zero_draws, tracer)

    def radiance_fn(params: SceneParams, origin, direction, time, seed: int):
        return _FastRadiance.apply(cfg, front, origin, direction, time, int(seed), *params)

    return radiance_fn


def make_fast_radiance_dynamic_front(scene: Scene, max_depth: int, replay_groups: int = 1,
                                     replay_skip_dead: bool | None = None,
                                     zero_draws: bool = False, tracer: Callable = trace_record):
    """make_fast_radiance with the front tables as an argument of each call
    (make_fast_radiance_dynamic_front of the JAX package, grad/fast.py:168-232):
    radiance_fn(params, origin, direction, time, seed, front) -> [R, 3].

    The geometry-training path: the caller refreshes the tables from the
    current parameters every step (ops.cuda.megakernel.FrontRefresher), so
    the culling bounds are exact for the geometry being differentiated.
    `scene` is in its original order and `front.remap` must map the
    padded columns to that order, as a refreshed front's does
    (`remap_order` "scene"); `front_tables`' fronts, which map to leaf
    order, are refused. The tables get no gradient: the replay backward
    re-derives every sphere attribute from `params`. The other arguments
    are make_fast_radiance's."""
    cfg = _Config(scene, max_depth, None, replay_groups, replay_skip_dead, zero_draws, tracer)

    def radiance_fn(params: SceneParams, origin, direction, time, seed: int,
                    front: FrontTables):
        if not isinstance(front, FrontTables) or front.remap_order != "scene":
            raise ValueError(
                "the dynamic-front radiance takes a FrontTables whose remap maps to the "
                "original scene order (FrontRefresher.refresh / refresh_device); "
                "front_tables' remap maps to BVH leaf order")
        return _FastRadiance.apply(cfg, front, origin, direction, time, int(seed), *params)

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


def refuse_trainable_geometry(trainable: tuple[str, ...] | None) -> None:
    """Raise if any of GEOMETRY_FIELDS trains: a front or a BVH is built
    over fixed geometry, and its boxes would go stale."""
    geo = set(GEOMETRY_FIELDS if trainable is None else trainable) & set(GEOMETRY_FIELDS)
    if geo:
        raise ValueError(
            f"bvh/front snapshot FIXED geometry but {sorted(geo)} are trainable; train "
            "materials only, train geometry with make_fast_geometry_train_step("
            "refresher=FrontRefresher(...)), or pass bvh=None and front=None (the brute "
            "recording forward)")


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
        refuse_trainable_geometry(trainable)
    mask = trainable_mask(trainable)
    device = resolve_device(device)
    scene = scene.to(device)
    if front is not None:
        front = front.to(device)
    if bvh is not None:
        bvh = bvh_tables(bvh, device)
    if two_phase is not None:
        radiance_fn = make_fast_radiance_twophase(scene, camera.max_depth, cut=two_phase,
                                                  cap_frac=cap_frac, front=front)
    else:
        radiance_fn = make_fast_radiance(scene, camera.max_depth, front=front, bvh=bvh,
                                         replay_groups=replay_groups,
                                         replay_skip_dead=replay_skip_dead)
    step = _make_step(scene, camera, spp, mask, device, generator, radiance_fn)
    params0, opt_state0 = init_train_state(scene, mask, optimizer, learning_rate)
    return params0, opt_state0, step


def _make_step(scene: Scene, camera, spp: int, mask: SceneParams, device: torch.device,
               generator: torch.Generator | None, radiance_fn: Callable) -> Callable:
    """step(params, opt_state, gen, target, *extra) of the fast train
    steps: draws the camera rays ([spp, H, W] order) and then the path
    seed from `gen` (None: `generator`, else a generator on `device` seeded
    with 0), takes the mean-squared loss of
    radiance_fn(params, o, d, t, seed, *extra) against `target`, and
    applies the optimizer to the fields `mask` trains."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    width, height = camera.image_size()
    dtype = scene.center0.dtype
    cam = camera.derive(dtype, device)
    pix = torch.arange(height * width, device=device).repeat(spp)
    i_idx = (pix % width).to(torch.int32)
    j_idx = (pix // width).to(torch.int32)

    def step(params: SceneParams, opt_state, gen: torch.Generator | None, target, *extra):
        with span("rtp.fit.step"):
            gen = generator if gen is None else gen
            o, d, t = rays_from_uniforms(
                cam, i_idx, j_idx, *camera_uniforms(pix.shape[0], gen, device, dtype))
            drawn = torch.randint(0, 2**31 - 1, (1,), generator=gen, device=gen.device)
            with sync("rtp.sync.seed"):
                seed = int(drawn)
            rad = radiance_fn(params, o, d, t, seed, *extra)
            img = rad.reshape(spp, height, width, 3).mean(dim=0)
            loss = torch.mean((img - target.to(device)) ** 2)
            grads = SceneParams(*torch.autograd.grad(loss, list(params)))
            with span("rtp.fit.adam"):
                apply_updates(opt_state, params, grads, mask)
            return params, opt_state, loss.detach(), grads

    return step


def make_fast_geometry_train_step(
    scene: Scene,
    camera,
    optimizer=None,
    *,
    refresher: FrontRefresher | None = None,
    spp: int = 8,
    learning_rate: float = 2e-2,
    trainable: tuple[str, ...] | None = None,
    replay_groups: int = 1,
    replay_skip_dead: bool | None = None,
    device=None,
    generator: torch.Generator | None = None,
):
    """Geometry-capable fast training on the front-culled recording
    kernel, its tables refreshed every step (make_fast_geometry_train_step
    of the JAX package, grad/fast.py:235-343).

    `scene` is in its original order (never reordered). With `refresher`
    (a FrontRefresher over `scene`): step(params, opt_state, gen, target)
    refreshes the tables from the current parameters on the device
    (`refresh_device`, under no_grad: the counterpart of the JAX package's
    stop_gradient(refresh_in_jit(params))) and then traces over them.
    Without it: step(params, opt_state, gen, target, front), the caller
    passing fresh tables every step (e.g. refresher.refresh(params)); the
    constructor warns when geometry fields are trainable. Either way the
    culling bounds are exact for the geometry being differentiated.

    Optimizer, `trainable`, device, generator and the draws of each step
    are make_fast_train_step's: given the same generator seed, this step
    and the brute make_fast_train_step see the same rays and Philox seed.
    Returns (params0, opt_state0, step)."""
    mask = trainable_mask(trainable)
    device = resolve_device(device)
    scene = scene.to(device)
    radiance_fn = make_fast_radiance_dynamic_front(scene, camera.max_depth,
                                                   replay_groups=replay_groups,
                                                   replay_skip_dead=replay_skip_dead)
    if refresher is not None:
        refresher = refresher.to(device)

        def refreshed_radiance(params: SceneParams, o, d, t, seed: int):
            with torch.no_grad():
                front = refresher.refresh_device(SceneParams(*(x.detach() for x in params)))
            return radiance_fn(params, o, d, t, seed, front)

        step = _make_step(scene, camera, spp, mask, device, generator, refreshed_radiance)
    else:
        geo = set(GEOMETRY_FIELDS if trainable is None else trainable) & set(GEOMETRY_FIELDS)
        if geo:
            warnings.warn(
                "make_fast_geometry_train_step without a refresher: the caller MUST pass "
                "fresh front tables every step (e.g. refresher.refresh(params)); reusing one "
                f"front while {sorted(geo)} train gives silently wrong culling/gradients. "
                "Prefer passing refresher= for the on-device refresh.",
                stacklevel=2,
            )
        inner = _make_step(scene, camera, spp, mask, device, generator, radiance_fn)

        def step(params: SceneParams, opt_state, gen: torch.Generator | None, target,
                 front: FrontTables):
            return inner(params, opt_state, gen, target, front.to(device))

    params0, opt_state0 = init_train_state(scene, mask, optimizer, learning_rate)
    return params0, opt_state0, step
