"""Sharded rendering and training over a mesh of ranks (counterpart of
raytracingproject_tpu/parallel/shard.py).

Layout, as in the JAX package:
- pixels sharded over the `rays` mesh axis: the rank at (ray_id, s_id)
  renders the ray_id-th contiguous slice of the padded pixel list
  (`_pixel_grid`);
- spp sharded over the `samples` axis: each rank renders spp / n_samples
  samples of its slice, and the partial sums are all-reduced over its
  `samples` group;
- the scene and the parameters replicated on every rank.

JAX writes this as one program under `shard_map`, and `jax.grad` gets
the gradient collective as XLA's transpose of it. Here each rank is a
process, the forward collectives are explicit and the backward is that
transpose written out (`_sharded_step`): the radiance sums are reduced
detached, each rank back-propagates its own radiance, and the parameter
gradients are all-reduced over the mesh. A differentiable all-reduce is
not used: its backward all-reduces the cotangent again, which would
multiply every replicated term by the group's size.

Each rank's random numbers come from its own generator,
`shard_generator(draw_base(generator), ray_id, s_id)`: one draw of the
caller's generator (the same on every rank when the callers seed alike)
keys a Philox block at the rank's two mesh coordinates, so a shard's
stream is a pure function of the caller's seed and its place in the mesh
(JAX folds the key with the ray index, then the sample index).

Spans (utils/profiling.py) of a sharded train step: `rtp.shard.step`
holds `rtp.shard.forward` (the shard's radiance), `rtp.shard.reduce.image`
(the image's and the loss's all-reduces), `rtp.shard.backward` (the
shard's backward: the path replay on the fast path), `rtp.shard.reduce.grad`
(the gradients' all-reduces) and `rtp.fit.adam`; every collective counts in
`collectives` and `collective_bytes`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from raytracingproject_tpu_torch.camera import (
    CameraDerived, camera_uniforms, generate_rays, rays_from_uniforms,
)
from raytracingproject_tpu_torch.grad.edge import soft_primary_radiance
from raytracingproject_tpu_torch.grad.fast import (
    make_fast_radiance, make_fast_radiance_twophase, refuse_trainable_geometry,
)
from raytracingproject_tpu_torch.grad.inverse import (
    SceneParams, apply_params, apply_updates, init_train_state, trainable_mask,
)
from raytracingproject_tpu_torch.ops.cuda.megakernel import trace_paths
from raytracingproject_tpu_torch.ops.rng import MASK32, philox4x32_10
from raytracingproject_tpu_torch.parallel.mesh import mesh_device
from raytracingproject_tpu_torch.render import ray_color
from raytracingproject_tpu_torch.scene import Scene
from raytracingproject_tpu_torch.utils.profiling import count, span, sync


def _pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pixel_grid(width: int, height: int, pad_to: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(i, j) int32 [P]: the row-major pixel list padded to a multiple of
    `pad_to` with pixel (0, 0), which padding pixels render again."""
    jj, ii = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    i = ii.reshape(-1).astype(np.int32)
    j = jj.reshape(-1).astype(np.int32)
    pad = _pad_to_multiple(i.size, pad_to) - i.size
    if pad:
        i = np.concatenate([i, np.zeros(pad, np.int32)])
        j = np.concatenate([j, np.zeros(pad, np.int32)])
    return torch.from_numpy(i), torch.from_numpy(j)


def _pad_target(target: torch.Tensor, total: int) -> torch.Tensor:
    """The flat target [total, 3]: padding pixels take pixel (0, 0)'s
    target, so they add a genuine residual to the loss, as in the JAX
    package."""
    flat = target.reshape(-1, 3)
    return torch.cat([flat, flat[:1].expand(total - flat.shape[0], 3)])


def draw_base(generator: torch.Generator) -> int:
    """One draw of the caller's generator: the base every rank derives
    its shard's generator from."""
    drawn = torch.randint(0, 2**62, (1,), generator=generator, device=generator.device)
    with sync("rtp.sync.base"):
        return int(drawn)


def _all_reduce(tensor: torch.Tensor, group) -> None:
    """`dist.all_reduce` (a sum, in place), counted."""
    _count_collective(tensor)
    dist.all_reduce(tensor, group=group)


def _count_collective(tensor: torch.Tensor) -> None:
    """One collective over this rank's `tensor`, in `collectives` and
    `collective_bytes`."""
    count("collectives")
    count("collective_bytes", tensor.numel() * tensor.element_size())


def shard_generator(base: int, ray_id: int, s_id: int, device) -> torch.Generator:
    """The generator of the shard at (ray_id, s_id): seeded with words 0
    and 1 of the Philox-4x32-10 block (ops/rng.py) at counter (ray_id,
    s_id, 0, 0) under the key (base's low 32 bits, its high bits)."""
    c = [torch.tensor([x], dtype=torch.int64) for x in (ray_id, s_id, 0, 0)]
    w0, w1, _, _ = philox4x32_10(*c, base & MASK32, base >> 32)
    return torch.Generator(device=device).manual_seed((int(w0) << 32) | int(w1))


def mesh_coords(mesh) -> tuple[int, int, int, int]:
    """(ray_id, s_id, n_rays, n_samples) of this rank."""
    return (mesh.get_local_rank("rays"), mesh.get_local_rank("samples"),
            mesh["rays"].size(), mesh["samples"].size())


def _render_flat(
    scene: Scene,
    cam: CameraDerived,
    i: torch.Tensor,
    j: torch.Tensor,
    generator: torch.Generator,
    *,
    max_depth: int,
    spp_local: int,
    use_megakernel: bool = False,
    front=None,
) -> torch.Tensor:
    """Radiance sum [P, 3] over `spp_local` samples of a flat pixel batch,
    one sample at a time (the live set stays one sample of the batch).

    Each sample draws its camera rays from `generator`, then the
    megakernel's seed (randint in [0, 2^31 - 1)) for
    `trace_paths(front=front)` with `use_megakernel`, else the path draws
    of `render.ray_color`. The kernels run on the card for CUDA tensors
    and their plain versions on the CPU."""
    acc = torch.zeros((i.shape[0], 3), dtype=cam.center.dtype, device=i.device)
    for _ in range(spp_local):
        origin, direction, time = generate_rays(cam, i, j, generator)
        if use_megakernel:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                     device=generator.device))
            rad = trace_paths(origin, direction, time, scene, seed, max_depth, front=front)
        else:
            rad = ray_color(scene, origin, direction, time, generator, max_depth)
        acc = acc + rad
    return acc


def _local_pixels(width: int, height: int, n_rays: int, ray_id: int, device):
    """(i, j) of this ray shard's slice of `_pixel_grid`, and its
    (start, stop) in the padded list."""
    i, j = _pixel_grid(width, height, n_rays)
    size = i.shape[0] // n_rays
    lo, hi = ray_id * size, (ray_id + 1) * size
    return i[lo:hi].to(device), j[lo:hi].to(device), lo, hi


def render_sharded(
    scene: Scene,
    camera,
    generator: torch.Generator | None,
    mesh,
    spp: int | None = None,
    use_megakernel: bool = False,
    front=None,
) -> torch.Tensor:
    """Distributed render: the mean radiance [H, W, 3], on every rank.

    Each rank renders spp / n_samples samples of its ray shard's pixels
    (`_render_flat`); the sums are all-reduced over `samples` and
    gathered over `rays`. Runs on the mesh's device (`make_mesh`).
    `use_megakernel` traces each sample with the megakernel (K1 with the
    brute scan, or with `front`, a FrontTables over `scene` in leaf
    order, K3; K7 for a FrontTablesHBM). `generator` (default: seeded with
    0 on the mesh's device) gives the base of every rank's stream
    (`shard_generator`)."""
    device = mesh_device(mesh)
    ray_id, s_id, n_rays, n_samples = mesh_coords(mesh)
    width, height = camera.image_size()
    spp = spp or camera.samples_per_pixel
    if spp % n_samples != 0:
        raise ValueError(f"spp {spp} not divisible by samples axis {n_samples}")
    scene = scene.to(device)
    if front is not None:
        front = front.to(device)
    cam = camera.derive(scene.center0.dtype, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    i, j, _, _ = _local_pixels(width, height, n_rays, ray_id, device)
    g = shard_generator(draw_base(generator), ray_id, s_id, device)
    acc = _render_flat(scene, cam, i, j, g, max_depth=camera.max_depth,
                       spp_local=spp // n_samples, use_megakernel=use_megakernel, front=front)
    _all_reduce(acc, mesh.get_group("samples"))
    parts = [torch.empty_like(acc) for _ in range(n_rays)]
    _count_collective(acc)
    dist.all_gather(parts, acc, group=mesh.get_group("rays"))
    return torch.cat(parts)[: width * height].reshape(height, width, 3) / spp


def _oracle_shard(scene: Scene, cam: CameraDerived, max_depth: int) -> Callable:
    """A shard's radiance sum through the oracle: `_render_flat` of the
    scene at `params`, differentiable in them."""
    def shard(params: SceneParams, g, i, j, spp_local: int):
        return _render_flat(apply_params(scene, params), cam, i, j, g, max_depth=max_depth,
                            spp_local=spp_local)

    return shard


def _sample_rays(cam: CameraDerived, g, i, j, spp_local: int):
    """Camera rays of `spp_local` samples of the pixels (i, j), in the fast
    steps' order ([spp_local, P]), from `g`."""
    n = i.shape[0]
    ii, jj = i.repeat(spp_local), j.repeat(spp_local)
    return rays_from_uniforms(cam, ii, jj, *camera_uniforms(n * spp_local, g, ii.device,
                                                           cam.center.dtype))


def _fast_shard(radiance_fn: Callable, cam: CameraDerived) -> Callable:
    """A shard's radiance sum through a fast radiance (the recording
    megakernel forward, the replay backward): the rays of every local
    sample, then the seed, drawn as `make_fast_train_step` draws them, so
    a 1x1 mesh's step is that step's on the shard's generator."""
    def shard(params: SceneParams, g, i, j, spp_local: int):
        o, d, t = _sample_rays(cam, g, i, j, spp_local)
        drawn = torch.randint(0, 2**31 - 1, (1,), generator=g, device=g.device)
        with sync("rtp.sync.seed"):
            seed = int(drawn)
        return radiance_fn(params, o, d, t, seed).reshape(spp_local, i.shape[0], 3).sum(dim=0)

    return shard


def _soft_shard(scene: Scene, cam: CameraDerived, max_depth: int,
                candidates_k: int | None) -> Callable:
    """A shard's radiance sum through `soft_primary_radiance`, the rays
    and draws in `make_soft_train_step`'s order."""
    def shard(params: SceneParams, g, i, j, spp_local: int, softness: float):
        o, d, t = _sample_rays(cam, g, i, j, spp_local)
        rad = soft_primary_radiance(params, scene, o, d, t, g, max_depth, float(softness),
                                    candidates_k=candidates_k)
        return rad.reshape(spp_local, i.shape[0], 3).sum(dim=0)

    return shard


def _sharded_step(camera, mesh, spp: int, mask: SceneParams,
                  generator: torch.Generator | None, shard: Callable) -> Callable:
    """step(params, opt_state, gen, target, *extra) of the sharded train
    steps: the loss

        sum over rays of sum((all_reduce_samples(acc) / spp - target)^2)
        / (npix * 3)

    with acc = shard(params, g, i, j, spp_local, *extra) this rank's
    radiance sum; its gradient is the transpose of the sharded forward:
    each rank back-propagates its acc with the cotangent
    2 * (img - target) / (spp * npix * 3), and the parameter gradients
    are summed over the mesh. Loss, gradients and updated parameters are
    the same on every rank."""
    device = mesh_device(mesh)
    ray_id, s_id, n_rays, n_samples = mesh_coords(mesh)
    if spp % n_samples != 0:
        raise ValueError(f"spp {spp} not divisible by samples axis {n_samples}")
    spp_local = spp // n_samples
    width, height = camera.image_size()
    npix = width * height
    i, j, lo, hi = _local_pixels(width, height, n_rays, ray_id, device)
    total = (hi - lo) * n_rays
    samples, rays = mesh.get_group("samples"), mesh.get_group("rays")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def step(params: SceneParams, opt_state, gen: torch.Generator | None, target, *extra):
        with span("rtp.shard.step"):
            gen = generator if gen is None else gen
            g = shard_generator(draw_base(gen), ray_id, s_id, device)
            with span("rtp.shard.forward"):
                acc = shard(params, g, i, j, spp_local, *extra)
            with span("rtp.shard.reduce.image"):
                img = acc.detach().clone()
                _all_reduce(img, samples)
                resid = img / spp - _pad_target(target.to(device, acc.dtype), total)[lo:hi]
                sq = torch.sum(resid * resid)
                _all_reduce(sq, rays)
            with span("rtp.shard.backward"):
                got = torch.autograd.grad(acc, list(params), 2.0 * resid / (spp * npix * 3),
                                          allow_unused=True)
            with span("rtp.shard.reduce.grad"):
                flat = torch.cat([(torch.zeros_like(p) if gp is None else gp).reshape(-1)
                                  for p, gp in zip(params, got)])
                _all_reduce(flat, samples)
                _all_reduce(flat, rays)
            grads = SceneParams(*(x.view_as(p) for x, p in
                                  zip(flat.split([p.numel() for p in params]), params)))
            with span("rtp.fit.adam"):
                apply_updates(opt_state, params, grads, mask)
            return params, opt_state, sq / (npix * 3), grads

    return step


def make_sharded_train_step(
    scene: Scene,
    camera,
    mesh,
    optimizer=None,
    *,
    spp: int = 8,
    learning_rate: float = 2e-2,
    trainable: tuple[str, ...] | None = None,
    use_megakernel: bool = False,
    front=None,
    two_phase: int | None = None,
    cap_frac: float = 0.25,
    generator: torch.Generator | None = None,
):
    """Sharded inverse-rendering step (make_sharded_train_step of the JAX
    package): loss pixels shard over `rays`, samples over `samples`, the
    parameter gradients are summed over the mesh (`_sharded_step`).

    Without `use_megakernel` each shard differentiates `_render_flat`
    through the oracle. With it each shard runs a fast radiance
    (grad/fast.py): the recording megakernel forward (K5) and the replay
    backward, shard-local. `front` (a FrontTables over `scene`, already in
    leaf order; FIXED geometry, so trainable centres or radii raise, as in
    make_fast_train_step) rides replicated into every shard's forward;
    `two_phase` (a cut depth) takes the two-phase pipeline (K6) with
    survivor capacity `cap_frac`, its compaction shard-local.

    `optimizer`, `trainable` and `generator` are make_fast_train_step's;
    the step runs on the mesh's device (`make_mesh`). Returns (params0,
    opt_state0, step) with step(params, opt_state, generator, target
    [H, W, 3]) -> (params, opt_state, loss, grads), replicated on every
    rank."""
    mask = trainable_mask(trainable)
    device = mesh_device(mesh)
    scene = scene.to(device)
    cam = camera.derive(scene.center0.dtype, device)
    max_depth = camera.max_depth
    if front is not None:
        refuse_trainable_geometry(trainable)
        front = front.to(device)
    if not use_megakernel:
        shard = _oracle_shard(scene, cam, max_depth)
    elif two_phase:
        shard = _fast_shard(make_fast_radiance_twophase(scene, max_depth, cut=two_phase,
                                                        cap_frac=cap_frac, front=front), cam)
    else:
        shard = _fast_shard(make_fast_radiance(scene, max_depth, front=front), cam)
    step = _sharded_step(camera, mesh, spp, mask, generator, shard)
    params0, opt_state0 = init_train_state(scene, mask, optimizer, learning_rate)
    return params0, opt_state0, step


def make_sharded_soft_train_step(
    scene: Scene,
    camera,
    mesh,
    optimizer=None,
    *,
    spp: int = 4,
    softness: float = 0.02,
    learning_rate: float = 2e-2,
    trainable: tuple[str, ...] | None = None,
    candidates_k: int | None = None,
    generator: torch.Generator | None = None,
):
    """Silhouette-gradient training sharded over the mesh
    (make_sharded_soft_train_step of the JAX package):
    grad.edge.soft_primary_radiance on each shard's rays with the
    collectives of make_sharded_train_step. The top-k candidates
    (`candidates_k`) are chosen per shard from its own rays.

    Returns (params0, opt_state0, step) with step(params, opt_state,
    generator, target [H, W, 3], softness_t=softness) -> (params,
    opt_state, loss, grads); `softness_t` may change from step to step."""
    mask = trainable_mask(trainable)
    device = mesh_device(mesh)
    scene = scene.to(device)
    cam = camera.derive(scene.center0.dtype, device)
    inner = _sharded_step(camera, mesh, spp, mask, generator,
                          _soft_shard(scene, cam, camera.max_depth, candidates_k))

    def step(params: SceneParams, opt_state, gen: torch.Generator | None, target,
             softness_t: float = softness):
        return inner(params, opt_state, gen, target, softness_t)

    params0, opt_state0 = init_train_state(scene, mask, optimizer, learning_rate)
    return params0, opt_state0, step
