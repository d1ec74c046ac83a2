"""Silhouette gradients through smoothed primary visibility (counterpart
of raytracingproject_tpu/grad/edge.py).

The hard renderers' gradients (grad/inverse.py, grad/fast.py) flow
through shading and hit distances but not through the hit/miss boundary:
moving a sphere never changes which pixels it covers. Here the primary
hit/miss indicator is replaced by a smooth one,

    v = sigmoid(sdist / softness),   sdist = disc / (a * 2r),
    L = v * L_surface + (1 - v) * L_sky,

sdist being about r - b near the silhouette (b the impact parameter), a
signed distance in world units. Far from a silhouette v is 0 or 1 and the
estimator is the exact one; near it v carries the boundary gradient. A
ray that misses every sphere is shaded at its closest approach to the
sphere nearest its silhouette, whose value vanishes as softness -> 0 and
whose gradient is the point. Secondary-bounce silhouettes are not
smoothed: the continuation is `render.ray_color`.

Plain PyTorch on any device, as the JAX package's is jnp (no kernel).
The JAX package splits a key for the scatter and the continuation; here
both draw from one `torch.Generator`, the scatter first.
"""

from __future__ import annotations

import math

import torch

from raytracingproject_tpu_torch.camera import camera_uniforms, rays_from_uniforms
from raytracingproject_tpu_torch.config import T_MAX, T_MIN, resolve_device
from raytracingproject_tpu_torch.grad.inverse import (
    SceneParams, apply_params, apply_updates, init_train_state, trainable_mask,
)
from raytracingproject_tpu_torch.materials import scatter
from raytracingproject_tpu_torch.ops.intersect import HitRecord, dot3
from raytracingproject_tpu_torch.render import ray_color, sky_color
from raytracingproject_tpu_torch.scene import Scene


def _quadratic(origin, direction, center, radius):
    """(a [R, 1], half_b, disc) of the half-b quadratic of each ray
    against each of its [R, M] spheres (centres [R, M, 3] or [M, 3])."""
    a = torch.clamp_min(dot3(direction, direction), 1e-20)[:, None]
    oc = origin[:, None, :] - center
    half_b = dot3(oc, direction[:, None, :])
    cq = dot3(oc, oc) - radius ** 2
    return a, half_b, half_b * half_b - a * cq


def _sdist(disc, a, radius):
    """Signed silhouette distance disc / (a * 2|r|), world units."""
    r_safe = torch.where(radius != 0.0, torch.abs(radius), 1.0)
    return disc / (a * 2.0 * r_safe)


@torch.no_grad()
def _topk_candidates(s: Scene, origin: torch.Tensor, direction: torch.Tensor,
                     time: torch.Tensor, k: int, chunk: int = 512) -> torch.Tensor:
    """[R, k] int64: the spheres with the largest signed silhouette
    distance of each ray, the candidates of the O(R * k) estimator
    (`_topk_candidates` of the JAX package, edge.py:50-102). A streaming
    top-k over chunks of `chunk` spheres, so peak memory is
    O(R * (chunk + 2k)) whatever the scene's size. Slots no contributing
    sphere fills are -1, never sphere 0 (a duplicate would enter the
    soft union twice). Selection is piecewise constant in the parameters,
    so it runs without autograd; the caller re-derives the k spheres'
    terms differentiably. torch.topk orders ties as it likes: among equal
    silhouette distances the set may differ from the JAX package's."""
    n = s.num_spheres
    r = origin.shape[0]
    dev = origin.device
    best_v = torch.full((r, k), -math.inf, dtype=origin.dtype, device=dev)
    best_i = torch.full((r, k), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        center = s.center0[c0:c1][None] + time[:, None, None] * s.center_delta[c0:c1][None]
        rad = s.radius[c0:c1][None, :]
        a, half_b, disc = _quadratic(origin, direction, center, rad)
        dpos = disc > 0.0
        far_root = (-half_b + torch.sqrt(torch.where(dpos, disc, 1.0))) / a
        contributes = (-half_b / a > T_MIN) | (dpos & (far_root > T_MIN))
        sdist = torch.where(contributes, _sdist(disc, a, rad), -math.inf)
        v, i = torch.topk(sdist, min(k, c1 - c0), dim=1)
        best_v, sel = torch.topk(torch.cat([best_v, v], dim=1), k, dim=1)
        best_i = torch.gather(torch.cat([best_i, i + c0], dim=1), 1, sel)
    return torch.where(best_v == -math.inf, -1, best_i)


def _take_rows(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """x[r, sel[r]] for x [R, M] or [R, M, 3]."""
    if x.dim() == 2:
        return torch.gather(x, 1, sel[:, None])[:, 0]
    return torch.gather(x, 1, sel[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]


def soft_primary_radiance(
    params: SceneParams,
    scene: Scene,
    origin: torch.Tensor,     # [R, 3]
    direction: torch.Tensor,  # [R, 3]
    time: torch.Tensor,       # [R]
    generator: torch.Generator | None,
    max_depth: int,
    softness: float = 0.02,
    candidates_k: int | None = None,
) -> torch.Tensor:
    """Radiance [R, 3] with smoothed primary visibility (the module's
    docstring; soft_primary_radiance of the JAX package, edge.py:105-230),
    differentiable in `params`.

    `softness` is the silhouette's smoothing width in world units, of the
    order of a pixel's footprint at the scene's distance. Without
    `candidates_k` every ray meets every sphere ([R, N] tensors); with it
    a top-k pass without autograd picks each ray's k spheres nearest
    their silhouette and the estimator runs on those ([R, k]). Where k
    covers every sphere whose silhouette band a ray touches, the two are
    equal: a far sphere's soft-union factor is exactly 1.

    The surface radiance is the scatter at the hit (or, for a miss, at the
    closest approach with the normal facing the ray) followed by
    `render.ray_color` at max_depth - 1 bounces, drawing from `generator`
    (on the rays' device) in that order; at max_depth 1 nothing is drawn
    that reaches the result."""
    s = apply_params(scene, params)

    if candidates_k is not None:
        cand = _topk_candidates(s, origin, direction, time, candidates_k)
        col_ok = cand >= 0
        cand = torch.clamp_min(cand, 0)
        center = s.center0[cand] + time[:, None, None] * s.center_delta[cand]  # [R, k, 3]
        rad = s.radius[cand]                                                   # [R, k]
    else:
        col_ok = None
        cand = None
        center = s.center0[None, :, :] + time[:, None, None] * s.center_delta[None, :, :]
        rad = s.radius[None, :].expand(origin.shape[0], -1)

    # the primary intersection with every candidate, keeping the discriminant
    a, half_b, disc = _quadratic(origin, direction, center, rad)
    dpos = disc > 0.0
    sqrtd = torch.sqrt(torch.where(dpos, disc, 1.0))
    r0 = (-half_b - sqrtd) / a
    r1 = (-half_b + sqrtd) / a
    in0 = (r0 > T_MIN) & (r0 < T_MAX)
    in1 = (r1 > T_MIN) & (r1 < T_MAX)
    root = torch.where(in0, r0, r1)
    valid = dpos & (in0 | in1)
    if col_ok is not None:
        valid = valid & col_ok

    t_masked = torch.where(valid, root, T_MAX)
    win = torch.argmin(t_masked, dim=1)
    t = _take_rows(t_masked, win)
    hit = torch.isfinite(t)

    # signed silhouette distance; spheres behind the ray (closest approach
    # at or before t_min and no valid root) never contribute
    t_star = -half_b / a
    contributes = (t_star > T_MIN) | valid
    if col_ok is not None:
        contributes = contributes & col_ok
    sdist = torch.where(contributes, _sdist(disc, a, rad), -math.inf)

    # soft-union visibility v = 1 - prod_i (1 - sigmoid(sdist_i / w)): deep
    # inside any footprint v saturates at 1, so only object-over-sky
    # silhouettes carry gradient (object-over-object ones are not modelled)
    v_i = torch.sigmoid(torch.where(torch.isfinite(sdist), sdist, -1e3) / softness)
    v = 1.0 - torch.prod(1.0 - v_i, dim=1)

    # the shading candidate: the hit's winner, or for a miss the sphere
    # nearest its silhouette, shaded at the closest approach with a front
    # face (at disc == 0 the grazing-hit limit, so L_surface is continuous)
    near = torch.argmax(sdist, dim=1)
    sel = torch.where(hit, win, near)
    t_used = torch.where(hit, torch.where(torch.isfinite(t), t, 1.0),
                         torch.clamp_min(_take_rows(t_star, sel), T_MIN))
    p = origin + t_used[:, None] * direction
    off = p - _take_rows(center, sel)
    outward = off / torch.clamp_min(torch.sqrt(torch.clamp_min(dot3(off, off), 1e-20)),
                                    1e-10)[:, None]
    front_face = torch.where(hit, dot3(direction, outward) < 0.0, True)
    normal = torch.where(front_face[:, None], outward, -outward)
    idx = sel if cand is None else _take_rows(cand, sel)  # a scene index: scatter gathers by it
    rec = HitRecord(t=t_used, idx=idx.to(torch.int32), hit=hit, p=p, normal=normal,
                    front_face=front_face)

    sc = scatter(generator, direction, rec, s)
    l_cont = ray_color(s, rec.p, sc.direction, time, generator, max_depth - 1)
    l_surface = torch.where(sc.scattered[:, None], sc.attenuation * l_cont, 0.0)
    return v[:, None] * l_surface + (1.0 - v)[:, None] * sky_color(direction)


def make_soft_train_step(
    scene: Scene,
    camera,
    optimizer=None,
    *,
    spp: int = 4,
    softness: float = 0.02,
    learning_rate: float = 2e-2,
    trainable: tuple[str, ...] | None = None,
    candidates_k: int | None = None,
    device=None,
    generator: torch.Generator | None = None,
):
    """Inverse-rendering step with silhouette gradients
    (make_soft_train_step of the JAX package, edge.py:233-297): the loss
    is the mean-squared error of a `spp`-sample image of
    `soft_primary_radiance` against the target.

    Conventions of grad.inverse.make_train_step (optimizer callable,
    `trainable`, device, generator). Returns (params0, opt_state0, step)
    with step(params, opt_state, gen, target [H, W, 3], softness_t=softness)
    -> (params, opt_state, loss, grads); each step draws the camera rays,
    then the estimator's draws, from `gen` (None: the generator given
    here, else one on the device seeded with 0). `softness_t` may change
    from step to step, so the smoothing can be annealed: the soft loss's
    optimum sits O(softness) off the hard target's, and shrinking it as
    the fit converges removes that bias while the early steps still see
    wide boundary gradients."""
    mask = trainable_mask(trainable)
    device = resolve_device(device)
    scene = scene.to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    width, height = camera.image_size()
    dtype = scene.center0.dtype
    cam = camera.derive(dtype, device)
    pix = torch.arange(height * width, device=device).repeat(spp)
    i_idx = (pix % width).to(torch.int32)
    j_idx = (pix // width).to(torch.int32)

    def step(params: SceneParams, opt_state, gen: torch.Generator | None, target,
             softness_t: float = softness):
        gen = generator if gen is None else gen
        o, d, t = rays_from_uniforms(
            cam, i_idx, j_idx, *camera_uniforms(pix.shape[0], gen, device, dtype))
        rad = soft_primary_radiance(params, scene, o, d, t, gen, camera.max_depth,
                                    float(softness_t), candidates_k=candidates_k)
        img = rad.reshape(spp, height, width, 3).mean(dim=0)
        loss = torch.mean((img - target.to(device)) ** 2)
        grads = SceneParams(*(
            torch.zeros_like(p) if g is None else g
            for p, g in zip(params, torch.autograd.grad(loss, list(params), allow_unused=True))))
        apply_updates(opt_state, params, grads, mask)
        return params, opt_state, loss.detach(), grads

    params0, opt_state0 = init_train_state(scene, mask, optimizer, learning_rate)
    return params0, opt_state0, step
