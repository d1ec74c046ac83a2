"""Path-replay backpropagation: an O(depth) backward pass for path tracing
(counterpart of raytracingproject_tpu/grad/replay.py).

The recording megakernel (ops/cuda/megakernel.py `trace_record`) and the
oracle's recorder (`xla_trace_record` here) store each bounce's discrete
path decisions: the sphere hit (or MISS / DEAD),
the scattered direction and the dielectric reflect bit. `replay_radiance`
re-evaluates those paths as a differentiable function of the scene
parameters: per bounce only the known winner's quadratic is re-solved,
and the random scatter offsets are rebuilt from the recorded direction as
constants:

    lambertian  u = detach(dir_rec - n)           dir(p) = n(p) + u
    metal       f = detach((dir_rec - refl) / fz)  dir(p) = refl(p) + fz(p) * f
    dielectric  branch = recorded bit              dir(p) = reflect/refract(p)

PyTorch autograd through this replay gives the JAX package's replay
gradient: the same estimator (draws and discrete topology are constants),
evaluated in the same order. The attribute gather is `index_select`,
whose backward is `index_add_`. The JAX package's one-hot and ray-minor
("colT") gathers are TPU matrix-unit layouts of the same values and are
not ported.

Known estimator properties (as in the JAX package): the fuzz gradient at
fuzz == 0 is taken as 0, and discrete events (Schlick branch, metal
absorption) carry no score-function term.

One divergence from the JAX package (`_finite_cotangent`): at every
bounce the backward zeroes the elements of each ray's cotangent of its
gathered sphere attributes that are not finite. A path caught between
two surfaces near their contact (a small metal sphere and the ground,
a dozen bounces and more) has a replay derivative that grows tenfold
every bounce or two back from its end, past float32's range: the
cotangent of the carried direction turns +inf and -inf, their sum NaN,
and the NaN reaches the fuzz and ior of every sphere the path touched
before. Both replays do this (float64 gives such a path's fuzz and ior
1e39 to 1e54). Every gradient reaches the parameters through the
gathered attributes, so the parameters' gradients stay finite; a finite
cotangent passes bit-unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from raytracingproject_tpu_torch.config import DIELECTRIC, LAMBERTIAN, METAL, T_MIN
from raytracingproject_tpu_torch.grad.inverse import SceneParams, apply_params
from raytracingproject_tpu_torch.materials import ScatterDraws, draw_scatter, scatter_from_draws
# idx codes (per bounce): >= 0 hit that sphere; MISS = sky then retire;
# DEAD = ray already terminated (nothing happens).
from raytracingproject_tpu_torch.ops.cuda.megakernel import DEAD, MISS
from raytracingproject_tpu_torch.ops.intersect import closest_hit
from raytracingproject_tpu_torch.ops.vecmath import dot, refract
from raytracingproject_tpu_torch.render import sky_color
from raytracingproject_tpu_torch.scene import Scene
from raytracingproject_tpu_torch.utils.profiling import sync


class PathResiduals(NamedTuple):
    """Recorded path decisions; leading axis = bounce depth. All leaves are
    constants of the replay."""

    idx: torch.Tensor   # [D, R] int32: hit sphere / MISS / DEAD
    ndir: torch.Tensor  # [D, R, 3] float: scattered direction (0 unless hit)
    refl: torch.Tensor  # [D, R] bool: dielectric reflect branch taken


class PathResidualsP(NamedTuple):
    """PathResiduals with the direction as three [D, R] planes, as K6
    writes them (the two-phase record and replay; PathResidualsP of the
    JAX package)."""

    idx: torch.Tensor   # [D, R] int32: hit sphere / MISS / DEAD
    ndx: torch.Tensor   # [D, R] float: scattered direction components
    ndy: torch.Tensor
    ndz: torch.Tensor
    refl: torch.Tensor  # [D, R] bool: dielectric reflect branch taken


def xla_trace_record(
    scene: Scene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    time: torch.Tensor,
    generator: torch.Generator | None,
    max_depth: int,
    draws: Sequence[ScatterDraws] | None = None,
) -> tuple[torch.Tensor, PathResiduals]:
    """The oracle's forward trace that also records PathResiduals
    (xla_trace_record of the JAX package, grad/replay.py:158-202): the
    radiance of `render.ray_color` for the same draws (bounce k takes the
    k-th set from `generator`, or `draws[k]`), and the residuals the
    recording megakernel writes. The in-package residual source where no
    kernel runs; forward only."""
    n = origin.shape[0]
    dtype, dev = origin.dtype, origin.device
    o, d = origin, direction
    thr = torch.ones((n, 3), dtype=dtype, device=dev)
    rad = torch.zeros((n, 3), dtype=dtype, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    res_idx = torch.full((max_depth, n), DEAD, dtype=torch.int32, device=dev)
    res_ndir = torch.zeros((max_depth, n, 3), dtype=dtype, device=dev)
    res_refl = torch.zeros((max_depth, n), dtype=torch.bool, device=dev)
    with torch.no_grad():
        for depth in range(max_depth):
            dr = draws[depth] if draws is not None else draw_scatter(generator, (n,), dtype)
            rec = closest_hit(o, d, time, scene.center0, scene.center_delta, scene.radius,
                              t_min=T_MIN)
            sc = scatter_from_draws(dr, d, rec, scene)
            miss = alive & ~rec.hit
            rad = rad + torch.where(miss[:, None], thr * sky_color(d), 0.0)
            hit_live = alive & rec.hit
            thr = torch.where(hit_live[:, None], thr * sc.attenuation, thr)
            res_idx[depth] = torch.where(hit_live, rec.idx, torch.where(miss, MISS, DEAD))
            res_ndir[depth] = torch.where(hit_live[:, None], sc.direction, 0.0)
            res_refl[depth] = sc.dielectric_reflected & hit_live
            alive = hit_live & sc.scattered
            o = torch.where(hit_live[:, None], rec.p, o)
            d = torch.where(hit_live[:, None], sc.direction, d)
    return rad, PathResiduals(idx=res_idx, ndir=res_ndir, refl=res_refl)


def _attr_table(scene_p: Scene, scene: Scene) -> torch.Tensor:
    """[N, 13] attribute table (differentiable leaves as columns)."""
    return torch.cat(
        [
            scene_p.center0,                                   # 0:3
            scene_p.center_delta,                              # 3:6
            scene_p.radius[:, None],                           # 6
            scene_p.albedo,                                    # 7:10
            scene_p.fuzz[:, None],                             # 10
            scene_p.ior[:, None],                              # 11
            scene.mat_type.to(scene_p.center0.dtype)[:, None],  # 12 (non-diff)
        ],
        dim=1,
    )


def _dot_xyz(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """`ops.intersect.dot3`'s value, (x + y) + z, from one product: three
    small kernels a call instead of five, and one `stack` in the backward
    instead of six slice scatters (the replay is bound by launches)."""
    x, y, z = (u * v).unbind(-1)
    return x + y + z


def _finite_cotangent(x: torch.Tensor) -> None:
    """Have the backward zero the elements of `x`'s gradient that are not
    finite (a ray's, at one bounce); the finite ones pass bit-unchanged."""
    if x.requires_grad:
        x.register_hook(lambda g: torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0))


def _unit_dir(d: torch.Tensor) -> torch.Tensor:
    """Grad-safe unit direction in the plain reference's order of operations
    (`d * (1 / sqrt(max(d . d, 1e-24)))`, two roundings; not the card's
    rsqrt, which is off by up to 2 ulp: a long specular chain multiplies a
    difference in the carried direction into the gradient). The clamp
    sends the zero-length branch's gradient to the constant."""
    return d * (1.0 / torch.sqrt(torch.clamp_min(dot(d, d), 1e-24)))[:, None]


class _UnitDir(torch.autograd.Function):
    """`_unit_dir`, keeping only `d` for the backward (the replay keeps it
    anyway): the backward works the chain out again and differentiates
    it, so values and gradients are the chain's own, bit for bit, and no
    [R] tensor of it is held per bounce until the backward."""

    @staticmethod
    def forward(ctx, d):
        ctx.save_for_backward(d)
        return _unit_dir(d)

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        with torch.enable_grad():
            d = d.detach().requires_grad_()
            return torch.autograd.grad(_unit_dir(d), d, g)[0]


def _make_live_step(table: torch.Tensor):
    """One differentiable replay bounce: carry (o, d, thr, L), residual row
    r = (idx, ndir, refl). The quadratic re-solve is src/sphere.h:30-57 on
    the known winner."""

    def _live_step(time, carry, r):
        o, d, thr, L = carry
        idx, ndir, refl = r
        # Degenerate-direction gradient guard: a lambertian scatter can
        # record ndir ~ 0 (u ~ -n, the case src/vec3.h's near_zero flags
        # and src/material.h:19-25 leaves unfixed). The carried direction
        # is then ~0 and every 1/|d| derivative near-singular; the values
        # stay exact, only the gradient through such a row's direction is
        # stopped.
        d_ok = (torch.sum(d * d, dim=-1) > 1e-12)[:, None]
        d = torch.where(d_ok, d, d.detach())
        hit = idx >= 0
        miss = idx == MISS
        i = torch.clamp_min(idx, 0).long()

        attrs = table.index_select(0, i)
        _finite_cotangent(attrs)
        c0 = attrs[:, 0:3]
        cd = attrs[:, 3:6]
        rad = attrs[:, 6]
        alb = attrs[:, 7:10]
        fz = attrs[:, 10]
        ior = attrs[:, 11]
        mat = attrs[:, 12].to(torch.int32)

        # re-solve the winner's quadratic (src/sphere.h:30-57): the closest
        # root is r0 when r0 > t_min, else r1 (r0 <= r1 always). Written as
        # the recorders write it (`ops.intersect._roots`, the kernels'
        # `_sphere_t`): dot products as (x + y) + z and times the
        # reciprocal, so that in float32
        # the replay lands on the recorded hit point whatever the device's
        # reduction order (a 1000-unit sphere's quadratic cancels enough for
        # that order alone to move t by 4e-4 relative)
        cc = c0 + time[:, None] * cd
        oc = o - cc
        a = torch.clamp_min(_dot_xyz(d, d), 1e-20)
        hb = _dot_xyz(oc, d)
        cq = _dot_xyz(oc, oc) - rad * rad
        disc = hb * hb - a * cq
        dpos = disc > 0.0
        sq = torch.sqrt(torch.where(dpos, disc, 1.0))
        inv_a = 1.0 / a
        r0 = (-hb - sq) * inv_a
        r1 = (-hb + sq) * inv_a
        t = torch.where(r0 > T_MIN, r0, r1)
        t = torch.where(hit, t, 1.0)

        p = o + t[:, None] * d
        r_safe = torch.where(rad != 0.0, rad, 1.0)
        outward = (p - cc) / r_safe[:, None]
        front = dot(d, outward) < 0.0
        nrm = torch.where(front[:, None], outward, -outward)

        L = L + torch.where(miss[:, None], thr * sky_color(d), 0.0)
        att = torch.where((mat == DIELECTRIC)[:, None], 1.0, alb)
        thr = torch.where(hit[:, None], thr * att, thr)

        ud = _UnitDir.apply(d)
        # lambertian: recorded dir = n + u, u parameter-independent
        u_const = ndir - nrm.detach()
        lam_dir = nrm + u_const

        # metal: recorded dir = reflect + fuzz * f
        rfl = ud - 2.0 * dot(ud, nrm)[:, None] * nrm
        fz_obs = fz.detach()
        f_const = torch.where(
            (fz_obs > 1e-6)[:, None],
            (ndir - rfl.detach()) / torch.clamp_min(fz_obs, 1e-6)[:, None],
            0.0,
        )
        met_dir = rfl + fz[:, None] * f_const

        # dielectric: recorded branch bit
        ratio = torch.where(front, 1.0 / ior, ior)
        die_dir = torch.where(refl[:, None], rfl, refract(ud, nrm, ratio))

        nd = torch.where(
            (mat == LAMBERTIAN)[:, None],
            lam_dir,
            torch.where((mat == METAL)[:, None], met_dir, die_dir),
        )
        o = torch.where(hit[:, None], p, o)
        d = torch.where(hit[:, None], nd, d)
        return o, d, thr, L

    return _live_step


def check_gather(gather: str | None) -> None:
    """Raise for a replay gather other than the default (None)."""
    if gather is not None:
        raise ValueError(
            f"gather={gather!r}: the one-hot and colT replay gathers are TPU "
            "matrix-unit layouts of the same values and are not ported; the "
            "port gathers with index_select (backward index_add_)")


def _live_depth(idx: torch.Tensor) -> int:
    """Bounces up to and including the last one at which any ray is not
    DEAD (one host read). Later bounces change nothing: a DEAD row leaves
    every carried value as it is."""
    rows = (idx != DEAD).any(dim=1)
    with sync("rtp.sync.live_depth"):
        live = torch.nonzero(rows)
        return int(live[-1]) + 1 if live.numel() else 0


def _replay(step, origin, direction, time, idx, ndir, refl, skip_dead: bool):
    """One replay over a ray slice; `skip_dead` stops after the slice's
    last live bounce."""
    n = origin.shape[0]
    dtype, dev = origin.dtype, origin.device
    carry = (origin, direction, torch.ones((n, 3), dtype=dtype, device=dev),
             torch.zeros((n, 3), dtype=dtype, device=dev))
    return _scan(step, time, carry, idx, lambda k: ndir[k], refl, skip_dead)[3]


def _scan(step, time, carry, idx, ndir_of, refl, skip_dead: bool):
    """The replay bounces of `idx`'s rows from `carry` (o, d, thr, L);
    `ndir_of(k)` is row k's [R, 3] direction. `skip_dead` stops after the
    last row at which any ray is not DEAD."""
    depth = _live_depth(idx) if skip_dead else idx.shape[0]
    for k in range(depth):
        carry = step(time, carry, (idx[k], ndir_of(k), refl[k]))
    return carry


def replay_radiance(
    params: SceneParams,
    scene: Scene,
    origin: torch.Tensor,     # [R, 3]
    direction: torch.Tensor,  # [R, 3]
    time: torch.Tensor,       # [R]
    res: PathResiduals,
    n_groups: int = 1,
    skip_dead: bool | None = None,
    gather: str | None = None,
) -> torch.Tensor:
    """Differentiable replay of recorded paths: radiance [R, 3] as a
    function of `params`, with every discrete decision frozen to `res`.

    At the recording parameters this reproduces the forward radiance to
    float precision. Cost per bounce: one sphere quadratic per ray.

    The bounce loop runs in Python and stops after the last bounce at
    which any ray is not DEAD (`skip_dead`, default on; False replays all
    `res.idx.shape[0]` bounces without the host read). `n_groups > 1`
    sorts rays by death depth (a permutation outside the graph: parameter
    gradients are sums over rays), replays `n_groups` equal slices, DEAD-
    padded, each only while its deepest ray lives, and unpermutes the
    radiance. Both are exact: a skipped bounce changes nothing.

    `gather` exists for the JAX signature: its "colT" value selects a TPU
    matrix-unit layout of the same gather, which the port has no use for,
    and any value but None raises."""
    check_gather(gather)
    skip = skip_dead is not False
    table = _attr_table(apply_params(scene, params), scene)
    step = _make_live_step(table)
    if n_groups <= 1:
        return _replay(step, origin, direction, time, res.idx, res.ndir, res.refl, skip)

    n = origin.shape[0]
    depth_of = (res.idx != DEAD).sum(dim=0)  # [R]: death is permanent
    perm = torch.argsort(-depth_of, stable=True)
    pad = (-n) % n_groups
    idx_s = res.idx[:, perm]
    if pad:
        # padding slots replay all-DEAD copies of ray 0; they land in the
        # shallow tail slice and are dropped before the unpermute
        perm = torch.cat([perm, perm.new_zeros(pad)])
        dead = torch.full((res.idx.shape[0], pad), DEAD, dtype=res.idx.dtype,
                          device=res.idx.device)
        idx_s = torch.cat([idx_s, dead], dim=1)
    o_s, d_s, t_s = origin[perm], direction[perm], time[perm]
    nd_s, rf_s = res.ndir[:, perm], res.refl[:, perm]
    g = (n + pad) // n_groups
    parts = [
        _replay(step, o_s[k * g:(k + 1) * g], d_s[k * g:(k + 1) * g],
                t_s[k * g:(k + 1) * g], idx_s[:, k * g:(k + 1) * g],
                nd_s[:, k * g:(k + 1) * g], rf_s[:, k * g:(k + 1) * g], skip)
        for k in range(n_groups)
    ]
    sorted_rad = torch.cat(parts)[:n]
    return sorted_rad[torch.argsort(perm[:n])]


def replay_radiance_twophase(
    params: SceneParams,
    scene: Scene,
    origin: torch.Tensor,     # [R, 3]
    direction: torch.Tensor,  # [R, 3]
    time: torch.Tensor,       # [R]
    res1: PathResidualsP,     # [cut, Rp], original ray order
    res2: PathResidualsP,     # [D - cut, Rp], packed order (alive-first)
    src: torch.Tensor,        # [Rp / row] int32 row packing permutation
    dest: torch.Tensor,       # [Rp / row] int32 inverse row permutation
    n_alive,                  # live rows after the cut (int or 0-dim tensor)
    cap_rays: int | None = None,
) -> torch.Tensor:
    """Differentiable replay of a two-phase recording
    (`ops.cuda.depth_tail.trace_record_twophase`; replay_radiance_twophase
    of the JAX package, grad/replay.py:449-562): radiance [R, 3] as a
    function of `params`.

    Phase 1 replays res1 for every ray. The carry (o, d, thr, L) is then
    packed by `src` and phase 2 replays res2 over the first `cap_rays`
    packed rays only: positions past n_alive rows hold all-DEAD rows,
    which change nothing, so that is exact while n_alive fits the
    capacity. When it does not, phase 2 runs at full width, also exact: a
    Python `if` on one host read of `n_alive`. Default capacity: half the
    padded ray count, rounded up to whole rows. Each phase stops after its
    last live bounce (one host read each).

    The row width of the packing is Rp / len(src): the recorder's
    (depth_tail.ROW_WIDTH; 128 for the JAX package's own recording), which
    take_ray_rows reads from the permutation's length as well."""
    from raytracingproject_tpu_torch.ops.cuda.depth_tail import take_ray_rows

    table = _attr_table(apply_params(scene, params), scene)
    step = _make_live_step(table)
    n = origin.shape[0]
    r_pad = res1.idx.shape[1]
    row = r_pad // src.shape[0]
    cap = r_pad // 2 if cap_rays is None else int(cap_rays)
    cap = min(max(cap, row), r_pad)
    cap = -(-cap // row) * row

    def pad(x, fill=0.0):
        if r_pad == n:
            return x
        return torch.cat([x, x.new_full((r_pad - n, *x.shape[1:]), fill)])

    o0, d0, tm = pad(origin), pad(direction, 1.0), pad(time)
    dtype, dev = origin.dtype, origin.device
    carry = (o0, d0, torch.ones((r_pad, 3), dtype=dtype, device=dev),
             torch.zeros((r_pad, 3), dtype=dtype, device=dev))

    def planar(res, sl=slice(None)):
        """(idx, ndir_of, refl) of PathResidualsP rows over the rays `sl`."""
        def ndir_of(k):
            return torch.stack([res.ndx[k, sl], res.ndy[k, sl], res.ndz[k, sl]], dim=-1)
        return res.idx[:, sl], ndir_of, res.refl[:, sl]

    carry = _scan(step, tm, carry, *planar(res1), skip_dead=True)
    src, dest = src.detach(), dest.detach()
    carry = tuple(take_ray_rows(x, src) for x in carry)
    tm_p = take_ray_rows(tm, src)
    if cap < r_pad and int(n_alive) * row <= cap:
        head = _scan(step, tm_p[:cap], tuple(x[:cap] for x in carry),
                     *planar(res2, slice(0, cap)), skip_dead=True)
        L = torch.cat([head[3], carry[3][cap:]])
    else:  # full width: the capacity is the whole frame, or the survivors overflow it
        L = _scan(step, tm_p, carry, *planar(res2), skip_dead=True)[3]
    return take_ray_rows(L, dest)[:n]
