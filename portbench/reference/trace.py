"""The bounce loop, plain PyTorch: "Ray Tracing in One Weekend"'s
ray_color as an iterative loop over rays in lockstep, with the renderer's
random-number contract (philox.py), brute-force closest hit over every
sphere, and the live rays compacted after each bounce.

`radiance` is the forward (any float dtype: float32 is the reference,
bfloat16 the control); given the materials (albedo, fuzz, ior) as leaves
it is the same loop as a function of them that autograd differentiates,
with the estimator of path replay: which sphere is hit,
the dielectric branch and metal absorption are constants of the
gradient, the random scatter offsets too, and a metal's fuzz gradient is
taken as 0 where its fuzz is at most 1e-6.

A scene is a dict of tensors: center0 [N, 3], center_delta [N, 3],
radius [N], mat_type [N] (0 lambertian, 1 metal, 2 dielectric), albedo
[N, 3], fuzz [N], ior [N].
"""

from __future__ import annotations

import math

import torch

from portbench.reference.philox import ball_radius, bounce_uniforms, unit_vector

T_MIN = 1e-3
LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
# [rays, spheres] elements of one closest-hit temporary
CHUNK_ELEMENTS = 1 << 24


def scene_on(arrays: dict, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The scene's numpy arrays as tensors of `dtype` on `device`."""
    out = {k: torch.as_tensor(v).to(device) for k, v in arrays.items()}
    return {k: (v.to(torch.int64) if k == "mat_type" else v.to(dtype)) for k, v in out.items()}


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def closest_hit(sc: dict, o: torch.Tensor, d: torch.Tensor, tm: torch.Tensor):
    """(t, winner) of every ray over every sphere: the first sphere in
    index order at the least t in (T_MIN, inf); winner -1 on a miss."""
    n_sph = sc["radius"].shape[0]
    step = max(1, CHUNK_ELEMENTS // max(n_sph, 1))
    c0, cd, rad = sc["center0"], sc["center_delta"], sc["radius"]
    ts, ws = [], []
    for r0 in range(0, o.shape[0], step):
        ox, oy, oz = (o[r0:r0 + step, q:q + 1] for q in range(3))
        dx, dy, dz = (d[r0:r0 + step, q:q + 1] for q in range(3))
        t = tm[r0:r0 + step, None]
        a = torch.clamp_min(_dot(dx, dy, dz, dx, dy, dz), 1e-20)
        inv_a = 1.0 / a
        ocx = ox - (c0[None, :, 0] + t * cd[None, :, 0])
        ocy = oy - (c0[None, :, 1] + t * cd[None, :, 1])
        ocz = oz - (c0[None, :, 2] + t * cd[None, :, 2])
        hb = _dot(ocx, ocy, ocz, dx, dy, dz)
        cq = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - rad[None] * rad[None]
        disc = hb * hb - a * cq
        pos = disc > 0.0
        sq = torch.sqrt(torch.where(pos, disc, 1.0))
        near = (-hb - sq) * inv_a
        far = (-hb + sq) * inv_a
        root = torch.where(near > T_MIN, near, torch.where(far > T_MIN, far, math.inf))
        root = torch.where(pos, root, math.inf)
        win = torch.argmin(root, dim=1)
        best = torch.gather(root, 1, win[:, None])[:, 0]
        ts.append(best)
        ws.append(torch.where(best < math.inf, win, -1))
    return torch.cat(ts), torch.cat(ws)


def _winner_t(sc, i, o, d, tm):
    """The hit distance of each ray on its own sphere `i` (differentiable
    in o and d), by the closest hit's arithmetic."""
    c = sc["center0"][i] + tm[:, None] * sc["center_delta"][i]
    dx, dy, dz = d.unbind(1)
    ocx, ocy, ocz = (o - c).unbind(1)
    a = torch.clamp_min(_dot(dx, dy, dz, dx, dy, dz), 1e-20)
    hb = _dot(ocx, ocy, ocz, dx, dy, dz)
    rad = sc["radius"][i]
    cq = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - rad * rad
    disc = hb * hb - a * cq
    sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    inv_a = 1.0 / a
    near = (-hb - sq) * inv_a
    far = (-hb + sq) * inv_a
    return torch.where(near > T_MIN, near, far)


def _scatter(sc, mats, i, o, d, tm, t, u, grad: bool):
    """Shade a live hit: (point, new direction, attenuation, scattered).
    `mats` holds albedo, fuzz and ior (leaves of the graph when `grad`)."""
    albedo, fuzz, ior = mats
    p = o + t[:, None] * d
    c = sc["center0"][i] + tm[:, None] * sc["center_delta"][i]
    rad = sc["radius"][i]
    inv_r = 1.0 / torch.where(rad != 0.0, rad, 1.0)
    nrm = (p - c) * inv_r[:, None]
    front = _dot(*d.unbind(1), *nrm.unbind(1)) < 0.0
    nrm = torch.where(front[:, None], nrm, -nrm)
    inv_len = 1.0 / torch.sqrt(torch.clamp_min(_dot(*d.unbind(1), *d.unbind(1)), 1e-20))
    ud = d * inv_len[:, None]
    u1, u2, u3, u4 = (x.to(d.dtype) for x in u)
    uv = torch.stack(unit_vector(u1, u2), 1)
    lam = nrm + uv
    udn = _dot(*ud.unbind(1), *nrm.unbind(1))
    rfl = ud - 2.0 * udn[:, None] * nrm
    fz = fuzz[i]
    ball = uv * ball_radius(u3)[:, None]
    if grad:
        ball = torch.where((fz.detach() > 1e-6)[:, None], ball, 0.0)
    met = rfl + fz[:, None] * ball
    met_ok = _dot(*met.unbind(1), *nrm.unbind(1)) > 0.0
    ir = ior[i]
    ratio = torch.where(front, 1.0 / ir, ir)
    cos_t = torch.clamp_max(-udn, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    om = 1.0 - cos_t
    schlick = r0 + (1.0 - r0) * om * om * om * om * om
    refl = cannot | (schlick > u4)
    perp = ratio[:, None] * (ud + cos_t[:, None] * nrm)
    k = torch.abs(1.0 - _dot(*perp.unbind(1), *perp.unbind(1)))
    kpos = k > 0.0
    par = torch.where(kpos, torch.sqrt(torch.where(kpos, k, 1.0)), 0.0)
    if grad:
        refl = refl.detach()
        met_ok = met_ok.detach()
    die = torch.where(refl[:, None], rfl, perp - par[:, None] * nrm)
    mat = sc["mat_type"][i]
    new_d = torch.where((mat == LAMBERTIAN)[:, None], lam,
                        torch.where((mat == METAL)[:, None], met, die))
    att = torch.where((mat == DIELECTRIC)[:, None], 1.0, albedo[i])
    scattered = (mat != METAL) | met_ok
    return p, new_d, att, scattered


def _sky(d: torch.Tensor) -> torch.Tensor:
    inv_len = 1.0 / torch.sqrt(torch.clamp_min(_dot(*d.unbind(1), *d.unbind(1)), 1e-20))
    a = 0.5 * (d[:, 1] * inv_len + 1.0)
    blue = torch.tensor((0.5, 0.7, 1.0), dtype=d.dtype, device=d.device)
    return (1.0 - a)[:, None] + a[:, None] * blue[None]


def radiance(sc: dict, o, d, tm, slot: torch.Tensor, seed, depth: int,
             mats=None) -> torch.Tensor:
    """Radiance [R, 3] of rays (o, d, tm) in the scene's dtype; `slot`
    (int64) keys each ray's draws with its pass's `seed` (an int, or an
    int64 tensor a ray). With `mats`
    (albedo, fuzz, ior requiring grad, float32) the loop is the
    differentiable one."""
    grad = mats is not None
    mats = mats if grad else (sc["albedo"], sc["fuzz"], sc["ior"])
    n = o.shape[0]
    L = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
    thr = torch.ones((n, 3), dtype=o.dtype, device=o.device)
    live = torch.arange(n, device=o.device)
    for k in range(depth):
        if live.numel() == 0:
            break
        with torch.no_grad():
            _, win = closest_hit(sc, o.detach(), d.detach(), tm)
        hit = win >= 0
        if grad:
            ok = ((d.detach() * d.detach()).sum(1) > 1e-12)[:, None]
            d = torch.where(ok, d, d.detach())
        miss = ~hit
        if bool(miss.any()):
            L = L.index_add(0, live[miss], thr[miss] * _sky(d[miss]))
        live, o, d, tm, thr, win = live[hit], o[hit], d[hit], tm[hit], thr[hit], win[hit]
        if live.numel() == 0:
            break
        t = _winner_t(sc, win, o, d, tm)
        u = bounce_uniforms(seed if isinstance(seed, int) else seed[live], slot[live], k)
        p, d, att, keep = _scatter(sc, mats, win, o, d, tm, t, u, grad)
        thr = thr * att
        live, o, d, tm, thr = live[keep], p[keep], d[keep], tm[keep], thr[keep]
    return L
