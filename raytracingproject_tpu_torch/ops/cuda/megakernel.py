"""The path-tracing megakernel: host tables, the CUDA wrapper and the
plain PyTorch versions of its kernels.

Counterpart of raytracingproject_tpu/ops/pallas/megakernel.py. The kernels
(K1 bounce loop, K2 brute closest hit, K3 front-culled closest hit, and K5,
the bounce loop that records path residuals) are hand-written CUDA in
csrc/megakernel.cu. `trace_paths` and `trace_record` are the public
entries: for CUDA tensors they launch a kernel or raise; for CPU tensors
they run the plain versions ("the twin") defined here, which the tests
hold against the JAX package and which chip_smoke.py holds against the
kernels.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytracingproject_tpu_torch.config import DIELECTRIC, LAMBERTIAN, METAL, T_MIN
from raytracingproject_tpu_torch.ops.rng import ball_radius, bounce_uniforms, unit_vector
from raytracingproject_tpu_torch.scene import Scene

# Rays per CUDA block (TPB in csrc/megakernel.cu). The TPU kernel's
# 1024-ray (8, 128) tile is TPU layout; here a block is 8 warps of 32 rays,
# and culling decisions are made per warp.
TILE = 256

# sphere table rows: cx cy cz mx my mz rad mat alb_r alb_g alb_b fuzz ior
ROW_CX, ROW_CY, ROW_CZ = 0, 1, 2
ROW_MX, ROW_MY, ROW_MZ = 3, 4, 5
ROW_RAD, ROW_MAT = 6, 7
ROW_AR, ROW_AG, ROW_AB = 8, 9, 10
ROW_FUZZ, ROW_IOR = 11, 12
N_ROWS = 16

WORD = 24    # front subtrees per culling word
UNROLL = 8   # subtree sphere ranges are padded to a multiple of this

# Dynamic shared memory one block may use on an H100 (227 KB). The kernels
# stage their tables there; larger scenes need the global-memory front
# (ROADMAP K7).
SMEM_BUDGET_BYTES = 232448

# Intra-word re-pack count of the JAX package's front tables.
DEFAULT_REPACK = 2

# Residual idx codes of the recording kernel (K5) besides a hit's winner
# (csrc/megakernel.cu MISS / DEAD; grad/replay.py re-exports them).
MISS = -1
DEAD = -2

# Kernel launches per entry point, counted by the wrapper after each
# successful launch (and nowhere else).
LAUNCHES = {"brute": 0, "front": 0, "record_brute": 0, "record_front": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scene_table(scene: Scene, dtype=torch.float32) -> torch.Tensor:
    """(16, N) sphere table (megakernel.py:1345 of the JAX package); the
    kernels take float32, the plain versions any float type."""
    rows = [
        scene.center0[:, 0], scene.center0[:, 1], scene.center0[:, 2],
        scene.center_delta[:, 0], scene.center_delta[:, 1], scene.center_delta[:, 2],
        scene.radius, scene.mat_type.to(scene.radius.dtype),
        scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
        scene.fuzz, scene.ior,
    ]
    rows += [torch.zeros_like(scene.radius)] * (N_ROWS - len(rows))
    return torch.stack(rows).to(dtype).contiguous()


@dataclasses.dataclass
class FrontTables:
    """Tables of the front-culled closest hit (K3), built by `front_tables`.
    Same arrays and layout as the JAX package's FrontTables."""

    sph: torch.Tensor    # (16, Np) front-padded sphere table
    ff: torch.Tensor     # (8, F) f32 subtree boxes (min xyz, max xyz, 0, 0)
    fi: torch.Tensor     # (2, F) i32 (start, padded count)
    wf: torch.Tensor     # (8, Wp) f32 word union boxes
    sf: torch.Tensor     # (8, S) f32 super-word union boxes
    remap: torch.Tensor  # (Np,) i32 padded column -> leaf-order sphere
    repack: int = 1

    def to(self, device) -> "FrontTables":
        t = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return FrontTables(**{k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                              for k, v in t.items()})

    def column_subtree(self) -> torch.Tensor:
        """(Np,) int64: the subtree owning each padded column."""
        fi = self.fi.cpu().numpy()
        owner = np.zeros(self.sph.shape[1], np.int64)
        for k in range(fi.shape[1]):
            s, c = int(fi[0, k]), int(fi[1, k])
            owner[s : s + c] = k
        return torch.from_numpy(owner).to(self.sph.device)


def default_front_nodes(n_spheres: int) -> int:
    """Front size: ~26 spheres per subtree, in WORD multiples, at most
    24^3 subtrees."""
    f = max(1, round(n_spheres / 26 / WORD)) * WORD
    return min(max(f, WORD), WORD * WORD * WORD)


def front_tables(scene: Scene, bvh, max_nodes: int | None = None, order_point=None,
                 repack: int | None = None, sub_block: bool = False,
                 word_earlyout: bool = False, device=None,
                 smem_budget: int | None = SMEM_BUDGET_BYTES) -> FrontTables:
    """Build the front-culling tables (megakernel.py:976-1099 of the JAX
    package). `scene` must already be in BVH leaf order (reorder_scene).

    Each subtree's sphere range is padded to a UNROLL multiple by repeating
    its last sphere, a no-op under the strict `<` best-t update.
    `order_point` orders subtrees near-to-far. Raises ValueError when the
    tables exceed `smem_budget` bytes, the kernel's shared memory; None
    skips the check (the plain version has no such limit). A front of more
    than 576 subtrees (super-words) pads to over 4608 columns, past the
    budget, so the kernel meets one only with the global-memory front (K7)."""
    from raytracingproject_tpu_torch.bvh import bvh_front

    if sub_block or word_earlyout:
        raise NotImplementedError(
            "sub_block and word_earlyout are not ported yet (ROADMAP, kernels "
            "still to port: K3 options)")
    if repack is None:
        repack = DEFAULT_REPACK
    if repack <= 0 or WORD % repack:
        raise ValueError(f"repack {repack} must divide {WORD}")
    device = scene.device if device is None else device
    if max_nodes is None:
        max_nodes = default_front_nodes(scene.num_spheres)
    max_nodes = ((max_nodes + WORD - 1) // WORD) * WORD
    fr = bvh_front(bvh, max_nodes=max_nodes, order_point=order_point)
    sph = scene_table(scene).cpu().numpy()

    cols, remap_cols = [], []
    new_start = np.zeros_like(fr.start)
    new_count = np.zeros_like(fr.count)
    pos = 0
    for k in range(fr.start.shape[0]):
        s, c = int(fr.start[k]), int(fr.count[k])
        if c == 0:
            continue
        cp = ((c + UNROLL - 1) // UNROLL) * UNROLL
        block = sph[:, s : s + c]
        ids = np.arange(s, s + c, dtype=np.int32)
        if cp > c:
            block = np.concatenate([block, np.repeat(block[:, -1:], cp - c, axis=1)], axis=1)
            ids = np.concatenate([ids, np.repeat(ids[-1:], cp - c)])
        new_start[k] = pos
        new_count[k] = cp
        cols.append(block)
        remap_cols.append(ids)
        pos += cp
    sph_pad = np.concatenate(cols, axis=1)
    remap = np.concatenate(remap_cols)
    ff = np.zeros((8, fr.fmin.shape[0]), np.float32)
    ff[0:3] = fr.fmin.T
    ff[3:6] = fr.fmax.T
    fi = np.stack([new_start, new_count]).astype(np.int32)
    # Word union boxes over real subtrees only; all-padding words keep the
    # degenerate 1e30 point, which the strict slab test always misses.
    n_words = fr.fmin.shape[0] // WORD
    n_super = (n_words + WORD - 1) // WORD
    n_words_pad = n_super * WORD if n_super > 1 else n_words
    wf = np.full((8, n_words_pad), 0.0, np.float32)
    wf[0:6] = 1e30
    for wd in range(n_words):
        sl = slice(wd * WORD, (wd + 1) * WORD)
        real = fr.count[sl] > 0
        if real.any():
            wf[0:3, wd] = fr.fmin[sl][real].min(axis=0)
            wf[3:6, wd] = fr.fmax[sl][real].max(axis=0)
            wf[6:8, wd] = 0.0
    sf = np.full((8, max(n_super, 1)), 0.0, np.float32)
    sf[0:6] = 1e30
    for sw in range(n_super):
        sl = slice(sw * WORD, min((sw + 1) * WORD, n_words))
        real = wf[0, sl] < 1e29
        if real.any():
            sf[0:3, sw] = wf[0:3, sl][:, real].min(axis=1)
            sf[3:6, sw] = wf[3:6, sl][:, real].max(axis=1)
            sf[6:8, sw] = 0.0
    smem_bytes = 4 * (sph_pad.size + ff.size + fi.size + wf.size + sf.size)
    if smem_budget is not None and smem_bytes > smem_budget:
        raise ValueError(
            f"front tables need {smem_bytes} B of shared memory (> {smem_budget} "
            f"budget): {sph_pad.shape[1]} padded spheres x {N_ROWS} rows. Scenes this "
            "large need the global-memory front (ROADMAP K7).")
    t = torch.from_numpy
    return FrontTables(
        sph=t(sph_pad).to(device), ff=t(ff).to(device), fi=t(fi).to(device),
        wf=t(wf).to(device), sf=t(sf).to(device), remap=t(remap).to(device),
        repack=repack,
    )


def front_with_params(front: FrontTables, scene: Scene) -> FrontTables:
    """`front` with its padded sphere table rebuilt from `scene` (the
    leaf-ordered scene it was built over, at its current parameters):
    sph = scene_table(scene)[:, remap]. At the parameters the front was
    built from this is bit-equal to `front.sph`.

    The JAX package's recording and plain forwards read the table copied
    when the front was built, so a materials-only train step there renders
    with the initial albedo, fuzz and ior while its replay differentiates
    the current ones; the port's fast radiance calls this on every
    forward. Geometry rows refresh too, but the culling boxes do not:
    geometry training with a front stays refused."""
    sph = scene_table(scene).index_select(1, front.remap.to(scene.device, torch.long))
    return dataclasses.replace(front, sph=sph.contiguous())


# ---------------------------------------------------------------------------
# The plain PyTorch versions ("twin") of K2, K3 and K1
# ---------------------------------------------------------------------------

def _sphere_t(tab: torch.Tensor, ox, oy, oz, dx, dy, dz, tm, a, inv_a,
              t_min: float) -> torch.Tensor:
    """[R, C] hit distance of every ray against every column of `tab`
    (16, C), +inf where the ray misses or hits outside (t_min, inf). The
    root choice is the strict sequential scan's: the near root when it is
    past t_min, else the far one."""
    c = lambda row: tab[row][None, :]  # noqa: E731
    col = lambda x: x[:, None]  # noqa: E731
    ccx = c(ROW_CX) + col(tm) * c(ROW_MX)
    ccy = c(ROW_CY) + col(tm) * c(ROW_MY)
    ccz = c(ROW_CZ) + col(tm) * c(ROW_MZ)
    rad = c(ROW_RAD)
    ocx, ocy, ocz = col(ox) - ccx, col(oy) - ccy, col(oz) - ccz
    half_b = ocx * col(dx) + ocy * col(dy) + ocz * col(dz)
    cq = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = half_b * half_b - col(a) * cq
    dpos = disc > 0.0
    sq = torch.sqrt(torch.where(dpos, disc, 1.0))
    r0 = (-half_b - sq) * col(inv_a)
    r1 = (-half_b + sq) * col(inv_a)
    t = torch.where(r0 > t_min, r0, torch.where(r1 > t_min, r1, math.inf))
    return torch.where(dpos, t, math.inf)


def _first_min(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(best t, winner column or -1): the first minimum in column order,
    which is what a strict `<` scan in column order keeps."""
    idx = torch.argmin(t, dim=1)
    bt = torch.gather(t, 1, idx[:, None])[:, 0]
    return bt, torch.where(bt < math.inf, idx, -1)


def closest_hit_brute_twin(tab, ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min=T_MIN):
    """K2's plain version: masked closest hit over every column of `tab`."""
    return _first_min(_sphere_t(tab, ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min))


def subtree_slab_mask(ff: torch.Tensor, ox, oy, oz, dx, dy, dz, t_min=T_MIN) -> torch.Tensor:
    """[R, F] "ray enters subtree box f within (t_min, inf)": the JAX
    package's _slab_factory math without the best-t far clamp."""
    def inv(d):
        return 1.0 / torch.where(torch.abs(d) > 1e-20, d, 1e-20)

    col = lambda x: x[:, None]  # noqa: E731
    row = lambda i: ff[i][None, :]  # noqa: E731
    idx, idy, idz = col(inv(dx)), col(inv(dy)), col(inv(dz))
    t0 = (row(0) - col(ox)) * idx
    t1 = (row(3) - col(ox)) * idx
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    t0 = (row(1) - col(oy)) * idy
    t1 = (row(4) - col(oy)) * idy
    tn = torch.maximum(tn, torch.minimum(t0, t1))
    tf = torch.minimum(tf, torch.maximum(t0, t1))
    t0 = (row(2) - col(oz)) * idz
    t1 = (row(5) - col(oz)) * idz
    tn = torch.maximum(tn, torch.clamp_min(torch.minimum(t0, t1), t_min))
    tf = torch.minimum(tf, torch.maximum(t0, t1))
    return tf > tn


def closest_hit_front_twin(front: FrontTables, col_subtree: torch.Tensor,
                           ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min=T_MIN):
    """K3's plain version: spheres of subtrees the ray's slab test misses
    are masked out, then the first minimum over the padded table. Equals
    K3 up to last-ulp ties (culled subtrees cannot hold a strictly closer
    hit; K3's extra best-t clamp only drops farther ones)."""
    live = subtree_slab_mask(front.ff, ox, oy, oz, dx, dy, dz, t_min)[:, col_subtree]
    t = _sphere_t(front.sph, ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min)
    return _first_min(torch.where(live, t, math.inf))


def bounce_loop_twin(origin, direction, time, tab, closest_hit, seed: int, max_depth: int,
                     ray0: int = 0, t_min: float = T_MIN, zero_draws: bool = False,
                     record: bool = False):
    """K1's plain version: the per-ray bounce loop of the JAX package's
    _bounce_loop, operation for operation. `tab` is the (16, C) table the
    winner columns index; `ray0` is the global slot of the first ray (the
    RNG counter).

    Returns the radiance [R, 3]; with `record` (K5's plain version) also
    the residual planes (idx, ndx, ndy, ndz, refl), each [max_depth, R],
    as the recording kernel writes them: idx is the winner column of `tab`
    on a live hit, MISS on a live miss and DEAD otherwise; nd* is the
    scattered direction on a live hit, else 0; refl is the dielectric
    reflect branch of a live hit.

    Values are float32 as in the kernel; float64 rays and table give the
    same loop in float64 (tests take finite differences through it)."""
    dev, dt = origin.device, origin.dtype
    n = origin.shape[0]
    if record:
        res_idx = torch.full((max_depth, n), DEAD, dtype=torch.int32, device=dev)
        res_nd = [torch.zeros((max_depth, n), dtype=dt, device=dev) for _ in range(3)]
        res_refl = torch.zeros((max_depth, n), dtype=torch.uint8, device=dev)
    ox, oy, oz = (origin[:, q].clone() for q in range(3))
    dx, dy, dz = (direction[:, q].clone() for q in range(3))
    tm = time
    one = torch.ones(n, dtype=dt, device=dev)
    thr_r, thr_g, thr_b = one, one, one
    rad_r = rad_g = rad_b = torch.zeros(n, dtype=dt, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    ray = torch.arange(ray0, ray0 + n, dtype=torch.int64, device=dev)
    where = torch.where
    for dep in range(max_depth):
        if not bool(alive.any()):
            break
        a = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20)
        inv_a = 1.0 / a
        bt, win = closest_hit(ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min)
        hit = bt < math.inf
        col = tab[:, torch.clamp_min(win, 0)]
        hx = where(hit, col[ROW_CX] + tm * col[ROW_MX], 0.0)
        hy = where(hit, col[ROW_CY] + tm * col[ROW_MY], 0.0)
        hz = where(hit, col[ROW_CZ] + tm * col[ROW_MZ], 0.0)
        hrad = where(hit, col[ROW_RAD], 1.0)
        hmat = where(hit, col[ROW_MAT], 0.0)
        har, hag, hab = (where(hit, col[r], 0.0) for r in (ROW_AR, ROW_AG, ROW_AB))
        hfz = where(hit, col[ROW_FUZZ], 0.0)
        hio = where(hit, col[ROW_IOR], 1.0)

        t_safe = where(hit, bt, 1.0)
        px = ox + t_safe * dx
        py = oy + t_safe * dy
        pz = oz + t_safe * dz
        inv_r = 1.0 / where(hrad != 0.0, hrad, 1.0)
        nx = (px - hx) * inv_r
        ny = (py - hy) * inv_r
        nz = (pz - hz) * inv_r
        front = (dx * nx + dy * ny + dz * nz) < 0.0
        sgn = where(front, 1.0, -1.0)
        nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

        # sky on a miss
        inv_len = 1.0 / torch.sqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20))
        m = (alive & ~hit).to(torch.float32)
        sky_a = 0.5 * (dy * inv_len + 1.0)
        rad_r = rad_r + m * thr_r * (1.0 - sky_a + sky_a * 0.5)
        rad_g = rad_g + m * thr_g * (1.0 - sky_a + sky_a * 0.7)
        rad_b = rad_b + m * thr_b * (1.0 - sky_a + sky_a * 1.0)

        # scatter
        udx, udy, udz = dx * inv_len, dy * inv_len, dz * inv_len
        u1, u2, u3, u4 = bounce_uniforms(seed, ray, dep, zero_draws)
        uvx, uvy, uvz = unit_vector(u1, u2)
        lam_x, lam_y, lam_z = nx + uvx, ny + uvy, nz + uvz
        u_dot_n = udx * nx + udy * ny + udz * nz
        rfl_x = udx - 2.0 * u_dot_n * nx
        rfl_y = udy - 2.0 * u_dot_n * ny
        rfl_z = udz - 2.0 * u_dot_n * nz
        br = ball_radius(u3)
        fx, fy, fz = uvx * br, uvy * br, uvz * br
        met_x, met_y, met_z = rfl_x + hfz * fx, rfl_y + hfz * fy, rfl_z + hfz * fz
        met_ok = (met_x * nx + met_y * ny + met_z * nz) > 0.0
        ratio = where(front, 1.0 / hio, hio)
        cos_t = torch.clamp_max(-(udx * nx + udy * ny + udz * nz), 1.0)
        s2 = 1.0 - cos_t * cos_t
        sin_t = torch.sqrt(torch.clamp_min(s2, 0.0))
        cannot = ratio * sin_t > 1.0
        r0s = (1.0 - ratio) / (1.0 + ratio)
        r0s = r0s * r0s
        one_m = 1.0 - cos_t
        schlick = r0s + (1.0 - r0s) * one_m * one_m * one_m * one_m * one_m
        do_refl = cannot | (schlick > u4)
        perp_x = ratio * (udx + cos_t * nx)
        perp_y = ratio * (udy + cos_t * ny)
        perp_z = ratio * (udz + cos_t * nz)
        k = torch.abs(1.0 - (perp_x * perp_x + perp_y * perp_y + perp_z * perp_z))
        spar = -torch.sqrt(k)
        die_x = where(do_refl, rfl_x, perp_x + spar * nx)
        die_y = where(do_refl, rfl_y, perp_y + spar * ny)
        die_z = where(do_refl, rfl_z, perp_z + spar * nz)

        is_lam = hmat == float(LAMBERTIAN)
        is_met = hmat == float(METAL)
        is_die = hmat == float(DIELECTRIC)
        sx = where(is_lam, lam_x, where(is_met, met_x, die_x))
        sy = where(is_lam, lam_y, where(is_met, met_y, die_y))
        sz = where(is_lam, lam_z, where(is_met, met_z, die_z))
        scattered = ~is_met | met_ok

        hit_live = alive & hit
        if record:
            res_idx[dep] = where(hit_live, win, where(alive & ~hit, MISS, DEAD)).to(torch.int32)
            for plane, v in zip(res_nd, (sx, sy, sz)):
                plane[dep] = where(hit_live, v, 0.0)
            res_refl[dep] = (hit_live & is_die & do_refl).to(torch.uint8)
        thr_r = thr_r * where(hit_live & ~is_die, har, 1.0)
        thr_g = thr_g * where(hit_live & ~is_die, hag, 1.0)
        thr_b = thr_b * where(hit_live & ~is_die, hab, 1.0)
        ox, oy, oz = where(hit_live, px, ox), where(hit_live, py, oy), where(hit_live, pz, oz)
        dx, dy, dz = where(hit_live, sx, dx), where(hit_live, sy, dy), where(hit_live, sz, dz)
        alive = hit_live & scattered
        # park dead rays where every later slab and sphere test misses
        ox, oy, oz = (where(alive, v, 1e18) for v in (ox, oy, oz))
        dx, dy, dz = (where(alive, v, 1.0) for v in (dx, dy, dz))
    rad = torch.stack([rad_r, rad_g, rad_b], dim=1)
    if record:
        return rad, (res_idx, *res_nd, res_refl)
    return rad


def _twin_chunk(n_cols: int) -> int:
    """Rays per twin chunk: keeps each [rays, columns] temporary near 64 MB."""
    return max(TILE, ((1 << 24) // max(n_cols, 1)) // TILE * TILE)


def trace_paths_twin(origin, direction, time, scene: Scene | None, seed: int, max_depth: int,
                     t_min: float = T_MIN, front: FrontTables | None = None,
                     zero_draws: bool = False) -> torch.Tensor:
    """Plain PyTorch `trace_paths` on any device, in ray chunks."""
    return _twin(origin, direction, time, scene, seed, max_depth, t_min, front, zero_draws,
                 record=False)


def trace_record_twin(origin, direction, time, scene: Scene | None, seed: int, max_depth: int,
                      t_min: float = T_MIN, front: FrontTables | None = None,
                      zero_draws: bool = False):
    """Plain PyTorch `trace_record` on any device: (radiance [R, 3],
    PathResiduals)."""
    rad, planes = _twin(origin, direction, time, scene, seed, max_depth, t_min, front,
                        zero_draws, record=True)
    return rad, decode_residuals(planes, origin.shape[0], front)


def _twin(origin, direction, time, scene, seed, max_depth, t_min, front, zero_draws,
          record: bool):
    if front is not None:
        tab = front.sph
        owner = front.column_subtree()

        def hit(*r):
            return closest_hit_front_twin(front, owner, *r)
    else:
        tab = scene_table(scene).to(origin.device)

        def hit(*r):
            return closest_hit_brute_twin(tab, *r)

    chunk = _twin_chunk(tab.shape[1])
    outs = []
    for r0 in range(0, max(origin.shape[0], 1), chunk):  # one empty chunk for 0 rays
        sl = slice(r0, r0 + chunk)
        outs.append(bounce_loop_twin(origin[sl], direction[sl], time[sl], tab, hit, seed,
                                     max_depth, ray0=r0, t_min=t_min, zero_draws=zero_draws,
                                     record=record))
    if not record:
        return torch.cat(outs)
    rad = torch.cat([r for r, _ in outs])
    planes = tuple(torch.cat([p[q] for _, p in outs], dim=1) for q in range(5))
    return rad, planes


def decode_residuals(planes, n: int, front: FrontTables | None):
    """PathResiduals from the residual planes (idx, ndx, ndy, ndz, refl),
    each [max_depth, >= n], of the recording kernel or its plain version
    (`_decode_res` of the JAX package). Front winners are columns of the
    front's padded table; `front.remap` maps them to the leaf-ordered
    scene the replay differentiates."""
    from raytracingproject_tpu_torch.grad.replay import PathResiduals

    idx, ndx, ndy, ndz, refl = (x[:, :n] for x in planes)
    if front is not None:
        remap = front.remap.to(idx.device, torch.int32)
        idx = torch.where(idx >= 0, remap[torch.clamp_min(idx, 0).long()], idx)
    return PathResiduals(idx=idx.contiguous(), ndir=torch.stack([ndx, ndy, ndz], dim=-1),
                         refl=refl.bool())


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def _require(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _pad_rays(x: torch.Tensor, total: int) -> torch.Tensor:
    """Pad the ray axis to `total` with copies of ray 0."""
    pad = total - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x[:1].expand(pad, *x.shape[1:])]).contiguous()


def trace_paths(origin: torch.Tensor, direction: torch.Tensor, time: torch.Tensor,
                scene: Scene | None, seed: int, max_depth: int, t_min: float = T_MIN,
                front: FrontTables | None = None, zero_draws: bool = False) -> torch.Tensor:
    """Radiance [R, 3] of camera rays: the full path trace in one kernel
    (pallas_trace_paths of the JAX package).

    With `front` the closest hit is front-culled (K3) over the front's
    padded table and `scene` is not read; otherwise it is the brute scan
    (K2) over `scene`. `seed` keys the Philox stream (ops/rng.py);
    `zero_draws` makes every uniform 0.0 (the TPU interpreter's PRNG).

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    PyTorch version."""
    dev = origin.device
    if dev.type == "cpu":
        return trace_paths_twin(origin, direction, time, scene, seed, max_depth, t_min,
                                front, zero_draws)
    rad, _ = _launch(origin, direction, time, scene, seed, max_depth, t_min, front,
                     zero_draws, record=False)
    return rad


def trace_record(origin: torch.Tensor, direction: torch.Tensor, time: torch.Tensor,
                 scene: Scene | None, seed: int, max_depth: int, t_min: float = T_MIN,
                 front: FrontTables | None = None, zero_draws: bool = False, bvh=None):
    """`trace_paths` that also records the path residuals for the replay
    backward (pallas_trace_record of the JAX package, K5): returns
    (radiance [R, 3], grad.replay.PathResiduals) with idx [D, R] int32 (a
    sphere of `scene`'s order, in leaf order with `front`; MISS; DEAD),
    ndir [D, R, 3] and refl [D, R] bool. The radiance equals
    `trace_paths`'s for the same rays, seed and closest hit.

    CUDA tensors launch the recording kernel (or raise); CPU tensors run
    its plain PyTorch version."""
    if bvh is not None:
        raise NotImplementedError(
            "the BVH-walking recording kernel is not ported yet (ROADMAP K8)")
    dev = origin.device
    if dev.type == "cpu":
        return trace_record_twin(origin, direction, time, scene, seed, max_depth, t_min,
                                 front, zero_draws)
    rad, planes = _launch(origin, direction, time, scene, seed, max_depth, t_min, front,
                          zero_draws, record=True)
    return rad, decode_residuals(planes, origin.shape[0], front)


def _launch(origin, direction, time, scene, seed, max_depth, t_min, front, zero_draws,
            record: bool):
    """Check the inputs and launch K1+K2 / K1+K3 (or, with `record`, K5)
    on CUDA tensors: (radiance [R, 3], residual planes [D, R_pad] or
    None)."""
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"the megakernel runs on cuda or cpu tensors, not {dev}")
    from raytracingproject_tpu_torch.ops.cuda import build

    n = origin.shape[0]
    _require(origin, "origin", (n, 3), torch.float32, dev)
    _require(direction, "direction", (n, 3), torch.float32, dev)
    _require(time, "time", (n,), torch.float32, dev)
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} is not a 32-bit unsigned value")
    if max_depth < 0:
        raise ValueError(f"max_depth {max_depth} < 0")
    r_pad = -(-n // TILE) * TILE
    planes = None
    res_args = []
    if record:
        planes = (torch.empty((max_depth, r_pad), dtype=torch.int32, device=dev),
                  *(torch.empty((max_depth, r_pad), dtype=torch.float32, device=dev)
                    for _ in range(3)),
                  torch.empty((max_depth, r_pad), dtype=torch.uint8, device=dev))
        res_args = [x.data_ptr() for x in planes]
    if n == 0:
        return origin.new_zeros((0, 3)), planes
    lib = build.load_library()
    o, d, t = _pad_rays(origin, r_pad), _pad_rays(direction, r_pad), _pad_rays(time, r_pad)
    out = torch.empty((r_pad, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = lambda x: x.data_ptr()  # noqa: E731
    if front is not None:
        n_cols = front.sph.shape[1]
        n_front = front.ff.shape[1]
        _require(front.sph, "front.sph", (N_ROWS, n_cols), torch.float32, dev)
        _require(front.ff, "front.ff", (8, n_front), torch.float32, dev)
        _require(front.fi, "front.fi", (2, n_front), torch.int32, dev)
        _require(front.wf, "front.wf", (8, front.wf.shape[1]), torch.float32, dev)
        _require(front.sf, "front.sf", (8, front.sf.shape[1]), torch.float32, dev)
        smem = 4 * sum(x.numel() for x in (front.sph, front.ff, front.fi, front.wf, front.sf))
        if smem > SMEM_BUDGET_BYTES:
            raise ValueError(f"front tables need {smem} B of shared memory "
                             f"(> {SMEM_BUDGET_BYTES})")
        fn, key = ((lib.rtp_record_front, "record_front") if record
                   else (lib.rtp_trace_front, "front"))
        err = fn(p(o), p(d), p(t), p(out), r_pad, p(front.sph), n_cols, p(front.ff),
                 p(front.fi), n_front, p(front.wf), front.wf.shape[1], p(front.sf),
                 front.sf.shape[1], front.repack, int(seed), max_depth, t_min,
                 int(zero_draws), *res_args, stream)
    else:
        tab = scene_table(scene)
        _require(tab, "sphere table", (N_ROWS, scene.num_spheres), torch.float32, dev)
        if 4 * tab.numel() > SMEM_BUDGET_BYTES:
            raise ValueError(f"{scene.num_spheres} spheres exceed the brute kernel's "
                             f"shared-memory budget ({SMEM_BUDGET_BYTES} B)")
        fn, key = ((lib.rtp_record_brute, "record_brute") if record
                   else (lib.rtp_trace_brute, "brute"))
        err = fn(p(o), p(d), p(t), p(out), r_pad, p(tab), tab.shape[1], int(seed), max_depth,
                 t_min, int(zero_draws), *res_args, stream)
    build.check(err, f"{key} megakernel launch")
    LAUNCHES[key] += 1
    return out[:n], planes


def philox_bits(n: int, seed: int, bounce: int, device) -> torch.Tensor:
    """[n, 4] int64: the kernel's Philox words of `bounce` for ray slots
    [0, n), computed on the card (for holding it against ops/rng.py)."""
    from raytracingproject_tpu_torch.ops.cuda import build

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("philox_bits runs the CUDA generator; use ops.rng on the CPU")
    lib = build.load_library()
    out = torch.empty((n, 4), dtype=torch.int32, device=dev)
    err = lib.rtp_philox(out.data_ptr(), n, int(seed), int(bounce),
                         torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "philox launch")
    return out.to(torch.int64) & 0xFFFFFFFF
