"""The front-culled closest hit without shading against the unrolled brute
one (tools/kfront.py of the JAX package).

The front probe (csrc/probes.cu probe_front_kernel) cuts the BVH into F
subtrees, each owning a contiguous sphere range padded to a multiple of 8
by repeating its last sphere (a no-op under the strict `<` update); each
ray slab-tests every subtree box of a word of 24 and scans the spheres of
its own live subtrees in order (the TPU probe, and this port's first,
ORed the word's hits over the warp). There is no stage 1 (every word is
tested) and no best-t clamp, as in the TPU probe. The brute probe scans
every sphere, unrolled x8. Both write the best t, or 0 on a miss.
`warp_schedule` counts the front probe's warp steps and its shared-memory
wavefronts.

    python -m raytracingproject_tpu_torch.probes.kfront [n_spheres]

(the cover scene when n_spheres is omitted, else make_random_scene(n,
seed=3)) holds the front against the brute scan at F = 24 and 48 on the
400x225 primary rays, then times both.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from raytracingproject_tpu_torch import probes
from raytracingproject_tpu_torch.bvh import build_bvh, bvh_front, reorder_scene
from raytracingproject_tpu_torch.camera import Camera, generate_rays
from raytracingproject_tpu_torch.ops.cuda.megakernel import (
    N_ROWS, UNROLL, _first_min, _require, _sphere_t, _twin_chunk, scene_table,
    subtree_slab_mask,
)
from raytracingproject_tpu_torch.probes.measure import marginal_ms
from raytracingproject_tpu_torch.probes.roofline import positive_discriminants
from raytracingproject_tpu_torch.scene import Scene, make_cover_scene, make_random_scene

T_MIN = 1e-3
WORD = 24  # subtrees a culling word
FRONTS = (24, 48)  # the front sizes main() holds and times
COVER_CAMERA = dict(aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=1,
                    max_depth=1, vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                    defocus_angle=0.6, focus_dist=10.0)


def pack_front_tables(scene: Scene, max_nodes: int):
    """(padded sphere table (16, Np), front boxes (8, F) float32, front
    ranges (2, F) int32 (start, padded count)) on the CPU, as
    tools/kfront.py:53 builds them with unroll 8 and leaves of 8: each
    subtree's sphere range is padded to a multiple of UNROLL (the kernel
    scans groups of 8) by repeating its last sphere; empty subtrees keep
    start and count 0."""
    bvh = build_bvh(scene, leaf_size=8)
    scene_r = reorder_scene(scene, bvh)
    fr = bvh_front(bvh, max_nodes=max_nodes)
    sph = scene_table(scene_r).numpy()
    cols = []
    new_start = np.zeros_like(fr.start)
    new_count = np.zeros_like(fr.count)
    pos = 0
    for k in range(fr.start.shape[0]):
        s, c = int(fr.start[k]), int(fr.count[k])
        if c == 0:
            continue
        cp = -(-c // UNROLL) * UNROLL
        block = sph[:, s : s + c]
        if cp > c:
            block = np.concatenate([block, np.repeat(block[:, -1:], cp - c, axis=1)], axis=1)
        new_start[k] = pos
        new_count[k] = cp
        cols.append(block)
        pos += cp
    ff = np.zeros((8, fr.fmin.shape[0]), np.float32)
    ff[0:3] = fr.fmin.T
    ff[3:6] = fr.fmax.T
    fi = np.stack([new_start, new_count]).astype(np.int32)
    t = torch.from_numpy
    return t(np.concatenate(cols, axis=1)), t(ff), t(fi)


def _ray_terms(rays):
    ox, oy, oz, dx, dy, dz, tm = rays
    a = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20)
    return ox, oy, oz, dx, dy, dz, tm, a, 1.0 / a


def column_owner(fi: torch.Tensor, n_cols: int) -> torch.Tensor:
    """(Np,) int64: the subtree owning each padded column."""
    fi = fi.cpu().numpy()
    owner = np.zeros(n_cols, np.int64)
    for k in range(fi.shape[1]):
        owner[int(fi[0, k]) : int(fi[0, k]) + int(fi[1, k])] = k
    return torch.from_numpy(owner)


def _chunked(fn, rays, n_cols: int) -> torch.Tensor:
    chunk = _twin_chunk(n_cols)
    return torch.cat([fn([x[r0:r0 + chunk] for x in rays])
                      for r0 in range(0, max(rays[0].shape[0], 1), chunk)])


def live_columns(rays, sph: torch.Tensor, ff: torch.Tensor, fi: torch.Tensor) -> torch.Tensor:
    """[R, Np] bool: the columns of subtrees whose box the ray enters
    within (t_min, inf), the spheres the front probe tests for it."""
    owner = column_owner(fi, sph.shape[1]).to(sph.device)
    ox, oy, oz, dx, dy, dz, _ = rays
    return subtree_slab_mask(ff, ox, oy, oz, dx, dy, dz, T_MIN)[:, owner]


def run_front_plain(rays, sph: torch.Tensor, ff: torch.Tensor, fi: torch.Tensor):
    """The front probe's plain version: the first minimum of t over the
    columns of live subtrees (`live_columns`); 0 on a miss."""
    def part(r):
        t = _sphere_t(sph, *_ray_terms(r), T_MIN)
        bt, _ = _first_min(torch.where(live_columns(r, sph, ff, fi), t, np.inf))
        return torch.where(bt < np.inf, bt, 0.0)

    return _chunked(part, rays, sph.shape[1])


def run_brute_plain(rays, sph: torch.Tensor):
    """The brute probe's plain version: the closest t over every column; 0
    on a miss."""
    def part(r):
        bt, _ = _first_min(_sphere_t(sph, *_ray_terms(r), T_MIN))
        return torch.where(bt < np.inf, bt, 0.0)

    return _chunked(part, rays, sph.shape[1])


def warp_schedule(rays, sph: torch.Tensor, ff: torch.Tensor, fi: torch.Tensor,
                  chunk: int = 8192) -> dict:
    """The front probe's work per warp of 32 neighbouring rays (ray r in
    lane r % 32), counted from the rays' own live columns (`live_columns`)
    word by word, as the kernel's flat loop takes them (a step tests UNROLL
    columns; a lane scans its own list and idles past its end):

    - "pairs": the lanes' own live columns, the pairs the bound charges;
    - "steps": warp steps, the longest own list of each (warp, word), so
      pairs / (steps * UNROLL * 32) of the lanes' slots do work;
    - "union_steps": the steps of the warp-vote design, the union of the
      warp's lists (every lane scans every column any lane needs);
    - "loads", "waves": the warp's float4 loads of one test plane (one a
      column position: 2 planes make twice both) and the shared-memory
      wavefronts they take: lanes reading one column share a broadcast,
      and column c of a float4 plane lies on bank group c % 8, so a load
      takes as many wavefronts as the most distinct columns of one
      residue (1 for a broadcast or for 8 neighbouring columns).

    A count of the inputs, on any device; `rays` is padded to whole warps
    with copies of ray 0, as the kernel's blocks are."""
    n_cols = sph.shape[1]
    word = column_owner(fi, n_cols).numpy() // WORD
    rays = [torch.cat([x, x[:1].expand(-(-x.shape[0] // 32) * 32 - x.shape[0])]) for x in rays]
    out = {"pairs": 0, "steps": 0, "union_steps": 0, "loads": 0, "waves": 0}
    chunk = chunk // 32 * 32
    for r0 in range(0, rays[0].shape[0], chunk):
        live = live_columns([x[r0:r0 + chunk] for x in rays], sph, ff, fi).cpu().numpy()
        for w in np.unique(word):
            m = live[:, word == w].reshape(-1, 32, int((word == w).sum()))  # [warps, 32, cols]
            lens = m.sum(axis=2)
            out["pairs"] += int(lens.sum())
            out["steps"] += int(lens.max(axis=1).sum()) // UNROLL
            out["union_steps"] += int(m.any(axis=1).sum()) // UNROLL
            n_max = int(lens.max())
            if n_max == 0:
                continue
            # each lane's i-th live column (or -1): [warps, 32, n_max]
            cols = np.where(m, np.arange(m.shape[2]), m.shape[2])
            cols = np.sort(cols, axis=2)[:, :, :n_max]
            cols = np.where(cols < m.shape[2], cols, -1)
            issued = (cols >= 0).any(axis=1)  # [warps, n_max]: the warp loads position i
            waves = np.zeros(issued.shape, np.int64)
            for q in range(8):
                v = np.sort(np.where((cols >= 0) & (cols % 8 == q), cols, -1), axis=1)
                distinct = (v[:, :1] >= 0).astype(np.int64)[:, 0] + \
                    ((v[:, 1:] != v[:, :-1]) & (v[:, 1:] >= 0)).sum(axis=1)
                waves = np.maximum(waves, distinct)
            out["loads"] += int(issued.sum())
            out["waves"] += int(waves.sum())
    return out


def run_front(rays, sph: torch.Tensor, ff: torch.Tensor, fi: torch.Tensor) -> torch.Tensor:
    """Best t (0 on a miss) of each ray of `rays` (ox, oy, oz, dx, dy, dz,
    tm; [R] float32 each) over the front tables of `pack_front_tables`
    (unroll 8, F a multiple of 24). CPU tensors run the plain version, CUDA
    tensors the kernel."""
    if rays[0].device.type == "cpu":
        return run_front_plain(rays, sph, ff, fi)
    n, n_front, r = sph.shape[1], ff.shape[1], rays[0].shape[0]
    planes = probes.kernel_rays(rays)
    dev, r_pad = planes[0].device, planes[0].shape[0]
    _require(sph, "sph", (N_ROWS, n), torch.float32, dev)
    _require(ff, "ff", (8, n_front), torch.float32, dev)
    _require(fi, "fi", (2, n_front), torch.int32, dev)
    out = torch.empty(r_pad, dtype=torch.float32, device=sph.device)
    probes.call("kfront_front", "rtp_probe_front", sph.data_ptr(), n, ff.data_ptr(),
                fi.data_ptr(), n_front, *(x.data_ptr() for x in planes), out.data_ptr(), r_pad,
                probes.stream(sph.device))
    return out[:r]


def run_brute(rays, sph: torch.Tensor) -> torch.Tensor:
    """Best t (0 on a miss) of each ray over every column of `sph` (16, n),
    unrolled x8. CPU tensors run the plain version, CUDA tensors the
    kernel."""
    if rays[0].device.type == "cpu":
        return run_brute_plain(rays, sph)
    n, r = sph.shape[1], rays[0].shape[0]
    planes = probes.kernel_rays(rays)
    _require(sph, "sph", (N_ROWS, n), torch.float32, planes[0].device)
    r_pad = planes[0].shape[0]
    out = torch.empty(r_pad, dtype=torch.float32, device=sph.device)
    probes.call("kfront_brute", "rtp_probe_hit", *probes.HIT_ARGS["kfront_brute"],
                sph.data_ptr(), n, *(x.data_ptr() for x in planes), out.data_ptr(), r_pad,
                probes.stream(sph.device))
    return out[:r]


def diverging_rays(ff: torch.Tensor, fi: torch.Tensor, n: int, seed: int = 0):
    """`n` rays (the seven planes, on the CPU) from the cover camera's eye
    whose warps diverge: even lanes aim at random points of the front's
    densest subtree's box (`ff`, `fi` of `pack_front_tables`), odd lanes
    nearly straight up, which misses every box of a scene below the eye
    (the cover scene's, make_random_scene's). The tests hold the front
    probe on them."""
    g = torch.Generator().manual_seed(seed)
    k = int(torch.argmax(fi[1]))
    lo, hi = ff[0:3, k].cpu(), ff[3:6, k].cpu()
    eye = torch.tensor(COVER_CAMERA["lookfrom"], dtype=torch.float32)
    d = lo + torch.rand((n, 3), generator=g) * (hi - lo) - eye
    up = torch.rand((n, 3), generator=g) * 0.02 - 0.01
    up[:, 1] = 1.0
    d = torch.where((torch.arange(n) % 2 == 1)[:, None], up, d)
    return probes.ray_planes(eye.expand(n, 3), d, torch.rand(n, generator=g))


def primary_rays(device, seed: int = 0, generator=None):
    """The 400x225 primary rays of the cover camera, one a pixel, row-major:
    the seven planes the probes take."""
    cam = Camera(**COVER_CAMERA)
    w, h = cam.image_size()
    dev = torch.device(device)
    pix = torch.arange(w * h, device=dev)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    o, d, t = generate_rays(cam.derive(torch.float32, dev), (pix % w).to(torch.int32),
                            (pix // w).to(torch.int32), gen)
    return probes.ray_planes(o, d, t)


def probe_scene(n_spheres: int | None) -> Scene:
    return make_random_scene(n_spheres, seed=3) if n_spheres else make_cover_scene(seed=0)


def measure(scene: Scene, device="cuda") -> dict:
    """Parity of the front against the brute probe and both probes' times
    on `scene` at the 400x225 primary rays: {"rays", "spheres",
    "brute_ms", "brute_roots", "front": {F: {"ms", "parity", "max_abs",
    "pairs", "roots", "boxes"}}}; pairs and boxes are the tests these rays
    need (the live columns of each ray, and F boxes a ray), roots (and
    brute_roots, over every column) those pairs whose discriminant is
    positive."""
    dev = probes.require_card(device)
    rays = primary_rays(dev)
    n_rays = rays[0].shape[0]
    sph_brute = scene_table(reorder_scene(scene, build_bvh(scene, leaf_size=8))).to(dev)
    ref = run_brute(rays, sph_brute)
    out = {"rays": n_rays, "spheres": scene.num_spheres, "front": {},
           "brute_roots": positive_discriminants(sph_brute, rays)}
    tables = {}
    for f in FRONTS:
        sph, ff, fi = (x.to(dev) for x in pack_front_tables(scene, max_nodes=f))
        tables[f] = (sph, ff, fi)
        got = run_front(rays, sph, ff, fi)
        close = torch.isclose(got, ref, rtol=1e-6, atol=1e-6)
        pairs = sum(int(live_columns([x[r0:r0 + 8192] for x in rays], sph, ff, fi).sum())
                    for r0 in range(0, n_rays, 8192))
        roots = positive_discriminants(sph, rays,
                                       lambda r: live_columns(r, sph, ff, fi))  # noqa: B023
        out["front"][f] = {"parity": close.double().mean().item(),
                           "max_abs": (got - ref).abs().max().item(),
                           "pairs": pairs, "roots": roots, "boxes": n_rays * ff.shape[1],
                           "columns": sph.shape[1]}

    def fresh(s):  # the pass's rays: a fresh draw of the camera's jitter and lens
        return primary_rays(dev, generator=torch.Generator(device=dev).manual_seed(s))

    pool = [probes.padded(fresh(s)) for s in range(4)]  # outside the timed passes
    out["brute_ms"] = marginal_ms(lambda s: run_brute(pool[s % 4], sph_brute), k1=8, k2=24)
    for f, (sph, ff, fi) in tables.items():
        out["front"][f]["ms"] = marginal_ms(lambda s: run_front(pool[s % 4], sph, ff, fi),
                                            k1=8, k2=24)
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    scene = probe_scene(int(argv[0]) if argv else None)
    res = measure(scene)
    n, r = res["spheres"], res["rays"]
    for f, v in res["front"].items():
        print(f"F={f}: parity {v['parity']:.6%} (max|d|={v['max_abs']:.2e})", flush=True)
    ms = res["brute_ms"]
    print(f"brute_u8  n={n}: {r / ms / 1e3:8.2f} Mrays/s ({ms:.3f} ms)", flush=True)
    for f, v in res["front"].items():
        print(f"front_{f:02d}  n={n}: {r / v['ms'] / 1e3:8.2f} Mrays/s ({v['ms']:.3f} ms)",
              flush=True)


if __name__ == "__main__":
    main()
