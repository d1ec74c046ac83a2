"""What K4 (the oracle's fused closest hit) and K7 (the global-memory
front) have to compute on a pass, counted in their plain versions'
operations: a count, not a measurement, so it runs on any device.

    python -m raytracingproject_tpu_torch.probes.pair_counts [device] [--hbm]

prints one JSON line: for the cover camera's 400x225 primary rays (one a
pixel, the oracle's pass) and for the same rays after one scatter, over
the cover scene's 487 spheres, `trace.disc_counts`: the pairs, the pairs
whose discriminant is positive (the only ones that take a square root and
roots), and the (warp of 32 consecutive rays, sphere) pairs in which some
ray's is positive (the pairs a warp cannot skip the roots of). With
`--hbm`, also `hbm_counts` for K7 on one pass of the reference frame
(400x225, 1 spp, slot order) over `make_random_scene(50000, seed=3)`'s
global-memory front, at bounce 0 and after one scatter. Default device:
cpu.
"""

from __future__ import annotations

import json
import sys

import torch

from raytracingproject_tpu_torch.camera import Camera, generate_rays
from raytracingproject_tpu_torch.config import T_MIN
from raytracingproject_tpu_torch.materials import draw_scatter
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
from raytracingproject_tpu_torch.ops.cuda import trace
from raytracingproject_tpu_torch.probes.kfront import COVER_CAMERA
from raytracingproject_tpu_torch.render import _bounce, _PathState, _slot_rays
from raytracingproject_tpu_torch.scene import make_cover_scene, make_random_scene

WARP = 32


def cover_pass(device, seed: int = 21):
    """(scene, rays): the cover scene and the cover camera's primary rays,
    one a pixel, row-major (o [R, 3], d [R, 3], time [R]), then the same
    rays after one scatter of the oracle's bounce (o, d)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cam = Camera(**COVER_CAMERA)
    w, h = cam.image_size()
    pix = torch.arange(w * h, device=dev)
    o, d, t = generate_rays(cam.derive(torch.float32, dev), (pix % w).to(torch.int32),
                            (pix // w).to(torch.int32), gen)
    scene = make_cover_scene(0, device=dev)
    n = o.shape[0]
    state = _PathState(o, d, torch.ones((n, 3), device=dev), torch.zeros((n, 3), device=dev),
                       torch.ones((n,), dtype=torch.bool, device=dev))
    state = _bounce(scene, t, state, draw_scatter(gen, (n,)), use_pallas=True)
    return scene, (o, d, t), (state.origin.contiguous(), state.direction.contiguous())


def hbm_pass(device, n_spheres: int = 50000, seed: int = 1):
    """(front, rays, rays after one scatter): `make_random_scene(n_spheres,
    seed=3)`'s global-memory front (K7's tables), one pass of the reference
    frame's camera rays (400x225, 1 spp, in `render`'s slot order, padded
    to a block multiple with parked rays: o, d, time), and the same rays
    after one bounce of the megakernel's plain version (Philox draws; dead
    rays parked as the kernel parks them)."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt

    dev = torch.device(device)
    cpu = make_random_scene(n_spheres, seed=3)
    tree = build_bvh(cpu, leaf_size=8)
    scene = reorder_scene(cpu, tree).to(dev)
    front = mk.front_tables_hbm(scene, tree)
    cam = Camera(**dict(COVER_CAMERA, samples_per_pixel=1, max_depth=16))
    w, h = cam.image_size()
    rays = _slot_rays(cam.derive(torch.float32, dev), w, h, 1,
                      torch.Generator(device=dev).manual_seed(seed), None)
    state, slot = dt.initial_state(*rays)
    tab, hit, chunk = mk.twin_closest_hit(None, front, None, dev)
    after = []
    for r0 in range(0, state.shape[1], chunk):
        planes = [state[q, r0:r0 + chunk] for q in range(mk.STATE_ROWS)]
        planes[mk.ST_ALIVE] = planes[mk.ST_ALIVE] > 0.5
        new, _ = mk._bounce_core(planes, slot[r0:r0 + chunk].long(), 0, 1, tab, hit, 41, T_MIN,
                                 False, False, False)
        after.append(torch.stack(new[:6]))
    after = torch.cat(after, dim=1)
    o, d, t = state[0:3].t(), state[3:6].t(), state[6]  # o, d, time
    return front, (o, d, t), (after[0:3].t(), after[3:6].t())


def hbm_counts(front: mk.FrontTablesHBM, o: torch.Tensor, d: torch.Tensor,
               t: torch.Tensor) -> dict:
    """K7's sphere tests on rays o, d, t (warps of 32 consecutive rays; a
    parked ray enters no box): "union_pairs", what the warp-union culling
    tests (every lane of a warp with a live ray tests every column of every
    subtree some lane of the warp enters); "own_pairs", what each ray's own
    masks select (the bound's count; both unclamped by the best t, so an
    upper bound of what either kernel tests); "warp_roots", the (warp,
    column) pairs of the union in which some lane's discriminant is
    positive, of "warp_pairs"; "own_roots", the own pairs whose
    discriminant is positive (a lane group scans one ray, so these are
    also its (group, column) pairs). Columns are the front's padded ones
    below each subtree's count."""
    dev = o.device
    n_front = front.ff.shape[1]
    n_words = n_front // mk.WORD
    n_super = -(-n_words // mk.WORD)
    word_of = torch.arange(n_front, device=dev) // mk.WORD
    super_of = torch.arange(n_words, device=dev) // mk.WORD
    cnt = front.fi[0].long()
    tab = front.sph.t()  # (16, F * BLOCK)
    keys = ("rays", "warps", "union_pairs", "own_pairs", "warp_pairs", "warp_roots", "own_roots")
    out = dict.fromkeys(keys, 0)
    step = 512  # rays at a time, whole warps
    for r0 in range(0, o.shape[0], step):
        ox, oy, oz = (o[r0:r0 + step, q].contiguous() for q in range(3))
        dx, dy, dz = (d[r0:r0 + step, q].contiguous() for q in range(3))
        tm = t[r0:r0 + step]
        live = ox < 1e17

        def enters(boxes):
            return mk.subtree_slab_mask(boxes, ox, oy, oz, dx, dy, dz, T_MIN) & live[:, None]

        if n_words == 1:
            m_word = live[:, None]
        elif n_super == 1:
            m_word = enters(front.wf)[:, :n_words]
        else:
            m_word = enters(front.wf)[:, :n_words] & enters(front.sf)[:, :n_super][:, super_of]
        m_sub = enters(front.ff) & m_word[:, word_of]  # [r, F]
        out["rays"] += int(live.sum())
        out["own_pairs"] += int((m_sub * cnt).sum())
        a = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20)
        for w0 in range(0, ox.shape[0], WARP):
            lanes = slice(w0, w0 + WARP)
            if not bool(live[lanes].any()):
                continue
            union = m_sub[lanes].any(dim=0)
            subs = torch.nonzero(union)[:, 0]
            if subs.numel() == 0:
                out["warps"] += 1
                continue
            offs = torch.arange(mk.BLOCK, device=dev)
            cols = (subs[:, None] * mk.BLOCK + offs)[offs[None, :] < cnt[subs][:, None]]
            n_lanes = min(WARP, ox.shape[0] - w0)
            _, disc = mk._sphere_disc(tab, *(x[lanes] for x in (ox, oy, oz, dx, dy, dz, tm, a)),
                                      cols=cols[None, :].expand(n_lanes, -1))
            pos = disc > 0.0
            own = m_sub[lanes][:, cols // mk.BLOCK]
            out["warps"] += 1
            out["union_pairs"] += WARP * cols.numel()
            out["warp_pairs"] += cols.numel()
            out["warp_roots"] += int(pos.any(dim=0).sum())
            out["own_roots"] += int((pos & own).sum())
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    hbm = "--hbm" in argv
    argv = [a for a in argv if a != "--hbm"]
    device = argv[0] if argv else "cpu"
    scene, (o, d, t), (o2, d2) = cover_pass(device)
    tab = trace.sphere_table(scene)
    out = {}
    for name, (ro, rd) in (("primary", (o, d)), ("after one scatter", (o2, d2))):
        c = trace.disc_counts(ro, rd, t, tab)
        out[name] = {**c, "roots_share": c["roots"] / c["pairs"],
                     "warp_roots_share": c["warp_roots"] / c["warps"]}
    line = {"rays": o.shape[0], "spheres": tab.shape[1], **out}
    if hbm:
        front, (o, d, t), (o2, d2) = hbm_pass(device)
        k7 = {}
        for name, (ro, rd) in (("bounce 0", (o, d)), ("after one scatter", (o2, d2))):
            c = hbm_counts(front, ro, rd, t)
            k7[name] = {**c, "union_over_own": c["union_pairs"] / max(c["own_pairs"], 1),
                        "warp_roots_share": c["warp_roots"] / max(c["warp_pairs"], 1),
                        "own_roots_share": c["own_roots"] / max(c["own_pairs"], 1)}
        line["K7, 50,000 spheres"] = {"subtrees": front.ff.shape[1], **k7}
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
