"""What K4 (the oracle's fused closest hit), K3 (the front in shared
memory), K7 (the global-memory front) and K8 (the BVH walk) have to
compute on a pass, counted in their plain versions' operations: a count,
not a measurement, so it runs on any device.

    python -m raytracingproject_tpu_torch.probes.pair_counts [device] [--front] [--hbm] [--bvh] \
        [--kfront]

prints one JSON line: for the cover camera's 400x225 primary rays (one a
pixel, the oracle's pass) and for the same rays after one scatter, over
the cover scene's 487 spheres, `trace.disc_counts`: the pairs, the pairs
whose discriminant is positive (the only ones that take a square root and
roots), and the (warp of 32 consecutive rays, sphere) pairs in which some
ray's is positive (the pairs a warp cannot skip the roots of). With
`--hbm`, also `hbm_counts` for K7 on one pass of the reference frame
(400x225, 1 spp, slot order) over `make_random_scene(50000, seed=3)`'s
global-memory front, at bounce 0 and after one scatter. With `--bvh`,
`bvh_counts` for K8 on the same pass over the same scene's leaf-8 tree:
the miss-link walk (the plain version's) and the kernel's ordered walk,
one ray a thread, whose count K8's bound reads. With `--front`,
`front_counts` for K3 on the same pass over the cover scene's front and
over `make_random_scene(3000, seed=3)`'s (the largest the shared memory
holds), each as `render` builds it at the bench shape, at bounce 0 and
after one scatter: the warp union's work against each ray's own, the
kernel's own work (its clamps included), and the warp steps of the union,
of one lane a ray and of the warp-level lane groups. With `--kfront`,
`kfront.warp_schedule` for kfront's front probe on the cover camera's
primary rays (its own measurement's rays, drawn on `device`) over the
cover scene's and `make_random_scene(2000, seed=3)`'s fronts at F = 24
and 48: the warp steps of the rays' own lists and of the warp's union,
and the shared-memory wavefronts of the staged table's loads. Default
device: cpu.

`ordered_walk` is the ordered walk itself in plain PyTorch, which
tests/test_torch_bvh_groups.py holds against the plain version;
`front_walk` is the front kernels' culling (K3, K6's front segment, K7),
clamps included, which tests/test_torch_front_warp_groups.py and
tests/test_torch_hbm_groups.py hold against the plain versions.
"""

from __future__ import annotations

import itertools
import json
import math
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
    scene, tree = _large_scene(device, n_spheres)
    front = mk.front_tables_hbm(scene, tree)
    return (front, *_pass_rays(device, seed, front=front))


def front_pass(device, scene_cpu, seed: int = 1):
    """(front, rays, rays after one scatter): `scene_cpu`'s K3 front as
    `render` builds it at the bench shape (leaf-8 tree, subtrees ordered
    near-to-far from the cover camera, repack 2, within the shared-memory
    budget), and one pass of the reference frame's rays before and after
    one bounce of the front's plain version (as `hbm_pass`)."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene

    tree = build_bvh(scene_cpu, leaf_size=8)
    scene = reorder_scene(scene_cpu, tree).to(torch.device(device))
    front = mk.front_tables(scene, tree, order_point=COVER_CAMERA["lookfrom"], repack=2)
    return (front, *_pass_rays(device, seed, front=front))


def bvh_pass(device, n_spheres: int = 50000, seed: int = 1):
    """(leaf-ordered scene, its leaf-8 tree's BVHTables, rays, rays after
    one scatter): as `hbm_pass`, the scatter through the BVH walk's plain
    version."""
    scene, tree = _large_scene(device, n_spheres)
    tables = mk.bvh_tables(tree, device)
    return (scene, tables, *_pass_rays(device, seed, scene=scene, bvh=tables))


def _large_scene(device, n_spheres: int):
    """`make_random_scene(n_spheres, seed=3)` in the leaf order of its leaf-8
    tree, on `device`, and the tree."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene

    cpu = make_random_scene(n_spheres, seed=3)
    tree = build_bvh(cpu, leaf_size=8)
    return reorder_scene(cpu, tree).to(torch.device(device)), tree


def _pass_rays(device, seed: int, scene=None, front=None, bvh=None):
    """One pass of the reference frame's rays and the same rays after one
    bounce of the plain version of the closest hit `trace_paths` takes for
    these arguments (see `hbm_pass`)."""
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt

    dev = torch.device(device)
    cam = Camera(**dict(COVER_CAMERA, samples_per_pixel=1, max_depth=16))
    w, h = cam.image_size()
    rays = _slot_rays(cam.derive(torch.float32, dev), w, h, 1,
                      torch.Generator(device=dev).manual_seed(seed), None)
    state, slot = dt.initial_state(*rays)
    tab, hit, chunk = mk.twin_closest_hit(scene, front, bvh, dev)
    after = []
    for r0 in range(0, state.shape[1], chunk):
        planes = [state[q, r0:r0 + chunk] for q in range(mk.STATE_ROWS)]
        planes[mk.ST_ALIVE] = planes[mk.ST_ALIVE] > 0.5
        new, _ = mk._bounce_core(planes, slot[r0:r0 + chunk].long(), 0, 1, tab, hit, 41, T_MIN,
                                 False, False, False)
        after.append(torch.stack(new[:6]))
    after = torch.cat(after, dim=1)
    o, d, t = state[0:3].t(), state[3:6].t(), state[6]  # o, d, time
    return (o, d, t), (after[0:3].t(), after[3:6].t())


def _take_less(bt, bc, ot, oc):
    """Keep (ot, oc) where it is lexicographically less than (bt, bc)."""
    less = (ot < bt) | ((ot == bt) & (oc < bc))
    return torch.where(less, ot, bt), torch.where(less, oc, bc)


def ordered_walk(nodes: torch.Tensor, tab: torch.Tensor, rays, t_min: float = T_MIN,
                 strict: bool = False, counts: dict | None = None,
                 ray_steps: list | None = None):
    """K8's ordered walk (csrc/megakernel.cu `closest_hit_bvh`) in plain
    PyTorch, every ray with its own record pointer and stack, over the node
    records `nodes` (`bvh_tables`) and the leaf-ordered table `tab` (16,
    N); rays are the nine planes (o xyz, d xyz, time, a, 1 / a) the
    closest hits take. At an inner record both children's boxes are tested
    within (t_min, best t] (`strict`: within (t_min, best t), the clamp
    the walk must not take), the nearer child is entered first (the first
    on equal entries) and the other deferred with its entry t; a deferred
    child is dropped when popped past the best t (`strict`: at it). A
    leaf's spheres update (t, column) lexicographically from the plain
    version's candidate roots (`_sphere_t`). Returns (best t, winner column
    or -1).

    With `counts`, adds for the rays that are not parked: "records" (inner
    records visited), "boxes" (two a record), "leaves", "pairs" (sphere
    tests), "roots" (those with a positive discriminant) and "steps"
    (records plus a leaf's spheres: the walk's dependent chain, one record
    or sphere at a time). With `ray_steps`, appends each ray's steps ([R]
    float64, 0 for a parked ray)."""
    ox, oy, oz, dx, dy, dz, tm, a, inv_a = rays
    dev, n, dt = ox.device, ox.shape[0], ox.dtype
    inv = [1.0 / torch.where(torch.abs(v) > 1e-20, v, 1e-20) for v in (dx, dy, dz)]
    org = (ox, oy, oz)
    box = nodes.view(torch.float32).to(dt)
    ref = torch.zeros(n, dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stk_t = torch.zeros((n, mk.BVH_STACK), dtype=dt, device=dev)
    stk_ref = torch.zeros((n, mk.BVH_STACK), dtype=torch.int64, device=dev)
    far = torch.full((n,), math.inf, dtype=dt, device=dev)
    win = torch.zeros(n, dtype=torch.int64, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    counted = (ox < 1e17).double()
    steps = torch.zeros(n, dtype=torch.float64, device=dev)
    keys = ("records", "boxes", "leaves", "pairs", "roots")
    tally = torch.zeros(len(keys), dtype=torch.float64, device=dev)  # read once, at the end

    def enters(lo, hi, rows):
        """Does each row's ray enter its box within (t_min, best t]? And where."""
        tn = tf = None
        for q in range(3):
            t0 = (lo[:, q] - org[q][rows]) * inv[q][rows]
            t1 = (hi[:, q] - org[q][rows]) * inv[q][rows]
            near, away = torch.minimum(t0, t1), torch.maximum(t0, t1)
            if q == 2:
                near = torch.clamp_min(near, t_min)
            tn = near if tn is None else torch.maximum(tn, near)
            tf = away if tf is None else torch.minimum(tf, away)
        within = tn < far[rows] if strict else tn <= far[rows]
        return (tf > tn) & within, tn

    while bool(active.any()):
        act = torch.nonzero(active)[:, 0]
        pop = torch.zeros(n, dtype=torch.bool, device=dev)
        inner, leaf = act[ref[act] >= 0], act[ref[act] < 0]
        if inner.numel():
            k = ref[inner]
            in0, tn0 = enters(box[k, 0:3], box[k, 4:7], inner)
            in1, tn1 = enters(box[k, 8:11], box[k, 12:15], inner)
            r0, r1 = nodes[k, 3].long(), nodes[k, 7].long()
            first0 = tn0 <= tn1
            both = in0 & in1
            b = inner[both]
            stk_t[b, sp[b]] = torch.where(first0, tn1, tn0)[both]
            stk_ref[b, sp[b]] = torch.where(first0, r1, r0)[both]
            sp[b] += 1
            go = in0 | in1
            ref[inner[go]] = torch.where(both, torch.where(first0, r0, r1),
                                         torch.where(in0, r0, r1))[go]
            pop[inner[~go]] = True
            steps[inner] += 1.0
            c = counted[inner].sum()
            tally[0] += c
            tally[1] += 2.0 * c
        if leaf.numel():
            packed = ~ref[leaf]
            start, cnt = packed >> 8, packed & 255
            offs = torch.arange(int(cnt.max()), device=dev)
            cols = torch.clamp_max(start[:, None] + offs[None, :], tab.shape[1] - 1)
            valid = offs[None, :] < cnt[:, None]
            planes = [x[leaf] for x in rays]
            t = torch.where(valid, mk._sphere_t(tab, *planes, t_min, cols=cols), math.inf)
            i = torch.argmin(t, dim=1, keepdim=True)  # ascending columns: the first
            lt, lc = torch.gather(t, 1, i)[:, 0], torch.gather(cols, 1, i)[:, 0]
            far[leaf], win[leaf] = _take_less(far[leaf], win[leaf], lt, lc)
            pop[leaf] = True
            steps[leaf] += cnt.double()
            if counts is not None:
                w = counted[leaf]
                _, disc = mk._sphere_disc(tab, *planes[:8], cols=cols)
                tally[2] += w.sum()
                tally[3] += (cnt * w).sum()
                tally[4] += (((disc > 0.0) & valid).sum(dim=1) * w).sum()
        rows = torch.nonzero(pop)[:, 0]
        while rows.numel():  # drop the deferred children entered past the best t
            top = stk_t[rows, (sp[rows] - 1).clamp_min(0)]
            past = top >= far[rows] if strict else top > far[rows]
            drop = (sp[rows] > 0) & past
            if not bool(drop.any()):
                break
            sp[rows[drop]] -= 1
        empty = sp[rows] == 0
        active[rows[empty]] = False
        rows = rows[~empty]
        sp[rows] -= 1
        ref[rows] = stk_ref[rows, sp[rows]]
    steps *= counted
    if counts is not None:
        for k, v in zip(keys, tally.tolist()):
            counts[k] = counts.get(k, 0) + int(v)
        counts["steps"] = counts.get("steps", 0) + float(steps.sum())
    if ray_steps is not None:
        ray_steps.append(steps)
    return far, torch.where(far < math.inf, win, -1)


def bvh_counts(scene, tables: mk.BVHTables, o: torch.Tensor, d: torch.Tensor,
               t: torch.Tensor) -> dict:
    """K8's work on rays o, d, t (one pass in slot order, whole warps):
    the miss-link walk's "boxes", "pairs" and "roots"
    (`closest_hit_bvh_twin(counts=)`; its dependent chain "steps" = boxes
    + pairs, one node or sphere at a time) and the kernel's ordered walk's
    (`ordered_walk`, one ray a thread, each ray's result checked equal to
    the miss-link walk's). "warp_steps": the sum over warps of 32
    consecutive rays of their longest ray's steps (a warp walks while one
    of its rays does)."""
    tab = mk.scene_table(scene).to(o.device)
    n = o.shape[0]
    planes = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t]
    dx, dy, dz = planes[3:6]
    a = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20)
    rays = [x.contiguous() for x in (*planes, a, 1.0 / a)]
    plain, ordered, parts = {"boxes": 0, "pairs": 0}, {}, []
    for r0 in range(0, n, 4096):
        sl = [x[r0:r0 + 4096] for x in rays]
        want = mk.closest_hit_bvh_twin(tab, tables.flat, *sl, counts=plain)
        got = ordered_walk(tables.nodes, tab, sl, counts=ordered, ray_steps=parts)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError("the ordered walk differs from the plain version")
    plain["steps"] = plain["boxes"] + plain["pairs"]
    ordered["warp_steps"] = float(torch.cat(parts).view(-1, WARP).max(dim=1).values.sum())
    return {"rays": int((rays[0] < 1e17).sum()), "miss-link walk": plain,
            "ordered walk": ordered}


def front_walk(front, tab: torch.Tensor):
    """The front kernels' culling in plain PyTorch, one ray as one lane
    group runs it: K3 and K6's front segment (`front_group_word`, `front`
    a FrontTables, `tab` its table `front.sph`) and K7 (`hbm_group_word`, a
    FrontTablesHBM, `tab` its visited columns as `twin_closest_hit` gives
    them). Returns walk(rays, t_min, counts=None) -> (best t, column of
    `tab` or -1), rays the nine planes the closest hits take.

    Stage 1 (super-word and word boxes) is not clamped. Then, for each word
    the ray enters, in ascending order: with `word_earlyout`, the word's
    box within (t_min, best t so far]; for each of the word's chunks
    (`repack` of them for K3, one for K7), the chunk's subtree boxes within
    the best t so far; with sub-block boxes (`bf`), each live subtree's
    8-column group boxes within the best t so far; then the columns of what
    is left, (t, column) kept lexicographically. The best t at each test
    is the least t of every column scanned before it, which is what a
    group's `group_min` of its lanes' carries reads. The result equals the
    plain version's (a clamped box holds no strictly closer hit).

    With `counts`, adds for the rays that are not parked: "boxes" (box
    tests), "pairs" (columns scanned, padding included) and "roots" (those
    whose discriminant is positive): what the kernel's groups test."""
    hbm = isinstance(front, mk.FrontTablesHBM)
    n_front = front.ff.shape[1]
    n_words = n_front // mk.WORD
    n_super = -(-n_words // mk.WORD)
    per = mk.WORD if hbm else mk.WORD // front.repack
    dev = tab.device
    if hbm:  # the visited columns of subtree s, compacted in ascending order
        cnt = front.fi[0].long().tolist()
        start = list(itertools.accumulate(cnt, initial=0))[:-1]
        bf0 = [s * front.ksub for s in range(n_front)]
    else:
        start, cnt = front.fi[0].long().tolist(), front.fi[1].long().tolist()
        bf0 = [s0 // mk.UNROLL for s0 in start]
    sub_cols = [torch.arange(start[s], start[s] + cnt[s], device=dev) for s in range(n_front)]
    chunks = []  # (first subtree, columns, each column's subtree in the chunk)
    for s0 in range(0, n_front, per):
        cols = torch.cat(sub_cols[s0:s0 + per])
        rel = torch.cat([torch.full((cnt[s],), s - s0, dtype=torch.int64, device=dev)
                         for s in range(s0, s0 + per)])
        chunks.append((s0, cols, rel))
    super_of = torch.arange(n_words, device=dev) // mk.WORD

    def walk(rays, t_min: float = T_MIN, counts: dict | None = None):
        ox, oy, oz, dx, dy, dz, tm, a, _ = rays
        geo = (ox, oy, oz, dx, dy, dz)
        n = ox.shape[0]
        live = ox < 1e17
        t = mk._sphere_t(tab, *rays, t_min)
        pos = mk._sphere_disc(tab, *geo, tm, a)[1] > 0.0
        best_t = torch.full((n,), math.inf, dtype=t.dtype, device=dev)
        best_c = torch.full((n,), -1, dtype=torch.int64, device=dev)
        got = {"boxes": torch.zeros((), dtype=torch.int64, device=dev),
               "pairs": torch.zeros((), dtype=torch.int64, device=dev),
               "roots": torch.zeros((), dtype=torch.int64, device=dev)}

        def enters(boxes, far=None):
            return mk.subtree_slab_mask(boxes, *geo, t_min, far) & live[:, None]

        def scan(cols, scanned):  # the columns `scanned` [n, len(cols)] selects
            nonlocal best_t, best_c
            ts = torch.where(scanned, t[:, cols], math.inf)
            gt = ts.min(dim=1).values
            gc = torch.where(ts == gt[:, None], cols, tab.shape[1]).min(dim=1).values
            best_t, best_c = _take_less(best_t, best_c, gt, torch.where(gt < math.inf, gc, -1))
            got["pairs"] += scanned.sum()
            got["roots"] += (scanned & pos[:, cols]).sum()

        if n_words == 1:
            m_word = live[:, None]
        elif n_super == 1:
            got["boxes"] += live.sum() * n_words
            m_word = enters(front.wf)[:, :n_words]
        else:
            m_super = enters(front.sf)[:, :n_super]
            got["boxes"] += live.sum() * n_super + m_super.sum() * mk.WORD
            m_word = enters(front.wf)[:, :n_words] & m_super[:, super_of]
        for w in range(n_words):
            lw = m_word[:, w]
            if not bool(lw.any()):
                continue
            if front.word_earlyout:
                got["boxes"] += lw.sum()
                lw = lw & enters(front.wf[:, w:w + 1], best_t)[:, 0]
            for s0, cols, rel in chunks[w * (mk.WORD // per):(w + 1) * (mk.WORD // per)]:
                got["boxes"] += lw.sum() * per
                m = enters(front.ff[:, s0:s0 + per], best_t) & lw[:, None]
                if front.bf is None:
                    scan(cols, m[:, rel])
                    continue
                for k in range(per):
                    s = s0 + k
                    if cnt[s] == 0 or not bool(m[:, k].any()):
                        continue
                    n_grp = cnt[s] // mk.UNROLL
                    got["boxes"] += m[:, k].sum() * n_grp
                    grp = enters(front.bf[:, bf0[s]:bf0[s] + n_grp], best_t) & m[:, k:k + 1]
                    scan(sub_cols[s], grp.repeat_interleave(mk.UNROLL, dim=1))
        if counts is not None:
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + int(v)
        return best_t, best_c

    return walk


def hbm_counts(front: mk.FrontTablesHBM, o: torch.Tensor, d: torch.Tensor,
               t: torch.Tensor) -> dict:
    """K7's sphere tests on rays o, d, t (warps of 32 consecutive rays; a
    parked ray enters no box): "union_pairs", what the warp-union culling
    tests (every lane of a warp with a live ray tests every column of every
    subtree some lane of the warp enters); "own_pairs", what each ray's own
    masks select (both unclamped by the best t, so an upper bound of what
    either kernel tests; the bound reads `front_walk`'s count, clamps
    included); "warp_roots", the (warp, column) pairs of the union in which
    some lane's discriminant is positive, of "warp_pairs"; "own_roots", the own pairs whose
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


def front_counts(front: mk.FrontTables, o: torch.Tensor, d: torch.Tensor,
                 t: torch.Tensor) -> dict:
    """K3's sphere tests on rays o, d, t (warps of 32 consecutive rays, as
    K3 maps 256 neighbouring rays a block; a parked ray enters no box):
    "kernel_pairs", "kernel_roots" and "kernel_boxes", what the kernel's
    groups test, clamps included (`front_walk`; the bound's count); the
    rest unclamped by the best t, so upper bounds of what a kernel tests:
    "own_pairs", the columns each live ray's own masks select (super-word,
    word and subtree boxes; equal to the mask sum of
    `closest_hit_front_twin`); "own_roots", those whose discriminant is
    positive; "union_pairs", what the warp-union culling tests (every lane
    of a warp with a live ray, every column of every subtree some lane
    enters). Warp steps, summed over the warps with a live ray (a warp
    scans while one lane does): "union_steps", the union's columns;
    "longest_steps", the longest lane's own columns (one lane a ray);
    "group_steps", the warp-level lane groups: with L live lanes each ray
    over G = the largest power of two <= 32 / L lanes, each of its
    `repack` chunks' live columns dealt over them (ceil(n / G) steps a
    chunk), the warp's longest ray."""
    dev = o.device
    n_front = front.ff.shape[1]
    n_words = n_front // mk.WORD
    n_super = -(-n_words // mk.WORD)
    per = mk.WORD // front.repack
    word_of = torch.arange(n_front, device=dev) // mk.WORD
    super_of = torch.arange(n_words, device=dev) // mk.WORD
    cnt = front.fi[1].double()
    owner = front.column_subtree()
    keys = ("rays", "warps", "own_pairs", "own_roots", "union_pairs", "union_steps",
            "longest_steps", "group_steps")
    out = dict.fromkeys(keys, 0)
    walk, walked = front_walk(front, front.sph), {}
    step = 4096  # rays at a time, whole warps
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
        own = m_sub.double() @ cnt
        a = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20)
        walk((ox, oy, oz, dx, dy, dz, tm, a, 1.0 / a), T_MIN, counts=walked)
        _, disc = mk._sphere_disc(front.sph, ox, oy, oz, dx, dy, dz, tm, a)
        n_warps = ox.shape[0] // WARP
        lanes = live.view(n_warps, WARP)
        has = lanes.any(dim=1)
        union = m_sub.view(n_warps, WARP, n_front).any(dim=1).double() @ cnt
        n_live = lanes.sum(dim=1).clamp_min(1)
        g = 2 ** torch.floor(torch.log2((WARP // n_live).double()))  # G of each warp
        chunks = (m_sub.double() * cnt).view(-1, n_front // per, per).sum(dim=2)
        steps = torch.ceil(chunks / g.repeat_interleave(WARP)[:, None]).sum(dim=1)
        out["rays"] += int(live.sum())
        out["warps"] += int(has.sum())
        out["own_pairs"] += int(own.sum())
        out["own_roots"] += int(((disc > 0.0) & m_sub[:, owner]).sum())
        out["union_pairs"] += int(WARP * union[has].sum())
        out["union_steps"] += int(union[has].sum())
        out["longest_steps"] += int(own.view(n_warps, WARP).max(dim=1).values.sum())
        out["group_steps"] += int(steps.view(n_warps, WARP).max(dim=1).values.sum())
    return {**out, **{f"kernel_{k}": v for k, v in walked.items()}}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    hbm, bvh, front, kf = (f in argv for f in ("--hbm", "--bvh", "--front", "--kfront"))
    argv = [a for a in argv if a not in ("--hbm", "--bvh", "--front", "--kfront")]
    device = argv[0] if argv else "cpu"
    scene, (o, d, t), (o2, d2) = cover_pass(device)
    tab = trace.sphere_table(scene)
    out = {}
    for name, (ro, rd) in (("primary", (o, d)), ("after one scatter", (o2, d2))):
        c = trace.disc_counts(ro, rd, t, tab)
        out[name] = {**c, "roots_share": c["roots"] / c["pairs"],
                     "warp_roots_share": c["warp_roots"] / c["warps"]}
    line = {"rays": o.shape[0], "spheres": tab.shape[1], **out}
    if front:
        for label, cpu in (("K3, cover", make_cover_scene(0)),
                           ("K3, 3,000 spheres", make_random_scene(3000, seed=3))):
            fr, (o, d, t), (o2, d2) = front_pass(device, cpu)
            k3 = {}
            for name, (ro, rd) in (("bounce 0", (o, d)), ("after one scatter", (o2, d2))):
                c = front_counts(fr, ro, rd, t)
                k3[name] = {**c, "union_over_own": c["union_pairs"] / max(c["own_pairs"], 1),
                            "own_roots_share": c["own_roots"] / max(c["own_pairs"], 1),
                            "kernel_over_own": c["kernel_pairs"] / max(c["own_pairs"], 1),
                            "union_over_groups": c["union_steps"] / max(c["group_steps"], 1),
                            "longest_over_groups": c["longest_steps"] / max(c["group_steps"], 1)}
            line[label] = {"subtrees": fr.ff.shape[1], "columns": fr.sph.shape[1],
                           "repack": fr.repack, **k3}
    if bvh:
        scene, tables, (o, d, t), (o2, d2) = bvh_pass(device)
        k8 = {name: bvh_counts(scene, tables, ro, rd, t)
              for name, (ro, rd) in (("bounce 0", (o, d)), ("after one scatter", (o2, d2)))}
        line["K8, 50,000 spheres"] = {"records": tables.nodes.shape[0], "depth": tables.depth,
                                      **k8}
    if hbm:
        front, (o, d, t), (o2, d2) = hbm_pass(device)
        k7 = {}
        for name, (ro, rd) in (("bounce 0", (o, d)), ("after one scatter", (o2, d2))):
            c = hbm_counts(front, ro, rd, t)
            k7[name] = {**c, "union_over_own": c["union_pairs"] / max(c["own_pairs"], 1),
                        "warp_roots_share": c["warp_roots"] / max(c["warp_pairs"], 1),
                        "own_roots_share": c["own_roots"] / max(c["own_pairs"], 1)}
        line["K7, 50,000 spheres"] = {"subtrees": front.ff.shape[1], **k7}
    if kf:
        from raytracingproject_tpu_torch.probes import kfront

        rays = kfront.primary_rays(device)
        for n in (None, 2000):
            sc = kfront.probe_scene(n)
            for f in kfront.FRONTS:
                tabs = [x.to(device) for x in kfront.pack_front_tables(sc, max_nodes=f)]
                c = kfront.warp_schedule(rays, *tabs)
                line[f"kfront front F={f}, {'cover' if n is None else f'{n:,} spheres'}"] = {
                    "columns": tabs[0].shape[1], **c,
                    "union_over_steps": c["union_steps"] / max(c["steps"], 1),
                    "lane_efficiency": c["pairs"] / max(c["steps"] * kfront.UNROLL * 32, 1),
                    "waves_per_load": c["waves"] / max(c["loads"], 1)}
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
