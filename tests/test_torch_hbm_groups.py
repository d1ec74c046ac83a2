"""K7's partition of the work (csrc/megakernel.cu, `closest_hit_hbm`: the
global-memory front), modelled in plain PyTorch and held bit for bit
against K7's plain version, `closest_hit_hbm_twin`.

On the card each of a block's L live rays gets G = the largest power of two
<= 256 / L of the block's threads, at most 32. The group runs stage 1 on
its ray's own masks (super-words, words); for each live word, in ascending
order, the group's best t so far clamps the word's own box (with
`word_earlyout`) and its 24 subtree boxes, dealt over the lanes; the
columns sid * 128 .. + count of each live subtree, in ascending order, are
dealt over the lanes (lane g takes the g-th, (g + G)-th, ... of the word's
live columns), or with sub-block boxes only the columns of the 8-column
groups whose box the ray enters within the group's best t at that subtree;
each lane keeps its first minimum with a strict `<`; at the end the group
reduces (t, column) lexicographically (an xor butterfly of shuffles). The
model below does the same on the plain version's candidate roots
(`_sphere_t`), so the claim that this is K7's plain function (each ray's
columns masked by its own unclamped slab tests, the first minimum in
column order, ties included) is checked for every G: on the plain front,
with `word_earlyout`, with `sub_block`, on a front with super-words (more
than 576 subtrees), on exact ties and on parked rays. The kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
from raytracingproject_tpu_torch.config import T_MIN
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
from raytracingproject_tpu_torch.probes.pair_counts import front_walk
from raytracingproject_tpu_torch.scene import make_cover_scene, make_random_scene

THREADS = 256   # threads (rays) of a block, csrc/megakernel.cu TPB
MAX_GROUP = 32  # a group is part of one warp
GROUPS = [1 << k for k in range(6)]  # every G a live ray can get: 1 .. 32
WORD = mk.WORD
BLOCK = mk.BLOCK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread: the shapes are small, and a parallel test
    run's workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def group_size(live: int) -> int:
    """G for `live` live rays: `min(1 << (31 - __clz(TPB / L)), 32)`."""
    return min(1 << ((THREADS // live).bit_length() - 1), MAX_GROUP)


def _slab(boxes, ox, oy, oz, dx, dy, dz, far):
    """[R, n] `slab` of csrc/common.cuh: the ray enters box k within
    (T_MIN, far], `far` [R] (the clamp the kernel gives each ray)."""
    def inv(d):
        return 1.0 / torch.where(torch.abs(d) > 1e-20, d, 1e-20)

    col = lambda x: x[:, None]  # noqa: E731
    row = lambda i: boxes[i][None, :]  # noqa: E731
    idx, idy, idz = col(inv(dx)), col(inv(dy)), col(inv(dz))
    t0, t1 = (row(0) - col(ox)) * idx, (row(3) - col(ox)) * idx
    tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
    t0, t1 = (row(1) - col(oy)) * idy, (row(4) - col(oy)) * idy
    tn, tf = torch.maximum(tn, torch.minimum(t0, t1)), torch.minimum(tf, torch.maximum(t0, t1))
    t0, t1 = (row(2) - col(oz)) * idz, (row(5) - col(oz)) * idz
    tn = torch.maximum(tn, torch.clamp_min(torch.minimum(t0, t1), T_MIN))
    tf = torch.minimum(torch.minimum(tf, torch.maximum(t0, t1)), col(far))
    return tf > tn


def _take_less(bt, bc, ot, oc):
    """Keep (ot, oc) where it is lexicographically less than (bt, bc)."""
    less = (ot < bt) | ((ot == bt) & (oc < bc))
    return torch.where(less, ot, bt), torch.where(less, oc, bc)


def grouped_hbm_hit(front: mk.FrontTablesHBM, rays, g_size: int, counts: dict | None = None):
    """K7's closest hit of R rays, each over a group of `g_size` lanes:
    (best t, winner padded column or -1), culled, scanned and reduced as
    the kernel's groups do. With `counts`, adds the columns the groups scan
    ("pairs")."""
    geo = rays[:6]
    t = mk._sphere_t(front.sph.t(), *rays, T_MIN)  # [R, F * BLOCK] candidate roots
    r = t.shape[0]
    inf = torch.full((r,), math.inf, dtype=t.dtype)
    cnt = front.fi[0].tolist()
    n_words = front.ff.shape[1] // WORD
    n_super = -(-n_words // WORD)
    # stage 1 on the ray's own masks (unclamped), as group_live_words descends
    if n_words == 1:
        word_live = torch.ones((r, 1), dtype=torch.bool)
    elif n_super == 1:
        word_live = _slab(front.wf[:, :n_words], *geo, inf)
    else:
        sup = _slab(front.sf[:, :n_super], *geo, inf)
        word_live = _slab(front.wf[:, :n_words], *geo, inf) & sup[:, torch.arange(n_words) // WORD]
    best = inf.clone()  # the group's best t so far (group_min of its lanes' carries)
    lane_t = torch.full((r, g_size), math.inf, dtype=t.dtype)
    lane_c = torch.zeros((r, g_size), dtype=torch.int64)  # the kernel's carry starts (inf, 0)
    width = WORD * BLOCK
    for w in range(n_words):
        far = best.clone()
        live_w = word_live[:, w]
        if front.word_earlyout:
            live_w = live_w & _slab(front.wf[:, w:w + 1], *geo, far)[:, 0]
        sub = _slab(front.ff[:, w * WORD:(w + 1) * WORD], *geo, far) & live_w[:, None]
        cols = torch.zeros((r, width), dtype=torch.bool)  # the word's columns each ray scans
        for k in range(WORD):
            sid, n = w * WORD + k, cnt[w * WORD + k]
            if n == 0:
                continue
            if front.ksub:
                grp = _slab(front.bf[:, sid * front.ksub:sid * front.ksub + n // mk.UNROLL],
                            *geo, best) & sub[:, k:k + 1]
                scanned = grp.repeat_interleave(mk.UNROLL, dim=1)
            else:
                scanned = sub[:, k:k + 1].expand(r, n)
            cols[:, k * BLOCK:k * BLOCK + n] = scanned
            seen = torch.where(scanned, t[:, sid * BLOCK:sid * BLOCK + n], math.inf)
            best = torch.minimum(best, seen.min(dim=1).values)
        if counts is not None:
            counts["pairs"] = counts.get("pairs", 0) + int(cols.sum())
        tw = torch.where(cols, t[:, w * width:(w + 1) * width], math.inf)
        lane = (torch.cumsum(cols, dim=1) - 1) % g_size  # place in the word's live columns
        for g in range(g_size):  # each lane's strict-`<` scan keeps its first minimum
            gt, gc = mk._first_min(torch.where(cols & (lane == g), tw, math.inf))
            better = gt < lane_t[:, g]
            lane_t[:, g] = torch.where(better, gt, lane_t[:, g])
            lane_c[:, g] = torch.where(better, w * width + gc, lane_c[:, g])
    lanes = torch.arange(g_size)
    off = g_size // 2
    while off:  # __shfl_xor_sync within the group
        lane_t, lane_c = _take_less(lane_t, lane_c, lane_t[:, lanes ^ off], lane_c[:, lanes ^ off])
        off //= 2
    return lane_t[:, 0], torch.where(lane_t[:, 0] < math.inf, lane_c[:, 0], -1)


def _twin_hit(front: mk.FrontTablesHBM, rays):
    """`closest_hit_hbm_twin`'s (t, winner), its column mapped from the
    visited columns back to the padded table's."""
    cols = front.valid_columns()
    tab = front.sph[cols].t().contiguous()
    group = None if front.bf is None else cols // mk.UNROLL
    bt, win = mk.closest_hit_hbm_twin(front, tab, cols // BLOCK, group, *rays, T_MIN)
    return bt, torch.where(win >= 0, cols[win.clamp_min(0)], -1)


def _front(scene_cpu, leaf_size: int = 8, **kw):
    tree = build_bvh(scene_cpu, leaf_size=leaf_size)
    scene = reorder_scene(scene_cpu, tree)
    return scene, mk.front_tables_hbm(scene, tree, order_point=(13.0, 2.0, 3.0), **kw)


def _rays(scene, n_rays: int, seed: int, parked: int = 0):
    """Rays from the cover camera's side: half aimed at random spheres'
    centres (at the ray's time), half in random directions from inside the
    scene (bounces), the last `parked` parked as the kernel parks a dead ray
    (o = 1e18, d = (1, 1, 1)). The nine planes the closest hits take."""
    rng = np.random.default_rng(seed)
    c0 = scene.center0.numpy()
    tm = rng.random(n_rays).astype(np.float32)
    tgt = rng.integers(0, c0.shape[0], n_rays)
    centre = c0[tgt] + tm[:, None] * scene.center_delta.numpy()[tgt]
    o = np.where(rng.random((n_rays, 1)) < 0.5,
                 np.array([13.0, 2.0, 3.0]) + rng.normal(scale=0.5, size=(n_rays, 3)),
                 rng.uniform([-10, 0.1, -10], [10, 2.0, 10], (n_rays, 3)))
    d = centre - o + rng.normal(scale=0.2, size=(n_rays, 3))
    stray = rng.random(n_rays) < 0.5
    d[stray] = rng.normal(size=(int(stray.sum()), 3))
    if parked:
        o[-parked:], d[-parked:] = 1e18, 1.0
    o, d = o.astype(np.float32), d.astype(np.float32)
    planes = [torch.from_numpy(np.ascontiguousarray(x)) for x in (*o.T, *d.T, tm)]
    dx, dy, dz = planes[3:6]
    a = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20)
    return (*planes, a, 1.0 / a)


def _hold(front, rays, g_size: int, misses: bool = True) -> None:
    """The model's (t, column) equal, bit for bit, to the plain version's."""
    want_t, want_c = _twin_hit(front, rays)
    got_t, got_c = grouped_hbm_hit(front, rays, g_size)
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_c, want_c)
    assert bool((want_c >= 0).any())
    if misses:
        assert bool((want_c < 0).any())


@pytest.fixture(scope="module")
def fronts():
    """make_random_scene(2000, seed=3)'s K7 fronts: several words (the
    plain and word_earlyout fronts) and fewer, bigger subtrees with
    sub-block boxes."""
    random = make_random_scene(2000, seed=3)
    scene, plain = _front(random)
    _, sub = _front(random, max_nodes=24, sub_block=True)
    return scene, {"plain": plain, "word_earlyout": dataclasses.replace(plain, word_earlyout=True),
                   "sub_block": sub,
                   "sub_block + word_earlyout": dataclasses.replace(sub, word_earlyout=True)}


@pytest.mark.parametrize("g_size", GROUPS)
@pytest.mark.parametrize("kind", ["plain", "word_earlyout", "sub_block",
                                  "sub_block + word_earlyout"])
def test_groups_equal_plain_hbm_front(fronts, kind, g_size):
    """Every G, on the plain front (several words), with word_earlyout, with
    sub-block boxes and with both: bit-equal to the plain version."""
    scene, by_kind = fronts
    front = by_kind[kind]
    assert front.ff.shape[1] // WORD > (0 if kind.startswith("sub_block") else 1)
    assert (front.ksub > 0) == kind.startswith("sub_block")
    _hold(front, _rays(scene, 64, seed=g_size + 3 * len(kind)), g_size)


@pytest.fixture(scope="module")
def super_front():
    """make_random_scene(5000, seed=3)'s front of more than 576 subtrees."""
    scene, front = _front(make_random_scene(5000, seed=3), leaf_size=4, max_nodes=600)
    assert front.ff.shape[1] // WORD > WORD
    return scene, front


@pytest.mark.parametrize("g_size", [1, 4, 32])
@pytest.mark.parametrize("earlyout", [False, True])
def test_groups_equal_plain_hbm_front_with_super_words(super_front, earlyout, g_size):
    """A front of more than 576 subtrees: stage 1 tests the super-word boxes,
    then the word boxes of each entered super-word, on the ray's own masks;
    with word_earlyout each of its ~25 words' box is clamped too."""
    scene, front = super_front
    front = dataclasses.replace(front, word_earlyout=earlyout)
    _hold(front, _rays(scene, 48, seed=g_size + 5 * earlyout), g_size)


@pytest.mark.parametrize("kind", ["plain", "word_earlyout", "sub_block",
                                  "sub_block + word_earlyout", "super-words"])
def test_front_walk_counts_the_columns_the_groups_scan(fronts, super_front, kind):
    """`probes.pair_counts.front_walk`, whose count K7's bound reads, on the
    visited columns: bit-equal to the plain version, scanning the columns
    the model's groups scan (the clamps included), which are no more than
    the unclamped masks select."""
    scene, front = super_front if kind == "super-words" else (fronts[0], fronts[1][kind])
    rays = _rays(scene, 64, seed=11 + len(kind), parked=8)
    cols = front.valid_columns()
    tab = front.sph[cols].t().contiguous()
    group = None if front.bf is None else cols // mk.UNROLL
    want = mk.closest_hit_hbm_twin(front, tab, cols // BLOCK, group, *rays, T_MIN)
    walked, scanned = {}, {}
    got = front_walk(front, tab)(rays, T_MIN, counts=walked)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    grouped_hbm_hit(front, rays, 1, counts=scanned)
    mask = mk.subtree_slab_mask(front.ff, *rays[:6], T_MIN)[:, cols // BLOCK]
    if group is not None:
        mask &= mk.subtree_slab_mask(front.bf, *rays[:6], T_MIN)[:, group]
    assert 0 < walked["pairs"] == scanned["pairs"] <= int(mask.sum())
    assert walked["roots"] <= walked["pairs"] and walked["boxes"] > 0


@pytest.mark.parametrize("g_size", GROUPS)
def test_groups_keep_the_first_of_exact_ties(g_size):
    """Every sphere of the cover scene twice: every hit is an exact tie
    between two columns (neighbouring columns of one leaf, so different
    lanes for G > 1), and the least column wins at every G."""
    cover = make_cover_scene(0)
    twice = cover.take(torch.cat([torch.arange(cover.num_spheres)] * 2))
    scene, front = _front(twice)
    rays = _rays(scene, 64, seed=40 + g_size)
    want_t, want_c = _twin_hit(front, rays)
    hit = want_c >= 0
    ties = (mk._sphere_t(front.sph.t(), *rays, T_MIN) == want_t[:, None]).sum(dim=1)
    assert bool(hit.sum() >= 16) and bool((ties[hit] >= 2).all())
    _hold(front, rays, g_size)


@pytest.mark.parametrize("g_size", [1, 8, 32])
def test_parked_rays_miss(fronts, g_size):
    """Rays parked as the kernel parks a dead one miss everything in the
    model and the plain version alike."""
    scene, by_kind = fronts
    rays = _rays(scene, 48, seed=g_size, parked=16)
    for front in (by_kind["plain"], by_kind["sub_block"]):
        _hold(front, rays, g_size)
        got_t, got_c = grouped_hbm_hit(front, rays, g_size)
        assert bool(torch.isinf(got_t[-16:]).all()) and bool((got_c[-16:] == -1).all())


@pytest.mark.parametrize("live", [1, 9, 33, 129, 256])
def test_live_counts_take_their_group_size(fronts, live):
    """A block's L live rays with the G the kernel gives them (capped at
    32), bit-equal to the plain version."""
    g_size = group_size(live)
    assert g_size * live <= THREADS and (g_size == MAX_GROUP or THREADS < 2 * g_size * live)
    scene, by_kind = fronts
    _hold(by_kind["word_earlyout"], _rays(scene, live, seed=live), g_size, misses=live >= 16)


def test_shared_memory_holds_the_live_list_alone():
    """K7 keeps every table in global memory: its shared memory is the
    block's live list, whose size the wrapper knows as SEGMENT_LIST_BYTES
    (the source's LIST_SMEM_BYTES: 9 words a ray, its winner's t and
    column, a count a warp)."""
    import re

    from raytracingproject_tpu_torch.ops.cuda import build

    source = build.source("megakernel").read_text()
    assert re.search(r"if \(MODE == HBM\) return LIST_SMEM_BYTES;", source)
    assert "RAY_WORDS * TPB + 2 * TPB + TPB / 32" in source
    assert mk.SEGMENT_LIST_BYTES == 4 * (9 * mk.TILE + 2 * mk.TILE + mk.TILE // 32)
    assert "boxes_in_smem" not in source
