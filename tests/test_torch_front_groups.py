"""K6's front segment's partition of the work (csrc/megakernel.cu,
`closest_hit_front_seg`), modelled in plain PyTorch and held bit for bit
against the front-culled closest hit's plain version, `closest_hit_front_twin`.

On the card each of a block's L live rays gets G = the largest power of two
<= 256 / L of the block's threads, at most 32. The group deals the ray's
own stage-1 box tests (super-words, words) and its subtree box tests over
its lanes; before each of a word's `repack` chunks, the group's best t so
far clamps the chunk's subtree boxes; the columns of the chunk's live
subtrees, in ascending order, are dealt over the lanes (lane g takes the
g-th, (g + G)-th, ... of them), each lane keeping its first minimum with a
strict `<`; at the end the group reduces (t, column) lexicographically
(an xor butterfly of shuffles). The model below does the same on the plain
version's candidate roots (`_sphere_t`), so the claim that per-ray culling
with that reduction is the plain version's function (each ray's columns
masked by its own slab tests, the first minimum in column order, ties
included) is checked for every G, on one word with repack 1 and 2, on
several words, on super-words, on exact ties and on parked rays. The
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
from raytracingproject_tpu_torch.config import T_MIN
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
from raytracingproject_tpu_torch.scene import make_cover_scene, make_random_scene

THREADS = 256   # threads (rays) of a block, csrc/megakernel.cu TPB
MAX_GROUP = 32  # 1 << LG_MAX: a group is part of one warp
GROUPS = [1 << k for k in range(6)]  # every G a live ray can get: 1 .. 32
WORD = mk.WORD


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


def grouped_front_hit(front: mk.FrontTables, rays, g_size: int):
    """The front segment's closest hit of R rays, each over a group of
    `g_size` lanes: (best t, winner column or -1), culled, scanned and
    reduced as the kernel's groups do."""
    ox, oy, oz, dx, dy, dz = rays[:6]
    t = mk._sphere_t(front.sph, *rays, T_MIN)  # [R, C] candidate roots
    r, n_cols = t.shape
    inf = torch.full((r,), math.inf, dtype=t.dtype)
    owner = front.column_subtree()
    n_words = front.ff.shape[1] // WORD
    n_super = -(-n_words // WORD)
    geo = (ox, oy, oz, dx, dy, dz)
    # stage 1 on the ray's own masks (unclamped), as front_live_words descends
    if n_words == 1:
        word_live = torch.ones((r, 1), dtype=torch.bool)
    elif n_super == 1:
        word_live = _slab(front.wf[:, :n_words], *geo, inf)
    else:
        sup = _slab(front.sf[:, :n_super], *geo, inf)
        word_live = _slab(front.wf[:, :n_words], *geo, inf) & sup[:, torch.arange(n_words) // WORD]
    lane_of = torch.full((r, n_cols), -1, dtype=torch.int64)  # the lane that tests a column
    best = inf.clone()  # the group's best t so far
    per = WORD // front.repack
    for w in range(n_words):
        for c in range(front.repack):
            base = w * WORD + c * per
            sub = _slab(front.ff[:, base:base + per], *geo, best) & word_live[:, w:w + 1]
            in_chunk = (owner >= base) & (owner < base + per)
            cols = torch.zeros((r, n_cols), dtype=torch.bool)
            cols[:, in_chunk] = sub[:, owner[in_chunk] - base]
            pos = torch.cumsum(cols, dim=1) - 1  # place in the chunk's live columns
            lane_of = torch.where(cols, pos % g_size, lane_of)
            best = torch.minimum(best, torch.where(cols, t, math.inf).min(dim=1).values)
    # each lane's strict-`<` scan in ascending order keeps its first minimum
    bt = torch.full((r, g_size), math.inf, dtype=t.dtype)
    bc = torch.zeros((r, g_size), dtype=torch.int64)
    for lane in range(g_size):
        lt, lc = mk._first_min(torch.where(lane_of == lane, t, math.inf))
        bt[:, lane] = lt
        bc[:, lane] = torch.where(lt < math.inf, lc, 0)  # the kernel's carry starts (inf, 0)
    lanes = torch.arange(g_size)
    off = g_size // 2
    while off:  # __shfl_xor_sync within the group
        bt, bc = _take_less(bt, bc, bt[:, lanes ^ off], bc[:, lanes ^ off])
        off //= 2
    return bt[:, 0], torch.where(bt[:, 0] < math.inf, bc[:, 0], -1)


def _front(scene_cpu, repack: int, leaf_size: int = 8, max_nodes=None, budget=True):
    tree = build_bvh(scene_cpu, leaf_size=leaf_size)
    scene = reorder_scene(scene_cpu, tree)
    front = mk.front_tables(scene, tree, max_nodes=max_nodes, order_point=(13.0, 2.0, 3.0),
                            repack=repack,
                            smem_budget=mk.SMEM_BUDGET_BYTES if budget else None)
    return scene, front


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
    want_t, want_c = mk.closest_hit_front_twin(front, front.column_subtree(), *rays, T_MIN)
    got_t, got_c = grouped_front_hit(front, rays, g_size)
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_c, want_c)
    assert bool((want_c >= 0).any())
    if misses:
        assert bool((want_c < 0).any())


@pytest.fixture(scope="module")
def cover_fronts():
    cover = make_cover_scene(0)
    return {rp: _front(cover, rp) for rp in (1, 2)}


@pytest.mark.parametrize("g_size", GROUPS)
@pytest.mark.parametrize("repack", [1, 2])
def test_groups_equal_plain_front_on_the_cover_front(cover_fronts, repack, g_size):
    """The cover scene's front (one word of 24 subtrees), repack 1 and 2:
    every G, bit-equal to the plain version."""
    scene, front = cover_fronts[repack]
    assert front.ff.shape[1] == WORD
    _hold(front, _rays(scene, 96, seed=g_size + 7 * repack), g_size)


@pytest.mark.parametrize("g_size", GROUPS)
def test_groups_equal_plain_front_on_several_words(g_size):
    """make_random_scene(2000, seed=3)'s front: several words, so stage 1
    tests the word boxes (on the ray's own mask), with repack 2."""
    scene, front = _front(make_random_scene(2000, seed=3), 2)
    n_words = front.ff.shape[1] // WORD
    assert 1 < n_words <= WORD
    _hold(front, _rays(scene, 64, seed=g_size), g_size)


@pytest.mark.parametrize("g_size", [1, 8, 32])
def test_groups_equal_plain_front_with_super_words(g_size):
    """A front of more than 576 subtrees (super-words). Its padded table
    exceeds the card's shared memory, so the kernel never meets one (`render`
    takes K8 for such a scene); the partition is held all the same."""
    scene, front = _front(make_random_scene(5000, seed=3), 1, leaf_size=4, max_nodes=600,
                          budget=False)
    assert front.ff.shape[1] // WORD > WORD
    _hold(front, _rays(scene, 32, seed=g_size), g_size)


@pytest.mark.parametrize("g_size", GROUPS)
def test_groups_keep_the_first_of_exact_ties(g_size):
    """Every sphere of the cover scene twice: every hit is an exact tie
    between two columns (the tree keeps a sphere and its copy in one leaf:
    neighbouring columns, so different lanes for G > 1), and the least
    column wins at every G."""
    cover = make_cover_scene(0)
    twice = cover.take(torch.cat([torch.arange(cover.num_spheres)] * 2))
    scene, front = _front(twice, 1)
    owner = front.column_subtree()
    rays = _rays(scene, 64, seed=40 + g_size)
    want_t, want_c = mk.closest_hit_front_twin(front, owner, *rays, T_MIN)
    hit = want_c >= 0
    ties = (mk._sphere_t(front.sph, *rays, T_MIN) == want_t[:, None]).sum(dim=1)
    assert bool(hit.sum() >= 16) and bool((ties[hit] >= 2).all())
    _hold(front, rays, g_size)


@pytest.mark.parametrize("g_size", [1, 4, 32])
def test_parked_rays_miss(cover_fronts, g_size):
    """Rays parked as the kernel parks a dead one miss everything in the
    model and the plain version alike."""
    scene, front = cover_fronts[2]
    rays = _rays(scene, 48, seed=g_size, parked=16)
    _hold(front, rays, g_size)
    got_t, got_c = grouped_front_hit(front, rays, g_size)
    assert bool(torch.isinf(got_t[-16:]).all()) and bool((got_c[-16:] == -1).all())


@pytest.mark.parametrize("live", [1, 5, 8, 9, 25, 33, 128, 129, 256])
def test_live_counts_take_their_group_size(cover_fronts, live):
    """A block's L live rays with the G the kernel gives them (capped at
    32), bit-equal to the plain version."""
    g_size = group_size(live)
    assert g_size * live <= THREADS and (g_size == MAX_GROUP or THREADS < 2 * g_size * live)
    scene, front = cover_fronts[1]
    _hold(front, _rays(scene, live, seed=live), g_size, misses=live >= 16)


def test_group_size_is_the_largest_power_of_two_that_fits_a_warp():
    """G * L threads of the block's 256 work; G is a power of two of at
    most 32, and doubling it would pass 32 or the block."""
    for live in range(1, THREADS + 1):
        g_size = group_size(live)
        assert g_size & (g_size - 1) == 0 and g_size * live <= THREADS
        assert g_size == MAX_GROUP or 2 * g_size * live > THREADS
