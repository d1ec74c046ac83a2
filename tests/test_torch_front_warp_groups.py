"""K3's partition of the work (csrc/megakernel.cu, `closest_hit_front_warp`:
the front in shared memory), modelled in plain PyTorch and held bit for bit
against the front's plain version, `closest_hit_front_twin`.

On the card each bounce a warp ballots its L live lanes and gives each live
ray a group of G = the largest power of two <= 32 / L lanes, the j-th live
lane's ray to group j. The group runs K6's front segment's per-ray work
(`front_group_word`): stage 1 (super-words, words) on the ray's own masks;
for each live word, with `word_earlyout`, the word's union box against the
group's best t; before each of the word's `repack` chunks, the group's best
t so far clamps the chunk's subtree boxes; the columns of the chunk's live
subtrees (with sub-block boxes: of the 8-column groups the ray enters
within the group's best t at that subtree), in ascending order, dealt over
the lanes (lane g takes the g-th, (g + G)-th, ... of the chunk's scanned
columns), each lane keeping its first minimum with a strict `<`; at the end
the group reduces (t, column) lexicographically (an xor butterfly of
shuffles). The model does the same on the plain version's candidate roots
(`_sphere_t`), so the claim that it is the plain version's function (each
ray's columns masked by its own slab tests, the first minimum in column
order, ties included) is checked on warps with 1, 2, 3, 16, 17 and 32 live
lanes: on the cover front at repack 1 and 2, on several words, on
super-words, on exact ties, on parked rays and on `sub_block` and
`word_earlyout` fronts. The kernels themselves are held against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).

Also here: the routes `prepare_scene` takes (K3 up to 3,000 spheres, K8
past them; the 3,000-sphere front fits the shared memory alone, not beside
the front segment's live list) and `probes.pair_counts.front_counts`'s own
pairs against the plain version's mask.
"""

import math

import pytest
import torch
from test_torch_front_groups import _front, _rays, _slab, _take_less

from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import T_MIN, RenderSettings
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
from raytracingproject_tpu_torch.probes.pair_counts import front_counts, front_walk
from raytracingproject_tpu_torch.render import prepare_scene
from raytracingproject_tpu_torch.scene import make_cover_scene, make_random_scene

WARP = 32
WORD = mk.WORD
LIVE = [1, 2, 3, 16, 17, 32]  # live lanes of a warp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread: the shapes are small, and a parallel test
    run's workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def group_size(live: int) -> int:
    """G for a warp with `live` live lanes: `1 << (31 - __clz(32 / L))`."""
    return 1 << ((WARP // live).bit_length() - 1)


def warp_groups_hit(front: mk.FrontTables, rays, alive: torch.Tensor, counts: dict | None = None):
    """K3's closest hit of R rays (R a multiple of 32, warps of 32
    consecutive rays), `alive` [R] the live lanes: (best t, winner column
    or -1), a dead lane's a miss, culled, scanned and reduced as the
    kernel's warp-level groups do. With `counts`, adds the columns the
    groups scan ("pairs")."""
    geo = rays[:6]
    t = mk._sphere_t(front.sph, *rays, T_MIN)  # [R, C] candidate roots
    r = t.shape[0]
    n_live = alive.view(-1, WARP).sum(dim=1)
    g_ray = torch.tensor([group_size(int(n)) if n else 1 for n in n_live]).repeat_interleave(WARP)
    inf = torch.full((r,), math.inf, dtype=t.dtype)
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
    word_live &= alive[:, None]  # a dead lane takes no part in a group
    start, count = front.fi[0].tolist(), front.fi[1].tolist()
    best = inf.clone()  # the group's best t so far (group_min of its lanes' carries)
    lane_t = torch.full((r, WARP), math.inf, dtype=t.dtype)
    lane_c = torch.zeros((r, WARP), dtype=torch.int64)  # the kernel's carry starts (inf, 0)
    per = WORD // front.repack
    for w in range(n_words):
        live_w = word_live[:, w]
        if front.word_earlyout:
            live_w = live_w & _slab(front.wf[:, w:w + 1], *geo, best)[:, 0]
        for c in range(front.repack):
            base = w * WORD + c * per
            sub = _slab(front.ff[:, base:base + per], *geo, best) & live_w[:, None]
            pos = torch.zeros(r, dtype=torch.int64)  # places taken in the chunk's columns
            for k in range(per):
                s0, n = start[base + k], count[base + k]
                if n == 0:
                    continue
                if front.bf is not None:  # the subtree's 8-column groups, clamped here
                    grp = _slab(front.bf[:, s0 // mk.UNROLL:(s0 + n) // mk.UNROLL], *geo, best)
                    scanned = grp.repeat_interleave(mk.UNROLL, dim=1) & sub[:, k:k + 1]
                else:
                    scanned = sub[:, k:k + 1].expand(r, n)
                lane = (pos[:, None] + torch.cumsum(scanned, dim=1) - 1) % g_ray[:, None]
                ts = torch.where(scanned, t[:, s0:s0 + n], math.inf)
                for g in range(int(g_ray.max())):  # each lane's strict-`<` scan, in order
                    gt, gc = mk._first_min(torch.where(lane == g, ts, math.inf))
                    better = gt < lane_t[:, g]
                    lane_t[:, g] = torch.where(better, gt, lane_t[:, g])
                    lane_c[:, g] = torch.where(better, s0 + gc, lane_c[:, g])
                pos += scanned.sum(dim=1)
                best = torch.minimum(best, ts.min(dim=1).values)
                if counts is not None:
                    counts["pairs"] = counts.get("pairs", 0) + int(scanned.sum())
    lanes = torch.arange(WARP)
    off = WARP // 2
    while off:  # __shfl_xor_sync within each ray's group (offsets below its G)
        ot, oc = _take_less(lane_t, lane_c, lane_t[:, lanes ^ off], lane_c[:, lanes ^ off])
        inside = (off < g_ray)[:, None]
        lane_t, lane_c = torch.where(inside, ot, lane_t), torch.where(inside, oc, lane_c)
        off //= 2
    bt, bc = lane_t[:, 0], lane_c[:, 0]
    return bt, torch.where(bt < math.inf, bc, -1)


def _alive(n_rays: int, live: int) -> torch.Tensor:
    """Lanes < `live` of every warp alive."""
    return torch.arange(n_rays) % WARP < live


def _park(rays, dead: torch.Tensor):
    """The rays with the `dead` ones parked as the kernel parks a dead ray
    (o = 1e18, d = (1, 1, 1)); a and 1 / a follow."""
    o = [torch.where(dead, 1e18, x) for x in rays[:3]]
    d = [torch.where(dead, 1.0, x) for x in rays[3:6]]
    a = torch.clamp_min(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-20)
    return (*o, *d, rays[6], a, 1.0 / a)


def _hold(front, rays, live: int, misses: bool = True) -> None:
    """The model's (t, column) with `live` live lanes a warp equal, bit for
    bit, to the plain version's on the same rays, the dead lanes parked; so
    is `front_walk`'s (the count the bounds read), and it counts the
    columns the model scans."""
    alive = _alive(rays[0].shape[0], live)
    rays = _park(rays, ~alive)
    want_t, want_c = mk.closest_hit_front_twin(front, front.column_subtree(), *rays, T_MIN)
    scanned, walked = {}, {}
    got_t, got_c = warp_groups_hit(front, rays, alive, counts=scanned)
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_c, want_c)
    walk_t, walk_c = front_walk(front, front.sph)(rays, T_MIN, counts=walked)
    assert torch.equal(walk_t, want_t) and torch.equal(walk_c, want_c)
    assert walked["pairs"] == scanned.get("pairs", 0)
    assert bool((want_c >= 0).any())
    if misses:
        assert bool((want_c[alive] < 0).any())


@pytest.fixture(scope="module")
def cover_fronts():
    cover = make_cover_scene(0)
    return {rp: _front(cover, rp) for rp in (1, 2)}


@pytest.mark.parametrize("live", LIVE)
@pytest.mark.parametrize("repack", [1, 2])
def test_warp_groups_equal_plain_front_on_the_cover_front(cover_fronts, repack, live):
    """The cover scene's front (one word of 24 subtrees), repack 1 and 2:
    each live count, bit-equal to the plain version."""
    scene, front = cover_fronts[repack]
    assert front.ff.shape[1] == WORD
    _hold(front, _rays(scene, 96, seed=live + 7 * repack), live, misses=live >= 16)


@pytest.mark.parametrize("live", [1, 3, 17, 32])
def test_warp_groups_equal_plain_front_on_several_words(live):
    """make_random_scene(2000, seed=3)'s front: several words, so stage 1
    tests the word boxes on the ray's own mask, with repack 2."""
    scene, front = _front(make_random_scene(2000, seed=3), 2)
    assert 1 < front.ff.shape[1] // WORD <= WORD
    _hold(front, _rays(scene, 64, seed=live), live, misses=live >= 16)


@pytest.mark.parametrize("live", [2, 32])
def test_warp_groups_equal_plain_front_with_super_words(live):
    """A front of more than 576 subtrees (super-words). Its padded table
    exceeds the card's shared memory, so the kernel never meets one (such a
    scene takes K7); the partition is held all the same."""
    scene, front = _front(make_random_scene(5000, seed=3), 1, leaf_size=4, max_nodes=600,
                          budget=False)
    assert front.ff.shape[1] // WORD > WORD
    _hold(front, _rays(scene, 32, seed=live), live, misses=False)


@pytest.mark.parametrize("live", LIVE)
def test_warp_groups_keep_the_first_of_exact_ties(live):
    """Every sphere of the cover scene twice: every hit is an exact tie
    between two columns (neighbouring, so different lanes for G > 1), and
    the least column wins at every live count."""
    cover = make_cover_scene(0)
    twice = cover.take(torch.cat([torch.arange(cover.num_spheres)] * 2))
    scene, front = _front(twice, 1)
    rays = _rays(scene, 64, seed=40 + live)
    want_t, want_c = mk.closest_hit_front_twin(front, front.column_subtree(), *rays, T_MIN)
    hit = want_c >= 0
    ties = (mk._sphere_t(front.sph, *rays, T_MIN) == want_t[:, None]).sum(dim=1)
    assert bool(hit.sum() >= 16) and bool((ties[hit] >= 2).all())
    _hold(front, rays, live, misses=False)


@pytest.mark.parametrize("live", [3, 32])
def test_parked_live_rays_miss(cover_fronts, live):
    """Rays parked as the kernel parks a dead one, on live lanes, miss
    everything in the model and the plain version alike."""
    scene, front = cover_fronts[2]
    rays = _rays(scene, 64, seed=live, parked=24)
    _hold(front, rays, live)
    got_t, got_c = warp_groups_hit(front, rays, _alive(64, live))
    assert bool(torch.isinf(got_t[-24:]).all()) and bool((got_c[-24:] == -1).all())


@pytest.fixture(scope="module")
def option_fronts():
    """K3's options: the cover front (repack 2) with word_earlyout, with
    sub-block boxes and with both; make_random_scene(2000, seed=3)'s front
    of 24 subtrees with both (ksub > 8) and its default front (several
    words) with word_earlyout."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene

    def front(scene_cpu, max_nodes=None, **kw):
        tree = build_bvh(scene_cpu, leaf_size=8)
        sc = reorder_scene(scene_cpu, tree)
        return sc, mk.front_tables(sc, tree, max_nodes=max_nodes, order_point=(13.0, 2.0, 3.0),
                                   repack=2, **kw)

    cover, random = make_cover_scene(0), make_random_scene(2000, seed=3)
    return {
        "cover, word_earlyout": front(cover, word_earlyout=True),
        "cover, sub_block": front(cover, sub_block=True),
        "cover, both": front(cover, sub_block=True, word_earlyout=True),
        "2000, 24 subtrees, both": front(random, max_nodes=WORD, sub_block=True,
                                         word_earlyout=True),
        "2000, word_earlyout": front(random, word_earlyout=True),
    }


@pytest.mark.parametrize("live", [1, 3, 17, 32])
@pytest.mark.parametrize("which", ["cover, word_earlyout", "cover, sub_block", "cover, both",
                                   "2000, 24 subtrees, both", "2000, word_earlyout"])
def test_warp_groups_with_the_options_equal_plain_front(option_fronts, which, live):
    """K3's options only cull: with word_earlyout, sub-block boxes or both
    (the group's best t clamping the word box and each subtree's group
    boxes), bit-equal to the plain version (which masks by the group boxes
    where the front has them)."""
    scene, front = option_fronts[which]
    if "sub_block" in which or "both" in which:
        assert front.bf is not None and front.ksub > 0
    if "24 subtrees" in which:
        assert front.ksub > 8
    _hold(front, _rays(scene, 64, seed=live + len(which)), live, misses=live >= 16)


def test_group_size_is_the_largest_power_of_two_that_fits_the_warp():
    """G * L lanes of the warp's 32 work; G is a power of two, and doubling
    it would pass the warp."""
    for live in range(1, WARP + 1):
        g = group_size(live)
        assert g & (g - 1) == 0 and g * live <= WARP < 2 * g * live
    assert [group_size(n) for n in LIVE] == [32, 16, 8, 2, 1, 1]


BENCH = dict(aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=4, max_depth=16,
             vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0))


@pytest.mark.parametrize("scene_of, kind", [
    (lambda: make_cover_scene(0), mk.FrontTables),
    (lambda: make_random_scene(2000, seed=3), mk.FrontTables),
    (lambda: make_random_scene(3000, seed=3), mk.FrontTables),
    (lambda: make_random_scene(5000, seed=3), mk.BVHTables),
], ids=["cover", "2000", "3000", "5000"])
def test_render_takes_the_same_front_as_before(scene_of, kind):
    """The route `prepare_scene` picks at the bench shape: K3 (a FrontTables
    in shared memory) up to 3,000 spheres, K8 (the tree's BVHTables) at 5,000;
    K3's shared-memory budget is the card's 227 KB."""
    assert mk.SMEM_BUDGET_BYTES == 232448
    _, front = prepare_scene(scene_of(), Camera(**BENCH), RenderSettings(device="cpu"))
    assert type(front) is kind


def test_the_largest_front_fits_alone_not_beside_the_live_list():
    """make_random_scene(3000, seed=3)'s front passes the kernel's
    shared-memory check alone (K3 needs nothing beside its tables), and not
    beside the front segment's live list (so a block-level list would move
    such scenes to K7)."""
    _, front = prepare_scene(make_random_scene(3000, seed=3), Camera(**BENCH),
                             RenderSettings(device="cpu"))
    cpu = torch.device("cpu")
    mk._require_front(front, cpu, sub_block=True)
    mk._require_front(front, cpu, sub_block=False)
    with pytest.raises(ValueError, match="shared memory"):
        mk._require_front(front, cpu, sub_block=False, extra=mk.SEGMENT_LIST_BYTES)


@pytest.mark.parametrize("n_spheres", [487, 2000])
def test_front_counts_own_pairs_are_the_plain_versions_mask(n_spheres):
    """`front_counts`' own pairs (stage 1, word and subtree boxes of each
    live ray) equal the plain version's mask sum (subtree boxes alone: a
    word box bounds its subtrees', so it never culls more); the warp union
    and the groups count at least the own columns' steps; the kernel's
    clamped count (`front_walk`) at most the own pairs."""
    scene, front = _front(make_cover_scene(0) if n_spheres == 487
                          else make_random_scene(n_spheres, seed=3), 2)
    rays = _rays(scene, 128, seed=n_spheres, parked=8)
    o, d, t = torch.stack(rays[0:3], dim=1), torch.stack(rays[3:6], dim=1), rays[6]
    c = front_counts(front, o, d, t)
    ox, oy, oz, dx, dy, dz = rays[:6]
    mask = mk.subtree_slab_mask(front.ff, ox, oy, oz, dx, dy, dz, T_MIN)
    mask = mask[:, front.column_subtree()]
    assert c["own_pairs"] == int(mask.sum()) > 0
    assert c["rays"] == 120 and c["warps"] == 4
    assert c["union_pairs"] >= c["own_pairs"] and c["union_steps"] >= c["longest_steps"]
    assert c["longest_steps"] >= c["group_steps"] > 0
    assert 0 < c["kernel_pairs"] <= c["own_pairs"] and c["kernel_roots"] <= c["own_roots"]
