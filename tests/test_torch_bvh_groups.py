"""K8's ordered walk (csrc/megakernel.cu, `closest_hit_bvh`), modelled in
plain PyTorch (`probes.pair_counts.ordered_walk`) and held bit for bit
against K8's plain version, `closest_hit_bvh_twin`, the miss-link walk in
column order with a strict `<`.

The kernel walks the node records of `bvh_tables` (both children's boxes
in the parent), one ray a thread: at an inner record it tests both
children's boxes against the best t so far, enters the nearer first and
defers the other with its entry t on a stack; a deferred child is dropped
when popped past the best t; a leaf's spheres update (t, column)
lexicographically. Out of column order, that keeps the plain version's
first minimum in column order only because the update is lexicographic
and the clamp is not strict on the best-t side (a box entered exactly at
the best t may hold an equal hit at a lower column): the constructed tie
below fails a strict clamp. The model is held on the cover scene and on
2,000 spheres, at leaf sizes 4 and 8, on four sets of primary and of
scattered rays, on parked rays and on exact ties; the node records, the
recorded depth and the stack's limit are tested too. The
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import re

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.bvh import FlatBVH, build_bvh, reorder_scene
from raytracingproject_tpu_torch.config import T_MIN
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
from raytracingproject_tpu_torch.probes.pair_counts import ordered_walk
from raytracingproject_tpu_torch.scene import SceneBuilder, make_cover_scene, make_random_scene

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread: the shapes are small, and a parallel test
    run's workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(o: np.ndarray, d: np.ndarray, tm: np.ndarray):
    """The nine planes the closest hits take, float32."""
    o, d = o.astype(np.float32), d.astype(np.float32)
    planes = [torch.from_numpy(np.ascontiguousarray(x)) for x in (*o.T, *d.T,
                                                                  tm.astype(np.float32))]
    dx, dy, dz = planes[3:6]
    a = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20)
    return (*planes, a, 1.0 / a)


def _rays(scene, n_rays: int, seed: int, kind: str, parked: int = 0):
    """`primary`: from around the cover camera, three in four aimed at
    random spheres' centres (at the ray's time), the rest up into the sky;
    `scattered`: from points on random spheres' surfaces in random
    directions, as after a bounce. The last `parked` parked as the kernel
    parks a dead ray (o = 1e18, d = 1)."""
    rng = np.random.default_rng(seed)
    c0, dc = scene.center0.numpy(), scene.center_delta.numpy()
    rad = scene.radius.numpy()
    tm = rng.random(n_rays)
    tgt = rng.integers(0, c0.shape[0], n_rays)
    centre = c0[tgt] + tm[:, None] * dc[tgt]
    if kind == "primary":
        o = np.array([13.0, 2.0, 3.0]) + rng.normal(scale=0.5, size=(n_rays, 3))
        d = centre - o + rng.normal(scale=0.2, size=(n_rays, 3))
        sky = rng.random(n_rays) < 0.25
        d[sky] = rng.normal(size=(int(sky.sum()), 3)) + np.array([0.0, 3.0, 0.0])
    else:
        u = rng.normal(size=(n_rays, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        o = centre + 1.0001 * np.abs(rad[tgt])[:, None] * u
        d = u + rng.normal(size=(n_rays, 3))
    if parked:
        o[-parked:], d[-parked:] = 1e18, 1.0
    return _planes(o, d, tm)


def _hold(tables: mk.BVHTables, tab, rays, misses: bool = True):
    """The model's (t, column) equal, bit for bit, to the plain version's."""
    want_t, want_c = mk.closest_hit_bvh_twin(tab, tables.flat, *rays)
    got_t, got_c = ordered_walk(tables.nodes, tab, rays)
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_c, want_c)
    assert bool((want_c >= 0).any())
    if misses:
        assert bool((want_c < 0).any())
    return got_t, got_c


@pytest.fixture(scope="module")
def trees():
    """(leaf-ordered scene, BVHTables) of the cover scene and of
    make_random_scene(2000, seed=3), at leaf sizes 4 and 8."""
    out = {}
    for name, scene in (("cover", make_cover_scene(0)),
                        ("2,000 spheres", make_random_scene(2000, seed=3))):
        for leaf in (4, 8):
            tree = build_bvh(scene, leaf_size=leaf)
            out[name, leaf] = (reorder_scene(scene, tree), mk.bvh_tables(tree, "cpu"))
    return out


@pytest.mark.parametrize("ray_set", range(4))
@pytest.mark.parametrize("kind", ["primary", "scattered"])
@pytest.mark.parametrize("leaf", [4, 8])
@pytest.mark.parametrize("name", ["cover", "2,000 spheres"])
def test_ordered_walk_equals_plain_walk(trees, name, leaf, kind, ray_set):
    """The walk on both scenes and leaf sizes, four sets of primary and of
    scattered rays: bit-equal to the miss-link walk in column order."""
    scene, tables = trees[name, leaf]
    rays = _rays(scene, 96, seed=100 * ray_set + 7 * leaf + len(kind), kind=kind)
    _hold(tables, mk.scene_table(scene), rays)


@pytest.mark.parametrize("parked", [16, 40])
def test_parked_rays_miss(trees, parked):
    """Rays parked as the kernel parks a dead one (a third of them, or all
    but eight) miss the root's box, in the model and the plain version
    alike."""
    scene, tables = trees["2,000 spheres", 8]
    rays = _rays(scene, 48, seed=11, kind="scattered", parked=parked)
    got_t, got_c = _hold(tables, mk.scene_table(scene), rays)
    assert bool(torch.isinf(got_t[-parked:]).all()) and bool((got_c[-parked:] == -1).all())


def test_walk_keeps_the_first_of_exact_ties():
    """Every sphere of the cover scene twice: every hit is an exact tie
    between two columns, which the walk may reach in either order; the
    least column wins."""
    cover = make_cover_scene(0)
    twice = cover.take(torch.cat([torch.arange(cover.num_spheres)] * 2))
    tree = build_bvh(twice, leaf_size=8)
    scene, tables = reorder_scene(twice, tree), mk.bvh_tables(tree, "cpu")
    tab = mk.scene_table(scene)
    rays = _rays(scene, 64, seed=40, kind="primary")
    want_t, want_c = _hold(tables, tab, rays)
    hit = want_c >= 0
    ties = (mk._sphere_t(tab, *rays, T_MIN) == want_t[:, None]).sum(dim=1)
    assert bool(hit.sum() >= 16) and bool((ties[hit] >= 2).all())


def _tie_scene(deferred_inner: bool):
    """A scene and a hand-built tree in which the ray o = 0, d = +x hits
    sphere A (column 0) and its copy B at exactly t = 3, where A's leaf box
    starts: B's leaf (with C, which widens its box to x = 1) is entered
    first, so the walk meets A's box or its deferred entry at t equal to
    the best t. `deferred_inner`: A's leaf sits under an inner node beside
    D (which widens that node's box to x = 2, and which the ray misses), so
    the deferred entry is the inner node's and the clamp that decides is
    A's box test at its record."""
    b = SceneBuilder()
    spheres = [(4.0, 0.0, 0.0, 1.0)]  # A
    if deferred_inner:
        spheres.append((2.5, 8.0, 0.0, 0.5))  # D
    spheres += [(4.0, 0.0, 0.0, 1.0), (2.0, 5.0, 0.0, 1.0)]  # B, C
    for x, y, z, r in spheres:
        b.add_lambertian((x, y, z), r, (0.5, 0.5, 0.5))
    scene = b.build()
    lo = np.array([[x - r, y - r, z - r] for x, y, z, r in spheres], np.float32)
    hi = np.array([[x + r, y + r, z + r] for x, y, z, r in spheres], np.float32)
    if deferred_inner:  # root, inner(A, D), leaf A, leaf D, leaf (B, C)
        bc = [2, 3]
        nmin = [lo.min(0), lo[[0, 1]].min(0), lo[0], lo[1], lo[bc].min(0)]
        nmax = [hi.max(0), hi[[0, 1]].max(0), hi[0], hi[1], hi[bc].max(0)]
        miss, start, count = [-1, 4, 3, 4, -1], [0, 0, 0, 1, 2], [0, 0, 1, 1, 2]
    else:  # root, leaf A, leaf (B, C)
        nmin, nmax = [lo.min(0), lo[0], lo[1:].min(0)], [hi.max(0), hi[0], hi[1:].max(0)]
        miss, start, count = [-1, 2, -1], [0, 0, 1], [0, 1, 2]
    t = torch.from_numpy
    tree = FlatBVH(node_min=t(np.stack(nmin)), node_max=t(np.stack(nmax)),
                   miss_link=t(np.array(miss, np.int32)),
                   leaf_start=t(np.array(start, np.int32)),
                   leaf_count=t(np.array(count, np.int32)),
                   prim_order=t(np.arange(len(spheres), dtype=np.int32)))
    return scene, tree


@pytest.mark.parametrize("deferred_inner", [False, True])
def test_constructed_tie_needs_the_non_strict_clamp(deferred_inner):
    """The walk reaches the tie's higher column first; with the non-strict
    clamp it still returns column 0, as the plain version does, and with a
    strict one (a box or deferred entry at exactly the best t dropped) it
    returns the higher column."""
    scene, tree = _tie_scene(deferred_inner)
    tables = mk.bvh_tables(tree, "cpu")
    tab = mk.scene_table(scene)
    rays = _planes(np.zeros((2, 3)), np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]),
                   np.zeros(2))
    want_t, want_c = mk.closest_hit_bvh_twin(tab, tables.flat, *rays)
    assert want_t.tolist() == [3.0, float("inf")] and want_c.tolist() == [0, -1]
    got_t, got_c = ordered_walk(tables.nodes, tab, rays)
    assert torch.equal(got_t, want_t) and torch.equal(got_c, want_c)
    strict_t, strict_c = ordered_walk(tables.nodes, tab, rays, strict=True)
    assert strict_t.tolist() == want_t.tolist()
    assert strict_c[0].item() == (2 if deferred_inner else 1)  # B, the copy


@pytest.mark.parametrize("leaf", [4, 8])
def test_node_records_hold_the_tree(trees, leaf):
    """Record 0 holds the root beside an empty box; the record of inner node
    i holds the boxes of nodes i + 1 and miss_link[i + 1] as the FlatBVH
    has them; a reference is a record, whose node is inner, or a leaf's
    ~((start << 8) | count); `depth` is the most inner nodes on a path."""
    _, tables = trees["2,000 spheres", leaf]
    flat = tables.flat
    nodes, box = tables.nodes, tables.nodes.view(torch.float32)
    inner = torch.nonzero(flat.leaf_count == 0)[:, 0]
    first = torch.cat([torch.zeros(1, dtype=torch.long), inner + 1])
    second = flat.miss_link.long()[inner + 1]
    assert nodes.shape == (1 + inner.numel(), 16)
    assert torch.equal(box[:, 0:3], flat.node_min[first])
    assert torch.equal(box[:, 4:7], flat.node_max[first])
    assert torch.equal(box[1:, 8:11], flat.node_min[second])
    assert torch.equal(box[1:, 12:15], flat.node_max[second])
    assert bool((box[0, 8:15:4] == 1e30).all()) and nodes[0, 7].item() == -1
    assert bool((nodes[:, 11] == 0).all()) and bool((nodes[:, 15] == 0).all())
    for ref, child in ((nodes[:, 3], first), (nodes[1:, 7], second)):
        leaf_child = flat.leaf_count[child] > 0
        assert torch.equal(inner[ref[~leaf_child].long() - 1], child[~leaf_child])
        packed = ~ref[leaf_child]
        assert torch.equal(packed >> 8, flat.leaf_start[child][leaf_child])
        assert torch.equal(packed & 255, flat.leaf_count[child][leaf_child])
    # the depth, by walking every path from the root
    depth, todo = 0, [(0, 0)]
    while todo:
        node, level = todo.pop()
        if flat.leaf_count[node] > 0:
            depth = max(depth, level)
        else:
            todo += [(node + 1, level + 1), (int(flat.miss_link[node + 1]), level + 1)]
    assert tables.depth == depth and 0 < depth <= mk.BVH_STACK


def _chain(depth: int) -> FlatBVH:
    """A tree of `depth` inner nodes in a chain, each with a leaf of one
    sphere as its first child: inner k is node 2k, its leaf 2k + 1, the
    last leaf node 2 * depth."""
    m = 2 * depth + 1
    count = np.ones(m, np.int32)
    count[0:2 * depth:2] = 0
    miss = np.full(m, -1, np.int32)
    miss[1:2 * depth:2] = np.arange(2, 2 * depth + 1, 2)
    start = np.zeros(m, np.int32)
    start[count > 0] = np.arange(depth + 1)
    box = torch.zeros((m, 3))
    return FlatBVH(node_min=box, node_max=box + 1.0, miss_link=torch.from_numpy(miss),
                   leaf_start=torch.from_numpy(start), leaf_count=torch.from_numpy(count),
                   prim_order=torch.arange(depth + 1, dtype=torch.int32))


def test_bvh_tables_raise_on_a_tree_deeper_than_the_stack():
    """A chain of BVH_STACK inner nodes fits the kernel's stack; one more
    raises (there is no return to another walk)."""
    ok = mk.bvh_tables(_chain(mk.BVH_STACK), "cpu")
    assert ok.depth == mk.BVH_STACK and ok.nodes.shape == (1 + mk.BVH_STACK, 16)
    with pytest.raises(ValueError, match="depth"):
        mk.bvh_tables(_chain(mk.BVH_STACK + 1), "cpu")


def test_kernel_constants_match_the_model():
    """The source's stack holds the entries the wrapper and this model
    allow, and K8 takes no shared memory (a thread walks its own ray)."""
    from raytracingproject_tpu_torch.ops.cuda import build

    source = build.source("megakernel").read_text()
    assert re.search(rf"constexpr int BVH_STACK = {mk.BVH_STACK};", source)
    assert re.search(r"cudaOccupancyMaxActiveBlocksPerMultiprocessor\(blocks, fn, TPB, 0\)",
                     source)
    assert "MODE == BVH) closest_hit_bvh<RECORD>(p, r, h);" in source


def test_bvh_tables_are_built_once_per_tree():
    """A tree passed again gets the records built for it (a pass need not
    rebuild them); an equal tree that is another object, and a tree changed
    in place, get records of their own, equal to a fresh build."""
    tree = build_bvh(make_cover_scene(0), leaf_size=8)
    first = mk.bvh_tables(tree, "cpu")
    assert mk.bvh_tables(tree, "cpu") is first
    again = FlatBVH(*(x.clone() for x in tree))
    other = mk.bvh_tables(again, "cpu")
    assert other is not first and torch.equal(other.nodes, first.nodes)
    tree.node_max.add_(1.0)  # widened in place: its records are built anew
    grown = mk.bvh_tables(tree, "cpu")
    assert grown is not first
    assert torch.equal(grown.nodes.view(torch.float32)[1:, 12:15],
                       first.nodes.view(torch.float32)[1:, 12:15] + 1.0)


def test_sphere_major_table_is_built_once_per_scene():
    """The sphere-major table K8 reads is built once for a scene passed
    pass after pass; a scene changed in place, or another scene object,
    gets a table of its own, equal to a fresh build."""
    scene = make_random_scene(40, seed=2)
    cpu = torch.device("cpu")
    first = mk._sphere_major(scene, cpu)
    assert torch.equal(first, mk.scene_table(scene).t()) and first.shape == (40, mk.N_ROWS)
    assert mk._sphere_major(scene, cpu) is first
    scene.albedo.mul_(0.5)  # a materials step in place: its table is built anew
    halved = mk._sphere_major(scene, cpu)
    assert halved is not first and torch.equal(halved, mk.scene_table(scene).t())
    other = scene.take(torch.arange(40))
    assert mk._sphere_major(other, cpu) is not halved
    assert torch.equal(mk._sphere_major(other, cpu), halved)
