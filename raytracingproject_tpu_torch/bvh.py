"""BVH: host-side build and the subtree front (counterpart of
raytracingproject_tpu/bvh.py).

- `build_bvh`: the native binned-SAH builder (native/bvh_builder.cpp),
  else the same Python median-split build. Flattened in DFS pre-order with miss links.
- `bvh_front`: a disjoint cut of subtrees covering every sphere, the
  culling structure of the front-culled megakernel (K3).
- `reorder_scene`: permute the scene into leaf order.

- `bvh_closest_hit`: the per-ray stackless walk, a forward-only oracle
  for the culled kernels (plain PyTorch ops, not a kernel).

`build_bvh` returns the tree as CPU tensors; `bvh_closest_hit` takes it on
the rays' device.
"""

from __future__ import annotations

import ctypes
import heapq
import sys
from typing import NamedTuple

import numpy as np
import torch

from raytracingproject_tpu_torch.config import T_MAX, T_MIN
from raytracingproject_tpu_torch.ops.intersect import HitRecord, dot3, hit_geometry
from raytracingproject_tpu_torch.scene import Scene
from raytracingproject_tpu_torch.utils.profiling import sync

LEAF_SIZE = 4
SENTINEL = -1  # miss link of the root's escape: traversal done


class FlatBVH(NamedTuple):
    """DFS pre-order flattened BVH of M nodes (CPU tensors); inner nodes
    have leaf_count == 0. `prim_order` maps sorted -> original sphere."""

    node_min: torch.Tensor    # [M, 3] float32
    node_max: torch.Tensor    # [M, 3] float32
    miss_link: torch.Tensor   # [M] int32
    leaf_start: torch.Tensor  # [M] int32
    leaf_count: torch.Tensor  # [M] int32
    prim_order: torch.Tensor  # [N] int32


def _host(x: torch.Tensor, dtype) -> np.ndarray:
    with sync("rtp.sync.table"):
        return np.ascontiguousarray(x.detach().cpu().numpy(), dtype)


def sphere_bounds(scene: Scene) -> tuple[np.ndarray, np.ndarray]:
    """Per-sphere AABBs incl. motion (src/sphere.h:9-28), float64."""
    c0 = _host(scene.center0, np.float64)
    c1 = c0 + _host(scene.center_delta, np.float64)
    r = np.abs(_host(scene.radius, np.float64))[:, None]
    return np.minimum(c0 - r, c1 - r), np.maximum(c0 + r, c1 + r)


def build_bvh(scene: Scene, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Host-side top-down build: native binned SAH when g++ is available,
    else the Python median split. Both give the same layout."""
    native = _build_bvh_native(scene, leaf_size)
    if native is not None:
        return native
    return _build_bvh_python(scene, leaf_size)


def _build_bvh_native(scene: Scene, leaf_size: int) -> FlatBVH | None:
    from raytracingproject_tpu_torch.native import load_library

    lib = load_library("bvh_builder")
    if lib is None:
        return None
    c0 = _host(scene.center0, np.float32)
    cd = _host(scene.center_delta, np.float32)
    rad = _host(scene.radius, np.float32)
    n = c0.shape[0]
    cap = 2 * n + 2
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    miss = np.empty(cap, np.int32)
    lstart = np.empty(cap, np.int32)
    lcount = np.empty(cap, np.int32)
    order = np.empty(n, np.int32)

    fn = lib.build_bvh_native
    fn.restype = ctypes.c_int
    ptr = np.ctypeslib.ndpointer
    fn.argtypes = [
        ctypes.c_int, ptr(np.float32), ptr(np.float32), ptr(np.float32),
        ctypes.c_int, ptr(np.float32), ptr(np.float32),
        ptr(np.int32), ptr(np.int32), ptr(np.int32), ptr(np.int32),
    ]
    m = fn(n, c0.reshape(-1), cd.reshape(-1), rad, leaf_size,
           node_min.reshape(-1), node_max.reshape(-1), miss, lstart, lcount, order)
    if m <= 0:
        return None
    t = torch.from_numpy
    return FlatBVH(
        node_min=t(node_min[:m].copy()), node_max=t(node_max[:m].copy()),
        miss_link=t(miss[:m].copy()), leaf_start=t(lstart[:m].copy()),
        leaf_count=t(lcount[:m].copy()), prim_order=t(order),
    )


def _build_bvh_python(scene: Scene, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Pure-Python build (median split on the longest centroid axis)."""
    bmin, bmax = sphere_bounds(scene)
    n = bmin.shape[0]
    centroid = 0.5 * (bmin + bmax)
    nodes_min: list[np.ndarray] = []
    nodes_max: list[np.ndarray] = []
    nodes_leaf: list[tuple[int, int]] = []
    order: list[int] = []

    def rec(idx: np.ndarray) -> None:
        me = len(nodes_min)
        nodes_min.append(bmin[idx].min(axis=0))
        nodes_max.append(bmax[idx].max(axis=0))
        nodes_leaf.append((0, 0))
        if idx.size <= leaf_size:
            nodes_leaf[me] = (len(order), idx.size)
            order.extend(idx.tolist())
            return
        axis = int(np.argmax(nodes_max[me] - nodes_min[me]))
        part = idx[np.argsort(centroid[idx, axis], kind="stable")]
        mid = idx.size // 2
        rec(part[:mid])
        rec(part[mid:])

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 64))
    try:
        rec(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(nodes_min)
    leaf_counts = np.array([c for (_, c) in nodes_leaf], np.int64)
    # Subtree sizes from the pre-order layout, walked backwards: an inner
    # node's children are i+1 and i+1+size(i+1).
    sizes = np.ones(m, np.int64)
    for i in range(m - 1, -1, -1):
        if leaf_counts[i] == 0:
            left = sizes[i + 1]
            sizes[i] = 1 + left + sizes[i + 1 + left]
    miss = np.arange(m, dtype=np.int64) + sizes
    miss[miss >= m] = SENTINEL
    return FlatBVH(
        node_min=torch.as_tensor(np.stack(nodes_min)).to(torch.float32),
        node_max=torch.as_tensor(np.stack(nodes_max)).to(torch.float32),
        miss_link=torch.as_tensor(miss.astype(np.int32)),
        leaf_start=torch.as_tensor(np.array([s for (s, _) in nodes_leaf], np.int32)),
        leaf_count=torch.as_tensor(leaf_counts.astype(np.int32)),
        prim_order=torch.as_tensor(np.array(order, np.int32)),
    )


class BVHFront(NamedTuple):
    """A disjoint cut of BVH subtrees covering every sphere: each entry's
    AABB and its contiguous sphere range in leaf order (numpy)."""

    fmin: np.ndarray    # [F, 3] float32
    fmax: np.ndarray    # [F, 3] float32
    start: np.ndarray   # [F] int32
    count: np.ndarray   # [F] int32, 0 for padding entries


def bvh_front(bvh: FlatBVH, max_nodes: int = 32, max_count: int | None = None,
              order_point=None) -> BVHFront:
    """Greedy cut: split the front subtree with the most spheres until
    `max_nodes` subtrees (and, with `max_count`, until none owns more).

    `order_point` (e.g. the camera position) orders subtrees near-to-far by
    box-centre distance, so the front kernel's best-t clamp culls far
    subtrees once near geometry has been hit; otherwise leaf order."""
    miss = bvh.miss_link.numpy()
    lstart = bvh.leaf_start.numpy()
    lcount = bvh.leaf_count.numpy()
    nmin = bvh.node_min.numpy().astype(np.float32)
    nmax = bvh.node_max.numpy().astype(np.float32)
    m = miss.shape[0]
    end = np.where(miss == SENTINEL, m, miss)

    pref = np.concatenate([[0], np.cumsum(lcount)])
    next_leaf_start = np.full(m + 1, 0, np.int64)
    nxt = 0
    for i in range(m - 1, -1, -1):
        if lcount[i] > 0:
            nxt = lstart[i]
        next_leaf_start[i] = nxt

    def prim_count(i: int) -> int:
        return int(pref[end[i]] - pref[i])

    heap: list[tuple[int, int]] = [(-prim_count(0), 0)]
    done: list[int] = []

    def must_split(negc: int) -> bool:
        return max_count is not None and -negc > max_count

    while heap and (len(heap) + len(done) < max_nodes or must_split(heap[0][0])):
        negc, i = heapq.heappop(heap)
        if lcount[i] > 0:
            done.append(i)
            continue
        left = i + 1
        right = int(end[left])
        heapq.heappush(heap, (-prim_count(left), left))
        heapq.heappush(heap, (-prim_count(right), right))
    done.extend(i for _, i in heap)
    if order_point is not None:
        p = np.asarray(order_point, np.float64)
        ctr = 0.5 * (nmin.astype(np.float64) + nmax.astype(np.float64))
        d2 = ((ctr - p[None, :]) ** 2).sum(axis=1)
        done.sort(key=lambda i: float(d2[i]))
    else:
        done.sort(key=lambda i: int(next_leaf_start[i]))

    f = len(done)
    fmin = nmin[done]
    fmax = nmax[done]
    start = np.array([next_leaf_start[i] for i in done], np.int32)
    count = np.array([prim_count(i) for i in done], np.int32)
    if int(count.sum()) != int(pref[-1]):
        raise RuntimeError("front does not cover every sphere")
    if f < max_nodes:
        # Degenerate points at 1e30: near == far on every axis, so the
        # strict tf > tn slab test always misses.
        pad = max_nodes - f
        fmin = np.concatenate([fmin, np.full((pad, 3), 1e30, np.float32)])
        fmax = np.concatenate([fmax, np.full((pad, 3), 1e30, np.float32)])
        start = np.concatenate([start, np.zeros(pad, np.int32)])
        count = np.concatenate([count, np.zeros(pad, np.int32)])
    return BVHFront(fmin=fmin, fmax=fmax, start=start, count=count)


def reorder_scene(scene: Scene, bvh: FlatBVH) -> Scene:
    """Permute the sphere arrays into BVH leaf order."""
    return scene.take(bvh.prim_order)


def bvh_closest_hit(
    origin: torch.Tensor,     # [R, 3]
    direction: torch.Tensor,  # [R, 3]
    time: torch.Tensor,       # [R]
    scene: Scene,             # must be reorder_scene(scene, bvh)
    bvh: FlatBVH,
    t_min: float = T_MIN,
) -> HitRecord:
    """Stackless closest-hit traversal, vectorised over rays: equals
    ops.intersect.closest_hit on the reordered scene up to ties (indices
    are into the reordered arrays). Forward only: no gradient.

    Every ray holds a node pointer; the loop runs until every pointer is
    the sentinel (one host read per iteration). An iteration is one box
    test and, on leaf lanes, a window of sphere tests. The window is the
    largest `leaf_count` of the tree it is given, so any `leaf_size` of
    `build_bvh` is covered (the JAX function's window is its LEAF_SIZE)."""
    dev = origin.device
    bvh = FlatBVH(*(x.to(dev) for x in bvh))
    with torch.no_grad():
        c0, cd, radius = scene.center0, scene.center_delta, scene.radius
        n_rays, n_prims = origin.shape[0], radius.shape[0]
        inv_d = 1.0 / torch.where(torch.abs(direction) > 1e-20, direction, 1e-20)
        a_quad = torch.clamp_min(dot3(direction, direction), 1e-20)[:, None]
        inv_a = 1.0 / a_quad
        window = max(int(bvh.leaf_count.max()), 1)
        offsets = torch.arange(window, device=dev)
        miss_link, leaf_start = bvh.miss_link.long(), bvh.leaf_start.long()
        leaf_count = bvh.leaf_count.long()

        ptr = torch.zeros((n_rays,), dtype=torch.int64, device=dev)
        best_t = torch.full((n_rays,), T_MAX, dtype=origin.dtype, device=dev)
        best_idx = torch.zeros((n_rays,), dtype=torch.int64, device=dev)
        while bool((ptr != SENTINEL).any()):
            active = ptr != SENTINEL
            node = torch.where(active, ptr, 0)
            t0 = (bvh.node_min[node] - origin) * inv_d
            t1 = (bvh.node_max[node] - origin) * inv_d
            tn = torch.clamp_min(torch.amax(torch.minimum(t0, t1), dim=-1), t_min)
            tf = torch.minimum(torch.amin(torch.maximum(t0, t1), dim=-1), best_t)
            box_hit = active & (tf > tn)
            lcount = leaf_count[node]
            is_leaf = lcount > 0

            prim = torch.clamp_max(leaf_start[node][:, None] + offsets[None, :], n_prims - 1)
            pvalid = (offsets[None, :] < lcount[:, None]) & (box_hit & is_leaf)[:, None]
            center = c0[prim] + time[:, None, None] * cd[prim]   # [R, L, 3]
            rad = radius[prim]                                   # [R, L]
            oc = origin[:, None, :] - center
            half_b = dot3(oc, direction[:, None, :])
            cq = dot3(oc, oc) - rad * rad
            disc = half_b * half_b - a_quad * cq
            dpos = disc > 0.0
            sq = torch.sqrt(torch.where(dpos, disc, 1.0))
            r0 = (-half_b - sq) * inv_a
            r1 = (-half_b + sq) * inv_a
            in0 = (r0 > t_min) & (r0 < best_t[:, None])
            in1 = (r1 > t_min) & (r1 < best_t[:, None])
            root = torch.where(pvalid & dpos & (in0 | in1), torch.where(in0, r0, r1), T_MAX)

            lane = torch.argmin(root, dim=-1, keepdim=True)
            lane_t = torch.gather(root, 1, lane)[:, 0]
            better = lane_t < best_t
            best_t = torch.where(better, lane_t, best_t)
            best_idx = torch.where(better, torch.gather(prim, 1, lane)[:, 0], best_idx)

            # an inner node that was hit descends to its first child
            # (ptr + 1); a leaf, or any miss, skips along the miss link
            nxt = torch.where(box_hit & ~is_leaf, node + 1, miss_link[node])
            ptr = torch.where(active, nxt, SENTINEL)

        hit = torch.isfinite(best_t)
        p, normal, front_face = hit_geometry(origin, direction, time, c0, cd, radius,
                                             best_t, best_idx, hit)
    return HitRecord(t=best_t, idx=best_idx.to(torch.int32), hit=hit, p=p, normal=normal,
                     front_face=front_face)
