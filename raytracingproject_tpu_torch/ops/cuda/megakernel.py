"""The path-tracing megakernel: host tables, the CUDA wrapper and the
plain PyTorch versions of its kernels.

Counterpart of raytracingproject_tpu/ops/pallas/megakernel.py. The kernels
(K1 bounce loop, K2 brute closest hit, K3 front-culled closest hit, K7 the
front with its sphere table in global memory, K8 the BVH walk, K5, the
bounce loop that records path residuals over the brute, front or BVH
closest hit, and K6, the bounce loop as a resumable depth segment) are
hand-written CUDA in csrc/megakernel.cu. `trace_paths`, `trace_record` and
`segment_call` are the public entries: for CUDA tensors they launch a
kernel or raise; for CPU tensors they run the plain versions ("the twin")
defined here, which the tests hold against the JAX package and which
chip_smoke.py holds against the kernels. ops/cuda/depth_tail.py drives K6
(two-phase and segmented tracing).

Which closest hit runs: `front` (FrontTables: K3, tables in shared memory;
FrontTablesHBM: K7, any size) wins over `bvh` (K8, any size), else the
brute scan over `scene` (K2, any size: the kernel stages the table in
chunks and spreads each block's live rays over its threads).
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch

from raytracingproject_tpu_torch.config import DIELECTRIC, LAMBERTIAN, METAL, T_MIN
from raytracingproject_tpu_torch.ops.rng import ball_radius, bounce_uniforms, unit_vector
from raytracingproject_tpu_torch.scene import Scene
from raytracingproject_tpu_torch.utils.profiling import sync

# Rays per CUDA block (TPB in csrc/megakernel.cu). The TPU kernel's
# 1024-ray (8, 128) tile is TPU layout; here a block is 8 warps of 32 rays,
# and culling decisions are made per ray (over lane groups of a warp or a
# block).
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
BLOCK = 128  # columns per subtree of the global-memory front (K7)

# Dynamic shared memory one block may use on an H100 (227 KB). The front
# kernels stage their whole tables there; past it the front keeps its
# spheres in global memory (K7).
SMEM_BUDGET_BYTES = 232448
# Shared memory K6's front segment keeps beside the front's tables, and K7
# alone: the block's live rays (9 words each), their winners (t, column)
# and each warp's live count (csrc/megakernel.cu LIST_SMEM_BYTES). A front
# the depth tail runs on must leave this much of the budget.
SEGMENT_LIST_BYTES = 4 * (9 * TILE + 2 * TILE + TILE // 32)

# Intra-word re-pack count of the JAX package's front tables.
DEFAULT_REPACK = 2

# Residual idx codes of the recording kernel (K5) besides a hit's winner
# (csrc/megakernel.cu MISS / DEAD; grad/replay.py re-exports them).
MISS = -1
DEAD = -2

# K6's carried state: [STATE_ROWS, R] float32 planes, ray-minor (rows: o xyz,
# d xyz, time, throughput rgb, radiance rgb, alive as 0/1), and with
# record_miss MISS_ROWS more (the miss direction xyz and throughput rgb; a
# zero direction means "has not missed"). csrc/megakernel.cu ST_*.
STATE_ROWS = 14
MISS_ROWS = 6
ST_RAD, ST_ALIVE = slice(10, 13), 13
ST_MDIR, ST_MTHR = slice(14, 17), slice(17, 20)

# Kernel launches per entry point, counted by the wrapper after each
# successful launch (and nowhere else). `brute_chunked` is the brute scan
# (every table size); `*_miss` are the record_miss versions; `segment_*`
# are K6 (plain, record_miss, recording). `*_opts` are K3 with its options
# (sub_block, word_earlyout); `brute_chunked_schlick3` is the brute scan
# with the planted Schlick fault.
LAUNCHES = {"front": 0, "record_front": 0, "brute_chunked": 0, "record_brute_chunked": 0,
            "bvh": 0, "record_bvh": 0, "front_hbm": 0, "front_miss": 0,
            "brute_chunked_miss": 0, "bvh_miss": 0, "front_hbm_miss": 0, "front_opts": 0,
            "front_opts_miss": 0, "record_front_opts": 0, "brute_chunked_schlick3": 0}
LAUNCHES.update({f"segment_{kind}{scan}": 0 for scan in ("brute_chunked", "front", "front_opts")
                 for kind in ("", "miss_", "record_")})

# The planted physics faults `trace_paths(inject_bug=)` takes (megakernel.py
# of the JAX package, :683-688): "schlick3", Schlick's reflectance with the
# exponent 3 instead of 5, which the per-material-region statistic must catch.
INJECT_BUGS = ("schlick3",)


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
    Same arrays, options and layout as the JAX package's FrontTables.

    Options (both only cull, so the closest hit is the same): `bf` and
    `ksub` (sub-block descent: inside a live subtree, the boxes of its
    8-column groups, column j of `bf` bounding padded columns [8j, 8j + 8);
    ksub is the biggest subtree's group count, 0 without) and
    `word_earlyout` (a live word's union box re-tested against the best t
    before its subtrees). The forward kernel takes both; the recording (K5)
    and segment (K6) kernels take `word_earlyout` and scan without the
    sub-block boxes, as the JAX package's do.

    `remap` maps a padded column to a sphere of the scene the tables were
    built over: the leaf-ordered scene for `front_tables` (`remap_order`
    "leaf"), the original scene for `FrontRefresher` ("scene"). `owner`,
    where the builder has it, is `column_subtree()`'s map."""

    sph: torch.Tensor    # (16, Np) front-padded sphere table
    ff: torch.Tensor     # (8, F) f32 subtree boxes (min xyz, max xyz, 0, 0)
    fi: torch.Tensor     # (2, F) i32 (start, padded count)
    wf: torch.Tensor     # (8, Wp) f32 word union boxes
    sf: torch.Tensor     # (8, S) f32 super-word union boxes
    remap: torch.Tensor  # (Np,) i32 padded column -> sphere (see remap_order)
    repack: int = 1
    bf: torch.Tensor | None = None   # (8, Np // 8 + ksub) f32 boxes of 8-column groups
    ksub: int = 0
    word_earlyout: bool = False
    remap_order: str = "leaf"
    owner: torch.Tensor | None = None  # (Np,) int64 padded column -> subtree

    def to(self, device) -> "FrontTables":
        t = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return FrontTables(**{k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                              for k, v in t.items()})

    def column_subtree(self) -> torch.Tensor:
        """(Np,) int64: the subtree owning each padded column."""
        if self.owner is not None:
            return self.owner.to(self.sph.device)
        owner = _column_owner(self.fi.cpu().numpy(), self.sph.shape[1])
        return torch.from_numpy(owner).to(self.sph.device)


def _column_owner(fi: np.ndarray, n_cols: int) -> np.ndarray:
    """(n_cols,) int64: the subtree owning each padded column of a front
    whose (start, padded count) table is `fi`."""
    owner = np.zeros(n_cols, np.int64)
    for k in range(fi.shape[1]):
        s, c = int(fi[0, k]), int(fi[1, k])
        owner[s : s + c] = k
    return owner


class FrontOverBudget(ValueError):
    """Front tables exceed the shared-memory budget they were given
    (`front_tables`, `FrontRefresher`)."""


def front_bytes_floor(n_spheres: int) -> int:
    """A lower bound on the shared memory of any front over `n_spheres`
    spheres: the padded table alone holds every sphere's N_ROWS words
    (padding adds columns, the box and range tables add bytes)."""
    return 4 * N_ROWS * n_spheres


def default_front_nodes(n_spheres: int) -> int:
    """Front size: ~26 spheres per subtree, in WORD multiples, at most
    24^3 subtrees."""
    f = max(1, round(n_spheres / 26 / WORD)) * WORD
    return min(max(f, WORD), WORD * WORD * WORD)


def _union_boxes(fmin: np.ndarray, fmax: np.ndarray,
                 real: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(wf, sf): union boxes of each word of WORD subtrees and each
    super-word of WORD words, (8, n) tables, over the `real` subtrees only.
    All-padding entries keep the degenerate 1e30 point, which the strict
    slab test always misses. Past one super-word the word table is padded
    to a WORD multiple."""
    n_words = fmin.shape[0] // WORD
    n_super = (n_words + WORD - 1) // WORD
    n_words_pad = n_super * WORD if n_super > 1 else n_words
    wf = np.full((8, n_words_pad), 0.0, np.float32)
    wf[0:6] = 1e30
    for wd in range(n_words):
        sl = slice(wd * WORD, (wd + 1) * WORD)
        if real[sl].any():
            wf[0:3, wd] = fmin[sl][real[sl]].min(axis=0)
            wf[3:6, wd] = fmax[sl][real[sl]].max(axis=0)
    sf = np.full((8, max(n_super, 1)), 0.0, np.float32)
    sf[0:6] = 1e30
    for sw in range(n_super):
        sl = slice(sw * WORD, min((sw + 1) * WORD, n_words))
        live = wf[0, sl] < 1e29
        if live.any():
            sf[0:3, sw] = wf[0:3, sl][:, live].min(axis=1)
            sf[3:6, sw] = wf[3:6, sl][:, live].max(axis=1)
    return wf, sf


def front_tables(scene: Scene, bvh, max_nodes: int | None = None, order_point=None,
                 repack: int | None = None, sub_block: bool = False,
                 word_earlyout: bool = False, device=None,
                 smem_budget: int | None = SMEM_BUDGET_BYTES) -> FrontTables:
    """Build the front-culling tables (megakernel.py:976-1099 of the JAX
    package). `scene` must already be in BVH leaf order (reorder_scene).

    Each subtree's sphere range is padded to a UNROLL multiple by repeating
    its last sphere, a no-op under the strict `<` best-t update.
    `order_point` orders subtrees near-to-far. Raises FrontOverBudget (a
    ValueError) when the tables exceed `smem_budget` bytes, the kernel's shared memory; None
    skips the check (the plain version has no such limit). A front of more
    than 576 subtrees (super-words) pads to over 4608 columns, past the
    budget, so the kernel meets one only with the global-memory front (K7).

    `sub_block` adds the boxes of every 8 padded columns (`bf`, with ksub
    degenerate 1e30 columns at its end as the JAX package pads them; the
    kernel stages them in shared memory too); it pairs with fewer, bigger
    subtrees (a small `max_nodes`). `word_earlyout` re-tests a live word's
    union box against the best t. See FrontTables.

    A scene whose `front_bytes_floor` already passes `smem_budget` is
    refused before anything is built."""
    from raytracingproject_tpu_torch.bvh import bvh_front

    floor = front_bytes_floor(scene.num_spheres)
    if smem_budget is not None and floor > smem_budget:
        raise FrontOverBudget(
            f"front tables of {scene.num_spheres} spheres need at least {floor} B of shared "
            f"memory (> {smem_budget} budget)")
    if repack is None:
        repack = DEFAULT_REPACK
    if repack <= 0 or WORD % repack:
        raise ValueError(f"repack {repack} must divide {WORD}")
    device = scene.device if device is None else device
    if max_nodes is None:
        max_nodes = default_front_nodes(scene.num_spheres)
    max_nodes = ((max_nodes + WORD - 1) // WORD) * WORD
    fr = bvh_front(bvh, max_nodes=max_nodes, order_point=order_point)
    table = scene_table(scene)
    with sync("rtp.sync.table"):
        sph = table.cpu().numpy()

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
    wf, sf = _union_boxes(fr.fmin, fr.fmax, fr.count > 0)
    bf, ksub = None, 0
    if sub_block:
        c0 = sph_pad[0:3]
        c1 = c0 + sph_pad[3:6]
        rad = np.abs(sph_pad[6])
        nblk = sph_pad.shape[1] // UNROLL
        ksub = int(new_count.max() // UNROLL)
        if ksub > 31:
            raise ValueError(f"a subtree of {ksub * UNROLL} spheres: sub_block packs at most 31 "
                             "groups of 8 (build the front with more, smaller subtrees)")
        bf = np.zeros((8, nblk + ksub), np.float32)
        bf[0:6] = 1e30
        bf[0:3, :nblk] = (np.minimum(c0, c1) - rad).reshape(3, nblk, UNROLL).min(axis=2)
        bf[3:6, :nblk] = (np.maximum(c0, c1) + rad).reshape(3, nblk, UNROLL).max(axis=2)
        bf[6:8, :nblk] = 0.0
    smem_bytes = 4 * (sph_pad.size + ff.size + fi.size + wf.size + sf.size
                      + (0 if bf is None else bf.size))
    if smem_budget is not None and smem_bytes > smem_budget:
        raise FrontOverBudget(
            f"front tables need {smem_bytes} B of shared memory (> {smem_budget} "
            f"budget): {sph_pad.shape[1]} padded spheres x {N_ROWS} rows")
    t = torch.from_numpy
    return FrontTables(
        sph=t(sph_pad).to(device), ff=t(ff).to(device), fi=t(fi).to(device),
        wf=t(wf).to(device), sf=t(sf).to(device), remap=t(remap).to(device),
        repack=repack, bf=None if bf is None else t(bf).to(device), ksub=ksub,
        word_earlyout=bool(word_earlyout), owner=t(_column_owner(fi, pos)).to(device),
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


class FrontRefresher:
    """Front tables for GEOMETRY training, refreshed from the current
    parameters on every step (FrontRefresher of the JAX package,
    megakernel.py:1102-1337).

    The partition (the BVH front's subtrees, their sphere ranges padded to
    UNROLL columns, the words and super-words) is fixed here, once, on the
    host; a refresh recomputes only the values: the padded sphere table
    and the exact union boxes of every subtree, word and super-word. The
    culling stays exact for any partition as long as each box bounds its
    spheres, which exact unions do; only its quality decays as the
    geometry drifts from the build-time sort (build a new refresher then).

    `scene` is in its original order, never reordered: `remap` maps a
    padded column to that order (`prim_order` composed in, `remap_order`
    "scene"), so the training scene and its parameters stay as they are.
    `bvh` is a FlatBVH over `scene`; `max_nodes`, `order_point` and
    `repack` (None: DEFAULT_REPACK) are `front_tables`'. The tables'
    shared memory is counted as `front_tables` counts it; past
    SMEM_BUDGET_BYTES this raises FrontOverBudget, before any launch.

    The static maps (column to source sphere, column to subtree, the
    `real` subtrees) live on `scene`'s device; `to(device)` moves them."""

    def __init__(self, scene: Scene, bvh, max_nodes: int | None = None, order_point=None,
                 repack: int | None = None):
        from raytracingproject_tpu_torch.bvh import bvh_front

        self.repack = DEFAULT_REPACK if repack is None else repack
        if self.repack <= 0 or WORD % self.repack:
            raise ValueError(f"repack {self.repack} must divide {WORD}")
        if max_nodes is None:
            max_nodes = default_front_nodes(scene.num_spheres)
        max_nodes = ((max_nodes + WORD - 1) // WORD) * WORD
        fr = bvh_front(bvh, max_nodes=max_nodes, order_point=order_point)
        n_front = fr.start.shape[0]
        cols = []
        start = np.zeros(n_front, np.int32)
        count = np.zeros(n_front, np.int32)
        pos = 0
        for k in range(n_front):
            s, c = int(fr.start[k]), int(fr.count[k])
            if c == 0:
                continue
            cp = ((c + UNROLL - 1) // UNROLL) * UNROLL
            ids = np.arange(s, s + c, dtype=np.int64)
            cols.append(np.concatenate([ids, np.repeat(ids[-1:], cp - c)]))
            start[k], count[k] = pos, cp
            pos += cp
        self.n_front = n_front
        self.n_words = n_front // WORD
        self.n_super = (self.n_words + WORD - 1) // WORD
        self.n_words_pad = self.n_super * WORD if self.n_super > 1 else self.n_words
        smem_bytes = 4 * (N_ROWS * pos + 8 * n_front + 2 * n_front + 8 * self.n_words_pad
                          + 8 * self.n_super)
        if smem_bytes > SMEM_BUDGET_BYTES:
            raise FrontOverBudget(
                f"refreshed front tables need {smem_bytes} B of shared memory (> "
                f"{SMEM_BUDGET_BYTES}): {pos} padded spheres x {N_ROWS} rows. Geometry "
                "training at this scale takes the brute recording forward "
                "(make_fast_train_step without front or bvh)")
        fi = np.stack([start, count])
        self._real_np = count > 0
        self._starts_np = start[self._real_np]
        dev = scene.device
        prim_order = bvh.prim_order.cpu().numpy().astype(np.int64)
        self.scene = scene
        self.col_src = torch.from_numpy(prim_order[np.concatenate(cols)]).to(dev)
        self.owner = torch.from_numpy(_column_owner(fi, pos)).to(dev)
        self.real = torch.from_numpy(count > 0).to(dev)
        self.fi = torch.from_numpy(fi).to(dev)
        self.remap = self.col_src.to(torch.int32)

    def to(self, device) -> "FrontRefresher":
        """This refresher with its scene and static maps on `device`."""
        out = copy.copy(self)
        out.scene = self.scene.to(device)
        for name in ("col_src", "owner", "real", "fi", "remap"):
            setattr(out, name, getattr(self, name).to(device))
        return out

    def _tables(self, sph: torch.Tensor, ff, wf, sf) -> FrontTables:
        return FrontTables(sph=sph, ff=ff, fi=self.fi, wf=wf, sf=sf, remap=self.remap,
                           repack=self.repack, remap_order="scene", owner=self.owner)

    def _padded_table(self, params) -> torch.Tensor:
        """(16, Np): the current parameters' sphere table, in column order."""
        scene = dataclasses.replace(self.scene, **params._asdict())
        return scene_table(scene).index_select(1, self.col_src)

    def refresh(self, params) -> FrontTables:
        """FrontTables for `params` (a grad.SceneParams over `scene`),
        computed in numpy on the host (`refresh` of the JAX package,
        megakernel.py:1281); on `scene`'s device."""
        dev = self.col_src.device
        sph = self._padded_table(params).detach().cpu().numpy()
        c0 = sph[0:3]
        c1 = c0 + sph[3:6]
        rad = np.abs(sph[6])
        bmin = (np.minimum(c0, c1) - rad).T  # (Np, 3)
        bmax = (np.maximum(c0, c1) + rad).T
        real = self._real_np
        fmin = np.full((self.n_front, 3), 1e30, np.float32)
        fmax = np.full((self.n_front, 3), 1e30, np.float32)
        fmin[real] = np.minimum.reduceat(bmin, self._starts_np, axis=0)
        fmax[real] = np.maximum.reduceat(bmax, self._starts_np, axis=0)
        ff = np.zeros((8, self.n_front), np.float32)
        ff[0:3] = fmin.T
        ff[3:6] = fmax.T
        wf, sf = _union_boxes(fmin, fmax, real)
        t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        return self._tables(t(sph), t(ff), t(wf), t(sf))

    def refresh_device(self, params) -> FrontTables:
        """FrontTables for `params`, computed on their device with device
        ops alone: the counterpart of the JAX package's `refresh_in_jit`
        (megakernel.py:1178). One index_select gathers the padded table;
        the subtree boxes are scatter_reduce amin / amax over the static
        column-to-subtree map, the word and super-word boxes reductions
        over WORD-aligned rows; no host round trip. Min and max are exact,
        so this equals `refresh` bit for bit. Call it under
        torch.no_grad(): the tables carry no gradient."""
        sph = self._padded_table(params)
        c0 = sph[0:3]
        c1 = c0 + sph[3:6]
        rad = torch.abs(sph[6])
        bmin = (torch.minimum(c0, c1) - rad).t()  # (Np, 3)
        bmax = (torch.maximum(c0, c1) + rad).t()
        seg = self.owner[:, None].expand(-1, 3)
        far = torch.full((self.n_front, 3), 1e30, dtype=sph.dtype, device=sph.device)
        real = self.real[:, None]
        fmin = torch.where(real, far.scatter_reduce(0, seg, bmin, "amin", include_self=False),
                           1e30)
        fmax = torch.where(real, far.scatter_reduce(0, seg, bmax, "amax", include_self=False),
                           1e30)
        zeros = lambda n: torch.zeros((2, n), dtype=sph.dtype, device=sph.device)  # noqa: E731
        ff = torch.cat([fmin.t(), fmax.t(), zeros(self.n_front)])
        # padding subtrees carry 1e30 (they lose every min) and -1e30 for the
        # max; a word or super-word with no real subtree is the 1e30 point
        wmin, wmax, w_real = _word_union(fmin, torch.where(real, fmax, -1e30), self.real,
                                         self.n_words)
        pad = self.n_super * WORD - self.n_words
        wmin = torch.cat([wmin, torch.full((pad, 3), 1e30, dtype=sph.dtype, device=sph.device)])
        wmax = torch.cat([wmax, torch.full((pad, 3), 1e30, dtype=sph.dtype, device=sph.device)])
        w_real = torch.cat([w_real, torch.zeros(pad, dtype=torch.bool, device=sph.device)])
        smin, smax, _ = _word_union(wmin, torch.where(w_real[:, None], wmax, -1e30), w_real,
                                    self.n_super)
        n_wf = self.n_words_pad
        wf = torch.cat([wmin[:n_wf].t(), wmax[:n_wf].t(), zeros(n_wf)])
        sf = torch.cat([smin.t(), smax.t(), zeros(self.n_super)])
        return self._tables(sph, ff, wf, sf)


def _word_union(lo: torch.Tensor, hi_masked: torch.Tensor, real: torch.Tensor, n: int):
    """(lo, hi, real) of `n` groups of WORD consecutive boxes: the union of
    each group's real boxes (`hi_masked` holds -1e30 where a box is not
    real), the 1e30 point where a group has none."""
    any_real = real.reshape(n, WORD).any(dim=1)
    lo = torch.where(any_real[:, None], lo.reshape(n, WORD, 3).amin(dim=1), 1e30)
    hi = torch.where(any_real[:, None], hi_masked.reshape(n, WORD, 3).amax(dim=1), 1e30)
    return lo, hi, any_real


@dataclasses.dataclass
class FrontTablesHBM:
    """Tables of the front-culled closest hit with its spheres in global
    memory (K7), built by `front_tables_hbm`: FrontTablesHBM of the JAX
    package. `ff`, `fi`, `wf`, `sf`, `remap`, `bf` and `ksub` are the arrays
    its `front_tables_hbm` makes. Subtree k owns columns [k * BLOCK, k * BLOCK + fi[0, k])
    of a padded table of F * BLOCK columns.

    The spheres are stored sphere-major: `sph` is [F * BLOCK, 16], row c
    holding the 16 table rows of padded column c (the transpose of the JAX
    package's (16, F * BLOCK) table, which was laid out for 128-lane DMA
    slices). A thread of the kernel reads one sphere as one 64-byte record
    from global memory, four 16-byte loads, instead of thirteen words a
    table row apart."""

    sph: torch.Tensor    # (F * BLOCK, 16) f32, sphere-major
    ff: torch.Tensor     # (8, F) f32 subtree boxes
    fi: torch.Tensor     # (1, F) i32 padded counts (block k starts at k * BLOCK)
    wf: torch.Tensor     # (8, Wp) f32 word union boxes
    sf: torch.Tensor     # (8, S) f32 super-word union boxes
    remap: torch.Tensor  # (F * BLOCK,) i32 padded column -> leaf-order sphere
    word_earlyout: bool = False      # re-test a live word's box against best t
    bf: torch.Tensor | None = None   # (8, F * ksub) f32 boxes of 8-column groups
    ksub: int = 0                    # BLOCK // UNROLL with `bf`, else 0

    def to(self, device) -> "FrontTablesHBM":
        t = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return FrontTablesHBM(**{k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                                 for k, v in t.items()})

    def valid_columns(self) -> torch.Tensor:
        """int64 padded columns a scan visits (below their subtree's count),
        ascending."""
        col = torch.arange(self.sph.shape[0], device=self.sph.device)
        return col[col % BLOCK < self.fi[0].long()[col // BLOCK]]


def front_tables_hbm(scene: Scene, bvh, max_nodes: int | None = None, order_point=None,
                     word_earlyout: bool = False, sub_block: bool = False,
                     device=None) -> FrontTablesHBM:
    """Build the tables of the global-memory front (front_tables_hbm of the
    JAX package, megakernel.py:2239-2347). `scene` must already be in BVH
    leaf order. The front is cut until no subtree owns more than BLOCK
    spheres; `order_point` orders subtrees near-to-far. `sub_block` adds a
    box per 8 padded columns, which the kernel reads from global memory
    (so, unlike the TPU's, the table has no size limit); it pairs with
    fewer, bigger subtrees (a small `max_nodes`)."""
    from raytracingproject_tpu_torch.bvh import bvh_front

    device = scene.device if device is None else device
    if max_nodes is None:
        max_nodes = default_front_nodes(scene.num_spheres)
    fr = bvh_front(bvh, max_nodes=max_nodes, max_count=BLOCK, order_point=order_point)
    f_real = fr.start.shape[0]
    f_pad = ((f_real + WORD - 1) // WORD) * WORD
    table = scene_table(scene)
    with sync("rtp.sync.table"):
        sph = table.cpu().numpy()

    blocks = np.zeros((N_ROWS, f_pad * BLOCK), np.float32)
    remap = np.zeros(f_pad * BLOCK, np.int32)
    counts = np.zeros(f_pad, np.int32)
    fmin = np.full((f_pad, 3), 1e30, np.float32)
    fmax = np.full((f_pad, 3), 1e30, np.float32)
    for k in range(f_real):
        s, c = int(fr.start[k]), int(fr.count[k])
        if c == 0:
            continue
        cp = ((c + UNROLL - 1) // UNROLL) * UNROLL
        blk = sph[:, s : s + c]
        ids = np.arange(s, s + c, dtype=np.int32)
        if cp > c:
            blk = np.concatenate([blk, np.repeat(blk[:, -1:], cp - c, axis=1)], axis=1)
            ids = np.concatenate([ids, np.repeat(ids[-1:], cp - c)])
        blocks[:, k * BLOCK : k * BLOCK + cp] = blk
        remap[k * BLOCK : k * BLOCK + cp] = ids
        counts[k] = cp
        fmin[k] = fr.fmin[k]
        fmax[k] = fr.fmax[k]
    ff = np.zeros((8, f_pad), np.float32)
    ff[0:3] = fmin.T
    ff[3:6] = fmax.T
    wf, sf = _union_boxes(fmin, fmax, counts > 0)
    bf, ksub = None, 0
    if sub_block:
        ksub = BLOCK // UNROLL
        c0 = blocks[0:3]
        c1 = c0 + blocks[3:6]
        rad = np.abs(blocks[6])
        real = (np.arange(f_pad * BLOCK) % BLOCK < np.repeat(counts, BLOCK)).reshape(-1, UNROLL)
        lo = np.where(real, (np.minimum(c0, c1) - rad).reshape(3, -1, UNROLL), np.inf).min(axis=2)
        hi = np.where(real, (np.maximum(c0, c1) + rad).reshape(3, -1, UNROLL), -np.inf).max(axis=2)
        bf = np.zeros((8, f_pad * ksub), np.float32)
        bf[0:6] = 1e30
        some = real.any(axis=1)
        bf[0:3, some] = lo[:, some]
        bf[3:6, some] = hi[:, some]
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return FrontTablesHBM(
        sph=t(np.ascontiguousarray(blocks.T)), ff=t(ff), fi=t(counts[None, :].copy()),
        wf=t(wf), sf=t(sf), remap=t(remap), word_earlyout=bool(word_earlyout),
        bf=None if bf is None else t(bf), ksub=ksub,
    )


# Entries of a ray's traversal stack in the BVH kernel (csrc/megakernel.cu
# BVH_STACK): the walk defers at most one child per inner node above the
# one it is at, so it takes trees of at most this depth.
BVH_STACK = 32


class BVHRefused(ValueError):
    """A tree the BVH kernel (K8) cannot walk (`bvh_tables`)."""


@dataclasses.dataclass
class BVHTables:
    """A FlatBVH prepared for the BVH-walking kernel (K8) on one device.

    `nodes` holds one record per inner node, and record 0 for the root's
    parent (its first child the root, its second an empty box). A record
    is sixteen 32-bit words, both children's boxes and references:
    `lo0 xyz, ref0, hi0 xyz, ref1, lo1 xyz, 0, hi1 xyz, 0`, the boxes as
    float32 bits. A reference is the child's record (> 0) or, for a
    leaf, ~((leaf_start << 8) | leaf_count) (< 0). The first child of
    inner node i is node i + 1, the second miss_link[i + 1], both in
    pre-order, so the first holds the lower columns. `depth` is the most
    inner nodes on a path from the root to a leaf: the most children the
    walk defers at once."""

    flat: object         # the FlatBVH, its tensors on the device (the plain version walks it)
    nodes: torch.Tensor  # (1 + inner nodes, 16) i32 records
    depth: int


def _tree_depth(leaf_count: np.ndarray, miss: np.ndarray) -> int:
    """The most inner nodes on a root-to-leaf path of a pre-order tree: a
    node's inner ancestors are the inner nodes j whose subtree, nodes
    (j, miss_link[j]) in pre-order, holds it."""
    m = leaf_count.shape[0]
    inner = np.flatnonzero(leaf_count == 0)
    inside = np.zeros(m + 1, np.int64)
    np.add.at(inside, inner + 1, 1)
    np.add.at(inside, np.where(miss[inner] < 0, m, miss[inner]), -1)
    return int(np.cumsum(inside)[:m][leaf_count > 0].max(initial=0))


# The node records of the trees passed last, newest last, each with the
# tree's tensors and their version counters: a caller that passes the same
# FlatBVH on every pass (`render_pass(bvh=)`, `trace_paths`) has its records
# built once, and a tree changed in place is built again.
_BUILT: list = []
_BUILT_KEPT = 4


def _versions(tensors) -> tuple | None:
    """The tensors' version counters, or None when one has none (a tensor
    made under torch.inference_mode): such tensors are never cached."""
    if any(x.is_inference() for x in tensors):
        return None
    return tuple(x._version for x in tensors)


def bvh_tables(bvh, device) -> BVHTables:
    """`bvh` (a FlatBVH over a leaf-ordered scene, or BVHTables) on
    `device`, with the kernel's node records (see BVHTables), built on the
    host from the tree as it is, once for each tree of the last few passed.
    Raises BVHRefused (a ValueError) for a leaf of more than 255 spheres,
    a scene of 2^23 spheres or more, or a tree deeper than the kernel's
    stack (BVH_STACK)."""
    device = torch.device(device)
    if isinstance(bvh, BVHTables):
        have = bvh.nodes.device
        if have.type == device.type and device.index in (None, have.index):
            return bvh
        bvh = bvh.flat
    versions = _versions(bvh)
    for tree, vers, dev, tables in _BUILT:
        if dev == device and vers == versions and all(a is b for a, b in zip(tree, bvh)):
            return tables
    tables = _build_bvh_tables(bvh, device)
    if versions is not None:
        _BUILT.append((tuple(bvh), versions, device, tables))
        del _BUILT[:-_BUILT_KEPT]
    return tables


def _build_bvh_tables(bvh, device: torch.device) -> BVHTables:
    """BVHTables of the FlatBVH `bvh` on `device` (see `bvh_tables`)."""
    flat = type(bvh)(*(x.to(device) for x in bvh))
    count = bvh.leaf_count.cpu().numpy().astype(np.int64)
    start = bvh.leaf_start.cpu().numpy().astype(np.int64)
    miss = bvh.miss_link.cpu().numpy().astype(np.int64)
    if int(count.max()) > 255 or int(start.max()) >= 1 << 23:
        raise BVHRefused("the BVH kernel packs a leaf as (start << 8) | count: it takes leaves "
                         "of at most 255 spheres and scenes below 2^23 spheres")
    depth = _tree_depth(count, miss)
    if depth > BVH_STACK:
        raise BVHRefused(f"a BVH of depth {depth}: the kernel's traversal stack holds "
                         f"{BVH_STACK} entries (build it with bigger leaves)")
    inner = np.flatnonzero(count == 0)
    record = np.zeros(count.shape[0], np.int64)
    record[inner] = 1 + np.arange(inner.size)
    ref = np.where(count == 0, record, ~((start << 8) | count))
    box = np.concatenate([bvh.node_min.cpu().numpy(), bvh.node_max.cpu().numpy()],
                         axis=1).astype(np.float32).view(np.int32)  # [M, 6]
    empty = np.full(6, 1e30, np.float32).view(np.int32)  # a point every slab test misses
    first = np.concatenate([[0], inner + 1])
    second = miss[inner + 1]
    nodes = np.zeros((1 + inner.size, 16), np.int32)
    nodes[:, 0:3], nodes[:, 4:7] = box[first, 0:3], box[first, 3:6]
    nodes[:, 3] = ref[first]
    nodes[0, 7], nodes[0, 8:11], nodes[0, 12:15] = -1, empty[0:3], empty[3:6]
    nodes[1:, 7] = ref[second]
    nodes[1:, 8:11], nodes[1:, 12:15] = box[second, 0:3], box[second, 3:6]
    return BVHTables(flat=flat, nodes=torch.from_numpy(nodes).to(device), depth=depth)


# ---------------------------------------------------------------------------
# The plain PyTorch versions ("twin") of K2, K3, K7, K8 and K1
# ---------------------------------------------------------------------------

def _sphere_disc(tab: torch.Tensor, ox, oy, oz, dx, dy, dz, tm, a,
                 cols: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(half_b, disc), [R, C] each, of the quadratic `_sphere_t` solves:
    every ray against every column of `tab` (16, C), or with `cols` ([R, L]
    int64) against its own L columns. The roots exist where disc > 0."""
    if cols is None:
        c = lambda row: tab[row][None, :]  # noqa: E731
    else:
        c = lambda row: tab[row][cols]  # noqa: E731
    col = lambda x: x[:, None]  # noqa: E731
    ccx = c(ROW_CX) + col(tm) * c(ROW_MX)
    ccy = c(ROW_CY) + col(tm) * c(ROW_MY)
    ccz = c(ROW_CZ) + col(tm) * c(ROW_MZ)
    rad = c(ROW_RAD)
    ocx, ocy, ocz = col(ox) - ccx, col(oy) - ccy, col(oz) - ccz
    half_b = ocx * col(dx) + ocy * col(dy) + ocz * col(dz)
    cq = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    return half_b, half_b * half_b - col(a) * cq


def _sphere_t(tab: torch.Tensor, ox, oy, oz, dx, dy, dz, tm, a, inv_a,
              t_min: float, cols: torch.Tensor | None = None) -> torch.Tensor:
    """[R, C] hit distance of every ray against every column of `tab`
    (16, C), or with `cols` ([R, L] int64) against its own L columns, +inf
    where the ray misses or hits outside (t_min, inf). The root choice is
    the strict sequential scan's: the near root when it is past t_min, else
    the far one."""
    half_b, disc = _sphere_disc(tab, ox, oy, oz, dx, dy, dz, tm, a, cols)
    col = lambda x: x[:, None]  # noqa: E731
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


def subtree_slab_mask(ff: torch.Tensor, ox, oy, oz, dx, dy, dz, t_min=T_MIN,
                      far: torch.Tensor | None = None) -> torch.Tensor:
    """[R, F] "ray enters subtree box f within (t_min, inf)": the JAX
    package's _slab_factory math without the best-t far clamp; with `far`
    ([R]), within (t_min, far], the kernels' clamped `slab`."""
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
    if far is not None:
        tf = torch.minimum(tf, col(far))
    return tf > tn


def closest_hit_front_twin(front: FrontTables, col_subtree: torch.Tensor,
                           ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min=T_MIN):
    """K3's plain version: spheres of subtrees the ray's slab test misses
    are masked out, then the first minimum over the padded table. Equals
    K3 up to last-ulp ties (culled subtrees cannot hold a strictly closer
    hit; K3's extra best-t clamp only drops farther ones). With sub-block
    boxes (`front.bf`), columns of 8-column groups the ray misses are masked
    out too; `word_earlyout` is a best-t test, which drops only farther
    hits, so like the clamp it has no counterpart here."""
    live = subtree_slab_mask(front.ff, ox, oy, oz, dx, dy, dz, t_min)[:, col_subtree]
    if front.bf is not None:
        group = torch.arange(front.sph.shape[1], device=ox.device) // UNROLL
        live &= subtree_slab_mask(front.bf, ox, oy, oz, dx, dy, dz, t_min)[:, group]
    t = _sphere_t(front.sph, ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min)
    return _first_min(torch.where(live, t, math.inf))


def closest_hit_hbm_twin(front: FrontTablesHBM, tab: torch.Tensor, col_subtree: torch.Tensor,
                         col_group: torch.Tensor | None,
                         ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min=T_MIN):
    """K7's plain version over `tab` (16, C), the front's visited columns
    (`FrontTablesHBM.valid_columns`) in ascending order: columns of
    subtrees (`col_subtree`) and, with sub-block boxes, of 8-column groups
    (`col_group`) whose box the ray misses are masked out, then the first
    minimum. Returns (best t, winner column of `tab` or -1).

    K7 also drops what a ray enters only beyond its best t so far (the
    clamped subtree and group tests, `word_earlyout`): such a box holds no
    strictly closer hit, so the result is the same and the plain version
    has no counterpart of them."""
    live = subtree_slab_mask(front.ff, ox, oy, oz, dx, dy, dz, t_min)[:, col_subtree]
    if col_group is not None:
        live &= subtree_slab_mask(front.bf, ox, oy, oz, dx, dy, dz, t_min)[:, col_group]
    t = _sphere_t(tab, ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min)
    return _first_min(torch.where(live, t, math.inf))


def closest_hit_bvh_twin(tab: torch.Tensor, bvh, ox, oy, oz, dx, dy, dz, tm, a, inv_a,
                         t_min=T_MIN, counts: dict | None = None):
    """K8's plain version: every ray walks the flat tree (`bvh`, a FlatBVH
    on the rays' device, over the leaf-ordered scene of `tab` (16, N)) with
    its own node pointer, in pre-order. A node's box is tested within
    (t_min, best t so far); a leaf that passes scans its spheres in order
    under the strict `<`; an inner node that passes goes to its first
    child, anything else follows the miss link. Returns (best t, winner
    column or -1). With `counts`, adds the box tests ("boxes") and sphere
    tests ("pairs") of rays that are not parked, and the sphere tests among
    them whose discriminant is positive ("roots"): the work the kernel's
    bound reads, whatever walk the kernel takes.

    The kernel walks out of column order (nearer child first, the other
    deferred) and still equals this walk bit for bit: pre-order visits the
    leaves in column order, so this walk keeps the first minimum of
    (t, column) in column order over the spheres it reaches, and the kernel
    carries (t, column) lexicographically, which keeps the same minimum
    whatever order the spheres come in. The spheres either walk reaches
    differ only in boxes entered beyond the final best t, which hold no
    lesser (t, column), as long as the kernel's clamp is not strict on the
    best-t side: a box entered exactly at the best t (or a deferred child
    popped at it) may hold an equal t at a lower column that this walk,
    reaching it first, kept. tests/test_torch_bvh_groups.py holds the
    kernel's walk (`probes.pair_counts.ordered_walk`) against this one and
    shows that a strict clamp loses such a tie."""
    dev, n = ox.device, ox.shape[0]

    def inv(d):
        return 1.0 / torch.where(torch.abs(d) > 1e-20, d, 1e-20)

    ix, iy, iz = inv(dx), inv(dy), inv(dz)
    nmin, nmax = bvh.node_min.to(ox.dtype), bvh.node_max.to(ox.dtype)
    miss_link, leaf_start = bvh.miss_link.long(), bvh.leaf_start.long()
    leaf_count = bvh.leaf_count.long()
    offsets = torch.arange(max(int(leaf_count.max()), 1), device=dev)
    ptr = torch.zeros(n, dtype=torch.int64, device=dev)
    bt = torch.full((n,), math.inf, dtype=ox.dtype, device=dev)
    win = torch.full((n,), -1, dtype=torch.int64, device=dev)
    while True:
        active = ptr >= 0
        if not bool(active.any()):
            break
        node = torch.where(active, ptr, 0)
        lo, hi = nmin[node], nmax[node]
        t0, t1 = (lo[:, 0] - ox) * ix, (hi[:, 0] - ox) * ix
        tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
        t0, t1 = (lo[:, 1] - oy) * iy, (hi[:, 1] - oy) * iy
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
        t0, t1 = (lo[:, 2] - oz) * iz, (hi[:, 2] - oz) * iz
        tn = torch.maximum(tn, torch.clamp_min(torch.minimum(t0, t1), t_min))
        tf = torch.minimum(tf, torch.minimum(torch.maximum(t0, t1), bt))
        entered = active & (tf > tn)
        count = leaf_count[node]
        rows = torch.nonzero(entered & (count > 0))[:, 0]
        if counts is not None:
            counts["boxes"] += int((active & (ox < 1e17)).sum())
            counts["pairs"] += int(count[rows].sum())
        if rows.numel():
            cols = torch.clamp_max(leaf_start[node[rows]][:, None] + offsets[None, :],
                                   tab.shape[1] - 1)
            if counts is not None:
                _, disc = _sphere_disc(tab, *(x[rows] for x in (ox, oy, oz, dx, dy, dz, tm, a)),
                                       cols=cols)
                valid = offsets[None, :] < count[rows][:, None]
                counts["roots"] = counts.get("roots", 0) + int(((disc > 0.0) & valid).sum())
            t = _sphere_t(tab, *(x[rows] for x in (ox, oy, oz, dx, dy, dz, tm, a, inv_a)),
                          t_min, cols=cols)
            t = torch.where(offsets[None, :] < count[rows][:, None], t, math.inf)
            lane = torch.argmin(t, dim=1, keepdim=True)
            lane_t = torch.gather(t, 1, lane)[:, 0]
            better = lane_t < bt[rows]
            bt[rows] = torch.where(better, lane_t, bt[rows])
            win[rows] = torch.where(better, torch.gather(cols, 1, lane)[:, 0], win[rows])
        ptr = torch.where(active, torch.where(entered & (count == 0), node + 1,
                                              miss_link[node]), -1)
    return bt, win


def _bounce_core(state, ray, bounce0: int, depth: int, tab, closest_hit, seed: int,
                 t_min: float, zero_draws: bool, record: bool, record_miss: bool,
                 inject_bug: str | None = None):
    """`depth` bounces of K1's loop from the carried `state` (the STATE_ROWS
    planes as a list of [R] tensors, alive as bool, and with `record_miss`
    the MISS_ROWS miss planes), the uniforms of bounce k keyed by (seed,
    `ray`, bounce0 + k). `inject_bug` plants a fault (INJECT_BUGS). Returns
    (state after the bounces, residual planes or None)."""
    (ox, oy, oz, dx, dy, dz, tm, thr_r, thr_g, thr_b, rad_r, rad_g, rad_b,
     alive) = state[:STATE_ROWS]
    miss = list(state[STATE_ROWS:STATE_ROWS + MISS_ROWS]) if record_miss else []
    dev, dt = ox.device, ox.dtype
    n = ox.shape[0]
    res = None
    if record:
        res = (torch.full((depth, n), DEAD, dtype=torch.int32, device=dev),
               *(torch.zeros((depth, n), dtype=dt, device=dev) for _ in range(3)),
               torch.zeros((depth, n), dtype=torch.uint8, device=dev))
    where = torch.where
    for dep in range(depth):
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

        # sky on a miss, or with record_miss the direction and throughput at
        # the miss (a miss retires the ray, so it happens once)
        inv_len = 1.0 / torch.sqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20))
        if record_miss:
            missed = alive & ~hit
            miss = [where(missed, v, mv)
                    for v, mv in zip((dx, dy, dz, thr_r, thr_g, thr_b), miss)]
        else:
            m = (alive & ~hit).to(torch.float32)
            sky_a = 0.5 * (dy * inv_len + 1.0)
            rad_r = rad_r + m * thr_r * (1.0 - sky_a + sky_a * 0.5)
            rad_g = rad_g + m * thr_g * (1.0 - sky_a + sky_a * 0.7)
            rad_b = rad_b + m * thr_b * (1.0 - sky_a + sky_a * 1.0)

        # scatter
        udx, udy, udz = dx * inv_len, dy * inv_len, dz * inv_len
        u1, u2, u3, u4 = bounce_uniforms(seed, ray, bounce0 + dep, zero_draws)
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
        if inject_bug == "schlick3":  # the planted fault: exponent 3
            schlick = r0s + (1.0 - r0s) * one_m * one_m * one_m
        else:
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
            res_idx, res_ndx, res_ndy, res_ndz, res_refl = res
            res_idx[dep] = where(hit_live, win, where(alive & ~hit, MISS, DEAD)).to(torch.int32)
            for plane, v in zip((res_ndx, res_ndy, res_ndz), (sx, sy, sz)):
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
    return [ox, oy, oz, dx, dy, dz, tm, thr_r, thr_g, thr_b, rad_r, rad_g, rad_b, alive,
            *miss], res


def bounce_loop_twin(origin, direction, time, tab, closest_hit, seed: int, max_depth: int,
                     ray0: int = 0, t_min: float = T_MIN, zero_draws: bool = False,
                     record: bool = False, record_miss: bool = False,
                     inject_bug: str | None = None):
    """K1's plain version: the per-ray bounce loop of the JAX package's
    _bounce_loop, operation for operation. `tab` is the (16, C) table the
    winner columns index; `ray0` is the global slot of the first ray (the
    RNG counter).

    Returns the radiance [R, 3]; with `record` (K5's plain version) also
    the residual planes (idx, ndx, ndy, ndz, refl), each [max_depth, R],
    as the recording kernel writes them: idx is the winner column of `tab`
    on a live hit, MISS on a live miss and DEAD otherwise; nd* is the
    scattered direction on a live hit, else 0; refl is the dielectric
    reflect branch of a live hit. With `record_miss` the built-in sky is
    left out and it returns (radiance, mdir [R, 3], mthr [R, 3]): the
    direction and throughput at the ray's miss, both exactly 0 where the
    ray never missed.

    Values are float32 as in the kernel; float64 rays and table give the
    same loop in float64 (tests take finite differences through it).
    `inject_bug` plants a physics fault (INJECT_BUGS), for tests."""
    dev, dt = origin.device, origin.dtype
    n = origin.shape[0]
    one = torch.ones(n, dtype=dt, device=dev)
    zero = torch.zeros(n, dtype=dt, device=dev)
    state = [*(origin[:, q] for q in range(3)), *(direction[:, q] for q in range(3)), time,
             one, one, one, zero, zero, zero, torch.ones(n, dtype=torch.bool, device=dev)]
    state += [zero] * (MISS_ROWS if record_miss else 0)
    ray = torch.arange(ray0, ray0 + n, dtype=torch.int64, device=dev)
    state, res = _bounce_core(state, ray, 0, max_depth, tab, closest_hit, seed, t_min,
                              zero_draws, record, record_miss, inject_bug)
    rad = torch.stack(state[10:13], dim=1)
    if record:
        return rad, res
    if record_miss:
        return rad, torch.stack(state[14:17], dim=1), torch.stack(state[17:20], dim=1)
    return rad


def _twin_chunk(n_cols: int) -> int:
    """Rays per twin chunk: keeps each [rays, columns] temporary near 64 MB."""
    return max(TILE, ((1 << 24) // max(n_cols, 1)) // TILE * TILE)


def trace_paths_twin(origin, direction, time, scene: Scene | None, seed: int, max_depth: int,
                     t_min: float = T_MIN, front=None, zero_draws: bool = False,
                     bvh=None, record_miss: bool = False, inject_bug: str | None = None):
    """Plain PyTorch `trace_paths` on any device, in ray chunks."""
    _check_inject_bug(inject_bug)
    return _twin(origin, direction, time, scene, seed, max_depth, t_min, front, zero_draws,
                 bvh, record=False, record_miss=record_miss, inject_bug=inject_bug)


def _check_inject_bug(inject_bug) -> None:
    if inject_bug is not None and inject_bug not in INJECT_BUGS:
        raise ValueError(f"inject_bug {inject_bug!r} is not one of {INJECT_BUGS}")


def trace_record_twin(origin, direction, time, scene: Scene | None, seed: int, max_depth: int,
                      t_min: float = T_MIN, front: FrontTables | None = None,
                      zero_draws: bool = False, bvh=None):
    """Plain PyTorch `trace_record` on any device: (radiance [R, 3],
    PathResiduals)."""
    _no_hbm_record(front)
    rad, planes = _twin(origin, direction, time, scene, seed, max_depth, t_min, front,
                        zero_draws, bvh, record=True)
    return rad, decode_residuals(planes, origin.shape[0], front)


def _no_hbm_record(front) -> None:
    if isinstance(front, FrontTablesHBM):
        raise ValueError(
            "trace_record takes no FrontTablesHBM (nor does the JAX package's "
            "pallas_trace_record): record large scenes with bvh=, or with a FrontTables "
            "that fits shared memory")


def twin_closest_hit(scene: Scene | None, front, bvh, device):
    """(tab, closest_hit, chunk): the plain closest hit `trace_paths` would
    run for these arguments (front over bvh over brute), as the callable
    `bounce_loop_twin` takes, the (16, C) table its winners index, and the
    rays to give it at a time (the scans hold [rays, columns] temporaries,
    the walk a leaf's few columns a ray)."""
    if isinstance(front, FrontTablesHBM):
        cols = front.valid_columns()
        tab = front.sph[cols].t().contiguous()
        col_subtree = cols // BLOCK
        col_group = None if front.bf is None else cols // UNROLL

        def hit(*r):
            return closest_hit_hbm_twin(front, tab, col_subtree, col_group, *r)
    elif front is not None:
        tab = front.sph
        owner = front.column_subtree()

        def hit(*r):
            return closest_hit_front_twin(front, owner, *r)
    elif bvh is not None:
        tab = scene_table(scene).to(device)
        flat = bvh_tables(bvh, device).flat

        def hit(*r):
            return closest_hit_bvh_twin(tab, flat, *r)

        return tab, hit, _twin_chunk(64)
    else:
        tab = scene_table(scene).to(device)

        def hit(*r):
            return closest_hit_brute_twin(tab, *r)
    return tab, hit, _twin_chunk(tab.shape[1])


def _twin(origin, direction, time, scene, seed, max_depth, t_min, front, zero_draws, bvh,
          record: bool, record_miss: bool = False, inject_bug: str | None = None):
    tab, hit, chunk = twin_closest_hit(scene, front, bvh, origin.device)
    outs = []
    for r0 in range(0, max(origin.shape[0], 1), chunk):  # one empty chunk for 0 rays
        sl = slice(r0, r0 + chunk)
        outs.append(bounce_loop_twin(origin[sl], direction[sl], time[sl], tab, hit, seed,
                                     max_depth, ray0=r0, t_min=t_min, zero_draws=zero_draws,
                                     record=record, record_miss=record_miss,
                                     inject_bug=inject_bug))
    if record:
        rad = torch.cat([r for r, _ in outs])
        planes = tuple(torch.cat([p[q] for _, p in outs], dim=1) for q in range(5))
        return rad, planes
    if record_miss:
        return tuple(torch.cat([o[q] for o in outs]) for q in range(3))
    return torch.cat(outs)


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


def _segment_front(front) -> None:
    if isinstance(front, FrontTablesHBM):
        raise ValueError(
            "K6 (the depth segment) takes the brute scan or a FrontTables, not a "
            "FrontTablesHBM (nor does the JAX package's _segment_call): trace large scenes "
            "with the monolithic kernel (trace_paths), or with bvh=")


def _state_rows(state: torch.Tensor, record_miss: bool, record: bool) -> int:
    rows = STATE_ROWS + (MISS_ROWS if record_miss else 0)
    if record and record_miss:
        raise ValueError("a segment records residuals or miss planes, not both (as the JAX "
                         "package's _segment_call is used)")
    if state.dim() != 2 or state.shape[0] != rows:
        raise ValueError(f"state has shape {tuple(state.shape)}, expected ({rows}, R)")
    return rows


def segment_twin(state: torch.Tensor, slot: torch.Tensor, scene: Scene | None, seed: int,
                 bounce0: int, depth: int, t_min: float = T_MIN, front=None,
                 zero_draws: bool = False, record_miss: bool = False, record: bool = False):
    """K6's plain version: `bounce_loop_twin` resumed from carried state,
    `depth` bounces. `state` is [STATE_ROWS, R] (with `record_miss`
    STATE_ROWS + MISS_ROWS) float planes, ray-minor: o xyz, d xyz, time,
    throughput rgb, radiance rgb, alive (0/1), then the miss direction and
    throughput; `slot` [R] holds each ray's slot in the monolithic trace,
    and bounce k of the segment draws the uniforms the monolithic trace
    draws for (slot, bounce0 + k). Returns the state after the segment (the
    time plane copied through) and, with `record`, the residual planes
    (idx, ndx, ndy, ndz, refl), each [depth, R], rows indexed by
    segment-local bounce (K5's codes; idx a column of the table the closest
    hit scans)."""
    _segment_front(front)
    rows = _state_rows(state, record_miss, record)
    tab, hit, chunk = twin_closest_hit(scene, front, None, state.device)
    outs, parts = [], []
    for r0 in range(0, max(state.shape[1], 1), chunk):
        sl = slice(r0, r0 + chunk)
        planes = [state[q, sl] for q in range(rows)]
        planes[ST_ALIVE] = planes[ST_ALIVE] > 0.5
        new, res = _bounce_core(planes, slot[sl].long(), bounce0, depth, tab, hit, seed, t_min,
                                zero_draws, record, record_miss)
        new[ST_ALIVE] = new[ST_ALIVE].to(state.dtype)
        outs.append(torch.stack(new))
        parts.append(res)
    out = torch.cat(outs, dim=1)
    if record:
        return out, tuple(torch.cat([r[q] for r in parts], dim=1) for q in range(5))
    return out


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
                front: FrontTables | FrontTablesHBM | None = None, zero_draws: bool = False,
                bvh=None, record_miss: bool = False, inject_bug: str | None = None):
    """Radiance [R, 3] of camera rays: the full path trace in one kernel
    (pallas_trace_paths of the JAX package).

    With `front` the closest hit is front-culled over the front's own
    padded table and `scene` is not read: K3 for a FrontTables (tables in
    shared memory), K7 for a FrontTablesHBM (spheres in global memory, any
    size). Else with `bvh` (a FlatBVH over `scene`, which must be in leaf
    order, or `bvh_tables` of one) it is the BVH walk (K8, any size). Else
    it is the brute scan (K2) over `scene`, staged in chunks (any size).
    `seed` keys the Philox stream
    (ops/rng.py); `zero_draws` makes every uniform 0.0 (the TPU
    interpreter's PRNG).

    With `record_miss` the kernel adds no sky: it returns (radiance,
    mdir [R, 3], mthr [R, 3]), the direction and throughput at each ray's
    miss (zeros where the ray never missed), and the caller adds
    `mthr * sky(mdir)` (an environment map, `render.sky_color`).

    `inject_bug` ("schlick3", for tests) plants a physics fault: Schlick's
    reflectance with the exponent 3 instead of 5, which the
    per-material-region statistic must catch. The plain version takes it
    on every closest hit; the card has it for the forward brute scan alone
    (other routes raise ValueError).

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    PyTorch version."""
    dev = origin.device
    if dev.type == "cpu":
        return trace_paths_twin(origin, direction, time, scene, seed, max_depth, t_min,
                                front, zero_draws, bvh, record_miss, inject_bug)
    _check_inject_bug(inject_bug)
    out, _ = _launch(origin, direction, time, scene, seed, max_depth, t_min, front,
                     zero_draws, bvh, record=False, record_miss=record_miss,
                     inject_bug=inject_bug)
    return out


def trace_record(origin: torch.Tensor, direction: torch.Tensor, time: torch.Tensor,
                 scene: Scene | None, seed: int, max_depth: int, t_min: float = T_MIN,
                 front: FrontTables | None = None, zero_draws: bool = False, bvh=None):
    """`trace_paths` that also records the path residuals for the replay
    backward (pallas_trace_record of the JAX package, K5): returns
    (radiance [R, 3], grad.replay.PathResiduals) with idx [D, R] int32 (a
    sphere of `scene`'s order, in leaf order with `front` or `bvh`; MISS;
    DEAD), ndir [D, R, 3] and refl [D, R] bool. The radiance equals
    `trace_paths`'s for the same rays, seed and closest hit. `front` must
    be a FrontTables: there is no recording kernel over a FrontTablesHBM
    (large scenes record with `bvh`).

    CUDA tensors launch the recording kernel (or raise); CPU tensors run
    its plain PyTorch version."""
    _no_hbm_record(front)
    dev = origin.device
    if dev.type == "cpu":
        return trace_record_twin(origin, direction, time, scene, seed, max_depth, t_min,
                                 front, zero_draws, bvh)
    rad, planes = _launch(origin, direction, time, scene, seed, max_depth, t_min, front,
                          zero_draws, bvh, record=True)
    return rad, decode_residuals(planes, origin.shape[0], front)


def _check_seed(seed: int, depth: int) -> None:
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} is not a 32-bit unsigned value")
    if depth < 0:
        raise ValueError(f"depth {depth} < 0")


def _res_planes(depth: int, n: int, dev):
    """Empty residual planes (idx, ndx, ndy, ndz, refl), [depth, n] each."""
    return (torch.empty((depth, n), dtype=torch.int32, device=dev),
            *(torch.empty((depth, n), dtype=torch.float32, device=dev) for _ in range(3)),
            torch.empty((depth, n), dtype=torch.uint8, device=dev))


def _require_front(front: FrontTables, dev, sub_block: bool, extra: int = 0) -> None:
    """The front's tables on `dev`, of the kernels' types and shapes, and
    within the shared-memory budget with `extra` bytes beside them."""
    n_cols = front.sph.shape[1]
    n_front = front.ff.shape[1]
    _require(front.sph, "front.sph", (N_ROWS, n_cols), torch.float32, dev)
    _require(front.ff, "front.ff", (8, n_front), torch.float32, dev)
    _require(front.fi, "front.fi", (2, n_front), torch.int32, dev)
    _require(front.wf, "front.wf", (8, front.wf.shape[1]), torch.float32, dev)
    _require(front.sf, "front.sf", (8, front.sf.shape[1]), torch.float32, dev)
    tables = [front.sph, front.ff, front.fi, front.wf, front.sf]
    if sub_block and front.ksub:
        _require(front.bf, "front.bf", (8, n_cols // UNROLL + front.ksub), torch.float32, dev)
        tables.append(front.bf)
    smem = 4 * sum(x.numel() for x in tables) + extra
    if smem > SMEM_BUDGET_BYTES:
        raise ValueError(f"front tables need {smem} B of shared memory "
                         f"(> {SMEM_BUDGET_BYTES}) with {extra} B beside them; build them with "
                         f"front_tables_hbm, or for the depth tail with smem_budget="
                         f"SMEM_BUDGET_BYTES - SEGMENT_LIST_BYTES")


def _front_args(front: FrontTables, sub_block: bool) -> tuple:
    """The front entries' table arguments and K3's options; without
    `sub_block` (K5 and K6, as the JAX package's recording and segment
    kernels) the sub-block boxes are left out."""
    p = lambda x: x.data_ptr()  # noqa: E731
    bf = front.bf if sub_block and front.ksub else None
    return (p(front.sph), front.sph.shape[1], p(front.ff), p(front.fi), front.ff.shape[1],
            p(front.wf), front.wf.shape[1], p(front.sf), front.sf.shape[1], front.repack,
            None if bf is None else p(bf), 0 if bf is None else bf.shape[1],
            0 if bf is None else front.ksub, int(front.word_earlyout))


def _front_opts(front: FrontTables, sub_block: bool) -> bool:
    """Does this launch take K3's options (their own instantiations)?"""
    return bool(front.word_earlyout or (sub_block and front.ksub))


# The sphere-major table the BVH kernel read last, with its scene's tensors
# and their version counters: a caller that passes the same scene on every
# pass (`render`'s passes over `prepare_scene`'s scene) has it built once,
# and a scene changed in place, or another scene, is built again.
_MAJOR: list = []


def _sphere_major(scene: Scene, dev) -> torch.Tensor:
    """(N, 16) float32 sphere-major table of `scene` for K8 and K5 bvh."""
    fields = tuple(getattr(scene, f.name) for f in dataclasses.fields(scene))
    versions = _versions(fields)
    for kept, vers, tab in _MAJOR:
        if vers == versions and all(a is b for a, b in zip(kept, fields)):
            return tab
    with torch.no_grad():
        tab = scene_table(scene).t().contiguous()
    _require(tab, "sphere table", (scene.num_spheres, N_ROWS), torch.float32, dev)
    if versions is not None:
        _MAJOR[:] = [(fields, versions, tab)]
    return tab


def _brute_scan(scene: Scene, dev) -> torch.Tensor:
    """The sphere table the brute scan's kernel (chunked, any size) takes."""
    tab = scene_table(scene)
    _require(tab, "sphere table", (N_ROWS, scene.num_spheres), torch.float32, dev)
    return tab


def _launch(origin, direction, time, scene, seed, max_depth, t_min, front, zero_draws, bvh,
            record: bool, record_miss: bool = False, inject_bug: str | None = None):
    """Check the inputs and launch the kernel `trace_paths` describes (or,
    with `record`, K5 over the same closest hit; with `record_miss`, the
    forward kernel that records the miss planes) on CUDA tensors:
    (radiance [R, 3] or (radiance, mdir, mthr), residual planes
    [D, R_pad] or None)."""
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"the megakernel runs on cuda or cpu tensors, not {dev}")
    from raytracingproject_tpu_torch.ops.cuda import build

    if inject_bug is not None and (record or record_miss or front is not None
                                   or bvh is not None):
        raise ValueError(f"inject_bug={inject_bug!r} runs on the plain version and, on the "
                         "card, on the forward brute scan alone")
    n = origin.shape[0]
    _require(origin, "origin", (n, 3), torch.float32, dev)
    _require(direction, "direction", (n, 3), torch.float32, dev)
    _require(time, "time", (n,), torch.float32, dev)
    _check_seed(seed, max_depth)
    r_pad = -(-n // TILE) * TILE
    planes = _res_planes(max_depth, r_pad, dev) if record else None
    miss = None
    if record_miss:
        miss = tuple(torch.empty((r_pad, 3), dtype=torch.float32, device=dev) for _ in range(2))
    # the forward entries take the miss planes (or nulls), the recording ones the residuals
    tail_args = ([x.data_ptr() for x in planes] if record
                 else [None, None] if miss is None else [x.data_ptr() for x in miss])
    if n == 0:
        out = origin.new_zeros((0, 3))
        return ((out, out, out) if record_miss else out), planes
    lib = build.load_library()
    o, d, t = _pad_rays(origin, r_pad), _pad_rays(direction, r_pad), _pad_rays(time, r_pad)
    out = torch.empty((r_pad, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = lambda x: x.data_ptr()  # noqa: E731
    rays = (p(o), p(d), p(t), p(out), r_pad)
    tail = (int(seed), max_depth, t_min, int(zero_draws), *tail_args, stream)
    if isinstance(front, FrontTablesHBM):
        n_front = front.ff.shape[1]
        _require(front.sph, "front.sph", (n_front * BLOCK, N_ROWS), torch.float32, dev)
        _require(front.ff, "front.ff", (8, n_front), torch.float32, dev)
        _require(front.fi, "front.fi", (1, n_front), torch.int32, dev)
        _require(front.wf, "front.wf", (8, front.wf.shape[1]), torch.float32, dev)
        _require(front.sf, "front.sf", (8, front.sf.shape[1]), torch.float32, dev)
        n_bf = 0
        if front.bf is not None:
            n_bf = front.bf.shape[1]
            _require(front.bf, "front.bf", (8, n_front * front.ksub), torch.float32, dev)
        key = "front_hbm"
        err = lib.rtp_trace_front_hbm(
            *rays, p(front.sph), p(front.ff), p(front.fi), n_front, p(front.wf),
            front.wf.shape[1], p(front.sf), front.sf.shape[1],
            None if front.bf is None else p(front.bf), n_bf, front.ksub,
            int(front.word_earlyout), *tail)
    elif front is not None:
        sub_block = not record
        _require_front(front, dev, sub_block)
        fn, key = ((lib.rtp_record_front, "record_front") if record
                   else (lib.rtp_trace_front, "front"))
        if _front_opts(front, sub_block):
            key = f"{key}_opts"
        err = fn(*rays, *_front_args(front, sub_block), *tail)
    elif bvh is not None:
        tables = bvh_tables(bvh, dev)
        tab = _sphere_major(scene, dev)
        fn, key = (lib.rtp_record_bvh, "record_bvh") if record else (lib.rtp_trace_bvh, "bvh")
        err = fn(*rays, p(tab), tab.shape[0], p(tables.nodes), tables.nodes.shape[0], *tail)
    elif inject_bug is not None:
        tab = _brute_scan(scene, dev)
        key = f"brute_chunked_{inject_bug}"
        err = lib.rtp_trace_brute_chunked_schlick3(*rays, p(tab), tab.shape[1], *tail[:4],
                                                   stream)
    else:
        tab = _brute_scan(scene, dev)
        key = "record_brute_chunked" if record else "brute_chunked"
        err = getattr(lib, f"rtp_{'record' if record else 'trace'}_brute_chunked")(
            *rays, p(tab), tab.shape[1], *tail)
    if record_miss:
        key = f"{key}_miss"
    build.check(err, f"{key} megakernel launch")
    LAUNCHES[key] += 1
    if record_miss:
        return (out[:n], miss[0][:n], miss[1][:n]), planes
    return out[:n], planes


def segment_call(state: torch.Tensor, slot: torch.Tensor, scene: Scene | None, seed: int,
                 bounce0: int, depth: int, t_min: float = T_MIN,
                 front: FrontTables | None = None, zero_draws: bool = False,
                 record_miss: bool = False, record: bool = False):
    """K6, one resumable depth segment (`_segment_call` of the JAX package,
    megakernel.py:1759): `depth` bounces of the bounce loop from the
    carried `state` ([STATE_ROWS, R] float32, with `record_miss`
    STATE_ROWS + MISS_ROWS; see `segment_twin`) of the rays whose
    monolithic slots are `slot` ([R] int32), starting at global bounce
    `bounce0`. The closest hit is `front`'s (a FrontTables: K3's culling,
    with its `word_earlyout`; its sub-block boxes are not used, as in the
    JAX package's segment kernel) or the brute scan over `scene` (staged
    in chunks, any size). Returns the state after the segment and, with
    `record`, the residual planes (idx, ndx, ndy, ndz, refl) [depth, R].
    R must be a multiple of TILE; padding rays are dead (alive 0).

    Random numbers: the JAX pipelines reseed each phase
    (seed ^ s * 0x9E3779B1) because the TPU's generator is keyed by tile
    position. Here a ray draws with Philox keyed by (seed, its monolithic
    slot, its global bounce), so a trace cut into segments follows the
    monolithic kernel's paths exactly, with real draws too.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    `segment_twin`."""
    if state.device.type == "cpu":
        return segment_twin(state, slot, scene, seed, bounce0, depth, t_min, front,
                            zero_draws, record_miss, record)
    _segment_front(front)
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"the segment kernel runs on cuda or cpu tensors, not {dev}")
    from raytracingproject_tpu_torch.ops.cuda import build

    rows = _state_rows(state, record_miss, record)
    n = state.shape[1]
    if n == 0 or n % TILE:
        raise ValueError(f"segment of {n} rays: the ray count must be a positive multiple "
                         f"of {TILE}")
    _require(state, "state", (rows, n), torch.float32, dev)
    _require(slot, "slot", (n,), torch.int32, dev)
    _check_seed(seed, depth)
    if bounce0 < 0:
        raise ValueError(f"bounce0 {bounce0} < 0")
    lib = build.load_library()
    out = torch.empty_like(state)
    planes = _res_planes(depth, n, dev) if record else None
    res = [x.data_ptr() for x in planes] if record else [None] * 5
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (state.data_ptr(), out.data_ptr(), slot.data_ptr(), n)
    tail = (int(seed), bounce0, depth, t_min, int(zero_draws), int(record_miss), *res, stream)
    if front is not None:
        scan = "front_opts" if _front_opts(front, False) else "front"
        _require_front(front, dev, sub_block=False, extra=SEGMENT_LIST_BYTES)  # the live list
        err = lib.rtp_segment_front(*head, *_front_args(front, False), *tail)
    else:
        tab, scan = _brute_scan(scene, dev), "brute_chunked"
        err = lib.rtp_segment_brute_chunked(*head, tab.data_ptr(), tab.shape[1], *tail)
    key = f"segment_{'record_' if record else 'miss_' if record_miss else ''}{scan}"
    build.check(err, f"{key} launch")
    LAUNCHES[key] += 1
    return (out, planes) if record else out


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
