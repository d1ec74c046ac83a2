"""The depth-tail pipelines: a trace cut into depth segments of K6, with
the live rays packed to the front between segments (counterpart of
`pallas_trace_paths_twophase`, `pallas_trace_record_twophase` and
`pallas_trace_paths_segmented`, raytracingproject_tpu/ops/pallas/
megakernel.py:1834-2179).

- `trace_paths_twophase`: a full-frame prefix of `cuts[0]` bounces, one
  alive-first compaction, then the tail on packed rays (more cuts, more
  compactions);
- `trace_record_twophase`: the same with one cut, recording the residuals
  of each phase for `grad.replay.replay_radiance_twophase`;
- `trace_paths_segmented`: a compaction after every `seg_len` bounces.

The segments are K6 (`megakernel.segment_call`); the compaction between
them is plain PyTorch (`cumsum`, `searchsorted`, `index_select`), as it
was XLA and not Pallas in the JAX package.

The carried state is ray-minor ([planes, R]): a warp's loads and stores of
one plane coalesce, and one `index_select` along dim 1 packs every plane.
A ray keeps its slot in the monolithic trace (`slot`) and draws its random
numbers by (seed, slot, global bounce), so with either closest hit a
pipeline follows the monolithic kernel's paths exactly, over the brute
scan and over the front alike (both cull and reduce per ray, so the
packing of the warps moves no value).

The compaction packs rows of ROW_WIDTH consecutive rays: a row is live
when any of its rays is. The JAX package packs 128-ray lane rows because
element gathers were serial on the TPU; on the card a gather of a few
[k, R] planes is cheap, and the bounce loop exits per warp of 32 rays, so
a 32-ray row moves whole warps and leaves each warp's work as it was.
Rows of one ray pack the survivors into full warps (PERF.md, depth tail).

Every pipeline takes `segment=` (default the kernel wrapper, which runs
the plain version on CPU tensors), and two-phase tracing also `tracer=`,
the monolithic trace it falls back to; the `*_twin` functions pass the
plain versions on any device.
"""

from __future__ import annotations

from typing import Callable

import torch

from raytracingproject_tpu_torch.config import T_MIN
from raytracingproject_tpu_torch.ops.cuda.megakernel import (
    MISS_ROWS, ST_ALIVE, ST_MDIR, ST_MTHR, ST_RAD, STATE_ROWS, TILE, FrontTablesHBM,
    decode_residuals, segment_call, segment_twin, trace_paths, trace_paths_twin,
)
from raytracingproject_tpu_torch.scene import Scene


# Rays per row of the alive-first compaction: every ray on its own. Read by
# alive_first_perm; take_ray_rows and grad.replay.replay_radiance_twophase
# take the width from the length of the permutation they are given. On an
# H100 80GB HBM3 at 700 W (bench shape, cut at 4) one-ray rows took the brute
# two-phase trace to 2.765 ms from 4.234 ms with 32-ray rows, the front's to
# 1.233 from 1.155 ms, at about the same compaction time
# (`python3 chip_smoke.py --row-widths`; PERF.md, depth tail).
ROW_WIDTH = 1


def alive_first_perm(alive: torch.Tensor):
    """Stable alive-first packing permutation over rows of ROW_WIDTH rays
    (`_alive_first_perm` of the JAX package, whose rows are 128 rays).

    `alive` is [Rp] (0/1 or bool), Rp a multiple of ROW_WIDTH. Returns
    (src, dest, n_alive): src[j] is the row placed at packed row j, dest[i]
    the packed position of row i (its inverse, computed elementwise),
    n_alive the number of rows holding any live ray (a 0-dim tensor on
    `alive`'s device: no host read). Two cumsums and two binary searches."""
    rows = (alive.reshape(-1, ROW_WIDTH) > 0.5).any(dim=1)
    n = rows.shape[0]
    alive_i = rows.to(torch.int32)
    cum = torch.cumsum(alive_i, 0, dtype=torch.int32)
    n_alive = cum[-1]
    cumd = torch.cumsum(1 - alive_i, 0, dtype=torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=alive.device)
    src_live = torch.searchsorted(cum, pos + 1).to(torch.int32)
    src_dead = torch.searchsorted(cumd, pos + 1 - n_alive).to(torch.int32)
    src = torch.where(pos < n_alive, src_live, src_dead)
    dest = torch.where(alive_i > 0, cum - 1, n_alive + cumd - 1)
    return src, dest, n_alive


def take_ray_rows(x: torch.Tensor, rows_idx: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Permute the ray axis `dim` of `x` by row indices (`_take_ray_rows` of
    the JAX package): the axis is cut into len(rows_idx) rows of equal
    width, which move as one. Differentiable in `x`."""
    dim = dim % x.dim()
    shape = x.shape
    n_rows = rows_idx.shape[0]
    if n_rows == 0 or shape[dim] % n_rows:
        raise ValueError(f"{shape[dim]} rays do not split into {n_rows} rows")
    split = shape[:dim] + (n_rows, shape[dim] // n_rows) + shape[dim + 1:]
    return x.reshape(split).index_select(dim, rows_idx.long()).reshape(shape)


def initial_state(origin: torch.Tensor, direction: torch.Tensor, time: torch.Tensor,
                  record_miss: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(state [STATE_ROWS (+ MISS_ROWS), Rp], slot [Rp] int32) of camera
    rays before their first bounce, Rp = R padded to a TILE multiple. The
    padding rays are dead and parked where every test misses (o = 1e18,
    d = (1, 1, 1)), with zero throughput."""
    n = origin.shape[0]
    r_pad = max(-(-n // TILE), 1) * TILE
    dev = origin.device
    rows = STATE_ROWS + (MISS_ROWS if record_miss else 0)
    state = torch.zeros((rows, r_pad), dtype=torch.float32, device=dev)
    state[0:3] = 1e18
    state[3:6] = 1.0
    state[0:3, :n] = origin.t()
    state[3:6, :n] = direction.t()
    state[6, :n] = time
    state[7:10, :n] = 1.0
    state[ST_ALIVE, :n] = 1.0
    return state, torch.arange(r_pad, dtype=torch.int32, device=dev)


def _check_bounds(bounds) -> None:
    if not all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:])):
        raise ValueError(f"depth cuts {bounds[1:-1]} must be strictly increasing and below "
                         f"max_depth {bounds[-1]}, above 0")


def _pipeline(origin, direction, time, scene, seed, bounds, t_min, front, zero_draws,
              record_miss, segment, record=False):
    """The segments [bounds[s], bounds[s + 1]) with a compaction between
    each two. Returns the radiance [R, 3] back in the original ray order
    (with `record_miss`, and the miss planes); with `record`, (radiance,
    each segment's residual planes, each compaction's (src, dest,
    n_alive))."""
    _check_bounds(bounds)
    state, slot = initial_state(origin, direction, time, record_miss)
    # dest_of_orig[i]: the packed position of original row i
    dest_of_orig = torch.arange(state.shape[1] // ROW_WIDTH, dtype=torch.int32,
                                device=state.device)
    planes, perms = [], []
    for b0, b1 in zip(bounds, bounds[1:]):
        state = segment(state, slot, scene, seed, b0, b1 - b0, t_min, front, zero_draws,
                        record_miss, record)
        if record:
            state, res = state
            planes.append(res)
        if b1 < bounds[-1]:
            perm = alive_first_perm(state[ST_ALIVE])
            perms.append(perm)
            src, dest, _ = perm
            state = take_ray_rows(state, src, dim=1)
            slot = take_ray_rows(slot, src)
            dest_of_orig = dest[dest_of_orig.long()]
    n = origin.shape[0]
    back = take_ray_rows(state, dest_of_orig, dim=1)
    rad = back[ST_RAD, :n].t().contiguous()
    if record:
        return rad, planes, perms
    if record_miss:
        return rad, back[ST_MDIR, :n].t().contiguous(), back[ST_MTHR, :n].t().contiguous()
    return rad


def trace_paths_twophase(origin: torch.Tensor, direction: torch.Tensor, time: torch.Tensor,
                         scene: Scene | None, seed: int, max_depth: int, cuts: tuple = (4,),
                         t_min: float = T_MIN, front=None, zero_draws: bool = False,
                         record_miss: bool = False, segment: Callable = segment_call,
                         tracer: Callable = trace_paths):
    """Radiance [R, 3] (with `record_miss`, and the miss planes: see
    `trace_paths`) by the two-phase pipeline: bounces [0, cuts[0]) for
    every ray, a compaction, then each next span of `(0, *cuts,
    max_depth)` on the packed rays (`pallas_trace_paths_twophase`).

    Equal to `trace_paths` for the same seed (see the module docstring). A
    FrontTablesHBM has no segment kernel: as in the JAX package, the trace
    is then the monolithic one, `tracer` (K7)."""
    if isinstance(front, FrontTablesHBM):
        return tracer(origin, direction, time, scene, seed, max_depth, t_min, front=front,
                      zero_draws=zero_draws, record_miss=record_miss)
    return _pipeline(origin, direction, time, scene, seed, (0, *cuts, max_depth), t_min,
                     front, zero_draws, record_miss, segment)


def trace_paths_segmented(origin: torch.Tensor, direction: torch.Tensor, time: torch.Tensor,
                          scene: Scene | None, seed: int, max_depth: int, seg_len: int = 8,
                          t_min: float = T_MIN, front=None, zero_draws: bool = False,
                          record_miss: bool = False, segment: Callable = segment_call):
    """Radiance [R, 3] (with `record_miss`, and the miss planes) by depth
    segments of `seg_len` bounces with a compaction between every two
    (`pallas_trace_paths_segmented`, which packs single rays with an
    argsort; here the rows of `alive_first_perm`). Raises for a
    FrontTablesHBM, which K6 does not take."""
    if isinstance(front, FrontTablesHBM):
        raise ValueError("segmented tracing runs K6, which takes the brute scan or a "
                         "FrontTables, not a FrontTablesHBM (nor does the JAX package's): "
                         "render large scenes without depth_segment")
    if seg_len <= 0:
        raise ValueError(f"seg_len {seg_len} must be positive")
    bounds = (*range(0, max_depth, seg_len), max_depth)
    return _pipeline(origin, direction, time, scene, seed, bounds, t_min, front, zero_draws,
                     record_miss, segment)


def trace_record_twophase(origin: torch.Tensor, direction: torch.Tensor, time: torch.Tensor,
                          scene: Scene | None, seed: int, max_depth: int, cut: int = 4,
                          t_min: float = T_MIN, front=None, zero_draws: bool = False,
                          segment: Callable = segment_call):
    """The two-phase trace with one cut, recording the residuals of each
    phase (`pallas_trace_record_twophase`). Returns
    (radiance [R, 3], res1, res2, src, dest, n_alive):

    - res1: grad.replay.PathResidualsP [cut, Rp] in the original ray order
      (Rp = R padded to a TILE multiple; padding rays are DEAD);
    - res2: PathResidualsP [max_depth - cut, Rp] in packed order: rows
      alive after the cut first, rows from n_alive on all DEAD;
    - src, dest: the row permutation and its inverse ([Rp / ROW_WIDTH]
      int32);
    - n_alive: the live row count (0-dim int32 tensor, not read on the
      host).

    idx are spheres of `scene`'s order (leaf order with `front`). With a
    FrontTables, the padded table's columns are mapped by `front.remap`."""
    from raytracingproject_tpu_torch.grad.replay import PathResidualsP

    if isinstance(front, FrontTablesHBM):
        raise ValueError("trace_record_twophase takes no FrontTablesHBM (nor does the JAX "
                         "package's pallas_trace_record_twophase)")

    def planar(planes):
        res = decode_residuals(planes, planes[0].shape[1], front)
        return PathResidualsP(idx=res.idx, ndx=planes[1], ndy=planes[2], ndz=planes[3],
                              refl=res.refl)

    rad, (planes1, planes2), [(src, dest, n_alive)] = _pipeline(
        origin, direction, time, scene, seed, (0, cut, max_depth), t_min, front, zero_draws,
        False, segment, record=True)
    return rad, planar(planes1), planar(planes2), src, dest, n_alive


def trace_paths_twophase_twin(*args, **kwargs):
    """`trace_paths_twophase` through the plain versions (K6's and, for a
    FrontTablesHBM, the monolithic kernel's) on any device."""
    return trace_paths_twophase(*args, segment=segment_twin, tracer=trace_paths_twin, **kwargs)


def trace_paths_segmented_twin(*args, **kwargs):
    """`trace_paths_segmented` through K6's plain version on any device."""
    return trace_paths_segmented(*args, segment=segment_twin, **kwargs)


def trace_record_twophase_twin(*args, **kwargs):
    """`trace_record_twophase` through K6's plain version on any device."""
    return trace_record_twophase(*args, segment=segment_twin, **kwargs)
