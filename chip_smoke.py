#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --row-widths   # only the measurement behind depth_tail.ROW_WIDTH

Builds the CUDA kernels from csrc/ with nvcc (one process per source, all
started together), holds each against its plain PyTorch version on the
card, and drives the port's main paths, each checked to have gone
through its kernels:

- serving: the cover scene through `render_image`, `render` and the CLI
  at the reference configuration (400x225, 30 spp, depth 50), on the
  forward megakernel (K1 with K2 or K3);
- training: `grad.fast.make_fast_train_step` on the cover scene at
  400x225, 2 spp, depth 50 (geometry + albedo on the brute recording
  kernel, materials on the front one), the recording megakernel (K5)
  forward and the path-replay backward, plus a descent check on the
  three-sphere scene. K5 is held against its plain version both at the
  bench shape and on one step's rays at the step's own shapes;
- the oracle: `render_image` and `render` with
  `RenderSettings(use_megakernel=False, use_pallas=True)` at the same
  reference configuration, the bounce loop in PyTorch with the fused
  closest hit (K4) once a bounce; K4 against its plain version (bit for
  bit) and against `ops.intersect.closest_hit`, `use_pallas` on against
  off, the BVH walk against the brute scan; and `grad.make_train_step` (autograd
  through the oracle) at 200 px wide, depth 8, on the cover and the
  three-sphere scene (a CPU scene and no device given: the step runs on
  the card), its geometry gradient against central differences of the
  loss, a descent check, and the oracle's radiance and gradients against
  the path replay of its own record in float64 and float32.

- large scenes: `render` with `RenderSettings(use_bvh=True)` on
  `make_random_scene(50000, seed=3)` at 400x225, 30 spp, depth 50, whose
  tables pass the shared-memory budget, on the BVH walk (K8), against the
  same pass loop on the global-memory front (K7);
  `make_fast_train_step(bvh=...)` on the same scene at 2 spp, depth 50, on
  the BVH-walking recording kernel (K5 bvh); the BVH walk (K8) through
  `render_pass(bvh=)`; and the brute scan (`use_bvh=False` on 5,000
  spheres; the chunked kernel runs every brute scan, the cover scene's
  too). Each is held against its plain version on 50,000 spheres, on
  8,192 rays and then at the shapes the paths give it (the 90,000 rays of
  one pass at depth 16; K5 bvh also on one train step's 180,000 rays at
  depth 50); K7, K8 and the chunked brute scan against each other, and
  their first hits against K4 on the 90,000 primary rays of a pass. K7
  (each of its three fronts), K8's three instantiations and the chunked
  scan's seven are held bit-equal to their plain versions (`torch.equal`)
  at their paths' shapes, the chunked scan also on 2,000 and 3,000
  spheres and on its edge cases: blocks with 1, 33, 129 and 256 live rays,
  and a scene where every hit is an exact tie; their registers (K8's
  stack frame too) and blocks per SM are printed, with the chunked scan's
  live rays a block-bounce and the SM load behind its time; K8's bound
  reads its ordered walk's count (the miss-link walk's, which PRs before
  the ordered walk read, is printed beside it); the 5,000-sphere geometry
  train step (the chunked recording kernel) is timed.

- the depth tail: `render` with `RenderSettings(two_phase=4)` and
  `depth_segment=8` and with a sky texture (K1's record_miss; on the
  two-phase route too), at the reference configuration, and
  `make_fast_train_step(two_phase=4)` at 2 spp, depth 50, through K6, the
  resumable depth segment (brute, chunked brute and front, each plain,
  with miss planes and recording); each K6 instantiation and each
  record_miss kernel held against its plain version at its path's shapes
  (a pass's 90,112 rays cut at 4 then 12 more bounces; the recording
  segments also on a train step's 180,000 rays at depth 50) and on its
  path's scene (the chunked scan on 5,000 spheres, five staged chunks;
  K7 with record_miss on 50,000, past 576 subtrees; the chunked and front
  segments bit-equal), the pipelines against the monolithic kernels
  (Philox draws: bit-equal, and so are the frames), the two-phase
  gradients against the monolithic ones.

- the probes, right after the build: each probe kernel of csrc/probes.cu
  (tools/'s FMA peak, mixed closest-hit peak, kfront and kexp) bit-equal
  to its plain version, the nine closest-hit probes' registers and blocks
  per SM, the SASS instructions a pair of the mixed peak and of kfront's
  two probes, then their own main path, what
  `python -m raytracingproject_tpu_torch.probes.roofline` (and `.kfront`,
  `.kexp`, on the cover scene and on make_random_scene(2000, seed=3))
  runs: the card's FFMA rate and mixed sphere-test peak, which every
  bound below reads.

- K3 on the largest fronts: `render`'s fronts of 2,000 and 3,000
  spheres (K3's route still), the twelve front instantiations' registers,
  stack frame and blocks per SM on the cover and 3,000-sphere fronts, K3,
  its record_miss kind and K5's front core bit-equal to their plain
  versions on a pass over each (the cover scene's at the bench shape), and
  K3's time on that pass and at depth 0 (its staging).

- K3's options and K1's planted fault: `front_tables(sub_block=,
  word_earlyout=)` on the cover and 2,000-sphere fronts, each option
  instantiation (forward, record_miss, K5, K6's three tails) bit-equal
  to plain K3's and held against its plain version, driven through
  `render_pass` and `make_fast_train_step`; `<CHUNKED, SCHLICK3>` against
  its plain version and the per-material-region statistic on the card
  (clean under z = 5, the planted fault past it).

- geometry training, the silhouette estimator and the session (G1-G3,
  E1, S1): the cover scene's FrontRefresher with two spheres moved and a
  radius changed, `refresh_device` on the card bit-equal to the host
  `refresh`; K5's front core over the refreshed tables bit-equal to its
  plain version on one geometry step's 180,000 rays at depth 50, its
  winners against the chunked scan's; `make_fast_geometry_train_step`
  (refresher and explicit front) equal to the brute `make_fast_train_step`
  from the same seed, through K5's front core alone, timed in turns with
  it; the cover-scale silhouette recovery of tests/test_edge_grad.py
  (`make_soft_train_step`, no kernel) over five seed pairs, held to that
  test's bounds on the median; `RendererSession` at its defaults for a
  3-second loop, through K3, its frames per second.

- sharding and the wavefront (P1, W1): a 1x1 mesh of an NCCL world of one
  (`parallel.make_mesh()`), `render_sharded` with the megakernel and the
  front at the reference configuration through K3 alone, its mean within
  5% of `render`'s; `make_sharded_train_step` at 400x225, 2 spp, depth 50
  (brute K5, front K5, two-phase K6 recording) and
  `make_sharded_soft_train_step` at E1's size, each step's loss and
  gradients within 1e-5 of the unsharded step's on the same rays and seed,
  both timed in turns; `wavefront.render_wavefront_image` at the
  reference configuration, its closest hit K4 once an iteration, its
  host reads counted (one an iteration, the rest once a frame), its mean
  within 5% of the megakernel's, two runs from one seed bit-equal, K4
  held against its plain version on the wavefront's own pools (mid-run,
  and with dead slots), Mrays/s at the bench shape beside `render`'s, the
  plain `closest_hit` in the same loop once for comparison, and an
  iteration's refill, bounce, K4 and accumulation times.

It then times kernels and plain versions at the bench shape (400x225,
4 spp, depth 16; K4 and the large-scene kernels at one pass of 90,000
rays, the latter also at the bench shape alone) and the train steps, and
works out each kernel's bound from the tests this run's rays need (counted
in the plain versions), the FFMA rate it measured (one counted operation
is one instruction under -fmad=false) and the data sheet's memory rate,
and each closest hit's mixed share (sphere tests a second over the
measured mixed peak; every kernel, the mixed peak included, takes roots
only where a discriminant is positive). Any failed check raises and the
script exits non-zero. Without a CUDA device it exits 1 and prints no result.

The second-to-last line of stdout is a JSON object with one entry per
kernel; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "raytracingproject_tpu_torch/csrc/megakernel.cu"
K4_SOURCE = "raytracingproject_tpu_torch/csrc/closest_hit.cu"
REPLACES = {
    "closest_hit": "raytracingproject_tpu/ops/pallas/trace.py:136",
    "front": "raytracingproject_tpu/ops/pallas/megakernel.py:869",
    "record_front": "raytracingproject_tpu/ops/pallas/megakernel.py:1637",
    "brute_chunked": "raytracingproject_tpu/ops/pallas/megakernel.py:832",
    "record_brute_chunked": "raytracingproject_tpu/ops/pallas/megakernel.py:1637",
    "bvh": "raytracingproject_tpu/ops/pallas/megakernel.py:850",
    "record_bvh": "raytracingproject_tpu/ops/pallas/megakernel.py:1637",
    "front_hbm": "raytracingproject_tpu/ops/pallas/megakernel.py:2500",
}
# record_miss: the same bodies with their miss planes (the pallas_call at :1488)
REPLACES.update({f"{k}_miss": REPLACES[k]
                 for k in ("front", "brute_chunked", "bvh", "front_hbm")})
# K6 (plain, with the miss planes, recording) over each scan
SEGMENT_KEYS = ("segment_brute_chunked", "segment_miss_brute_chunked",
                "segment_record_brute_chunked", "segment_front", "segment_miss_front",
                "segment_record_front")
# K6: _segment_call's pallas_call, over the brute or the front body
REPLACES.update({k: "raytracingproject_tpu/ops/pallas/megakernel.py:1818" for k in SEGMENT_KEYS})
# K3's options (sub_block, word_earlyout): the forward body :869 with its
# options (:464-527), K5's front core :1578 and K6's front segment :1737 with
# word_earlyout; K1's planted fault inject_bug="schlick3" (:683-688) on the
# brute body :832
OPTION_KEYS = ("front_opts", "front_opts_miss", "record_front_opts", "segment_front_opts",
               "segment_miss_front_opts", "segment_record_front_opts")
REPLACES.update({"front_opts": REPLACES["front"], "front_opts_miss": REPLACES["front"],
                 "record_front_opts": "raytracingproject_tpu/ops/pallas/megakernel.py:1637",
                 "segment_front_opts": REPLACES["segment_front"],
                 "segment_miss_front_opts": REPLACES["segment_front"],
                 "segment_record_front_opts": REPLACES["segment_front"],
                 "brute_chunked_schlick3": REPLACES["brute_chunked"]})
# The probe kernels (csrc/probes.cu) and the pallas_call each replaces
PROBE_SOURCE = "raytracingproject_tpu_torch/csrc/probes.cu"
PROBE_REPLACES = {"fma": "tools/roofline.py:92", "mixed": "tools/roofline.py:160",
                  "kfront_front": "tools/kfront.py:191", "kfront_brute": "tools/kfront.py:210",
                  **{f"kexp_{v}": "tools/kexp.py:106" for v in
                     ("full", "full_u4", "full_u8", "slim", "slim_u4", "slim_u8")}}
MODES = {1: "FRONT", 2: "CHUNKED", 3: "BVH", 4: "HBM"}
OPTS = {0: "", 1: ", SCHLICK3", 2: ", FRONT_OPTS"}
# The 24 trace_kernel instantiations: 12 front (K3, K5, record_miss, K6's
# three segments, each with and without K3's options), 7 chunked brute
# scans (every brute scan, SCHLICK3 included), 3 BVH walks, 2 K7.
N_INSTANTIATIONS = 24
# The chunked brute scan's six instantiations: (record, record_miss, segment)
CHUNKED_KINDS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 1, 1), (1, 0, 1))
# The twelve front instantiations: (record, record_miss, segment, opt): K3
# (plain and record_miss), K5's front core, K6's three front segments,
# each without and with K3's options
FRONT_KINDS = tuple((rec, miss, seg, opt) for opt in (0, 2) for seg in (0, 1)
                    for rec, miss in ((0, 0), (0, 1), (1, 0)))


def launch_key(label: str) -> str:
    """The launch counter of a path's label: the brute scan's labels of the
    cover scene ("brute", "record_brute", "brute_miss", "segment_brute",
    ...) count the chunked kernel, which runs every brute scan."""
    if "brute" in label and "brute_chunked" not in label:
        return label.replace("brute", "brute_chunked")
    return label


def entry_name(label: str) -> str:
    """The `kernels` entry of a path's label: the kernel that runs it, with
    "_cover" where the chunked kernel ran the cover scene (its other
    entries are timed on 5,000 or 50,000 spheres)."""
    key = launch_key(label)
    return f"megakernel_{key}" + ("_cover" if key != label else "")
COVER_CAMERA = dict(aspect_ratio=16.0 / 9.0, image_width=400, vfov=20.0,
                    lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                    defocus_angle=0.6, focus_dist=10.0)
N_CMP = 65536  # camera rays in the kernel-against-twin comparisons
N_LARGE = 50000  # spheres of the large-scene path: make_random_scene(N_LARGE, seed=3)
N_LARGE_CMP = 8192  # camera rays of the large-scene kernel-against-twin comparisons
CHUNK = 1024  # spheres a chunk of the chunked brute scan stages (csrc/megakernel.cu)
LIVE_PER_BLOCK = (1, 33, 129, 256)  # live rays of the blocks the chunked scan's edge cases run
TRAIN_STEPS = 7  # per full-width configuration: 2 warm-up, 5 timed
# Descent check (three-sphere scene, 128x72, 4 spp, depth 8, albedo only,
# 40 steps): mean loss of the last 5 steps over the first 5 must stay
# below this. Measured 0.218 on an H100 80GB HBM3 at 700 W; the limit
# leaves that run a margin of 1.8x.
DESCENT_RATIO = 0.4
# E1's seed pairs (target render, steps): the pair tests/test_edge_grad.py
# keys its one run with, (0, 7), and the four after it. Whether a single
# run meets that test's bounds depends on its draws (E1 prints every run),
# so E1 holds the bounds to the median over the five.
E1_SEEDS = ((0, 7), (1, 8), (2, 9), (3, 10), (4, 11))
# Float32 gradients of the oracle against the replay of its own record
# (65,536 cover rays, depth 8), relative norm per field. Measured on an
# H100 80GB HBM3 at 700 W: <= 4.4e-6 in all six fields (radius), the
# replay's radiance bit-equal to the oracle's. With the replay's dot
# products as reductions, whose order differs on the card, it was 1e-2 to
# 0.7 in the geometry fields.
GRAD32_TOL = 1e-4

# The card's data-sheet rates (NVIDIA H100 SXM at its full 700 W limit):
# float32 outside the tensor cores, which counts a fused multiply-add as
# two operations, and HBM3. The kernels are built without FMA contraction,
# so each of their operations is one instruction: bounds take as the
# operations rate the larger of the FFMA instruction rate this run
# measures (`RATE`, probes.roofline.fma_peak) and the data sheet's
# PEAK_FP32 / 2 instructions, so that no bound sits below the card's rate.
PEAK_FP32 = 67e12   # operations per second
PEAK_BYTES = 3.35e12  # bytes per second
# This run's measured peaks: "ops", FFMA instructions a second; "pairs",
# sphere tests a second of the brute closest hit (the mixed peak).
RATE = {"ops": None, "pairs": None}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synced_s(fn):
    """(result, seconds) of fn() between two device synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rel_err(a, b) -> float:
    """Relative-norm difference of a against b (float64)."""
    import torch

    a, b = a.double(), b.double()
    return (torch.linalg.norm(a - b) / (torch.linalg.norm(b) + 1e-12)).item()


def hold_record(mk, what: str, o, d, t, scene, front, seed: int, depth: int,
                zero: bool, bvh=None, twin=None, exact: bool = False) -> float:
    """K5 (front with `front`, else bvh with `bvh`, else brute) against its
    plain version on one set of rays: radiance bit-equal to the forward kernel's and
    within 1e-3 of the twin's on >= 99.9% of rays; idx equal on >= 99.9% of
    entries; ndir and refl equal wherever idx is; with `exact` (the brute
    scan, on the chunked kernel) all of it bit-equal. `twin` is the plain version's
    result on these arguments where the caller has it already. Returns the
    max |diff| (radiance against the twin, and ndir where idx is equal)."""
    import torch

    path = "front" if front is not None else "bvh" if bvh is not None else "brute"
    route = dict(front=front, zero_draws=zero, bvh=bvh)
    rad, res = mk.trace_record(o, d, t, scene, seed, depth, **route)
    fwd = mk.trace_paths(o, d, t, scene, seed, depth, **route)
    prad, pres = twin if twin is not None else mk.trace_record_twin(o, d, t, scene, seed,
                                                                    depth, **route)
    torch.cuda.synchronize()
    eq = res.idx == pres.idx
    idx_frac = eq.double().mean().item()
    rad_diff = torch.abs(rad - prad)
    rad_frac = (rad_diff <= 1e-3).all(dim=1).double().mean().item()
    nd_diff = torch.abs(res.ndir - pres.ndir)[eq].max().item()
    refl_ok = torch.equal(res.refl[eq], pres.refl[eq])
    print(f"record_{path} kernel vs twin ({what}, {'zero draws' if zero else 'philox'}, "
          f"{o.shape[0]} rays, depth {depth}): radiance == trace_paths "
          f"{torch.equal(rad, fwd)}, max |rad diff| {rad_diff.max().item():.3e}, idx "
          f"equal {idx_frac:.6f}, max |ndir diff| where idx equal {nd_diff:.3e}, refl "
          f"equal there {refl_ok}")
    check(torch.equal(rad, fwd), f"record_{path} ({what}): radiance bit-equal to trace_paths")
    check(rad_frac >= 0.999, f"record_{path} ({what}): >= 99.9% of rays within 1e-3 of "
          "the twin")
    check(idx_frac >= 0.999, f"record_{path} ({what}): idx equal on >= 99.9% of entries")
    check(nd_diff == 0.0 and refl_ok, f"record_{path} ({what}): ndir, refl equal where "
          "idx is")
    if exact:
        check(torch.equal(rad, prad) and all(torch.equal(a, b) for a, b in zip(res, pres)),
              f"record_{path} ({what}): radiance and residuals bit-equal to the plain version")
    return max(rad_diff.max().item(), nd_diff)


def record_against_twin(mk, scene, front, o, d, t) -> dict:
    """Phase 8: K5 (brute and front) against its plain version at the
    bench shape's front (repack 2), depth 16, zero and Philox draws, both
    (the chunked kernel, K5's front core) bit-equal. Returns the max |diff|
    per path."""
    max_err = {}
    for path in ("brute", "front"):
        f = front if path == "front" else None
        max_err[path] = max(hold_record(mk, "bench shape", o, d, t, scene, f, 2024, 16, zero,
                                        exact=True)
                            for zero in (True, False))
    return max_err


def replay_on_card(mk, scene, front, o, d, t) -> None:
    """Phase 9: the replay of K5's residuals reproduces K5's radiance, and
    the fast radiance's gradients with the kernel forward equal those with
    the twin forward (relative norm 1e-5 per field). The gradient's
    index_add_ sums in no fixed order on the card, which alone moves a
    field made of cancelling terms (ior) by up to ~1e-4 between two runs of
    the same forward; the comparison runs with PyTorch's deterministic
    algorithms on, so that it sees the forwards alone, and prints that
    spread beside it."""
    import torch

    from raytracingproject_tpu_torch.grad import (
        SceneParams, extract_params, make_fast_radiance, replay_radiance,
    )

    w = torch.rand((o.shape[0], 3), device=o.device,
                   generator=torch.Generator(device=o.device).manual_seed(9))

    def grads(f, tracer, deterministic):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        try:
            pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
            r = make_fast_radiance(scene, 16, front=f, tracer=tracer)(pp, o, d, t, 77)
            return torch.autograd.grad((r * w).sum(), list(pp))
        finally:
            torch.use_deterministic_algorithms(False)

    def rel(a, b):
        return {n: rel_err(x, y) for n, x, y in zip(SceneParams._fields, a, b)}

    def fmt(errs):
        return ", ".join(f"{n} {v:.2e}" for n, v in errs.items())

    for path in ("brute", "front"):
        f = front if path == "front" else None
        rad, res = mk.trace_record(o, d, t, scene, 77, 16, front=f)
        with torch.no_grad():
            rp = replay_radiance(extract_params(scene), scene, o, d, t, res)
        frac = (torch.abs(rp - rad).max(dim=1).values <= 2e-5).double().mean().item()
        spread = rel(grads(f, mk.trace_record, False), grads(f, mk.trace_record, False))
        same = rel(grads(f, mk.trace_record, True), grads(f, mk.trace_record_twin, True))
        print(f"replay ({path} residuals, {o.shape[0]} rays, depth 16): {frac:.6f} of rays "
              f"within 2e-5 of the kernel's radiance; gradient relative errors, kernel vs twin "
              f"forward (deterministic): {fmt(same)}; kernel vs kernel (default, index_add_ "
              f"order): {fmt(spread)}")
        check(frac >= 0.998, f"replay of record_{path} residuals: >= 99.8% within 2e-5")
        check(max(same.values()) <= 1e-5, f"{path}: kernel and twin forward gradients agree")


def ops_rate() -> float:
    """Instructions a second a bound charges: the measured FFMA rate or the
    data sheet's (PEAK_FP32 / 2), whichever is larger."""
    return max(RATE["ops"], PEAK_FP32 / 2)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(milliseconds, what bounds it): the least time the card could take
    for `ops` float32 operations (one instruction each) at `ops_rate()`, on
    `nbytes` bytes moved once."""
    t_ops, t_bytes = 1e3 * ops / ops_rate(), 1e3 * nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def test_ops(counts: dict) -> float:
    """Operations a bound charges for the tests in `counts`: every ray-sphere
    pair ("pairs") to the sign of its discriminant, the roots of those
    whose discriminant is positive ("roots"), and the box tests ("boxes"),
    at probes/roofline.py's counts (one count for the script and the
    probes)."""
    from raytracingproject_tpu_torch.probes import roofline

    return roofline.test_ops(counts["pairs"], counts["roots"], counts.get("boxes", 0))


YARDSTICKS = {"miss-link": "the miss-link walk's count",
              "unclamped": "the count unclamped by the best t"}


def print_yardstick(key: str, counts: dict, ms: float, bound_of) -> None:
    """Where `counts` (`counting_hit`) also holds the count an earlier bound
    read (K8: the plain version's miss-link walk, not the kernel's ordered
    walk; the fronts: their culling without the clamps by the best t),
    print the bound and share against it, so that shares compare across
    versions; `bound_of(counts)` is the row's (ms, what bounds it)."""
    for name, what in YARDSTICKS.items():
        if f"{name} pairs" in counts:
            old = {k: counts[f"{name} {k}"] for k in ("pairs", "roots", "boxes")}
            o_ms, o_by = bound_of(old)
            print(f"{key}: read against {what} instead, bound {o_ms:.4f} ms by {o_by}, share "
                  f"{o_ms / ms:.3f}")


def megakernel_bound(counts: dict, n_rays: int, depth: int, tab_bytes: int,
                     record: bool) -> tuple[float, str]:
    """Bound of one megakernel call: the counted tests at their
    operations each (`test_ops`), against the rays read (28 B), the table,
    the radiance written (12 B) and, recording, the residual planes
    (17 B a ray and bounce)."""
    ops = test_ops(counts)
    nbytes = n_rays * 40 + tab_bytes + (n_rays * depth * 17 if record else 0)
    return bound(ops, nbytes)


def sass_instructions_per_pair(library: Path, function: str = "") -> dict | None:
    """Instructions of a sphere loop per ray-sphere pair, read from
    `cuobjdump -sass` of `library` (of the functions whose mangled name
    holds `function`): the shortest backward-branch loop that holds the
    square root's MUFU.RSQ, over the number of them in it (the compiler
    may unroll): {"static": its whole body a pair, "no_roots": the body
    less what the forward branches around a MUFU.RSQ skip, the path of a
    pair whose discriminant is not positive}. None where cuobjdump is
    missing or the loop is not found; the figures are printed beside the
    bound and used nowhere."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True).stdout
    best = None
    for func in out.split("Function : ")[1:]:
        if function not in func.split("\n", 1)[0]:
            continue
        code = [(int(m.group(1), 16), m.group(2)) for m in
                re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", func)]
        for k, (addr, text) in enumerate(code):
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if m is None or int(m.group(1), 16) >= addr:
                continue
            top = int(m.group(1), 16)
            body = [(a, t) for a, t in code[:k + 1] if a >= top]
            roots = sum("MUFU.RSQ" in t for _, t in body)
            if not roots or (best is not None and len(body) / roots >= best["static"]):
                continue
            skipped = set()
            for a, t in body:  # forward branches within the body over a square root
                f = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", t)
                if f is None or not a < int(f.group(1), 16) <= addr:
                    continue
                span = {x for x, _ in body if a < x < int(f.group(1), 16)}
                if any("MUFU.RSQ" in u for x, u in body if x in span):
                    skipped.update(span)
            best = {"static": len(body) / roots, "no_roots": (len(body) - len(skipped)) / roots}
    return best


def hold_closest_hit(trace, what: str, o, d, t, scene) -> float:
    """K4 against its plain version, and against ops.intersect.closest_hit,
    on one set of rays. Against the plain version: t and idx bit-equal
    (and so hit mask equal, idx equal, t within 1e-6 relative). Against
    closest_hit (ties aside): hit masks differ on <= 0.01% of rays, idx
    equal on >= 99.9% of common hits, t within 1e-5 relative where idx is.
    Returns max |t diff| against the plain version over the hits."""
    import torch

    from raytracingproject_tpu_torch.ops.intersect import closest_hit

    tab = trace.sphere_table(scene)
    kt, ki = trace.closest_hit_fused(o, d, t, tab)
    torch.cuda.synchronize()
    pt, pi = trace.closest_hit_fused_twin(o, d, t, tab)
    hit = torch.isfinite(pt)
    mask_eq = torch.equal(torch.isfinite(kt), hit)
    idx_frac = (ki == pi)[hit].double().mean().item()
    t_diff = torch.abs(kt - pt)[hit]
    t_ok = bool((t_diff <= 1e-6 * torch.abs(pt)[hit]).all())
    bit_equal = torch.equal(kt, pt) and torch.equal(ki, pi)
    rec = trace.pallas_closest_hit(o, d, t, scene)
    ref = closest_hit(o, d, t, scene.center0, scene.center_delta, scene.radius)
    mask_diff = (rec.hit != ref.hit).double().mean().item()
    both = rec.hit & ref.hit
    same = both & (rec.idx == ref.idx)
    ref_idx_frac = same.double().sum().item() / max(both.double().sum().item(), 1.0)
    ref_rel = (torch.abs(rec.t - ref.t)[same] / torch.abs(ref.t)[same]).max().item()
    n_diff = (torch.abs(rec.normal - ref.normal)[same]).max().item()
    print(f"closest_hit kernel vs twin ({what}, {o.shape[0]} rays x {tab.shape[1]} spheres, "
          f"{int(hit.sum())} hits): bit-equal {bit_equal}, hit mask equal {mask_eq}, idx equal "
          f"{idx_frac:.6f}, max |t diff| {t_diff.max().item():.3e}; vs ops.intersect."
          f"closest_hit: hit masks differ {mask_diff:.2e}, idx equal {ref_idx_frac:.6f}, max "
          f"relative t diff {ref_rel:.3e}, max |normal diff| {n_diff:.3e}, bit-equal t "
          f"{torch.equal(rec.t, ref.t)}")
    check(bool(hit.any()) and not bool(hit.all()), f"closest_hit ({what}): hits and misses")
    check(bit_equal, f"closest_hit ({what}): t and idx bit-equal to the twin's")
    check(mask_eq, f"closest_hit ({what}): hit mask equal to the twin's")
    check(idx_frac >= 0.999, f"closest_hit ({what}): idx equal on >= 99.9% of hits")
    check(t_ok, f"closest_hit ({what}): t within 1e-6 relative of the twin's")
    check(bool((ki[~hit] == 0).all()), f"closest_hit ({what}): idx 0 on a miss")
    check(mask_diff <= 1e-4, f"closest_hit ({what}): hit mask of ops.intersect.closest_hit")
    check(ref_idx_frac >= 0.999 and ref_rel <= 1e-5,
          f"closest_hit ({what}): idx and t of ops.intersect.closest_hit")
    return t_diff.max().item()


def pass_rays(cam, gen):
    """The camera rays of one oracle pass: the image once, row-major."""
    import dataclasses

    return step_rays(dataclasses.replace(cam, samples_per_pixel=1), gen, seed=False)


def closest_hit_against_twin(trace, card: str) -> tuple[float, float, float, tuple[float, str],
                                                        int]:
    """K4 on the card: against its plain version on the cover scene's
    90,000 primary rays of one 400x225 pass, on the same rays after one
    scatter (incoherent) and on 65,536 random rays with random times over
    2,000 random spheres, most of them moving (two shared-memory chunks);
    then both timed at the main path's shape (CUDA events, warm). Returns
    (max |t diff|, ms, plain ms, bound, pair tests)."""
    import torch

    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.materials import draw_scatter
    from raytracingproject_tpu_torch.render import _bounce, _PathState
    from raytracingproject_tpu_torch.scene import make_cover_scene, make_random_scene

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    cover = make_cover_scene(0, device=dev)
    o, d, t = pass_rays(Camera(**COVER_CAMERA, samples_per_pixel=1, max_depth=50), gen)
    err = hold_closest_hit(trace, "cover, primary rays", o, d, t, cover)
    n = o.shape[0]
    state = _PathState(o, d, torch.ones((n, 3), device=dev), torch.zeros((n, 3), device=dev),
                       torch.ones((n,), dtype=torch.bool, device=dev))
    state = _bounce(cover, t, state, draw_scatter(gen, (n,)), use_pallas=True)
    o2, d2 = state.origin.contiguous(), state.direction.contiguous()
    err = max(err, hold_closest_hit(trace, "cover, after one scatter", o2, d2, t, cover))
    rnd = make_random_scene(2000, seed=4, device=dev)
    ro = torch.rand((N_CMP, 3), generator=gen, device=dev) * torch.tensor(
        [22.0, 3.0, 22.0], device=dev) - torch.tensor([11.0, 0.0, 11.0], device=dev)
    rd = torch.randn((N_CMP, 3), generator=gen, device=dev)
    rt = torch.rand((N_CMP,), generator=gen, device=dev)
    err = max(err, hold_closest_hit(trace, "random scene, random rays", ro, rd, rt, rnd))

    tab = trace.sphere_table(cover)

    def kern():
        trace.closest_hit_fused(o, d, t, tab)

    def twin():
        trace.closest_hit_fused_twin(o, d, t, tab)

    kern()
    twin()  # warm both
    ms = cuda_ms(kern, 50)
    plain_ms = cuda_ms(twin, 5)
    ms2 = cuda_ms(lambda: trace.closest_hit_fused(o2, d2, t, tab), 50)
    counts = trace.disc_counts(o, d, t, tab)
    counts2 = trace.disc_counts(o2, d2, t, tab)
    pairs = counts["pairs"]
    b_ms, b_by = bound(test_ops(counts), n * 36 + tab.numel() * 4)
    b2_ms, _ = bound(test_ops(counts2), n * 36 + tab.numel() * 4)
    occ = trace.closest_hit_occupancy()
    print(f"closest_hit: kernel {ms:.4f} ms (primary rays; {ms2:.4f} ms after one scatter) = "
          f"{pairs / ms / 1e6:.1f} G pair tests/s; twin {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
          f"by {b_by}, the kernel reaches {b_ms / ms:.3f} of it (after one scatter {b2_ms:.4f} "
          f"ms, {b2_ms / ms2:.3f}) ({n} rays x {tab.shape[1]} spheres; blocks of "
          f"{occ['threads']} threads, {occ['blocks_per_sm']} a SM) on {card}")
    for what, c in (("primary rays", counts), ("after one scatter", counts2)):
        print(f"closest_hit pairs ({what}): {c['roots']} of {c['pairs']} pairs have a positive "
              f"discriminant ({c['roots'] / c['pairs']:.5f}); {c['warp_roots']} of {c['warps']} "
              f"(warp of 32 rays, sphere) pairs take roots in some lane "
              f"({c['warp_roots'] / c['warps']:.5f})")
    from raytracingproject_tpu_torch.ops.cuda import build

    per_pair = sass_instructions_per_pair(build.library("closest_hit"))
    if per_pair is None:
        print("closest_hit SASS: instructions per pair not measured")
    else:
        print(f"closest_hit SASS: {per_pair['static']:.1f} static instructions per pair in the "
              f"sphere loop (the roots' branch included, which most warps skip), "
              f"{per_pair['no_roots']:.1f} on the path that skips the roots")
    return err, ms, plain_ms, (b_ms, b_by), pairs


@contextlib.contextmanager
def counted_bounces():
    """Counts the bounces `render.ray_color` runs (calls of its `_bounce`)."""
    import importlib

    # the package exports the function `render` under the module's name
    render_mod = importlib.import_module("raytracingproject_tpu_torch.render")
    count = [0]
    original = render_mod._bounce

    def counting(*args, **kwargs):
        count[0] += 1
        return original(*args, **kwargs)

    render_mod._bounce = counting
    try:
        yield count
    finally:
        render_mod._bounce = original


def oracle_frame(trace, card: str, megakernel_mean: float) -> int:
    """The oracle's serving path through the normal entry points at the
    reference configuration with the fused closest hit, then K4 end to end
    (`use_pallas` on against off at 2 spp) and the BVH walk against the
    brute scan. Returns K4's launches on the main path."""
    import torch

    from raytracingproject_tpu_torch import bvh as bvh_mod
    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.color import to_u8
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.ops.intersect import closest_hit
    from raytracingproject_tpu_torch.render import render, render_image
    from raytracingproject_tpu_torch.scene import make_cover_scene

    dev = torch.device("cuda")
    cover = make_cover_scene(0)
    ref_cam = Camera(**COVER_CAMERA, samples_per_pixel=30, max_depth=50)
    fused = RenderSettings(device="cuda", use_megakernel=False, use_pallas=True, use_bvh=False)
    plain = RenderSettings(device="cuda", use_megakernel=False, use_pallas=False, use_bvh=False)
    trace.reset_launches()
    with counted_bounces() as bounces:
        img_u8 = render_image(cover, ref_cam, settings=fused)
        img, frame_s = synced_s(lambda: render(cover, ref_cam, settings=fused))
    launches = trace.LAUNCHES["closest_hit"]
    print(f"oracle main path: render_image + render (use_megakernel=False, use_pallas=True) at "
          f"400x225, 30 spp, depth 50: closest_hit launches {launches}, bounces run "
          f"{bounces[0]}")
    check(launches == bounces[0] == 2 * 30 * 50,
          "K4 ran once for every bounce of the oracle: 2 frames x 30 spp x 50 bounces")
    check(tuple(img.shape) == (225, 400, 3) and torch.isfinite(img).all().item(),
          "oracle image finite, 225x400x3")
    check(torch.equal(img_u8, to_u8(img)), "oracle render_image == to_u8(render) (same seed)")
    mean = img.mean().item()
    print(f"image means: oracle {mean:.5f}, front megakernel {megakernel_mean:.5f}")
    check(abs(mean - megakernel_mean) <= 0.05 * megakernel_mean,
          "oracle mean within 5% of the megakernel render's")
    print(f"seconds per oracle frame (K4, 400x225, 30 spp, depth 50, {bounces[0] // 2} bounces): "
          f"{frame_s:.4f} s on {card}")

    # K4 end to end: equal seeds consume equal draws
    cam2 = Camera(**COVER_CAMERA, samples_per_pixel=2, max_depth=50)
    a = render(cover, cam2, torch.Generator(device=dev).manual_seed(6), fused)
    b, plain_s = synced_s(lambda: render(cover, cam2, torch.Generator(device=dev).manual_seed(6),
                                         plain))
    frac = (torch.abs(a - b) <= 1e-4).all(dim=-1).double().mean().item()
    print(f"oracle, use_pallas on vs off (2 spp, depth 50, equal seeds): {frac:.6f} of pixels "
          f"within 1e-4, bit-equal {torch.equal(a, b)}; the plain-selection render took "
          f"{plain_s:.4f} s")
    check(torch.equal(a, b), "use_pallas on and off give the same image, bit for bit")

    # the BVH walk against the brute scan, one bounce of cover rays
    o, d, t = (x[:N_CMP] for x in pass_rays(ref_cam, torch.Generator(device=dev).manual_seed(8)))
    tree = bvh_mod.build_bvh(cover, leaf_size=4)
    rs = bvh_mod.reorder_scene(cover, tree).to(dev)
    got = bvh_mod.bvh_closest_hit(o, d, t, rs, tree)
    ref = closest_hit(o, d, t, rs.center0, rs.center_delta, rs.radius)
    tie = torch.abs(got.t - ref.t) <= 1e-6 * torch.abs(ref.t)
    ok = ((got.idx == ref.idx) | tie)[ref.hit]
    print(f"bvh_closest_hit vs closest_hit ({N_CMP} cover rays, leaf size 4): hit mask equal "
          f"{torch.equal(got.hit, ref.hit)}, idx equal or t tied {ok.double().mean().item():.6f}")
    check(torch.equal(got.hit, ref.hit) and bool(ok.all()), "the BVH walk equals the brute scan")
    return launches


def oracle_profile(trace, card: str) -> None:
    """Where an oracle pass's time goes: one 400x225 pass of the cover
    scene at 1 spp, depth 50, with K4. Host seconds with the early exit
    (one host read of `alive.any()` a bounce) and without it, then one
    pass under torch.profiler: device events, their time, K4's part, and
    the share of the wall the card was busy."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.render import render_pass
    from raytracingproject_tpu_torch.scene import make_cover_scene

    dev = torch.device("cuda")
    cam = Camera(**COVER_CAMERA, samples_per_pixel=1, max_depth=50)
    scene, derived = make_cover_scene(0, device=dev), cam.derive(torch.float32, dev)
    w, h = cam.image_size()

    def one_pass(early_exit: bool):
        return render_pass(scene, derived, torch.Generator(device=dev).manual_seed(5), width=w,
                           height=h, max_depth=50, spp_chunk=1, early_exit=early_exit,
                           use_pallas=True, use_megakernel=False)

    one_pass(True)  # warm
    with counted_bounces() as bounces:
        one_pass(True)
    secs = {e: statistics.median(synced_s(lambda: one_pass(e))[1] for _ in range(5))  # noqa: B023
            for e in (True, False)}
    print(f"oracle pass (400x225, 1 spp, depth 50, K4): {bounces[0]} bounces with the early "
          f"exit, {secs[True]:.4f} s; all 50 without it, {secs[False]:.4f} s (medians of 5); "
          f"{1e3 * secs[True] / bounces[0]:.3f} and {1e3 * secs[False] / 50:.3f} ms a bounce on "
          f"{card}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = synced_s(lambda: one_pass(True))
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) * 1e-6
    k4 = [e for e in device if "closest_hit_kernel" in e.name]
    if not device or busy == 0.0:
        print("oracle pass profile: no device time in the trace; not measured")
        return
    print(f"oracle pass profile: wall {wall:.4f} s (profiler on), {len(device)} device events = "
          f"{len(device) / bounces[0]:.1f} a bounce, device time {busy:.4f} s, busy share "
          f"{busy / wall:.3f}; closest_hit_kernel {len(k4)} launches, "
          f"{1e3 * sum(e.time_range.elapsed_us() for e in k4) * 1e-6:.3f} ms "
          f"({sum(e.time_range.elapsed_us() for e in k4) * 1e-6 / busy:.3f} of the device time) "
          f"on {card}")


def geometry_probe(name: str, start, cam, spp: int, target, hold: bool) -> None:
    """What one geometry step of the oracle does to the loss, in float64
    on one fixed set of draws: the gradient in (center0, radius) against
    the central difference of the loss along it, and Adam's first step
    (every coordinate by the learning rate against its gradient's sign).

    With `hold` the difference at a step of 1e-8 or 1e-7 must equal the
    gradient's norm within 1e-4 (measured 2.4e-7 on the three-sphere
    scene): the gradient is the derivative of the loss while no path
    changes its branch. The estimator holds no term for the paths that do
    (silhouettes, hit or miss, reflect or refract); at Adam's step of 2e-3
    they outweigh the smooth part, and from the true geometry the loss
    rises, as it does in the JAX package (tests/test_torch_inverse.py).
    The cover scene is printed only: a few near-grazing rays, whose
    radiance goes as the square root of the distance to their silhouette,
    make its difference quotient depend on the step."""
    import dataclasses

    import torch

    from raytracingproject_tpu_torch.grad import SceneParams, extract_params, render_loss

    dev, f64 = torch.device("cuda"), torch.float64
    scene = dataclasses.replace(start.to(dev), **{f: getattr(start, f).to(dev, f64)
                                                  for f in SceneParams._fields})
    w, h = cam.image_size()
    cam64, target = cam.derive(f64, dev), target.to(f64)

    def loss(p):
        return render_loss(p, scene, cam64, torch.Generator(device=dev).manual_seed(7), target,
                           width=w, height=h, max_depth=cam.max_depth, spp_chunk=spp)

    p0 = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
    l0 = loss(p0)
    g = SceneParams(*torch.autograd.grad(l0, list(p0)))
    norm = torch.sqrt((g.center0 ** 2).sum() + (g.radius ** 2).sum())

    def moved(dc, dr):
        with torch.no_grad():
            return loss(p0._replace(center0=p0.center0.detach() + dc,
                                    radius=p0.radius.detach() + dr)).item()

    quotients = {eps: (moved(eps * g.center0 / norm, eps * g.radius / norm)
                       - moved(-eps * g.center0 / norm, -eps * g.radius / norm)) / (2 * eps)
                 for eps in (1e-8, 1e-7, 1e-5, 1e-3)}
    lr = 2e-3
    adam = moved(-lr * torch.sign(g.center0), -lr * torch.sign(g.radius)) - l0.item()
    first_order = -lr * (g.center0.abs().sum() + g.radius.abs().sum()).item()
    print(f"oracle geometry gradient, {name} (float64, fixed draws): |grad| {norm.item():.6e}; "
          "central difference along it at step "
          + ", ".join(f"{eps:.0e}: {q:.6e}" for eps, q in quotients.items())
          + f"; Adam's first step of {lr}: loss {adam:+.3e}, first order predicts "
          f"{first_order:+.3e}")
    if hold:
        dev_rel = min(abs(quotients[eps] - norm.item()) for eps in (1e-8, 1e-7)) / norm.item()
        check(dev_rel <= 1e-4, f"oracle {name}: the geometry gradient is the loss's derivative "
              f"(relative deviation {dev_rel:.2e})")


def oracle_train(trace, card: str) -> None:
    """`grad.make_train_step` (autograd through the oracle, the winner
    selected by the plain scan, not K4) at the widths of bench_grad.py's
    `xla` rows: cover and three-sphere at 200 px, depth 8. Seven steps
    each, held to finite values and to moving exactly the trainable
    fields; `geometry_probe` holds the geometry gradient against the
    loss's derivative and says why these losses need not fall."""
    import dataclasses
    import statistics

    import torch

    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.grad import SceneParams, make_train_step
    from raytracingproject_tpu_torch.render import render
    from raytracingproject_tpu_torch.scene import make_cover_scene, make_three_sphere_scene

    dev = torch.device("cuda")
    trainable = ("albedo", "center0", "radius")
    three = make_three_sphere_scene()
    three_cam = dict(aspect_ratio=16.0 / 9.0, image_width=200, vfov=90.0,
                     lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0))
    configs = {  # true scene, start, camera, spp
        "cover_200px_d8": (make_cover_scene(0), perturbed_cover("geometry"),
                           dict(COVER_CAMERA, image_width=200), 2),
        "three_sphere_200px_d8": (
            three, dataclasses.replace(three, albedo=torch.full_like(three.albedo, 0.5)),
            three_cam, 4),
    }
    trace.reset_launches()
    for name, (true, start, cam_kw, spp) in configs.items():
        cam = Camera(**cam_kw, samples_per_pixel=spp, max_depth=8)
        target = render(true, dataclasses.replace(cam, samples_per_pixel=16),
                        torch.Generator(device=dev).manual_seed(5), RenderSettings(device="cuda"))
        # a scene built on the CPU and no device asked for: the step runs on the card
        params, opt, step = make_train_step(start, cam, spp=spp, learning_rate=2e-3,
                                            trainable=trainable,
                                            generator=torch.Generator(device=dev).manual_seed(3))
        check(params.albedo.is_cuda, f"oracle {name}: the train step runs on the card by default")
        p0 = SceneParams(*(x.detach().clone() for x in params))
        losses, times = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(TRAIN_STEPS):
            (params, opt, loss, grads), sec = synced_s(
                lambda: step(params, opt, None, target))  # noqa: B023
            losses.append(loss.item())
            times.append(sec)
            check(torch.isfinite(loss).item(), f"oracle {name}: finite loss")
            check(all(torch.isfinite(g).all().item() for g in grads),
                  f"oracle {name}: finite grads")
        peak = torch.cuda.max_memory_allocated()
        for f in SceneParams._fields:
            moved = not torch.equal(getattr(params, f).detach(), getattr(p0, f))
            check(moved == (f in trainable), f"oracle {name}: {f} "
                  f"{'moves' if f in trainable else 'stays bit-unchanged'}")
        geometry_probe(name, start, cam, spp, target, hold=name.startswith("three"))
        w, h = cam.image_size()
        print(f"oracle train step, {name} ({w}x{h}, {spp} spp, depth 8, {w * h * spp} rays, "
              f"{start.num_spheres} spheres): losses " + ", ".join(f"{x:.6f}" for x in losses)
              + f"; seconds per step (median of {len(times) - 2} warm) "
              f"{statistics.median(times[2:]):.4f} s, peak memory {peak / 2**20:.1f} MiB on {card}")
    check(trace.LAUNCHES["closest_hit"] == 0, "the oracle's train step selects with the plain scan")


def oracle_against_replay(card: str) -> None:
    """Autograd through `ray_color` against `replay_radiance` on
    `xla_trace_record`'s residuals, for the same rays and draws, on the
    card (cover, 65,536 rays spread over the image, depth 8), in float64
    and in float32 (the float64 draws, rounded).

    Within one precision they are one function differentiated twice, and
    the replay re-solves each winner's quadratic in the recorder's own
    operation order, so it lands on the recorded hit points. Held, per
    precision: the replay's radiance against the oracle's, and per field
    the relative-norm difference of the gradients of a weighted radiance
    sum (fuzz where fuzz > 0, where the replay can recover the fuzz
    offset). float64: radiance 1e-10, gradients 1e-7 (measured 1.3e-12 and
    <= 2.3e-10). float32: radiance within 1e-5 on >= 99.9% of rays,
    gradients GRAD32_TOL (measured: see there).

    Printed, not held: how far each float32 gradient lies from the float64
    one. That distance is of order 1 in the geometry fields for both
    routes alike, because about 1% of the float32 paths take another
    branch than the float64 ones and because a few near-grazing rays
    (1 / sqrt(disc) in the root's derivative) carry nearly all of the
    gradient: the share of the radiance's sensitivity to a random geometry
    direction (central differences in float64) that the top 0.1% of rays
    carry is printed beside it."""
    import dataclasses

    import torch

    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.grad import (
        SceneParams, apply_params, extract_params, replay_radiance, xla_trace_record,
    )
    from raytracingproject_tpu_torch.materials import draw_scatter
    from raytracingproject_tpu_torch.render import ray_color
    from raytracingproject_tpu_torch.scene import make_cover_scene

    dev = torch.device("cuda")
    depth = 8
    gen = torch.Generator(device=dev).manual_seed(13)
    cover = make_cover_scene(0, device=dev)
    rays = pass_rays(Camera(**COVER_CAMERA, samples_per_pixel=1, max_depth=depth), gen)
    pick = torch.arange(N_CMP, device=dev) * rays[0].shape[0] // N_CMP  # spread over the image
    draws64 = [draw_scatter(gen, (N_CMP,), torch.float64) for _ in range(depth)]
    w64 = torch.rand((N_CMP, 3), generator=gen, device=dev, dtype=torch.float64)
    grads, records = {}, {}
    for dtype in (torch.float64, torch.float32):
        scene = dataclasses.replace(cover, **{f: getattr(cover, f).to(dtype)
                                              for f in SceneParams._fields})
        o, d, t = (x[pick].to(dtype) for x in rays)
        draws = [type(dr)(*(x.to(dtype) for x in dr)) for dr in draws64]
        w = w64.to(dtype)
        pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
        rad = ray_color(apply_params(scene, pp), o, d, t, None, depth, draws=draws)
        g_oracle = torch.autograd.grad((rad * w).sum(), list(pp))
        rad_rec, res = xla_trace_record(scene, o, d, t, None, depth, draws=draws)
        rad_rep = replay_radiance(pp, scene, o, d, t, res)
        g_replay = torch.autograd.grad((rad_rep * w).sum(), list(pp))
        torch.cuda.synchronize()
        grads[dtype], records[dtype] = (g_oracle, g_replay), res
        diff = torch.abs(rad_rep - rad).max(dim=1).values
        frac = (diff <= 1e-5).double().mean().item()
        lit = scene.fuzz > 0

        def errs(ga, gb):
            return {f: rel_err(a[lit] if f == "fuzz" else a, b[lit] if f == "fuzz" else b)
                    for f, a, b in zip(SceneParams._fields, ga, gb)}

        show = lambda e: ", ".join(f"{k} {v:.2e}" for k, v in e.items())  # noqa: E731
        err = errs(g_replay, g_oracle)
        name = str(dtype).removeprefix("torch.")
        print(f"oracle vs replay of its record ({N_CMP} cover rays, depth {depth}, {name}): "
              f"recorder radiance == ray_color {torch.equal(rad_rec, rad.detach())}; replay "
              f"within 1e-5 on {frac:.6f} of rays, max |diff| {diff.max().item():.3e}; gradient "
              f"relative errors {show(err)}; on {card}")
        check(torch.isfinite(rad).all().item()
              and all(torch.isfinite(g).all().item() for g in g_oracle + g_replay),
              f"oracle and replay gradients finite ({name})")
        check(torch.equal(rad_rec, rad.detach()),
              f"xla_trace_record returns ray_color's radiance ({name})")
        if dtype == torch.float64:
            check(diff.max().item() <= 1e-10, "float64: replay radiance equals the oracle's")
            check(max(err.values()) <= 1e-7, "float64: oracle and replay gradients agree")
            continue
        check(frac >= 0.999, "float32: >= 99.9% of rays within 1e-5 of the replay")
        check(max(err.values()) <= GRAD32_TOL,
              f"float32: oracle and replay gradients agree within {GRAD32_TOL}")
        g64 = grads[torch.float64][0]
        r64 = records[torch.float64]
        same = ((res.idx == r64.idx) & (res.refl == r64.refl)).all(dim=0).double().mean().item()
        # per-ray sensitivity to one random geometry direction, float64
        scene64 = dataclasses.replace(cover, **{f: getattr(cover, f).double()
                                                for f in SceneParams._fields})
        vc = torch.randn(cover.center0.shape, generator=gen, device=dev, dtype=torch.float64)
        vr = torch.randn(cover.radius.shape, generator=gen, device=dev, dtype=torch.float64)
        o64, d64, t64 = (x[pick].double() for x in rays)
        h = 1e-7
        with torch.no_grad():
            up, down = (ray_color(dataclasses.replace(
                scene64, center0=scene64.center0 + sgn * h * vc,
                radius=scene64.radius + sgn * h * vr), o64, d64, t64, None, depth, draws=draws64)
                for sgn in (1.0, -1.0))
        sens = torch.sort(((up - down).abs() * w64).sum(dim=1), descending=True).values
        top = max(1, N_CMP // 1000)
        print(f"float32 against float64 gradients: oracle {show(errs(g_oracle, g64))}; replay "
              f"{show(errs(g_replay, g64))}; the float32 record equals the float64 one on "
              f"{same:.6f} of rays; the top {top} rays carry "
              f"{(sens[:top].sum() / sens.sum()).item():.4f} of the radiance's sensitivity to a "
              f"random geometry direction")


def perturbed_cover(kind: str, seed: int = 11):
    """The cover scene with its trainable fields moved off the truth:
    `geometry` moves albedo, the small spheres' centres (sigma 0.01) and
    radii (+-2%); `materials` moves albedo, metal fuzz and glass ior."""
    import dataclasses

    import numpy as np
    import torch

    from raytracingproject_tpu_torch.config import DIELECTRIC, METAL
    from raytracingproject_tpu_torch.scene import make_cover_scene

    s = make_cover_scene(0)
    rng = np.random.default_rng(seed)
    n = s.num_spheres
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    albedo = torch.clamp(s.albedo * t(rng.uniform(0.7, 1.3, (n, 3))), 0.0, 1.0)
    if kind == "geometry":
        small = (s.radius < 0.5)[:, None]
        center0 = s.center0 + torch.where(small, t(rng.normal(0.0, 0.01, (n, 3))), 0.0)
        radius = torch.where(small[:, 0], s.radius * t(rng.uniform(0.98, 1.02, n)), s.radius)
        return dataclasses.replace(s, albedo=albedo, center0=center0, radius=radius)
    met, die = s.mat_type == METAL, s.mat_type == DIELECTRIC
    fuzz = torch.where(met, torch.clamp(s.fuzz + t(rng.uniform(-0.1, 0.1, n)), 0.0, 1.0),
                       s.fuzz)
    ior = torch.where(die, s.ior * t(rng.uniform(0.95, 1.05, n)), s.ior)
    return dataclasses.replace(s, albedo=albedo, fuzz=fuzz, ior=ior)


def step_rays(cam, gen, seed: bool = True):
    """One train step's camera rays (400x225 at the camera's spp, in the
    [spp, H, W] order) and path seed, drawn from `gen` as
    make_fast_train_step's step draws them; without `seed` the rays
    alone."""
    import torch

    from raytracingproject_tpu_torch.camera import camera_uniforms, rays_from_uniforms

    dev = gen.device
    w, h = cam.image_size()
    pix = torch.arange(w * h, device=dev).repeat(cam.samples_per_pixel)
    o, d, t = rays_from_uniforms(cam.derive(torch.float32, dev), (pix % w).to(torch.int32),
                                 (pix // w).to(torch.int32),
                                 *camera_uniforms(pix.shape[0], gen, dev))
    if not seed:
        return o, d, t
    return o, d, t, int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=dev))


def train_full_width(mk, card: str) -> tuple[dict, dict, dict]:
    """Phases 10 and 12c: make_fast_train_step on the cover scene at
    400x225, 2 spp, depth 50, in both configurations, from a perturbed
    scene toward a `render()` of the true one. Before the steps, K5 is held
    against its plain version on one step's rays at the step's own shapes
    (depth 50; the perturbed scene, or the front prepared for the depth-50
    camera with its table rebuilt by front_with_params). Returns the launch
    counts of the steps, the median seconds per warm step per configuration
    and that comparison's max |diff| per path."""
    import statistics

    import torch

    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.grad import SceneParams, make_fast_train_step
    from raytracingproject_tpu_torch.render import prepare_scene, render
    from raytracingproject_tpu_torch.scene import make_cover_scene

    dev = torch.device("cuda")
    cam = Camera(**COVER_CAMERA, samples_per_pixel=2, max_depth=50)
    settings = RenderSettings(device="cuda")
    target = render(make_cover_scene(0), Camera(**COVER_CAMERA, samples_per_pixel=16,
                                                max_depth=50),
                    torch.Generator(device=dev).manual_seed(5), settings)
    configs = {  # trainable fields, perturbation, front, Adam's learning rate
        "geometry+albedo (brute K5)": (("albedo", "center0", "radius"), "geometry", False, 2e-3),
        "materials (front K5)": (("albedo", "fuzz", "ior"), "materials", True, 1e-2),
    }
    step_s, rec_err, launches = {}, {}, {}
    for name, (trainable, kind, use_front, lr) in configs.items():
        start = perturbed_cover(kind).to(dev)
        front = None
        if use_front:
            start, front = prepare_scene(start, cam, settings)
            print(f"train front: {front.ff.shape[1]} subtrees over {front.sph.shape[1]} "
                  f"columns, repack {front.repack}")
        o, d, t, seed = step_rays(cam, torch.Generator(device=dev).manual_seed(4))
        fr = None if front is None else mk.front_with_params(front, start)
        rec_err["front" if use_front else "brute"] = hold_record(
            mk, "train step", o, d, t, start, fr, seed, cam.max_depth, False,
            exact=not use_front)
        del o, d, t, fr
        gen = torch.Generator(device=dev).manual_seed(3)
        params, opt, step = make_fast_train_step(start, cam, spp=2, learning_rate=lr,
                                                 trainable=trainable, front=front,
                                                 generator=gen)
        p0 = SceneParams(*(x.detach().clone() for x in params))
        losses, times = [], []
        mk.reset_launches()
        for _ in range(TRAIN_STEPS):
            (params, opt, loss, grads), sec = synced_s(
                lambda: step(params, opt, None, target))  # noqa: B023
            losses.append(loss.item())
            times.append(sec)
            check(torch.isfinite(loss).item(), f"{name}: finite loss")
            check(all(torch.isfinite(g).all().item() for g in grads), f"{name}: finite grads")
        for k, v in mk.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        for f in SceneParams._fields:
            moved = not torch.equal(getattr(params, f).detach(), getattr(p0, f))
            check(moved == (f in trainable), f"{name}: {f} "
                  f"{'moves' if f in trainable else 'stays bit-unchanged'}")
        step_s[name] = statistics.median(times[2:])
        print(f"train step, {name}, cover 400x225, 2 spp, depth 50: losses "
              + ", ".join(f"{x:.6f}" for x in losses)
              + f"; seconds per step (median of {len(times) - 2} warm) {step_s[name]:.4f} s "
              f"on {card}")
    print(f"training path: kernel launches {launches}")
    check(launches[launch_key("record_brute")] > 0 and launches["record_front"] > 0,
          "both recording kernels ran on the training path")
    return launches, step_s, rec_err


def descent(make_step, what: str) -> None:
    """Albedo-only descent on the three-sphere scene (128x72, 4 spp,
    depth 8, 40 steps of Adam(5e-2) from albedo 0.5) with `make_step`
    (make_fast_train_step in phase 11, make_train_step for the oracle)."""
    import dataclasses

    import torch

    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.render import render
    from raytracingproject_tpu_torch.scene import make_three_sphere_scene

    dev = torch.device("cuda")
    cam = Camera(aspect_ratio=16.0 / 9.0, image_width=128, samples_per_pixel=4, max_depth=8,
                 vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0))
    true = make_three_sphere_scene()
    target = render(true, dataclasses.replace(cam, samples_per_pixel=64),
                    torch.Generator(device=dev).manual_seed(1),
                    RenderSettings(device="cuda", use_bvh=False))
    start = dataclasses.replace(true, albedo=torch.full_like(true.albedo, 0.5))  # on the CPU
    params, opt, step = make_step(start, cam, spp=4, learning_rate=5e-2, trainable=("albedo",),
                                  generator=torch.Generator(device=dev).manual_seed(2))
    check(params.albedo.is_cuda, f"descent, {what}: the train step runs on the card by default")
    losses = []
    for _ in range(40):
        params, opt, loss, _ = step(params, opt, None, target)
        losses.append(loss.item())
    ratio = (sum(losses[-5:]) / 5) / (sum(losses[:5]) / 5)
    err = torch.abs(params.albedo.detach().cpu() - true.albedo)[:2].max().item()
    print(f"descent, {what} (three spheres, 128x72, 4 spp, depth 8, albedo, 40 steps): loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}, last-5 / first-5 mean ratio {ratio:.4f} "
          f"(limit {DESCENT_RATIO}); max |albedo - truth| over the two diffuse spheres {err:.4f}")
    check(ratio < DESCENT_RATIO, f"descent, {what}: the loss falls")


def time_training(mk, scene, front, o, d, t, card: str) -> dict:
    """Phase 12a/b: K5 kernel against its plain version at the bench shape
    (CUDA events), and the replay backward (forward with graph, then
    autograd) at the same shape. Returns (ms, plain_ms) per path."""
    import statistics

    import torch

    from raytracingproject_tpu_torch.grad import SceneParams, extract_params, replay_radiance

    n_rays = o.shape[0]
    times = {}
    for path in ("brute", "front"):
        f = front if path == "front" else None

        def kern():
            mk.trace_record(o, d, t, scene, 99, 16, front=f)

        def twin():
            mk.trace_record_twin(o, d, t, scene, 99, 16, front=f)

        kern()
        twin()  # warm both
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(twin, 2)
        times[path] = (ms, plain_ms)
        print(f"record_{path}: kernel {ms:.3f} ms = {n_rays / ms / 1e3:.3f} Mrays/s; twin "
              f"{plain_ms:.3f} ms ({n_rays} camera rays, depth 16) on {card}")

        _, res = mk.trace_record(o, d, t, scene, 99, 16, front=f)
        w = torch.ones((n_rays, 3), device=o.device)

        def backward():
            pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
            rad = replay_radiance(pp, scene, o, d, t, res)
            return torch.autograd.grad((rad * w).sum(), list(pp))

        backward()
        secs = [synced_s(backward)[1] for _ in range(3)]
        print(f"replay backward ({path} residuals, {n_rays} rays, depth 16, live depth "
              f"{int((res.idx != mk.DEAD).any(dim=1).sum())}): "
              f"{1e3 * statistics.median(secs):.3f} ms (median of 3) on {card}")
    return times


def step_split(card: str) -> None:
    """Phase 12d: where a full-width train step's time goes (cover,
    400x225, 2 spp, depth 50), each part timed alone between device
    synchronisations: ray generation with the seed draw, the K5 forward,
    the replay forward with graph, its backward, and the Adam update."""
    import torch

    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.grad import SceneParams, extract_params, replay_radiance
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
    from raytracingproject_tpu_torch.render import prepare_scene

    dev = torch.device("cuda")
    cam = Camera(**COVER_CAMERA, samples_per_pixel=2, max_depth=50)
    gen = torch.Generator(device=dev).manual_seed(8)
    for name, kind, trainable, use_front in (
            ("geometry+albedo (brute K5)", "geometry", ("albedo", "center0", "radius"), False),
            ("materials (front K5)", "materials", ("albedo", "fuzz", "ior"), True)):
        scene = perturbed_cover(kind).to(dev)
        front = None
        if use_front:
            scene, front = prepare_scene(scene, cam, RenderSettings(device="cuda"))
        parts = {"rays": [], "K5 forward": [], "replay forward": [], "replay backward": [],
                 "Adam": []}
        pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
        trained = [SceneParams._fields.index(f) for f in trainable]
        opt = torch.optim.Adam([pp[k] for k in trained], lr=1e-2)
        for _ in range(4):
            (o, d, t, seed), s = synced_s(lambda: step_rays(cam, gen))
            parts["rays"].append(s)
            fr = None if front is None else mk.front_with_params(front, scene)
            (_, res), s = synced_s(lambda: mk.trace_record(o, d, t, scene, seed, 50, front=fr))  # noqa: B023
            parts["K5 forward"].append(s)
            rad, s = synced_s(lambda: replay_radiance(pp, scene, o, d, t, res))  # noqa: B023
            parts["replay forward"].append(s)
            grads, s = synced_s(lambda: torch.autograd.grad(rad.sum(), list(pp)))  # noqa: B023
            parts["replay backward"].append(s)
            for k in trained:
                pp[k].grad = grads[k]
            _, s = synced_s(opt.step)
            parts["Adam"].append(s)
        summary = ", ".join(f"{k} {1e3 * sorted(v[1:])[1]:.3f} ms" for k, v in parts.items())
        print(f"step split, {name} (median of 3 warm): {summary}; on {card}")


def rays_differ(a, b, tol: float = 1e-3) -> float:
    """Share of rays whose radiance differs by more than `tol`."""
    return (abs(a - b) > tol).any(dim=1).double().mean().item()


def counting_hit(mk, scene, front, bvh, device, counts: dict):
    """(tab, closest_hit, chunk) as `mk.twin_closest_hit` gives them, the
    closest hit adding to `counts` what each call's rays need: live
    ray-bounces, ray-sphere pair tests and ray-box tests. Brute: every
    sphere a live bounce. Front (K3, K6's front segment, K7): what the
    kernel's culling tests, its clamps by the best t included
    (`probes.pair_counts.front_walk`, whose result must equal the plain
    version's on every bounce): the super-word boxes, the 24 word boxes of
    each super-word the ray enters (below 577 subtrees the word boxes at
    once, below 25 none), with `word_earlyout` each entered word's box
    within the best t, the subtree boxes of each chunk of an entered word
    within the best t, with sub-block boxes the 8-column group boxes of
    each subtree left, and the columns of what is left, padding columns
    included; and beside them ("unclamped boxes", "unclamped pairs",
    "unclamped roots") the same hierarchy's count without the clamps, the
    yardstick of earlier bounds. BVH walk (K8): the
    two boxes of each node record the kernel's ordered walk visits and the
    spheres of the leaves it enters (`probes.pair_counts.ordered_walk`,
    the walk the kernel takes; "records", "leaves" and "steps", its
    dependent chain, beside them), and the plain version's miss-link walk's
    ("miss-link boxes", "miss-link pairs", "miss-link roots"), whose
    result the ordered walk's must equal on every bounce. "roots": the
    pair tests among those whose discriminant is positive. Dead rays are
    parked where every test misses and count nothing."""
    import torch

    tab, base, chunk = mk.twin_closest_hit(scene, front, bvh, device)
    if front is not None:
        from raytracingproject_tpu_torch.probes.pair_counts import front_walk

        walk = front_walk(front, tab)
        plain: dict = {"boxes": 0, "pairs": 0, "roots": 0}
        grp = n_grp = None
        if isinstance(front, mk.FrontTablesHBM):
            cols = front.valid_columns()
            sub = cols // mk.BLOCK
            if front.bf is not None:
                grp = cols // mk.UNROLL
                n_grp = front.fi[0].long() // mk.UNROLL  # groups a subtree scans
        else:
            sub = front.column_subtree()
            if front.bf is not None:  # K3's sub-block boxes (the forward kernel's option)
                grp = torch.arange(front.sph.shape[1], device=device) // mk.UNROLL
                n_grp = front.fi[1].long() // mk.UNROLL
        n_words = front.ff.shape[1] // mk.WORD
        n_super = -(-n_words // mk.WORD)
        word_of = torch.arange(front.ff.shape[1], device=device) // mk.WORD
        super_of = torch.arange(n_words, device=device) // mk.WORD

        def hit(ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min):
            live = ox < 1e17
            n_live = int(live.sum())

            def enters(boxes):
                return mk.subtree_slab_mask(boxes, ox, oy, oz, dx, dy, dz, t_min) & live[:, None]

            # unclamped: stage 1 as the kernels descend (super-word boxes, the word
            # boxes of entered super-words; one word is live without a test), then
            # the WORD subtree boxes of every entered word
            if n_words == 1:
                m_word = live[:, None]
            elif n_super == 1:
                plain["boxes"] += n_live * n_words
                m_word = enters(front.wf)[:, :n_words]
            else:
                m_super = enters(front.sf)[:, :n_super]
                plain["boxes"] += n_live * n_super + int(m_super.sum()) * mk.WORD
                m_word = enters(front.wf)[:, :n_words] & m_super[:, super_of]
            plain["boxes"] += int(m_word.sum()) * mk.WORD
            m_sub = enters(front.ff) & m_word[:, word_of]
            entered = m_sub[:, sub]
            if grp is not None:
                plain["boxes"] += int((m_sub * n_grp[None, :]).sum())
                entered = entered & mk.subtree_slab_mask(front.bf, ox, oy, oz, dx, dy, dz,
                                                         t_min)[:, grp]
            plain["pairs"] += int(entered.sum())
            disc = mk._sphere_disc(tab, ox, oy, oz, dx, dy, dz, tm, a)[1]
            plain["roots"] += int((entered & (disc > 0.0)).sum())
            for k, v in plain.items():
                counts[f"unclamped {k}"] = v
            counts["bounces"] += n_live
            rays = (ox, oy, oz, dx, dy, dz, tm, a, inv_a)
            got = walk(rays, t_min, counts)
            want = base(*rays, t_min)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  "the front kernels' clamped culling (their model) equals the plain version on "
                  "a bounce")
            return want
    elif bvh is not None:
        from raytracingproject_tpu_torch.probes.pair_counts import ordered_walk

        tables = mk.bvh_tables(bvh, device)
        plain: dict = {"boxes": 0, "pairs": 0, "roots": 0}

        def hit(ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min):
            counts["bounces"] += int((ox < 1e17).sum())
            rays = (ox, oy, oz, dx, dy, dz, tm, a, inv_a)
            want = mk.closest_hit_bvh_twin(tab, tables.flat, *rays, t_min, counts=plain)
            for k, v in plain.items():
                counts[f"miss-link {k}"] = v
            got = ordered_walk(tables.nodes, tab, rays, t_min, counts=counts)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  "K8's ordered walk (its model) equals the plain version on a bounce")
            return got
    else:
        def hit(ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min):
            live = ox < 1e17
            counts["bounces"] += int(live.sum())
            counts["pairs"] += int(live.sum()) * tab.shape[1]
            disc = mk._sphere_disc(tab, ox, oy, oz, dx, dy, dz, tm, a)[1]
            counts["roots"] += int(((disc > 0.0) & live[:, None]).sum())
            return base(ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_min)
    return tab, hit, chunk


def count_tests(mk, o, d, t, scene, front, seed: int, depth: int, bvh=None) -> dict:
    """What these rays need in a monolithic trace, counted in the plain
    version of the bounce loop (see `counting_hit`)."""
    import torch

    counts = {"bounces": 0, "pairs": 0, "roots": 0, "boxes": 0}
    tab, hit, chunk = counting_hit(mk, scene, front, bvh, o.device, counts)
    for r0 in range(0, o.shape[0], chunk):
        sl = slice(r0, r0 + chunk)
        mk.bounce_loop_twin(o[sl], d[sl], t[sl], tab, hit, seed, depth, ray0=r0)
    torch.cuda.synchronize()
    return counts


def hold_large(mk, what: str, key: str, o, d, t, scene, seed: int, depth: int, twin=None,
               exact: bool = False, **route) -> float:
    """One large-scene kernel (route: front=<FrontTablesHBM>, bvh=<tree> or
    neither for the chunked brute scan; key its launch counter) against its
    plain version on one set of rays: >= 99.9% of rays within 1e-3,
    bit-equal expected (required with `exact`, the chunked scan). `twin`
    is the plain version's result on these arguments where the caller has
    it already. Returns the max |diff|."""
    import torch

    before = mk.LAUNCHES[key]
    k = mk.trace_paths(o, d, t, scene, seed, depth, **route)
    torch.cuda.synchronize()
    check(mk.LAUNCHES[key] == before + 1, f"{what}: one launch of {key}")
    p = twin if twin is not None else mk.trace_paths_twin(o, d, t, scene, seed, depth, **route)
    diff = torch.abs(k - p)
    frac = (diff <= 1e-3).all(dim=1).double().mean().item()
    print(f"{what} kernel vs twin ({o.shape[0]} rays, depth {depth}, philox): {frac:.6f} within "
          f"1e-3, max |diff| {diff.max().item():.3e}, bit-equal {torch.equal(k, p)}")
    check(torch.isfinite(k).all().item(), f"{what}: radiance finite")
    check(frac >= 0.999, f"{what}: >= 99.9% of rays within 1e-3 of the plain version")
    check(not exact or torch.equal(k, p), f"{what}: bit-equal to the plain version")
    return diff.max().item()


def chunked_edge_cases(mk, rays) -> dict:
    """The chunked scan's six instantiations on four blocks with 1, 33, 129
    and 256 live rays of `rays` (block b traces rays b, b + 4, ...; the
    rest parked from the start: dead in K6's carried state, a miss at the
    first bounce in the monolithic kernels), on 2,000 spheres (two chunks),
    5,000 (five chunks) and a scene of every sphere twice, at columns i and
    1999 - i, where every hit is an exact tie: each bit-equal to its plain
    version. Returns each launch key's max |diff| against the plain version
    (0 when bit-equal)."""
    import numpy as np
    import torch

    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt
    from raytracingproject_tpu_torch.scene import make_random_scene

    dev = rays[0].device
    n = mk.TILE * len(LIVE_PER_BLOCK)
    o, d, t = (x[::x.shape[0] // n][:n].clone() for x in rays)  # over the whole image
    rng = np.random.default_rng(7)
    live = np.zeros(n, bool)
    blocks = len(LIVE_PER_BLOCK)
    for b, k in enumerate(LIVE_PER_BLOCK):  # thread t of block b traces ray t * blocks + b
        live[rng.choice(mk.TILE, k, replace=False) * blocks + b] = True
    live = torch.from_numpy(live).to(dev)
    o[~live], d[~live] = 1e18, 1.0
    states = {}
    for miss in (False, True):
        states[miss], slot = dt.initial_state(o, d, t, miss)
        states[miss][mk.ST_ALIVE] = live.float()
    half = make_random_scene(1000, seed=3)
    twice = torch.cat([torch.arange(1000), torch.arange(999, -1, -1)])
    scenes = {"2,000 spheres": make_random_scene(2000, seed=3, device=dev),
              "5,000 spheres": make_random_scene(5000, seed=3, device=dev),
              "every hit a tie": half.take(twice).to(dev)}
    # launch key -> (kernel call, plain version) over a scene
    seg = dict(zip(("segment_brute_chunked", "segment_miss_brute_chunked",
                    "segment_record_brute_chunked"),
                   ((False, False), (True, False), (False, True))))
    runs = {"brute_chunked": lambda sc: (mk.trace_paths(o, d, t, sc, 5, 8),
                                         mk.trace_paths_twin(o, d, t, sc, 5, 8)),
            "record_brute_chunked": lambda sc: (mk.trace_record(o, d, t, sc, 5, 8),
                                                mk.trace_record_twin(o, d, t, sc, 5, 8)),
            "brute_chunked_miss": lambda sc: (
                mk.trace_paths(o, d, t, sc, 5, 8, record_miss=True),
                mk.trace_paths_twin(o, d, t, sc, 5, 8, record_miss=True))}
    for key, (miss, record) in seg.items():
        runs[key] = lambda sc, miss=miss, record=record: tuple(
            f(states[miss], slot, sc, 77, 3, 8, record_miss=miss, record=record)
            for f in (mk.segment_call, mk.segment_twin))

    def tensors(x):
        return [y for v in x for y in tensors(v)] if isinstance(x, (tuple, list)) else [x]

    err = {}
    for what, sc in scenes.items():
        for key, run in runs.items():
            before = mk.LAUNCHES[key]
            got, plain = run(sc)
            torch.cuda.synchronize()
            check(mk.LAUNCHES[key] == before + 1, f"{key} ({what}): one launch")
            got, plain = tensors(got), tensors(plain)
            same = all(torch.equal(a, b) for a, b in zip(got, plain))
            err[key] = max([err.get(key, 0.0)] + [torch.abs(a.double() - b.double()).max().item()
                                                  for a, b in zip(got, plain)])
            print(f"{key}, blocks with {LIVE_PER_BLOCK} live rays, {what}: bit-equal to the "
                  f"plain version {same}")
            check(same, f"{key} ({what}): bit-equal to the plain version")
            if what == "every hit a tie" and key == "record_brute_chunked":
                idx = got[1]
                check(bool((idx >= 0).any()) and bool((idx[idx >= 0] < 1000).all()),
                      "ties: every winner is the first copy of its sphere")
    return err


def chunked_blocks(mk, idx, n_cols: int, kernel_ms: float, card: str) -> None:
    """Where the chunked scan's time goes, from a record's idx [D, R] of
    its rays (a ray is live at a bounce its idx is not DEAD; thread t of
    block b traces ray t x blocks + b): the live rays L of each block at
    each bounce, the share of the block's threads a bounce keeps busy
    (L x G of 256, G the lanes a ray), the longest block's path (n / G
    tests a thread, summed over its bounces), the tests each SM is given
    with the blocks dealt round-robin (all are resident at once), and the
    times the measured mixed peak puts on the tests balanced and as dealt."""
    import torch

    n_blocks = idx.shape[1] // mk.TILE
    dev = idx.device
    live = torch.zeros((idx.shape[0], n_blocks), dtype=torch.float64, device=dev)
    live.index_add_(1, torch.arange(idx.shape[1], device=dev) % n_blocks,
                    (idx != mk.DEAD).double())  # [D, B]
    ran = live > 0
    groups = torch.where(ran, torch.exp2(torch.floor(torch.log2(mk.TILE / live.clamp_min(1)))),
                         0.0)
    busy = (live * groups).sum().item() / (mk.TILE * ran.sum().item())
    path = torch.where(ran, n_cols / groups.clamp_min(1), 0.0).sum(dim=0)
    tests = n_cols * live.sum(dim=0)  # per block
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = torch.zeros(n_sm, dtype=torch.float64, device=dev)
    per_sm.index_add_(0, torch.arange(n_blocks, device=dev) % n_sm, tests)
    bounds = torch.tensor([1, 2, 5, 33, 129, 257], dtype=torch.float64, device=dev)
    hist = [int(((live >= lo) & (live < hi)).sum()) for lo, hi in zip(bounds[:-1], bounds[1:])]
    peak, skew = RATE["pairs"], (per_sm.max() / per_sm.mean()).item()
    print(f"chunked scan, one pass ({idx.shape[1]} rays, depth {idx.shape[0]}, {n_cols} spheres): "
          f"{int(ran.sum())} block-bounces of {n_blocks} blocks; live rays a block-bounce in "
          f"[1,2) [2,5) [5,33) [33,129) [129,256]: {hist}; threads busy {busy:.3f}; the longest "
          f"block's path {path.max().item():.4g} tests a thread (mean {path.mean().item():.4g}); "
          f"sphere tests {tests.sum().item():.4g} (every one needed); at the mixed peak "
          f"{peak:.4g}/s balanced {1e3 * tests.sum().item() / peak:.2f} ms, dealt round-robin to "
          f"{n_sm} SMs {1e3 * per_sm.max().item() * n_sm / peak:.2f} ms (the most loaded SM "
          f"{skew:.3f}x the mean); the kernel {kernel_ms:.3f} ms; on {card}")


def large_occupancy(card: str) -> None:
    """K7's two instantiations (forward, record_miss) and K8's three
    (forward, recording, record_miss): registers, spill stores and stack
    frame as -Xptxas -v reported them, and blocks per SM with their shared
    memory (the live list; every table stays in global memory), as the
    launch gets them."""
    from raytracingproject_tpu_torch.ops.cuda import build

    regs = build.kernel_registers(str(build.BUILD_INFO["log"]))
    lib = build.load_library()
    kinds = [((4, 0, miss, 0, 0), lambda b, miss=miss: lib.rtp_hbm_blocks_per_sm(miss, b))
             for miss in (0, 1)]
    kinds += [((3, rec, miss, 0, 0), lambda b, rec=rec, miss=miss: lib.rtp_bvh_blocks_per_sm(
        rec, miss, b)) for rec, miss in ((0, 0), (1, 0), (0, 1))]
    for key, occupancy in kinds:
        blocks = ctypes.c_int()
        build.check(occupancy(ctypes.byref(blocks)), "occupancy")
        print(f"  {instantiation(key)}: {regs[key][0]} registers, {regs[key][1]} B spill "
              f"stores, {regs[key][2]} B stack frame, {blocks.value} blocks of 256 threads per "
              f"SM; on {card}")


def large_scenes(mk, trace, card: str) -> list[dict]:
    """The large-scene path (see the module docstring): comparisons, the
    main path at full width with its launch counts, times and bounds.
    Returns the `kernels` entries of the five large-scene kernels."""
    import dataclasses
    import statistics

    import torch

    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import DIELECTRIC, METAL, RenderSettings
    from raytracingproject_tpu_torch.grad import (
        SceneParams, extract_params, make_fast_train_step, replay_radiance,
    )
    from raytracingproject_tpu_torch.render import (
        _slot_rays, blocks_to_image, prepare_scene, render, render_pass,
    )
    from raytracingproject_tpu_torch.scene import make_random_scene

    dev = torch.device("cuda")
    settings = RenderSettings(device="cuda")
    bench_cam = Camera(**COVER_CAMERA, samples_per_pixel=4, max_depth=16)
    ref_cam = Camera(**COVER_CAMERA, samples_per_pixel=30, max_depth=50)
    w, h = bench_cam.image_size()
    o, d, t = _slot_rays(bench_cam.derive(torch.float32, dev), w, h, 4,
                         torch.Generator(device=dev).manual_seed(1), None)
    n_rays = w * h * 4
    stride = o.shape[0] // N_LARGE_CMP
    oc, dc, tc = (x[::stride][:N_LARGE_CMP].contiguous() for x in (o, d, t))  # over the image
    max_err: dict[str, float] = {}

    def worst(key, err):
        max_err[key] = max(max_err.get(key, 0.0), err)

    # ---- L1. the brute scan (the chunked kernel, every table size) ----
    for n in (2000, 3000):  # tables that fit shared memory whole, near its size
        sc = make_random_scene(n, seed=3, device=dev)
        worst("brute_chunked", hold_large(mk, f"brute scan ({n} spheres)", "brute_chunked",
                                          oc[:4096], dc[:4096], tc[:4096], sc, 7, 8, exact=True))
    five = make_random_scene(5000, seed=3, device=dev)
    worst("brute_chunked", hold_large(mk, "brute past the budget (5,000 spheres)",
                                      "brute_chunked", oc[:4096], dc[:4096], tc[:4096], five, 7, 4,
                                      exact=True))
    worst("record_brute_chunked", hold_record(mk, "5,000 spheres", oc[:4096], dc[:4096],
                                              tc[:4096], five, None, 7, 4, False, exact=True))
    del five
    for key, err in chunked_edge_cases(mk, (o, d, t)).items():
        worst(key, err)

    # ---- L2. 50,000 spheres: every kernel against its plain version ----
    host = {}
    big_cpu = make_random_scene(N_LARGE, seed=3)
    t0 = time.perf_counter()
    tree = build_bvh(big_cpu, leaf_size=8)
    host["build_bvh"] = time.perf_counter() - t0
    big = reorder_scene(big_cpu, tree).to(dev)
    t0 = time.perf_counter()
    fronts = {"plain": mk.front_tables_hbm(big, tree)}
    host["front_tables_hbm"] = time.perf_counter() - t0
    fronts["word_earlyout"] = dataclasses.replace(fronts["plain"], word_earlyout=True)
    fronts["sub_block"] = mk.front_tables_hbm(big, tree, max_nodes=480, sub_block=True)
    for name, f in fronts.items():
        print(f"K7 front ({name}): {f.ff.shape[1]} subtrees (super-words {f.sf.shape[1]}), "
              f"{int(f.fi.sum())} scanned columns of {f.sph.shape[0]}, ksub {f.ksub}")
    check(fronts["plain"].ff.shape[1] > 576, "the 50,000-sphere front has super-words")
    large_occupancy(card)
    for name, f in fronts.items():
        worst("front_hbm", hold_large(mk, f"K7 ({name}, {N_LARGE} spheres)", "front_hbm",
                                      oc, dc, tc, None, 2024, 4, exact=True, front=f))
    worst("bvh", hold_large(mk, f"K8 ({N_LARGE} spheres)", "bvh", oc, dc, tc, big, 2024, 4,
                            exact=True, bvh=tree))
    tables = mk.bvh_tables(tree, dev)
    print(f"K8's node records: {tables.nodes.shape[0]} ({tables.nodes.numel() * 4} B), depth "
          f"{tables.depth} of a {mk.BVH_STACK}-entry stack")
    worst("record_bvh", hold_record(mk, f"{N_LARGE} spheres", oc, dc, tc, big, None, 2024, 4,
                                    False, bvh=tables, exact=True))

    # ---- L3. first hits of a whole pass against K4 ----
    po, pd, pt = pass_rays(ref_cam, torch.Generator(device=dev).manual_seed(21))
    k4_t, k4_i = trace.closest_hit_fused(po, pd, pt, trace.sphere_table(big))
    k4_hit = torch.isfinite(k4_t)
    _, res1 = mk.trace_record(po, pd, pt, big, 3, 1, bvh=tables)
    want = torch.where(k4_hit, k4_i, mk.MISS)
    k8_differ = (res1.idx[0] != want).double().mean().item()
    k7_miss = mk.trace_paths(po, pd, pt, None, 3, 1, front=fronts["plain"]).sum(dim=1) > 0
    k7_differ = (k7_miss == k4_hit).double().mean().item()
    k7_k8 = rays_differ(mk.trace_paths(po, pd, pt, None, 3, 2, front=fronts["plain"]),
                        mk.trace_paths(po, pd, pt, big, 3, 2, bvh=tables))
    print(f"first hits, {po.shape[0]} primary rays x {N_LARGE} spheres against K4 "
          f"({int(k4_hit.sum())} hits): K5 bvh's winners differ on {k8_differ:.6f} of rays, K7's "
          f"hit mask on {k7_differ:.6f}; K7 vs K8 at depth 2 differ on {k7_k8:.6f}")
    check(bool(k4_hit.any()) and not bool(k4_hit.all()), "the pass has hits and misses")
    check(k8_differ <= 1e-3 and k7_differ <= 1e-3 and k7_k8 <= 1e-3,
          "first hits of K8 and K7 equal K4's on >= 99.9% of a pass's rays")

    # ---- L4. K7 against K8 against the chunked brute scan, depth 16 ----
    o16, d16, t16 = (x[::o.shape[0] // 16384][:16384].contiguous() for x in (o, d, t))
    deep = {"K8": mk.trace_paths(o16, d16, t16, big, 11, 16, bvh=tables),
            "brute": mk.trace_paths(o16, d16, t16, big, 11, 16)}
    for name, f in fronts.items():
        deep[f"K7 {name}"] = mk.trace_paths(o16, d16, t16, None, 11, 16, front=f)
    differ = {k: rays_differ(v, deep["brute"]) for k, v in deep.items() if k != "brute"}
    print(f"against the chunked brute scan ({N_LARGE} spheres, 16,384 rays, depth 16), share of "
          "rays that differ by > 1e-3: " + ", ".join(f"{k} {v:.6f}" for k, v in differ.items()))
    check(max(differ.values()) <= 1e-3, "K7, K8 and the chunked brute scan agree on >= 99.9%")
    del deep

    # ---- L5. the main path at full width ----
    def k7_render(scene_cpu, cam):
        """`render`'s pass loop with render_pass(front=) over the global-memory
        front of the same tree: the image through K7."""
        tr = build_bvh(scene_cpu, leaf_size=8)
        sc = reorder_scene(scene_cpu, tr).to(dev)
        hb = mk.front_tables_hbm(sc, tr)
        gen = torch.Generator(device=dev).manual_seed(0)
        derived = cam.derive(torch.float32, dev)
        acc = None
        for _ in range(cam.samples_per_pixel):
            out = render_pass(sc, derived, gen, width=w, height=h, max_depth=cam.max_depth,
                              spp_chunk=1, front=hb, raw_slots=True)
            acc = out if acc is None else acc + out
        return blocks_to_image(acc, w, h, 1) / cam.samples_per_pixel

    mk.reset_launches()
    img, frame_s = synced_s(lambda: render(big_cpu, ref_cam, settings=RenderSettings(use_bvh=True)))
    launches = dict(mk.LAUNCHES)
    print(f"large-scene main path: render(use_bvh=True) on {N_LARGE} spheres at 400x225, 30 spp, "
          f"depth 50: kernel launches {launches}; {frame_s:.4f} s, scene preparation included, "
          f"on {card}")
    check(launches["bvh"] == 30 and launches["front_hbm"] == 0 and launches["front"] == 0,
          "K8 ran once a pass of the large-scene frame")
    check(img.is_cuda and tuple(img.shape) == (225, 400, 3) and torch.isfinite(img).all().item(),
          "large-scene image on the card, finite, 225x400x3")
    mk.reset_launches()
    img7, frame7_s = synced_s(lambda: k7_render(big_cpu, ref_cam))
    launches["front_hbm"] = mk.LAUNCHES["front_hbm"]
    print(f"image means ({N_LARGE} spheres, 30 spp, depth 50): K8 render {img.mean().item():.5f}, "
          f"K7 passes {img7.mean().item():.5f} ({launches['front_hbm']} launches, "
          f"{frame7_s:.4f} s)")
    check(launches["front_hbm"] == 30, "K7 ran once a pass")
    check(abs(img.mean().item() - img7.mean().item()) <= 0.05 * img7.mean().item(),
          "K8 render mean within 5% of the K7 render's")
    frames = {}
    for n in (5000, 16000, N_LARGE):
        sc = big_cpu if n == N_LARGE else make_random_scene(n, seed=3)
        mk.reset_launches()
        a, frames[n] = synced_s(
            lambda: render(sc, bench_cam, settings=RenderSettings(use_bvh=True)))  # noqa: B023
        check(mk.LAUNCHES["bvh"] == 4, f"{n} spheres: K8 ran once a pass at the bench shape")
        b = k7_render(sc, bench_cam)
        check(torch.isfinite(a).all().item(), f"{n} spheres: image finite")
        check(abs(a.mean().item() - b.mean().item()) <= 0.05 * b.mean().item(),
              f"{n} spheres: K8 render mean within 5% of the K7 render's")
        print(f"render(use_bvh=True), {n} spheres, bench shape (4 spp, depth 16): "
              f"{frames[n]:.4f} s, mean {a.mean().item():.5f} (K7 {b.mean().item():.5f})")
    mk.reset_launches()
    a = render(make_random_scene(5000, seed=3), bench_cam, settings=RenderSettings(use_bvh=False))
    launches["brute_chunked"] = mk.LAUNCHES["brute_chunked"]
    check(launches["brute_chunked"] == 4 and torch.isfinite(a).all().item(),
          "render(use_bvh=False) on 5,000 spheres ran the chunked brute scan once a pass")

    # ---- L6. training at full width: K5 bvh, materials only ----
    train_cam = Camera(**COVER_CAMERA, samples_per_pixel=2, max_depth=50)
    target = render(big_cpu, dataclasses.replace(train_cam, samples_per_pixel=8),
                    torch.Generator(device=dev).manual_seed(5), settings)
    rng = torch.Generator().manual_seed(11)
    truth = reorder_scene(big_cpu, tree)  # on the CPU, in leaf order
    n = truth.num_spheres
    met, die = truth.mat_type == METAL, truth.mat_type == DIELECTRIC
    jitter = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(shape, generator=rng)  # noqa: E731
    start = dataclasses.replace(
        truth, albedo=torch.clamp(truth.albedo * jitter(0.7, 1.3, n, 3), 0.0, 1.0),
        fuzz=torch.where(met, torch.clamp(truth.fuzz + jitter(-0.1, 0.1, n), 0.0, 1.0), truth.fuzz),
        ior=torch.where(die, truth.ior * jitter(0.95, 1.05, n), truth.ior))
    trainable = ("albedo", "fuzz", "ior")
    params, opt, step = make_fast_train_step(start, train_cam, spp=2, learning_rate=1e-2,
                                             trainable=trainable, bvh=tree,
                                             generator=torch.Generator(device=dev).manual_seed(3))
    check(params.albedo.is_cuda, "large-scene train step: parameters on the card by default")
    p0 = SceneParams(*(x.detach().clone() for x in params))
    losses, times = [], []
    mk.reset_launches()
    for _ in range(TRAIN_STEPS):
        (params, opt, loss, grads), sec = synced_s(lambda: step(params, opt, None, target))
        losses.append(loss.item())
        times.append(sec)
        check(torch.isfinite(loss).item() and all(torch.isfinite(g).all().item() for g in grads),
              "large-scene train step: finite loss and gradients")
    launches["record_bvh"] = mk.LAUNCHES["record_bvh"]
    check(launches["record_bvh"] == TRAIN_STEPS, "K5 bvh ran once a train step")
    for f in SceneParams._fields:
        moved = not torch.equal(getattr(params, f).detach(), getattr(p0, f))
        check(moved == (f in trainable), f"large-scene train step: {f} "
              f"{'moves' if f in trainable else 'stays bit-unchanged'}")
    step_s = statistics.median(times[2:])
    print(f"train step, materials (K5 bvh), {N_LARGE} spheres, 400x225, 2 spp, depth 50: losses "
          + ", ".join(f"{x:.6f}" for x in losses)
          + f"; seconds per step (median of {len(times) - 2} warm) {step_s:.4f} s on {card}")
    so, sd, st, seed = step_rays(train_cam, torch.Generator(device=dev).manual_seed(4))
    start_dev = start.to(dev)
    rad, res = mk.trace_record(so, sd, st, start_dev, seed, 50, bvh=tables)
    with torch.no_grad():
        rp = replay_radiance(extract_params(start_dev), start_dev, so, sd, st, res)
    frac = (torch.abs(rp - rad).max(dim=1).values <= 2e-5).double().mean().item()
    print(f"replay (K5 bvh residuals of one step's {so.shape[0]} rays, depth 50): {frac:.6f} of "
          "rays within 2e-5 of the kernel's radiance")
    check(frac >= 0.998, "replay of K5 bvh's residuals: >= 99.8% within 2e-5")
    del rad, res, rp
    worst("record_bvh", hold_record(mk, f"one train step's rays, {N_LARGE} spheres", so, sd, st,
                                    start_dev, None, seed, 50, False, bvh=tables, exact=True))
    del so, sd, st
    # the chunked recording kernel on its own main path: geometry + albedo on 5,000 spheres
    five_cpu = make_random_scene(5000, seed=3)
    params, opt, step = make_fast_train_step(five_cpu, train_cam, spp=2, learning_rate=2e-3,
                                             trainable=("albedo", "center0", "radius"),
                                             generator=torch.Generator(device=dev).manual_seed(3))
    mk.reset_launches()
    geo_times = []
    for _ in range(TRAIN_STEPS):
        (params, opt, loss, grads), sec = synced_s(lambda: step(params, opt, None, target))
        geo_times.append(sec)
        check(torch.isfinite(loss).item(), "5,000-sphere geometry step: finite loss")
    launches["record_brute_chunked"] = mk.LAUNCHES["record_brute_chunked"]
    check(launches["record_brute_chunked"] == TRAIN_STEPS,
          "the chunked recording kernel ran once a step")
    geo_step_s = statistics.median(geo_times[2:])
    print(f"train step, geometry + albedo (the chunked recording kernel), 5,000 spheres, 400x225, "
          f"2 spp, depth 50: seconds per step (median of {len(geo_times) - 2} warm) "
          f"{geo_step_s:.4f} s on {card}")
    del params, opt, step, grads, target

    # ---- L7. times: the bench shape on three scene sizes, then one pass's shape ----
    print(f"large-scene times: CUDA events, warm, {n_rays} camera rays, depth 16; host seconds on "
          f"{N_LARGE} spheres: build_bvh {host['build_bvh']:.4f}, front_tables_hbm "
          f"{host['front_tables_hbm']:.4f}; on {card}")

    def kernel_ms(rays, sc, tb, fr) -> dict:
        """Milliseconds of every large-scene kernel on `rays` at depth 16."""
        routes = {"bvh": (False, dict(bvh=tb)), "brute_chunked": (False, {}),
                  "record_bvh": (True, dict(bvh=tb)), "record_brute_chunked": (True, {})}
        routes.update({f"front_hbm {k}": (False, dict(front=v)) for k, v in fr.items()})
        ms = {}
        for name, (rec, route) in routes.items():
            fn = mk.trace_record if rec else mk.trace_paths

            def kern():
                fn(*rays, sc, 99, 16, **route)  # noqa: B023

            kern()
            ms[name] = cuda_ms(kern, 5)
        return ms

    for n in (5000, 16000, N_LARGE):
        if n == N_LARGE:
            sc, tb, fr = big, tables, fronts
        else:
            cpu = make_random_scene(n, seed=3)
            tr = build_bvh(cpu, leaf_size=8)
            sc = reorder_scene(cpu, tr).to(dev)
            tb = mk.bvh_tables(tr, dev)
            fr = {"plain": mk.front_tables_hbm(sc, tr)}
            fr["word_earlyout"] = dataclasses.replace(fr["plain"], word_earlyout=True)
            fr["sub_block"] = mk.front_tables_hbm(sc, tr, max_nodes=max(24, n // 104 // 24 * 24),
                                                  sub_block=True)
        print(f"{n} spheres: " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in kernel_ms((o, d, t), sc, tb, fr).items())
              + f"; K7 front {fr['plain'].ff.shape[1]} subtrees")
    # The kernels' entries: kernel and plain version on the rays of one pass of the frame (the
    # shape `render` gives K7 and K8: 400x225 at 1 spp in slot order), depth 16, 50,000
    # spheres: the plain versions take minutes at the bench shape. Bounds from the tests
    # counted in the plain versions on every 11th of those rays, scaled.
    rays1 = _slot_rays(ref_cam.derive(torch.float32, dev), w, h, 1,
                       torch.Generator(device=dev).manual_seed(1), None)
    n1 = w * h
    step1 = rays1[0].shape[0] // N_LARGE_CMP
    sub1 = tuple(x[::step1][:N_LARGE_CMP].contiguous() for x in rays1)
    scale = n1 / N_LARGE_CMP
    ms = kernel_ms(rays1, big, tables, fronts)
    print(f"{N_LARGE} spheres, one pass ({n1} camera rays, depth 16): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    chunked_blocks(mk, mk.trace_record(*rays1, big, 99, 16)[1].idx, big.num_spheres,
                   ms["brute_chunked"], card)
    entries, counted = [], {}
    for key in ("brute_chunked", "record_brute_chunked", "bvh", "record_bvh", "front_hbm"):
        name = "front_hbm plain" if key == "front_hbm" else key
        front = fronts["plain"] if key == "front_hbm" else None
        tree_k = tables if "bvh" in key else None
        twin = mk.trace_record_twin if key.startswith("record") else mk.trace_paths_twin
        kept = []
        plain_ms = cuda_ms(
            lambda: kept.append(twin(*rays1, big, 99, 16, front=front, bvh=tree_k)),  # noqa: B023
            1)
        if key.startswith("record"):  # every one bit-equal
            worst(key, hold_record(mk, f"one pass's rays, {N_LARGE} spheres", *rays1, big, None,
                                   99, 16, False, bvh=tree_k, twin=kept[0], exact=True))
        else:
            worst(key, hold_large(mk, f"{key} (one pass's rays, {N_LARGE} spheres)", key, *rays1,
                                  big, 99, 16, twin=kept[0], exact=True, front=front,
                                  bvh=tree_k))
        del kept
        if key == "front_hbm":  # K7's options on the same rays, bit-equal too
            for opt in ("word_earlyout", "sub_block"):
                worst(key, hold_large(mk, f"front_hbm {opt} (one pass's rays, {N_LARGE} "
                                      "spheres)", key, *rays1, None, 99, 16, exact=True,
                                      front=fronts[opt]))
        route = "bvh" if tree_k is not None else "front" if front is not None else "brute"
        if route not in counted:  # a recording kernel's rays need what its forward's do
            counted[route] = count_tests(mk, *sub1, big, front, 99, 16, bvh=tree_k)
        counts = {k: v * scale for k, v in counted[route].items()}
        tab_bytes = 64 * big.num_spheres
        if front is not None:
            tab_bytes = 4 * sum(x.numel() for x in (front.sph, front.ff, front.fi, front.wf,
                                                    front.sf))
        elif tree_k is not None:
            tab_bytes += 4 * tables.nodes.numel()
        b_ms, b_by = megakernel_bound(counts, n1, 16, tab_bytes, key.startswith("record"))
        print(f"{key}: kernel {ms[name]:.3f} ms, plain version {plain_ms:.1f} ms (one run); these "
              f"rays need about {({k: round(v) for k, v in counts.items()})} (counted on every "
              f"{step1}th ray, scaled by {scale:.2f}); bound {b_ms:.4f} ms by {b_by}, the kernel "
              f"reaches {b_ms / ms[name]:.3f} of it")
        print_yardstick(key, counts, ms[name], lambda c: megakernel_bound(  # noqa: B023
            c, n1, 16, tab_bytes, key.startswith("record")))  # noqa: B023
        entries.append({
            "name": f"megakernel_{key}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[key], "launches": launches[key],
            "max_abs_err": max_err[key], "ms": ms[name], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "pairs": counts["pairs"],
        })
    print(f"seconds per frame (render: K8, {N_LARGE} spheres, 400x225, 30 spp, depth 50) "
          f"{frame_s:.4f} s; through K7 passes {frame7_s:.4f} s; bench-shape frames " +
          ", ".join(f"{n} spheres {s:.4f} s" for n, s in frames.items()) +
          f"; train step (K5 bvh) {step_s:.4f} s; 5,000-sphere geometry step (chunked) "
          f"{geo_step_s:.4f} s; on {card}")
    return entries


def front_occupancy(lib, regs: dict, front, what: str, card: str) -> None:
    """The twelve front instantiations' registers, spill stores and stack
    frame as -Xptxas -v reported them, and the blocks of 256 threads one SM
    holds with the shared memory of `front`'s tables (the forward kinds
    with options: and its sub-block boxes; the front segments: and the
    live list), as the launch gets them."""
    from raytracingproject_tpu_torch.ops.cuda import build
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk

    tables = (front.sph.shape[1], front.ff.shape[1], front.wf.shape[1], front.sf.shape[1])
    table_bytes = 4 * sum(x.numel() for x in (front.sph, front.ff, front.fi, front.wf, front.sf))
    for rec, miss, seg, opt in FRONT_KINDS:
        key, blocks = (1, rec, miss, seg, opt), ctypes.c_int()
        n_bf = 0 if front.bf is None or rec or seg or not opt else front.bf.shape[1]
        head = (f"  {instantiation(key)}: {regs[key][0]} registers, {regs[key][1]} B spill "
                f"stores, {regs[key][2]} B stack frame")
        if table_bytes + 32 * n_bf + (mk.SEGMENT_LIST_BYTES if seg else 0) > mk.SMEM_BUDGET_BYTES:
            print(f"{head}; its live list does not fit beside {what}'s tables")
            continue
        build.check(lib.rtp_front_blocks_per_sm(*tables, n_bf, rec, miss, seg, int(opt > 0),
                                                ctypes.byref(blocks)), "occupancy")
        print(f"{head}, {blocks.value} blocks of 256 threads per SM ({what}); on {card}")


def instantiation(key) -> str:
    mode, record, miss, seg, opt = key
    return (f"trace_kernel<{MODES[mode]}{', record' if record else ''}"
            f"{', record_miss' if miss else ''}{', segment' if seg else ''}{OPTS[opt]}>")


def hold_state(what: str, k, p, exact: bool = False) -> float:
    """One K6 launch against its plain version on the same carried state:
    every state plane of >= 99.9% of rays within 1e-3 (and, recording,
    residual idx equal on >= 99.9% of entries, ndir and refl equal where
    idx is); with `exact` (the chunked scan) all of it bit-equal. Returns
    the max |diff| over the radiance, throughput and miss planes and the
    ndir where idx is equal."""
    import torch

    (k, kres), (p, pres) = (k, p) if isinstance(k, tuple) else ((k, None), (p, None))
    diff = torch.abs(k - p)
    frac = (diff <= 1e-3).all(dim=0).double().mean().item()
    err = diff[7:].max().item()  # throughput, radiance, alive (and the miss planes)
    line = f"{what}: {frac:.6f} of rays within 1e-3 on every plane, bit-equal {torch.equal(k, p)}"
    if kres is not None:
        eq = kres[0] == pres[0]
        nd = max(torch.abs(a - b)[eq].max().item() for a, b in zip(kres[1:4], pres[1:4]))
        refl_ok = torch.equal(kres[4][eq], pres[4][eq])
        idx_frac = eq.double().mean().item()
        line += (f"; residual idx equal {idx_frac:.6f}, max |ndir diff| there {nd:.3e}, refl "
                 f"equal there {refl_ok}")
        check(idx_frac >= 0.999 and nd == 0.0 and refl_ok,
              f"{what}: residuals equal to the plain version's")
        err = max(err, nd)
    print(line)
    check(torch.isfinite(k).all().item(), f"{what}: state finite")
    check(frac >= 0.999, f"{what}: >= 99.9% of rays within 1e-3 of the plain version")
    if exact:
        same = torch.equal(k, p) and (kres is None
                                      or all(torch.equal(a, b) for a, b in zip(kres, pres)))
        check(same, f"{what}: bit-equal to the plain version")
    return err


def hold_segments(mk, dt, what: str, rays, scene, front, seed: int, cut: int, depth: int,
                  record_miss: bool, record: bool, timed: bool = False, exact: bool = False):
    """K6 against its plain version on the two segments of a two-phase
    trace of `rays` (bounces [0, cut) from the camera rays, then [cut,
    depth) on the rays packed alive-first after the cut), each from the
    same input for both. Returns (max |diff|, kernel ms of the two
    segments, plain ms of the two) with `timed`, else the max |diff|."""
    kw = dict(front=front, record_miss=record_miss, record=record)
    state, slot = dt.initial_state(*rays, record_miss)
    err, ms, plain_ms = 0.0, [], []
    for b0, n in ((0, cut), (cut, depth - cut)):
        k = mk.segment_call(state, slot, scene, seed, b0, n, **kw)
        p = mk.segment_twin(state, slot, scene, seed, b0, n, **kw)
        err = max(err, hold_state(f"{what}, bounces [{b0}, {b0 + n}) of {slot.shape[0]} rays",
                                  k, p, exact))
        if timed:
            ms.append(cuda_ms(lambda: mk.segment_call(state, slot, scene, seed, b0, n, **kw),  # noqa: B023
                              10))
            plain_ms.append(cuda_ms(lambda: mk.segment_twin(state, slot, scene, seed, b0, n,  # noqa: B023
                                                            **kw), 1))
        state = k[0] if record else k
        src, _, _ = dt.alive_first_perm(state[mk.ST_ALIVE])
        state, slot = dt.take_ray_rows(state, src, dim=1), dt.take_ray_rows(slot, src)
    return (err, ms, plain_ms) if timed else err


def segment_counts(mk, dt, rays, scene, front, seed: int, cut: int, depth: int) -> dict:
    """The tests a two-phase trace of `rays` needs, counted in K6's plain
    version (`counting_hit`), over both segments."""
    counts = {"bounces": 0, "pairs": 0, "roots": 0, "boxes": 0}
    state, slot = dt.initial_state(*rays)
    tables = counting_hit(mk, scene, front, None, state.device, counts)
    original = mk.twin_closest_hit
    mk.twin_closest_hit = lambda *args: tables
    try:
        for b0, n in ((0, cut), (cut, depth - cut)):
            state = mk.segment_twin(state, slot, scene, seed, b0, n, front=front)
            src, _, _ = dt.alive_first_perm(state[mk.ST_ALIVE])
            state, slot = dt.take_ray_rows(state, src, dim=1), dt.take_ray_rows(slot, src)
    finally:
        mk.twin_closest_hit = original
    return counts


def warp_bounces(idx, cut: int, src, row: int, warp: int = 32) -> dict:
    """Bounces paid per warp over bounces needed, from a monolithic
    record's idx [D, R] (a ray runs its non-DEAD bounces; a warp's loop
    runs while any of its rays does, so each of its 32 lanes pays the
    warp's most): monolithic; the two-phase pipeline with a cut at `cut`
    (phase 1 pays up to `cut`, phase 2 the rest over the rays packed by
    `src` in rows of `row`); and phase 2 alone, unpacked and packed."""
    import torch

    b = (idx != -2).sum(dim=0).double()  # bounces each ray runs
    n = b.shape[0] - b.shape[0] % warp

    def paid(x):
        return warp * x[:n].reshape(-1, warp).max(dim=1).values.sum().item()

    tail = torch.clamp_min(b - cut, 0.0)
    packed = tail.reshape(-1, row)[src.long()].reshape(-1)
    return {"monolithic": paid(b) / b.sum().item(),
            "two-phase": (paid(torch.clamp_max(b, cut)) + paid(packed)) / b.sum().item(),
            "tail unpacked": paid(tail) / max(tail.sum().item(), 1.0),
            "tail packed": paid(packed) / max(tail.sum().item(), 1.0),
            "mean bounces": b.mean().item(),
            "alive after the cut": (tail > 0).double().mean().item()}


def pipeline_times(mk, dt, rays, scene, front, depth: int, rows, segmented: bool):
    """(ms, paid) of the pipelines on `rays` to `depth`, CUDA events, warm:
    the monolithic kernel (first and last), two-phase with a cut at 4 at
    each row width of `rows` and, with `segmented`, segments of 8 bounces;
    paid[row] is `warp_bounces` of the two-phase packing at that width. A
    brute two-phase trace is checked bit-equal to the monolithic one."""
    import torch

    def mono():
        return mk.trace_paths(*rays, scene, 47, depth, front=front)

    want = mono()
    t_ms = {"monolithic": cuda_ms(mono, 5)}
    _, res = mk.trace_record(*rays, scene, 47, depth, front=front)
    chosen, paid = dt.ROW_WIDTH, {}
    try:
        for row in rows:
            dt.ROW_WIDTH = row

            def two():
                return dt.trace_paths_twophase(*rays, scene, 47, depth, cuts=(4,), front=front)

            got = two()
            check(front is not None or torch.equal(got, want),
                  f"brute two-phase with {row}-ray rows bit-equal to the monolithic kernel")
            t_ms[f"two-phase 4 ({row}-ray rows)"] = cuda_ms(two, 5)
            st0, slot0 = dt.initial_state(*rays)
            alive = mk.segment_call(st0, slot0, scene, 47, 0, 4, front=front)[mk.ST_ALIVE]
            src, _, _ = dt.alive_first_perm(alive)
            idx = torch.cat([res.idx, torch.full((depth, st0.shape[1] - rays[0].shape[0]),
                                                 mk.DEAD, dtype=res.idx.dtype,
                                                 device=res.idx.device)], dim=1)
            paid[row] = warp_bounces(idx, 4, src, row)
    finally:
        dt.ROW_WIDTH = chosen
    if segmented:
        def seg():
            return dt.trace_paths_segmented(*rays, scene, 47, depth, seg_len=8, front=front)

        seg()
        t_ms["segmented 8"] = cuda_ms(seg, 5)
    t_ms["monolithic, again"] = cuda_ms(mono, 5)
    return t_ms, paid


def compaction_ms(mk, dt, rays, scene) -> float:
    """CUDA-event ms of one compaction at dt.ROW_WIDTH (alive_first_perm and
    the gathers of the 14 state planes and the slots) after 4 bounces."""
    st0, slot0 = dt.initial_state(*rays)
    st0 = mk.segment_call(st0, slot0, scene, 47, 0, 4)

    def compact():
        src, _, _ = dt.alive_first_perm(st0[mk.ST_ALIVE])
        return dt.take_ray_rows(st0, src, dim=1), dt.take_ray_rows(slot0, src)

    compact()
    return cuda_ms(compact, 20)


def row_widths(mk, card: str) -> None:
    """The measurement behind depth_tail.ROW_WIDTH, run by `python3
    chip_smoke.py --row-widths` (not by the default run): on the cover
    scene, brute and front, at the bench shape and on one pass at depth 50,
    the two-phase trace (cut 4) with one-ray and with 32-ray rows beside
    the monolithic kernel, the bounces each packing makes a warp pay, and
    the compaction alone at each width."""
    import torch

    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt
    from raytracingproject_tpu_torch.render import _slot_rays
    from raytracingproject_tpu_torch.scene import make_cover_scene

    dev = torch.device("cuda")
    cover = make_cover_scene(0)
    tree = build_bvh(cover, leaf_size=8)
    scene = reorder_scene(cover, tree).to(dev)
    front = mk.front_tables(scene, tree, order_point=COVER_CAMERA["lookfrom"], repack=1)
    cam = Camera(**COVER_CAMERA, samples_per_pixel=4, max_depth=16)
    w, h = cam.image_size()
    derived = cam.derive(torch.float32, dev)
    shapes = (("bench shape", _slot_rays(derived, w, h, 4, torch.Generator(device=dev)
                                         .manual_seed(1), None), 16),
              ("one pass, depth 50", _slot_rays(derived, w, h, 1, torch.Generator(device=dev)
                                                .manual_seed(31), None), 50))
    print(f"row widths of the two-phase compaction (chosen: {dt.ROW_WIDTH}); CUDA events, warm, "
          f"on {card}")
    for name, rays, depth in shapes:
        for path in ("brute", "front"):
            t_ms, paid = pipeline_times(mk, dt, rays, scene, front if path == "front" else None,
                                        depth, (1, 32), segmented=False)
            print(f"{path}, {name} ({rays[0].shape[0]} rays, depth {depth}): "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in t_ms.items())
                  + "; bounces paid per warp over bounces needed, two-phase: "
                  + ", ".join(f"{row}-ray rows {p['two-phase']:.3f} (tail packed "
                              f"{p['tail packed']:.3f})" for row, p in paid.items())
                  + f"; monolithic {paid[1]['monolithic']:.3f}")
        chosen = dt.ROW_WIDTH
        comp = {}
        try:
            for row in (1, 32):
                dt.ROW_WIDTH = row
                comp[row] = compaction_ms(mk, dt, rays, scene)
        finally:
            dt.ROW_WIDTH = chosen
        print(f"compaction ({name}, {rays[0].shape[0]} rays): "
              + ", ".join(f"{row}-ray rows {v:.4f} ms" for row, v in comp.items()))


def depth_tail(mk, card: str) -> list[dict]:
    """The depth-tail path (two-phase and segmented tracing through K6, and
    K1's record_miss for sky textures): each K6 instantiation and each
    record_miss kernel against its plain version at its path's shapes; the
    pipelines against the monolithic kernels; the main paths through
    `render` and `make_fast_train_step(two_phase=)` at full width with
    their launch counts; times and bounds. Returns the `kernels` entries
    of the 14 new kernels."""
    import statistics

    import torch

    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.grad import (
        SceneParams, extract_params, make_fast_radiance, make_fast_radiance_twophase,
        make_fast_train_step, replay_radiance_twophase,
    )
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt
    from raytracingproject_tpu_torch.render import (
        _slot_rays, blocks_to_image, prepare_scene, render, render_pass, sky_color,
    )
    from raytracingproject_tpu_torch.scene import make_cover_scene, make_random_scene

    dev = torch.device("cuda")
    ref_cam = Camera(**COVER_CAMERA, samples_per_pixel=30, max_depth=50)
    bench_cam = Camera(**COVER_CAMERA, samples_per_pixel=4, max_depth=16)
    train_cam = Camera(**COVER_CAMERA, samples_per_pixel=2, max_depth=50)
    w, h = ref_cam.image_size()
    cover_cpu = make_cover_scene(0)
    tree = build_bvh(cover_cpu, leaf_size=8)
    scene = reorder_scene(cover_cpu, tree).to(dev)
    front = mk.front_tables(scene, tree, order_point=COVER_CAMERA["lookfrom"], repack=1)
    # the chunked scan's own scene: past the shared-memory budget, five staged chunks
    five_cpu = make_random_scene(5000, seed=3)
    five = five_cpu.to(dev)
    check(4 * five.num_spheres * mk.N_ROWS > mk.SMEM_BUDGET_BYTES
          and five.num_spheres > 4 * CHUNK, "5,000 spheres take the chunked scan, 5 chunks")
    scenes = {"brute": scene, "brute_chunked": five, "front": scene}
    rays1 = _slot_rays(ref_cam.derive(torch.float32, dev), w, h, 1,
                       torch.Generator(device=dev).manual_seed(31), None)  # one pass: 90,112
    n1 = rays1[0].shape[0]
    bench = _slot_rays(bench_cam.derive(torch.float32, dev), w, h, 4,
                       torch.Generator(device=dev).manual_seed(1), None)  # 360,000 (+ pad)
    max_err: dict[str, float] = {}
    ms: dict[str, float] = {}
    plain_ms: dict[str, float] = {}
    bounds: dict[str, tuple[float, str]] = {}
    pairs_of: dict[str, float] = {}

    def worst(key, err):
        max_err[key] = max(max_err.get(key, 0.0), err)

    # ---- D1. K6 against its plain version: a pass's rays, cut 4 then 12 bounces; a step's
    # 180,000 rays, cut 4 then 46 (recording). The chunked segments on 5,000 spheres ----
    cut, depth = 4, 16
    so, sd, st, s_seed = step_rays(train_cam, torch.Generator(device=dev).manual_seed(4))
    seg_counts = {scan: segment_counts(mk, dt, rays1, sc, front if scan == "front" else None,
                                       41, cut, depth) for scan, sc in scenes.items()}
    for scan, sc in scenes.items():
        f = front if scan == "front" else None
        for kind in ("", "miss_", "record_"):
            key = f"segment_{kind}{scan}"
            miss, record = kind == "miss_", kind == "record_"
            before = mk.LAUNCHES[launch_key(key)]
            exact = True  # the redesigned closest hits: the chunked scan, the front segment
            err, k_ms, p_ms = hold_segments(mk, dt, key, rays1, sc, f, 41, cut, depth, miss,
                                            record, timed=True, exact=exact)
            check(mk.LAUNCHES[launch_key(key)] > before,
                  f"{key}: the segments launched {launch_key(key)}")
            worst(key, err)
            if record:
                worst(key, hold_segments(mk, dt, f"{key} (a train step's rays)", (so, sd, st),
                                         sc, f, s_seed, cut, 50, False, True, exact=exact))
            ms[key], plain_ms[key] = sum(k_ms), sum(p_ms)
            counts = seg_counts[scan]
            rows = mk.STATE_ROWS + (mk.MISS_ROWS if miss else 0)
            tab_bytes = 4 * (sc.num_spheres * mk.N_ROWS if f is None
                             else f.sph.numel() + f.ff.numel())
            nbytes = 2 * (n1 * (8 * rows + 4) + tab_bytes) + (n1 * depth * 17 if record else 0)
            bounds[key] = bound(test_ops(counts),
                                nbytes)
            pairs_of[key] = counts["pairs"]
            print(f"{key}: kernel {k_ms[0]:.3f} + {k_ms[1]:.3f} ms (bounces [0, {cut}) of {n1} "
                  f"rays, then [{cut}, {depth}) packed), plain version {p_ms[0]:.1f} + "
                  f"{p_ms[1]:.1f} ms; these rays need {counts}; bound {bounds[key][0]:.4f} ms "
                  f"by {bounds[key][1]}, the kernel reaches {bounds[key][0] / ms[key]:.3f} of "
                  f"it; on {card}")
            print_yardstick(key, counts, ms[key],
                            lambda c: bound(test_ops(c), nbytes))  # noqa: B023
    del so, sd, st

    # ---- D2. two-phase and segmented against monolithic on the card, Philox draws ----
    for path, sc in scenes.items():
        f = front if path == "front" else None
        mono = mk.trace_paths(*rays1, sc, 43, 50, front=f)
        runs = {"two-phase cut 4": dict(cuts=(4,)), "two-phase cuts 2 and 6": dict(cuts=(2, 6))}
        outs = {k: dt.trace_paths_twophase(*rays1, sc, 43, 50, front=f, **kw)
                for k, kw in runs.items()}
        outs["segmented, 8 bounces"] = dt.trace_paths_segmented(*rays1, sc, 43, 50, seg_len=8,
                                                                front=f)
        rad_m, res_m = mk.trace_record(*rays1, sc, 43, 50, front=f)
        rad2, res1, res2, _, dest, n_alive = dt.trace_record_twophase(*rays1, sc, 43, 50, cut=4,
                                                                      front=f)
        outs["two-phase record (radiance)"] = rad2
        back = [dt.take_ray_rows(x, dest, dim=1)[:, :n1] for x in res2]
        idx = torch.cat([res1.idx[:, :n1], back[0]])
        nd = torch.stack([torch.cat([a[:, :n1], b]) for a, b in zip(res1[1:4], back[1:4])], -1)
        refl = torch.cat([res1.refl[:, :n1], back[4]])
        same_rays = ((idx == res_m.idx) & (refl == res_m.refl)).all(dim=0)
        same_rays &= (nd == res_m.ndir).all(dim=2).all(dim=0)
        line = ", ".join(f"{k} {rays_differ(v, mono):.6f} (bit-equal {torch.equal(v, mono)})"
                         for k, v in outs.items())
        frac = same_rays.double().mean().item()
        print(f"{path} ({sc.num_spheres} spheres), one pass ({n1} rays), depth 50, philox: share "
              f"of rays differing from the monolithic kernel by > 1e-3: {line}; two-phase "
              f"residuals, unpermuted, equal the monolithic record's on {frac:.6f} of rays; "
              f"{int(n_alive)} rows of {dt.ROW_WIDTH} alive after the cut")
        # bit-equal on every scan: the front segment and monolithic K3 both compute their
        # plain version's closest hit (per-ray culling, the first minimum in column order)
        for k, v in outs.items():
            check(torch.equal(v, mono), f"{path} {k} bit-equal to the monolithic kernel")
        check(frac == 1.0, f"{path}: two-phase residuals equal the monolithic record's")
        check(bool((res2.idx[:, int(n_alive) * dt.ROW_WIDTH:] == mk.DEAD).all()),
              f"{path}: packed rows past n_alive all DEAD")
    del outs, res_m, res1, res2, back, idx, nd, refl

    # ---- D3. record_miss on the five monolithic closest hits, each on its path's scene: the
    # cover scene, 5,000 spheres for the chunked scan, 50,000 for K7 (super-words) ----
    big_cpu = make_random_scene(N_LARGE, seed=3)
    big_tree = build_bvh(big_cpu, leaf_size=8)
    big = reorder_scene(big_cpu, big_tree).to(dev)
    hbm = mk.front_tables_hbm(big, big_tree)
    check(hbm.ff.shape[1] > 576, f"the {N_LARGE}-sphere K7 front has super-words")
    routes = {"brute": (scene, {}), "brute_chunked": (five, {}), "front": (scene, dict(front=front)),
              "bvh": (scene, dict(bvh=tree)), "front_hbm": (big, dict(front=hbm))}
    for name, (sc, kw) in routes.items():
        key = f"{name}_miss"
        plain = mk.trace_paths(*rays1, sc, 45, 16, **kw)
        before = mk.LAUNCHES[launch_key(key)]
        rad, mdir, mthr = mk.trace_paths(*rays1, sc, 45, 16, record_miss=True, **kw)
        torch.cuda.synchronize()
        check(mk.LAUNCHES[launch_key(key)] == before + 1, f"{key}: one launch")
        ident = torch.abs(rad + mthr * sky_color(mdir) - plain).max().item()
        kept = []
        p_ms = cuda_ms(lambda: kept.append(mk.trace_paths_twin(  # noqa: B023
            *rays1, sc, 45, 16, record_miss=True, **kw)), 1)  # noqa: B023
        diffs = [torch.abs(a - b) for a, b in zip((rad, mdir, mthr), kept[0])]
        frac = min((d <= 1e-3).all(dim=1).double().mean().item() for d in diffs)
        never = (mdir == 0).all(dim=1)
        bit = all(torch.equal(a, b) for a, b in zip((rad, mdir, mthr), kept[0]))
        print(f"{key} ({sc.num_spheres} spheres): rad + mthr * sky(mdir) against the kernel "
              f"without miss recording: max |diff| {ident:.3e}; against the plain version "
              f"{frac:.6f} of rays within 1e-3 (bit-equal {bit}); "
              f"{never.double().mean().item():.4f} of rays never missed")
        check(ident <= 2e-6, f"{key}: the miss planes rebuild the kernel's sky within 2e-6")
        check(bit, f"{key}: bit-equal to the plain version")
        check(frac >= 0.999, f"{key}: >= 99.9% of rays within 1e-3 of the plain version")
        check(bool((mthr[never] == 0).all()), f"{key}: never-missed planes are 0")
        worst(key, max(d.max().item() for d in diffs))
        ms[key] = cuda_ms(lambda: mk.trace_paths(*rays1, sc, 45, 16, record_miss=True,  # noqa: B023
                                                 **kw), 10)  # noqa: B023
        if name == "bvh":  # the tree passed on every call, as render_pass does, against its records
            built = mk.bvh_tables(tree, dev)
            r_ms = cuda_ms(lambda: mk.trace_paths(*rays1, sc, 45, 16, record_miss=True,
                                                  bvh=built), 10)  # noqa: B023
            print(f"{key}: {ms[key]:.4f} ms with the FlatBVH passed on every call, {r_ms:.4f} ms "
                  f"with its node records (built once per tree either way)")
        plain_ms[key] = p_ms
        step = 1 if name in ("brute", "brute_chunked", "front") else 11  # walks: a subset
        sub = tuple(x[::step].contiguous() for x in rays1)
        counts = count_tests(mk, *sub, sc, kw.get("front"), 45, 16, bvh=kw.get("bvh"))
        counts = {k: v * step for k, v in counts.items()}
        f = kw.get("front")
        tab_bytes = (4 * sum(x.numel() for x in (f.sph, f.ff, f.fi, f.wf, f.sf))
                     if f is not None else 64 * sc.num_spheres)
        if name == "bvh":
            tab_bytes += 4 * mk.bvh_tables(tree, dev).nodes.numel()
        # the rays read and the radiance written (40 B), the miss planes written (24 B)
        b_ms, b_by = bound(test_ops(counts),
                           n1 * 64 + tab_bytes)
        bounds[key] = (b_ms, b_by)
        pairs_of[key] = counts["pairs"]
        print(f"{key}: kernel {ms[key]:.3f} ms, plain version {p_ms:.1f} ms ({n1} rays, depth "
              f"16, {sc.num_spheres} spheres); these rays need about "
              f"{({k: round(v) for k, v in counts.items()})}; bound {b_ms:.4f} ms by {b_by}, the "
              f"kernel reaches {b_ms / ms[key]:.3f} of it")
        print_yardstick(key, counts, ms[key],
                        lambda c: bound(test_ops(c), n1 * 64 + tab_bytes))  # noqa: B023
        del kept, plain, rad, mdir, mthr
    del big, hbm

    # ---- D4. the paths at full width, each launch counted ----
    gen = torch.Generator().manual_seed(12)
    tex = torch.rand((256, 512, 3), generator=gen)  # a linear equirect environment, on the CPU
    launches: dict[str, int] = {}

    def run(name, fn, want: dict):
        """fn() with the launch counts it adds: exactly `want` of each named
        label's kernel (`launch_key`), none of any other K6 or record_miss
        kernel."""
        before = dict(mk.LAUNCHES)
        img, sec = synced_s(fn)
        got = {k: v - before[k] for k, v in mk.LAUNCHES.items() if v != before[k]}
        print(f"{name}: launches {got}, mean {img.mean().item():.5f}, {sec:.4f} s on {card}")
        watched = {k for k in mk.LAUNCHES if k.startswith("segment_") or k.endswith("_miss")}
        check({k: v for k, v in got.items() if k in watched}
              == {launch_key(k): v for k, v in want.items()},
              f"{name}: launches {want} of the depth-tail kernels")
        check(torch.isfinite(img).all().item() and tuple(img.shape) == (h, w, 3),
              f"{name}: image finite, {h}x{w}x3")
        for k, v in want.items():
            launches[k] = launches.get(k, 0) + v
        return img, sec

    def settings(**kw):
        return RenderSettings(**kw)  # no device: the card

    def pixels_differ(a, b):
        return (torch.abs(a - b) > 1e-3).any(dim=2).double().mean().item()

    def frame(cam, sc=cover_cpu, sky=None, **kw):
        return lambda: render(sc, cam, settings=settings(**kw), sky_texture=sky)

    def passes(cam):
        """render()'s sample chunks for `cam` (rays_per_batch of them at most)."""
        spp = cam.samples_per_pixel
        return -(-spp // max(1, min(spp, RenderSettings().rays_per_batch // (w * h))))

    p_ref, p_bench = passes(ref_cam), passes(bench_cam)
    mk.reset_launches()
    frames = {}
    frames["front"] = run("frame, front (monolithic)", frame(ref_cam, use_bvh=True), {})
    frames["front two-phase 4"] = run("frame, front, two_phase=4",
                                      frame(ref_cam, use_bvh=True, two_phase=4),
                                      {"segment_front": 2 * p_ref})
    frames["front segmented 8"] = run("frame, front, depth_segment=8",
                                      frame(ref_cam, use_bvh=True, depth_segment=8),
                                      {"segment_front": 7 * p_ref})
    frames["brute"] = run("frame, brute (monolithic)", frame(ref_cam, use_bvh=False), {})
    frames["brute two-phase 4"] = run("frame, brute, two_phase=4",
                                      frame(ref_cam, use_bvh=False, two_phase=4),
                                      {"segment_brute": 2 * p_ref})
    frames["front sky"] = run("frame, front, sky texture", frame(ref_cam, sky=tex, use_bvh=True),
                              {"front_miss": p_ref})
    frames["front two-phase 4 sky"] = run(
        "frame, front, two_phase=4, sky texture",
        frame(ref_cam, sky=tex, use_bvh=True, two_phase=4), {"segment_miss_front": 2 * p_ref})
    # Slot-keyed draws: a pipeline's frame is the monolithic frame bit for bit, on the brute
    # scan and on the front (both cull per ray, D2).
    check(torch.equal(frames["brute two-phase 4"][0], frames["brute"][0]),
          "brute two_phase=4 frame bit-equal to the monolithic frame")
    for k, m in (("front two-phase 4", "front"), ("front segmented 8", "front"),
                 ("front two-phase 4 sky", "front sky")):
        share = pixels_differ(frames[k][0], frames[m][0])
        print(f"{k}: {share:.6f} of pixels differ from the monolithic frame by > 1e-3")
        check(torch.equal(frames[k][0], frames[m][0]), f"{k}: bit-equal to the monolithic frame")
    check(abs(frames["front sky"][0].mean().item() - frames["front"][0].mean().item()) > 1e-3,
          "the texture changes the frame")
    # the other record_miss and K6 kernels on their own routes, at the bench shape
    bench_frames = {}
    bench_frames["brute sky"] = run("bench shape, brute, sky texture",
                                    frame(bench_cam, sky=tex, use_bvh=False),
                                    {"brute_miss": p_bench})
    bench_frames["brute two-phase sky"] = run(
        "bench shape, brute, two_phase=4, sky texture",
        frame(bench_cam, sky=tex, use_bvh=False, two_phase=4), {"segment_miss_brute": 2 * p_bench})
    bench_frames["5000 chunked"] = run("bench shape, 5,000 spheres, brute (chunked)",
                                       frame(bench_cam, sc=five_cpu, use_bvh=False), {})
    bench_frames["5000 chunked two-phase"] = run(
        "bench shape, 5,000 spheres, brute (chunked), two_phase=4",
        frame(bench_cam, sc=five_cpu, use_bvh=False, two_phase=4),
        {"segment_brute_chunked": 2 * p_bench})
    bench_frames["5000 chunked sky"] = run(
        "bench shape, 5,000 spheres, brute (chunked), sky texture",
        frame(bench_cam, sc=five_cpu, sky=tex, use_bvh=False), {"brute_chunked_miss": p_bench})
    bench_frames["5000 chunked two-phase sky"] = run(
        "bench shape, 5,000 spheres, brute (chunked), two_phase=4, sky texture",
        frame(bench_cam, sc=five_cpu, sky=tex, use_bvh=False, two_phase=4),
        {"segment_miss_brute_chunked": 2 * p_bench})
    tex_dev = tex.to(dev)

    def k8_sky_frame():
        """`render`'s pass loop through render_pass(bvh=, sky_tex=): K8 with record_miss."""
        derived = bench_cam.derive(torch.float32, dev)
        g = torch.Generator(device=dev).manual_seed(0)
        acc = sum(render_pass(scene, derived, g, width=w, height=h, max_depth=16, spp_chunk=1,
                              bvh=tree, sky_tex=tex_dev, two_phase=4, depth_segment=8,
                              raw_slots=True) for _ in range(4))
        return blocks_to_image(acc, w, h, 1) / 4

    bench_frames["bvh sky"] = run("bench shape, render_pass(bvh=) with a sky texture (and "
                                  "two_phase, depth_segment: skipped)", k8_sky_frame,
                                  {"bvh_miss": 4})
    bench_frames["50000 sky two-phase"] = run(
        f"bench shape, {N_LARGE} spheres (K8), two_phase=4, sky texture: the monolithic fallback",
        frame(bench_cam, sc=big_cpu, sky=tex, use_bvh=True, two_phase=4),
        {"bvh_miss": p_bench})

    def k7_sky_frame():
        """The pass loop through render_pass(front=, sky_tex=, two_phase=4) on
        the global-memory front: K7 has no segment kernel, so each pass is
        one monolithic K7 with record_miss."""
        sc = reorder_scene(big_cpu, big_tree).to(dev)
        hb = mk.front_tables_hbm(sc, big_tree)
        derived = bench_cam.derive(torch.float32, dev)
        g = torch.Generator(device=dev).manual_seed(0)
        acc = sum(render_pass(sc, derived, g, width=w, height=h, max_depth=16, spp_chunk=1,
                              front=hb, sky_tex=tex_dev, two_phase=4, raw_slots=True)
                  for _ in range(4))
        return blocks_to_image(acc, w, h, 1) / 4

    bench_frames["50000 K7 sky two-phase"] = run(
        f"bench shape, {N_LARGE} spheres, render_pass(front=<K7's front>), two_phase=4, sky "
        "texture: the monolithic fallback", k7_sky_frame, {"front_hbm_miss": 4})
    for a, b in (("brute two-phase sky", "brute sky"),
                 ("5000 chunked two-phase", "5000 chunked"),
                 ("5000 chunked two-phase sky", "5000 chunked sky")):
        check(torch.equal(bench_frames[a][0], bench_frames[b][0]), f"{a}: bit-equal to {b}")
    del big_cpu

    # ---- D5. training at full width: make_fast_train_step(two_phase=4, cap_frac=0.25) ----
    target = render(cover_cpu, Camera(**COVER_CAMERA, samples_per_pixel=16, max_depth=50),
                    torch.Generator(device=dev).manual_seed(5), RenderSettings())
    configs = {  # trainable fields, start (CPU), front, scan, Adam's learning rate
        "geometry+albedo (brute K6)": (("albedo", "center0", "radius"),
                                       perturbed_cover("geometry"), None, "brute", 2e-3),
        "materials (front K6)": (("albedo", "fuzz", "ior"),) + prepare_scene(
            perturbed_cover("materials"), train_cam, RenderSettings(device="cpu")) + ("front",
                                                                                    1e-2),
    }
    step_s = {}
    for name, (trainable, start, front_cpu, scan, lr) in configs.items():
        params, opt, step = make_fast_train_step(
            start, train_cam, spp=2, learning_rate=lr, trainable=trainable, front=front_cpu,
            two_phase=4, cap_frac=0.25, generator=torch.Generator(device=dev).manual_seed(3))
        check(params.albedo.is_cuda, f"two-phase step {name}: parameters on the card by default")
        p0 = SceneParams(*(x.detach().clone() for x in params))
        key = f"segment_record_{scan}"
        before = mk.LAUNCHES[launch_key(key)]
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            (params, opt, loss, grads), sec = synced_s(
                lambda: step(params, opt, None, target))  # noqa: B023
            losses.append(loss.item())
            times.append(sec)
            check(torch.isfinite(loss).item() and all(torch.isfinite(g).all().item()
                                                      for g in grads),
                  f"two-phase step {name}: finite loss and gradients")
        check(mk.LAUNCHES[launch_key(key)] - before == 2 * TRAIN_STEPS,
              f"two-phase step {name}: {launch_key(key)} ran twice a step")
        launches[key] = launches.get(key, 0) + 2 * TRAIN_STEPS
        for fld in SceneParams._fields:
            moved = not torch.equal(getattr(params, fld).detach(), getattr(p0, fld))
            check(moved == (fld in trainable), f"two-phase step {name}: {fld} "
                  f"{'moves' if fld in trainable else 'stays bit-unchanged'}")
        step_s[name] = statistics.median(times[2:])
        print(f"two-phase train step, {name}, cover 400x225, 2 spp, depth 50: losses "
              + ", ".join(f"{x:.6f}" for x in losses)
              + f"; seconds per step (median of {len(times) - 2} warm) {step_s[name]:.4f} s "
              f"on {card}")
        # replay and gradients on one step's rays against the monolithic fast radiance
        sc = start.to(dev)
        fr = None if front_cpu is None else front_cpu.to(dev)
        o, d, t, seed = step_rays(train_cam, torch.Generator(device=dev).manual_seed(4))
        frp = None if fr is None else mk.front_with_params(fr, sc)
        rad, res1, res2, src, dest, n_alive = dt.trace_record_twophase(o, d, t, sc, seed, 50,
                                                                       cut=4, front=frp)
        cap = max(1, int(round(res1.idx.shape[1] * 0.25)))
        with torch.no_grad():
            rp = replay_radiance_twophase(extract_params(sc), sc, o, d, t, res1, res2, src, dest,
                                          n_alive, cap_rays=cap)
        frac = (torch.abs(rp - rad).max(dim=1).values <= 2e-5).double().mean().item()
        wts = torch.rand((o.shape[0], 3), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(9))

        def grads_of(fn):
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(sc)))
                return torch.autograd.grad((fn(pp, o, d, t, seed) * wts).sum(), list(pp))  # noqa: B023
            finally:
                torch.use_deterministic_algorithms(False)

        g_mono = grads_of(make_fast_radiance(sc, 50, front=fr))
        errs = {}
        for cf in (0.25, 0.001):
            g_two = grads_of(make_fast_radiance_twophase(sc, 50, cut=4, cap_frac=cf, front=fr))
            errs[cf] = {n: rel_err(a, b) for n, a, b in zip(SceneParams._fields, g_two, g_mono)}
        print(f"two-phase replay ({name}, one step's {o.shape[0]} rays, depth 50, {int(n_alive)} "
              f"of {src.shape[0]} rows alive after the cut, capacity {cap} rays): {frac:.6f} of "
              f"rays within 2e-5 of the recorded radiance; gradient relative errors against the "
              f"monolithic fast radiance (deterministic), cap_frac 0.25: "
              + ", ".join(f"{n} {v:.2e}" for n, v in errs[0.25].items())
              + "; cap_frac 0.001 (full-width branch): "
              + ", ".join(f"{n} {v:.2e}" for n, v in errs[0.001].items()))
        check(frac >= 0.998, f"two-phase replay ({name}): >= 99.8% within 2e-5")
        for cf, e in errs.items():
            check(max(e.values()) <= 1e-4, f"two-phase gradients ({name}, cap_frac {cf}) within "
                  "1e-4 of the monolithic ones")
        del rad, res1, res2, rp, o, d, t
    params, opt, step = make_fast_train_step(five_cpu, train_cam, spp=2, learning_rate=2e-3,
                                             trainable=("albedo", "center0", "radius"),
                                             two_phase=4,
                                             generator=torch.Generator(device=dev).manual_seed(3))
    before = mk.LAUNCHES["segment_record_brute_chunked"]
    for _ in range(3):
        params, opt, loss, grads = step(params, opt, None, target)
        check(torch.isfinite(loss).item(), "5,000-sphere two-phase geometry step: finite loss")
    check(mk.LAUNCHES["segment_record_brute_chunked"] - before == 6,
          "the chunked recording segment ran twice a step")
    launches["segment_record_brute_chunked"] = 6
    del params, opt, step, grads, target
    print(f"depth-tail main paths: launches of the new kernels {launches}")
    for key in ms:
        check(launches.get(key, 0) > 0, f"{key} ran on its main path")

    # ---- D6. times ----
    print(f"depth-tail times: CUDA events, warm, on {card}")
    for name, rays, d_max in (("bench shape", bench, 16), ("one pass, depth 50", rays1, 50)):
        for path in ("brute", "front"):
            t_ms, wb = pipeline_times(mk, dt, rays, scene, front if path == "front" else None,
                                      d_max, (dt.ROW_WIDTH,), segmented=True)
            wb = wb[dt.ROW_WIDTH]
            print(f"{path}, {name} ({rays[0].shape[0]} rays, depth {d_max}, {dt.ROW_WIDTH}-ray "
                  "rows): " + ", ".join(f"{k} {v:.3f} ms" for k, v in t_ms.items())
                  + f"; bounces paid per warp over bounces needed: monolithic "
                  f"{wb['monolithic']:.3f}, two-phase {wb['two-phase']:.3f}; the tail alone "
                  f"{wb['tail unpacked']:.3f} unpacked, {wb['tail packed']:.3f} packed; mean "
                  f"bounces a ray {wb['mean bounces']:.3f}, {wb['alive after the cut']:.4f} of "
                  "rays alive after the cut")
    for n_name, rays in (("one pass", rays1), ("bench shape", bench)):
        print(f"compaction ({n_name}, {rays[0].shape[0]} rays padded to a tile multiple, 14 "
              f"planes and the slots, {dt.ROW_WIDTH}-ray rows): "
              f"{compaction_ms(mk, dt, rays, scene):.4f} ms")
    # the train step's split, two-phase against monolithic (brute, geometry + albedo)
    sc = perturbed_cover("geometry").to(dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(sc)))
    parts = {k: [] for k in ("K6 record (both phases)", "two-phase replay forward",
                             "two-phase replay backward", "K5 record", "replay forward",
                             "replay backward")}
    from raytracingproject_tpu_torch.grad import replay_radiance

    for _ in range(4):
        o, d, t, seed = step_rays(train_cam, gen)
        rec, s = synced_s(lambda: dt.trace_record_twophase(o, d, t, sc, seed, 50, cut=4))  # noqa: B023
        parts["K6 record (both phases)"].append(s)
        cap = int(round(rec[1].idx.shape[1] * 0.25))
        rad, s = synced_s(lambda: replay_radiance_twophase(pp, sc, o, d, t, *rec[1:],  # noqa: B023
                                                           cap_rays=cap))  # noqa: B023
        parts["two-phase replay forward"].append(s)
        _, s = synced_s(lambda: torch.autograd.grad(rad.sum(), list(pp)))  # noqa: B023
        parts["two-phase replay backward"].append(s)
        (_, res), s = synced_s(lambda: mk.trace_record(o, d, t, sc, seed, 50))  # noqa: B023
        parts["K5 record"].append(s)
        rad, s = synced_s(lambda: replay_radiance(pp, sc, o, d, t, res))  # noqa: B023
        parts["replay forward"].append(s)
        _, s = synced_s(lambda: torch.autograd.grad(rad.sum(), list(pp)))  # noqa: B023
        parts["replay backward"].append(s)
    print("train step split, geometry+albedo (brute), two-phase against monolithic (median of 3 "
          "warm): " + ", ".join(f"{k} {1e3 * sorted(v[1:])[1]:.3f} ms" for k, v in parts.items())
          + f"; seconds per two-phase step: " + ", ".join(f"{k} {v:.4f} s"
                                                         for k, v in step_s.items())
          + f"; on {card}")
    print("seconds per frame (400x225, 30 spp, depth 50): " + ", ".join(
        f"{k} {v[1]:.4f} s" for k, v in frames.items()) + f"; on {card}")

    entries = []
    for key in sorted(ms):
        entries.append({
            "name": entry_name(key), "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[launch_key(key)], "launches": launches[key],
            "max_abs_err": max_err[key],
            "ms": ms[key], "plain_ms": plain_ms[key], "bound_ms": bounds[key][0],
            "bound_by": bounds[key][1], "library_ms": None, "pairs": pairs_of[key],
        })
    return entries


def ffma_loop(library: Path) -> tuple[int, int] | None:
    """(FFMA, all instructions) in the loop of fma_kernel's iterations, read
    from `cuobjdump -sass`: the backward-branch loop of the function whose
    name holds fma_kernel with the most FFMA. None where cuobjdump is
    missing or the loop is not found."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True).stdout
    funcs = [f for f in out.split("Function : ")[1:] if "fma_kernel" in f.split("\n", 1)[0]]
    if not funcs:
        return None
    code = [(int(m.group(1), 16), m.group(2)) for m in
            re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", funcs[0])]
    best = None
    for k, (addr, text) in enumerate(code):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if m is None or int(m.group(1), 16) >= addr:
            continue
        body = [t for a, t in code[:k + 1] if a >= int(m.group(1), 16)]
        n_ffma = sum(bool(re.search(r"\bFFMA\b", t)) for t in body)
        if best is None or n_ffma > best[0]:
            best = (n_ffma, len(body))
    return best


def probe_occupancy(all_regs: dict, fronts: dict) -> None:
    """The nine closest-hit probe instantiations' registers, spill stores
    and stack frame (`-Xptxas -v`, `all_regs`) and blocks per SM as their
    launches get them (`probes.blocks_per_sm`): a probe_hit_kernel's shared
    memory does not depend on the table, the front probe's on its front
    (`fronts`: label -> (n_cols, n_front), the cover scene's and 2,000
    spheres' at each F)."""
    from raytracingproject_tpu_torch import probes
    from raytracingproject_tpu_torch.ops.cuda import build

    outs = ("OUT_T", "OUT_KEXP", "OUT_SUM")
    for key, (v, u, o) in probes.HIT_ARGS.items():
        r = build.named(all_regs, f"probe_hit_kernelILi{v}ELi{u}ELi{o}E")
        print(f"  probe_hit_kernel<{('WIDE', 'SLIM')[v]}, {u}, {outs[o]}> ({key}): {r[0]} "
              f"registers, {r[1]} B spill stores, {r[2]} B stack frame, "
              f"{probes.blocks_per_sm(key)} blocks of {probes.PTPB} threads per SM (on the cover "
              "scene and 2,000 spheres alike)")
    r = build.named(all_regs, "probe_front_kernelILi8E")
    per = []
    for label, (n_cols, n_front) in fronts.items():
        per.append(f"{label} ({n_cols} columns) "
                   f"{probes.blocks_per_sm('kfront_front', n_cols, n_front)}")
    print(f"  probe_front_kernel<8> (kfront_front): {r[0]} registers, {r[1]} B spill stores, "
          f"{r[2]} B stack frame; blocks of {probes.PTPB} threads per SM: {', '.join(per)}")


def probe_kernels(card: str, all_regs: dict) -> list[dict]:
    """Phase 1b, the probes (csrc/probes.cu): each probe kernel against its
    plain version at the shapes its measurement gives it (bit-equal), the
    closest-hit probes' registers and blocks per SM (`probe_occupancy`) and
    the SASS instructions a pair of the mixed peak, kfront's brute and
    front probes, then the probes' main path
    as `python -m raytracingproject_tpu_torch.probes.*` drives it: the FFMA
    rate and the mixed peak (`roofline.measure`), kfront and kexp on the
    cover scene and on make_random_scene(2000, seed=3) at the 400x225
    primary rays, with the probes' launches counted. Sets RATE (every later
    bound reads it) and returns the probes' `kernels` entries."""
    import torch

    from raytracingproject_tpu_torch import probes
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.ops.cuda import build
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
    from raytracingproject_tpu_torch.probes import kexp, kfront, roofline

    dev = torch.device("cuda")
    loop = ffma_loop(build.library("probes"))
    print("fma_kernel SASS: " + ("loop not found" if loop is None else
                                 f"{loop[0]} FFMA of {loop[1]} instructions in its loop"))
    check(loop is not None and loop[0] >= 0.95 * loop[1], "the FMA probe's loop is FFMA")
    n = roofline.full_waves(dev)
    x = torch.linspace(0.99, 1.01, n, device=dev)
    tab = roofline.mixed_table(488).to(dev)
    ox = torch.linspace(10.0, 14.0, n, device=dev)
    err, plain_ms = {}, {}

    def hold(key, kern, plain, what):
        k, p = kern(), plain()
        torch.cuda.synchronize()
        fin = torch.isfinite(p)
        e = (k[fin] - p[fin]).abs().max().item() if fin.any() else 0.0
        print(f"{key} probe vs its plain version ({what}): bit-equal {torch.equal(k, p)}, "
              f"max |diff| {e:.3e}")
        check(torch.equal(k, p), f"{key} probe bit-equal to its plain version ({what})")
        err[key] = max(err.get(key, 0.0), e)
        if key not in plain_ms:
            plain_ms[key] = cuda_ms(plain, 1)

    hold("fma", lambda: roofline.fma_chains(x), lambda: roofline.fma_chains_plain(x),
         f"{n} elements")
    hold("mixed", lambda: roofline.mixed_hits(tab, ox),
         lambda: roofline.mixed_hits_plain(tab, ox), f"{n} rays, {tab.shape[1]} spheres")
    scenes = {"cover": kfront.probe_scene(None), "2000": kfront.probe_scene(2000)}
    rays = kfront.primary_rays(dev)
    fronts = {}
    for name, sc in scenes.items():
        sph = mk.scene_table(sc).to(dev)
        for v in kexp.VARIANTS:
            hold(f"kexp_{v}", lambda: kexp.run(rays, sph, v),  # noqa: B023
                 lambda: kexp.run_plain(rays, sph, v), f"{name}")  # noqa: B023
        sphb = mk.scene_table(reorder_scene(sc, build_bvh(sc, leaf_size=8))).to(dev)
        hold("kfront_brute", lambda: kfront.run_brute(rays, sphb),  # noqa: B023
             lambda: kfront.run_brute_plain(rays, sphb), name)  # noqa: B023
        for f in kfront.FRONTS:
            tabs = [t_.to(dev) for t_ in kfront.pack_front_tables(sc, max_nodes=f)]
            fronts[f"{name} F={f}"] = (tabs[0].shape[1], tabs[1].shape[1])
            hold("kfront_front", lambda: kfront.run_front(rays, *tabs),  # noqa: B023
                 lambda: kfront.run_front_plain(rays, *tabs), f"{name}, F={f}")  # noqa: B023
    probe_occupancy(all_regs, fronts)
    for key, fn in (*((k, "probe_hit_kernelILi{}ELi{}ELi{}E".format(*probes.HIT_ARGS[k]))
                      for k in ("mixed", "kfront_brute")),
                    ("kfront_front", "probe_front_kernelILi8E")):
        per_pair = sass_instructions_per_pair(build.library("probes"), fn)
        print(f"{key} probe SASS: " + ("instructions per pair not measured" if per_pair is None
                                       else f"{per_pair['static']:.1f} static instructions per "
                                       f"pair in the sphere loop, {per_pair['no_roots']:.1f} on "
                                       "the path that skips the roots"))

    # ---- the probes' main path ----
    probes.reset_launches()
    peaks = roofline.measure(dev)
    kf = {name: kfront.measure(sc, dev) for name, sc in scenes.items()}
    kx = {name: kexp.measure(sc, dev) for name, sc in scenes.items()}
    launches = dict(probes.LAUNCHES)
    print(f"probes' main path (roofline, kfront and kexp measurements): launches {launches}")
    for key in PROBE_REPLACES:
        check(launches[key] > 0, f"the {key} probe ran on the probes' main path")
    RATE["ops"], RATE["pairs"] = peaks["ffma_per_s"], peaks["mixed_pairs_per_s"]
    print(json.dumps(peaks))
    print(f"measured peaks on {card}: {peaks['ffma_per_s']:.5g} FFMA instructions/s "
          f"= {peaks['fp32_flops_per_s'] / 1e12:.4g} TFLOP/s float32 (data sheet "
          f"{PEAK_FP32 / 1e12:.4g} TFLOP/s); mixed {peaks['mixed_pairs_per_s']:.5g} sphere tests/s"
          f" ({peaks['mixed_ops_over_ffma']:.3f} of the FFMA rate at the operations its bound "
          f"charges: {roofline.OPS_PAIR_DISC} a pair and {roofline.OPS_PAIR_ROOTS} more for each "
          f"of a pass's {peaks['mixed_roots']:.0f} of "
          f"{peaks['mixed_rays'] * peaks['mixed_spheres']} with a positive discriminant); bounds below use the larger of the measured FFMA rate "
          f"and the data sheet's {PEAK_FP32 / 2:.4g}")
    for name, r in kf.items():
        print(f"kfront on {name} ({r['spheres']} spheres, {r['rays']} primary rays): brute "
              f"{r['brute_ms']:.4f} ms = {r['rays'] / r['brute_ms'] / 1e3:.2f} Mrays/s; "
              + "; ".join(f"front F={f} ({v['columns']} columns) {v['ms']:.4f} ms = "
                          f"{r['rays'] / v['ms'] / 1e3:.2f} Mrays/s, parity {v['parity']:.6f}, "
                          f"{v['pairs'] / r['rays']:.1f} tests a ray"
                          for f, v in r["front"].items()) + f"; on {card}")
        check(all(v["parity"] == 1.0 for v in r["front"].values()),
              f"kfront on {name}: the front probe finds the brute probe's t on every ray")
    for name, r in kx.items():
        print(f"kexp on {name} ({r['spheres']} spheres, {r['rays']} primary rays): "
              + ", ".join(f"{v} {r[v]['ms']:.4f} ms" for v in kexp.VARIANTS) + f"; on {card}")
        check(all(r[v]["max_abs"] == 0.0 for v in kexp.VARIANTS),
              f"kexp on {name}: unrolling changes no value")

    entries = []

    def entry(key, ms, pairs, b):
        entries.append({
            "name": f"probe_{key}", "route": "cuda", "source": PROBE_SOURCE,
            "replaces": PROBE_REPLACES[key], "launches": launches[key], "max_abs_err": err[key],
            "ms": ms, "plain_ms": plain_ms[key], "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None, "pairs": pairs,
        })

    entry("fma", peaks["fma_ms"], None,
          bound(n * roofline.FMAS_PER_ELEMENT, 8 * n))
    n_pad, mixed_roots = peaks["mixed_spheres"], peaks["mixed_roots"]
    entry("mixed", peaks["mixed_ms"], n * n_pad,
          bound(roofline.test_ops(n * n_pad, mixed_roots), 8 * n + 4 * tab.numel()))
    # kfront and kexp from the 2,000-sphere scene: tens of waves of work,
    # where the cover scene's 0.1-0.2 ms passes vary by half between calls
    big = kf["2000"]
    r, n_sph = big["rays"], scenes["2000"].num_spheres
    brute_ops = roofline.test_ops(r * n_sph, big["brute_roots"])
    entry("kfront_brute", big["brute_ms"], r * n_sph, bound(brute_ops, 32 * r + 64 * n_sph))
    f24 = big["front"][kfront.FRONTS[0]]
    entry("kfront_front", f24["ms"], f24["pairs"],
          bound(roofline.test_ops(f24["pairs"], f24["roots"], f24["boxes"]),
                32 * r + 64 * f24["columns"]))
    for v in kexp.VARIANTS:
        entry(f"kexp_{v}", kx["2000"][v]["ms"], r * n_sph, bound(brute_ops, 32 * r + 64 * n_sph))
    print(f"pairs with a positive discriminant: mixed probe {mixed_roots:.0f} of {n * n_pad}; "
          f"primary rays on 2,000 spheres {big['brute_roots']} of {r * n_sph}, of the F=24 "
          f"front's live columns {f24['roots']} of {f24['pairs']}")
    return entries


def front_large(mk, lib, regs: dict, card: str) -> None:
    """Phase 12i, K3 on the largest fronts the shared memory holds:
    `render`'s fronts of make_random_scene(2000 / 3000, seed=3) at the
    bench shape (`prepare_scene`: repack 2, near-to-far from the cover
    camera; both still FrontTables, the route K3). The twelve front
    instantiations' occupancy on the 3,000-sphere front (its tables leave
    one block an SM); K3 (forward and record_miss) and K5's front core
    bit-equal to their plain versions on one pass of the reference
    frame's 90,112 rays at depth 16; K3's time on that pass, and at depth 0
    (the table's staging and the rays' loads and stores alone)."""
    import torch

    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.render import _slot_rays, prepare_scene
    from raytracingproject_tpu_torch.scene import make_random_scene

    dev = torch.device("cuda")
    bench_cam = Camera(**COVER_CAMERA, samples_per_pixel=4, max_depth=16)
    w, h = bench_cam.image_size()
    rays = _slot_rays(bench_cam.derive(torch.float32, dev), w, h, 1,
                      torch.Generator(device=dev).manual_seed(31), None)
    for n in (2000, 3000):
        sc, fr = prepare_scene(make_random_scene(n, seed=3), bench_cam,
                               RenderSettings(device="cuda"))
        check(isinstance(fr, mk.FrontTables), f"{n} spheres: render's route is K3")
        if n == 3000:
            front_occupancy(lib, regs, fr, "3,000 spheres", card)
        k = mk.trace_paths(*rays, sc, 61, 16, front=fr)
        check(torch.equal(k, mk.trace_paths_twin(*rays, sc, 61, 16, front=fr)),
              f"front ({n} spheres, a pass): bit-equal to the plain version")
        km = mk.trace_paths(*rays, sc, 62, 16, front=fr, record_miss=True)
        pm = mk.trace_paths_twin(*rays, sc, 62, 16, front=fr, record_miss=True)
        check(all(torch.equal(a, b) for a, b in zip(km, pm)),
              f"front_miss ({n} spheres, a pass): bit-equal to the plain version")
        rad, res = mk.trace_record(*rays, sc, 63, 16, front=fr)
        prad, pres = mk.trace_record_twin(*rays, sc, 63, 16, front=fr)
        check(torch.equal(rad, prad) and all(torch.equal(a, b) for a, b in zip(res, pres)),
              f"record_front ({n} spheres, a pass): radiance and residuals bit-equal to the "
              "plain version")
        ms = cuda_ms(lambda: mk.trace_paths(*rays, sc, 61, 16, front=fr), 10)  # noqa: B023
        staged = cuda_ms(lambda: mk.trace_paths(*rays, sc, 61, 0, front=fr), 10)  # noqa: B023
        print(f"K3 on {n} spheres ({fr.ff.shape[1]} subtrees over {fr.sph.shape[1]} columns, "
              f"{4 * sum(x.numel() for x in (fr.sph, fr.ff, fr.fi, fr.wf, fr.sf))} B of tables): "
              f"forward, record_miss and K5 bit-equal to their plain versions on a pass "
              f"({rays[0].shape[0]} rays, depth 16); K3 {ms:.4f} ms a pass, {staged:.4f} ms at "
              f"depth 0 (staging); on {card}")


def front_options(mk, card: str) -> list[dict]:
    """Phase 12g, K3's options: `front_tables(sub_block=, word_earlyout=)`
    on the cover scene and on make_random_scene(2000, seed=3), with the
    front `default_front_nodes` gives and a front of fewer, bigger subtrees
    (24) for sub_block. Each option instantiation bit-equal to plain K3's on
    the bench shape (forward, record_miss, K5) and on one pass cut at 4 then
    12 bounces (K6's three tails), and held against its plain version; the
    options' main path: `render_pass` with the options' front (plain, with
    a sky texture, two-phase, both), `make_fast_train_step` with a
    word_earlyout front (monolithic and two-phase), launches counted; times
    against plain K3 and bounds. Returns the six `kernels` entries."""
    import torch

    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.grad import make_fast_train_step
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt
    from raytracingproject_tpu_torch.render import _slot_rays, render_pass
    from raytracingproject_tpu_torch.scene import make_cover_scene, make_random_scene

    dev = torch.device("cuda")
    bench_cam = Camera(**COVER_CAMERA, samples_per_pixel=4, max_depth=16)
    w, h = bench_cam.image_size()
    bench = _slot_rays(bench_cam.derive(torch.float32, dev), w, h, 4,
                       torch.Generator(device=dev).manual_seed(1), None)
    rays1 = _slot_rays(bench_cam.derive(torch.float32, dev), w, h, 1,
                       torch.Generator(device=dev).manual_seed(31), None)
    n_b, n1 = w * h * 4, rays1[0].shape[0]
    cmp = tuple(x[:N_CMP].contiguous() for x in bench)
    op = COVER_CAMERA["lookfrom"]
    max_err, ms, plain_ms, bounds, pairs = {}, {}, {}, {}, {}
    fronts_of = {}
    for name, cpu in (("cover", make_cover_scene(0)), ("2000", make_random_scene(2000, seed=3))):
        tree = build_bvh(cpu, leaf_size=8)
        sc = reorder_scene(cpu, tree).to(dev)
        ft = lambda **kw: mk.front_tables(sc, tree, order_point=op, repack=2, **kw)  # noqa: E731
        fr = {"plain": ft(), "word_earlyout": ft(word_earlyout=True),
              "sub_block": ft(sub_block=True), "both": ft(sub_block=True, word_earlyout=True),
              "plain, 24 subtrees": ft(max_nodes=mk.WORD),
              "sub_block, 24 subtrees": ft(max_nodes=mk.WORD, sub_block=True),
              "both, 24 subtrees": ft(max_nodes=mk.WORD, sub_block=True, word_earlyout=True)}
        fronts_of[name] = (sc, fr)
        print(f"K3 options on {name} ({sc.num_spheres} spheres): default front "
              f"{fr['plain'].ff.shape[1]} subtrees over {fr['plain'].sph.shape[1]} columns (ksub "
              f"{fr['both'].ksub}), 24 subtrees (ksub {fr['both, 24 subtrees'].ksub})")

        def worst(key, e):
            max_err[key] = max(max_err.get(key, 0.0), e)

        # forward and record_miss: bit-equal to plain K3 (bench shape), held against the twin
        for kname, f in fr.items():
            if "plain" in kname:
                continue
            base = fr["plain, 24 subtrees"] if "24" in kname else fr["plain"]
            k = mk.trace_paths(*bench, sc, 99, 16, front=f)
            check(torch.equal(k, mk.trace_paths(*bench, sc, 99, 16, front=base)),
                  f"front_opts ({kname}, {name}): bit-equal to plain K3")
            p = mk.trace_paths_twin(*cmp, sc, 99, 16, front=f)
            e = (k[:N_CMP] - p).abs()
            frac = (e <= 1e-3).all(dim=1).double().mean().item()
            km = mk.trace_paths(*rays1, sc, 98, 16, front=f, record_miss=True)
            bm = mk.trace_paths(*rays1, sc, 98, 16, front=base, record_miss=True)
            check(all(torch.equal(a, b) for a, b in zip(km, bm)),
                  f"front_opts_miss ({kname}, {name}): bit-equal to plain K3's")
            pm = mk.trace_paths_twin(*rays1, sc, 98, 16, front=f, record_miss=True)
            em = max((a - b).abs().max().item() for a, b in zip(km, pm))
            print(f"  {kname}: forward == plain K3 True, vs its plain version ({N_CMP} rays, "
                  f"depth 16) {frac:.6f} within 1e-3, bit-equal {torch.equal(k[:N_CMP], p)}; "
                  f"record_miss == plain K3 True, vs its plain version max |diff| {em:.3e}")
            check(frac >= 0.999 and e.mean().item() < 1e-5,
                  f"front_opts ({kname}, {name}): >= 99.9% within 1e-3 of its plain version")
            check(em <= 1e-3, f"front_opts_miss ({kname}, {name}): within 1e-3 of its plain "
                  "version")
            worst("front_opts", e.max().item())
            worst("front_opts_miss", em)
        # K5 with word_earlyout: bit-equal to plain K5 front, held against its plain version
        we = fr["word_earlyout"]
        ra, pa = mk.trace_record(*bench, sc, 99, 16, front=fr["plain"])
        rb, pb = mk.trace_record(*bench, sc, 99, 16, front=we)
        check(torch.equal(ra, rb) and all(torch.equal(getattr(pa, x), getattr(pb, x))
                                          for x in ("idx", "ndir", "refl")),
              f"record_front_opts ({name}): bit-equal to plain K5 front")
        worst("record_front_opts", hold_record(mk, f"word_earlyout, {name}", *cmp, sc, we, 99,
                                               16, False))
        # K6's three tails with word_earlyout
        for kind in ("", "miss_", "record_"):
            key = f"segment_{kind}front_opts"
            miss, rec = kind == "miss_", kind == "record_"
            state, slot = dt.initial_state(*rays1, miss)
            for b0, nb in ((0, 4), (4, 12)):
                a = mk.segment_call(state, slot, sc, 41, b0, nb, front=fr["plain"],
                                    record_miss=miss, record=rec)
                b = mk.segment_call(state, slot, sc, 41, b0, nb, front=we, record_miss=miss,
                                    record=rec)
                same = (torch.equal(a[0], b[0]) and all(torch.equal(x, y)
                                                        for x, y in zip(a[1], b[1]))
                        if rec else torch.equal(a, b))
                check(same, f"{key} ({name}, bounces [{b0}, {b0 + nb})): bit-equal to plain K6")
                state = b[0] if rec else b
                src, _, _ = dt.alive_first_perm(state[mk.ST_ALIVE])
                state, slot = dt.take_ray_rows(state, src, dim=1), dt.take_ray_rows(slot, src)
            err, k_ms, p_ms = hold_segments(mk, dt, f"{key} ({name})", rays1, sc, we, 41, 4, 16,
                                            miss, rec, timed=True)
            worst(key, err)
            if name == "cover":
                ms[key], plain_ms[key] = sum(k_ms), sum(p_ms)
                counts = segment_counts(mk, dt, rays1, sc, we, 41, 4, 16)
                pairs[key] = counts["pairs"]
                rows = mk.STATE_ROWS + (mk.MISS_ROWS if miss else 0)
                tab_bytes = 4 * (we.sph.numel() + we.ff.numel())
                nbytes = 2 * (n1 * (8 * rows + 4) + tab_bytes) + (n1 * 16 * 17 if rec else 0)
                bounds[key] = bound(test_ops(counts), nbytes)
                print_yardstick(key, counts, ms[key],
                                lambda c: bound(test_ops(c), nbytes))  # noqa: B023

    # ---- the options' main path: render_pass and make_fast_train_step with the options ----
    sc, fr = fronts_of["cover"]
    train_cam = Camera(**COVER_CAMERA, samples_per_pixel=2, max_depth=50)
    sky = torch.rand((256, 512, 3), generator=torch.Generator(device=dev).manual_seed(8),
                     device=dev)
    target = torch.full((h, w, 3), 0.5, device=dev)
    mk.reset_launches()
    derived = bench_cam.derive(torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    for kw in ({}, dict(sky_tex=sky), dict(two_phase=4), dict(two_phase=4, sky_tex=sky)):
        img = render_pass(sc, derived, gen, width=w, height=h, max_depth=16, spp_chunk=4,
                          front=fr["both"], **kw)
        check(torch.isfinite(img).all().item(), f"render_pass with the options' front {kw}: "
              "finite")
    for tp in (None, 4):
        gen = torch.Generator(device=dev).manual_seed(3)
        params, opt, step = make_fast_train_step(sc, train_cam, spp=2, front=fr["word_earlyout"],
                                                 trainable=("albedo",), two_phase=tp,
                                                 generator=gen)
        params, opt, loss, _ = step(params, opt, None, target)
        check(torch.isfinite(loss).item(), f"train step with a word_earlyout front "
              f"(two_phase={tp}): finite loss")
    torch.cuda.synchronize()
    launches = {k: mk.LAUNCHES[k] for k in OPTION_KEYS}
    print(f"the options' main path (render_pass with sub_block + word_earlyout: plain, sky "
          f"texture, two-phase, both; make_fast_train_step with word_earlyout, monolithic and "
          f"two-phase): launches {launches}")
    for key in OPTION_KEYS:
        check(launches[key] > 0, f"{key} ran on the options' main path")

    # ---- times: the bench shape (forward, K5), one pass (record_miss); against plain K3 ----
    for name, (sc, fr) in fronts_of.items():
        line = []
        for kname, f in fr.items():
            t_ms = cuda_ms(lambda: mk.trace_paths(*bench, sc, 99, 16, front=f), 10)  # noqa: B023
            line.append(f"{kname} {t_ms:.4f} ms")
        print(f"K3 forward at the bench shape ({n_b} rays, depth 16) on {name}: "
              + ", ".join(line) + f"; on {card}")
    sc, fr = fronts_of["cover"]
    timed = {"front_opts": (fr["both"], False, bench, {}),
             "front_opts_miss": (fr["both"], False, rays1, dict(record_miss=True)),
             "record_front_opts": (fr["word_earlyout"], True, bench, {})}
    for key, (f, rec, rays, kw) in timed.items():
        fn, tw = (mk.trace_record, mk.trace_record_twin) if rec else (mk.trace_paths,
                                                                      mk.trace_paths_twin)
        ms[key] = cuda_ms(lambda: fn(*rays, sc, 99, 16, front=f, **kw), 10)  # noqa: B023
        plain_ms[key] = cuda_ms(lambda: tw(*rays, sc, 99, 16, front=f, **kw), 1)  # noqa: B023
        ms[key.replace("_opts", "")] = cuda_ms(
            lambda: fn(*rays, sc, 99, 16, front=fr["plain"], **kw), 10)  # noqa: B023
        counts = count_tests(mk, *rays, sc, f, 99, 16)
        pairs[key] = counts["pairs"]
        n = rays[0].shape[0]
        tab_bytes = 4 * (f.sph.numel() + f.ff.numel() + (0 if f.bf is None else f.bf.numel()))
        if kw:
            def bound_of(c):
                return bound(test_ops(c), n * 64 + tab_bytes)  # noqa: B023
        else:
            def bound_of(c):
                return megakernel_bound(c, n, 16, tab_bytes, rec)  # noqa: B023
        bounds[key] = bound_of(counts)
        print(f"{key}: kernel {ms[key]:.4f} ms (plain K3's instantiation "
              f"{ms[key.replace('_opts', '')]:.4f} ms), plain version {plain_ms[key]:.1f} ms "
              f"({n} rays, depth 16, cover); these rays need {counts}; bound "
              f"{bounds[key][0]:.4f} ms by {bounds[key][1]}, the kernel reaches "
              f"{bounds[key][0] / ms[key]:.3f} of it; on {card}")
        print_yardstick(key, counts, ms[key], bound_of)
    for key in ("segment_front_opts", "segment_miss_front_opts", "segment_record_front_opts"):
        print(f"{key}: kernel {ms[key]:.4f} ms ({n1} rays cut at 4, then 12 bounces packed, "
              f"cover), plain version {plain_ms[key]:.1f} ms; bound {bounds[key][0]:.4f} ms by "
              f"{bounds[key][1]}, the kernel reaches {bounds[key][0] / ms[key]:.3f} of it")
    return [{
        "name": f"megakernel_{key}", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES[key], "launches": launches[key], "max_abs_err": max_err[key],
        "ms": ms[key], "plain_ms": plain_ms[key], "bound_ms": bounds[key][0],
        "bound_by": bounds[key][1], "library_ms": None, "pairs": pairs[key],
    } for key in OPTION_KEYS]


def region_stats(scene, rays, radiance) -> dict:
    """{primary-hit sphere (-1: sky): (samples, mean rgb, std rgb)} of
    per-sample radiance (tests/test_tpu_lane.py's _region_stats)."""
    import numpy as np
    import torch

    from raytracingproject_tpu_torch.ops.intersect import closest_hit

    o, d, t = rays
    rec = closest_hit(o, d, t, scene.center0, scene.center_delta, scene.radius)
    region = torch.where(rec.hit, rec.idx, -1).cpu().numpy()
    rad = radiance.double().cpu().numpy()
    return {int(r): (int((region == r).sum()), rad[region == r].mean(axis=0),
                     rad[region == r].std(axis=0)) for r in np.unique(region)}


def region_statistic(mk, card: str) -> dict:
    """Phase 12h, K1's planted fault on `<CHUNKED, SCHLICK3>`: the kernel
    against its plain version, then the per-material-region statistic of
    tests/test_tpu_lane.py:180-254 on the card (the three-sphere scene,
    160x90, depth 16, at 256 spp: tests/test_torch_region.py's SPP_CARD;
    the brute scan (the chunked kernel) against the oracle `ray_color`): clean, every region
    of > 1,000 samples under z = 5; with inject_bug="schlick3", the
    dielectric (region 2) past z = 5. The statistic's run is this kernel's
    main path. Returns its `kernels` entry."""
    import numpy as np
    import torch

    from raytracingproject_tpu_torch.camera import Camera, generate_rays
    from raytracingproject_tpu_torch.render import ray_color
    from raytracingproject_tpu_torch.scene import make_three_sphere_scene

    dev = torch.device("cuda")
    scene = make_three_sphere_scene(device=dev)
    spp = 256
    cam = Camera(aspect_ratio=16 / 9, image_width=160, samples_per_pixel=spp, max_depth=16,
                 vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0))
    w, h = cam.image_size()
    pix = torch.arange(w * h, device=dev).repeat(spp)
    rays = generate_rays(cam.derive(torch.float32, dev), (pix % w).to(torch.int32),
                         (pix // w).to(torch.int32), torch.Generator(device=dev).manual_seed(3))
    k = mk.trace_paths(*rays, scene, 21, 16, inject_bug="schlick3")
    p = mk.trace_paths_twin(*rays, scene, 21, 16, inject_bug="schlick3")
    torch.cuda.synchronize()
    err = (k - p).abs().max().item()
    print(f"brute_chunked_schlick3 vs its plain version ({pix.shape[0]} rays, depth 16, "
          f"philox): bit-equal {torch.equal(k, p)}, max |diff| {err:.3e}")
    check(torch.equal(k, p), "brute_chunked_schlick3: bit-equal to its plain version")
    plain_ms = cuda_ms(lambda: mk.trace_paths_twin(*rays, scene, 21, 16, inject_bug="schlick3"),
                       1)
    oracle = ray_color(scene, *rays, torch.Generator(device=dev).manual_seed(9), 16,
                       early_exit=True)
    so = region_stats(scene, rays, oracle)
    mk.reset_launches()
    z = {}
    for bug in (None, "schlick3"):
        rad = mk.trace_paths(*rays, scene, 21, 16, inject_bug=bug)
        sk = region_stats(scene, rays, rad)
        z[bug] = {r: np.abs(sk[r][1] - so[r][1]) / (np.sqrt((sk[r][2] ** 2 + so[r][2] ** 2)
                                                            / sk[r][0]) + 1e-6) for r in sk}
        print(f"region statistic ({'inject_bug=' + bug if bug else 'clean'}, {pix.shape[0]} "
              f"samples): " + ", ".join(f"region {r} ({sk[r][0]} samples) z max "
                                        f"{z[bug][r].max():.2f}" for r in sorted(sk)))
    launches = mk.LAUNCHES["brute_chunked_schlick3"]
    check(launches > 0, "the region statistic ran brute_chunked_schlick3")
    for r, zr in z[None].items():
        if so[r][0] > 1000:
            check(zr.max() < 5.0, f"clean region {r}: z {zr.max():.2f} < 5")
    zd = z["schlick3"][2].max()
    check(zd > 5.0, f"schlick3 caught: dielectric z {zd:.2f} > 5")
    ms = cuda_ms(lambda: mk.trace_paths(*rays, scene, 21, 16, inject_bug="schlick3"), 5)
    counts = count_tests(mk, *rays, scene, None, 21, 16)
    b = megakernel_bound(counts, pix.shape[0], 16, 4 * mk.N_ROWS * scene.num_spheres, False)
    print(f"brute_chunked_schlick3: kernel {ms:.4f} ms ({pix.shape[0]} rays, depth 16, 4 "
          f"spheres), plain version {plain_ms:.1f} ms; bound {b[0]:.4f} ms by {b[1]}, "
          f"reaches {b[0] / ms:.3f} of it; on {card}")
    return {"name": "megakernel_brute_chunked_schlick3", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES["brute_chunked_schlick3"], "launches": launches,
            "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None, "pairs": counts["pairs"]}


def geometry_training(mk, card: str) -> None:
    """Phases G1-G3, geometry training on the front-culled kernel: the
    cover scene's FrontRefresher (built as prepare_scene builds the front
    for a depth-50 camera: leaf 8, near-to-far from the camera, repack 1),
    two spheres moved and one radius changed.
    G1: refresh_device on the card bit-equal to the host refresh in every
    table, every sphere inside its refreshed subtree box; its time.
    G2: K5's front core (<FRONT, RECORD>) over the refreshed tables on one
    geometry step's rays (400x225, 2 spp, depth 50) bit-equal to its plain
    version, its winners against the chunked recording scan's.
    G3: make_fast_geometry_train_step (refresher= and explicit front) on
    the moved scene against the brute make_fast_train_step from the same
    generator seed, launches counted; times of both; ten steps' losses."""
    import dataclasses
    import statistics
    import warnings

    import torch

    from raytracingproject_tpu_torch.bvh import build_bvh
    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.grad import (
        SceneParams, extract_params, make_fast_geometry_train_step, make_fast_train_step,
    )
    from raytracingproject_tpu_torch.render import render
    from raytracingproject_tpu_torch.scene import make_cover_scene

    dev = torch.device("cuda")
    cam = Camera(**COVER_CAMERA, samples_per_pixel=2, max_depth=50)
    settings = RenderSettings(device="cuda")
    t_phase = time.perf_counter()
    cover = make_cover_scene(0).to(dev)
    refresher = mk.FrontRefresher(cover, build_bvh(cover, leaf_size=max(settings.bvh_leaf_size, 8)),
                                  order_point=tuple(float(x) for x in cam.lookfrom), repack=1)
    p = extract_params(cover)
    c0 = p.center0.clone()
    c0[5] += torch.tensor([0.05, -0.03, 0.04], device=dev)
    c0[200] += torch.tensor([-0.04, 0.02, 0.03], device=dev)
    radius = p.radius.clone()
    radius[100] *= 1.2
    moved = p._replace(center0=c0, radius=radius)
    moved_scene = dataclasses.replace(cover, center0=c0, radius=radius)

    # ---- G1. the refresh: on the card against the host ----
    fr = refresher.refresh_device(moved)
    host = refresher.refresh(moved)
    torch.cuda.synchronize()
    tables = ("sph", "ff", "fi", "wf", "sf", "remap", "owner")
    check(all(torch.equal(getattr(fr, k), getattr(host, k)) for k in tables),
          "G1: refresh_device on the card bit-equal to the host refresh (every table)")
    owner = fr.column_subtree()
    inside = all(
        bool(((fr.sph[0:3] + tt * fr.sph[3:6] - fr.sph[6].abs() >= fr.ff[0:3, owner])
              & (fr.sph[0:3] + tt * fr.sph[3:6] + fr.sph[6].abs() <= fr.ff[3:6, owner])).all())
        for tt in (0.0, 1.0))
    check(inside, "G1: every sphere inside its refreshed subtree box at t = 0 and t = 1")
    ev = []
    for _ in range(20):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        refresher.refresh_device(moved)
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    refresh_ms = statistics.median(a.elapsed_time(b) for a, b in ev)
    host_s = statistics.median(synced_s(lambda: refresher.refresh(moved))[1] for _ in range(5))
    print(f"G1 refresh ({fr.ff.shape[1]} subtrees over {fr.sph.shape[1]} columns, "
          f"{4 * sum(getattr(fr, k).numel() for k in tables[:5])} B of tables): refresh_device "
          f"{refresh_ms:.4f} ms (CUDA events, median of 20), host refresh {1e3 * host_s:.3f} ms "
          f"(synchronised, median of 5); bit-equal; spheres inside their boxes; "
          f"{time.perf_counter() - t_phase:.1f} s; on {card}")

    # ---- G2. <FRONT, RECORD> on the refreshed tables at one geometry step's shape ----
    t_phase = time.perf_counter()
    o, d, t, seed = step_rays(cam, torch.Generator(device=dev).manual_seed(4))
    hold_record(mk, "refreshed tables, moved cover", o, d, t, moved_scene, fr, seed, 50, False,
                exact=True)
    _, res_f = mk.trace_record(o, d, t, moved_scene, seed, 50, front=fr)
    _, res_b = mk.trace_record(o, d, t, moved_scene, seed, 50)
    differ = int((res_f.idx != res_b.idx).sum())
    rays_differ_idx = int((res_f.idx != res_b.idx).any(dim=0).sum())
    print(f"G2 record_front on refreshed tables ({o.shape[0]} rays, depth 50): bit-equal to "
          f"the plain version; idx entries differing from the chunked recording scan's: "
          f"{differ} of {res_f.idx.numel()} ({rays_differ_idx} rays); "
          f"{time.perf_counter() - t_phase:.1f} s; on {card}")
    check(differ <= res_f.idx.numel() // 10000,
          "G2: winners on refreshed tables equal the chunked scan's (ties at most 1e-4)")
    del o, d, t, res_f, res_b

    # ---- G3. the geometry step against the brute step, launches, times ----
    t_phase = time.perf_counter()
    trainable = ("center0", "radius", "albedo")
    target = render(make_cover_scene(0), Camera(**COVER_CAMERA, samples_per_pixel=16,
                                                max_depth=50),
                    torch.Generator(device=dev).manual_seed(5), settings)
    gen = lambda: torch.Generator(device=dev).manual_seed(3)  # noqa: E731
    bp, bo, bstep = make_fast_train_step(moved_scene, cam, spp=2, learning_rate=2e-3,
                                         trainable=trainable)
    gp, go, gstep = make_fast_geometry_train_step(moved_scene, cam, refresher=refresher, spp=2,
                                                  learning_rate=2e-3, trainable=trainable)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the caller (here) passes fresh tables every step
        ep, eo, estep = make_fast_geometry_train_step(moved_scene, cam, spp=2,
                                                      learning_rate=2e-3, trainable=trainable)
    rp, ro, _ = make_fast_geometry_train_step(moved_scene, cam, refresher=refresher, spp=2,
                                              learning_rate=2e-3, trainable=trainable)
    _, _, bloss, bg = bstep(bp, bo, gen(), target)
    mk.reset_launches()
    _, _, gloss, gg = gstep(gp, go, gen(), target)
    torch.cuda.synchronize()
    launches = dict(mk.LAUNCHES)
    _, _, eloss, eg = estep(ep, eo, gen(), target,
                            refresher.refresh_device(SceneParams(*(x.detach() for x in ep))))
    _, _, rloss, rg = gstep(rp, ro, gen(), target)  # the same step again: the noise floor

    def grad_diff(a, b):
        return max((getattr(a, f) - getattr(b, f)).abs().max().item() for f in SceneParams._fields)

    g_err, e_err, r_err = grad_diff(gg, bg), grad_diff(eg, gg), grad_diff(rg, gg)
    print(f"G3 geometry step (refresher) vs brute step (cover 400x225, 2 spp, depth 50, "
          f"{trainable}): loss {gloss.item():.9f} vs {bloss.item():.9f}, max |grad diff| "
          f"{g_err:.3e}; explicit-front form: loss {eloss.item():.9f}, max |grad diff| {e_err:.3e}; "
          f"the refresher step run again: loss {rloss.item():.9f}, max |grad diff| {r_err:.3e} "
          f"(the replay backward's atomic adds run in no fixed order on the card); launches "
          f"{({k: v for k, v in launches.items() if v})}")
    check(launches["record_front"] > 0 and sum(launches.values()) == launches["record_front"],
          "G3: the geometry step went through K5's front core alone")
    check(abs(gloss.item() - bloss.item()) <= 1e-6 * abs(bloss.item()) and g_err <= 1e-6,
          "G3: geometry step's loss (rtol 1e-6) and grads (atol 1e-6) equal the brute step's")
    check(abs(eloss.item() - gloss.item()) <= 1e-6 * abs(gloss.item()) and e_err <= 1e-6,
          "G3: the explicit-front form equals the refresher form (rtol 1e-6, atol 1e-6)")

    forms = {"geometry (refresher, K5 front)": [gstep, gp, go, False, []],
             "brute (K5 chunked)": [bstep, bp, bo, False, []],
             "geometry (explicit host refresh)": [estep, ep, eo, True, []]}
    for _ in range(7):  # the three forms in turns, one step each a round
        for name, form in forms.items():
            step, params, opt, extra, secs = form
            args = (refresher.refresh(params),) if extra else ()
            (params, opt, loss, _), sec = synced_s(
                lambda: step(params, opt, None, target, *args))  # noqa: B023
            secs.append(sec)
            check(torch.isfinite(loss).item(), f"G3 {name}: finite loss")
    times = {name: statistics.median(form[4][2:]) for name, form in forms.items()}
    geo_s = times["geometry (refresher, K5 front)"]
    print("G3 seconds per train step (in turns, median of 5 warm rounds; cover 400x225, 2 spp, "
          "depth 50): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in times.items())
          + f"; geometry / brute {geo_s / times['brute (K5 chunked)']:.3f}; the refresh's share "
          f"of a geometry step {refresh_ms / (1e3 * geo_s):.5f}; on {card}")

    start = perturbed_cover("geometry").to(dev)
    params, opt, step = make_fast_geometry_train_step(
        start, cam, refresher=mk.FrontRefresher(start, build_bvh(start, leaf_size=8),
                                                order_point=tuple(float(x) for x in cam.lookfrom),
                                                repack=1),
        spp=2, learning_rate=2e-3, trainable=trainable,
        generator=torch.Generator(device=dev).manual_seed(9))
    losses = []
    for _ in range(10):
        params, opt, loss, _ = step(params, opt, None, target)
        losses.append(loss.item())
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    print(f"G3 ten geometry steps from the perturbed cover (recorded, not gated): losses "
          + ", ".join(f"{x:.6f}" for x in losses)
          + f"; last-3 / first-3 mean {last / first:.4f} ({'falls' if last < first else 'rises'})"
          f"; {time.perf_counter() - t_phase:.1f} s; on {card}")


def soft_recovery(target_seed: int, step_seed: int) -> dict:
    """One run of the cover-scale silhouette recovery
    (tests/test_edge_grad.py:192-260) on the card: the cover scene at 128
    px wide, 2 spp, depth 3, candidates_k = 8; sphere n - 2 (the big
    Lambertian at (-4, 1, 0)) moved by (0.25, -0.15, 0.2) and shrunk to 0.8
    of its radius; 160 steps of Adam(2e-2), the softness annealed from 0.05
    to 0.003, every other sphere held; the target an oracle render drawn
    from `target_seed`, the steps' draws from `step_seed`. Returns the
    centre's error per axis, the angular sizes (fitted, true, start), the
    last loss, the median seconds a step and the megakernel launches."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.grad import make_soft_train_step
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
    from raytracingproject_tpu_torch.render import render
    from raytracingproject_tpu_torch.scene import make_cover_scene

    dev = torch.device("cuda")
    scene = make_cover_scene(0)
    n = scene.num_spheres
    sphere = n - 2
    check(scene.center0[sphere].tolist() == [-4.0, 1.0, 0.0], "E1: sphere n - 2 is at (-4, 1, 0)")
    cam = Camera(aspect_ratio=16.0 / 9.0, image_width=128, samples_per_pixel=2, max_depth=3,
                 vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0), defocus_angle=0.0)
    oracle = RenderSettings(device="cuda", use_megakernel=False, use_bvh=False)
    target = render(scene, cam, torch.Generator(device=dev).manual_seed(target_seed), oracle)
    true_c = scene.center0[sphere].double().numpy()
    true_r = scene.radius[sphere].item()
    c0 = scene.center0.clone()
    c0[sphere] += torch.tensor([0.25, -0.15, 0.2])
    radius = scene.radius.clone()
    radius[sphere] *= 0.8
    wrong = dataclasses.replace(scene, center0=c0, radius=radius)
    params, opt, step = make_soft_train_step(
        wrong, cam, optimizer=lambda ps: torch.optim.Adam(ps, lr=2e-2), spp=2, softness=0.05,
        trainable=("center0", "radius"), candidates_k=8,
        generator=torch.Generator(device=dev).manual_seed(step_seed))
    held = torch.ones(n, dtype=torch.bool, device=dev)
    held[sphere] = False
    n_steps = 160
    secs = []
    mk.reset_launches()
    for i in range(n_steps):
        w = 0.05 * (0.003 / 0.05) ** (i / (n_steps - 1))
        old = (params.center0.detach().clone(), params.radius.detach().clone())
        (params, opt, loss, _), sec = synced_s(
            lambda: step(params, opt, None, target, w))  # noqa: B023
        secs.append(sec)
        with torch.no_grad():  # every sphere but the target one is held
            params.center0[held] = old[0][held]
            params.radius[held] = old[1][held]
    got_c = params.center0[sphere].detach().double().cpu().numpy()
    got_r = params.radius[sphere].item()
    lookfrom = np.array([13.0, 2.0, 3.0])
    return {
        "err": np.abs(got_c - true_c), "centre": got_c, "radius": got_r,
        "ang": got_r / np.linalg.norm(lookfrom - got_c),
        "ang_true": true_r / np.linalg.norm(lookfrom - true_c),
        "ang_start": 0.8 * true_r / np.linalg.norm(lookfrom - true_c
                                                   - np.array([0.25, -0.15, 0.2])),
        "loss": loss.item(), "step_s": statistics.median(secs[2:]),
        "launches": sum(mk.LAUNCHES.values()),
    }


def soft_step(card: str) -> None:
    """Phase E1, the silhouette estimator at cover scale: `soft_recovery`
    for each of E1_SEEDS. Every run must improve on the start (y and z
    errors below the start's 0.15 and 0.2); the median over the runs of
    each axis's error must meet the JAX test's bounds (y and z below 0.08,
    x, the depth axis, below 0.40), and so must the median angular-size
    error (below 10% of the truth, and below 0.4 of the start's)."""
    import numpy as np

    t_phase = time.perf_counter()
    runs = [soft_recovery(*seeds) for seeds in E1_SEEDS]
    for seeds, r in zip(E1_SEEDS, runs):
        print(f"E1 soft step, seeds {seeds} (cover, 128x72, 2 spp, depth 3, k 8, 160 steps): "
              f"loss {r['loss']:.6f}; centre {r['centre'].round(4).tolist()}, error "
              f"{r['err'].round(4).tolist()}; radius {r['radius']:.4f}; angular size "
              f"{r['ang']:.5f} vs {r['ang_true']:.5f} (start {r['ang_start']:.5f}); seconds per "
              f"step (median) {r['step_s']:.4f} s")
        check(r["launches"] == 0, "E1: the soft step launches no megakernel")
        check(r["err"][1] < 0.15 and r["err"][2] < 0.2, f"E1 {seeds}: the fit improved on the start")
    err = np.median([r["err"] for r in runs], axis=0)
    ang_true, ang_start = runs[0]["ang_true"], runs[0]["ang_start"]
    ang_err = float(np.median([abs(r["ang"] - ang_true) for r in runs]))
    print(f"E1 median over {len(runs)} runs: centre error {err.round(4).tolist()} (bounds 0.40, "
          f"0.08, 0.08), angular-size error {ang_err:.5f} (bounds {0.10 * ang_true:.5f}, "
          f"{0.4 * abs(ang_start - ang_true):.5f}); seconds per step (median) "
          f"{float(np.median([r['step_s'] for r in runs])):.4f} s; "
          f"{time.perf_counter() - t_phase:.1f} s; on {card}")
    check(err[1] < 0.08 and err[2] < 0.08 and err[0] < 0.40,
          "E1: the median centre error within the JAX bounds")
    check(ang_err < 0.10 * ang_true and ang_err < 0.4 * abs(ang_start - ang_true),
          "E1: the median angular-size error within the JAX bounds")


def session_loop(mk, card: str) -> None:
    """Phase S1, the session: RendererSession with the default settings
    (1024x768, 4 spp, depth 8, two frames in flight, the megakernel with
    the front, on the card), init, load_preconfigured_shapes and a
    3-second interactive loop, K3's launches counted."""
    import numpy as np

    from raytracingproject_tpu_torch import RendererSession

    t_phase = time.perf_counter()
    s = RendererSession()
    s.init()
    s.load_preconfigured_shapes()
    s.draw_frame()  # warm: the first frame's host work
    s.flush()
    mk.reset_launches()
    t0 = time.perf_counter()
    frames = s.start_interactive_loop(duration_ms=3000)
    loop_s = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    print(f"S1 session (defaults: {s.settings.width}x{s.settings.height}, "
          f"{s.camera.samples_per_pixel} spp, depth {s.camera.max_depth}, "
          f"{s.settings.max_frames_in_flight} frames in flight): {frames} frames in {loop_s:.3f} s "
          f"= {frames / loop_s:.3f} frames/s; launches {({k: v for k, v in launches.items() if v})}; "
          f"{s.dump_device_info()}; {time.perf_counter() - t_phase:.1f} s; on {card}")
    check(frames > 0 and launches["front"] > 0, "S1: the session loop rendered through K3")
    check(s.last_frame is not None and s.last_frame.shape == (768, 1024, 3)
          and bool(np.isfinite(s.last_frame).all()), "S1: the last frame is finite, 768x1024x3")


def sharded_one_card(mk, card: str) -> dict:
    """Phase P1, the sharded paths on one card: a 1x1 mesh of an NCCL
    world of one (`make_mesh()`). `render_sharded` with the megakernel
    and the front at the reference configuration (400x225, 30 spp, depth
    50) through K3, its mean within 5% of `render`'s; the sharded train
    step on the cover scene at 400x225, 2 spp, depth 50 (the brute K5
    forward on geometry + albedo, the front form on materials, and
    two_phase=4) and the sharded soft step at E1's size (cover 128x72, 2
    spp, depth 3, k 8), each step's loss and gradients against the
    unsharded step's on the shard's derived generator (the same rays and
    seed): loss within 1e-5 relative, every gradient within 1e-5 of the
    largest (the replay's atomic adds run in no fixed order on the card:
    the unsharded step run twice gives the floor). Seconds per step of
    both, in turns: the collectives' cost on a world of one. Returns the
    launches of each path."""
    import dataclasses
    import statistics

    import torch
    import torch.distributed as dist

    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.grad import (
        SceneParams, make_fast_train_step, make_soft_train_step,
    )
    from raytracingproject_tpu_torch.parallel import (
        make_mesh, make_sharded_soft_train_step, make_sharded_train_step, render_sharded,
    )
    from raytracingproject_tpu_torch.parallel.shard import draw_base, shard_generator
    from raytracingproject_tpu_torch.render import prepare_scene, render
    from raytracingproject_tpu_torch.scene import make_cover_scene

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    mesh = make_mesh()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and tuple(mesh.shape) == (1, 1), "P1: make_mesh() is a 1x1 mesh of an NCCL world of one")
    paths = {}

    # ---- P1a. render_sharded: megakernel + front at the reference configuration ----
    ref_cam = Camera(**COVER_CAMERA, samples_per_pixel=30, max_depth=50)
    settings = RenderSettings(device="cuda")
    scene, front = prepare_scene(make_cover_scene(0), ref_cam, settings)
    render_sharded(scene, ref_cam, gen(0), mesh, use_megakernel=True, front=front)  # warm
    mk.reset_launches()
    img, shard_s = synced_s(lambda: render_sharded(scene, ref_cam, gen(1), mesh,
                                                   use_megakernel=True, front=front))
    paths["render_sharded"] = {k: v for k, v in mk.LAUNCHES.items() if v}
    ref, render_s = synced_s(lambda: render(make_cover_scene(0), ref_cam, gen(1), settings))
    m_s, m_r = img.mean().item(), ref.mean().item()
    print(f"P1 render_sharded (1x1 NCCL mesh, megakernel + front, 400x225, 30 spp, depth 50): "
          f"launches {paths['render_sharded']}; mean {m_s:.5f} vs render's {m_r:.5f}; "
          f"{shard_s:.4f} s vs render's {render_s:.4f} s on {card}")
    check(paths["render_sharded"] == {"front": 30},
          "P1: render_sharded went through K1 with K3 alone, one launch a sample")
    check(tuple(img.shape) == (225, 400, 3) and torch.isfinite(img).all().item(),
          "P1: the sharded image is finite, 225x400x3")
    check(abs(m_s - m_r) <= 0.05 * m_r, "P1: the sharded mean within 5% of render's")

    # ---- P1b. the sharded train steps against make_fast_train_step ----
    cam = Camera(**COVER_CAMERA, samples_per_pixel=2, max_depth=50)
    target = render(make_cover_scene(0), Camera(**COVER_CAMERA, samples_per_pixel=16,
                                                max_depth=50), gen(5), settings)
    geo = perturbed_cover("geometry").to(dev)
    mat, mat_front = prepare_scene(perturbed_cover("materials").to(dev), cam, settings)
    configs = {  # start, make_fast_train_step's keywords, Adam's rate, the launch key
        "brute K5 (geometry + albedo)": (geo, dict(trainable=("albedo", "center0", "radius")),
                                         2e-3, "record_brute_chunked"),
        "front K5 (materials)": (mat, dict(trainable=("albedo", "fuzz", "ior"), front=mat_front),
                                 1e-2, "record_front"),
        "two-phase 4 (brute, geometry + albedo)": (
            geo, dict(trainable=("albedo", "center0", "radius"), two_phase=4), 2e-3,
            "segment_record_brute_chunked"),
    }

    def grad_err(a, b):
        scale = max(getattr(b, f).abs().max().item() for f in SceneParams._fields)
        return max((getattr(a, f) - getattr(b, f)).abs().max().item()
                   for f in SceneParams._fields) / scale

    for name, (start, kw, lr, key) in configs.items():
        sp, so, sstep = make_sharded_train_step(start, cam, mesh, spp=2, use_megakernel=True,
                                                learning_rate=lr, **kw)
        up, uo, ustep = make_fast_train_step(start, cam, spp=2, learning_rate=lr, **kw)
        rp, ro, _ = make_fast_train_step(start, cam, spp=2, learning_rate=lr, **kw)
        mk.reset_launches()
        _, _, sloss, sg = sstep(sp, so, gen(3), target)
        torch.cuda.synchronize()
        launches = {k: v for k, v in mk.LAUNCHES.items() if v}
        paths[name] = launches
        shard_gen = lambda: shard_generator(draw_base(gen(3)), 0, 0, dev)  # noqa: E731
        _, _, uloss, ug = ustep(up, uo, shard_gen(), target)
        _, _, rloss, rg = ustep(rp, ro, shard_gen(), target)
        l_err, g_err, floor = (abs(sloss.item() - uloss.item()) / abs(uloss.item()),
                               grad_err(sg, ug), grad_err(rg, ug))
        print(f"P1 sharded step, {name} (cover 400x225, 2 spp, depth 50): loss "
              f"{sloss.item():.9f} vs unsharded {uloss.item():.9f} (relative {l_err:.2e}); max "
              f"|grad diff| / max |grad| {g_err:.2e} (the unsharded step twice: {floor:.2e}); "
              f"launches {launches}")
        check(launches.get(key, 0) > 0 and sum(launches.values()) == sum(
            v for k, v in launches.items() if k.startswith(("record_", "segment_record_"))),
            f"P1 {name}: the step went through the recording kernels ({key})")
        check(l_err <= 1e-5 and g_err <= 1e-5,
              f"P1 {name}: loss and gradients within 1e-5 of the unsharded step's")
        secs = {"sharded": [], "unsharded": []}
        for _ in range(5):  # in turns, one step each a round
            for form, (step, p, o) in (("sharded", (sstep, sp, so)),
                                       ("unsharded", (ustep, up, uo))):
                (_, _, loss, _), sec = synced_s(lambda: step(p, o, None, target))  # noqa: B023
                secs[form].append(sec)
                check(torch.isfinite(loss).item(), f"P1 {name} {form}: finite loss")
        s_med, u_med = statistics.median(secs["sharded"][1:]), statistics.median(
            secs["unsharded"][1:])
        print(f"P1 seconds per step, {name} (in turns, median of 4 warm rounds): sharded "
              f"{s_med:.4f} s, unsharded {u_med:.4f} s, ratio {s_med / u_med:.3f} on {card}")

    # ---- P1c. the sharded soft step at E1's size ----
    soft_cam = Camera(aspect_ratio=16.0 / 9.0, image_width=128, samples_per_pixel=2, max_depth=3,
                      vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      defocus_angle=0.0)
    cover = make_cover_scene(0)
    soft_target = render(cover, soft_cam, gen(0), RenderSettings(device="cuda",
                                                                 use_megakernel=False,
                                                                 use_bvh=False))
    c0 = cover.center0.clone()
    c0[cover.num_spheres - 2] += torch.tensor([0.25, -0.15, 0.2])
    wrong = dataclasses.replace(cover, center0=c0)
    kw = dict(spp=2, softness=0.05, trainable=("center0", "radius"), candidates_k=8)
    sp, so, sstep = make_sharded_soft_train_step(wrong, soft_cam, mesh, **kw)
    up, uo, ustep = make_soft_train_step(wrong, soft_cam, **kw)
    mk.reset_launches()
    _, _, sloss, sg = sstep(sp, so, gen(7), soft_target, 0.02)
    launches = sum(mk.LAUNCHES.values())
    _, _, uloss, ug = ustep(up, uo, shard_generator(draw_base(gen(7)), 0, 0, dev), soft_target,
                            0.02)
    l_err, g_err = abs(sloss.item() - uloss.item()) / abs(uloss.item()), grad_err(sg, ug)
    secs = {"sharded": [], "unsharded": []}
    for _ in range(6):
        for form, (step, p, o) in (("sharded", (sstep, sp, so)), ("unsharded", (ustep, up, uo))):
            (_, _, loss, _), sec = synced_s(lambda: step(p, o, None, soft_target))  # noqa: B023
            secs[form].append(sec)
    s_med, u_med = statistics.median(secs["sharded"][1:]), statistics.median(
        secs["unsharded"][1:])
    print(f"P1 sharded soft step (cover 128x72, 2 spp, depth 3, k 8): loss {sloss.item():.9f} vs "
          f"unsharded {uloss.item():.9f} (relative {l_err:.2e}); max |grad diff| / max |grad| "
          f"{g_err:.2e}; megakernel launches {launches}; seconds per step (in turns, median of 5 "
          f"warm rounds) sharded {s_med:.4f} s, unsharded {u_med:.4f} s, ratio "
          f"{s_med / u_med:.3f}; {time.perf_counter() - t_phase:.1f} s; on {card}")
    check(launches == 0, "P1: the soft step launches no megakernel")
    check(l_err <= 1e-5 and g_err <= 1e-5,
          "P1 soft step: loss and gradients within 1e-5 of the unsharded step's")
    dist.destroy_process_group()
    return paths


def count_syncs(fn):
    """(fn(), {(file, line): count}): the synchronising CUDA calls fn()
    made, by the Python line that made them (torch's sync debug mode at
    "warn", each of its warnings recorded)."""
    import collections
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter((Path(w.filename).name, w.lineno) for w in caught
                                    if "synchronizing" in str(w.message))


def plain_hit_wavefront(wf, scene, cd, generator, width: int, height: int, spp: int,
                        max_depth: int, pool_size: int) -> tuple:
    """`render_wavefront`'s loop with `ops.intersect.closest_hit` where
    its bounce takes K4 (`wf.refill`, the plain closest hit, `wf.shade`):
    a comparison on the card, never a route the renderer takes. Returns
    (radiance sum [npix, 3], iterations)."""
    import torch

    from raytracingproject_tpu_torch.config import T_MIN
    from raytracingproject_tpu_torch.ops.intersect import closest_hit

    npix, total, dev = width * height, width * height * spp, cd.center.device
    key = int(torch.randint(0, 2**62, (1,), generator=generator, device=dev))
    acc = torch.zeros((npix, 3), device=dev)
    pool = wf._empty_pool(pool_size, torch.float32, dev)
    nxt = torch.zeros((), dtype=torch.int64, device=dev)
    iterations, running = 0, True
    while running:
        pool, nxt = wf.refill(pool, nxt, total, cd, width, npix, key)
        rec = closest_hit(pool.origin, pool.direction, pool.time, scene.center0,
                          scene.center_delta, scene.radius, t_min=T_MIN)
        pool, acc = wf.shade(pool, rec, acc, scene, generator, max_depth)
        iterations += 1
        queued, live = torch.stack([nxt, pool.alive.sum()]).tolist()
        running = queued < total or live > 0
    return acc, iterations


def wavefront_phase(mk, trace, card: str, megakernel_mean: float) -> int:
    """Phase W1, the wavefront: `render_wavefront_image` on the cover
    scene at the reference configuration (400x225, 30 spp, depth 50), its
    closest hit K4 once an iteration, its host reads counted by torch's
    sync debug mode (one an iteration, the loop's condition; the others,
    the key's and the set-up's, fewer than a bench frame's iterations), finite,
    its mean within 5% of the front megakernel's render; two runs from one
    seed bit-equal; K4 held against its plain version (and
    `ops.intersect.closest_hit`) on the bench shape's pool mid-run, every
    slot live, and late, with dead, stale slots; Mrays/s at the bench shape
    (400x225, 4 spp, depth 16) beside `render`'s (the front megakernel),
    in turns; the same loop with the plain `closest_hit` on the card,
    timed once as a comparison; the refill's, the bounce's, K4's and the
    accumulation's ms an iteration on the mid-run pool. Returns K4's
    launches on the wavefront's main path."""
    import statistics

    import torch

    from raytracingproject_tpu_torch import wavefront as wf
    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.render import render
    from raytracingproject_tpu_torch.scene import make_cover_scene

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    settings = RenderSettings(device="cuda")
    cover = make_cover_scene(0)
    ref_cam = Camera(**COVER_CAMERA, samples_per_pixel=30, max_depth=50)
    bench_cam = Camera(**COVER_CAMERA, samples_per_pixel=4, max_depth=16)
    wf.render_wavefront_image(cover, bench_cam, gen(0), settings)  # warm
    bench_stats = {}
    _, bench_sites = count_syncs(lambda: wf.render_wavefront_image(cover, bench_cam, gen(2),
                                                                   settings, stats=bench_stats))

    trace.reset_launches()
    mk.reset_launches()
    stats = {}
    img, sites = count_syncs(lambda: wf.render_wavefront_image(cover, ref_cam, gen(1), settings,
                                                               stats=stats))
    launches = trace.LAUNCHES["closest_hit"]
    mean = img.mean().item()
    again, frame_s = synced_s(lambda: wf.render_wavefront_image(cover, ref_cam, gen(1), settings))
    iters, reads = stats["iterations"], sum(sites.values())
    per_frame = {"reference": reads - iters, "bench": sum(bench_sites.values()) - bench_stats["iterations"]}
    print(f"W1 wavefront (cover, 400x225, 30 spp, depth 50, pool "
          f"{wf.wavefront_pool_size(400 * 225 * 30, settings.rays_per_batch)}): {iters} "
          f"iterations, {reads} host reads (synchronising CUDA calls, torch's sync debug mode; "
          f"by line: {', '.join(f'{f}:{ln} x{n}' for (f, ln), n in sites.most_common())}), "
          f"closest_hit launches {launches}, megakernel launches {sum(mk.LAUNCHES.values())}; "
          f"mean {mean:.5f} vs the front megakernel's {megakernel_mean:.5f}; {frame_s:.4f} s a "
          f"frame (the second run) on {card}")
    print(f"W1 host reads less iterations: {per_frame['reference']} a reference frame, "
          f"{per_frame['bench']} a bench frame ({bench_stats['iterations']} iterations)")
    check(launches == iters > 0 and sum(mk.LAUNCHES.values()) == 0,
          "W1: the wavefront's closest hit is K4, once an iteration")
    # fewer than the bench frame's 21 iterations: no other read comes once an iteration
    check(sites.most_common(1)[0][1] == iters
          and max(per_frame.values()) < bench_stats["iterations"],
          "W1: one host read an iteration (the loop's condition), the others once a frame")
    check(tuple(img.shape) == (225, 400, 3) and torch.isfinite(img).all().item(),
          "W1: the wavefront image is finite, 225x400x3")
    check(abs(mean - megakernel_mean) <= 0.05 * megakernel_mean,
          "W1: the wavefront's mean within 5% of the megakernel render's")
    diff = (again - img).abs().max().item()
    print(f"W1 two runs from one seed: bit-equal {torch.equal(again, img)}, max |diff| {diff:.3e}")
    check(torch.equal(again, img), "W1: two wavefront runs from one seed are bit-equal")

    # K4 at the wavefront's own shape: the bench shape's pool after 3 iterations, refilled
    # (every slot live), and after the queue drained (dead slots keep their stale rays)
    n_rays = 400 * 225 * 4
    w, h = bench_cam.image_size()
    pool = wf.wavefront_pool_size(n_rays, settings.rays_per_batch)
    cd = bench_cam.derive(torch.float32, dev)
    cov = cover.to(dev)
    key = 12345
    acc = torch.zeros((w * h, 3), device=dev)
    p = wf._empty_pool(pool, torch.float32, dev)
    nxt = torch.zeros((), dtype=torch.int64, device=dev)
    g = gen(11)
    for _ in range(3):
        p, nxt = wf.refill(p, nxt, n_rays, cd, w, w * h, key)
        p, acc = wf.bounce(p, acc, cov, g, 16)
    live = int(p.alive.sum())
    p_full, _ = wf.refill(p, nxt, n_rays, cd, w, w * h, key)
    check(bool(p_full.alive.all()), "W1: the mid-run pool is full after its refill")
    hold_closest_hit(trace, "wavefront pool, mid-run, all live", p_full.origin,
                     p_full.direction, p_full.time, cov)
    p_late, nxt_late, acc_late = p, nxt, acc.clone()
    while int(nxt_late) < n_rays:
        p_late, nxt_late = wf.refill(p_late, nxt_late, n_rays, cd, w, w * h, key)
        p_late, acc_late = wf.bounce(p_late, acc_late, cov, g, 16)
    dead = int((~p_late.alive).sum())
    check(0 < dead < pool, "W1: the late pool holds live and dead slots")
    hold_closest_hit(trace, f"wavefront pool, queue drained, {dead} dead slots",
                     p_late.origin, p_late.direction, p_late.time, cov)

    render(cover, bench_cam, gen(0), settings)  # warm
    secs = {"wavefront": [], "megakernel (front)": []}
    for k in range(4):  # in turns
        for name, fn in (("wavefront", lambda: wf.render_wavefront_image(  # noqa: B023
                cover, bench_cam, gen(10 + k), settings)),  # noqa: B023
                         ("megakernel (front)", lambda: render(cover, bench_cam,  # noqa: B023
                                                               gen(10 + k), settings))):
            secs[name].append(synced_s(fn)[1])
    med = {k: statistics.median(v[1:]) for k, v in secs.items()}
    (_, plain_iters), plain_s = synced_s(lambda: plain_hit_wavefront(
        wf, cov, cd, gen(10), w, h, 4, 16, pool))
    print(f"W1 bench shape (400x225, 4 spp, depth 16; in turns, median of 3 warm frames): "
          f"wavefront {med['wavefront']:.4f} s = {n_rays / med['wavefront'] / 1e6:.3f} Mrays/s "
          f"(pool {pool}), render (front megakernel) "
          f"{med['megakernel (front)']:.4f} s = {n_rays / med['megakernel (front)'] / 1e6:.3f} "
          f"Mrays/s, ratio {med['wavefront'] / med['megakernel (front)']:.2f}; the wavefront "
          f"loop with the plain closest_hit (comparison only, once, {plain_iters} iterations) "
          f"{plain_s:.4f} s = {n_rays / plain_s / 1e6:.3f} Mrays/s; on {card}")

    contrib = torch.rand((pool, 3), device=dev)
    tab = trace.sphere_table(cov)
    refill_ms = cuda_ms(lambda: wf.refill(p, nxt, n_rays, cd, w, w * h, key), 20)
    bounce_ms = cuda_ms(lambda: wf.bounce(p_full, acc.clone(), cov, g, 16), 20)
    acc_ms = cuda_ms(lambda: wf.accumulate(acc, p_full.pixel, contrib), 20)
    k4_ms = cuda_ms(lambda: trace.closest_hit_fused(p_full.origin, p_full.direction,
                                                    p_full.time, tab), 20)
    print(f"W1 one iteration at the bench shape (pool {pool}, {live} live before the refill): "
          f"refill {refill_ms:.4f} ms, bounce {bounce_ms:.4f} ms (K4 {k4_ms:.4f} ms, the "
          f"accumulation {acc_ms:.4f} ms), by CUDA events; {time.perf_counter() - t_phase:.1f} s; "
          f"on {card}")
    return launches


def main() -> int:
    import torch

    args = sys.argv[1:]
    if args not in ([], ["--row-widths"]):
        print("usage: python3 chip_smoke.py [--row-widths]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.color import to_u8
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.ops.cuda import build
    from raytracingproject_tpu_torch.grad import make_fast_train_step, make_train_step
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
    from raytracingproject_tpu_torch.ops.cuda import trace
    from raytracingproject_tpu_torch.ops.rng import bounce_bits
    from raytracingproject_tpu_torch.probes.roofline import card_line
    from raytracingproject_tpu_torch.render import (
        _slot_rays, prepare_scene, render, render_image,
    )
    from raytracingproject_tpu_torch.scene import make_cover_scene
    from raytracingproject_tpu_torch.utils.ppm import read_ppm

    card = card_line()
    print(card)  # name, power limit: nvidia-smi's own line
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args == ["--row-widths"]:
        row_widths(mk, card)
        return 0

    # ---- 1. build ----
    build.build()  # every source under csrc/, one nvcc each, started together
    for name in build.LIBRARIES:
        build.load_library(name)
    print(f"build: nvcc {build.BUILD_INFO['seconds']:.1f} s for {len(build.LIBRARIES)} sources")
    for line in str(build.BUILD_INFO["log"]).splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or line.startswith("==")):
            print(f"  ptxas: {line.strip()}")
    all_regs = build.kernel_registers(str(build.BUILD_INFO["log"]))
    regs = {k: v for k, v in all_regs.items() if isinstance(k, tuple)}  # trace_kernel's
    for key in sorted(regs):
        print(f"  {instantiation(key)}: {regs[key][0]} registers, {regs[key][1]} B spill stores, "
              f"{regs[key][2]} B stack frame")
    check(len(regs) == N_INSTANTIATIONS,
          f"{N_INSTANTIATIONS} instantiations of trace_kernel (got {len(regs)})")
    lib = build.load_library()
    for kind in CHUNKED_KINDS:  # the chunked scan's occupancy, as the launch gets it
        key, blocks = (2, *kind, 0), ctypes.c_int()
        build.check(lib.rtp_chunked_blocks_per_sm(*kind, ctypes.byref(blocks)), "occupancy")
        print(f"  {instantiation(key)}: {regs[key][0]} registers, {regs[key][1]} B spill "
              f"stores, {blocks.value} blocks of {mk.TILE} threads per SM")
    key = (2, 0, 0, 0, 1)  # the planted fault: the forward chunked scan's shared memory
    print(f"  {instantiation(key)}: {regs[key][0]} registers, {regs[key][1]} B spill stores")

    k4_regs = build.named(all_regs, "closest_hit_kernel")
    occ = trace.closest_hit_occupancy()
    print(f"  closest_hit_kernel: {k4_regs[0]} registers, {k4_regs[1]} B spill stores, "
          f"{occ['blocks_per_sm']} blocks of {occ['threads']} threads (one ray each) per SM")

    # ---- 1b. the probes: the card's measured peaks, which every bound below reads ----
    probe_entries = probe_kernels(card, all_regs)

    # ---- 2. the generator: kernel against ops/rng.py, bit for bit ----
    ray = torch.arange(N_CMP, dtype=torch.int64, device=dev)
    for seed, bounce in ((0, 0), (123456789, 7), (2**31 - 2, 49)):
        got = mk.philox_bits(N_CMP, seed, bounce, dev)
        want = torch.stack(bounce_bits(seed, ray, bounce), dim=1)
        check(torch.equal(got, want), f"philox kernel == twin (seed {seed}, bounce {bounce})")
    print("rng: philox kernel bit-equal to the twin")

    # ---- 3./4. K1+K2 and K1+K3 against the twin, front against brute ----
    bench_cam = Camera(**COVER_CAMERA, samples_per_pixel=4, max_depth=16)
    settings = RenderSettings(device="cuda")
    scene, front = prepare_scene(make_cover_scene(0), bench_cam, settings)
    print(f"scene: {scene.num_spheres} spheres; front {front.ff.shape[1]} subtrees over "
          f"{front.sph.shape[1]} columns, repack {front.repack}")
    front_occupancy(lib, regs, front, "the cover front", card)
    gen = torch.Generator(device=dev).manual_seed(1)
    w, h = bench_cam.image_size()
    o, d, t = _slot_rays(bench_cam.derive(torch.float32, dev), w, h, 4, gen, None)
    oc, dc, tc = o[:N_CMP], d[:N_CMP], t[:N_CMP]
    max_err = {}
    outs = {}
    for path in ("brute", "front"):
        f = front if path == "front" else None
        for zero in (True, False):
            k = mk.trace_paths(oc, dc, tc, scene, 2024, 16, front=f, zero_draws=zero)
            p = mk.trace_paths_twin(oc, dc, tc, scene, 2024, 16, front=f, zero_draws=zero)
            torch.cuda.synchronize()
            check(torch.isfinite(k).all().item(), f"{path} kernel radiance finite")
            diff = torch.abs(k - p)
            frac = (diff <= 1e-3).all(dim=1).double().mean().item()
            mean = diff.mean().item()
            mx = diff.max().item()
            max_err[path] = max(max_err.get(path, 0.0), mx)
            print(f"{path} kernel vs twin ({'zero draws' if zero else 'philox'}, {N_CMP} rays, "
                  f"depth 16): {frac:.6f} within 1e-3, mean |diff| {mean:.3e}, max {mx:.3e}")
            check(frac >= 0.999, f"{path}: >= 99.9% of rays within 1e-3")
            check(mean < 1e-5, f"{path}: mean |diff| < 1e-5")
            check(torch.equal(k, p), f"{path} ({'the chunked kernel' if path == 'brute' else 'K3'}"
                  "): bit-equal to the plain version")
            if not zero:
                outs[path] = k
    differ = (torch.abs(outs["brute"] - outs["front"]) > 1e-3).any(dim=1).double().mean().item()
    print(f"front vs brute kernel: {differ:.6f} of rays differ by > 1e-3")
    check(differ <= 1e-3, "front and brute kernels differ on <= 0.1% of rays")

    # ---- 5. the main path through the normal entry points ----
    ref_cam = Camera(**COVER_CAMERA, samples_per_pixel=30, max_depth=50)
    cover = make_cover_scene(0)
    mk.reset_launches()
    img_u8 = render_image(cover, ref_cam, settings=settings)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render(cover, ref_cam, settings=settings)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    img_brute = render(cover, ref_cam, settings=RenderSettings(device="cuda", use_bvh=False))
    torch.cuda.synchronize()
    launches = dict(mk.LAUNCHES)
    print(f"main path: render_image + render (front), render (brute) at 400x225, 30 spp, "
          f"depth 50: kernel launches {launches}")
    check(launches["front"] > 0 and launches[launch_key("brute")] > 0,
          "both kernels ran on the main path")
    check(tuple(img.shape) == (225, 400, 3) and torch.isfinite(img).all().item(),
          "front image finite, 225x400x3")
    check(torch.isfinite(img_brute).all().item(), "brute image finite")
    check(torch.equal(img_u8, to_u8(img)), "render_image == to_u8(render) (same seed)")
    twin_cam = Camera(**COVER_CAMERA, samples_per_pixel=4, max_depth=50)
    img_twin = render(cover, twin_cam, settings=settings, tracer=mk.trace_paths_twin)
    m_k, m_b, m_t = img.mean().item(), img_brute.mean().item(), img_twin.mean().item()
    print(f"image means: front kernel {m_k:.5f}, brute kernel {m_b:.5f}, twin at 4 spp {m_t:.5f}")
    check(abs(m_k - m_t) <= 0.05 * m_t, "kernel mean within 5% of the twin's")
    check(abs(m_b - m_t) <= 0.05 * m_t, "brute kernel mean within 5% of the twin's")
    print(f"seconds per frame (front, 400x225, 30 spp, depth 50): {frame_s:.4f} s on {card}")

    # ---- 6. the CLI ----
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "cover.ppm"
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        res = subprocess.run([sys.executable, "-m", "raytracingproject_tpu_torch", "--scene",
                              "cover", "-o", str(out)], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=600)
        print(f"cli: rc {res.returncode}; {res.stderr.strip().splitlines()[-1]}")
        check(res.returncode == 0, f"CLI exit 0 (stderr: {res.stderr[-2000:]})")
        ppm = read_ppm(out)
        m = re.search(r"front=(\d+)", res.stderr)
        check(m is not None and int(m.group(1)) > 0, "CLI went through the front kernel")
        check("on cuda" in res.stderr, "CLI rendered on the card")
        check(ppm.shape == (225, 400, 3), "CLI PPM is 400x225")
        print(f"cli: PPM read back, {ppm.shape}, mean {ppm.mean():.3f}")

    # ---- 7. times at the bench shape (400x225, 4 spp, depth 16) ----
    n_rays = w * h * 4
    kernels = []
    counts = {}
    for path in ("brute", "front"):
        f = front if path == "front" else None

        def kern():
            mk.trace_paths(o, d, t, scene, 99, 16, front=f)

        def twin():
            mk.trace_paths_twin(o, d, t, scene, 99, 16, front=f)

        kern()
        twin()  # warm both
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(twin, 2)
        print(f"{path}: kernel {ms:.3f} ms = {n_rays / ms / 1e3:.3f} Mrays/s; twin "
              f"{plain_ms:.3f} ms = {n_rays / plain_ms / 1e3:.3f} Mrays/s "
              f"({n_rays} camera rays, depth 16) on {card}")
        counts[path] = count_tests(mk, o, d, t, scene, f, 99, 16)
        tab_bytes = 4 * (scene.num_spheres * mk.N_ROWS if f is None
                         else f.sph.numel() + f.ff.numel())
        b_ms, b_by = megakernel_bound(counts[path], n_rays, 16, tab_bytes, record=False)
        print(f"{path}: these rays need {counts[path]}; bound {b_ms:.4f} ms by {b_by}, the "
              f"kernel reaches {b_ms / ms:.3f} of it")
        print_yardstick(path, counts[path], ms, lambda c: megakernel_bound(  # noqa: B023
            c, n_rays, 16, tab_bytes, record=False))  # noqa: B023
        kernels.append({
            "name": entry_name(path), "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[launch_key(path)], "launches": launches[launch_key(path)],
            "max_abs_err": max_err[path], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "pairs": counts[path]["pairs"],
        })

    # ---- 8. K5 (brute and front) against its plain version ----
    rec_err = record_against_twin(mk, scene, front, oc, dc, tc)

    # ---- 9. the replay on the card ----
    replay_on_card(mk, scene, front, oc, dc, tc)

    # ---- 10. the training path at full width (cover, 400x225, 2 spp, depth 50) ----
    train_launches, step_s, train_err = train_full_width(mk, card)

    # ---- 11. descent ----
    descent(make_fast_train_step, "fast path")

    # ---- 12. times: K5 and the replay at the bench shape, the step's split ----
    rec_times = time_training(mk, scene, front, o, d, t, card)
    for name, sec in step_s.items():
        print(f"seconds per train step, {name}, cover 400x225, 2 spp, depth 50: {sec:.4f} s "
              f"on {card}")
    step_split(card)
    for path in ("brute", "front"):
        key = f"record_{path}"
        ms, plain_ms = rec_times[path]
        f = front if path == "front" else None
        tab_bytes = 4 * (scene.num_spheres * mk.N_ROWS if f is None
                         else f.sph.numel() + f.ff.numel())
        b_ms, b_by = megakernel_bound(counts[path], n_rays, 16, tab_bytes, record=True)
        print(f"record_{path}: bound {b_ms:.4f} ms by {b_by}, the kernel reaches "
              f"{b_ms / ms:.3f} of it")
        print_yardstick(key, counts[path], ms, lambda c: megakernel_bound(  # noqa: B023
            c, n_rays, 16, tab_bytes, record=True))  # noqa: B023
        kernels.append({
            "name": entry_name(key), "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[launch_key(key)], "launches": train_launches[launch_key(key)],
            "max_abs_err": max(rec_err[path], train_err[path]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "pairs": counts[path]["pairs"],
        })

    # ---- 12e. large scenes: chunked brute, K8, K5 bvh and K7 on up to 50,000 spheres ----
    kernels.extend(large_scenes(mk, trace, card))

    # ---- 12i. K3 on 2,000 and 3,000 spheres ----
    front_large(mk, lib, regs, card)

    # ---- 12f. the depth tail: K6 (two-phase, segmented) and K1's record_miss ----
    kernels.extend(depth_tail(mk, card))

    # ---- 12g. K3's options (sub_block, word_earlyout) ----
    kernels.extend(front_options(mk, card))

    # ---- 12h. K1's planted fault (schlick3) and the per-material-region statistic ----
    kernels.append(region_statistic(mk, card))

    # ---- 13. K4 against its plain version, and its time at the main path's shape ----
    k4_err, k4_ms, k4_plain_ms, (k4_bound_ms, k4_bound_by), k4_pairs = closest_hit_against_twin(
        trace, card)

    # ---- 14. the oracle's main path (render_image, render with K4), K4 end to end, the BVH walk
    k4_launches = oracle_frame(trace, card, m_k)
    kernels.append({
        "name": "closest_hit", "route": "cuda", "source": K4_SOURCE,
        "replaces": REPLACES["closest_hit"], "launches": k4_launches, "max_abs_err": k4_err,
        "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound_ms,
        "bound_by": k4_bound_by, "library_ms": None, "pairs": k4_pairs,
    })

    oracle_profile(trace, card)

    # ---- 15. the oracle's train step at 200 px, depth 8 (cover and three-sphere) ----
    oracle_train(trace, card)

    # ---- 16. descent through the oracle ----
    descent(make_train_step, "oracle")

    # ---- 17. the oracle's gradients against the replay of its own record ----
    oracle_against_replay(card)

    # ---- 18. G1-G3: geometry training on the front-culled kernel (refreshed tables) ----
    geometry_training(mk, card)

    # ---- 19. E1: the silhouette estimator's cover-scale recovery ----
    soft_step(card)

    # ---- 20. S1: the session's interactive loop ----
    session_loop(mk, card)

    # ---- 21. P1: the sharded paths on one card (a 1x1 NCCL mesh) ----
    sharded_launches = sharded_one_card(mk, card)

    # ---- 22. W1: the wavefront (K4 once an iteration) ----
    wf_launches = wavefront_phase(mk, trace, card, m_k)
    print(f"launches by path (this slice): {json.dumps(sharded_launches)}; wavefront "
          f"closest_hit {wf_launches}")
    kernels.extend(probe_entries)
    print(f"bounds at {ops_rate():.5g} instructions/s, the larger of the measured "
          f"{RATE['ops']:.5g} FFMA instructions/s and the data sheet's {PEAK_FP32 / 2:.4g} (its "
          f"{PEAK_FP32:.3g} operations/s count an FMA as two); mixed share: the closest hit's "
          f"sphere tests a second over the measured mixed peak, {RATE['pairs']:.5g}/s (the "
          f"mixed probe defines it, so it has none; like every kernel here it takes roots only "
          f"where a discriminant is positive); on {card}")
    for k in kernels:
        pairs = k.pop("pairs", None)
        mixed = (f", mixed share {pairs / k['ms'] * 1e3 / RATE['pairs']:.4f}"
                 if pairs and k["name"] != "probe_mixed" else "")
        print(f"  {k['name']}: {k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']}, share {k['bound_ms'] / k['ms']:.4f}{mixed}; launches "
              f"{k['launches']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
