"""Versions of the hand-written kernels against each other on one card:
the same kernels built from several source trees and timed in one
process, in turns (every tree, then every tree again in reverse order),
so that versions are compared under one card, one power limit and one
host.

    python -m raytracingproject_tpu_torch.probes.compare_builds [--frames] [--scans] [--bvh] \
        [--front] [--probes] NAME=DIR ...

Each DIR holds the CUDA sources of one version (closest_hit.cu,
megakernel.cu, probes.cu and common.cuh, as raytracingproject_tpu_torch/csrc
does; for the parent commit, unpack that directory of it with `git
archive`).
Each is built with the package's nvcc flags into a directory of its own
(one nvcc a source, all started together) and bound with the package's
ctypes signatures; the wrappers then launch whichever version is loaded.
Every version is checked bit-equal to the plain versions, then timed:

- K4 (`closest_hit_fused`) on the cover camera's 90,000 primary rays and
  on the same rays after one scatter (`pair_counts.cover_pass`), over the
  cover scene's 487 spheres;
- K6's front segment (`segment_call`, plain, miss planes, recording) on
  one pass of the reference configuration, 90,112 rays in slot order: the
  first segment, bounces [0, 4), from the camera rays, then the packed
  tail, bounces [4, 16), from the plain version's state after the first,
  packed alive-first (as chip_smoke.py's D1);
- with --frames, the reference frame (400x225, 30 spp, depth 50) through
  `render` with two_phase=4, with depth_segment=8 and monolithic on the
  front, monolithic on the brute scan (`use_bvh=False`), through the
  oracle with K4 and, with --scans too, on the 50,000 spheres (K7);
- with --scans, the brute scan and K7 (`scan_cases`): the brute scan's
  forward, recording, record_miss and planted-fault kernels on the cover
  scene at the bench shape (400x225, 4 spp, depth 16), its three K6
  segments on one pass cut at 4 then 12 bounces, its forward on one pass
  over `make_random_scene(2000 / 3000, seed=3)` (tables that fit shared
  memory) and, forward and recording, over `make_random_scene(50000,
  seed=3)`; K7 on one pass over the same 50,000 spheres with each front
  (plain, word_earlyout, sub_block) and with record_miss, and at the bench
  shape over 5,000 and 16,000 spheres; for their times beside these, K3
  and K5's front core on the cover scene at the bench shape and K8 on the
  50,000-sphere pass; each version's
  result bit-equal to the first version's on the same rays (and, on the
  cover scene, to the plain version's);
- with --bvh, K8's three instantiations (`bvh_cases`): the forward on one
  pass of the reference frame (90,112 rays in slot order, depth 16) over
  `make_random_scene(50000, seed=3)`'s leaf-8 tree and at the bench shape
  over 5,000, 16,000 and 50,000 spheres; K5's bvh core on that pass, at
  the bench shape on the same three and on one train step's 180,000 rays
  at depth 50 (2 spp, the step's draws); `record_miss` on one pass over
  the cover scene and over the 50,000 spheres; with --frames too, the 50,000-sphere
  reference frame through `render_pass(bvh=)`, the materials train step
  on those spheres through K5's bvh core and the geometry step on 5,000
  spheres through the chunked recording kernel (400x225, 2 spp, depth
  50, as chip_smoke.py's L6); each version's result bit-equal to the
  first version's;
- with --front, K3's nine instantiations and its neighbours (`front_cases`):
  K3 (forward) and K5's front core at the bench shape and `record_miss`
  on one pass over the cover scene's front as `render` builds it; K3's
  options (sub_block and word_earlyout) on the same cases, and K6's three
  front tails with word_earlyout on one pass cut at 4 then 12 bounces; K3
  on one pass over `render`'s fronts of make_random_scene(2000 / 3000,
  seed=3), the latter also at depth 0 (the table's staging); for their
  times beside these, the brute scan's forward and recording kernels on
  the cover bench shape, K7 and K8 on the 50,000-sphere pass; each
  version's result bit-equal to the first version's and, where the plain
  version is given, to it. A case a version fails to launch ends the
  comparison;
- with --probes, the probe kernels of probes.cu (`probe_cases`): the
  mixed peak on its full-wave synthetic rays; kfront's brute probe and
  its front probe at F = 24 and 48, and kexp's six variants, on the
  cover camera's primary rays over the cover scene and
  `make_random_scene(2000, seed=3)`; each bit-equal to its plain version
  and to the first version's result, timed by the profiler's device
  time (`device_ms`). --probes alone builds probes.cu alone and leaves
  out K4 and the front segments.
A version whose library still has the whole-table brute entry points
(`rtp_trace_brute`, ...) runs them where the table fits shared memory, as
its own wrapper did.

Prints the card, each version's registers (nvcc -Xptxas -v), one line per
version and turn, and a last JSON line with every time. Needs a card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from raytracingproject_tpu_torch.ops.cuda import build

SOURCES = ("closest_hit", "megakernel")
PROBE_SOURCE = "probes"
KINDS = ("plain", "miss", "record")
# The whole-table brute scan's entry points of the sources before every
# brute scan took the chunked kernel, and the chunked entry each stands for
# (the same arguments): n_spheres is argument 6 of the forward ones, 5 of
# the segment's.
_T = build._P, build._I, build._U, build._F
WHOLE_TABLE = {
    "rtp_trace_brute_chunked": ("rtp_trace_brute", 6, [_T[0]] * 4 + [_T[1], _T[0], _T[1], _T[2],
                                                       _T[1], _T[3], _T[1]] + [_T[0]] * 3),
    "rtp_record_brute_chunked": ("rtp_record_brute", 6, [_T[0]] * 4 + [
        _T[1], _T[0], _T[1], _T[2], _T[1], _T[3], _T[1]] + [_T[0]] * 6),
    "rtp_trace_brute_chunked_schlick3": ("rtp_trace_brute_schlick3", 6, [_T[0]] * 4 + [
        _T[1], _T[0], _T[1], _T[2], _T[1], _T[3], _T[1], _T[0]]),
    "rtp_segment_brute_chunked": ("rtp_segment_brute", 5, [_T[0]] * 3 + [
        _T[1], _T[0], _T[1], _T[2], _T[1], _T[1], _T[3], _T[1], _T[1]] + [_T[0]] * 6),
}


# K7's entry point before its box tables stayed in global memory: one more
# argument, staged or not (17, before the seed).
HBM_STAGED = [_T[0]] * 4 + [_T[1]] + [_T[0]] * 3 + [_T[1], _T[0], _T[1], _T[0], _T[1], _T[0],
                                                    _T[1], _T[1], _T[1], _T[1], _T[2], _T[1],
                                                    _T[3], _T[1]] + [_T[0]] * 3


# K8's node table before the ordered walk, which a version without
# `rtp_bvh_blocks_per_sm` reads: eight words a node (box, miss link,
# (start << 8) | count). `bvh_tables` registers it beside the records the
# wrapper passes, keyed by their address (both kept alive).
OLD_NODES: dict[int, tuple] = {}


def bvh_tables(tree, dev):
    """`megakernel.bvh_tables(tree, dev)`, registered in OLD_NODES with the
    node words of the miss-link walk."""
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk

    tb = mk.bvh_tables(tree, dev)
    f = tb.flat
    leaf = torch.where(f.leaf_count > 0, (f.leaf_start << 8) | f.leaf_count, 0)
    old = torch.cat([f.node_min.float().view(torch.int32), f.node_max.float().view(torch.int32),
                     f.miss_link.int()[:, None], leaf.int()[:, None]], dim=1).contiguous()
    OLD_NODES[tb.nodes.data_ptr()] = (tb, old)
    return tb


class OwnRoute:
    """A version's megakernel library as its own wrapper used it: where it
    has the whole-table brute entry points and the table fits shared
    memory, the chunked entries launch those; where its K7 predates the
    live list (no `rtp_hbm_blocks_per_sm`), K7 stages its box tables
    whenever they fit the shared-memory budget, as its wrapper decided;
    where its K8 predates the ordered walk (no `rtp_bvh_blocks_per_sm`),
    K8 reads the miss-link node words (OLD_NODES) for the records it is
    given."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    def __getattr__(self, name):
        if (name in ("rtp_trace_bvh", "rtp_record_bvh")
                and not hasattr(self.lib, "rtp_bvh_blocks_per_sm")):
            fn = getattr(self.lib, name)

            def miss_link_walk(*a):  # a[7] the node table, a[8] its rows
                old = OLD_NODES[a[7]][1]
                return fn(*a[:7], old.data_ptr(), old.shape[0], *a[9:])

            return miss_link_walk
        if name == "rtp_trace_front_hbm" and not hasattr(self.lib, "rtp_hbm_blocks_per_sm"):
            fn = getattr(self.lib, name)
            fn.argtypes = HBM_STAGED

            def staged(*a):  # a[8] n_front, a[10] n_words_pad, a[12] n_super
                from raytracingproject_tpu_torch.ops.cuda import megakernel as mk

                boxes = 4 * (9 * a[8] + 8 * a[10] + 8 * a[12])
                return fn(*a[:17], int(boxes <= mk.SMEM_BUDGET_BYTES), *a[17:])

            return staged
        if name not in WHOLE_TABLE or not hasattr(self.lib, WHOLE_TABLE[name][0]):
            return getattr(self.lib, name)
        fn = getattr(self.lib, name, None)  # the chunked entry, where the version has one
        old_name, at, args = WHOLE_TABLE[name]
        old = getattr(self.lib, old_name)
        old.argtypes, old.restype = args, build._I

        def call(*a):
            from raytracingproject_tpu_torch.ops.cuda import megakernel as mk

            fits = 4 * mk.N_ROWS * a[at] <= mk.SMEM_BUDGET_BYTES
            return (old if fits else fn)(*a)

        return call


def build_version(name: str, src: Path,
                  sources=SOURCES) -> list[tuple[str, Path, subprocess.Popen]]:
    """Start nvcc on each of `sources` in `src`, into build/versions/<name>/."""
    out = build.BUILD_DIR / "versions" / name
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    jobs = []
    for s in sources:
        lib = out / f"lib{s}.so"
        proc = subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", str(lib), str(src / f"{s}.cu")],
                                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        jobs.append((s, lib, proc))
    return jobs


def bind(path: Path, source: str) -> ctypes.CDLL:
    """The library at `path` with the package's signatures of `source`'s
    entry points (those it has: an older version may lack newer ones)."""
    lib = ctypes.CDLL(str(path))
    for fn, (args, res) in build.LIBRARIES[source].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
    return lib


def cuda_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of the kernels fn() launches, summed by the
    profiler (CUPTI): the probes on the cover scene run for less than their
    wrappers' host time, so events around a run of calls would time the
    host's pace, with the card idle between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages())
    return us / reps / 1e3


def wall_s(fn, reps: int = 3) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def scan_cases(dev) -> dict:
    """--scans: case name -> (the kernel call, its plain version or None),
    over the brute scan and K7 (see the module docstring). None: the plain
    version takes seconds to minutes there (chip_smoke.py holds those)."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
    from raytracingproject_tpu_torch.probes.kfront import COVER_CAMERA
    from raytracingproject_tpu_torch.render import _slot_rays
    from raytracingproject_tpu_torch.scene import make_cover_scene, make_random_scene

    bench = Camera(**dict(COVER_CAMERA, samples_per_pixel=4, max_depth=16))
    w, h = bench.image_size()
    rays4 = _slot_rays(bench.derive(torch.float32, dev), w, h, 4,
                       torch.Generator(device=dev).manual_seed(1), None)
    rays1 = _slot_rays(bench.derive(torch.float32, dev), w, h, 1,
                       torch.Generator(device=dev).manual_seed(31), None)
    cover = make_cover_scene(0, device=dev)
    cases = {
        "brute cover bench forward": (lambda: mk.trace_paths(*rays4, cover, 99, 16),
                                      lambda: mk.trace_paths_twin(*rays4, cover, 99, 16)),
        "brute cover bench record": (lambda: mk.trace_record(*rays4, cover, 99, 16),
                                     lambda: mk.trace_record_twin(*rays4, cover, 99, 16)),
        "brute cover bench record_miss": (
            lambda: mk.trace_paths(*rays4, cover, 99, 16, record_miss=True),
            lambda: mk.trace_paths_twin(*rays4, cover, 99, 16, record_miss=True)),
        "brute cover bench schlick3": (
            lambda: mk.trace_paths(*rays4, cover, 99, 16, inject_bug="schlick3"),
            lambda: mk.trace_paths_twin(*rays4, cover, 99, 16, inject_bug="schlick3")),
    }
    for kind in KINDS:  # K6 over the brute scan: one pass cut at 4, then 12 packed
        kw = dict(record_miss=kind == "miss", record=kind == "record")
        st, slot = dt.initial_state(*rays1, kind == "miss")
        first = mk.segment_twin(st, slot, cover, 41, 0, 4, **kw)
        st1 = first[0] if kind == "record" else first
        src, _, _ = dt.alive_first_perm(st1[mk.ST_ALIVE])
        st2, slot2 = dt.take_ray_rows(st1, src, dim=1), dt.take_ray_rows(slot, src)
        for (a, sl, b0, n) in ((st, slot, 0, 4), (st2, slot2, 4, 12)):
            cases[f"brute cover segment {kind} [{b0}, {b0 + n})"] = (
                lambda a=a, sl=sl, b0=b0, n=n, kw=kw: mk.segment_call(a, sl, cover, 41, b0, n,
                                                                       **kw),
                lambda a=a, sl=sl, b0=b0, n=n, kw=kw: mk.segment_twin(a, sl, cover, 41, b0, n,
                                                                       **kw))
    # kernels this comparison does not redesign, for their times: K3 and K5 on the cover front
    cover_cpu = make_cover_scene(0)
    ctree = build_bvh(cover_cpu, leaf_size=8)
    cscene = reorder_scene(cover_cpu, ctree).to(dev)
    cfront = mk.front_tables(cscene, ctree, order_point=COVER_CAMERA["lookfrom"])
    cases["K3 cover bench forward"] = (
        lambda: mk.trace_paths(*rays4, cscene, 99, 16, front=cfront), None)
    cases["K5 front cover bench record"] = (
        lambda: mk.trace_record(*rays4, cscene, 99, 16, front=cfront), None)
    for n in (2000, 3000):
        sc = make_random_scene(n, seed=3, device=dev)
        cases[f"brute {n} spheres pass forward"] = (
            lambda sc=sc: mk.trace_paths(*rays1, sc, 99, 16), None)
    big_cpu = make_random_scene(50000, seed=3)
    tree = build_bvh(big_cpu, leaf_size=8)
    big = reorder_scene(big_cpu, tree).to(dev)
    cases["brute 50,000 spheres pass forward"] = (lambda: mk.trace_paths(*rays1, big, 99, 16),
                                                  None)
    cases["brute 50,000 spheres pass record"] = (lambda: mk.trace_record(*rays1, big, 99, 16),
                                                 None)
    bvh = bvh_tables(tree, dev)
    cases["K8 50,000 spheres pass forward (--scans)"] = (
        lambda: mk.trace_paths(*rays1, big, 99, 16, bvh=bvh), None)
    fronts = {"plain": mk.front_tables_hbm(big, tree)}
    fronts["word_earlyout"] = dataclasses.replace(fronts["plain"], word_earlyout=True)
    fronts["sub_block"] = mk.front_tables_hbm(big, tree, max_nodes=480, sub_block=True)

    def k7(f, rays, **kw):
        return lambda: mk.trace_paths(*rays, None, 99, 16, front=f, **kw)

    for k, f in fronts.items():
        cases[f"K7 50,000 spheres pass {k}"] = (k7(f, rays1), None)
    cases["K7 50,000 spheres pass record_miss"] = (
        k7(fronts["plain"], rays1, record_miss=True), None)
    for n in (5000, 16000):
        cpu = make_random_scene(n, seed=3)
        tr = build_bvh(cpu, leaf_size=8)
        f = mk.front_tables_hbm(reorder_scene(cpu, tr).to(dev), tr)
        cases[f"K7 {n} spheres bench"] = (k7(f, rays4), None)
    return cases


def front_cases(dev) -> dict:
    """--front: case name -> (the kernel call, its plain version or None),
    over K3's instantiations and the kernels beside them (see the module
    docstring)."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
    from raytracingproject_tpu_torch.probes.kfront import COVER_CAMERA
    from raytracingproject_tpu_torch.render import _slot_rays, prepare_scene
    from raytracingproject_tpu_torch.scene import make_cover_scene, make_random_scene

    bench = Camera(**dict(COVER_CAMERA, samples_per_pixel=4, max_depth=16))
    w, h = bench.image_size()
    rays4 = _slot_rays(bench.derive(torch.float32, dev), w, h, 4,
                       torch.Generator(device=dev).manual_seed(1), None)
    rays1 = _slot_rays(bench.derive(torch.float32, dev), w, h, 1,
                       torch.Generator(device=dev).manual_seed(31), None)
    settings = RenderSettings(device=str(dev))
    cover_cpu = make_cover_scene(0)
    ctree = build_bvh(cover_cpu, leaf_size=8)  # as prepare_scene builds it
    cover = reorder_scene(cover_cpu, ctree).to(dev)
    front, opts = (mk.front_tables(cover, ctree, order_point=COVER_CAMERA["lookfrom"], repack=2,
                                   sub_block=sub, word_earlyout=sub) for sub in (False, True))
    cases = {}
    for tag, f in (("", front), (" with options", opts)):
        cases[f"K3 cover bench{tag}"] = (
            lambda f=f: mk.trace_paths(*rays4, cover, 99, 16, front=f),
            lambda f=f: mk.trace_paths_twin(*rays4, cover, 99, 16, front=f))
        cases[f"K5 front cover bench{tag}"] = (
            lambda f=f: mk.trace_record(*rays4, cover, 99, 16, front=f), None)
        cases[f"K3 record_miss cover pass{tag}"] = (
            lambda f=f: mk.trace_paths(*rays1, cover, 98, 16, front=f, record_miss=True),
            lambda f=f: mk.trace_paths_twin(*rays1, cover, 98, 16, front=f, record_miss=True))
    for kind in KINDS:  # K6's front tails with word_earlyout: one pass cut at 4, then 12 packed
        kw = dict(front=opts, record_miss=kind == "miss", record=kind == "record")
        st, slot = dt.initial_state(*rays1, kind == "miss")
        first = mk.segment_twin(st, slot, cover, 41, 0, 4, **kw)
        st1 = first[0] if kind == "record" else first
        src, _, _ = dt.alive_first_perm(st1[mk.ST_ALIVE])
        st2, slot2 = dt.take_ray_rows(st1, src, dim=1), dt.take_ray_rows(slot, src)
        for (a, sl, b0, n) in ((st, slot, 0, 4), (st2, slot2, 4, 12)):
            cases[f"K6 front {kind} with word_earlyout [{b0}, {b0 + n})"] = (
                lambda a=a, sl=sl, b0=b0, n=n, kw=kw: mk.segment_call(a, sl, cover, 41, b0, n,
                                                                       **kw),
                lambda a=a, sl=sl, b0=b0, n=n, kw=kw: mk.segment_twin(a, sl, cover, 41, b0, n,
                                                                       **kw))
    for n in (2000, 3000):
        sc, f = prepare_scene(make_random_scene(n, seed=3), bench, settings)
        cases[f"K3 {n:,} spheres pass"] = (
            lambda sc=sc, f=f: mk.trace_paths(*rays1, sc, 99, 16, front=f),
            lambda sc=sc, f=f: mk.trace_paths_twin(*rays1, sc, 99, 16, front=f))
    cases["K3 3,000 spheres pass, depth 0 (staging)"] = (
        lambda sc=sc, f=f: mk.trace_paths(*rays1, sc, 99, 0, front=f), None)
    cases["brute cover bench forward"] = (lambda: mk.trace_paths(*rays4, cover, 99, 16), None)
    cases["brute cover bench record"] = (lambda: mk.trace_record(*rays4, cover, 99, 16), None)
    big_cpu = make_random_scene(50000, seed=3)
    tree = build_bvh(big_cpu, leaf_size=8)
    big = reorder_scene(big_cpu, tree).to(dev)
    hbm, tb = mk.front_tables_hbm(big, tree), bvh_tables(tree, dev)
    cases["K7 50,000 spheres pass"] = (
        lambda: mk.trace_paths(*rays1, None, 99, 16, front=hbm), None)
    cases["K8 50,000 spheres pass"] = (
        lambda: mk.trace_paths(*rays1, big, 99, 16, bvh=tb), None)
    return cases


def probe_cases(dev) -> dict:
    """--probes: case name -> (the probe call, its plain version), over the
    eight probe_hit_kernel instantiations and probe_front_kernel (see the
    module docstring); the rays are padded to whole blocks here, outside
    the timed calls, as the probes' measurements pad theirs."""
    from raytracingproject_tpu_torch import probes
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
    from raytracingproject_tpu_torch.probes import kexp, kfront, roofline

    tab = roofline.mixed_table(488).to(dev)
    ox = torch.linspace(10.0, 14.0, roofline.full_waves(dev), device=dev)
    cases = {"mixed peak": (lambda: roofline.mixed_hits(tab, ox),
                            lambda: roofline.mixed_hits_plain(tab, ox))}
    rays = probes.padded(kfront.primary_rays(dev))
    for name in (None, 2000):
        sc = kfront.probe_scene(name)
        tag = "cover" if name is None else f"{name:,} spheres"
        sphb = mk.scene_table(reorder_scene(sc, build_bvh(sc, leaf_size=8))).to(dev)
        cases[f"kfront brute {tag}"] = (lambda sphb=sphb: kfront.run_brute(rays, sphb),
                                        lambda sphb=sphb: kfront.run_brute_plain(rays, sphb))
        for f in kfront.FRONTS:
            tabs = [t.to(dev) for t in kfront.pack_front_tables(sc, max_nodes=f)]
            cases[f"kfront front F={f} {tag}"] = (
                lambda tabs=tabs: kfront.run_front(rays, *tabs),
                lambda tabs=tabs: kfront.run_front_plain(rays, *tabs))
        sph = mk.scene_table(sc).to(dev)
        for v in kexp.VARIANTS:
            cases[f"kexp {v} {tag}"] = (lambda sph=sph, v=v: kexp.run(rays, sph, v),
                                        lambda sph=sph, v=v: kexp.run_plain(rays, sph, v))
    return cases


def bvh_cases(dev) -> dict:
    """--bvh: case name -> (the kernel call, None), over K8's three
    instantiations (see the module docstring); chip_smoke.py holds them
    against their plain versions, which take seconds a pass here."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.camera import Camera, camera_uniforms, rays_from_uniforms
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
    from raytracingproject_tpu_torch.probes.kfront import COVER_CAMERA
    from raytracingproject_tpu_torch.render import _slot_rays
    from raytracingproject_tpu_torch.scene import make_cover_scene, make_random_scene

    bench = Camera(**dict(COVER_CAMERA, samples_per_pixel=4, max_depth=16))
    w, h = bench.image_size()
    rays4 = _slot_rays(bench.derive(torch.float32, dev), w, h, 4,
                       torch.Generator(device=dev).manual_seed(1), None)
    rays1 = _slot_rays(bench.derive(torch.float32, dev), w, h, 1,
                       torch.Generator(device=dev).manual_seed(31), None)
    gen = torch.Generator(device=dev).manual_seed(4)  # one train step's rays: 2 spp, [spp, H, W]
    pix = torch.arange(w * h, device=dev).repeat(2)
    step = rays_from_uniforms(bench.derive(torch.float32, dev), (pix % w).to(torch.int32),
                              (pix // w).to(torch.int32), *camera_uniforms(pix.shape[0], gen, dev))
    cases = {}
    for n in (5000, 16000, 50000):
        cpu = make_random_scene(n, seed=3)
        tree = build_bvh(cpu, leaf_size=8)
        sc = reorder_scene(cpu, tree).to(dev)
        tb = bvh_tables(tree, dev)
        if n == 50000:
            cases["K8 50,000 spheres pass forward"] = (
                lambda sc=sc, tb=tb: mk.trace_paths(*rays1, sc, 99, 16, bvh=tb), None)
            cases["K8 50,000 spheres pass record_miss"] = (
                lambda sc=sc, tb=tb: mk.trace_paths(*rays1, sc, 99, 16, bvh=tb,
                                                    record_miss=True), None)
            cases["K5 bvh 50,000 spheres pass"] = (
                lambda sc=sc, tb=tb: mk.trace_record(*rays1, sc, 99, 16, bvh=tb), None)
            cases["K5 bvh 50,000 spheres train step rays, depth 50"] = (
                lambda sc=sc, tb=tb: mk.trace_record(*step, sc, 1234, 50, bvh=tb), None)
        cases[f"K8 {n:,} spheres bench"] = (
            lambda sc=sc, tb=tb: mk.trace_paths(*rays4, sc, 99, 16, bvh=tb), None)
        cases[f"K5 bvh {n:,} spheres bench"] = (
            lambda sc=sc, tb=tb: mk.trace_record(*rays4, sc, 99, 16, bvh=tb), None)
    cover_cpu = make_cover_scene(0)
    tree = build_bvh(cover_cpu, leaf_size=8)
    cover = reorder_scene(cover_cpu, tree).to(dev)
    cover_tb = bvh_tables(tree, dev)
    cases["K8 cover pass record_miss"] = (
        lambda: mk.trace_paths(*rays1, cover, 31, 16, bvh=cover_tb, record_miss=True), None)
    return cases


def bvh_frame(scene_cpu, cam, dev):
    """The image of `cam` over `scene_cpu` through K8: `render`'s pass loop
    with render_pass(bvh=), one pass a sample, scene preparation included."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.render import blocks_to_image, render_pass

    tree = build_bvh(scene_cpu, leaf_size=8)
    sc = reorder_scene(scene_cpu, tree).to(dev)
    tb = bvh_tables(tree, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    derived = cam.derive(torch.float32, dev)
    w, h = cam.image_size()
    acc = None
    for _ in range(cam.samples_per_pixel):
        out = render_pass(sc, derived, gen, width=w, height=h, max_depth=cam.max_depth,
                          spp_chunk=1, bvh=tb, raw_slots=True)
        acc = out if acc is None else acc + out
    return blocks_to_image(acc, w, h, 1) / cam.samples_per_pixel


def train_steps(cam, dev) -> dict:
    """--bvh --frames: name -> a call of one fast train step at `cam`'s
    shape (2 spp, depth 50), from the true scene toward a target rendered
    once: materials on `make_random_scene(50000, seed=3)` through K5's
    bvh core, geometry and albedo on 5,000 spheres through the chunked
    recording kernel. The step updates its parameters in place, so it
    trains at learning rate 0: every call steps the same scene."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.grad import make_fast_train_step
    from raytracingproject_tpu_torch.render import render
    from raytracingproject_tpu_torch.scene import make_random_scene

    steps = {}
    for name, n, kw in (("K5 bvh materials step, 50,000 spheres", 50000,
                         dict(trainable=("albedo", "fuzz", "ior"))),
                        ("chunked geometry step, 5,000 spheres", 5000,
                         dict(trainable=("albedo", "center0", "radius")))):
        cpu = make_random_scene(n, seed=3)
        target = render(cpu, cam, torch.Generator(device=dev).manual_seed(5),
                        RenderSettings(device="cuda"))
        if n == 50000:
            tree = build_bvh(cpu, leaf_size=8)
            cpu = reorder_scene(cpu, tree)
            kw["bvh"] = bvh_tables(tree, dev)
        params, opt, step = make_fast_train_step(
            cpu, cam, spp=2, learning_rate=0.0,
            generator=torch.Generator(device=dev).manual_seed(3), **kw)
        steps[name] = (lambda step=step, params=params, opt=opt, target=target:
                       step(params, opt, None, target))
    return steps


def main(argv=None) -> int:
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
    from raytracingproject_tpu_torch.ops.cuda import trace
    from raytracingproject_tpu_torch.probes.kfront import COVER_CAMERA
    from raytracingproject_tpu_torch.probes.pair_counts import cover_pass
    from raytracingproject_tpu_torch.probes.roofline import card_line
    from raytracingproject_tpu_torch.render import _slot_rays, render
    from raytracingproject_tpu_torch.scene import make_cover_scene

    argv = sys.argv[1:] if argv is None else argv
    flags = ("--frames", "--scans", "--bvh", "--front", "--probes")
    frames, scans, bvh, k3, probe = (f in argv for f in flags)
    probes_only = probe and not (frames or scans or bvh or k3)
    sources = ((PROBE_SOURCE,) if probes_only
               else SOURCES + ((PROBE_SOURCE,) if probe else ()))
    versions = dict(a.split("=", 1) for a in argv if a not in flags)
    if not versions or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    jobs = {name: build_version(name, Path(src), sources) for name, src in versions.items()}
    libs, regs = {}, {}
    for name, js in jobs.items():
        log = ""
        for source, path, proc in js:
            _, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}/{source}.cu:\n{err}")
            log += err
        libs[name] = {s: bind(p, s) for s, p, _ in js}
        r = build.kernel_registers(log)
        regs[name] = {k: v for k, v in r.items() if isinstance(k, str) and "probe_" in k}
        if "megakernel" in libs[name]:
            libs[name]["megakernel"] = OwnRoute(libs[name]["megakernel"])
            regs[name].update({"closest_hit_kernel": build.named(r, "closest_hit_kernel"),
                               **{f"trace_kernel{list(k)}": v for k, v in r.items()
                                  if isinstance(k, tuple)}})
    print(f"built {len(versions)} versions in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, r in regs.items():
        print(f"{name}: (registers, spill store bytes) {r}", flush=True)

    def use(name):
        build._libs.update(libs[name])

    # ---- the work, on the first version; the plain versions' results ----
    use(next(iter(versions)))
    scene, (o, d, t), (o2, d2) = cover_pass(dev)
    tab = trace.sphere_table(scene)
    k4_sets = {} if probes_only else {"primary": (o, d, t), "after one scatter": (o2, d2, t)}
    k4_want = {k: trace.closest_hit_fused_twin(*r, tab) for k, r in k4_sets.items()}

    cover_cpu = make_cover_scene(0)
    tree = build_bvh(cover_cpu, leaf_size=8)
    fscene = reorder_scene(cover_cpu, tree).to(dev)
    front = mk.front_tables(fscene, tree, order_point=COVER_CAMERA["lookfrom"], repack=1,
                            smem_budget=mk.SMEM_BUDGET_BYTES - mk.SEGMENT_LIST_BYTES)
    ref_cam = Camera(**dict(COVER_CAMERA, samples_per_pixel=30, max_depth=50))
    w, h = ref_cam.image_size()
    rays1 = _slot_rays(ref_cam.derive(torch.float32, dev), w, h, 1,
                       torch.Generator(device=dev).manual_seed(31), None)
    seg_in, seg_want = {}, {}
    for kind in () if probes_only else KINDS:
        kw = dict(front=front, record_miss=kind == "miss", record=kind == "record")
        st, slot = dt.initial_state(*rays1, kind == "miss")
        first = mk.segment_twin(st, slot, fscene, 41, 0, 4, **kw)
        st1 = first[0] if kind == "record" else first
        src, _, _ = dt.alive_first_perm(st1[mk.ST_ALIVE])
        st2, slot2 = dt.take_ray_rows(st1, src, dim=1), dt.take_ray_rows(slot, src)
        seg_in[kind] = ((st, slot, 0, 4, kw), (st2, slot2, 4, 12, kw))
        seg_want[kind] = (first, mk.segment_twin(st2, slot2, fscene, 41, 4, 12, **kw))
        print(f"front segment {kind}: {int(st1[mk.ST_ALIVE].sum())} of {st.shape[1]} rays alive "
              "after the cut", flush=True)

    def same(a, b):
        if isinstance(a, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    for name in versions:
        use(name)
        for k, r in k4_sets.items():
            if not same(trace.closest_hit_fused(*r, tab), k4_want[k]):
                raise RuntimeError(f"{name}: K4 differs from its plain version ({k})")
        for kind in seg_in:
            for (st, slot, b0, n, kw), want in zip(seg_in[kind], seg_want[kind]):
                if not same(mk.segment_call(st, slot, fscene, 41, b0, n, **kw), want):
                    raise RuntimeError(f"{name}: front segment {kind} [{b0}, {b0 + n}) "
                                       "differs from its plain version")
    if not probes_only:
        print("every version bit-equal to the plain versions (K4 on both ray sets, the three "
              "front segments on both segments)", flush=True)
    probe_work = probe_cases(dev) if probe else {}
    cases = {**(scan_cases(dev) if scans else {}), **(bvh_cases(dev) if bvh else {}),
             **(front_cases(dev) if k3 else {}), **probe_work}
    if cases:
        first = next(iter(versions))
        use(first)
        want = {k: (fn(), plain() if plain is not None else None)
                for k, (fn, plain) in cases.items()}
        for k, (got, plain) in want.items():
            if plain is not None and not same(got, plain):
                raise RuntimeError(f"{first}: {k} differs from its plain version")
        for name in versions:
            use(name)
            for k, (fn, _) in cases.items():
                if not same(fn(), want[k][0]):
                    raise RuntimeError(f"{name}: {k} differs from {first}'s")
        print(f"every version bit-equal to {first} on every case "
              f"({', '.join(cases)}; and, where given, to the plain versions)", flush=True)

    fast = RenderSettings(device="cuda")
    oracle = RenderSettings(device="cuda", use_megakernel=False, use_pallas=True, use_bvh=False)
    frame_cases = {
        "front two_phase=4": lambda: render(cover_cpu, ref_cam, settings=RenderSettings(
            device="cuda", two_phase=4)),
        "front depth_segment=8": lambda: render(cover_cpu, ref_cam, settings=RenderSettings(
            device="cuda", depth_segment=8)),
        "front monolithic": lambda: render(cover_cpu, ref_cam, settings=fast),
        "oracle (K4)": lambda: render(cover_cpu, ref_cam, settings=oracle),
        "brute monolithic": lambda: render(cover_cpu, ref_cam, settings=RenderSettings(
            device="cuda", use_bvh=False)),
    }
    if scans:
        from raytracingproject_tpu_torch.scene import make_random_scene

        big_cpu = make_random_scene(50000, seed=3)
        frame_cases["K7 50,000 spheres"] = lambda: render(big_cpu, ref_cam, settings=fast)
    if bvh:
        from raytracingproject_tpu_torch.scene import make_random_scene

        big_cpu = make_random_scene(50000, seed=3)
        frame_cases["K8 50,000 spheres"] = lambda: bvh_frame(big_cpu, ref_cam, dev)
        if frames:
            frame_cases.update(train_steps(dataclasses.replace(ref_cam, samples_per_pixel=2),
                                           dev))

    results = {name: [] for name in versions}
    order = list(versions)
    for turn, names in enumerate((order, order[::-1])):
        for name in names:
            use(name)
            r = {}
            for k, rays in k4_sets.items():
                r[f"K4 {k}"] = cuda_ms(lambda: trace.closest_hit_fused(*rays, tab), 50)  # noqa: B023
            for kind in seg_in:
                for (st, slot, b0, n, kw) in seg_in[kind]:
                    r[f"segment {kind} [{b0}, {b0 + n})"] = cuda_ms(
                        lambda: mk.segment_call(st, slot, fscene, 41, b0, n, **kw), 20)  # noqa: B023
            for k, (fn, _) in cases.items():
                r[k] = (device_ms(fn, 100) if k in probe_work else
                        cuda_ms(fn, 5 if "50,000" in k else 30 if "cover pass" in k else 10))
            if frames:
                for k, fn in frame_cases.items():
                    r[f"frame {k} (s)"] = wall_s(fn, 1 if k.startswith(("oracle", "K7", "K8"))
                                                 else 5 if "step" in k else 3)
            results[name].append(r)
            print(f"turn {turn}, {name}: " + ", ".join(f"{k} {v:.5g}" for k, v in r.items())
                  + f"; on {card}", flush=True)
    summary = {name: {k: statistics.mean(x[k] for x in rs) for k in rs[0]}
               for name, rs in results.items()}
    print(json.dumps({"card": card, "registers": regs,
                      "turns": results, "mean": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
