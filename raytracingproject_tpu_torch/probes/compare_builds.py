"""Versions of the hand-written kernels against each other on one card:
the same kernels built from several source trees and timed in one
process, in turns (every tree, then every tree again in reverse order),
so that versions are compared under one card, one power limit and one
host.

    python -m raytracingproject_tpu_torch.probes.compare_builds [--frames] [--scans] NAME=DIR ...

Each DIR holds the CUDA sources of one version (closest_hit.cu,
megakernel.cu and common.cuh, as raytracingproject_tpu_torch/csrc does;
for the parent commit, unpack that directory of it with `git archive`).
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
  cover scene, to the plain version's). A version whose library still has
  the whole-table brute entry points (`rtp_trace_brute`, ...) runs them
  where the table fits shared memory, as its own wrapper did.

Prints the card, each version's registers (nvcc -Xptxas -v), one line per
version and turn, and a last JSON line with every time. Needs a card.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from raytracingproject_tpu_torch.ops.cuda import build

SOURCES = ("closest_hit", "megakernel")
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


class OwnRoute:
    """A version's megakernel library as its own wrapper used it: where it
    has the whole-table brute entry points and the table fits shared
    memory, the chunked entries launch those; where its K7 predates the
    live list (no `rtp_hbm_blocks_per_sm`), K7 stages its box tables
    whenever they fit the shared-memory budget, as its wrapper decided."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    def __getattr__(self, name):
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


def build_version(name: str, src: Path) -> list[tuple[str, Path, subprocess.Popen]]:
    """Start nvcc on each of SOURCES in `src`, into build/versions/<name>/."""
    out = build.BUILD_DIR / "versions" / name
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    jobs = []
    for s in SOURCES:
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
    import dataclasses

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
    bvh = mk.bvh_tables(tree, dev)
    cases["K8 50,000 spheres pass forward"] = (
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
    frames, scans = "--frames" in argv, "--scans" in argv
    versions = dict(a.split("=", 1) for a in argv if a not in ("--frames", "--scans"))
    if not versions or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    jobs = {name: build_version(name, Path(src)) for name, src in versions.items()}
    libs, regs = {}, {}
    for name, js in jobs.items():
        log = ""
        for source, path, proc in js:
            _, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}/{source}.cu:\n{err}")
            log += err
        libs[name] = {s: bind(p, s) for s, p, _ in js}
        libs[name]["megakernel"] = OwnRoute(libs[name]["megakernel"])
        r = build.kernel_registers(log)
        regs[name] = {"closest_hit_kernel": build.named(r, "closest_hit_kernel"),
                      **{f"front segment, record {k[1]}, record_miss {k[2]}": v
                         for k, v in r.items() if isinstance(k, tuple) and k[0] == 1 and k[3:] == (1, 0)},
                      **{f"trace_kernel{list(k)}": v for k, v in r.items()
                         if isinstance(k, tuple) and k[0] in (0, 2, 4)}}
    print(f"built {len(versions)} versions in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, r in regs.items():
        print(f"{name}: (registers, spill store bytes) {r}", flush=True)

    def use(name):
        build._libs.update(libs[name])

    # ---- the work, on the first version; the plain versions' results ----
    use(next(iter(versions)))
    scene, (o, d, t), (o2, d2) = cover_pass(dev)
    tab = trace.sphere_table(scene)
    k4_sets = {"primary": (o, d, t), "after one scatter": (o2, d2, t)}
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
    for kind in KINDS:
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
        for kind in KINDS:
            for (st, slot, b0, n, kw), want in zip(seg_in[kind], seg_want[kind]):
                if not same(mk.segment_call(st, slot, fscene, 41, b0, n, **kw), want):
                    raise RuntimeError(f"{name}: front segment {kind} [{b0}, {b0 + n}) "
                                       "differs from its plain version")
    print("every version bit-equal to the plain versions (K4 on both ray sets, the three front "
          "segments on both segments)", flush=True)
    cases = scan_cases(dev) if scans else {}
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
        print(f"the brute scan and K7: every version bit-equal to {first} on every case (and, on "
              "the cover scene, to the plain versions)", flush=True)

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

    results = {name: [] for name in versions}
    order = list(versions)
    for turn, names in enumerate((order, order[::-1])):
        for name in names:
            use(name)
            r = {}
            for k, rays in k4_sets.items():
                r[f"K4 {k}"] = cuda_ms(lambda: trace.closest_hit_fused(*rays, tab), 50)  # noqa: B023
            for kind in KINDS:
                for (st, slot, b0, n, kw) in seg_in[kind]:
                    r[f"segment {kind} [{b0}, {b0 + n})"] = cuda_ms(
                        lambda: mk.segment_call(st, slot, fscene, 41, b0, n, **kw), 20)  # noqa: B023
            for k, (fn, _) in cases.items():
                r[k] = cuda_ms(fn, 5 if "50,000" in k else 10)
            if frames:
                for k, fn in frame_cases.items():
                    r[f"frame {k} (s)"] = wall_s(fn, 1 if k.startswith(("oracle", "K7")) else 3)
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
