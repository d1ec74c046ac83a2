"""Versions of K4 and of K6's front segment against each other on one card:
the same kernels built from several source trees and timed in one
process, in turns (every tree, then every tree again in reverse order),
so that versions are compared under one card, one power limit and one
host.

    python -m raytracingproject_tpu_torch.probes.compare_builds [--frames] NAME=DIR ...

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
  front, and through the oracle with K4.

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
    frames = "--frames" in argv
    versions = dict(a.split("=", 1) for a in argv if a != "--frames")
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
        r = build.kernel_registers(log)
        regs[name] = {"closest_hit_kernel": build.named(r, "closest_hit_kernel"),
                      **{f"front segment, record {k[1]}, record_miss {k[2]}": v
                         for k, v in r.items() if isinstance(k, tuple) and k[0] == 1 and k[3:] == (1, 0)}}
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

    fast = RenderSettings(device="cuda")
    oracle = RenderSettings(device="cuda", use_megakernel=False, use_pallas=True, use_bvh=False)
    frame_cases = {
        "front two_phase=4": lambda: render(cover_cpu, ref_cam, settings=RenderSettings(
            device="cuda", two_phase=4)),
        "front depth_segment=8": lambda: render(cover_cpu, ref_cam, settings=RenderSettings(
            device="cuda", depth_segment=8)),
        "front monolithic": lambda: render(cover_cpu, ref_cam, settings=fast),
        "oracle (K4)": lambda: render(cover_cpu, ref_cam, settings=oracle),
    }

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
            if frames:
                for k, fn in frame_cases.items():
                    r[f"frame {k} (s)"] = wall_s(fn, 1 if k.startswith("oracle") else 3)
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
