#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc, holds each against its plain
PyTorch version on the card, drives the main path (the cover scene through
`render_image`, `render` and the CLI, at the reference configuration
400x225, 30 spp, depth 50), checks that it went through the kernels, and
times kernel and plain version at the bench shape (400x225, 4 spp,
depth 16). Any failed check raises and the script exits non-zero. Without
a CUDA device it exits 1 and prints no result.

The second-to-last line of stdout is a JSON object with one entry per
kernel; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
REPLACES = {
    "brute": "raytracingproject_tpu/ops/pallas/megakernel.py:832",
    "front": "raytracingproject_tpu/ops/pallas/megakernel.py:869",
}
COVER_CAMERA = dict(aspect_ratio=16.0 / 9.0, image_width=400, vfov=20.0,
                    lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                    defocus_angle=0.6, focus_dist=10.0)
N_CMP = 65536  # camera rays in the kernel-against-twin comparisons


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.color import to_u8
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.ops.cuda import build
    from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
    from raytracingproject_tpu_torch.ops.rng import bounce_bits
    from raytracingproject_tpu_torch.render import (
        _slot_rays, prepare_scene, render, render_image,
    )
    from raytracingproject_tpu_torch.scene import make_cover_scene
    from raytracingproject_tpu_torch.utils.ppm import read_ppm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)  # name, power limit: nvidia-smi's own line
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build ----
    build.build()
    build.load_library()
    print(f"build: nvcc {build.BUILD_INFO['seconds']:.1f} s")
    for line in str(build.BUILD_INFO["log"]).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

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
    check(launches["front"] > 0 and launches["brute"] > 0, "both kernels ran on the main path")
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
        kernels.append({
            "name": f"megakernel_{path}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[path], "launches": launches[path],
            "max_abs_err": max_err[path], "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
