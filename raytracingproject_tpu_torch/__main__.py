"""CLI entry point (counterpart of raytracingproject_tpu/__main__.py and
the reference's src/main.cpp:11-71).

Renders the RTWeekend cover scene with the reference camera (400x225,
30 spp, depth 50, vfov 20, lookfrom (13,2,3), defocus 0.6, focus 10)
through the megakernel with front culling (or, with --wavefront, the
stream-compaction renderer of wavefront.py), and writes P3 PPM to stdout
(or --output) with progress, rays a second and the program's counters
(kernel launches among them) on stderr. With --trace DIR the render runs
under the profiler and DIR/trace.json holds its Chrome trace, the
program's `rtp.*` spans included.

    python -m raytracingproject_tpu_torch > image.ppm
    python -m raytracingproject_tpu_torch --scene three --spp 64 -o out.ppm
    python -m raytracingproject_tpu_torch --wavefront -o out.ppm
    python -m raytracingproject_tpu_torch --trace prof -o out.ppm
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import torch

from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.color import to_u8
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.render import render
from raytracingproject_tpu_torch.scene import (
    make_cover_scene, make_minimal_scene, make_three_sphere_scene,
)
from raytracingproject_tpu_torch.utils import profiling
from raytracingproject_tpu_torch.utils.ppm import encode_ppm
from raytracingproject_tpu_torch.wavefront import render_wavefront_image

SCENES = {
    "cover": make_cover_scene,
    "three": make_three_sphere_scene,
    "minimal": make_minimal_scene,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytracingproject_tpu_torch")
    ap.add_argument("--scene", choices=sorted(SCENES), default="cover")
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--spp", type=int, default=30,
                    help="samples per pixel (reference default 30, src/main.cpp:58)")
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-bvh", action=argparse.BooleanOptionalAction, default=True,
                    help="front-culled closest hit (default); --no-use-bvh scans every sphere")
    ap.add_argument("--wavefront", action="store_true",
                    help="stream-compaction renderer (wavefront.py: a dense ray pool, the fused "
                         "closest hit K4 on the card); --use-bvh does not apply to it")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: cuda; without a card it raises, so ask for cpu)")
    ap.add_argument("--output", "-o", default="-", help="output path ('-' = stdout)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="profile the render and write its Chrome trace to DIR/trace.json")
    args = ap.parse_args(argv)

    cover = args.scene == "cover"
    camera = Camera(
        aspect_ratio=16.0 / 9.0,
        image_width=args.width,
        samples_per_pixel=args.spp,
        max_depth=args.depth,
        vfov=20.0 if cover else 90.0,
        lookfrom=(13.0, 2.0, 3.0) if cover else (0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, 0.0) if cover else (0.0, 0.0, -1.0),
        defocus_angle=0.6 if cover else 0.0,
        focus_dist=10.0 if cover else 1.0,
    )
    scene = SCENES[args.scene](seed=args.seed) if cover else SCENES[args.scene]()
    settings = RenderSettings(use_bvh=args.use_bvh, device=args.device)
    device = settings.resolved_device()
    generator = torch.Generator(device=device).manual_seed(args.seed)

    print(f"Rendering {args.scene} {camera.image_width}x{camera.image_height} "
          f"spp={args.spp} depth={args.depth} on {device}", file=sys.stderr, flush=True)
    renderer = render_wavefront_image if args.wavefront else render
    rays = camera.image_width * camera.image_height * args.spp
    meter = profiling.RaysPerSecond()
    traced = profiling.trace(args.trace) if args.trace else contextlib.nullcontext()
    with traced:
        meter.start()
        img = renderer(scene, camera, generator, settings)
        meter.stop(rays)
    data = encode_ppm(to_u8(img).cpu().numpy())
    counts = " ".join(f"{k}={v}" for k, v in profiling.counters().items() if v)
    print("Done.", file=sys.stderr)
    print(f"{rays} rays in {meter.total_seconds:.2f}s = {meter.average / 1e6:.2f} Mrays/s "
          f"({counts})", file=sys.stderr)
    if args.output == "-":
        sys.stdout.write(data)
    else:
        with open(args.output, "w") as f:
            f.write(data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
