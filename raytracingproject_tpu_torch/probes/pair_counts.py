"""What K4 (the oracle's fused closest hit) has to compute on the oracle's
pass, counted in its plain version's operations: a count, not a
measurement, so it runs on any device.

    python -m raytracingproject_tpu_torch.probes.pair_counts [device]

prints one JSON line: for the cover camera's 400x225 primary rays (one a
pixel, the oracle's pass) and for the same rays after one scatter, over
the cover scene's 487 spheres, `trace.disc_counts`: the pairs, the pairs
whose discriminant is positive (the only ones that take a square root and
roots), and the (warp of 32 consecutive rays, sphere) pairs in which some
ray's is positive (the pairs a warp cannot skip the roots of). Default
device: cpu.
"""

from __future__ import annotations

import json
import sys

import torch

from raytracingproject_tpu_torch.camera import Camera, generate_rays
from raytracingproject_tpu_torch.materials import draw_scatter
from raytracingproject_tpu_torch.ops.cuda import trace
from raytracingproject_tpu_torch.probes.kfront import COVER_CAMERA
from raytracingproject_tpu_torch.render import _bounce, _PathState
from raytracingproject_tpu_torch.scene import make_cover_scene


def cover_pass(device, seed: int = 21):
    """(scene, rays): the cover scene and the cover camera's primary rays,
    one a pixel, row-major (o [R, 3], d [R, 3], time [R]), then the same
    rays after one scatter of the oracle's bounce (o, d)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cam = Camera(**COVER_CAMERA)
    w, h = cam.image_size()
    pix = torch.arange(w * h, device=dev)
    o, d, t = generate_rays(cam.derive(torch.float32, dev), (pix % w).to(torch.int32),
                            (pix // w).to(torch.int32), gen)
    scene = make_cover_scene(0, device=dev)
    n = o.shape[0]
    state = _PathState(o, d, torch.ones((n, 3), device=dev), torch.zeros((n, 3), device=dev),
                       torch.ones((n,), dtype=torch.bool, device=dev))
    state = _bounce(scene, t, state, draw_scatter(gen, (n,)), use_pallas=True)
    return scene, (o, d, t), (state.origin.contiguous(), state.direction.contiguous())


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    scene, (o, d, t), (o2, d2) = cover_pass(argv[0] if argv else "cpu")
    tab = trace.sphere_table(scene)
    out = {}
    for name, (ro, rd) in (("primary", (o, d)), ("after one scatter", (o2, d2))):
        c = trace.disc_counts(ro, rd, t, tab)
        out[name] = {**c, "roots_share": c["roots"] / c["pairs"],
                     "warp_roots_share": c["warp_roots"] / c["warps"]}
    print(json.dumps({"rays": o.shape[0], "spheres": tab.shape[1], **out}), flush=True)


if __name__ == "__main__":
    main()
