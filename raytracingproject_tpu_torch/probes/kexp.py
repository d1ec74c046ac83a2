"""Closest-hit micro-experiments: where does the closest hit's time go?
(tools/kexp.py of the JAX package.)

Intersection-only probes (no shading, no random numbers) on the cover
camera's primary rays, one kernel template (csrc/probes.cu
probe_hit_kernel) in six variants:

  full      the full hit carry (11 values: t, the winner's centre,
            radius, material, albedo, fuzz, ior), updated in the loop from
            a second pair of staged planes, unrolled x1
  full_u4   the same, unrolled x4; full_u8 x8
  slim      best t and winner index alone (the chunked brute scan's
            carry), the test's two planes staged alone
  slim_u4   unrolled x4; slim_u8 x8

Every variant reads a sphere's test fields as two 16-byte broadcasts from
256-sphere chunks staged by cp.async, and takes the roots only where the
discriminant is positive.

Each writes where(bt < inf, bt, 0) + c * 1e-7, c being the second value
of its carry: the winner's centre x (full) or its index (slim), 0 on a
miss.

    python -m raytracingproject_tpu_torch.probes.kexp [n_spheres]
"""

from __future__ import annotations

import sys

import torch

from raytracingproject_tpu_torch import probes
from raytracingproject_tpu_torch.ops.cuda.megakernel import (
    N_ROWS, ROW_CX, ROW_MX, _first_min, _require, _sphere_t, _twin_chunk, scene_table,
)
from raytracingproject_tpu_torch.probes.kfront import primary_rays, probe_scene
from raytracingproject_tpu_torch.probes.measure import marginal_ms
from raytracingproject_tpu_torch.scene import Scene

T_MIN = 1e-3
VARIANTS = probes.KEXP_VARIANTS


def parse(variant: str) -> tuple[bool, int]:
    """(slim, unroll) of a variant name (tools/kexp.py:76-77)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    unroll = 8 if variant.endswith("u8") else (4 if variant.endswith("u4") else 1)
    return variant.startswith("slim"), unroll


def run_plain(rays, sph: torch.Tensor, variant: str) -> torch.Tensor:
    """The probe's plain version: the first minimum of t over every column
    of `sph` (the strict `<` scan keeps it) and its carry value."""
    slim, _ = parse(variant)
    chunk = _twin_chunk(sph.shape[1])
    if rays[0].shape[0] > chunk:
        return torch.cat([run_plain([x[r0:r0 + chunk] for x in rays], sph, variant)
                          for r0 in range(0, rays[0].shape[0], chunk)])
    ox, oy, oz, dx, dy, dz, tm = rays
    a = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20)
    bt, win = _first_min(_sphere_t(sph, ox, oy, oz, dx, dy, dz, tm, a, 1.0 / a, T_MIN))
    hit = win >= 0
    w = torch.clamp_min(win, 0)
    carry = win.to(torch.float32) if slim else sph[ROW_CX][w] + tm * sph[ROW_MX][w]
    return torch.where(hit, bt, 0.0) + torch.where(hit, carry, 0.0) * 1e-7


def run(rays, sph: torch.Tensor, variant: str) -> torch.Tensor:
    """The kexp probe `variant` (VARIANTS) on `rays` (ox, oy, oz, dx, dy,
    dz, tm; [R] float32 each) over the (16, n) table `sph`. CPU tensors run
    the plain version, CUDA tensors the kernel."""
    parse(variant)
    if rays[0].device.type == "cpu":
        return run_plain(rays, sph, variant)
    n, r = sph.shape[1], rays[0].shape[0]
    planes = probes.kernel_rays(rays)
    _require(sph, "sph", (N_ROWS, n), torch.float32, planes[0].device)
    r_pad = planes[0].shape[0]
    out = torch.empty(r_pad, dtype=torch.float32, device=sph.device)
    key = f"kexp_{variant}"
    probes.call(key, "rtp_probe_hit", *probes.HIT_ARGS[key], sph.data_ptr(), n,
                *(x.data_ptr() for x in planes), out.data_ptr(), r_pad,
                probes.stream(sph.device))
    return out[:r]


def measure(scene: Scene, device="cuda") -> dict:
    """Each variant's time on `scene` at the 400x225 primary rays, with its
    agreement to the full x1 probe: {"rays", "spheres", variant: {"ms",
    "max_abs"}}."""
    dev = probes.require_card(device)
    sph = scene_table(scene).to(dev)

    def fresh(s):
        return primary_rays(dev, generator=torch.Generator(device=dev).manual_seed(s))

    rays = [fresh(s) for s in range(4)]
    out = {"rays": rays[0][0].shape[0], "spheres": scene.num_spheres}
    pool = [probes.padded(x) for x in rays]  # padded here, outside the timed passes
    ref = {False: run(pool[0], sph, "full"), True: run(pool[0], sph, "slim")}
    for v in VARIANTS:
        got = run(pool[0], sph, v)
        ms = marginal_ms(lambda s, v=v: run(pool[s % 4], sph, v), k1=8, k2=24)
        out[v] = {"ms": ms, "max_abs": (got - ref[parse(v)[0]]).abs().max().item()}
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    scene = probe_scene(int(argv[0]) if argv else None)
    res = measure(scene)
    r, n = res["rays"], res["spheres"]
    warps = -(-r // 32)
    for v in VARIANTS:
        ms = res[v]["ms"]
        print(f"{v:8s}: {r / ms / 1e3:7.2f} Mrays/s  ({ms:7.3f} ms/pass, "
              f"{ms * 1e6 / warps / n:6.2f} ns/sphere/warp)", flush=True)


if __name__ == "__main__":
    main()
