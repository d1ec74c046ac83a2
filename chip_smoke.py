#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc, holds each against its plain
PyTorch version on the card, and drives the port's two main paths, each
checked to have gone through its kernels:

- serving: the cover scene through `render_image`, `render` and the CLI
  at the reference configuration (400x225, 30 spp, depth 50), on the
  forward megakernel (K1 with K2 or K3);
- training: `grad.fast.make_fast_train_step` on the cover scene at
  400x225, 2 spp, depth 50 (geometry + albedo on the brute recording
  kernel, materials on the front one), the recording megakernel (K5)
  forward and the path-replay backward, plus a descent check on the
  three-sphere scene. K5 is held against its plain version both at the
  bench shape and on one step's rays at the step's own shapes.

It then times kernels and plain versions at the bench shape (400x225,
4 spp, depth 16) and the train steps at full width. Any failed check
raises and the script exits non-zero. Without a CUDA device it exits 1 and
prints no result.

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
    "record_brute": "raytracingproject_tpu/ops/pallas/megakernel.py:1637",
    "record_front": "raytracingproject_tpu/ops/pallas/megakernel.py:1637",
}
COVER_CAMERA = dict(aspect_ratio=16.0 / 9.0, image_width=400, vfov=20.0,
                    lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                    defocus_angle=0.6, focus_dist=10.0)
N_CMP = 65536  # camera rays in the kernel-against-twin comparisons
TRAIN_STEPS = 7  # per full-width configuration: 2 warm-up, 5 timed
# Descent check (three-sphere scene, 128x72, 4 spp, depth 8, albedo only,
# 40 steps): mean loss of the last 5 steps over the first 5 must stay
# below this. Measured 0.218 on an H100 80GB HBM3 at 700 W; the limit
# leaves that run a margin of 1.8x.
DESCENT_RATIO = 0.4


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
                zero: bool) -> float:
    """K5 (brute without `front`, front with it) against its plain version
    on one set of rays: radiance bit-equal to the forward kernel's and
    within 1e-3 of the twin's on >= 99.9% of rays; idx equal on >= 99.9% of
    entries; ndir and refl equal wherever idx is. Returns the max |diff|
    (radiance against the twin, and ndir where idx is equal)."""
    import torch

    path = "front" if front is not None else "brute"
    rad, res = mk.trace_record(o, d, t, scene, seed, depth, front=front, zero_draws=zero)
    fwd = mk.trace_paths(o, d, t, scene, seed, depth, front=front, zero_draws=zero)
    prad, pres = mk.trace_record_twin(o, d, t, scene, seed, depth, front=front,
                                      zero_draws=zero)
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
    return max(rad_diff.max().item(), nd_diff)


def record_against_twin(mk, scene, front, o, d, t) -> dict:
    """Phase 8: K5 (brute and front) against its plain version at the
    bench shape's front (repack 2), depth 16, zero and Philox draws.
    Returns the max |diff| per path."""
    max_err = {}
    for path in ("brute", "front"):
        f = front if path == "front" else None
        max_err[path] = max(hold_record(mk, "bench shape", o, d, t, scene, f, 2024, 16, zero)
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


def step_rays(cam, gen):
    """One train step's camera rays (400x225 at the camera's spp, in the
    [spp, H, W] order) and path seed, drawn from `gen` as
    make_fast_train_step's step draws them."""
    import torch

    from raytracingproject_tpu_torch.camera import camera_uniforms, rays_from_uniforms

    dev = gen.device
    w, h = cam.image_size()
    pix = torch.arange(w * h, device=dev).repeat(cam.samples_per_pixel)
    o, d, t = rays_from_uniforms(cam.derive(torch.float32, dev), (pix % w).to(torch.int32),
                                 (pix // w).to(torch.int32),
                                 *camera_uniforms(pix.shape[0], gen, dev))
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=dev))
    return o, d, t, seed


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
            mk, "train step", o, d, t, start, fr, seed, cam.max_depth, False)
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
    check(launches["record_brute"] > 0 and launches["record_front"] > 0,
          "both recording kernels ran on the training path")
    return launches, step_s, rec_err


def descent(card: str) -> None:
    """Phase 11: albedo-only descent on the three-sphere scene (128x72,
    4 spp, depth 8, 40 steps of Adam(5e-2) from albedo 0.5)."""
    import dataclasses

    import torch

    from raytracingproject_tpu_torch.camera import Camera
    from raytracingproject_tpu_torch.config import RenderSettings
    from raytracingproject_tpu_torch.grad import make_fast_train_step
    from raytracingproject_tpu_torch.render import render
    from raytracingproject_tpu_torch.scene import make_three_sphere_scene

    dev = torch.device("cuda")
    cam = Camera(aspect_ratio=16.0 / 9.0, image_width=128, samples_per_pixel=4, max_depth=8,
                 vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0))
    true = make_three_sphere_scene()
    target = render(true, dataclasses.replace(cam, samples_per_pixel=64),
                    torch.Generator(device=dev).manual_seed(1),
                    RenderSettings(device="cuda", use_bvh=False))
    start = dataclasses.replace(true, albedo=torch.full_like(true.albedo, 0.5)).to(dev)
    params, opt, step = make_fast_train_step(start, cam, spp=4, learning_rate=5e-2,
                                             trainable=("albedo",),
                                             generator=torch.Generator(device=dev).manual_seed(2))
    losses = []
    for _ in range(40):
        params, opt, loss, _ = step(params, opt, None, target)
        losses.append(loss.item())
    ratio = (sum(losses[-5:]) / 5) / (sum(losses[:5]) / 5)
    err = torch.abs(params.albedo.detach().cpu() - true.albedo)[:2].max().item()
    print(f"descent (three spheres, 128x72, 4 spp, depth 8, albedo, 40 steps): loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}, last-5 / first-5 mean ratio {ratio:.4f} "
          f"(limit {DESCENT_RATIO}); max |albedo - truth| over the two diffuse spheres {err:.4f}")
    check(ratio < DESCENT_RATIO, "descent: the loss falls")


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

    # ---- 8. K5 (brute and front) against its plain version ----
    rec_err = record_against_twin(mk, scene, front, oc, dc, tc)

    # ---- 9. the replay on the card ----
    replay_on_card(mk, scene, front, oc, dc, tc)

    # ---- 10. the training path at full width (cover, 400x225, 2 spp, depth 50) ----
    train_launches, step_s, train_err = train_full_width(mk, card)

    # ---- 11. descent ----
    descent(card)

    # ---- 12. times: K5 and the replay at the bench shape, the step's split ----
    rec_times = time_training(mk, scene, front, o, d, t, card)
    for name, sec in step_s.items():
        print(f"seconds per train step, {name}, cover 400x225, 2 spp, depth 50: {sec:.4f} s "
              f"on {card}")
    step_split(card)
    for path in ("brute", "front"):
        key = f"record_{path}"
        ms, plain_ms = rec_times[path]
        kernels.append({
            "name": f"megakernel_{key}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[key], "launches": train_launches[key],
            "max_abs_err": max(rec_err[path], train_err[path]), "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
