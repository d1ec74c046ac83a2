"""The card's measured peaks (tools/roofline.py of the JAX package): the
FFMA rate and the sphere-test rate of the brute closest hit.

- `fma_peak`: FFMA instructions a second of `fma_chains` (csrc/probes.cu
  fma_kernel: eight independent chains of explicit FMAs a thread). One
  FFMA is two floating-point operations; the port's kernels are built
  with -fmad=false, so each operation they are charged (`test_ops`) is
  one instruction: their operations bound is read at
  this rate, or at the data sheet's (SPEC_FP32_FLOPS / 2) where that is
  higher.
- `mixed_peak`: lane-sphere tests a second of the brute closest hit in
  isolation (`mixed_hits`: the reference quadratic with the roots only
  where the discriminant is positive, as every kernel of the port takes
  them, over a random 488-sphere table, every carry of the hit summed into
  the output so that none of its selects is dropped): the ceiling for the
  intersection's own mix of instructions, against which a closest hit's
  pairs a second give its "mixed share". Its operations a second
  (`measure`'s `mixed_ops_per_s`) are `test_ops` of its pairs and of
  those whose discriminant is positive, the count its bound charges.

    python -m raytracingproject_tpu_torch.probes.roofline

prints one JSON line with both peaks and the card's nvidia-smi line.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

from raytracingproject_tpu_torch import probes
from raytracingproject_tpu_torch.ops.cuda.megakernel import (
    N_ROWS, UNROLL, _pad_rays, _require, _sphere_disc, _sphere_t, _twin_chunk,
)
from raytracingproject_tpu_torch.probes.measure import marginal_ms

# Floating-point operations a test is charged, counted line by line in the
# plain versions (one per multiply, add, subtract, negate, compare, select,
# sqrt). A ray against a sphere, `_sphere_t` and `_first_min`: the moving
# centre 6 (3 mul, 3 add), o - c 3, half_b 5 (3 mul, 2 add), c 7 (4 mul,
# 2 add, 1 sub), disc 3 (2 mul, 1 sub), its test 1: 25 for every pair
# (OPS_PAIR_DISC); then, only where disc > 0, the guard and sqrt 2, the
# two roots 5 (1 neg, 2 add, 2 mul), the interval tests and
# selects 5, the strict-< best 3 (compare, select t, select idx): 15 more
# (OPS_PAIR_ROOTS). A pair whose discriminant is not positive never uses
# its roots, so a bound charges 25 for it and 40 for the others
# (`test_ops`); every kernel of the port, the probes included, computes
# the roots only there. A ray against a box,
# `subtree_slab_mask`: 6 an axis (2 sub, 2 mul, min, max) = 18, the y axis
# folded in 2, the z axis with its t_min clamp 3, the final compare 1: 24
# (the reciprocals of the direction are per ray, not per box). The rest of
# a bounce (hit geometry, sky, the Philox draws' integer work, the scatter
# rules) is left out: a bound from these counts is lower than the work, so
# a kernel's share of it is if anything understated.
OPS_PAIR_DISC = 25
OPS_PAIR_ROOTS = 15
OPS_PER_BOX = 24


def test_ops(pairs: float, roots: float, boxes: float = 0.0) -> float:
    """Operations a bound charges for `pairs` ray-sphere pairs, `roots` of
    them with a positive discriminant, and `boxes` ray-box tests."""
    return pairs * OPS_PAIR_DISC + roots * OPS_PAIR_ROOTS + boxes * OPS_PER_BOX


def positive_discriminants(sph: torch.Tensor, rays, mask=None, chunk: int = 8192) -> int:
    """Ray-sphere pairs of `rays` (the seven planes o xyz, d xyz, time)
    against the columns of `sph` (16 or 8, C) whose discriminant is
    positive (`_sphere_disc`), counted in chunks of rays; with `mask`, a
    function of a chunk's rays giving [r, C] bool, only the pairs it keeps."""
    ox, oy, oz, dx, dy, dz, tm = rays
    n = 0
    for r0 in range(0, ox.shape[0], chunk):
        r = [x[r0:r0 + chunk] for x in rays]
        a = torch.clamp_min(r[3] * r[3] + r[4] * r[4] + r[5] * r[5], 1e-20)
        pos = _sphere_disc(sph, *r, a)[1] > 0.0
        if mask is not None:
            pos &= mask(r)
        n += int(pos.sum())
    return n

# The FMA probe (tools/roofline.py CHAINS, INNER, ITERS): per element,
# CHAINS chains of INNER * ITERS steps c <- fma(c, FMA_A, FMA_B).
CHAINS, INNER, ITERS = 8, 8, 512
FMA_A = float(np.float32(1.000000119))  # 1 + 2^-23
FMA_B = float(np.float32(1e-30))
FMAS_PER_ELEMENT = CHAINS * INNER * ITERS
# float32 outside the tensor cores on NVIDIA's data sheet (H100 SXM at
# 700 W), which counts an FMA as two operations; printed beside the
# measured rate.
SPEC_FP32_FLOPS = 67e12


def fma_chains_plain(x: torch.Tensor) -> torch.Tensor:
    """fma_kernel's plain version, elementwise over float32 `x`. Each step
    fma(c, A, B) is computed exactly: c * A is exact in float64 (two 24-bit
    significands), and as 0 < B is far below half an ulp of c * A, the
    correctly rounded c * A + B is the float32 rounding of the next float64
    above c * A (no float32 rounding boundary lies strictly between them),
    which breaks the ties that rounding c * A alone would get wrong."""
    c = torch.stack([x * torch.tensor(1.0 + 1e-6 * k, dtype=torch.float32)
                     for k in range(CHAINS)])
    up = torch.tensor(np.inf, dtype=torch.float64, device=x.device)
    for _ in range(INNER * ITERS):
        c = torch.nextafter(c.double() * FMA_A, up).float()
    acc = c[0]
    for k in range(1, CHAINS):
        acc = acc + c[k]
    return acc


def fma_chains(x: torch.Tensor) -> torch.Tensor:
    """The FMA probe over float32 `x` (any shape): per element the sum of
    CHAINS chains of INNER * ITERS FMAs. CPU tensors run the plain version,
    CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return fma_chains_plain(x)
    _require(x, "x", x.shape, torch.float32, x.device)
    out = torch.empty_like(x)
    probes.call("fma", "rtp_probe_fma", x.data_ptr(), out.data_ptr(), x.numel(),
                probes.stream(x.device))
    return out


def mixed_table(n_spheres: int = 488, seed: int = 0) -> torch.Tensor:
    """(16, n_pad) sphere table of the mixed peak, n_pad the next multiple
    of 8 (tools/roofline.py:119-126): centres uniform in [-8, 8]^3, radii in
    [0.1, 0.4], rows 7-12 uniform in [0, 1), no motion."""
    n_pad = -(-n_spheres // UNROLL) * UNROLL
    rng = np.random.default_rng(seed)
    tab = np.zeros((N_ROWS, n_pad), np.float32)
    tab[0:3] = rng.uniform(-8, 8, (3, n_pad))
    tab[6] = rng.uniform(0.1, 0.4, n_pad)
    tab[7:13] = rng.uniform(0.0, 1.0, (6, n_pad))
    return torch.from_numpy(tab)


def mixed_rays(ox: torch.Tensor):
    """The mixed peak's synthetic rays from one float32 plane
    (tools/roofline.py:137-146): (ox, oy, oz, dx, dy, dz, tm, a, inv_a)."""
    oy = ox * 0.5 + 2.0
    oz = ox * 0.25 + 3.0
    dx = ox * 1e-3 - 0.9
    dy = ox * 1e-3 - 0.1
    dz = ox * 1e-3 - 0.3
    tm = ox * 0.0
    a = dx * dx + dy * dy + dz * dz
    return ox, oy, oz, dx, dy, dz, tm, a, 1.0 / a


def mixed_hits_plain(tab: torch.Tensor, ox: torch.Tensor) -> torch.Tensor:
    """The mixed probe's plain version: the brute closest hit of each
    synthetic ray over `tab`, and the sum of its hit carry in the JAX
    carry's order (best t, centre xyz, radius, material, albedo rgb, fuzz,
    ior; a miss keeps the initial carry, so its sum is inf). The material
    is the table's value truncated to an integer, as the kernel's hit holds
    it. Runs in ray chunks (the scan holds a [rays, spheres] temporary)."""
    chunk = _twin_chunk(tab.shape[1])
    if ox.shape[0] > chunk:
        return torch.cat([mixed_hits_plain(tab, ox[r0:r0 + chunk])
                          for r0 in range(0, ox.shape[0], chunk)])
    rays = mixed_rays(ox)
    t = _sphere_t(tab, *rays, t_min=1e-3)
    win = torch.argmin(t, dim=1)
    bt = torch.gather(t, 1, win[:, None])[:, 0]
    hit = bt < np.inf
    col = tab[:, win]
    tm = rays[6]
    carry = [
        bt,
        torch.where(hit, col[0] + tm * col[3], 0.0),
        torch.where(hit, col[1] + tm * col[4], 0.0),
        torch.where(hit, col[2] + tm * col[5], 0.0),
        torch.where(hit, col[6], 1.0),
        torch.where(hit, torch.trunc(col[7]), 0.0),
        *(torch.where(hit, col[r], 0.0) for r in (8, 9, 10, 11)),
        torch.where(hit, col[12], 1.0),
    ]
    acc = carry[0]
    for c in carry[1:]:
        acc = acc + c
    return acc


def mixed_hits(tab: torch.Tensor, ox: torch.Tensor) -> torch.Tensor:
    """The mixed probe over the (16, n) table `tab` and [R] float32 `ox`
    (the synthetic rays' seed plane). CPU tensors run the plain version,
    CUDA tensors the kernel (probe_hit_kernel<WIDE, 8, OUT_SUM>)."""
    if ox.device.type == "cpu":
        return mixed_hits_plain(tab, ox)
    n, r = tab.shape[1], ox.shape[0]
    _require(ox, "ox", (r,), torch.float32, ox.device)
    _require(tab, "tab", (N_ROWS, n), torch.float32, ox.device)
    r_pad = probes.blocks(r)
    ox = _pad_rays(ox, r_pad)
    out = torch.empty_like(ox)
    probes.call("mixed", "rtp_probe_hit", *probes.HIT_ARGS["mixed"], tab.data_ptr(), n,
                ox.data_ptr(), *([None] * 6), out.data_ptr(), r_pad, probes.stream(ox.device))
    return out[:r]


def full_waves(dev) -> int:
    """Elements (or rays) that fill the card in whole waves: 48 blocks of
    256 threads an SM (a multiple of every per-SM block count from 1 to 8
    but 5 and 7), so no partial wave tails the timing."""
    return torch.cuda.get_device_properties(dev).multi_processor_count * 48 * probes.PTPB


def fma_peak(device="cuda") -> dict:
    """The measured FFMA rate of the card: {"ffma_per_s", "flops_per_s"
    (twice that), "ms" (one pass), "elements", "ffma" (per pass)}."""
    dev = probes.require_card(device)
    n = full_waves(dev)
    pool = [torch.full((n,), 1.0 + 0.01 * k / 16, device=dev) for k in range(16)]
    ms = marginal_ms(lambda s: fma_chains(pool[s % 16]), k1=4, k2=12, reps=5)
    fmas = n * FMAS_PER_ELEMENT
    return {"ffma_per_s": fmas / ms * 1e3, "flops_per_s": 2 * fmas / ms * 1e3, "ms": ms,
            "elements": n, "ffma": fmas}


def mixed_peak(n_spheres: int = 488, device="cuda") -> dict:
    """The measured sphere-test rate of the brute closest hit, every carry
    consumed: {"pairs_per_s", "roots_per_s" (of those pairs, the ones whose
    discriminant is positive), "ms" (one pass), "rays", "spheres" (padded),
    "roots" (a pass's, the mean over the timed passes' ray sets)}."""
    dev = probes.require_card(device)
    tab = mixed_table(n_spheres).to(dev)
    r = full_waves(dev)
    base = torch.linspace(10.0, 14.0, r, device=dev)
    pool = [base * (0.99 + 0.02 * k / 16) for k in range(16)]
    ms = marginal_ms(lambda s: mixed_hits(tab, pool[s % 16]), k1=8, k2=24, reps=5)
    n = tab.shape[1]
    roots = statistics.mean(positive_discriminants(tab, mixed_rays(x)[:7], chunk=1 << 16)
                            for x in pool)
    return {"pairs_per_s": r * n / ms * 1e3, "roots_per_s": roots / ms * 1e3, "ms": ms,
            "rays": r, "spheres": n, "roots": roots}


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def measure(device="cuda") -> dict:
    """Both peaks, with the card they were measured on. The mixed peak's
    operations a second are those a bound charges for its tests
    (`test_ops` of its pairs and roots), read against the FFMA rate."""
    dev = probes.require_card(device)
    fma, mixed = fma_peak(dev), mixed_peak(device=dev)
    ops = test_ops(mixed["pairs_per_s"], mixed["roots_per_s"])
    return {
        "card": card_line(), "ffma_per_s": fma["ffma_per_s"],
        "fp32_flops_per_s": fma["flops_per_s"], "spec_fp32_flops_per_s": SPEC_FP32_FLOPS,
        "fma_ms": fma["ms"], "mixed_pairs_per_s": mixed["pairs_per_s"],
        "mixed_ops_per_s": ops, "mixed_ops_over_ffma": ops / fma["ffma_per_s"],
        "mixed_ms": mixed["ms"], "mixed_spheres": mixed["spheres"],
        "mixed_roots": mixed["roots"], "mixed_rays": mixed["rays"],
    }


def main() -> None:
    print(json.dumps(measure()), flush=True)


if __name__ == "__main__":
    main()
