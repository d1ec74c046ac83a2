"""Probe kernels: measurements of the card and of the closest hit alone
(counterpart of tools/roofline.py, tools/kfront.py, tools/kexp.py and
tools/measure.py of the JAX package).

- `measure.marginal_ms`: the marginal time of one pass between two pass
  counts, on CUDA events.
- `roofline`: `fma_peak` (FFMA instructions a second) and `mixed_peak`
  (sphere tests a second of the brute closest hit, every carry consumed),
  and the operation counts a test is charged (`test_ops`).
  `python -m raytracingproject_tpu_torch.probes.roofline`.
- `kfront`: the front-culled closest hit without shading against the
  unrolled brute one (`pack_front_tables`, `run_front`, `run_brute`).
  `python -m raytracingproject_tpu_torch.probes.kfront [n_spheres]`.
- `kexp`: closest-hit variants, the full hit carry against best t and
  winner alone, unrolled x1, x4, x8 (`run`).
  `python -m raytracingproject_tpu_torch.probes.kexp [n_spheres]`.
- `compare_builds`: the kernels built from several source trees and
  timed in turns in one process (old against new).
  `python -m raytracingproject_tpu_torch.probes.compare_builds [--frames] [--scans] [--bvh]
  [--front] [--probes] NAME=DIR ...`.
- `pair_counts`: the work of K4, K3, K7 and K8 on a pass, counted (pairs
  with a positive discriminant, per ray and per warp; the warp union
  against each ray's own masks; warp steps), and kfront's front probe's
  warp steps and shared-memory wavefronts; a count, so it runs on any
  device. `python -m raytracingproject_tpu_torch.probes.pair_counts [device] [--front]
  [--hbm] [--bvh] [--kfront]`.

The kernels are hand-written CUDA in csrc/probes.cu. Each wrapper runs its
plain PyTorch version for CPU tensors and launches the kernel (or raises)
for CUDA tensors; `LAUNCHES` counts the launches; `blocks_per_sm` gives a
probe's occupancy. The measurements need a card: they raise without one.
"""

from __future__ import annotations

import torch

from raytracingproject_tpu_torch.ops.cuda import build
from raytracingproject_tpu_torch.ops.cuda.megakernel import _pad_rays, _require

# closest-hit variants of the kexp probe: the full hit carry or best t and
# winner alone ("slim"), unrolled x1 (no suffix), x4 or x8
KEXP_VARIANTS = ("full", "full_u4", "full_u8", "slim", "slim_u4", "slim_u8")

# Kernel launches by probe, counted after each successful launch.
LAUNCHES = {"fma": 0, "mixed": 0, "kfront_front": 0, "kfront_brute": 0,
            **{f"kexp_{v}": 0 for v in KEXP_VARIANTS}}

# Rays per block of the probes (PTPB in csrc/probes.cu): rays are padded
# to a multiple.
PTPB = 256
# Spheres a staged chunk of probe_hit_kernel (CHUNK in csrc/probes.cu): the
# edges the tests hold the probes at.
CHUNK = 256

# (variant, unroll, out) of rtp_probe_hit for each probe_hit_kernel
# instantiation, by launch key: variant 0 the full hit carry (WIDE), 1 best
# t and winner (SLIM); out 0 best t, 1 kexp's t + carry * 1e-7, 2 the sum of
# every carry (the mixed peak).
HIT_ARGS = {"mixed": (0, 8, 2), "kfront_brute": (0, 8, 0),
            **{f"kexp_{v}": (int(v.startswith("slim")),
                             8 if v.endswith("u8") else 4 if v.endswith("u4") else 1, 1)
               for v in KEXP_VARIANTS}}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def require_card(device) -> torch.device:
    """The CUDA device a measurement runs on; raises without one."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the probes measure a CUDA card, not {dev}")
    return dev


def stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def call(key: str, fn_name: str, *args) -> None:
    """Launch csrc/probes.cu's entry `fn_name`, check it and count it."""
    err = getattr(build.load_library("probes"), fn_name)(*args)
    build.check(err, f"{key} probe launch", "probes")
    LAUNCHES[key] += 1


def blocks_per_sm(key: str, n_cols: int = 0, n_front: int = 0) -> int:
    """Blocks of PTPB threads one SM holds of the probe `key`
    ("kfront_front" over `n_cols` columns and `n_front` subtrees, or a key
    of HIT_ARGS, whose shared memory does not depend on the table), as its
    launch gets them on the current card."""
    import ctypes

    lib = build.load_library("probes")
    b = ctypes.c_int()
    args = (0, 0, 0, n_cols, n_front) if key == "kfront_front" else (*HIT_ARGS[key], 0, 0)
    build.check(lib.rtp_probe_blocks_per_sm(*args, ctypes.byref(b)), f"{key} probe occupancy",
                "probes")
    return b.value


def blocks(r: int) -> int:
    """`r` rays rounded up to whole blocks of PTPB threads."""
    return -(-r // PTPB) * PTPB


def padded(rays) -> list[torch.Tensor]:
    """The seven ray planes padded to whole blocks with copies of ray 0
    (no copy when they fill them already). The measurements pad their
    pools so, outside the timed passes."""
    return [_pad_rays(x, blocks(x.shape[0])) for x in rays]


def kernel_rays(rays) -> list[torch.Tensor]:
    """The seven ray planes (ox, oy, oz, dx, dy, dz, tm; [R] float32,
    contiguous, on one device) as the kernels take them: padded to whole
    blocks. Raises on anything else."""
    r, dev = rays[0].shape[0], rays[0].device
    for name, x in zip(("ox", "oy", "oz", "dx", "dy", "dz", "tm"), rays, strict=True):
        _require(x, name, (r,), torch.float32, dev)
    return padded(rays)


def ray_planes(origin: torch.Tensor, direction: torch.Tensor, time: torch.Tensor):
    """(ox, oy, oz, dx, dy, dz, tm) of [R, 3], [R, 3], [R] rays, float32."""
    o, d = origin.float(), direction.float()
    return (o[:, 0].contiguous(), o[:, 1].contiguous(), o[:, 2].contiguous(),
            d[:, 0].contiguous(), d[:, 1].contiguous(), d[:, 2].contiguous(),
            time.float().contiguous())
