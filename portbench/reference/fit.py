"""The fit's steps, worked out again: each step draws its camera rays (the
[spp, H, W] order) and then its path seed from the step generator, traces
them by the differentiable loop of trace.py, takes the mean-squared error
of the spp-mean image against the target, and applies Adam (PyTorch's
defaults: betas 0.9 and 0.999, eps 1e-8, bias-corrected) to the trained
materials."""

from __future__ import annotations

import torch

from portbench.reference import camera, trace

BETAS = (0.9, 0.999)
EPS = 1e-8


def steps(arrays: dict, target: torch.Tensor, cam: dict, width: int, height: int, spp: int,
          depth: int, gen: torch.Generator, n_steps: int, lr: float, trainable,
          dtype=torch.float32, half: bool = False):
    """{"loss": [float] a step, "grad": [{field: gradient}] a step, "params": {field: value
    after the steps}, "start": {field: value before}} of `n_steps` steps from the scene
    `arrays`, in `dtype`. `half` plants a fault for the benchmark's control: the image is
    the mean over the first half of the samples alone."""
    device = gen.device
    frame = camera.derive(cam, width, height)
    sc = trace.scene_on(arrays, device, dtype)
    leaves = {f: sc[f].clone().requires_grad_(True) for f in trainable}
    start = {f: v.detach().clone() for f, v in leaves.items()}
    m = {f: torch.zeros_like(v) for f, v in leaves.items()}
    v2 = {f: torch.zeros_like(v) for f, v in leaves.items()}
    n = spp * width * height
    pix = torch.arange(width * height, device=device).repeat(spp)
    slot = torch.arange(n, device=device)
    target = target.to(device, dtype)
    out = {"loss": [], "grad": []}
    for k in range(1, n_steps + 1):
        draws, seed = camera.pass_draws(n, gen, device)
        o, d, tm = camera.rays(frame, pix, width, draws, dtype)
        mats = tuple(leaves.get(f, sc[f]) for f in ("albedo", "fuzz", "ior"))
        rad = trace.radiance(sc, o, d, tm, slot, seed, depth, mats=mats)
        img = rad.reshape(spp, height, width, 3)[:max(1, spp // 2) if half else spp].mean(dim=0)
        loss = torch.mean((img - target) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {f: torch.zeros_like(leaves[f]) if g is None else g
                 for f, g in zip(leaves, grads)}
        with torch.no_grad():
            for f, g in grads.items():
                m[f] = BETAS[0] * m[f] + (1.0 - BETAS[0]) * g
                v2[f] = BETAS[1] * v2[f] + (1.0 - BETAS[1]) * g * g
                bc1 = 1.0 - BETAS[0] ** k
                bc2 = 1.0 - BETAS[1] ** k
                leaves[f] -= (lr / bc1) * m[f] / (v2[f].sqrt() / bc2 ** 0.5 + EPS)
        out["loss"].append(float(loss.detach()))
        out["grad"].append({f: g.detach() for f, g in grads.items()})
        del rad, img, loss
    out["params"] = {f: v.detach() for f, v in leaves.items()}
    out["start"] = start
    return out
