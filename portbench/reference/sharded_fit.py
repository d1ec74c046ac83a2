"""The sharded fit's steps, worked out again on one card: the layout of
the program's sharded train step (a mesh of `n_rays` x `n_samples` ranks,
pixels over `rays`, samples over `samples`), its draws, and its loss.

Each step draws one base from the step generator (`torch.randint(0,
2^62)`), and for the rank at (ray_id, s_id) a generator seeded with words
0 and 1 of the Philox-4x32-10 block at counter (ray_id, s_id, 0, 0)
under the key (base's low 32 bits, its high bits) (philox.py). From it
the rank draws its camera uniforms, in the order of camera.py's
`pass_draws`, and then its path seed, for its slice of the pixel list:
the row-major pixels padded to a multiple of `n_rays` with pixel 0,
cut in `n_rays` contiguous slices, each slice's `spp / n_samples`
samples in sample-major order, the ray slots numbered from 0 in that
order. trace.py traces them. The loss is the sum over the slices of
sum((slice image - slice target)^2) / (W * H * 3), the slice image the
sum of its samples over `spp` (padding pixels take pixel 0's target).
It is accumulated one slice at a time, each slice's graph freed before
the next, so a 1200x675 step fits one card. Adam is PyTorch's, with
fit.py's betas and eps.

The program's one rule beyond the plain estimator is followed
(`FiniteGathers`): at every bounce, the elements of a ray's gradient of
its sphere's albedo, fuzz and ior that are not finite are zeroed. A path
caught near the contact of two surfaces has a derivative past float32's
range, and its +inf and -inf would sum to NaN.
"""

from __future__ import annotations

import torch

from portbench.reference import camera, fit, philox, trace


class FiniteGathers:
    """A trained leaf as trace.py's shading reads it: each per-ray gather
    `leaf[i]` has the elements of its gradient that are not finite set to
    0 (a ray's, at one bounce); finite ones pass unchanged."""

    def __init__(self, leaf: torch.Tensor):
        self.leaf = leaf

    def __getitem__(self, i):
        rows = self.leaf[i]
        rows.register_hook(lambda g: torch.where(torch.isfinite(g), g, 0.0))
        return rows


def rank_generator(base: int, ray_id: int, s_id: int, device) -> torch.Generator:
    """The generator of the rank at (ray_id, s_id) for a step's `base`."""
    c = [torch.tensor([x], dtype=torch.int64) for x in (ray_id, s_id, 0, 0)]
    w0, w1, _, _ = philox.philox(*c, base & philox.MASK32, base >> 32)
    return torch.Generator(device=device).manual_seed((int(w0) << 32) | int(w1))


def slices(width: int, height: int, n_rays: int) -> list[torch.Tensor]:
    """Each ray slice's row-major pixels (int64), the list padded with
    pixel 0 to a multiple of `n_rays`."""
    n = width * height
    pix = torch.cat([torch.arange(n), torch.zeros((-n) % n_rays, dtype=torch.int64)])
    return list(pix.chunk(n_rays))


def steps(arrays: dict, target: torch.Tensor, cam: dict, width: int, height: int, spp: int,
          depth: int, gen: torch.Generator, n_steps: int, lr: float, trainable,
          n_rays: int, n_samples: int = 1, dtype=torch.float32, half: bool = False,
          fault_step: int | None = None, alone: bool = False):
    """fit.steps' result ({"loss", "grad", "params", "start"}) for the
    sharded step on a mesh of `n_rays` x `n_samples` ranks, in `dtype`.
    Three planted faults for the benchmark's checks: `half`, each slice's
    image the mean over the first half of its samples alone (fit.py's);
    `fault_step`, the base drawn twice at that step, so every rank's draws
    are wrong from there on; `alone`, the gradients' exchange left out:
    the update from the first slice's gradient alone (rank 0's, as if it
    trained on its own pixels), the loss still over every slice."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = gen.device
    frame = camera.derive(cam, width, height)
    sc = trace.scene_on(arrays, device, dtype)
    leaves = {f: sc[f].clone().requires_grad_(True) for f in trainable}
    start = {f: v.detach().clone() for f, v in leaves.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=lr, betas=fit.BETAS, eps=fit.EPS,
                           foreach=False)
    spp_local = spp // n_samples
    flat_target = target.to(device, dtype).reshape(-1, 3)
    norm = 1.0 / (width * height * 3)
    out = {"loss": [], "grad": []}
    for k in range(1, n_steps + 1):
        base = _draw_base(gen)
        if k == fault_step:
            base = _draw_base(gen)
        mats = tuple(FiniteGathers(leaves[f]) if f in leaves else sc[f]
                     for f in ("albedo", "fuzz", "ior"))
        loss = torch.zeros((), dtype=torch.float64, device=device)
        for ray_id, pix in enumerate(slices(width, height, n_rays)):
            pix = pix.to(device)
            acc = 0.0
            for s_id in range(n_samples):
                g = rank_generator(base, ray_id, s_id, device)
                n = spp_local * pix.shape[0]
                draws, seed = camera.pass_draws(n, g, device)
                o, d, tm = camera.rays(frame, pix.repeat(spp_local), width, draws, dtype)
                slot = torch.arange(n, device=device)
                rad = trace.radiance(sc, o, d, tm, slot, seed, depth, mats=mats)
                acc = acc + rad.reshape(spp_local, pix.shape[0], 3).sum(dim=0)
            if half:
                acc = rad.reshape(spp_local, pix.shape[0], 3)[:max(1, spp_local // 2)].sum(
                    dim=0) * (spp_local / max(1, spp_local // 2))
            resid = acc / spp - flat_target[pix]
            part = torch.sum(resid * resid) * norm
            if ray_id == 0 or not alone:
                part.backward()
            loss += part.detach()
            del acc, resid, part, rad
        grads = {f: torch.zeros_like(v) if v.grad is None else v.grad.clone()
                 for f, v in leaves.items()}
        opt.step()
        opt.zero_grad(set_to_none=True)
        out["loss"].append(float(loss))
        out["grad"].append(grads)
    out["params"] = {f: v.detach() for f, v in leaves.items()}
    out["start"] = start
    return out


def _draw_base(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
