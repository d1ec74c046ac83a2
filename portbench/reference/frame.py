"""A frame's pixels, worked out again from the scene's arrays, the camera
and the frame's generator: every sample of each asked-for pixel, in the
pass split, slot order and draw order of camera.py, traced by trace.py."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import camera, trace


def pixels(arrays: dict, cam: dict, width: int, height: int, spp: int, depth: int,
           gen: torch.Generator, pix: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """Mean radiance [P, 3] (float32) of the row-major pixels `pix` of the
    frame whose draws come from `gen`; the bounce loop runs in `dtype`."""
    device = gen.device
    frame = camera.derive(cam, width, height)
    sc = trace.scene_on(arrays, device, dtype)
    chunk = camera.pass_chunk(width, height, spp)
    pix_t = torch.as_tensor(pix, dtype=torch.int64, device=device)
    rays, slots, seeds, counts = [], [], [], []
    done = 0
    while done < spp:
        c = min(chunk, spp - done)
        slot_pix, gather = camera.block_order(width, height, c)
        draws, seed = camera.pass_draws(len(slot_pix), gen, device)
        sl = torch.as_tensor(gather[:, pix].reshape(-1), device=device)
        rays.append(camera.rays(frame, pix_t.repeat(c), width, [x[sl] for x in draws], dtype))
        slots.append(sl)
        seeds.append(torch.full_like(sl, seed))
        counts.append(c)
        done += c
    o, d, tm = (torch.cat([r[q] for r in rays]) for q in range(3))
    rad = trace.radiance(sc, o, d, tm, torch.cat(slots), torch.cat(seeds), depth).float()
    # the samples of each pixel summed in pass order, as the renderer sums them
    acc = torch.zeros((len(pix), 3), dtype=torch.float32, device=device)
    for part in rad.split([c * len(pix) for c in counts]):
        acc = acc + part.reshape(-1, len(pix), 3).sum(dim=0)
    return acc / spp
