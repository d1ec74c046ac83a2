"""Checkpoint and resume (counterpart of raytracingproject_tpu/utils/checkpoint.py).

The reference has none; its only recovery is swapchain recreation.
- `render_checkpointed`: a many-sample render saves (accumulated radiance,
  samples done) every few chunks, so an interrupted job resumes where it
  stopped and gives the image an uninterrupted one gives.
- `save_training_state` / `load_training_state`: SceneParams and the
  torch.optim optimizer's state of an inverse-rendering loop, in npz.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.ops.cuda.megakernel import BVHTables
from raytracingproject_tpu_torch.render import (
    prepare_oracle_scene, prepare_scene, render_pass,
)
from raytracingproject_tpu_torch.scene import Scene


def _config_fingerprint(scene: Scene, camera: Camera, seed: int,
                        settings: RenderSettings) -> str:
    h = hashlib.sha256()
    for f in ("center0", "center_delta", "radius", "mat_type", "albedo", "fuzz", "ior"):
        h.update(getattr(scene, f).detach().cpu().numpy().tobytes())
    h.update(json.dumps(
        [camera.image_width, camera.image_height, camera.samples_per_pixel,
         camera.max_depth, camera.vfov, list(camera.lookfrom), list(camera.lookat),
         list(camera.vup), camera.defocus_angle, camera.focus_dist, int(seed),
         [(k, str(v)) for k, v in sorted(vars(settings).items()) if k != "device"]]).encode())
    return h.hexdigest()[:16]


def _chunk_generator(seed: int, done: int, device) -> torch.Generator:
    """The generator of the sample chunk that starts after `done` samples:
    seeded from (seed, done) alone, the counterpart of the JAX package's
    fold_in(key, done), so a resumed render draws what an uninterrupted
    one draws."""
    return torch.Generator(device=device).manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | done)


def render_checkpointed(
    scene: Scene,
    camera: Camera,
    seed: int,
    checkpoint_path: str | Path,
    settings: RenderSettings | None = None,
    checkpoint_every: int = 8,
) -> np.ndarray:
    """Render with an accumulation checkpoint every `checkpoint_every`
    sample chunks; resumes when `checkpoint_path` holds a partial render
    of the same scene, camera, seed and settings.

    The render is `render`'s, chunk by chunk: the settings pick the path
    (the port's default, the megakernel with the front, or with
    `use_megakernel=False` the oracle loop with early exit, the JAX
    package's default here) and `rays_per_batch` the chunk. Chunk c draws
    from a generator seeded from (`seed`, samples done before it). Returns
    the mean-radiance image [H, W, 3] (float32 numpy); the checkpoint file
    is removed on completion."""
    settings = settings or RenderSettings()
    path = Path(checkpoint_path)
    device = settings.resolved_device()
    width, height = camera.image_size()
    spp = camera.samples_per_pixel
    fp = _config_fingerprint(scene, camera, seed, settings)

    acc = np.zeros((height, width, 3), np.float64)
    done = 0
    if path.exists():
        with np.load(path) as ck:
            if str(ck["fingerprint"]) == fp and int(ck["spp_total"]) == spp:
                acc = ck["acc"]
                done = int(ck["done"])

    bvh = front = None
    if settings.use_megakernel:
        scene, front = prepare_scene(scene, camera, settings)
        if isinstance(front, BVHTables):
            bvh, front = front, None
        dtype = torch.float32
    else:
        scene, bvh = prepare_oracle_scene(scene, settings)
        dtype = settings.dtype
    cam = camera.derive(dtype, device)
    spp_chunk = max(1, min(spp, settings.rays_per_batch // max(width * height, 1)))
    while done < spp:
        chunk = min(spp_chunk, spp - done)
        out = render_pass(
            scene, cam, _chunk_generator(seed, done, device), width=width, height=height,
            max_depth=camera.max_depth, spp_chunk=chunk, bvh=bvh, front=front,
            early_exit=True, use_pallas=settings.use_pallas,
            use_megakernel=settings.use_megakernel,
            depth_segment=settings.depth_segment or 0, two_phase=settings.two_phase or 0,
        )
        acc = acc + out.cpu().numpy().astype(np.float64)
        done += chunk
        if done < spp and (done // spp_chunk) % max(checkpoint_every, 1) == 0:
            tmp = path.with_suffix(".tmp.npz")
            np.savez(tmp, acc=acc, done=done, spp_total=spp, fingerprint=fp)
            os.replace(tmp, path)

    if path.exists():
        path.unlink()
    return (acc / spp).astype(np.float32)


def save_training_state(path: str | Path, params, opt_state: torch.optim.Optimizer,
                        step: int) -> None:
    """Save an inverse-rendering state: the SceneParams leaves, the
    optimizer's state_dict (its per-parameter tensors, and its parameter
    groups as JSON) and the step, as npz, written to a temporary file and
    moved into place (os.replace), so a crash never leaves half a file."""
    path = Path(path)
    sd = opt_state.state_dict()
    arrays = {f"p{i}": x.detach().cpu().numpy() for i, x in enumerate(params)}
    for pid, st in sd["state"].items():
        for name, v in st.items():
            arrays[f"o{pid}_{name}"] = torch.as_tensor(v).cpu().numpy()
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, step=step, n_params=len(params),
             opt_groups=json.dumps(sd["param_groups"]), **arrays)
    os.replace(tmp, path)


def load_training_state(path: str | Path, params_like, opt_state_like: torch.optim.Optimizer):
    """Restore what save_training_state wrote into `params_like` (a
    SceneParams, its tensors overwritten in place) and `opt_state_like`
    (an optimizer over the same trainable tensors, e.g. a fresh train
    step's), so the optimizer keeps holding the returned parameters.
    Returns (params, opt_state, step)."""
    with np.load(Path(path)) as ck:
        step = int(ck["step"])
        n_params = int(ck["n_params"])
        if n_params != len(params_like):
            raise ValueError(f"{path} holds {n_params} parameter fields, not {len(params_like)}")
        with torch.no_grad():
            for i, x in enumerate(params_like):
                x.copy_(torch.from_numpy(ck[f"p{i}"]))
        groups = json.loads(str(ck["opt_groups"]))
        state: dict = {}
        for key in ck.files:
            if key.startswith("o") and key != "opt_groups":
                pid, name = key[1:].split("_", 1)
                state.setdefault(int(pid), {})[name] = torch.from_numpy(ck[key])
    for g in groups:  # JSON turned the groups' tuples (Adam's betas) into lists
        for k, v in g.items():
            if k != "params" and isinstance(v, list):
                g[k] = tuple(v)
    opt_state_like.load_state_dict({"state": state, "param_groups": groups})
    return params_like, opt_state_like, step
