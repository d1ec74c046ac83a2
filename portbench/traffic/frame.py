"""Frame traffic: a closed loop of `render.render(scene, camera, generator,
settings)` calls, each to a synchronised image, the next started when the
last is done. Each frame has a fresh generator seeded from (seed, frame
index); set-up renders frame 0 to warm every shape, the window frames 1,
2, ...

The check: `check_frames` of the window's frames, drawn from the seed
(reservoir sampling, so it holds only those images), and in each
`check_pixels` pixels drawn from the seed, worked out again by the plain
reference (every sample, depth and draw of those pixels). Compared: the
mean and the largest absolute gap over the sampled pixels' channels.

Parameters: width, spp, depth, check_frames, check_pixels, trace_units,
prep_calls (the traced run's timed prepare_scene calls).
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench.harness import rng, torch_seed, worst
from portbench.reference import camera as ref_camera
from portbench.reference import frame as ref_frame


def camera_of(config: dict, params: dict):
    from raytracingproject_tpu_torch.camera import Camera

    cam = config["camera"]
    return Camera(aspect_ratio=cam["aspect_ratio"], image_width=params["width"],
                  samples_per_pixel=params["spp"], max_depth=params["depth"], vfov=cam["vfov"],
                  lookfrom=tuple(cam["lookfrom"]), lookat=tuple(cam["lookat"]),
                  vup=tuple(cam["vup"]), defocus_angle=cam["defocus_angle"],
                  focus_dist=cam["focus_dist"])


def scene_of(arrays: dict, device):
    from raytracingproject_tpu_torch.scene import Scene

    return Scene(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class FrameJob:
    """A frame cell's set-up, its window's units (frames) and its check."""

    def __init__(self, bench, cell, seed: int, device):
        from raytracingproject_tpu_torch.config import RenderSettings
        from raytracingproject_tpu_torch.render import render

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.params = cell.params
        self.arrays = bench.scene_arrays(cell.config, seed)
        self.scene = scene_of(self.arrays, self.device)
        self.camera = camera_of(cell.config, self.params)
        self.settings = RenderSettings(device=self.device)
        self.render = render
        self.kept: list = []
        self.pick = random.Random(torch_seed(seed, 2))
        self.count = 0
        self._frame(0)  # warm-up: every shape of the window

    def generator(self, i: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(torch_seed(self.seed, 1, i))

    def _frame(self, i: int) -> torch.Tensor:
        img = self.render(self.scene, self.camera, self.generator(i), self.settings)
        sync(self.device)
        return img

    def unit(self) -> None:
        self.count += 1
        img = self._frame(self.count)
        k = int(self.params["check_frames"])
        if len(self.kept) < k:
            self.kept.append((self.count, img))
        else:
            j = self.pick.randrange(self.count)
            if j < k:
                self.kept[j] = (self.count, img)

    def spans(self) -> dict:
        """Host seconds of `prepare_scene` calls on this cell's scene,
        camera and settings, each synchronised."""
        from raytracingproject_tpu_torch.render import prepare_scene

        out = []
        for _ in range(int(self.params["prep_calls"])):
            t = time.perf_counter()
            prepare_scene(self.scene, self.camera, self.settings)
            sync(self.device)
            out.append(time.perf_counter() - t)
        return {"prepare_scene": out}

    def release(self) -> None:
        self.scene = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def size(self) -> tuple[int, int]:
        w = int(self.params["width"])
        return w, ref_camera.image_height(w, self.cell.config["camera"]["aspect_ratio"])

    def sample(self, i: int) -> np.ndarray:
        """The pixels of frame `i` the check compares, drawn from the seed."""
        w, h = self.size()
        return rng(self.seed, 3, i).choice(w * h, min(int(self.params["check_pixels"]), w * h),
                                           replace=False)

    def reference(self, i: int, pix: np.ndarray, dtype=torch.float32) -> torch.Tensor:
        """The plain reference's mean radiance [P, 3] at pixels `pix` of
        frame `i`, its bounce loop in `dtype`."""
        w, h = self.size()
        return ref_frame.pixels(self.arrays, self.cell.config["camera"], w, h, self.params["spp"],
                                self.params["depth"], self.generator(i), pix, dtype)

    def check(self) -> dict:
        means, gaps = [], []
        for i, img in self.kept:
            pix = self.sample(i)
            got = img.reshape(-1, 3)[torch.as_tensor(pix, device=img.device)]
            mean, gap = pixel_gaps(got, self.reference(i, pix))
            means.append(mean)
            gaps.append(gap)
        lim = self.cell.limits
        return {"pixel_mean_gap": (worst(means), lim["pixel_mean_gap"]),
                "pixel_max_gap": (worst(gaps), lim["pixel_max_gap"])}


def pixel_gaps(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(mean, largest) absolute gap over the pixels' channels."""
    diff = (got.float() - ref.float()).abs()
    return float(diff.mean()), float(diff.max())


def prepare(bench, cell, seed: int, device) -> FrameJob:
    return FrameJob(bench, cell, seed, device)
