"""Camera model (counterpart of raytracingproject_tpu/camera.py;
reference: src/camera.h).

`Camera.derive` reproduces `camera::initialize` (src/camera.h:52-85) in
float64 numpy, exactly as the JAX package does, then casts the frame.
`generate_rays` draws its uniforms from a `torch.Generator` and hands them
to `rays_from_uniforms`, which tests feed with the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


class CameraDerived(NamedTuple):
    """Derived camera frame (src/camera.h:117-126 privates)."""

    center: torch.Tensor          # [3]
    pixel00_loc: torch.Tensor     # [3]
    pixel_delta_u: torch.Tensor   # [3]
    pixel_delta_v: torch.Tensor   # [3]
    defocus_disk_u: torch.Tensor  # [3]
    defocus_disk_v: torch.Tensor  # [3]
    defocus_angle: torch.Tensor   # [] degrees (<= 0 disables the disk)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Reference camera config surface (src/camera.h:15-26), same defaults."""

    aspect_ratio: float = 1.0
    image_width: int = 100
    samples_per_pixel: int = 10
    max_depth: int = 10

    vfov: float = 90.0
    lookfrom: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    lookat: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    defocus_angle: float = 0.0
    focus_dist: float = 10.0

    @property
    def image_height(self) -> int:
        """height = width / aspect, floored, min 1 (src/camera.h:53-54)."""
        return max(int(self.image_width / self.aspect_ratio), 1)

    def image_size(self) -> Tuple[int, int]:
        """(width, height)."""
        return (self.image_width, self.image_height)

    def derive(self, dtype=torch.float32, device="cpu") -> CameraDerived:
        """`camera::initialize` in float64, cast to `dtype` on `device`."""
        width, height = self.image_width, self.image_height
        lookfrom = np.asarray(self.lookfrom, np.float64)
        lookat = np.asarray(self.lookat, np.float64)
        vup = np.asarray(self.vup, np.float64)

        center = lookfrom
        theta = math.radians(self.vfov)
        h = math.tan(theta / 2.0)
        viewport_height = 2.0 * h * self.focus_dist
        viewport_width = viewport_height * (width / height)

        w = (lookfrom - lookat) / np.linalg.norm(lookfrom - lookat)
        u = np.cross(vup, w)
        u = u / np.linalg.norm(u)
        v = np.cross(w, u)

        viewport_u = viewport_width * u
        viewport_v = viewport_height * -v
        pixel_delta_u = viewport_u / width
        pixel_delta_v = viewport_v / height

        viewport_upper_left = center - self.focus_dist * w - viewport_u / 2 - viewport_v / 2
        pixel00_loc = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

        defocus_radius = self.focus_dist * math.tan(math.radians(self.defocus_angle / 2.0))
        defocus_disk_u = u * defocus_radius
        defocus_disk_v = v * defocus_radius

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64)).to(dtype).to(device)

        return CameraDerived(
            center=t(center), pixel00_loc=t(pixel00_loc),
            pixel_delta_u=t(pixel_delta_u), pixel_delta_v=t(pixel_delta_v),
            defocus_disk_u=t(defocus_disk_u), defocus_disk_v=t(defocus_disk_v),
            defocus_angle=t(self.defocus_angle),
        )


def rays_from_uniforms(
    cam: CameraDerived,
    i: torch.Tensor,           # [R] pixel columns
    j: torch.Tensor,           # [R] pixel rows
    offset: torch.Tensor,      # [R, 2] pixel-square jitter in [-0.5, 0.5)
    disk_u: torch.Tensor,      # [R] U[0,1) for the defocus-disk radius
    disk_theta: torch.Tensor,  # [R] defocus-disk angle in [0, 2*pi)
    time: torch.Tensor,        # [R] ray time in [0, 1)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`camera::get_ray` (src/camera.h:87-113) given its random draws.
    Returns (origin [R,3], direction [R,3], time [R]); directions are not
    normalised (the quadratic uses a = |d|^2)."""
    dt = cam.pixel00_loc.dtype
    pixel_center = (
        cam.pixel00_loc[None, :]
        + i[:, None].to(dt) * cam.pixel_delta_u[None, :]
        + j[:, None].to(dt) * cam.pixel_delta_v[None, :]
    )
    pixel_sample = (
        pixel_center
        + offset[:, 0:1] * cam.pixel_delta_u[None, :]
        + offset[:, 1:2] * cam.pixel_delta_v[None, :]
    )
    # random_in_unit_disk (ops/sampling.py of the JAX package): r = sqrt(U)
    r = torch.sqrt(disk_u)
    dx = (r * torch.cos(disk_theta))[:, None]
    dy = (r * torch.sin(disk_theta))[:, None]
    defocus_origin = (
        cam.center[None, :] + dx * cam.defocus_disk_u[None, :]
        + dy * cam.defocus_disk_v[None, :]
    )
    # a select on the device, not a host read of the angle: the wavefront
    # makes rays every iteration
    origin = torch.where(cam.defocus_angle > 0.0, defocus_origin,
                         cam.center[None, :].expand_as(defocus_origin))
    direction = pixel_sample - origin
    return origin.contiguous(), direction, time


def camera_uniforms(n: int, generator: torch.Generator, device,
                    dtype=torch.float32):
    """The draws `rays_from_uniforms` takes, from `generator`."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device, dtype=dtype)

    offset = rand(n, 2) - 0.5
    disk_u = rand(n)
    disk_theta = rand(n) * (2.0 * math.pi)
    time = rand(n)
    return offset, disk_u, disk_theta, time


def generate_rays(cam: CameraDerived, i: torch.Tensor, j: torch.Tensor,
                  generator: torch.Generator):
    """Batched `camera::get_ray`: jitter, defocus disk and ray time drawn
    from `generator` (which must live on the rays' device)."""
    u = camera_uniforms(i.shape[0], generator, cam.pixel00_loc.device,
                        cam.pixel00_loc.dtype)
    return rays_from_uniforms(cam, i, j, *u)
