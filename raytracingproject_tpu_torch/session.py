"""Renderer session: the environment API of the reference on PyTorch
(counterpart of raytracingproject_tpu/session.py).

`RayTracingProject::GraphicalEnvironment` (src/graphical_environment.h:17-32)
exposes init / load_preconfigured_shapes / add_spheres / add_texture /
start_interactive_loop. The Vulkan device, swapchain and pipeline
bring-up becomes device discovery; presenting a frame becomes producing
an image (`last_frame`). Frames in flight (max_frames_in_flight = 2,
src/common_objects.h:10) are renders whose CUDA event has not been waited
for: once more than `max_frames_in_flight` are queued, the oldest is
synchronised and copied to the host.

The session renders with its RenderSettings, by default the port's
(`render` on the megakernel with the front-culled closest hit, K3), on
the card unless `settings.device` asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import platform
import time as _time
from collections import deque
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch

from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.render import render
from raytracingproject_tpu_torch.scene import Scene, SceneBuilder

log = logging.getLogger("raytracingproject_tpu_torch")


class SessionError(RuntimeError):
    """Raised on misuse: the analog of LOG_AND_THROW
    (src/graphical_environment.h:10-11)."""


def _log_and_throw(msg: str) -> None:
    log.error(msg)
    raise SessionError(msg)


class Sphere(NamedTuple):
    """The sphere record of the reference (src/common_objects.h:17-22:
    {vec3 center; float radius; vec4 color}). Spheres added through the
    session become Lambertians with albedo color.rgb."""

    center: tuple
    radius: float
    color: tuple = (1.0, 1.0, 1.0, 1.0)


# Capacity of the session's sphere buffer, the reference's
# DataBuffer<Sphere, 200> (src/vulkan/graphical_environment_vulkan.h:141).
SPHERE_CAPACITY = 200


def orbit_camera(camera: Camera, angle_deg: float) -> Camera:
    """`camera` rotated `angle_deg` around `lookat` about the `vup` axis
    (Rodrigues, in float64 on the host).

    The analog of the reference's animated model matrix
    (glm::rotate(mat4(1), time * radians(90), vec3(0,0,1)),
    src/vulkan/graphical_environment_vulkan.cpp:374-391): rotating the scene
    under a fixed camera equals orbiting the camera around the scene, and
    the scene's arrays stay as they are."""
    lookfrom = np.asarray(camera.lookfrom, np.float64)
    lookat = np.asarray(camera.lookat, np.float64)
    axis = np.asarray(camera.vup, np.float64)
    axis = axis / np.linalg.norm(axis)
    rel = lookfrom - lookat
    th = np.radians(angle_deg)
    rot = (rel * np.cos(th) + np.cross(axis, rel) * np.sin(th)
           + axis * np.dot(axis, rel) * (1.0 - np.cos(th)))
    return dataclasses.replace(camera, lookfrom=tuple(float(x) for x in lookat + rot))


class RendererSession:
    """Stateful renderer session with the interface of the reference's
    environment (src/graphical_environment.h:17-32).

    Unlike the reference (where `append` after init never re-uploads and
    the sphere buffer is never bound, src/vulkan/data_buffer.h:47-52,
    descriptors_manager.h:26-36), spheres added at any time are rendered:
    each frame's scene is padded to SPHERE_CAPACITY."""

    def __init__(
        self,
        settings: RenderSettings | None = None,
        camera: Camera | None = None,
        animate_deg_per_s: float = 0.0,
    ) -> None:
        """`animate_deg_per_s` is the analog of the reference's
        time-rotating model matrix (update_uniform_buffer,
        src/vulkan/graphical_environment_vulkan.cpp:374-391, which spins
        the scene at 90 deg/s of wall-clock time): the camera orbits
        `lookat` about `vup` at that rate (`orbit_camera`). 90.0 matches
        the reference."""
        self.settings = settings or RenderSettings()
        self.animate_deg_per_s = animate_deg_per_s
        self._anim_start: float | None = None
        self.camera = camera or Camera(
            aspect_ratio=self.settings.width / self.settings.height,
            image_width=self.settings.width,
            samples_per_pixel=4,
            max_depth=8,
            vfov=60.0,
            lookfrom=(0.0, 0.0, 4.0),
            lookat=(0.0, 0.0, 0.0),
        )
        self._builder = SceneBuilder()
        self._spheres_added = 0
        self._texture: np.ndarray | None = None
        self._device: torch.device | None = None
        self._validate = False
        self._frame_index = 0
        self._inflight: deque = deque()
        self._last_frame: np.ndarray | None = None

    # -- lifecycle ---------------------------------------------------------

    def enable_validation(self) -> None:
        """The analog of the reference's validation layers
        (graphical_environment_vulkan.cpp:17, validation.h:29-49). PyTorch
        has no global NaN switch like the JAX package's jax_debug_nans, so
        this catches a frame, not an op: from now on each finished frame
        is checked with torch.isfinite, and a non-finite one raises
        FloatingPointError, the exception jax_debug_nans raises."""
        self._validate = True
        log.info("validation enabled: every finished frame is checked for NaN and inf")

    def resize(self, width: int, height: int) -> None:
        """The analog of swapchain recreation (VK_ERROR_OUT_OF_DATE_KHR,
        graphical_environment_vulkan.cpp:404-414): the camera takes the new
        extent and frames in flight at the old one are dropped."""
        if width <= 0 or height <= 0:
            _log_and_throw(f"invalid extent {width}x{height}")
        self.settings = dataclasses.replace(self.settings, width=width, height=height)
        self.camera = dataclasses.replace(self.camera, aspect_ratio=width / height,
                                          image_width=width)
        self._inflight.clear()
        log.info("resized to %dx%d", width, height)

    def init(self) -> None:
        """Device discovery, in place of the instance, surface, device,
        swapchain and pipeline bring-up
        (src/vulkan/graphical_environment_vulkan.cpp:21-106): the render
        device of the settings (the card unless they ask for the CPU).
        Without it, SessionError; nothing falls back to the CPU."""
        from raytracingproject_tpu_torch.utils.cache import enable_compilation_cache

        try:
            self._device = self.settings.resolved_device()
        except RuntimeError as err:
            _log_and_throw(f"no render device: {err}")
        log.info("RendererSession.init: %s; kernels build into %s", self._device,
                 enable_compilation_cache())

    def load_preconfigured_shapes(self) -> None:
        """The reference loads three shader sets here
        (src/vulkan/graphical_environment_vulkan.h:73-80); the kernels build
        at first use, so this adds the two demo spheres of the Vulkan test
        (tests/vulkan_tests.cpp:16-21)."""
        self.add_spheres([
            Sphere(center=(0.0, 0.0, -2.0), radius=1.0, color=(0.9, 0.2, 0.2, 1.0)),
            Sphere(center=(1.5, 0.5, -2.5), radius=0.5, color=(0.2, 0.9, 0.2, 1.0)),
        ])

    def add_spheres(self, spheres: Sequence[Sphere]) -> None:
        """Append spheres (src/graphical_environment.h:27,
        graphical_environment_vulkan.cpp:416-421), at most SPHERE_CAPACITY
        in all; past it SessionError, not a silent drop."""
        if self._spheres_added + len(spheres) > SPHERE_CAPACITY:
            _log_and_throw(f"sphere buffer overflow: {self._spheres_added}+{len(spheres)} > "
                           f"{SPHERE_CAPACITY}")
        for s in spheres:
            self._builder.add_lambertian(s.center, s.radius, tuple(s.color[:3]))
        self._spheres_added += len(spheres)

    def add_texture(self, path: str) -> None:
        """Load an image (src/graphical_environment.h:29, the stb-based
        Texture of src/vulkan/texture.cpp:9-43): PPM natively, other
        formats through PIL where it is installed.

        The texture becomes the environment map: later frames look it up
        (equirectangular, bilinear) for the sky radiance of a miss. Its u8
        values are decoded to linear radiance by inverting the sqrt gamma
        of src/color.h:9-12."""
        p = Path(path)
        if not p.exists():
            _log_and_throw(f"texture not found: {path}")
        if p.suffix.lower() == ".ppm":
            from raytracingproject_tpu_torch.utils.ppm import read_ppm

            self._texture = read_ppm(p)
            return
        try:
            from PIL import Image
        except ImportError:
            log.warning("PIL unavailable; texture %s recorded but not decoded", path)
            self._texture = None
            return
        self._texture = np.asarray(Image.open(p).convert("RGB"))

    # -- frame loop --------------------------------------------------------

    def scene(self) -> Scene:
        if self._spheres_added == 0:
            _log_and_throw("no spheres added")
        return self._builder.build(self.settings.dtype).pad_to(SPHERE_CAPACITY)

    def draw_frame(self) -> None:
        """Render one frame. Mirrors the reference's two-phase draw_frame
        (graphical_environment_vulkan.cpp:222-225): the frame is queued
        with a CUDA event recorded after its render, and once more than
        `max_frames_in_flight` are queued the oldest is waited for (the
        fence wait, .cpp:232/308) and copied to the host. Frame i draws
        from a generator seeded with i."""
        if self._device is None:
            _log_and_throw("init() not called")
        gen = torch.Generator(device=self._device).manual_seed(self._frame_index)
        sky = None
        if self._texture is not None:
            sky = (torch.as_tensor(self._texture, dtype=torch.float32, device=self._device)
                   / 255.0) ** 2
        cam = self.camera
        if self.animate_deg_per_s:
            now = _time.monotonic()
            if self._anim_start is None:
                self._anim_start = now
            cam = orbit_camera(cam, (now - self._anim_start) * self.animate_deg_per_s)
        img = render(self.scene(), cam, gen, self.settings, sky_texture=sky)
        done = None
        if img.is_cuda:
            done = torch.cuda.Event()
            done.record()
        self._inflight.append((img, done))
        self._frame_index += 1
        while len(self._inflight) > self.settings.max_frames_in_flight:
            self._finish(*self._inflight.popleft())

    def _finish(self, img: torch.Tensor, done) -> None:
        """Wait for a queued frame, check it under validation, keep it."""
        if done is not None:
            done.synchronize()
        if self._validate and not bool(torch.isfinite(img).all()):
            raise FloatingPointError(f"non-finite values in frame {tuple(img.shape)} "
                                     "(enable_validation)")
        self._last_frame = img.cpu().numpy()

    def start_interactive_loop(self, duration_ms: int = 3000, max_frames: int | None = None) -> int:
        """Render frames for `duration_ms` (src/graphical_environment.h:31,
        graphical_environment_vulkan.cpp:208-220), or until `max_frames`.
        Returns the frames rendered."""
        start = _time.monotonic()
        frames = 0
        while (_time.monotonic() - start) * 1000.0 < duration_ms:
            self.draw_frame()
            frames += 1
            if max_frames is not None and frames >= max_frames:
                break
        self.flush()
        return frames

    def flush(self) -> np.ndarray | None:
        """Drain the frames in flight (the vkDeviceWaitIdle analog,
        graphical_environment_vulkan.h:88); returns the last frame."""
        while self._inflight:
            self._finish(*self._inflight.popleft())
        return self._last_frame

    @property
    def last_frame(self) -> np.ndarray | None:
        return self._last_frame

    def dump_device_info(self) -> str:
        """Device capabilities (graphical_environment_vulkan.cpp:192-206
        prints the memory heaps): each card's name, multiprocessors and
        free and total memory, or one line naming the CPU. Call after
        init()."""
        if self._device is None or self._device.type != "cuda":
            lines = [f"cpu:0 {platform.machine()} {platform.processor() or '?'} "
                     f"threads={torch.get_num_threads()}"]
        else:
            lines = []
            for i in range(torch.cuda.device_count()):
                props = torch.cuda.get_device_properties(i)
                free, total = torch.cuda.mem_get_info(i)
                lines.append(f"cuda:{i} {props.name} sms={props.multi_processor_count} "
                             f"bytes_free={free} bytes_total={total}")
        info = "\n".join(lines)
        log.info("device info:\n%s", info)
        return info
