"""Scene representation: struct-of-arrays spheres + materials
(counterpart of raytracingproject_tpu/scene.py).

The scene makers draw from the same numpy generators as the JAX package,
so `make_cover_scene(seed)` and the rest give the same arrays in both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracingproject_tpu_torch.config import DIELECTRIC, LAMBERTIAN, METAL

_FIELDS = ("center0", "center_delta", "radius", "mat_type", "albedo", "fuzz", "ior")


@dataclasses.dataclass(frozen=True)
class Scene:
    """SoA sphere scene: N spheres, every tensor shares the leading axis.

    A moving sphere lerps center0 -> center0 + center_delta by ray time
    (src/sphere.h:19-28); `mat_type` selects the scatter rule
    (0 lambertian, 1 metal, 2 dielectric)."""

    center0: torch.Tensor       # [N, 3]
    center_delta: torch.Tensor  # [N, 3]
    radius: torch.Tensor        # [N]
    mat_type: torch.Tensor      # [N] int32
    albedo: torch.Tensor        # [N, 3]
    fuzz: torch.Tensor          # [N]
    ior: torch.Tensor           # [N]

    @property
    def num_spheres(self) -> int:
        return int(self.center0.shape[0])

    @property
    def device(self) -> torch.device:
        return self.center0.device

    def to(self, device) -> "Scene":
        return Scene(**{f: getattr(self, f).to(device) for f in _FIELDS})

    def take(self, index: torch.Tensor) -> "Scene":
        """Spheres reordered (or selected) by `index`."""
        index = index.to(self.device, torch.long)
        return Scene(**{f: getattr(self, f).index_select(0, index) for f in _FIELDS})

    def pad_to(self, n: int) -> "Scene":
        """Pad to a fixed capacity with inert spheres (radius 0, parked at
        y = 1e9), as the JAX Scene.pad_to."""
        cur = self.num_spheres
        if cur > n:
            raise ValueError(f"scene has {cur} spheres > capacity {n}")
        if cur == n:
            return self
        pad = n - cur
        dev, dt = self.device, self.radius.dtype
        far = torch.zeros((pad, 3), dtype=self.center0.dtype, device=dev)
        far[:, 1] = 1e9
        cat = torch.cat
        return Scene(
            center0=cat([self.center0, far]),
            center_delta=cat([self.center_delta, torch.zeros((pad, 3), dtype=dt, device=dev)]),
            radius=cat([self.radius, torch.zeros(pad, dtype=dt, device=dev)]),
            mat_type=cat([self.mat_type, torch.zeros(pad, dtype=torch.int32, device=dev)]),
            albedo=cat([self.albedo, torch.zeros((pad, 3), dtype=dt, device=dev)]),
            fuzz=cat([self.fuzz, torch.zeros(pad, dtype=dt, device=dev)]),
            ior=cat([self.ior, torch.ones(pad, dtype=dt, device=dev)]),
        )


class SceneBuilder:
    """Imperative scene construction (src/hittable_list.h:17-23 plus the
    material constructors)."""

    def __init__(self) -> None:
        self._rows: list[tuple] = []

    def _add(self, center0, center_delta, radius, mat, albedo, fuzz, ior) -> None:
        self._rows.append((
            np.asarray(center0, np.float64), np.asarray(center_delta, np.float64),
            float(radius), int(mat), np.asarray(albedo, np.float64),
            float(fuzz), float(ior),
        ))

    @staticmethod
    def _delta(center, center2):
        if center2 is None:
            return np.zeros(3)
        return np.asarray(center2, np.float64) - np.asarray(center, np.float64)

    def add_lambertian(self, center, radius, albedo, center2=None) -> "SceneBuilder":
        """Diffuse sphere; `center2` makes it a moving sphere."""
        self._add(center, self._delta(center, center2), radius, LAMBERTIAN, albedo, 0.0, 1.0)
        return self

    def add_metal(self, center, radius, albedo, fuzz=0.0, center2=None) -> "SceneBuilder":
        """Metal sphere; fuzz clamped to <= 1 (src/material.h:34)."""
        self._add(center, self._delta(center, center2), radius, METAL, albedo,
                  min(float(fuzz), 1.0), 1.0)
        return self

    def add_dielectric(self, center, radius, ior=1.5, center2=None) -> "SceneBuilder":
        """Glass sphere; attenuation is fixed (1, 1, 1)."""
        self._add(center, self._delta(center, center2), radius, DIELECTRIC, np.ones(3),
                  0.0, float(ior))
        return self

    def build(self, dtype=torch.float32, device="cpu") -> Scene:
        if not self._rows:
            raise ValueError("empty scene")
        c0, cd, r, m, al, fz, ir = zip(*self._rows)

        def f(x):
            return torch.as_tensor(np.asarray(x, np.float64)).to(dtype).to(device)

        return Scene(
            center0=f(np.stack(c0)), center_delta=f(np.stack(cd)), radius=f(r),
            mat_type=torch.as_tensor(np.array(m, np.int32)).to(device),
            albedo=f(np.stack(al)), fuzz=f(fz), ior=f(ir),
        )


def make_cover_scene(seed: int = 0, dtype=torch.float32, device="cpu") -> Scene:
    """The RTWeekend final cover scene (src/main.cpp:12-53), drawn from
    `np.random.default_rng(seed)` exactly as the JAX package draws it."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for a in range(-11, 11):
        for c in range(-11, 11):
            choose_mat = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rng.random(3) * rng.random(3)
                center2 = center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0])
                b.add_lambertian(center, 0.2, albedo, center2=center2)
            elif choose_mat < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                fuzz = rng.uniform(0.0, 0.5)
                b.add_metal(center, 0.2, albedo, fuzz)
            else:
                b.add_dielectric(center, 0.2, 1.5)
    b.add_dielectric((0.0, 1.0, 0.0), 1.0, 1.5)
    b.add_lambertian((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1))
    b.add_metal((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0)
    return b.build(dtype, device)


def make_cover_scene_reference(dtype=torch.float32, arg_order: str = "rl",
                               device="cpu") -> Scene:
    """The cover scene with the exact sphere layout of the reference's
    golden render: its default-seeded std::mt19937 stream replayed bit for
    bit (utils/mt19937.py). `arg_order` is the C++ argument evaluation
    order ("rl" = right-to-left, MSVC's; "lr" = left-to-right)."""
    from raytracingproject_tpu_torch.utils.mt19937 import MT19937

    gen = MT19937()
    rl = arg_order == "rl"

    def rd():
        return gen.canonical()

    def vec_random(lo=0.0, hi=1.0):
        a, b_, c = (gen.uniform(lo, hi) for _ in range(3))
        return np.array([c, b_, a]) if rl else np.array([a, b_, c])

    b = SceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for a in range(-11, 11):
        for c in range(-11, 11):
            choose_mat = rd()
            jx, jz = rd(), rd()
            if rl:
                jx, jz = jz, jx
            center = np.array([a + 0.9 * jx, 0.2, c + 0.9 * jz])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                v1 = vec_random()
                v2 = vec_random()
                albedo = (v2 * v1) if rl else (v1 * v2)
                center2 = center + np.array([0.0, gen.uniform(0.0, 0.5), 0.0])
                b.add_lambertian(center, 0.2, albedo, center2=center2)
            elif choose_mat < 0.95:
                albedo = vec_random(0.5, 1.0)
                fuzz = gen.uniform(0.0, 0.5)
                b.add_metal(center, 0.2, albedo, fuzz)
            else:
                b.add_dielectric(center, 0.2, 1.5)
    b.add_dielectric((0.0, 1.0, 0.0), 1.0, 1.5)
    b.add_lambertian((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1))
    b.add_metal((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0)
    return b.build(dtype, device)


def make_three_sphere_scene(dtype=torch.float32, device="cpu") -> Scene:
    """Lambertian + metal + dielectric trio with a ground sphere."""
    b = SceneBuilder()
    b.add_lambertian((0.0, -100.5, -1.0), 100.0, (0.8, 0.8, 0.0))
    b.add_lambertian((0.0, 0.0, -1.0), 0.5, (0.1, 0.2, 0.5))
    b.add_dielectric((-1.0, 0.0, -1.0), 0.5, 1.5)
    b.add_metal((1.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), 0.0)
    return b.build(dtype, device)


def make_ground_scene(dtype=torch.float32, device="cpu") -> Scene:
    """The reference unit test's world: only the r=1000 ground sphere
    (tests/tests.cpp:26-29)."""
    b = SceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    return b.build(dtype, device)


def make_minimal_scene(dtype=torch.float32, device="cpu") -> Scene:
    """One lambertian sphere + ground."""
    b = SceneBuilder()
    b.add_lambertian((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5))
    b.add_lambertian((0.0, 0.0, -1.0), 0.5, (0.7, 0.3, 0.3))
    return b.build(dtype, device)


def make_random_scene(n: int, seed: int = 0, extent: float = 22.0,
                      dtype=torch.float32, device="cpu") -> Scene:
    """`n` random small spheres + ground: the cover recipe scaled to any
    sphere count."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    half = extent / 2.0
    for _ in range(n - 1):
        choose_mat = rng.random()
        center = np.array([
            rng.uniform(-half, half), rng.uniform(0.15, 0.45), rng.uniform(-half, half)
        ])
        radius = rng.uniform(0.1, 0.3)
        if choose_mat < 0.8:
            albedo = rng.random(3) * rng.random(3)
            center2 = center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0])
            b.add_lambertian(center, radius, albedo, center2=center2)
        elif choose_mat < 0.95:
            b.add_metal(center, radius, rng.uniform(0.5, 1.0, 3), rng.uniform(0.0, 0.5))
        else:
            b.add_dielectric(center, radius, 1.5)
    return b.build(dtype, device)
