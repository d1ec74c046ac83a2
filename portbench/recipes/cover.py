"""The "Ray Tracing in One Weekend" final cover scene (v4, section 14;
upstream src/main.cpp:12-53), drawn from a seed.

A 1,000-unit ground sphere; on the 22 x 22 grid one 0.2-unit sphere a
cell, jittered in the cell, unless it lies within 0.9 of (4, 0.2, 0);
the book's 0.8 / 0.15 / 0.05 diffuse / metal / glass mix; diffuse spheres
move up by U(0, 0.5) over the shutter, their albedo the product of two
uniform colours; metal albedo U(0.5, 1), fuzz U(0, 0.5); glass ior 1.5;
and the three large spheres. The book draws each sphere's material on its
own; here the mix is exact: the spheres are ranked by their material draw
and the lowest 80% are diffuse, the next 15% metal, the rest glass, so
every seed has the same number of each and does the same work.
"""

from __future__ import annotations

import numpy as np

from portbench.recipes.spheres import assemble, small_spheres


def make(config: dict, rng: np.random.Generator) -> dict[str, np.ndarray]:
    n = int(config["grid"])
    a, c = np.meshgrid(np.arange(-n // 2, n // 2), np.arange(-n // 2, n // 2), indexing="ij")
    draws = rng.random((n * n, 3))
    center = np.stack([a.reshape(-1) + 0.9 * draws[:, 1], np.full(n * n, 0.2),
                       c.reshape(-1) + 0.9 * draws[:, 2]], axis=1)
    keep = np.linalg.norm(center - np.array([4.0, 0.2, 0.0]), axis=1) > 0.9
    small = small_spheres(center[keep], np.full(int(keep.sum()), 0.2), draws[keep, 0],
                          config["mix"], rng)
    big = {
        "center0": np.array([[0.0, 1.0, 0.0], [-4.0, 1.0, 0.0], [4.0, 1.0, 0.0]]),
        "radius": np.array([1.0, 1.0, 1.0]),
        "mat_type": np.array([2, 0, 1], np.int32),
        "albedo": np.array([[1.0, 1.0, 1.0], [0.4, 0.2, 0.1], [0.7, 0.6, 0.5]]),
        "fuzz": np.zeros(3),
        "ior": np.array([1.5, 1.0, 1.0]),
    }
    return assemble(small, big)
