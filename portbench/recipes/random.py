"""The cover recipe scaled to any sphere count: `spheres - 1` spheres of
radius U(0.1, 0.3) at centres U(-extent/2, extent/2) x U(0.15, 0.45) x
U(-extent/2, extent/2) over the 1,000-unit ground sphere, with the cover's
materials and exact mix (cover.py)."""

from __future__ import annotations

import numpy as np

from portbench.recipes.spheres import assemble, small_spheres


def make(config: dict, rng: np.random.Generator) -> dict[str, np.ndarray]:
    n = int(config["spheres"]) - 1
    half = float(config["extent"]) / 2.0
    lo = np.array([-half, 0.15, -half])
    hi = np.array([half, 0.45, half])
    center = lo + (hi - lo) * rng.random((n, 3))
    radius = 0.1 + 0.2 * rng.random(n)
    return assemble(small_spheres(center, radius, rng.random(n), config["mix"], rng), None)
