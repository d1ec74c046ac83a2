"""What the sphere recipes share: the small spheres' materials drawn in
bulk, and the scene's arrays with the ground sphere first."""

from __future__ import annotations

import numpy as np

FIELDS = ("center0", "center_delta", "radius", "mat_type", "albedo", "fuzz", "ior")


def small_spheres(center, radius, choose, mix, rng) -> dict[str, np.ndarray]:
    """Materials of spheres at `center`: ranked by `choose`, the first
    mix[0] share diffuse, the next mix[1] metal, the rest glass."""
    n = center.shape[0]
    rank = np.empty(n, np.int64)
    rank[np.argsort(choose, kind="stable")] = np.arange(n)
    n_diffuse = int(round(mix[0] * n))
    n_metal = int(round(mix[1] * n))
    mat = np.where(rank < n_diffuse, 0, np.where(rank < n_diffuse + n_metal, 1, 2))
    diffuse = rng.random((n, 3)) * rng.random((n, 3))
    metal = 0.5 + 0.5 * rng.random((n, 3))
    fuzz = 0.5 * rng.random(n)
    lift = 0.5 * rng.random(n)
    delta = np.zeros((n, 3))
    delta[:, 1] = np.where(mat == 0, lift, 0.0)
    return {
        "center0": center, "center_delta": delta, "radius": radius,
        "mat_type": mat.astype(np.int32),
        "albedo": np.where((mat == 0)[:, None], diffuse,
                           np.where((mat == 1)[:, None], metal, 1.0)),
        "fuzz": np.where(mat == 1, fuzz, 0.0),
        "ior": np.where(mat == 2, 1.5, 1.0),
    }


def assemble(small: dict, big: dict | None) -> dict[str, np.ndarray]:
    """Ground, the small spheres, then `big`'s spheres; float32 arrays."""
    ground = {"center0": np.array([[0.0, -1000.0, 0.0]]), "center_delta": np.zeros((1, 3)),
              "radius": np.array([1000.0]), "mat_type": np.zeros(1, np.int32),
              "albedo": np.full((1, 3), 0.5), "fuzz": np.zeros(1), "ior": np.ones(1)}
    parts = [ground, small] + ([] if big is None else [big])
    out = {}
    for f in FIELDS:
        rows = [p.get(f, np.zeros((len(p["radius"]), 3))) for p in parts]
        out[f] = np.concatenate(rows).astype(np.int32 if f == "mat_type" else np.float32)
    return out
