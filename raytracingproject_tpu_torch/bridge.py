"""The JAX package's state carried across, as numpy arrays.

Takes the arrays of a JAX `Scene`, `FlatBVH`, `FrontTables`,
`FrontTablesHBM`, `SceneParams`, `PathResiduals` or two-phase recording
(fetched by the caller with `np.asarray`) and builds the port's objects on a given device, so
both packages can compute on the same data: the same scene and culling
tables for the forward, the same parameters and recorded path decisions
for the replay backward. Never imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingproject_tpu_torch.bvh import FlatBVH
from raytracingproject_tpu_torch.grad.inverse import SceneParams
from raytracingproject_tpu_torch.grad.replay import PathResiduals, PathResidualsP
from raytracingproject_tpu_torch.ops.cuda.megakernel import FrontTables, FrontTablesHBM
from raytracingproject_tpu_torch.scene import Scene


def _t(x, dtype, device):
    return torch.from_numpy(np.array(x)).to(dtype).to(device)  # a writable copy


def scene_from_arrays(center0, center_delta, radius, mat_type, albedo, fuzz, ior,
                      device="cpu") -> Scene:
    """Scene from the seven arrays of a JAX Scene (in field order)."""
    f = torch.float32
    return Scene(
        center0=_t(center0, f, device), center_delta=_t(center_delta, f, device),
        radius=_t(radius, f, device), mat_type=_t(mat_type, torch.int32, device),
        albedo=_t(albedo, f, device), fuzz=_t(fuzz, f, device), ior=_t(ior, f, device),
    )


def bvh_from_arrays(node_min, node_max, miss_link, leaf_start, leaf_count,
                    prim_order) -> FlatBVH:
    """FlatBVH (host tensors) from the six arrays of a JAX FlatBVH."""
    f, i = torch.float32, torch.int32
    return FlatBVH(
        node_min=_t(node_min, f, "cpu"), node_max=_t(node_max, f, "cpu"),
        miss_link=_t(miss_link, i, "cpu"), leaf_start=_t(leaf_start, i, "cpu"),
        leaf_count=_t(leaf_count, i, "cpu"), prim_order=_t(prim_order, i, "cpu"),
    )


def front_from_arrays(sph, ff, fi, wf, sf, remap, repack: int, device="cpu", bf=None,
                      ksub: int = 0, word_earlyout: bool = False) -> FrontTables:
    """FrontTables from the arrays of a JAX FrontTables and its `repack`,
    `bf`, `ksub` and `word_earlyout`."""
    f, i = torch.float32, torch.int32
    return FrontTables(
        sph=_t(sph, f, device), ff=_t(ff, f, device), fi=_t(fi, i, device),
        wf=_t(wf, f, device), sf=_t(sf, f, device), remap=_t(remap, i, device),
        repack=int(repack), bf=None if bf is None else _t(bf, f, device), ksub=int(ksub),
        word_earlyout=bool(word_earlyout),
    )


def front_hbm_from_arrays(sph, ff, fi, wf, sf, remap, word_earlyout: bool = False, bf=None,
                          ksub: int = 0, device="cpu") -> FrontTablesHBM:
    """FrontTablesHBM from the arrays of a JAX FrontTablesHBM and its
    `word_earlyout` and `ksub`. The JAX (16, F * 128) sphere table is
    stored transposed, one 16-float row a padded column."""
    f, i = torch.float32, torch.int32
    return FrontTablesHBM(
        sph=_t(np.asarray(sph).T, f, device).contiguous(), ff=_t(ff, f, device),
        fi=_t(fi, i, device), wf=_t(wf, f, device), sf=_t(sf, f, device),
        remap=_t(remap, i, device), word_earlyout=bool(word_earlyout),
        bf=None if bf is None else _t(bf, f, device), ksub=int(ksub),
    )


def params_from_arrays(center0, center_delta, radius, albedo, fuzz, ior, device="cpu",
                       dtype=torch.float32) -> SceneParams:
    """SceneParams from the six arrays of a JAX SceneParams (in field
    order)."""
    return SceneParams(*(_t(x, dtype, device)
                         for x in (center0, center_delta, radius, albedo, fuzz, ior)))


def residuals_from_arrays(idx, ndir, refl, device="cpu") -> PathResiduals:
    """PathResiduals from the three arrays of a JAX PathResiduals: idx
    [D, R] int32, ndir [D, R, 3] float32, refl [D, R] bool."""
    return PathResiduals(idx=_t(idx, torch.int32, device), ndir=_t(ndir, torch.float32, device),
                         refl=_t(refl, torch.bool, device))


def residuals_p_from_arrays(res1, res2, src, dest, n_alive, device="cpu", dtype=torch.float32):
    """(res1, res2, src, dest, n_alive) for `replay_radiance_twophase` from
    a JAX two-phase recording (`pallas_trace_record_twophase`): `res1` and
    `res2` the five arrays of a JAX PathResidualsP each (idx, ndx, ndy,
    ndz, refl), `src` / `dest` its row permutations, `n_alive` its live row
    count. The JAX rows are 128 rays wide; the port's replay reads the
    width from len(src)."""
    def planar(arrays):
        idx, ndx, ndy, ndz, refl = arrays
        return PathResidualsP(idx=_t(idx, torch.int32, device), ndx=_t(ndx, dtype, device),
                              ndy=_t(ndy, dtype, device), ndz=_t(ndz, dtype, device),
                              refl=_t(refl, torch.bool, device))

    i = torch.int32
    return (planar(res1), planar(res2), _t(src, i, device), _t(dest, i, device),
            _t(n_alive, i, device))
