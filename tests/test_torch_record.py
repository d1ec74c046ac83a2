"""The recording megakernel's plain version (K5's twin, `trace_record` on
CPU tensors) against the JAX package's `pallas_trace_record` in interpret
mode, and the materials refresh of a front (`front_with_params`).

As in test_torch_megakernel.py, the TPU interpreter's PRNG returns zeros,
so the port runs with `zero_draws`; both packages get the same rays and
scene arrays. The CUDA kernel is held against this twin on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.ops.pallas.megakernel import pallas_trace_record

from raytracingproject_tpu_torch.grad.replay import DEAD, MISS
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
from test_torch_megakernel import (
    COVER_CAM, THREE_CAM, _port_front, _port_scene, _rays, _scene_and_front,
)


@functools.lru_cache(maxsize=None)
def _record_both(name, path, depth, n=1024, seed=5):
    """((JAX radiance, residuals), (port radiance, residuals), (rays, port
    scene, port front)) of the same rays; cached, so callers must not
    modify what it returns."""
    js, jf = _scene_and_front(name)
    o, d, t = _rays(THREE_CAM if name == "three" else COVER_CAM, n, seed=seed)
    jfront = jf if path == "front" else None
    jrad, jres = pallas_trace_record(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), js,
                                     jnp.int32(7), max_depth=depth, interpret=True,
                                     front=jfront)
    ps = _port_scene(js)
    pf = _port_front(jf) if path == "front" else None
    rays = tuple(torch.from_numpy(x) for x in (o, d, t))
    prad, pres = mk.trace_record(*rays, ps, 7, depth, front=pf, zero_draws=True)
    return (np.asarray(jrad), jres), (prad, pres), (rays, ps, pf)


# (scene, closest hit, depth, least share of rays with radiance within 5e-5,
#  least share of equal idx, least share of ndir within 1e-4 where idx is
#  equal, largest ndir difference where idx is equal); measured values in
#  the test's docstring
RECORD_CASES = [
    ("three", "brute", 3, 1.0, 0.999, 0.999, 2.5e-4),
    ("cover", "front", 1, 1.0, 0.999, 0.8, 1e-2),
    ("random2w", "front", 3, 0.98, 0.997, 0.95, 0.12),
]

# (scene, closest hit, depth, least share of idx equal to the float64
#  run's, largest ndir difference from it where idx is equal, the same on
#  the first bounce); measured values in the test's docstring
FLOAT64_CASES = [
    ("three", "brute", 3, 1.0, 2.5e-4, 2e-5),
    ("cover", "front", 1, 1.0, 1.5e-2, 1.5e-2),
    ("random2w", "front", 3, 0.998, 0.17, 5e-3),
]


@pytest.mark.parametrize("name,path,depth,rad_frac,idx_frac,nd_frac,nd_max", RECORD_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in RECORD_CASES])
def test_record_twin_matches_pallas_record(name, path, depth, rad_frac, idx_frac, nd_frac,
                                           nd_max):
    """Radiance within 5e-5, decoded idx equal, ndir within 1e-4 and refl
    equal where idx is equal, on the shares RECORD_CASES sets.

    The three-sphere scene meets the bounds asked for (all rays within
    5e-5, idx equal everywhere; ndir within 1e-4 on 99.97% of entries,
    the rest within 1.3e-4, behind the glass sphere). The cover and random
    scenes are seen from 13 units away, where the reference quadratic
    loses ~12 bits to cancellation on their 0.1-0.3 radius spheres and
    the two packages round it apart (XLA contracts FMAs; PyTorch and the
    -fmad=false kernel do not; ROADMAP Queue 3). Both packages' directions
    are then off float64 (test_record_twin_ndir_near_float64), so on the
    cover scene ndir agrees within 1e-4 on 83% of entries and within
    7.5e-3 on all of them; its radiance at depth 1 does not see ndir and
    matches. On the random scene at depth 3 this moves some later bounces:
    98.6% of rays within 5e-5, idx equal on 99.77%, ndir within 1e-4 on
    96% and within 7.9e-2 on all. refl is equal wherever idx is, in every
    case."""
    (jrad, jres), (prad, pres), _ = _record_both(name, path, depth)
    assert pres.idx.shape == (depth, 1024) and pres.idx.dtype == torch.int32
    assert pres.ndir.shape == (depth, 1024, 3) and pres.refl.dtype == torch.bool
    rad_ok = (np.abs(prad.numpy() - jrad).max(axis=1) <= 5e-5).mean()
    eq = pres.idx.numpy() == np.asarray(jres.idx)
    nd_err = np.abs(pres.ndir.numpy() - np.asarray(jres.ndir)).max(axis=2)[eq]
    refl_eq = (pres.refl.numpy() == np.asarray(jres.refl))[eq].mean()
    print(f"{name}/{path} depth {depth}: radiance within 5e-5 {rad_ok:.6f}, idx equal "
          f"{eq.mean():.6f}, ndir within 1e-4 {(nd_err <= 1e-4).mean():.6f} (max diff "
          f"{nd_err.max():.3e}), refl equal {refl_eq:.6f}")
    assert rad_ok >= rad_frac
    assert eq.mean() >= idx_frac
    assert (nd_err <= 1e-4).mean() >= nd_frac
    assert nd_err.max() <= nd_max
    assert refl_eq == 1.0


@pytest.mark.parametrize("name,path,depth,idx_frac,nd_max,nd0_max", FLOAT64_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in FLOAT64_CASES])
def test_record_twin_ndir_near_float64(name, path, depth, idx_frac, nd_max, nd0_max):
    """Both packages' float32 records against the port's plain loop run
    in float64 on the same rays (brute closest hit on the same leaf-ordered
    scene; a front changes no winner), where idx equals the float64 run's.
    The port's ndir stays within the stated bound of float64, and within
    3x of the JAX package's own distance from it: the float32 differences
    of test_record_twin_matches_pallas_record are rounding of the
    reference quadratic in both packages, not a fault of either.

    Measured largest differences from float64, port / JAX: three-sphere
    1.17e-4 / 1.15e-4 (first bounce 9.4e-6 / 8.3e-6); cover 9.2e-3 /
    3.9e-3 (XLA's FMAs round the discriminant once); random depth 3
    0.114 / 0.106 (first bounce 3.4e-3 / 3.2e-3, later bounces start from
    the drifted hit points). idx equals float64's on 100%, 100% and 99.87%
    of entries (JAX: 99.80% on the random scene)."""
    (jrad, jres), (prad, pres), (rays, ps, _) = _record_both(name, path, depth)
    o, d, t = (x.double() for x in rays)
    tab = mk.scene_table(ps, torch.float64)
    _, planes = mk.bounce_loop_twin(o, d, t, tab,
                                    lambda *r: mk.closest_hit_brute_twin(tab, *r), 7, depth,
                                    zero_draws=True, record=True)
    ref = mk.decode_residuals(planes, o.shape[0], None)
    ref_idx, ref_nd = ref.idx.numpy(), ref.ndir.numpy()

    def off(idx, nd):
        eq = idx == ref_idx
        err = np.where(eq, np.abs(nd - ref_nd).max(axis=2), 0.0)
        return eq.mean(), err.max(), err[0].max()

    p_eq, p_max, p0_max = off(pres.idx.numpy(), pres.ndir.numpy())
    j_eq, j_max, j0_max = off(np.asarray(jres.idx), np.asarray(jres.ndir))
    print(f"{name}/{path} depth {depth} against float64: idx equal port {p_eq:.6f} JAX "
          f"{j_eq:.6f}; max |ndir diff| port {p_max:.3e} JAX {j_max:.3e}; first bounce port "
          f"{p0_max:.3e} JAX {j0_max:.3e}")
    assert p_eq >= idx_frac
    assert p_max <= nd_max and p0_max <= nd0_max
    assert p_max <= 3.0 * j_max


@pytest.mark.parametrize("path", ["brute", "front"])
def test_record_twin_radiance_equals_trace_paths_twin(path):
    """Recording changes no value: the record twin's radiance equals the
    plain forward's bit for bit (Philox draws), and the residual codes are
    well formed (DEAD rows form a suffix; directions are zero off hits)."""
    js, jf = _scene_and_front("cover")
    o, d, t = (torch.from_numpy(x) for x in _rays(COVER_CAM, 1024, seed=8))
    ps, pf = _port_scene(js), (_port_front(jf) if path == "front" else None)
    rad, res = mk.trace_record(o, d, t, ps, 31337, 6, front=pf)
    assert torch.equal(rad, mk.trace_paths(o, d, t, ps, 31337, 6, front=pf))
    idx = res.idx
    assert int(idx.min()) >= DEAD and int(idx.max()) < ps.num_spheres
    dead = idx == DEAD
    assert torch.equal(dead[1:] | ~dead[:-1], torch.ones_like(dead[1:]))  # DEAD is permanent
    after_miss = (idx[:-1] == MISS) & ~dead[1:]
    assert not bool(after_miss.any())
    assert bool((res.ndir[idx < 0] == 0).all()) and not bool(res.refl[idx < 0].any())


def test_front_with_params_is_bit_equal_at_build_params():
    js, jf = _scene_and_front("cover")
    ps, pf = _port_scene(js), _port_front(jf)
    assert torch.equal(mk.front_with_params(pf, ps).sph, pf.sph)


def test_front_record_sees_current_materials():
    """The repair of the JAX package's stale front materials: with the
    albedo scaled by 0.25, the front record forward of the refreshed front
    equals the brute record forward of the scaled scene on >= 99.9% of
    rays (within 1e-5), where the build-time table would not."""
    js, jf = _scene_and_front("cover")
    ps, pf = _port_scene(js), _port_front(jf)
    scaled = dataclasses.replace(ps, albedo=ps.albedo * 0.25)
    o, d, t = (torch.from_numpy(x) for x in _rays(COVER_CAM, 1024, seed=3))
    brute, _ = mk.trace_record(o, d, t, scaled, 11, 3)
    fresh, _ = mk.trace_record(o, d, t, scaled, 11, 3, front=mk.front_with_params(pf, scaled))
    stale, _ = mk.trace_record(o, d, t, scaled, 11, 3, front=pf)
    close = (torch.abs(fresh - brute) <= 1e-5).all(dim=1).double().mean().item()
    stale_close = (torch.abs(stale - brute) <= 1e-5).all(dim=1).double().mean().item()
    print(f"refreshed front vs brute: {close:.6f} of rays within 1e-5; build-time table "
          f"{stale_close:.6f}")
    assert close >= 0.999
    assert stale_close < 0.9


def test_record_bvh_raises():
    """`bvh` must be a FlatBVH (or `bvh_tables` of one) whose leaves the
    kernel's node words can hold; anything else raises."""
    from raytracingproject_tpu_torch.bvh import build_bvh

    js, _ = _scene_and_front("three")
    ps = _port_scene(js)
    o, d, t = (torch.from_numpy(x) for x in _rays(THREE_CAM, 256, seed=1))
    with pytest.raises(TypeError):
        mk.trace_record(o, d, t, ps, 1, 2, bvh=object())
    tree = build_bvh(ps, leaf_size=2)
    with pytest.raises(ValueError, match="255"):
        mk.trace_record(o, d, t, ps, 1, 2, bvh=tree._replace(leaf_count=tree.leaf_count * 200))
