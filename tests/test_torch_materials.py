"""The port's ops/sampling.py (support and moments, as tests/test_sampling.py
holds the JAX package's) and materials.py: scatter_from_draws against the
JAX package's scatter with the draws reproduced from its key."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu import materials as jmat, scene as jscene
from raytracingproject_tpu.config import DIELECTRIC, LAMBERTIAN, METAL
from raytracingproject_tpu.ops import sampling as jsmp
from raytracingproject_tpu.ops.intersect import HitRecord as JHitRecord

from raytracingproject_tpu_torch import materials as pmat
from raytracingproject_tpu_torch.ops import sampling as psmp
from raytracingproject_tpu_torch.ops.intersect import HitRecord
from test_torch_megakernel import _port_scene

N = 200_000


def jax_scatter_draws(key, n, dtype=torch.float32) -> pmat.ScatterDraws:
    """The numbers materials.scatter of the JAX package draws from `key`
    for n rays (split(key, 3) at materials.py:52; the nested split of
    random_in_unit_sphere happens inside the JAX sampling function)."""
    k_lam, k_fuzz, k_refl = jax.random.split(key, 3)
    T = lambda x: torch.from_numpy(np.array(x)).to(dtype)  # noqa: E731
    return pmat.ScatterDraws(unit=T(jsmp.random_unit_vector(k_lam, (n,))),
                             ball=T(jsmp.random_in_unit_sphere(k_fuzz, (n,))),
                             uniform=T(jax.random.uniform(k_refl, (n,))))


def test_unit_disk_support_and_radial_cdf():
    p = psmp.random_in_unit_disk(torch.Generator().manual_seed(0), (N,)).numpy()
    r2 = p[:, 0] ** 2 + p[:, 1] ** 2
    assert p.shape == (N, 3) and np.all(p[:, 2] == 0.0)
    assert np.all(r2 <= 1.0 + 1e-6)
    assert abs(r2.mean() - 0.5) < 0.01            # uniform over the disk: r^2 ~ U[0, 1]
    assert abs(np.mean(r2 < 0.25) - 0.25) < 0.01


def test_unit_vector_isotropic():
    v = psmp.random_unit_vector(torch.Generator().manual_seed(1), (N,)).numpy()
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    assert np.all(np.abs(v.mean(axis=0)) < 0.01)
    np.testing.assert_allclose(v.var(axis=0), 1.0 / 3.0, atol=0.01)


def test_unit_sphere_interior_uniform():
    p = psmp.random_in_unit_sphere(torch.Generator().manual_seed(2), (N,)).numpy()
    r = np.linalg.norm(p, axis=-1)
    assert np.all(r <= 1.0 + 1e-6)
    assert abs((r ** 3).mean() - 0.5) < 0.01      # uniform in the ball: r^3 ~ U[0, 1]
    assert np.all(np.abs(p.mean(axis=0)) < 0.01)


def test_hemisphere_alignment_and_dtype():
    normal = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64).expand(N, 3)
    v = psmp.random_on_hemisphere(torch.Generator().manual_seed(3), normal)
    assert v.dtype == torch.float64 and bool((v[:, 1] > 0.0).all())
    np.testing.assert_allclose(np.linalg.norm(v.numpy(), axis=-1), 1.0, atol=1e-9)
    d = pmat.draw_scatter(torch.Generator().manual_seed(4), (5,))
    assert d.unit.shape == (5, 3) and d.ball.shape == (5, 3) and d.uniform.shape == (5,)


def _records(n, seed):
    """n synthetic hit records over a scene with every material (one metal
    of fuzz 1, so some rays are absorbed; glass seen from inside at every
    angle, so some rays reflect totally): incident directions, normals
    facing against them, faces and sphere indices drawn with numpy."""
    js = (jscene.SceneBuilder()
          .add_lambertian((0, 0, 0), 1.0, (0.8, 0.3, 0.2))
          .add_metal((3, 0, 0), 1.0, (0.7, 0.6, 0.5), fuzz=0.0)
          .add_metal((6, 0, 0), 1.0, (0.9, 0.9, 0.9), fuzz=1.0)
          .add_dielectric((9, 0, 0), 1.0, 1.5)
          .add_dielectric((12, 0, 0), 1.0, 2.4).build())
    rng = np.random.default_rng(seed)
    d = (rng.normal(size=(n, 3)) * rng.uniform(0.2, 3.0, (n, 1))).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where((np.sum(d * nrm, axis=1) < 0)[:, None], nrm, -nrm).astype(np.float32)
    d[:8] = -nrm[:8] * 2.0                         # head-on: cos == 1, sin_theta's guard
    idx = rng.integers(0, 5, n).astype(np.int32)
    front = rng.random(n) < 0.5
    t = rng.uniform(0.5, 5.0, n).astype(np.float32)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    return js, d, dict(t=t, idx=idx, hit=np.ones(n, bool), p=p, normal=nrm, front_face=front)


def test_scatter_from_draws_matches_jax():
    """Direction and attenuation within 1e-5, `scattered` and
    `dielectric_reflected` equal, per material (the Schlick comparison may
    flip where the probability is within float rounding of the draw:
    measured 0 of 6000, allowed 1e-3)."""
    n = 6000
    js, d, rec = _records(n, seed=0)
    key = jax.random.PRNGKey(5)
    ref = jmat.scatter(key, jnp.asarray(d), JHitRecord(**{k: jnp.asarray(v)
                                                          for k, v in rec.items()}), js)
    got = pmat.scatter_from_draws(jax_scatter_draws(key, n), torch.from_numpy(d),
                                  HitRecord(**{k: torch.from_numpy(v) for k, v in rec.items()}),
                                  _port_scene(js))
    mat = np.asarray(js.mat_type)[rec["idx"]]
    refl_same = got.dielectric_reflected.numpy() == np.asarray(ref.dielectric_reflected)
    assert (~refl_same[mat == DIELECTRIC]).mean() <= 1e-3
    for code, name in ((LAMBERTIAN, "lambertian"), (METAL, "metal"), (DIELECTRIC, "dielectric")):
        sel = (mat == code) & refl_same
        assert sel.sum() > 500
        diff = np.abs(got.direction.numpy()[sel] - np.asarray(ref.direction)[sel]).max()
        print(name, "max |direction diff|", diff)
        assert diff <= 1e-5
        np.testing.assert_allclose(got.attenuation.numpy()[sel], np.asarray(ref.attenuation)[sel],
                                   atol=1e-7)
        np.testing.assert_array_equal(got.scattered.numpy()[sel], np.asarray(ref.scattered)[sel])
    # the cases the rule has branches for did occur
    assert (~got.scattered.numpy()[mat == METAL]).sum() > 50          # absorbed metal rays
    inside_glass = (mat == DIELECTRIC) & ~rec["front_face"]
    cos = np.minimum(np.sum(-d / np.linalg.norm(d, axis=1, keepdims=True) * rec["normal"], 1), 1)
    ior = np.asarray(js.ior)[rec["idx"]]
    tir = inside_glass & (ior * np.sqrt(np.maximum(1 - cos * cos, 0)) > 1.0)
    assert tir.sum() > 100 and got.dielectric_reflected.numpy()[tir].all()
    assert got.scattered.dtype == torch.bool and got.dielectric_reflected.dtype == torch.bool


def test_schlick_matches_jax():
    rng = np.random.default_rng(2)
    c = rng.random(256).astype(np.float32)
    r = rng.uniform(0.4, 2.5, 256).astype(np.float32)
    np.testing.assert_allclose(
        pmat.schlick_reflectance(torch.from_numpy(c), torch.from_numpy(r)).numpy(),
        np.asarray(jmat.schlick_reflectance(jnp.asarray(c), jnp.asarray(r))), atol=1e-6)


def test_scatter_draws_from_the_generator_in_order():
    """scatter(generator) is scatter_from_draws on draw_scatter's numbers,
    drawn in the order unit vector, ball point, uniform."""
    js, d, rec = _records(64, seed=1)
    prec = HitRecord(**{k: torch.from_numpy(v) for k, v in rec.items()})
    ps = _port_scene(js)
    a = pmat.scatter(torch.Generator().manual_seed(9), torch.from_numpy(d), prec, ps)
    draws = pmat.draw_scatter(torch.Generator().manual_seed(9), (64,))
    b = pmat.scatter_from_draws(draws, torch.from_numpy(d), prec, ps)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    g = torch.Generator().manual_seed(9)
    assert torch.equal(draws.unit, psmp.random_unit_vector(g, (64,)))
    assert torch.equal(draws.ball, psmp.random_in_unit_sphere(g, (64,)))
    assert torch.equal(draws.uniform, torch.rand(64, generator=g))
