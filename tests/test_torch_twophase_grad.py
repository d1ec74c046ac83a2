"""The two-phase gradient path of the port: `trace_record_twophase`
(K6 recording both phases, ops/cuda/depth_tail.py) against the monolithic
record and the JAX package's `pallas_trace_record_twophase`;
`replay_radiance_twophase` on the JAX package's own two-phase recording
against the JAX replay; `make_fast_radiance_twophase` and
`make_fast_train_step(two_phase=)` against the monolithic fast path.

Inputs are made with numpy seeds or the JAX package's ray generator and
handed to both packages as numpy arrays; the JAX pipelines run in
interpret mode, whose PRNG returns zeros (`zero_draws` in the port).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.grad import inverse as jinv
from raytracingproject_tpu.grad.replay import replay_radiance_twophase as jreplay_twophase
from raytracingproject_tpu.ops.pallas import megakernel as jmk

from raytracingproject_tpu_torch import bridge
from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.grad import (
    SceneParams, extract_params, make_fast_radiance, make_fast_radiance_twophase,
    make_fast_train_step, replay_radiance_twophase,
)
from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt, megakernel as mk
from test_torch_depth_tail import DEPTH, N_RAYS, _three, _torch, _within
from test_torch_grad import _port_params, _rel_errors
from test_torch_megakernel import (
    COVER_CAM, THREE_CAM, _port_front, _port_scene, _rays, _scene_and_front,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread for this module: its shapes are too small to
    split (alone it runs ~1.8x faster so), and it keeps the workers of a
    parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", ["brute", "front"])
@pytest.mark.parametrize("zero_draws", [True, False])
def test_record_twophase_equals_monolithic_record(path, zero_draws):
    """tests/test_twophase.py's contract: the residuals, unpermuted, are the
    monolithic record's rows (idx, direction, refl), the radiance is its
    radiance, and packed positions from n_alive rows on are all DEAD."""
    _, _, ps, pf = _three(path)
    rays = _torch(*_rays(THREE_CAM, 700, seed=16))
    n = rays[0].shape[0]
    rad_m, res_m = mk.trace_record(*rays, ps, 5, DEPTH, front=pf, zero_draws=zero_draws)
    rad, res1, res2, src, dest, n_alive = dt.trace_record_twophase(
        *rays, ps, 5, DEPTH, cut=2, front=pf, zero_draws=zero_draws)
    assert torch.equal(rad, rad_m)
    back = [dt.take_ray_rows(x, dest, dim=1)[:, :n] for x in res2]
    assert torch.equal(torch.cat([res1.idx[:, :n], back[0]]), res_m.idx)
    ndir = torch.stack([torch.cat([a[:, :n], b]) for a, b in zip(res1[1:4], back[1:4])], dim=-1)
    assert torch.equal(ndir, res_m.ndir)
    assert torch.equal(torch.cat([res1.refl[:, :n], back[4]]), res_m.refl)
    assert bool((res2.idx[:, int(n_alive) * dt.ROW_WIDTH:] == mk.DEAD).all())
    assert bool((res1.idx[:, n:] == mk.DEAD).all())  # padding rays


def test_record_twophase_matches_jax(monkeypatch):
    """At 128-ray rows (three spheres, zero draws, 1,024 rays: no padding
    either side), the packing (src, dest, n_alive) and both phases' idx and
    refl equal pallas_trace_record_twophase's; the radiance within 5e-5 on
    >= 99.9% of rays, every recorded direction of a ray within 1e-4 on
    >= 99% of rays and 1e-3 on all: the glass-trapped rays of
    test_segment_twin_matches_jax_segment, 8 of 1,024 here, drift in
    their later bounces (their idx stay equal)."""
    js, _, ps, _ = _three("brute")
    o, d, t = _rays(THREE_CAM, N_RAYS, seed=17)
    ref = jmk.pallas_trace_record_twophase(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), js,
                                           jnp.int32(5), max_depth=DEPTH, cut=2,
                                           interpret=True)
    monkeypatch.setattr(dt, "ROW_WIDTH", 128)
    got = dt.trace_record_twophase(*_torch(o, d, t), ps, 5, DEPTH, cut=2, zero_draws=True)
    assert _within(got[0].numpy(), ref[0], 5e-5) >= 0.999
    for g, r in zip(got[3:], ref[3:]):
        assert np.array_equal(g.numpy(), np.asarray(r))
    for g, r in zip(got[1:3], ref[1:3]):
        assert np.array_equal(g.idx.numpy(), np.asarray(r.idx))
        assert np.array_equal(g.refl.numpy(), np.asarray(r.refl))
        nd = np.max([np.abs(a.numpy() - np.asarray(b)) for a, b in
                     zip((g.ndx, g.ndy, g.ndz), (r.ndx, r.ndy, r.ndz))], axis=(0, 1))
        assert (nd <= 1e-4).mean() >= 0.99 and nd.max() <= 1e-3  # per ray, every bounce


@pytest.mark.parametrize("path,cap_frac,zero_draws", [("brute", 0.5, False),
                                                     ("front", 0.001, True)])
def test_fast_radiance_twophase_equals_monolithic(path, cap_frac, zero_draws):
    """make_fast_radiance_twophase against make_fast_radiance on the same
    rays and seed (cover scene, depth 6, Philox or zero draws): radiance
    and every gradient equal, with ample capacity and with the overflow
    branch; no gradient wanted, the forward is the plain two-phase
    trace."""
    js, jf = _scene_and_front("cover")
    ps = _port_scene(js)
    pf = _port_front(jf) if path == "front" else None
    rays = _torch(*_rays(COVER_CAM, 1024, seed=19))
    w = torch.from_numpy(np.random.default_rng(5).random((1024, 3)).astype(np.float32))

    def run(fn):
        pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(ps)))
        rad = fn(pp, *rays, 4242)
        return rad.detach(), torch.autograd.grad((rad * w).sum(), list(pp))

    rad_m, g_m = run(make_fast_radiance(ps, DEPTH, front=pf, zero_draws=zero_draws))
    rad_2, g_2 = run(make_fast_radiance_twophase(ps, DEPTH, cut=2, cap_frac=cap_frac, front=pf,
                                                 zero_draws=zero_draws))
    assert torch.equal(rad_2, rad_m)
    for name, a, b in zip(SceneParams._fields, g_2, g_m):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-9), name
    with torch.no_grad():
        plain = make_fast_radiance_twophase(ps, DEPTH, cut=2, front=pf, zero_draws=zero_draws)(
            extract_params(ps), *rays, 4242)
    assert torch.equal(plain, rad_m)
    with pytest.raises(ValueError, match="two-phase cut"):
        make_fast_radiance_twophase(ps, DEPTH, cut=DEPTH)


def test_twophase_train_step_equals_monolithic_step():
    """make_fast_train_step(two_phase=2) on the CPU: from the same
    generator its loss, gradients and updated parameters equal the
    monolithic step's; frozen fields stay bit-unchanged."""
    js, jf = _scene_and_front("three")
    ps = _port_scene(js)
    cam = Camera(aspect_ratio=1.0, image_width=16, samples_per_pixel=2, max_depth=5, vfov=60.0,
                 lookfrom=(0.0, 0.5, 1.5), lookat=(0.0, 0.0, -1.0))
    target = torch.full((16, 16, 3), 0.5)
    trainable = ("albedo", "fuzz", "ior")
    out = {}
    for two_phase in (None, 2):
        params, opt, step = make_fast_train_step(
            ps, cam, spp=2, trainable=trainable, front=_port_front(jf), two_phase=two_phase,
            device="cpu", generator=torch.Generator().manual_seed(6))
        before = SceneParams(*(x.detach().clone() for x in params))
        for _ in range(2):
            params, opt, loss, grads = step(params, opt, None, target)
        for f in SceneParams._fields:
            if f not in trainable:
                assert torch.equal(getattr(params, f).detach(), getattr(before, f)), f
        out[two_phase] = (loss, grads, params)
    (l1, g1, p1), (l2, g2, p2) = out[None], out[2]
    assert torch.equal(l1, l2)
    for a, b in zip(g1 + p1, g2 + p2):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-9)


@functools.lru_cache(maxsize=None)
def _jax_twophase_record():
    """pallas_trace_record_twophase (interpret mode) of the replay test's
    rays, shared by its three capacities."""
    js = _scene_and_front("three")[0]
    o, d, t = (jnp.asarray(x) for x in _rays(THREE_CAM, 1200, seed=18))
    return jmk.pallas_trace_record_twophase(o, d, t, js, jnp.int32(5), max_depth=DEPTH, cut=2,
                                            interpret=True)


@pytest.mark.parametrize("cap_frac", [0.75, 0.5, 0.001])
def test_replay_twophase_matches_jax_replay(cap_frac):
    """replay_radiance_twophase on the JAX package's own two-phase recording
    (bridge.residuals_p_from_arrays, 128-ray rows, 1,200 rays padded to
    2,048): the radiance within 2e-5 on >= 99.8% of rays in float32, and
    the gradients of sum(rad * w) within 1e-4 relative per field in float64
    (test_replay_matches_jax_replay's bounds). Ten of the 16 rows live
    after the cut: cap_frac 0.75 (12 rows) takes the capacity branch, 0.5
    (8 rows; tests/test_twophase.py's value, whose rays overflow it too)
    and 0.001 (one row) the full-width one."""
    js = _scene_and_front("three")[0]
    ps = _port_scene(js)
    o, d, t = _rays(THREE_CAM, 1200, seed=18)
    jo, jd, jt = (jnp.asarray(x) for x in (o, d, t))
    _, res1, res2, src, dest, n_alive = _jax_twophase_record()
    r_pad = res1.idx.shape[1]
    cap = max(1, int(round(r_pad * cap_frac)))
    assert (int(n_alive) * 128 <= cap) == (cap_frac == 0.75)
    params = jinv.extract_params(js)
    jrad = np.asarray(jreplay_twophase(params, js, jo, jd, jt, res1, res2, src, dest, n_alive,
                                       cap_rays=cap))

    def port_rec(dtype):
        arrays = lambda r: [np.asarray(x) for x in r]  # noqa: E731
        return bridge.residuals_p_from_arrays(arrays(res1), arrays(res2), np.asarray(src),
                                              np.asarray(dest), np.asarray(n_alive),
                                              dtype=dtype)

    prad = replay_radiance_twophase(_port_params(params, requires_grad=False), ps,
                                    *(torch.from_numpy(np.array(x)) for x in (o, d, t)),
                                    *port_rec(torch.float32), cap_rays=cap)
    assert (np.abs(prad.detach().numpy() - jrad).max(axis=1) <= 2e-5).mean() >= 0.998

    w = np.random.default_rng(3).random((o.shape[0], 3))
    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree.map(  # noqa: E731
            lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            tree)
        js64, r1, r2 = f64(js), f64(res1), f64(res2)
        o64, d64, t64 = f64((jo, jd, jt))
        g_ref = jax.grad(lambda p: jnp.sum(jreplay_twophase(
            p, js64, o64, d64, t64, r1, r2, src, dest, n_alive, cap_rays=cap) * w))(
            jinv.extract_params(js64))
        g_ref = [np.asarray(x) for x in g_ref]
    pp = _port_params(params, dtype=torch.float64)
    rays64 = tuple(torch.from_numpy(np.array(x)).double() for x in (o, d, t))
    rad64 = replay_radiance_twophase(pp, ps, *rays64, *port_rec(torch.float64), cap_rays=cap)
    g = torch.autograd.grad((rad64 * torch.from_numpy(w)).sum(), list(pp))
    rel = _rel_errors(js.fuzz, g_ref, g)
    print(f"cap_frac {cap_frac}: float64 gradient relative errors {rel}")
    assert max(rel.values()) <= 1e-4
