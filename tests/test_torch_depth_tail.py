"""The depth-tail pipelines of the port (ops/cuda/depth_tail.py): K6's
plain version (`segment_twin`), the alive-first compaction, two-phase and
segmented tracing and their routes through `render`, against the JAX
package's Pallas pipelines in interpret mode and against the port's own
monolithic trace. The two-phase record, replay and train step are in
tests/test_torch_twophase_grad.py.

The TPU interpreter's PRNG returns zeros, so the port runs with
`zero_draws` wherever it is held against JAX. Inside the port a segment
draws as the monolithic kernel draws for the same ray and bounce, so the
pipelines equal the monolithic trace with real draws too. The CUDA
kernels are held against these plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.ops.pallas import megakernel as jmk

from raytracingproject_tpu_torch import bvh as pbvh, scene as pscene
from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import T_MIN, RenderSettings
from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt, megakernel as mk
from raytracingproject_tpu_torch.render import render, render_pass
from test_torch_megakernel import (
    COVER_CAM, THREE_CAM, _port_front, _port_scene, _rays, _scene_and_front,
)

DEPTH = 6  # tests/test_twophase.py's depth
N_RAYS = 1024  # one TPU tile: no padding on either side


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread for this module: its shapes are too small to
    split (alone it runs ~1.8x faster so), and it keeps the workers of a
    parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _within(got, ref, atol):
    """Share of rays (rows) whose every component is within `atol`."""
    return np.all(np.abs(np.asarray(got) - np.asarray(ref)) <= atol, axis=-1).mean()


def _three(path):
    """(JAX scene, JAX front or None, port scene, port front or None)."""
    js, jf = _scene_and_front("three")
    front = path == "front"
    return js, (jf if front else None), _port_scene(js), (_port_front(jf) if front else None)


# ---- K6's plain version against the JAX segment call ----

def _jax_state(o, d, t, record_miss):
    """The JAX pipelines' initial flat planes (no padding: R is a tile
    multiple)."""
    n = o.shape[0]
    one, zero = np.ones(n, np.float32), np.zeros(n, np.float32)
    state = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t, one, one, one,
             zero, zero, zero, one]
    return [jnp.asarray(x) for x in state + [zero] * (6 if record_miss else 0)]


def _jax_segment(state, js, jf, depth, record_miss=False, record=False):
    """(flat state after one `_segment_call`, raw residual outputs)."""
    planes = [p.reshape(-1, jmk.LANES) for p in state]
    outs = jmk._segment_call(planes, js, jnp.int32(5), depth, T_MIN, jf, True,
                             record_miss=record_miss, record=record)
    flat = [o.reshape(-1) for o in outs[: 19 if record_miss else 13]]
    new = flat[0:6] + [state[6]] + flat[6:13] + flat[13:]
    return new, [np.asarray(o).reshape(depth, -1) for o in outs[13:17]] if record else None


@functools.lru_cache(maxsize=None)
def _first_segment(path, record_miss):
    """(JAX rays, the JAX state after a first segment of 2 bounces), shared
    by the segment tests."""
    js, jf, _, _ = _three(path)
    o, d, t = _rays(THREE_CAM, N_RAYS, seed=11)
    state, _ = _jax_segment(_jax_state(o, d, t, record_miss), js, jf, 2,
                            record_miss=record_miss)
    return state


@pytest.mark.parametrize("path", ["brute", "front"])
@pytest.mark.parametrize("kind", ["plain", "miss", "record"])
def test_segment_twin_matches_jax_segment(path, kind):
    """segment_twin against `_segment_call(..., interpret=True)` from the
    state a first JAX segment of 2 bounces left, for a second segment of
    4: every output plane (13, 19 with the miss planes, 17 with the
    residuals) within 5e-5 on >= 99.9% of rays, but the origin and
    direction planes, which hold that on >= 99.5% and 1e-3 on all rays;
    the residual idx equal on >= 99.9% of entries, refl equal and the
    direction within 1e-4 on >= 99.9% of them (1e-3 on all) where idx is.

    The origin and direction of 8 of 2,048 rays (seed 11) drift by 1.2e-4
    to 4.7e-4 (1e-4 relative): under zero draws a ray inside the glass
    sphere always reflects, and six reflections amplify XLA's contracted
    FMAs against the port's separate roundings (ROADMAP Queue 3). Those
    rays are still alive, so their radiance is 0 in both; the monolithic
    depth-6 radiance agrees within 5e-5 on every ray."""
    js, jf, ps, pf = _three(path)
    miss, record = kind == "miss", kind == "record"
    state1 = _first_segment(path, miss)
    ref, res = _jax_segment(state1, js, jf, 4, record_miss=miss, record=record)
    port_state = torch.from_numpy(np.stack([np.asarray(p) for p in state1]))
    slot = torch.arange(N_RAYS, dtype=torch.int32)
    got = mk.segment_twin(port_state, slot, ps, 5, 2, 4, front=pf, zero_draws=True,
                          record_miss=miss, record=record)
    if record:
        got, planes = got
    assert got.shape == port_state.shape
    for q, r in enumerate(ref):
        close = _within(got[q].numpy()[:, None], np.asarray(r)[:, None], 5e-5)
        assert close >= (0.995 if q < 6 else 0.999), (q, close)
        assert _within(got[q].numpy()[:, None], np.asarray(r)[:, None], 1e-3) == 1.0, q
    if record:
        jidx, jrefl = (np.asarray(x) for x in jmk._decode_res(jnp.asarray(res[0]), None))
        eq = planes[0].numpy() == jidx
        assert eq.mean() >= 0.999 and (jidx == mk.MISS).any() and (jidx >= 0).any()
        for q in range(3):
            nd = np.abs(planes[1 + q].numpy() - res[1 + q])[eq]
            assert (nd <= 1e-4).mean() >= 0.999 and nd.max() <= 1e-3
        assert np.array_equal(planes[4].numpy().astype(bool)[eq], jrefl[eq])


def test_segment_refuses_what_k6_does_not_take():
    js, jf, ps, pf = _three("front")
    o, d, t = _torch(*_rays(THREE_CAM, 256, seed=1))
    state, slot = dt.initial_state(o, d, t)
    tree = pbvh.build_bvh(ps, leaf_size=2)
    with pytest.raises(ValueError, match="FrontTablesHBM"):
        mk.segment_call(state, slot, ps, 1, 0, 2, front=mk.front_tables_hbm(ps, tree))
    with pytest.raises(ValueError, match="not both"):
        mk.segment_call(state, slot, ps, 1, 0, 2, record_miss=True, record=True)
    with pytest.raises(ValueError, match="expected"):
        mk.segment_call(state, slot, ps, 1, 0, 2, record_miss=True)  # 14 planes, not 20


# ---- the compaction ----

@pytest.mark.parametrize("kind", ["sparse", "dense", "all_dead", "all_alive"])
def test_alive_first_perm_matches_jax(kind, monkeypatch):
    """At 128-ray rows, src, dest and n_alive equal `_alive_first_perm`'s
    exactly, and take_ray_rows equals `_take_ray_rows`."""
    monkeypatch.setattr(dt, "ROW_WIDTH", 128)
    rng = np.random.default_rng(3)
    n = 128 * 48
    p_alive = {"sparse": 0.002, "dense": 0.3, "all_dead": 0.0, "all_alive": 1.0}[kind]
    alive = (rng.random(n) < p_alive).astype(np.float32)
    jsrc, jdest, jn = (np.asarray(x) for x in jmk._alive_first_perm(jnp.asarray(alive)))
    src, dest, n_alive = dt.alive_first_perm(torch.from_numpy(alive))
    assert np.array_equal(src.numpy(), jsrc) and np.array_equal(dest.numpy(), jdest)
    assert int(n_alive) == int(jn)
    assert src.dtype == dest.dtype == torch.int32
    x = rng.random((3, n)).astype(np.float32)
    ref = np.asarray(jmk._take_ray_rows(jnp.asarray(x), jnp.asarray(jsrc), axis=1))
    assert np.array_equal(dt.take_ray_rows(torch.from_numpy(x), src, dim=1).numpy(), ref)


@pytest.mark.parametrize("row", [1, 32])
def test_alive_first_perm_packs_live_rows_first(row, monkeypatch):
    """At one-ray and warp-wide rows: live rows first in their order, then
    the dead ones in theirs; dest inverts src."""
    monkeypatch.setattr(dt, "ROW_WIDTH", row)
    alive = torch.from_numpy((np.random.default_rng(4).random(1024) < 0.05).astype(np.float32))
    src, dest, n_alive = dt.alive_first_perm(alive)
    live = (alive.reshape(-1, row) > 0.5).any(dim=1)
    want = torch.cat([torch.nonzero(live)[:, 0], torch.nonzero(~live)[:, 0]])
    assert torch.equal(src.long(), want) and int(n_alive) == int(live.sum())
    assert torch.equal(dest.long()[src.long()], torch.arange(src.shape[0]))


# ---- two-phase and segmented tracing ----

@pytest.mark.parametrize("path", ["brute", "front"])
@pytest.mark.parametrize("cuts", [(2,), (1, 3)], ids=["cut2", "cuts1-3"])
def test_twophase_matches_jax(path, cuts):
    """trace_paths_twophase against pallas_trace_paths_twophase in
    interpret mode (three spheres, zero draws, depth 6): >= 99.9% of rays
    within 5e-5; with record_miss the radiance alike, the miss direction
    and throughput within 5e-5 on >= 99.5% and 1e-3 on all (the
    glass-trapped rays of test_segment_twin_matches_jax_segment)."""
    js, jf, ps, pf = _three(path)
    o, d, t = _rays(THREE_CAM, N_RAYS, seed=12)
    jo, jd, jt = (jnp.asarray(x) for x in (o, d, t))
    rays = _torch(o, d, t)
    ref = jmk.pallas_trace_paths_twophase(jo, jd, jt, js, jnp.int32(7), max_depth=DEPTH,
                                          cuts=cuts, interpret=True, front=jf)
    got = dt.trace_paths_twophase(*rays, ps, 7, DEPTH, cuts=cuts, front=pf, zero_draws=True)
    assert _within(got.numpy(), ref, 5e-5) >= 0.999
    if cuts == (2,) and path == "brute":
        ref = jmk.pallas_trace_paths_twophase(jo, jd, jt, js, jnp.int32(7), max_depth=DEPTH,
                                              cuts=cuts, interpret=True, front=jf,
                                              record_miss=True)
        got = dt.trace_paths_twophase(*rays, ps, 7, DEPTH, cuts=cuts, front=pf,
                                      zero_draws=True, record_miss=True)
        for q, (g, r) in enumerate(zip(got, ref)):  # the miss planes: as in the segment test
            assert _within(g.numpy(), r, 5e-5) >= (0.999 if q == 0 else 0.995)
            assert _within(g.numpy(), r, 1e-3) == 1.0


@pytest.mark.parametrize("path", ["brute", "front"])
def test_segmented_matches_jax(path):
    """trace_paths_segmented (seg_len 2) against
    pallas_trace_paths_segmented in interpret mode: >= 99.9% of rays within
    5e-5."""
    js, jf, ps, pf = _three(path)
    o, d, t = _rays(THREE_CAM, N_RAYS, seed=13)
    ref = jmk.pallas_trace_paths_segmented(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), js,
                                           jnp.int32(7), max_depth=DEPTH, seg_len=2,
                                           interpret=True, front=jf)
    got = dt.trace_paths_segmented(*_torch(o, d, t), ps, 7, DEPTH, seg_len=2, front=pf,
                                   zero_draws=True)
    assert _within(got.numpy(), ref, 5e-5) >= 0.999


@pytest.mark.parametrize("scene_name,path,zero_draws", [
    ("three", "brute", True), ("three", "front", False), ("cover", "brute", False),
    ("cover", "front", True)])
def test_pipelines_equal_the_monolithic_trace(scene_name, path, zero_draws, monkeypatch):
    """Keyed by (seed, slot, bounce), every pipeline computes the monolithic
    plain version's radiance bit for bit, with zero draws and with Philox
    draws, at row widths 1, 32 and 128, and its miss planes too."""
    js, jf = _scene_and_front(scene_name)
    ps = _port_scene(js)
    pf = _port_front(jf) if path == "front" else None
    cam = THREE_CAM if scene_name == "three" else COVER_CAM
    rays = _torch(*_rays(cam, 600, seed=14))  # not a tile multiple: padding rays
    kw = dict(front=pf, zero_draws=zero_draws)
    mono = mk.trace_paths(*rays, ps, 99, DEPTH, **kw)
    for row, run in ((1, lambda: dt.trace_paths_twophase(*rays, ps, 99, DEPTH, cuts=(2,), **kw)),
                     (32, lambda: dt.trace_paths_twophase(*rays, ps, 99, DEPTH, cuts=(1, 3),
                                                          **kw)),
                     (128, lambda: dt.trace_paths_segmented(*rays, ps, 99, DEPTH, seg_len=2,
                                                            **kw))):
        monkeypatch.setattr(dt, "ROW_WIDTH", row)
        assert torch.equal(run(), mono), row
    monkeypatch.undo()
    miss = mk.trace_paths(*rays, ps, 99, DEPTH, record_miss=True, **kw)
    got = dt.trace_paths_twophase(*rays, ps, 99, DEPTH, record_miss=True, cuts=(2,), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, miss))


def test_hbm_front_falls_back_and_refuses():
    """A FrontTablesHBM has no segment kernel: two-phase is the monolithic
    K7 trace (as the JAX package falls back), segmented and the two-phase
    record raise."""
    _, _, ps, _ = _three("brute")
    tree = pbvh.build_bvh(ps, leaf_size=2)
    hbm = mk.front_tables_hbm(ps, tree)
    rays = _torch(*_rays(THREE_CAM, 512, seed=15))
    for zero in (True, False):
        mono = mk.trace_paths(*rays, None, 3, DEPTH, front=hbm, zero_draws=zero)
        two = dt.trace_paths_twophase(*rays, None, 3, DEPTH, cuts=(2,), front=hbm,
                                      zero_draws=zero)
        assert torch.equal(two, mono)
    with pytest.raises(ValueError, match="FrontTablesHBM"):
        dt.trace_paths_segmented(*rays, None, 3, DEPTH, seg_len=2, front=hbm)
    with pytest.raises(ValueError, match="FrontTablesHBM"):
        dt.trace_record_twophase(*rays, None, 3, DEPTH, cut=2, front=hbm)
    with pytest.raises(ValueError, match="strictly increasing"):
        dt.trace_paths_twophase(*rays, ps, 3, DEPTH, cuts=(3, 2))


# ---- the routes through render ----

RENDER_CAM = dict(aspect_ratio=16.0 / 9.0, image_width=32, samples_per_pixel=2, max_depth=6,
                  vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0))


@pytest.mark.parametrize("kw", [{"two_phase": 2}, {"depth_segment": 2}, {"two_phase": 9}],
                         ids=["two_phase", "depth_segment", "two_phase_past_depth"])
def test_render_depth_tail_equals_monolithic(kw):
    """render() with two_phase or depth_segment gives the monolithic
    render's image bit for bit from the same generator (an option at or
    past max_depth traces monolithically), with and without a sky
    texture."""
    cam = Camera(**RENDER_CAM)
    scene = pscene.make_three_sphere_scene()
    tex = np.random.default_rng(2).random((8, 16, 3)).astype(np.float32)
    for sky in (None, tex):
        gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
        mono = render(scene, cam, gen(), RenderSettings(device="cpu"), sky_texture=sky)
        got = render(scene, cam, gen(), RenderSettings(device="cpu", **kw), sky_texture=sky)
        assert torch.equal(got, mono)


def test_render_pass_with_bvh_skips_the_pipelines(monkeypatch):
    """render_pass(bvh=) traces monolithically whatever two_phase and
    depth_segment say, as the JAX render_pass does."""
    import importlib

    # the package exports the function `render` under the module's name
    prender_mod = importlib.import_module("raytracingproject_tpu_torch.render")

    def refuse(*args, **kwargs):
        raise AssertionError("a depth-tail pipeline ran with bvh=")

    monkeypatch.setattr(prender_mod, "trace_paths_twophase", refuse)
    monkeypatch.setattr(prender_mod, "trace_paths_segmented", refuse)
    scene = pscene.make_three_sphere_scene()
    tree = pbvh.build_bvh(scene, leaf_size=2)
    rs = pbvh.reorder_scene(scene, tree)
    cam = Camera(**RENDER_CAM)
    w, h = cam.image_size()
    derived = cam.derive(torch.float32, "cpu")
    base = dict(width=w, height=h, max_depth=6, spp_chunk=2, bvh=tree)
    ref = render_pass(rs, derived, torch.Generator().manual_seed(1), **base)
    for kw in ({"two_phase": 2}, {"depth_segment": 2}):
        got = render_pass(rs, derived, torch.Generator().manual_seed(1), **base, **kw)
        assert torch.equal(got, ref)


def test_sky_texture_megakernel_render_near_oracle():
    """render(sky_texture=) on the megakernel route (record_miss, the
    texture looked up after the kernel) against the oracle route on the
    same texture: image means within 5% (different draws, one estimator)."""
    cam = Camera(**dict(RENDER_CAM, samples_per_pixel=16))
    scene = pscene.make_three_sphere_scene()
    tex = np.random.default_rng(7).random((12, 24, 3)).astype(np.float32) * 0.9 + 0.05
    mega = render(scene, cam, torch.Generator().manual_seed(1), RenderSettings(device="cpu"),
                  sky_texture=tex)
    oracle = render(scene, cam, torch.Generator().manual_seed(2),
                    RenderSettings(device="cpu", use_megakernel=False), sky_texture=tex)
    plain = render(scene, cam, torch.Generator().manual_seed(1), RenderSettings(device="cpu"))
    assert torch.isfinite(mega).all() and mega.shape == (18, 32, 3)
    m, r = mega.mean().item(), oracle.mean().item()
    print(f"image means: megakernel {m:.5f}, oracle {r:.5f}, without the texture "
          f"{plain.mean().item():.5f}")
    assert abs(m - r) <= 0.05 * r
    assert not torch.allclose(mega, plain)
