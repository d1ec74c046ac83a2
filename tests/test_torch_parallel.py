"""The sharded entry points (parallel/) against the JAX package's and
against one process's computation over the same shards.

Multi-rank worlds run on the CPU under gloo: `parallel.launch.run_world`
spawns 4 ranks, each on one PyTorch thread, rendezvousing through a
FileStore in the test's temporary directory, every wait bounded. One
world a layout (2x2, 4x1, 1x4) runs every job of that layout, and the
tests read its results. Exact checks hold each world against the same
shards computed in this process (on one thread too) with the same
derived generators: `_render_flat` for the render, the same loss
differentiated by autograd for the steps, so a gradient scaled by a group
size fails them. Statistical checks hold the port to the JAX tests'
bounds (tests/test_parallel.py), JAX on its 8 virtual CPU devices.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from raytracingproject_tpu import scene as jscene
from raytracingproject_tpu.camera import Camera as JCamera
from raytracingproject_tpu.parallel import make_mesh as jmake_mesh
from raytracingproject_tpu.parallel import render_sharded as jrender_sharded
from raytracingproject_tpu.parallel.shard import _pixel_grid as j_pixel_grid

from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.grad import (
    SceneParams, extract_params, make_fast_radiance, make_fast_radiance_twophase,
    make_fast_train_step, make_soft_train_step,
)
from raytracingproject_tpu_torch.parallel import (
    make_mesh, make_sharded_soft_train_step, make_sharded_train_step, multihost_init,
    render_sharded,
)
from raytracingproject_tpu_torch.parallel.launch import render_job, run_jobs, run_world, train_job
from raytracingproject_tpu_torch.parallel.shard import (
    _fast_shard, _oracle_shard, _pad_target, _pixel_grid, _render_flat, _soft_shard, draw_base,
    shard_generator,
)
from raytracingproject_tpu_torch.render import prepare_scene, render
from raytracingproject_tpu_torch.scene import make_minimal_scene, make_three_sphere_scene

CAM = dict(aspect_ratio=16.0 / 9.0, image_width=64, samples_per_pixel=16, max_depth=6,
           vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0), defocus_angle=0.0,
           focus_dist=1.0)  # tests/test_parallel.py's small_camera
ORACLE = RenderSettings(device="cpu", use_megakernel=False, use_bvh=False)
RENDER_SEED = 3
STEP_SEED = 11
# the exact steps' frame: 24x13 pixels pad to 13 pixels a ray shard
STEP_CAM = dict(CAM, image_width=24, samples_per_pixel=4, max_depth=6)
# one exact step of each kind: (name, soft, make_sharded_train_step's or the soft step's kwargs)
STEP_KINDS = (
    ("oracle", False, dict(spp=4)),
    ("fast", False, dict(spp=4, use_megakernel=True)),
    ("front", False, dict(spp=4, use_megakernel=True, trainable=("albedo", "fuzz", "ior"))),
    ("two_phase", False, dict(spp=4, use_megakernel=True, two_phase=2)),
    ("soft", True, dict(spp=4, softness=0.05, candidates_k=2)),
)
DESCENT_STEPS = 25


def cam(**kw):
    return Camera(**dict(CAM, **kw))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread in this process, as in every rank: the
    exact checks compare sums, and the first multi-threaded CPU op of a
    process can round one worker's share differently (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _front_scene():
    """The three-sphere scene in leaf order and its front (K3's plain
    version on the CPU)."""
    return prepare_scene(make_three_sphere_scene(), cam(), RenderSettings(device="cpu"))


def _step_scene(name):
    return _front_scene()[0] if name == "front" else make_three_sphere_scene()


def _step_kwargs(name, kwargs):
    return dict(kwargs, front=_front_scene()[1]) if name == "front" else kwargs


def _step_target():
    c = Camera(**STEP_CAM)
    return render(make_three_sphere_scene(), c, torch.Generator().manual_seed(2), ORACLE)


def _descent_problem():
    """tests/test_parallel.py's sharded descent: the minimal scene, sphere
    1's albedo to recover from a render of (0.9, 0.1, 0.1)."""
    scene = make_minimal_scene()
    true = dataclasses.replace(scene, albedo=scene.albedo.clone())
    true.albedo[1] = torch.tensor([0.9, 0.1, 0.1])
    c = cam(image_width=32, samples_per_pixel=8, max_depth=4)
    return scene, c, render(true, c, torch.Generator().manual_seed(4), ORACLE)


def _soft_problem():
    """tests/test_parallel.py's sharded soft descent: sphere 1 of the
    three-sphere scene moved by (0.15, -0.1, 0), its centre alone updated."""
    true = make_three_sphere_scene()
    wrong = dataclasses.replace(true, center0=true.center0.clone())
    wrong.center0[1] += torch.tensor([0.15, -0.1, 0.0])
    c = cam(image_width=48, samples_per_pixel=4, max_depth=3)
    target = render(true, c, torch.Generator().manual_seed(4), ORACLE)
    mask = SceneParams(*(torch.zeros_like(x) for x in extract_params(true)))
    mask.center0[1] = 1.0
    return true, wrong, c, target, mask


def _world(tmp_path_factory, samples_axis_size, jobs):
    store = tmp_path_factory.mktemp("world")
    return run_world(run_jobs, 4, str(store), samples_axis_size=samples_axis_size,
                     timeout_s=240.0, args=(jobs,))


@pytest.fixture(scope="module")
def world_2x2(tmp_path_factory):
    """Every job of the 2x2 layout: renders (oracle, megakernel, front),
    one step of each kind, the descents. Results a rank, in job order."""
    front_scene, front = _front_scene()
    jobs = [
        (render_job, (make_three_sphere_scene(), cam(samples_per_pixel=32), RENDER_SEED)),
        (render_job, (make_three_sphere_scene(), cam(image_width=32, samples_per_pixel=4),
                      RENDER_SEED, None, True)),
        (render_job, (front_scene, cam(image_width=32, samples_per_pixel=4), RENDER_SEED, None,
                      True, front)),
    ]
    target = _step_target()
    for name, soft, kwargs in STEP_KINDS:
        jobs.append((train_job, (_step_scene(name), Camera(**STEP_CAM), target, [STEP_SEED],
                                 soft, None, _step_kwargs(name, kwargs))))
    scene, c, tgt = _descent_problem()
    jobs.append((train_job, (scene, c, tgt, list(range(DESCENT_STEPS)), False, None,
                             dict(spp=8, learning_rate=5e-2, trainable=("albedo",)))))
    _, wrong, c, tgt, mask = _soft_problem()
    jobs.append((train_job, (wrong, c, tgt, list(range(100, 100 + DESCENT_STEPS)), True, mask,
                             dict(spp=4, learning_rate=3e-2, softness=0.05,
                                  trainable=("center0",), candidates_k=4))))
    return _world(tmp_path_factory, 2, jobs)


@pytest.fixture(scope="module")
def world_4x1(tmp_path_factory):
    return _world(tmp_path_factory, 1, [(render_job, (make_three_sphere_scene(),
                                                      cam(image_width=32, samples_per_pixel=4),
                                                      RENDER_SEED))])


@pytest.fixture(scope="module")
def world_1x4(tmp_path_factory):
    return _world(tmp_path_factory, 4, [(render_job, (make_three_sphere_scene(),
                                                      cam(image_width=32, samples_per_pixel=4),
                                                      RENDER_SEED))])


@pytest.fixture
def world_of_one():
    """This process's own gloo world of one (make_mesh starts it), taken
    down after the test."""
    yield make_mesh("cpu")
    dist.destroy_process_group()


def _flat_render(scene, camera, n_rays, n_samples, seed, use_megakernel=False, front=None):
    """The sharded render computed in this process: `_render_flat` over
    each shard's pixels with its derived generator, the samples summed
    in order, the ray shards concatenated."""
    w, h = camera.image_size()
    base = draw_base(torch.Generator().manual_seed(seed))
    i, j = _pixel_grid(w, h, n_rays)
    size = i.shape[0] // n_rays
    cd = camera.derive(torch.float32)
    parts = []
    for r in range(n_rays):
        sl = slice(r * size, (r + 1) * size)
        acc = None
        for s in range(n_samples):
            a = _render_flat(scene, cd, i[sl], j[sl], shard_generator(base, r, s, "cpu"),
                             max_depth=camera.max_depth,
                             spp_local=camera.samples_per_pixel // n_samples,
                             use_megakernel=use_megakernel, front=front)
            acc = a if acc is None else acc + a
        parts.append(acc)
    flat = torch.cat(parts)[: w * h].reshape(h, w, 3)
    return (flat / camera.samples_per_pixel).numpy()


def _images(world, job):
    return [rank[job]["image"] for rank in world]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture,shape", [("world_2x2", (2, 2)), ("world_4x1", (4, 1)),
                                           ("world_1x4", (1, 4))])
def test_mesh_factorization(request, fixture, shape):
    """Each rank's (ray_id, s_id) is divmod(rank, n_samples) on a
    (world // samples, samples) mesh, as JAX's reshape of the devices."""
    world = request.getfixturevalue(fixture)
    for rank, out in enumerate(world):
        assert out[0]["coords"] == (*divmod(rank, shape[1]), *shape)
    jmesh = jmake_mesh(samples_axis_size=shape[1] * 2)
    assert (jmesh.shape["rays"], jmesh.shape["samples"]) == (8 // (shape[1] * 2), shape[1] * 2)


def test_mesh_bad_factor_raises(world_of_one):
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh("cpu", samples_axis_size=2)
    with pytest.raises(ValueError):
        jmake_mesh(samples_axis_size=3)


def test_mesh_backend_and_multihost_init(world_of_one):
    """The world of one is gloo for the CPU; the card's NCCL is not taken
    in its place (nor the other way round), and multihost_init is a no-op
    on an existing group."""
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert world_of_one.shape == (1, 1)
    assert world_of_one.mesh_dim_names == ("rays", "samples")
    multihost_init(backend="nccl", world_size=99, rank=5)  # a no-op: the group exists
    assert dist.get_world_size() == 1
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="nccl"):
            make_mesh("cuda")
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make_mesh()  # the card by default, and there is none


@pytest.mark.parametrize("w,h,pad", [(64, 36, 4), (32, 18, 8), (24, 13, 2), (5, 3, 4)])
def test_pixel_grid_and_padded_target_equal_jax(w, h, pad):
    """`_pixel_grid` and the padded target bit-equal to the JAX package's
    (padding repeats pixel (0, 0) and its target)."""
    ji, jj = j_pixel_grid(w, h, pad)
    pi, pj = _pixel_grid(w, h, pad)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pj.numpy(), np.asarray(jj))
    target = np.random.default_rng(w * h).random((h, w, 3), dtype=np.float32)
    tf = jnp.asarray(target).reshape(-1, 3)
    n_pad = ji.shape[0] - tf.shape[0]
    want = jnp.concatenate([tf, jnp.broadcast_to(tf[0], (n_pad, 3))], axis=0)
    got = _pad_target(torch.from_numpy(target), pi.shape[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# render_sharded
# ---------------------------------------------------------------------------

def test_render_sharded_replicated_on_every_rank(world_2x2):
    imgs = _images(world_2x2, 0)
    assert imgs[0].shape == (36, 64, 3) and np.isfinite(imgs[0]).all()
    for img in imgs[1:]:
        np.testing.assert_array_equal(img, imgs[0])


@pytest.mark.parametrize("job,use_megakernel", [(0, False), (1, True), (2, True)])
def test_render_sharded_2x2_equals_render_flat(world_2x2, job, use_megakernel):
    """The 2x2 world (oracle; megakernel brute; megakernel with the
    front) equals this process's `_render_flat` over the same shards with
    the same derived generators, within 1e-6."""
    if job == 2:
        scene, front = _front_scene()
    else:
        scene, front = make_three_sphere_scene(), None
    c = cam(samples_per_pixel=32) if job == 0 else cam(image_width=32, samples_per_pixel=4)
    want = _flat_render(scene, c, 2, 2, RENDER_SEED, use_megakernel, front)
    np.testing.assert_allclose(_images(world_2x2, job)[0], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fixture,n_rays,n_samples", [("world_4x1", 4, 1), ("world_1x4", 1, 4)])
def test_render_sharded_other_layouts_equal_render_flat(request, fixture, n_rays, n_samples):
    world = request.getfixturevalue(fixture)
    want = _flat_render(make_three_sphere_scene(), cam(image_width=32, samples_per_pixel=4),
                        n_rays, n_samples, RENDER_SEED)
    for img in _images(world, 0):
        np.testing.assert_allclose(img, want, rtol=0, atol=1e-6)


def test_render_sharded_matches_jax_statistics(world_2x2):
    """The 2x2 world's render against JAX's render_sharded (its 8 devices
    as 4x2) on the three-sphere scene at 32 spp: tests/test_parallel.py's
    bounds (mean |diff| < 0.025, 99th percentile < 0.2)."""
    jc = JCamera(**dict(CAM, samples_per_pixel=32))
    want = np.asarray(jrender_sharded(jscene.make_three_sphere_scene(), jc,
                                      jax.random.PRNGKey(0), jmake_mesh(samples_axis_size=2)))
    diff = np.abs(_images(world_2x2, 0)[0] - want)
    assert diff.mean() < 0.025, diff.mean()
    assert np.quantile(diff, 0.99) < 0.2


def test_one_by_one_mesh_equals_render_flat_bit_for_bit(world_of_one):
    """On a 1x1 mesh render_sharded is `_render_flat` of the whole image,
    bit for bit (oracle and megakernel); equal seeds give equal images."""
    for c, mk in ((cam(image_width=32, samples_per_pixel=4), False),
                  (cam(image_width=32, samples_per_pixel=2), True)):
        got = render_sharded(make_three_sphere_scene(), c, torch.Generator().manual_seed(5),
                             world_of_one, use_megakernel=mk)
        want = _flat_render(make_three_sphere_scene(), c, 1, 1, 5, mk)
        np.testing.assert_array_equal(got.numpy(), want)
    again = render_sharded(make_three_sphere_scene(), c, torch.Generator().manual_seed(5),
                           world_of_one, use_megakernel=True)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_shard_generators_are_distinct_and_pure():
    """A shard's stream is a function of the base and its coordinates
    alone: equal for equal arguments, distinct across the mesh."""
    base = draw_base(torch.Generator().manual_seed(0))
    draws = {(r, s): torch.rand(4, generator=shard_generator(base, r, s, "cpu"))
             for r in range(4) for s in range(4)}
    again = torch.rand(4, generator=shard_generator(base, 2, 3, "cpu"))
    assert torch.equal(again, draws[(2, 3)])
    assert len({tuple(v.tolist()) for v in draws.values()}) == len(draws)
    other = torch.rand(4, generator=shard_generator(base + 1, 2, 3, "cpu"))
    assert not torch.equal(other, draws[(2, 3)])


# ---------------------------------------------------------------------------
# the sharded train steps
# ---------------------------------------------------------------------------

def _reference_step(name, soft, kwargs):
    """(loss, grads) of one sharded step computed in this process: each of
    the 2x2 shards' radiance with its derived generator, then the loss of
    the JAX definition differentiated by autograd."""
    scene, camera = _step_scene(name), Camera(**STEP_CAM)
    kwargs = _step_kwargs(name, kwargs)
    cd = camera.derive(torch.float32)
    depth, spp = camera.max_depth, kwargs["spp"]
    if soft:
        shard = _soft_shard(scene, cd, depth, kwargs["candidates_k"])
        extra = (kwargs["softness"],)
    elif not kwargs.get("use_megakernel"):
        shard, extra = _oracle_shard(scene, cd, depth), ()
    elif kwargs.get("two_phase"):
        shard = _fast_shard(make_fast_radiance_twophase(scene, depth, cut=kwargs["two_phase"]), cd)
        extra = ()
    else:
        shard, extra = _fast_shard(make_fast_radiance(scene, depth, front=kwargs.get("front")),
                                   cd), ()
    w, h = camera.image_size()
    i, j = _pixel_grid(w, h, 2)
    size = i.shape[0] // 2
    target = _pad_target(_step_target(), i.shape[0])
    base = draw_base(torch.Generator().manual_seed(STEP_SEED))
    params = SceneParams(*(x.detach().clone().requires_grad_(True)
                           for x in extract_params(scene)))
    sq = 0.0
    for r in range(2):
        sl = slice(r * size, (r + 1) * size)
        acc = sum(shard(params, shard_generator(base, r, s, "cpu"), i[sl], j[sl], spp // 2,
                        *extra) for s in range(2))
        sq = sq + torch.sum((acc / spp - target[sl]) ** 2)
    loss = sq / (w * h * 3)
    grads = torch.autograd.grad(loss, list(params), allow_unused=True)
    return float(loss.detach()), [np.zeros(p.shape, np.float32) if g is None else g.numpy()
                         for p, g in zip(params, grads)]


@pytest.mark.parametrize("k", range(len(STEP_KINDS)), ids=[s[0] for s in STEP_KINDS])
def test_sharded_step_2x2_equals_one_process(world_2x2, k):
    """Loss and gradients of one step on the 2x2 world equal, within 1e-5
    relative, the same loss over the same shards differentiated in one
    process (oracle, fast, fast with the front, two-phase, soft); every
    rank holds the same loss and gradients."""
    name, soft, kwargs = STEP_KINDS[k]
    outs = [rank[3 + k] for rank in world_2x2]
    for o in outs[1:]:
        assert o["loss"] == outs[0]["loss"]
        for a, b in zip(o["grads"][0], outs[0]["grads"][0]):
            np.testing.assert_array_equal(a, b)
    loss, grads = _reference_step(name, soft, kwargs)
    assert abs(outs[0]["loss"][0] - loss) <= 1e-5 * abs(loss), (outs[0]["loss"], loss)
    assert any(np.abs(g).max() > 0 for g in grads)
    for field, got, want in zip(SceneParams._fields, outs[0]["grads"][0], grads):
        err = np.linalg.norm(got - want)
        assert err <= 1e-5 * max(np.linalg.norm(want), 1e-12), (name, field, err,
                                                                 np.linalg.norm(want))


def test_sharded_train_step_runs_and_descends(world_2x2):
    """tests/test_parallel.py's descent on the 2x2 world: 25 steps, the
    loss falls, sphere 1's albedo moves to the red target (> 0.75, < 0.25),
    every gradient finite."""
    out = [rank[3 + len(STEP_KINDS)] for rank in world_2x2][0]
    losses = out["loss"]
    assert losses[-1] < losses[0], losses
    for g in out["grads"]:
        for name, leaf in g._asdict().items():
            assert np.isfinite(leaf).all(), name
    got = out["params"].albedo[1]
    assert got[0] > 0.75 and got[1] < 0.25, got


def test_sharded_soft_step_runs_and_descends(world_2x2):
    """tests/test_parallel.py's sharded soft descent on the 2x2 world:
    25 masked steps bring sphere 1's centre within 0.7 of the start's
    error."""
    true, _, _, _, _ = _soft_problem()
    out = [rank[4 + len(STEP_KINDS)] for rank in world_2x2][0]
    assert np.isfinite(out["loss"]).all()
    err0 = np.linalg.norm([0.15, -0.1, 0.0])
    err = np.linalg.norm(out["params"].center0[1] - true.center0[1].numpy())
    assert err < 0.7 * err0, (err, err0)


def test_one_by_one_fast_step_is_make_fast_train_step(world_of_one):
    """On a 1x1 mesh the sharded fast step (brute, and two-phase) is
    make_fast_train_step run on the shard's derived generator: same rays,
    same seed, loss and gradients within 1e-5 relative (the two take the
    sample mean and the pixel mean in other float32 orders)."""
    scene, c = make_three_sphere_scene(), Camera(**STEP_CAM)
    target = _step_target()
    for kw in (dict(), dict(two_phase=2)):
        p1, o1, sharded = make_sharded_train_step(scene, c, world_of_one, spp=4,
                                                  use_megakernel=True, **kw)
        p2, o2, plain = make_fast_train_step(scene, c, spp=4, device="cpu", **kw)
        _, _, loss1, g1 = sharded(p1, o1, torch.Generator().manual_seed(9), target)
        base = draw_base(torch.Generator().manual_seed(9))
        _, _, loss2, g2 = plain(p2, o2, shard_generator(base, 0, 0, "cpu"), target)
        assert abs(float(loss1) - float(loss2)) <= 1e-5 * float(loss2)
        for a, b in zip(g1, g2):
            assert float(torch.linalg.norm(a - b)) <= 1e-5 * max(float(torch.linalg.norm(b)),
                                                                 1e-12)


def test_one_by_one_soft_step_is_make_soft_train_step(world_of_one):
    """The same for the soft step: make_soft_train_step on the shard's
    generator, with a softness_t of its own."""
    true, wrong, c, target, _ = _soft_problem()
    p1, o1, sharded = make_sharded_soft_train_step(wrong, c, world_of_one, spp=4, softness=0.05,
                                                   candidates_k=4)
    p2, o2, plain = make_soft_train_step(wrong, c, spp=4, softness=0.05, candidates_k=4,
                                         device="cpu")
    _, _, loss1, g1 = sharded(p1, o1, torch.Generator().manual_seed(3), target, 0.03)
    base = draw_base(torch.Generator().manual_seed(3))
    _, _, loss2, g2 = plain(p2, o2, shard_generator(base, 0, 0, "cpu"), target, 0.03)
    assert abs(float(loss1) - float(loss2)) <= 1e-5 * float(loss2)
    for a, b in zip(g1, g2):
        assert float(torch.linalg.norm(a - b)) <= 1e-5 * max(float(torch.linalg.norm(b)), 1e-12)


def test_front_with_trainable_geometry_raises(world_of_one):
    scene, front = _front_scene()
    with pytest.raises(ValueError, match="FIXED geometry"):
        make_sharded_train_step(scene, cam(), world_of_one, use_megakernel=True, front=front)


def test_run_world_reports_a_failed_rank(tmp_path):
    """A rank that raises fails the call with its traceback (here the JAX
    package's error for spp the samples axis does not divide)."""
    with pytest.raises(RuntimeError, match="(?s)rank .* failed.*not divisible by samples"):
        run_world(render_job, 2, str(tmp_path), samples_axis_size=2, timeout_s=60.0,
                  args=(make_three_sphere_scene(), cam(image_width=8, samples_per_pixel=3), 0))
