"""The replay's one divergence from the JAX package (grad/replay.py,
`_finite_cotangent`): at every bounce the backward zeroes the elements of
a ray's cotangent of its gathered sphere attributes that are not finite.

The fixture `data/wedge_path.npz` is one recorded path of the cover
scene's four-card materials fit at 1200x675 (seed 3141592711, step 2,
rank 1, two-phase cut 4: the ray whose float32 replay on the card gave
NaN fuzz and ior gradients), with the spheres it touches alone: it
crosses a glass sphere, then bounces eighteen times between a small
metal sphere and the ground near their contact. In float64 the port's
replay and the JAX replay agree on a fuzz gradient of about 1e54, past
float32's range: in float32 the cotangents overflow to +inf and -inf and
their sum is NaN (on the card; this CPU's float32 rounds the chain
otherwise). The rule's tests feed such a non-finite cotangent in: the
port's replay and the JAX replay give NaN without the rule, the port's
is finite with it, and the benchmark's plain sharded reference follows
the same rule. On sound batches the rule changes no bit. CPU only."""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu.grad.inverse import SceneParams as JSceneParams
from raytracingproject_tpu.grad.replay import PathResiduals as JPathResiduals
from raytracingproject_tpu.grad.replay import replay_radiance as jreplay
from raytracingproject_tpu.scene import Scene as JScene

from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.grad import (
    SceneParams, extract_params, make_fast_radiance, make_fast_radiance_twophase,
)
from raytracingproject_tpu_torch.grad import replay
from raytracingproject_tpu_torch.scene import Scene, make_cover_scene

FIXTURE = Path(__file__).parent / "data" / "wedge_path.npz"
FIELDS = SceneParams._fields
TRAINED = ("albedo", "fuzz", "ior")
FLOAT32_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_rule(monkeypatch):
    """The replay as the JAX package has it: no cotangent is zeroed."""
    monkeypatch.setattr(replay, "_finite_cotangent", lambda x: None)


def wedge(dtype=np.float32) -> dict:
    with np.load(FIXTURE) as z:
        return {k: (z[k].astype(dtype) if z[k].dtype.kind == "f" else z[k]) for k in z.files}


def port_grads(z: dict) -> dict:
    """The port's replay gradient of the path's loss weight, by leaf."""
    dtype = torch.from_numpy(z["origin"]).dtype
    scene = Scene(mat_type=torch.from_numpy(z["mat_type"]),
                  **{f: torch.from_numpy(z[f]) for f in FIELDS})
    leaves = SceneParams(*(getattr(scene, f).clone().requires_grad_(f in TRAINED)
                           for f in FIELDS))
    res = replay.PathResiduals(torch.from_numpy(z["idx"]), torch.from_numpy(z["ndir"]),
                               torch.from_numpy(z["refl"]))
    rad = replay.replay_radiance(leaves, scene, torch.from_numpy(z["origin"]),
                                 torch.from_numpy(z["direction"]), torch.from_numpy(z["time"]),
                                 res)
    got = torch.autograd.grad((rad * torch.from_numpy(z["cot"]).to(dtype)).sum(),
                              [getattr(leaves, f) for f in TRAINED])
    return {f: g.double().numpy() for f, g in zip(TRAINED, got)}


def jax_grads(z: dict) -> dict:
    """The JAX package's replay gradient of the same, by leaf."""
    p = {f: jnp.asarray(z[f]) for f in FIELDS}
    scene = JScene(mat_type=jnp.asarray(z["mat_type"]), **p)
    res = JPathResiduals(jnp.asarray(z["idx"]), jnp.asarray(z["ndir"]), jnp.asarray(z["refl"]))

    def loss(mats):
        params = JSceneParams(p["center0"], p["center_delta"], p["radius"], *mats)
        rad = jreplay(params, scene, jnp.asarray(z["origin"]), jnp.asarray(z["direction"]),
                      jnp.asarray(z["time"]), res)
        return jnp.sum(rad * jnp.asarray(z["cot"]))

    got = jax.grad(loss)(tuple(p[f] for f in TRAINED))
    return {f: np.asarray(g, np.float64) for f, g in zip(TRAINED, got)}


def overflowed(z: dict) -> dict:
    """The path with its first channel's cotangent at +inf, as float32's
    overflow leaves it a few bounces from the path's end."""
    z = dict(z)
    z["cot"] = z["cot"].copy()
    z["cot"][..., 0] = np.inf
    return z


def test_float64_replays_agree_past_float32_range(no_rule):
    """float64: the port's replay and the JAX package's agree on the
    path's gradients, and its fuzz gradient lies past float32's range (the
    fault is the estimator's, shared by both)."""
    z = wedge(np.float64)
    with jax.enable_x64(True):
        want = jax_grads(z)
    got = port_grads(z)
    assert np.abs(got["fuzz"]).max() > FLOAT32_MAX and np.abs(got["ior"]).max() > 1e40
    for f in TRAINED:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-6, atol=0.0)


def test_without_the_rule_both_replays_give_nan(no_rule):
    """float32, the rule off: a non-finite cotangent reaches the
    parameters as NaN, in the port's replay and in the JAX package's."""
    z = overflowed(wedge())
    for grads in (port_grads(z), jax_grads(z)):
        assert np.isnan(grads["fuzz"]).any() and np.isnan(grads["ior"]).any()


def test_rule_keeps_the_gradients_finite():
    """float32 with the rule: every gradient is finite; with a finite
    cotangent the rule changes no bit of the path's gradients."""
    z = wedge()
    assert all(np.isfinite(g).all() for g in port_grads(overflowed(z)).values())
    got = port_grads(z)
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(replay, "_finite_cotangent", lambda x: None)
        bare = port_grads(z)
    for f in TRAINED:
        np.testing.assert_array_equal(got[f], bare[f])


def test_reference_follows_the_same_rule():
    """The benchmark's plain sharded reference traces the same ray with its
    own differentiable loop and draws (the recorded path seed and ray
    slot): with the non-finite cotangent its gradients are NaN without the
    rule and finite with it (`FiniteGathers`), and with a finite one the
    rule changes no bit."""
    from portbench.reference import trace
    from portbench.reference.sharded_fit import FiniteGathers

    z = wedge()
    sc = trace.scene_on({f: z[f] for f in (*FIELDS, "mat_type")}, "cpu")
    slot = torch.as_tensor(z["slot"], dtype=torch.int64).reshape(1)

    def grads(cot, guarded: bool):
        leaves = {f: sc[f].clone().requires_grad_(True) for f in TRAINED}
        mats = tuple(FiniteGathers(leaves[f]) if guarded else leaves[f] for f in TRAINED)
        rad = trace.radiance(sc, torch.from_numpy(z["origin"]), torch.from_numpy(z["direction"]),
                             torch.from_numpy(z["time"]), slot, int(z["seed"]),
                             z["idx"].shape[0], mats=mats)
        return torch.autograd.grad((rad * torch.from_numpy(cot)).sum(), list(leaves.values()))

    inf_cot = overflowed(z)["cot"]
    assert any(bool(torch.isnan(g).any()) for g in grads(inf_cot, False))
    assert all(bool(torch.isfinite(g).all()) for g in grads(inf_cot, True))
    for a, b in zip(grads(z["cot"], True), grads(z["cot"], False)):
        assert torch.equal(a, b)


def _cover_batch():
    """A sound batch: 256 camera rays of the cover scene, seeded."""
    cam = Camera(aspect_ratio=16 / 9, image_width=32, samples_per_pixel=1, max_depth=8,
                 vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                 defocus_angle=0.6, focus_dist=10.0)
    scene = make_cover_scene(3)
    cd = cam.derive(torch.float32)
    g = torch.Generator().manual_seed(5)
    i = torch.randint(0, 32, (256,), generator=g, dtype=torch.int32)
    j = torch.randint(0, 18, (256,), generator=g, dtype=torch.int32)
    from raytracingproject_tpu_torch.camera import generate_rays

    o, d, t = generate_rays(cd, i, j, g)
    return scene, o, d, t, torch.rand((256, 3), generator=g)


@pytest.mark.parametrize("two_phase", [False, True])
def test_sound_batch_is_bit_unchanged(two_phase):
    """On a sound batch (every cotangent finite) the rule changes no bit
    of any leaf's gradient, through the monolithic replay and the
    two-phase one."""
    scene, o, d, t, w = _cover_batch()
    make = (lambda: make_fast_radiance_twophase(scene, 8, cut=3)) if two_phase else (
        lambda: make_fast_radiance(scene, 8))

    def grads():
        params = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
        rad = make()(params, o, d, t, 1234)
        return torch.autograd.grad((rad * w).sum(), list(params))

    got = grads()
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(replay, "_finite_cotangent", lambda x: None)
        bare = grads()
    assert all(torch.isfinite(g).all() for g in bare)
    for a, b in zip(got, bare):
        assert torch.equal(a, b)



def _batch_grads(two_phase: bool, unit_dir=None):
    """The cover batch's replay gradients, by leaf; with `unit_dir`, the
    replay's unit direction taken through it."""
    scene, o, d, t, w = _cover_batch()
    radiance = (make_fast_radiance_twophase(scene, 8, cut=3) if two_phase
                else make_fast_radiance(scene, 8))
    params = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        if unit_dir is not None:
            m.setattr(replay, "_UnitDir", unit_dir)
        rad = radiance(params, o, d, t, 1234)
        return torch.autograd.grad((rad * w).sum(), list(params))


class _InlineUnitDir:
    """The unit direction as plain autograd differentiates it."""
    apply = staticmethod(replay._unit_dir)


@pytest.mark.parametrize("two_phase", [False, True])
def test_unit_dir_gives_the_plain_chain_bits(two_phase):
    """The replay's unit direction (`_UnitDir`, which works its chain out
    again in the backward) gives every leaf's gradient bit for bit as the
    chain under plain autograd does."""
    got = _batch_grads(two_phase)
    plain = _batch_grads(two_phase, _InlineUnitDir)
    assert any(bool(g.abs().sum() > 0) for g in plain)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_unit_dir_keeps_less_for_the_backward():
    """A replay's graph (the cover batch's recorded paths) keeps fewer
    bytes for its backward with `_UnitDir` than with the chain under plain
    autograd, which keeps the length's square, its square root, its
    reciprocal and that times 1: four float32 values a ray a live bounce
    past the first (whose direction, the camera's, no parameter moves)."""
    scene, o, d, t, _ = _cover_batch()
    _, res = replay.xla_trace_record(scene, o, d, t, torch.Generator().manual_seed(9), 8)
    live = replay._live_depth(res.idx)

    def kept(unit_dir) -> int:
        params = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
        held = []  # every packed tensor kept alive, so that no storage's address is reused

        def pack(x):
            held.append(x)
            return x

        mp = pytest.MonkeyPatch()
        with mp.context() as m, torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            if unit_dir is not None:
                m.setattr(replay, "_UnitDir", unit_dir)
            replay.replay_radiance(params, scene, o, d, t, res)
        return sum({x.untyped_storage().data_ptr(): x.untyped_storage().nbytes()
                    for x in held}.values())

    assert live >= 2
    assert kept(_InlineUnitDir) - kept(None) == 4 * 4 * o.shape[0] * (live - 1)
