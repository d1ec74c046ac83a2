"""K4's plain PyTorch version (ops/cuda/trace.py) against the JAX package's
Pallas kernel in interpret mode and against the port's own closest_hit, on
the cases of tests/test_pallas_trace.py plus a ragged ray count and a scene
larger than one of the kernel's shared-memory chunks. The CUDA kernel
itself is held against this plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracingproject_tpu import scene as jscene
from raytracingproject_tpu.ops.pallas.trace import pallas_closest_hit as jpallas_closest_hit

from raytracingproject_tpu_torch.ops import intersect as pint
from raytracingproject_tpu_torch.ops.cuda import trace as ptrace
from test_torch_megakernel import _port_scene


def _random_rays(m, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-8, 8, (m, 3)).astype(np.float32),
            rng.normal(size=(m, 3)).astype(np.float32), rng.random(m).astype(np.float32))


CASES = {  # scene, rays: test_pallas_trace.py's two, its padding case, one past a chunk
    "three-300": (jscene.make_three_sphere_scene, 300),
    "cover-512": (lambda: jscene.make_cover_scene(0), 512),
    "three-77": (jscene.make_three_sphere_scene, 77),
    "random1100-77": (lambda: jscene.make_random_scene(1100, seed=3), 77),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_twin_matches_pallas_interpret(case):
    """Hit mask equal; t within 4e-4 (absolute + relative: XLA contracts
    the interpreted kernel's products into FMAs, PyTorch rounds each one;
    measured 2.0e-4 on the cover scene's ground sphere, <= 1e-6 on the
    three-sphere scene), far inside the JAX test's own 5e-3 / 1e-3; idx
    equal but for near-ties; p within 4e-4 and the normal within 1e-3.
    Also against the port's differentiable closest_hit on the same rays,
    which rounds as the plain version does (1e-5)."""
    make, m = CASES[case]
    js = make()
    o, d, t = _random_rays(m, 0 if m != 77 else 1)
    ref = jpallas_closest_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), js,
                              interpret=True)
    ps = _port_scene(js)
    # the kernel stages 1,024 spheres at a time: this case needs a second chunk
    assert ps.num_spheres > 1024 or not case.startswith("random1100")
    po, pd, pt = (torch.from_numpy(x) for x in (o, d, t))
    got = ptrace.pallas_closest_hit(po, pd, pt, ps)
    assert got.t.shape == (m,) and got.idx.dtype == torch.int32
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert hit.any() and (got.idx.numpy()[~hit] == 0).all()
    t_ref, t_got = np.asarray(ref.t)[hit], got.t.numpy()[hit]
    print(case, "max rel t diff", (np.abs(t_got - t_ref) / np.abs(t_ref)).max())
    np.testing.assert_allclose(t_got, t_ref, rtol=4e-4, atol=4e-4)
    same = got.idx.numpy()[hit] == np.asarray(ref.idx)[hit]
    assert np.all(same | (np.abs(t_got - t_ref) <= 4e-4 * (1 + np.abs(t_ref))))
    for f, tol in (("p", 4e-4), ("normal", 1e-3)):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit][same],
                                   np.asarray(getattr(ref, f))[hit][same], rtol=tol, atol=tol)

    own = pint.closest_hit(po, pd, pt, ps.center0, ps.center_delta, ps.radius)
    assert torch.equal(own.hit, got.hit)
    same = (own.idx == got.idx)[own.hit]
    tie = (torch.abs(own.t - got.t) <= 1e-5 * torch.abs(own.t))[own.hit]
    assert bool((same | tie).all())
    np.testing.assert_allclose(own.t[own.hit].numpy(), t_got, rtol=1e-5, atol=1e-6)


def test_fused_twin_chunks_do_not_change_the_scan():
    """Scanning in sphere chunks (the kernel's shared-memory chunks) with a
    strict `<` across chunks equals the one-chunk scan bit for bit: the
    first of equal minima wins either way."""
    ps = _port_scene(jscene.make_cover_scene(0))
    o, d, t = (torch.from_numpy(x) for x in _random_rays(400, 3))
    tab = ptrace.sphere_table(ps)
    assert tab.shape == (8, ps.num_spheres) and bool((tab[7] == 0).all())
    # duplicate the first 100 spheres at the end: exact ties across chunks
    tab = torch.cat([tab, tab[:, :100]], dim=1)
    whole = ptrace.closest_hit_fused_twin(o, d, t, tab, sphere_chunk=1 << 20)
    for chunk in (64, 100, 487):
        part = ptrace.closest_hit_fused_twin(o, d, t, tab, sphere_chunk=chunk)
        assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])
    assert int(whole[1].max()) < ps.num_spheres  # a duplicate never wins its tie


def test_wrapper_takes_cpu_and_refuses_other_devices():
    """CPU tensors run the plain version and count no launch; a tensor that
    is on neither the CPU nor a card raises; t and idx carry no gradient."""
    ps = _port_scene(jscene.make_three_sphere_scene())
    o, d, t = (torch.from_numpy(x) for x in _random_rays(16, 2))
    before = dict(ptrace.LAUNCHES)
    radius = ps.radius.clone().requires_grad_(True)
    rec = ptrace.pallas_closest_hit(o, d, t, dataclasses.replace(ps, radius=radius))
    assert ptrace.LAUNCHES == before
    assert not rec.t.requires_grad and not rec.p.requires_grad
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ptrace.closest_hit_fused(meta, meta, torch.zeros(4, device="meta"),
                                 torch.zeros((8, 2), device="meta"))
    ptrace.LAUNCHES["closest_hit"] = 5
    ptrace.reset_launches()
    assert ptrace.LAUNCHES == {"closest_hit": 0}


@pytest.mark.parametrize("warp", [32, 8])
def test_disc_counts_equal_a_pair_by_pair_count(warp):
    """`trace.disc_counts`, the count behind K4's sizing (pairs whose
    discriminant is positive, and (warp, sphere) pairs in which some ray's
    is), against a count pair by pair in float32 numpy with the plain
    version's operations, on 70 rays (a ragged last warp) over the cover
    scene's first 40 spheres, half the rays aimed at a sphere."""
    ps = _port_scene(jscene.make_cover_scene(0))
    tab = ptrace.sphere_table(ps)[:, :40].contiguous()
    rng = np.random.default_rng(9)
    o = rng.uniform(-8, 8, (70, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 3.0, 70)
    t = rng.random(70).astype(np.float32)
    d = rng.normal(size=(70, 3)).astype(np.float32)
    tn = tab.numpy()
    aim = rng.integers(0, 40, 35)
    d[:35] = (tn[0:3, aim] + t[:35] * tn[3:6, aim]).T - o[:35]
    f = np.float32
    pos = np.zeros((70, 40), bool)
    for i in range(70):
        a = max(d[i, 0] * d[i, 0] + d[i, 1] * d[i, 1] + d[i, 2] * d[i, 2], f(1e-20))
        for s in range(40):
            oc = [o[i, k] - (tn[k, s] + t[i] * tn[3 + k, s]) for k in range(3)]
            half_b = oc[0] * d[i, 0] + oc[1] * d[i, 1] + oc[2] * d[i, 2]
            cq = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - tn[6, s] * tn[6, s]
            pos[i, s] = half_b * half_b - a * cq > f(0.0)
    warps = -(-70 // warp)
    padded = np.concatenate([pos, np.zeros((warps * warp - 70, 40), bool)])
    want = {"pairs": 70 * 40, "roots": int(pos.sum()), "warps": warps * 40,
            "warp_roots": int(padded.reshape(warps, warp, 40).any(axis=1).sum())}
    got = ptrace.disc_counts(*(torch.from_numpy(x) for x in (o, d, t)), tab, warp=warp)
    assert got == want
    assert 0 < want["warp_roots"] < want["warps"] and want["roots"] >= 35
