"""The port's CUDA kernels on the card, held against their plain PyTorch
versions. Every test here needs an NVIDIA card: it carries the `cuda`
marker and skips when torch.cuda.is_available() is false. This file
imports no jax, so it also runs where only PyTorch is installed:

    RTP_BACKEND=cuda python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk
from raytracingproject_tpu_torch.ops.rng import bounce_bits
from raytracingproject_tpu_torch.render import _slot_rays, prepare_scene, render_image
from raytracingproject_tpu_torch.scene import make_cover_scene

pytestmark = pytest.mark.cuda

# The launch counter of each path: every brute scan runs the chunked kernel.
KEY = {"brute": "brute_chunked", "front": "front"}

COVER = dict(aspect_ratio=16.0 / 9.0, image_width=160, samples_per_pixel=1, max_depth=16,
             vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
             defocus_angle=0.6, focus_dist=10.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cover_rays(device):
    camera = Camera(**COVER)
    settings = RenderSettings(device=device)
    scene, front = prepare_scene(make_cover_scene(0), camera, settings)
    w, h = camera.image_size()
    gen = torch.Generator(device=device).manual_seed(5)
    rays = _slot_rays(camera.derive(torch.float32, device), w, h, 1, gen, None)
    return scene, front, rays


@pytest.mark.parametrize("path", ["brute", "front"])
@pytest.mark.parametrize("zero_draws", [True, False])
def test_kernel_matches_twin(cuda_device, path, zero_draws):
    """At least 99.9% of rays within 1e-3 and a mean difference below 1e-5
    (built without FMA contraction, the two should agree exactly except
    on ties)."""
    scene, front, (o, d, t) = _cover_rays(cuda_device)
    f = front if path == "front" else None
    before = mk.LAUNCHES[KEY[path]]
    k = mk.trace_paths(o, d, t, scene, 4242, 16, front=f, zero_draws=zero_draws)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[KEY[path]] == before + 1
    p = mk.trace_paths_twin(o, d, t, scene, 4242, 16, front=f, zero_draws=zero_draws)
    diff = torch.abs(k - p)
    assert torch.isfinite(k).all()
    assert (diff <= 1e-3).all(dim=1).double().mean().item() >= 0.999
    assert diff.mean().item() < 1e-5


@pytest.mark.parametrize("path", ["brute", "front"])
@pytest.mark.parametrize("zero_draws", [True, False])
def test_record_kernel_matches_twin(cuda_device, path, zero_draws):
    """K5 against its plain version: radiance bit-equal to the forward
    kernel's (recording changes no value) and within the forward's bounds
    of the twin's; residual idx equal on >= 99.9% of entries, ndir and
    refl equal wherever idx is."""
    scene, front, (o, d, t) = _cover_rays(cuda_device)
    f = front if path == "front" else None
    key = f"record_{KEY[path]}"
    before = mk.LAUNCHES[key]
    rad, res = mk.trace_record(o, d, t, scene, 4242, 16, front=f, zero_draws=zero_draws)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[key] == before + 1
    assert torch.equal(rad, mk.trace_paths(o, d, t, scene, 4242, 16, front=f,
                                           zero_draws=zero_draws))
    prad, pres = mk.trace_record_twin(o, d, t, scene, 4242, 16, front=f, zero_draws=zero_draws)
    diff = torch.abs(rad - prad)
    assert (diff <= 1e-3).all(dim=1).double().mean().item() >= 0.999
    assert diff.mean().item() < 1e-5
    eq = res.idx == pres.idx
    assert eq.double().mean().item() >= 0.999
    assert torch.equal(res.ndir[eq], pres.ndir[eq])
    assert torch.equal(res.refl[eq], pres.refl[eq])
    assert res.idx.shape == (16, o.shape[0]) and res.ndir.shape == (16, o.shape[0], 3)


def test_fast_radiance_kernel_gradients_match_twin(cuda_device):
    """The fast radiance with the recording kernel forward and with its
    plain version forward, both on the card, give the same gradients
    (relative norm 1e-5 per field). index_add_ on the card sums in no fixed
    order, which alone moves a field of cancelling terms (ior) by up to
    1e-4 between two runs of one forward, so both run with PyTorch's
    deterministic algorithms."""
    from raytracingproject_tpu_torch.grad import SceneParams, extract_params, make_fast_radiance

    scene, _, (o, d, t) = _cover_rays(cuda_device)
    w = torch.rand((o.shape[0], 3), generator=torch.Generator(device=cuda_device).manual_seed(2),
                   device=cuda_device)
    grads = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for tracer in (mk.trace_record, mk.trace_record_twin):
            pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
            rad = make_fast_radiance(scene, 8, tracer=tracer)(pp, o, d, t, 99)
            grads.append(torch.autograd.grad((rad * w).sum(), list(pp)))
    finally:
        torch.use_deterministic_algorithms(False)
    for name, a, b in zip(SceneParams._fields, *grads):
        a, b = a.double(), b.double()
        rel = (torch.linalg.norm(a - b) / (torch.linalg.norm(b) + 1e-6)).item()
        assert rel <= 1e-5, (name, rel)


def test_front_kernel_matches_brute_kernel(cuda_device):
    scene, front, (o, d, t) = _cover_rays(cuda_device)
    b = mk.trace_paths(o, d, t, scene, 17, 16)
    f = mk.trace_paths(o, d, t, scene, 17, 16, front=front)
    differ = (torch.abs(b - f) > 1e-3).any(dim=1).double().mean().item()
    assert differ <= 1e-3


def test_philox_kernel_matches_spec(cuda_device):
    n = 4096
    for bounce in (0, 1, 49):
        got = mk.philox_bits(n, 77, bounce, cuda_device).cpu()
        want = torch.stack(bounce_bits(77, torch.arange(n, dtype=torch.int64), bounce), dim=1)
        assert torch.equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    scene, front, (o, d, t) = _cover_rays(cuda_device)
    with pytest.raises(ValueError):
        mk.trace_paths(o.double(), d, t, scene, 1, 4)
    with pytest.raises(ValueError):
        mk.trace_paths(o, d[:, :2], t, scene, 1, 4)
    with pytest.raises(ValueError):
        mk.trace_paths(o, d, t, scene, 1, 4, front=front.to("cpu"))


def test_render_image_goes_through_the_kernels(cuda_device):
    camera = Camera(**dict(COVER, samples_per_pixel=2, max_depth=8))
    mk.reset_launches()
    img = render_image(make_cover_scene(0), camera, settings=RenderSettings(device="cuda"))
    img_b = render_image(make_cover_scene(0), camera,
                         settings=RenderSettings(device="cuda", use_bvh=False))
    assert mk.LAUNCHES["front"] > 0 and mk.LAUNCHES["brute_chunked"] > 0
    assert img.shape == (90, 160, 3) and img.dtype == torch.uint8
    assert abs(img.float().mean().item() - img_b.float().mean().item()) < 1.0


@pytest.mark.parametrize("n_rays,n_spheres", [(160 * 90, None), (77, None), (5000, 2500)])
def test_closest_hit_kernel_matches_twin(cuda_device, n_rays, n_spheres):
    """K4 against its plain version: the cover scene at a whole pass and at
    a ray count that fills no block, and a moving-sphere scene of more than
    two shared-memory chunks. Hit mask equal, idx equal on >= 99.9% of
    hits, t within 1e-6 relative (built without FMA contraction in the
    plain version's operation order, they should be bit-equal)."""
    from raytracingproject_tpu_torch.ops.cuda import trace
    from raytracingproject_tpu_torch.scene import make_random_scene

    if n_spheres is None:
        scene, _, (o, d, t) = _cover_rays(cuda_device)
        pick = torch.linspace(0, o.shape[0] - 1, n_rays, device=cuda_device).long()  # sky and ground
        o, d, t = (x[pick].contiguous() for x in (o, d, t))
    else:
        scene = make_random_scene(n_spheres, seed=2, device=cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(6)
        o = torch.rand((n_rays, 3), generator=gen, device=cuda_device) * 16.0 - 8.0
        d = torch.randn((n_rays, 3), generator=gen, device=cuda_device)
        t = torch.rand((n_rays,), generator=gen, device=cuda_device)
    tab = trace.sphere_table(scene)
    before = trace.LAUNCHES["closest_hit"]
    kt, ki = trace.closest_hit_fused(o, d, t, tab)
    torch.cuda.synchronize()
    assert trace.LAUNCHES["closest_hit"] == before + 1
    pt, pi = trace.closest_hit_fused_twin(o, d, t, tab)
    hit = torch.isfinite(pt)
    assert torch.equal(torch.isfinite(kt), hit) and hit.any() and not hit.all()
    assert (ki == pi)[hit].double().mean().item() >= 0.999
    assert torch.all(torch.abs(kt - pt)[hit] <= 1e-6 * torch.abs(pt)[hit])
    assert ki.dtype == torch.int32 and bool((ki[~hit] == 0).all())


@pytest.mark.parametrize("n_rays", [77, 4099])
@pytest.mark.parametrize("n_spheres", [1023, 1024, 1025, 3000])
def test_closest_hit_kernel_is_bit_equal_at_chunk_edges(cuda_device, n_rays, n_spheres):
    """K4 bit-equal to its plain version (t and idx, `torch.equal`) at ray
    counts that fill no block and at sphere counts around the
    shared-memory chunks' edges (256 spheres a chunk), with rays from
    inside the scene, half aimed at a sphere so that every warp takes
    roots somewhere; a sphere copied to the table's end ties its first."""
    from raytracingproject_tpu_torch.ops.cuda import trace
    from raytracingproject_tpu_torch.scene import make_random_scene

    scene = make_random_scene(n_spheres - 1, seed=n_spheres, device=cuda_device)
    tab = trace.sphere_table(scene)
    tab = torch.cat([tab, tab[:, :1]], dim=1).contiguous()  # an exact tie across chunks
    gen = torch.Generator(device=cuda_device).manual_seed(n_rays)
    o = torch.rand((n_rays, 3), generator=gen, device=cuda_device) * 16.0 - 8.0
    o[:, 1] = o[:, 1].abs() * 0.25 + 0.5
    t = torch.rand((n_rays,), generator=gen, device=cuda_device)
    d = torch.randn((n_rays, 3), generator=gen, device=cuda_device)
    aim = torch.randint(0, n_spheres, (n_rays // 2,), generator=gen, device=cuda_device)
    aim[0] = 0
    d[:n_rays // 2] = (tab[0:3, aim] + t[:n_rays // 2] * tab[3:6, aim]).t() - o[:n_rays // 2]
    before = trace.LAUNCHES["closest_hit"]
    kt, ki = trace.closest_hit_fused(o, d, t, tab)
    torch.cuda.synchronize()
    assert trace.LAUNCHES["closest_hit"] == before + 1
    pt, pi = trace.closest_hit_fused_twin(o, d, t, tab)
    assert torch.equal(kt, pt) and torch.equal(ki, pi)
    hit = torch.isfinite(pt)
    assert hit.any() and not hit.all() and bool((pi < n_spheres - 1).all())


def test_closest_hit_wrapper_rejects_and_records(cuda_device):
    """The wrapper raises on what the kernel does not take, and
    pallas_closest_hit rebuilds the record of ops.intersect.closest_hit
    (ties aside) without a gradient."""
    from raytracingproject_tpu_torch.ops.cuda import trace
    from raytracingproject_tpu_torch.ops.intersect import closest_hit

    scene, _, (o, d, t) = _cover_rays(cuda_device)
    tab = trace.sphere_table(scene)
    with pytest.raises(ValueError):
        trace.closest_hit_fused(o.double(), d, t, tab)
    with pytest.raises(ValueError):
        trace.closest_hit_fused(o, d[:, :2], t, tab)
    with pytest.raises(ValueError):
        trace.closest_hit_fused(o, d, t, tab.cpu())
    with pytest.raises(ValueError):
        trace.closest_hit_fused(o, d, t, tab[:7])
    rec = trace.pallas_closest_hit(o, d, t, scene)
    ref = closest_hit(o, d, t, scene.center0, scene.center_delta, scene.radius)
    assert not rec.t.requires_grad and torch.equal(rec.hit, ref.hit)
    same = (rec.idx == ref.idx) & ref.hit
    assert same.double().sum().item() >= 0.999 * ref.hit.double().sum().item()
    assert torch.allclose(rec.t[same], ref.t[same], rtol=1e-6)
    assert torch.allclose(rec.normal[same], ref.normal[same], atol=1e-5)


def test_oracle_render_goes_through_the_closest_hit_kernel(cuda_device):
    """render() on the oracle loop with use_pallas launches K4 once a
    bounce, and from an equal seed gives the brute loop's image (>= 99.5%
    of pixels within 1e-4)."""
    from raytracingproject_tpu_torch.ops.cuda import trace
    from raytracingproject_tpu_torch.render import render

    camera = Camera(**dict(COVER, samples_per_pixel=2, max_depth=8))
    kw = dict(device="cuda", use_megakernel=False, use_bvh=False)
    trace.reset_launches()
    gen = lambda: torch.Generator(device="cuda").manual_seed(3)  # noqa: E731
    img = render(make_cover_scene(0), camera, gen(), RenderSettings(use_pallas=True, **kw))
    assert 0 < trace.LAUNCHES["closest_hit"] <= 2 * 8
    ref = render(make_cover_scene(0), camera, gen(), RenderSettings(**kw))
    assert img.shape == (90, 160, 3) and torch.isfinite(img).all()
    assert (torch.abs(img - ref) <= 1e-4).all(dim=-1).double().mean().item() >= 0.995


@pytest.mark.parametrize("which", ["oracle", "fast"])
def test_train_steps_run_on_the_card_by_default(cuda_device, which):
    """A scene built on the CPU and no `device`: the train step moves it to
    the card, as `render` does, and a step with a CPU target runs there."""
    from raytracingproject_tpu_torch.grad import make_fast_train_step, make_train_step
    from raytracingproject_tpu_torch.scene import make_three_sphere_scene

    make = make_train_step if which == "oracle" else make_fast_train_step
    camera = Camera(aspect_ratio=16.0 / 9.0, image_width=32, samples_per_pixel=2, max_depth=4,
                    vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0))
    scene = make_three_sphere_scene()
    assert scene.device.type == "cpu"
    params, opt, step = make(scene, camera, spp=2, trainable=("albedo",))
    assert params.albedo.is_cuda
    params, opt, loss, grads = step(params, opt, None, torch.full((18, 32, 3), 0.5))
    assert loss.is_cuda and torch.isfinite(loss) and grads.albedo.is_cuda


# ---- large scenes: chunked brute, K8, K5 bvh, K7 ----

def _large_scene(device, n_spheres=2000):
    """(leaf-ordered scene, its tree, 8,192 camera rays) on a random scene
    past no budget, so every closest hit can be held against every other."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.scene import make_random_scene

    scene = make_random_scene(n_spheres, seed=3)
    tree = build_bvh(scene, leaf_size=8)
    scene = reorder_scene(scene, tree).to(device)
    camera = Camera(**dict(COVER, image_width=128))
    w, h = camera.image_size()
    gen = torch.Generator(device=device).manual_seed(7)
    rays = _slot_rays(camera.derive(torch.float32, device), w, h, 1, gen, None)
    return scene, tree, rays


def _rays_differ(a, b, tol=1e-3):
    return (torch.abs(a - b) > tol).any(dim=1).double().mean().item()


def test_chunked_brute_kernel_equals_whole_table_kernel(cuda_device):
    """The brute scan on 2,000 spheres, a table that fits shared memory
    whole, runs the chunked kernel (the whole-table kernel is gone: every
    brute scan is chunked), forward and recording, bit-equal to the plain
    version, which scans the whole table."""
    scene, _, (o, d, t) = _large_scene(cuda_device)
    assert 4 * mk.N_ROWS * scene.num_spheres <= mk.SMEM_BUDGET_BYTES
    before = dict(mk.LAUNCHES)
    chunked = mk.trace_paths(o, d, t, scene, 5, 8)
    rad_c, res_c = mk.trace_record(o, d, t, scene, 5, 8)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["brute_chunked"] == before["brute_chunked"] + 1
    assert mk.LAUNCHES["record_brute_chunked"] == before["record_brute_chunked"] + 1
    rad_p, res_p = mk.trace_record_twin(o, d, t, scene, 5, 8)
    assert torch.equal(chunked, rad_p) and torch.equal(rad_c, rad_p)
    assert torch.equal(res_c.idx, res_p.idx) and torch.equal(res_c.ndir, res_p.ndir)
    assert torch.equal(res_c.refl, res_p.refl)


LIVE_PER_BLOCK = (1, 33, 129, 256)  # G = 256, 4, 1, 1 lanes a live ray


def _few_live_rays(rays):
    """One 256-ray block of the chunked kernel per entry of LIVE_PER_BLOCK
    (block b traces rays b, b + 4, ...), with that many of the camera rays
    `rays` (taken over the whole image) live at random places in the block
    and the rest parked where every sphere test misses (o = 1e18,
    d = (1, 1, 1)). Returns (o, d, t, live mask)."""
    import numpy as np

    n = mk.TILE * len(LIVE_PER_BLOCK)
    o, d, t = (x[::x.shape[0] // n][:n].clone() for x in rays)  # over the whole image
    rng = np.random.default_rng(7)
    live = np.zeros(n, bool)
    blocks = len(LIVE_PER_BLOCK)
    for b, k in enumerate(LIVE_PER_BLOCK):  # thread t of block b traces ray t * blocks + b
        live[rng.choice(mk.TILE, k, replace=False) * blocks + b] = True
    live = torch.from_numpy(live).to(o.device)
    o[~live], d[~live] = 1e18, 1.0
    return o, d, t, live


def _tensors(x):
    return [y for v in x for y in _tensors(v)] if isinstance(x, (tuple, list)) else [x]


def _all_equal(a, b):
    """Every tensor of a (nested tuples) equal to b's, bit for bit."""
    a, b = _tensors(a), _tensors(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["forward", "record", "record_miss", "segment",
                                  "segment_miss", "segment_record"])
def test_chunked_kernel_with_few_live_rays(cuda_device, kind):
    """Blocks with 1, 33, 129 and 256 live rays, the rest parked from the
    start (K6: dead in the carried state; the monolithic kernels: a miss at
    the first bounce): each of the chunked scan's six instantiations
    bit-equal to its plain version (2,000 spheres, two chunks)."""
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt

    scene, _, rays = _large_scene(cuda_device)
    o, d, t, live = _few_live_rays(rays)
    if kind.startswith("segment"):
        miss, record = kind == "segment_miss", kind == "segment_record"
        state, slot = dt.initial_state(o, d, t, miss)
        state[mk.ST_ALIVE] = live.float()
        kw = dict(record_miss=miss, record=record)
        key = f"segment_{'record_' if record else 'miss_' if miss else ''}brute_chunked"
        before = mk.LAUNCHES[key]
        got = mk.segment_call(state, slot, scene, 77, 3, 8, **kw)
        want = mk.segment_twin(state, slot, scene, 77, 3, 8, **kw)
        if record:
            (got, planes), (want, pplanes) = got, want
            assert _all_equal(planes, pplanes)
    else:
        fn = mk.trace_record if kind == "record" else mk.trace_paths
        kw = {"record_miss": True} if kind == "record_miss" else {}
        twin = mk.trace_record_twin if kind == "record" else mk.trace_paths_twin
        key = {"forward": "brute_chunked", "record": "record_brute_chunked",
               "record_miss": "brute_chunked_miss"}[kind]
        before = mk.LAUNCHES[key]
        got = fn(o, d, t, scene, 5, 8, **kw)
        want = twin(o, d, t, scene, 5, 8, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[key] == before + 1
    assert _all_equal(got, want)


def test_chunked_kernel_keeps_the_first_of_exact_ties(cuda_device):
    """Every sphere twice, at columns i and 1999 - i (other lanes, other
    chunks): every hit is an exact tie, and the chunked kernel, forward and
    recording, keeps the first column as the plain version does."""
    from raytracingproject_tpu_torch.scene import make_random_scene

    half = make_random_scene(1000, seed=3)
    scene = half.take(torch.cat([torch.arange(1000), torch.arange(999, -1, -1)])).to(cuda_device)
    _, _, rays = _large_scene(cuda_device)
    o, d, t = (x[::4][:2048].contiguous() for x in rays)  # over the whole image
    got = mk.trace_paths(o, d, t, scene, 9, 8)
    rad, res = mk.trace_record(o, d, t, scene, 9, 8)
    assert torch.equal(got, mk.trace_paths_twin(o, d, t, scene, 9, 8))
    prad, pres = mk.trace_record_twin(o, d, t, scene, 9, 8)
    for a, b in ((rad, got), (rad, prad), (res.idx, pres.idx), (res.ndir, pres.ndir),
                 (res.refl, pres.refl)):
        assert torch.equal(a, b)
    hits = res.idx >= 0
    assert bool(hits.any()) and bool((res.idx[hits] < 1000).all())


@pytest.mark.parametrize("zero_draws", [True, False])
def test_bvh_kernel_matches_twin(cuda_device, zero_draws):
    """K8 and K5's bvh core against their plain versions (the miss-link
    walk in column order, whose first minimum the kernel's ordered walk
    keeps: bit-equal), and K8 against the brute kernel up to ties."""
    scene, tree, (o, d, t) = _large_scene(cuda_device)
    before = dict(mk.LAUNCHES)
    k = mk.trace_paths(o, d, t, scene, 4242, 8, bvh=tree, zero_draws=zero_draws)
    rad, res = mk.trace_record(o, d, t, scene, 4242, 8, bvh=tree, zero_draws=zero_draws)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["bvh"] == before["bvh"] + 1
    assert mk.LAUNCHES["record_bvh"] == before["record_bvh"] + 1
    assert torch.isfinite(k).all() and torch.equal(rad, k)
    prad, pres = mk.trace_record_twin(o, d, t, scene, 4242, 8, bvh=tree, zero_draws=zero_draws)
    assert torch.equal(k, prad) and _all_equal(res, pres)
    assert _rays_differ(k, mk.trace_paths(o, d, t, scene, 4242, 8, zero_draws=zero_draws)) <= 1e-3


def _few_live_neighbours(rays):
    """Four blocks of a kernel whose block b traces rays 256 b .. + 255,
    with 1, 33, 129 and 256 of the camera rays `rays` (taken over the whole
    image) live at random places in the block and the rest parked (a miss
    at the first bounce)."""
    import numpy as np

    n = mk.TILE * len(LIVE_PER_BLOCK)
    o, d, t = (x[::x.shape[0] // n][:n].clone() for x in rays)
    block = np.arange(n) // mk.TILE
    rng = np.random.default_rng(9)
    live = np.zeros(n, bool)
    for b, k in enumerate(LIVE_PER_BLOCK):
        live[rng.choice(np.flatnonzero(block == b), k, replace=False)] = True
    live = torch.from_numpy(live).to(o.device)
    o[~live], d[~live] = 1e18, 1.0
    return o, d, t


@pytest.mark.parametrize("kind", ["forward", "record", "record_miss"])
def test_bvh_kernels_with_few_live_rays_and_ties(cuda_device, kind):
    """K8's three kernels on blocks with 1, 33, 129 and 256 live rays (the
    rest parked: warps that bounce with one lane live), over 2,000 spheres
    and over a scene of every sphere twice (every hit an exact tie that
    the walk may reach in either order), and on a hand-built tree where
    the walk meets the tie's higher column first: bit-equal to the plain
    versions (the miss-link walk in column order)."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.scene import make_random_scene
    from test_torch_bvh_groups import _tie_scene

    scene, tree, rays = _large_scene(cuda_device)
    o, d, t = _few_live_neighbours(rays)
    half = make_random_scene(1000, seed=3)
    twice = half.take(torch.cat([torch.arange(1000), torch.arange(999, -1, -1)]))
    twice_tree = build_bvh(twice, leaf_size=8)
    cases = [(scene, tree, (o, d, t)), (reorder_scene(twice, twice_tree).to(cuda_device),
                                        twice_tree, (o, d, t))]
    for inner in (False, True):
        tie, tie_tree = _tie_scene(inner)
        x = torch.tensor([[0.0, 0.0, 0.0]] * 3, device=cuda_device)
        dirs = torch.tensor([[1.0, 0.0, 0.0], [1.0, 1e-3, 0.0], [0.0, -1.0, 0.0]],
                            device=cuda_device)
        cases.append((tie.to(cuda_device), tie_tree, (x, dirs, torch.zeros(3, device=cuda_device))))
    key = {"forward": "bvh", "record": "record_bvh", "record_miss": "bvh_miss"}[kind]
    for sc, tr, (ro, rd, rt) in cases:
        before = mk.LAUNCHES[key]
        if kind == "record":
            got = mk.trace_record(ro, rd, rt, sc, 5, 8, bvh=tr)
            want = mk.trace_record_twin(ro, rd, rt, sc, 5, 8, bvh=tr)
        else:
            kw = dict(bvh=tr, record_miss=kind == "record_miss")
            got = mk.trace_paths(ro, rd, rt, sc, 5, 8, **kw)
            want = mk.trace_paths_twin(ro, rd, rt, sc, 5, 8, **kw)
        torch.cuda.synchronize()
        assert mk.LAUNCHES[key] == before + 1
        assert _all_equal(got, want)
    if kind == "record":  # the tie's first bounce: column 0 (A), not its copy
        assert got[1].idx[0, :2].tolist() == [0, 0] and got[1].idx[0, 2].item() == mk.MISS


@pytest.mark.parametrize("kw", [{}, {"word_earlyout": True}, {"sub_block": True},
                                {"sub_block": True, "word_earlyout": True, "max_nodes": 24},
                                {"max_nodes": 600}])
def test_front_hbm_kernel_matches_twin(cuda_device, kw):
    """K7 against its plain version (bit-equal), the brute kernel and K3 on
    the same scene, with each option and on a front of more than 576
    subtrees (the three-level culling path); its shared memory holds the
    live list alone, whatever the budget says."""
    scene, tree, (o, d, t) = _large_scene(cuda_device)
    front = mk.front_tables_hbm(scene, tree, **kw)
    before = mk.LAUNCHES["front_hbm"]
    k = mk.trace_paths(o, d, t, None, 99, 8, front=front)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["front_hbm"] == before + 1
    assert torch.isfinite(k).all()
    assert torch.equal(k, mk.trace_paths_twin(o, d, t, None, 99, 8, front=front))
    assert _rays_differ(k, mk.trace_paths(o, d, t, scene, 99, 8)) <= 1e-3
    k3 = mk.trace_paths(o, d, t, None, 99, 8, front=mk.front_tables(scene, tree))
    assert _rays_differ(k, k3) <= 1e-3
    with pytest.raises(ValueError, match="FrontTablesHBM"):
        mk.trace_record(o, d, t, scene, 99, 8, front=front)
    budget = mk.SMEM_BUDGET_BYTES
    try:
        mk.SMEM_BUDGET_BYTES = 0
        assert torch.equal(mk.trace_paths(o, d, t, None, 99, 8, front=front), k)
    finally:
        mk.SMEM_BUDGET_BYTES = budget


@pytest.mark.parametrize("kind", ["plain", "word_earlyout", "sub_block", "record_miss"])
@pytest.mark.parametrize("live", [1, 5, 9, 17, 33, 65, 129, 256])
def test_front_hbm_kernel_at_each_group_size(cuda_device, kind, live):
    """K7 with `live` rays of every block that enter the scene (warp w of
    block b traces the 32 rays of warp w x blocks + b, so the rays of its
    threads w x 32 + lane < live), the rest parked where every box misses:
    they miss at the first bounce and leave `live` (or fewer) live rays a
    block, each group size G = min(32, 256 / L rounded down to a power of
    two) from the second bounce on; on each front (a front of more than
    576 subtrees for the plain and record_miss kinds) bit-equal to the
    plain version."""
    import dataclasses

    scene, tree, (o, d, t) = _large_scene(cuda_device)
    if kind == "sub_block":
        front = mk.front_tables_hbm(scene, tree, sub_block=True, max_nodes=48)
    else:
        front = mk.front_tables_hbm(scene, tree, max_nodes=600)
        assert front.ff.shape[1] > 576
        front = dataclasses.replace(front, word_earlyout=kind == "word_earlyout")
    o, d = o.clone(), d.clone()
    n_blocks = o.shape[0] // mk.TILE
    ray = torch.arange(o.shape[0], device=cuda_device)
    parked = (ray // 32) // n_blocks * 32 + ray % 32 >= live
    o[parked], d[parked] = 1e18, 1.0
    kw = {"record_miss": True} if kind == "record_miss" else {}
    key = "front_hbm_miss" if kind == "record_miss" else "front_hbm"
    before = mk.LAUNCHES[key]
    got = mk.trace_paths(o, d, t, None, 31, 8, front=front, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[key] == before + 1
    assert _all_equal(got, mk.trace_paths_twin(o, d, t, None, 31, 8, front=front, **kw))


@pytest.mark.parametrize("kind", ["forward", "record", "record_miss", "schlick3", "segment",
                                  "segment_miss", "segment_record"])
def test_brute_route_on_the_cover_scene_matches_plain(cuda_device, kind):
    """Every brute scan takes the chunked kernel, the cover scene's too
    (487 spheres, one chunk): each of its seven instantiations, on the
    cover camera's rays, bit-equal to its plain version, and counted under
    its chunked launch key."""
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt

    scene, _, (o, d, t) = _cover_rays(cuda_device)
    if kind.startswith("segment"):
        miss, record = kind == "segment_miss", kind == "segment_record"
        state, slot = dt.initial_state(o, d, t, miss)
        kw = dict(record_miss=miss, record=record)
        key = f"segment_{'record_' if record else 'miss_' if miss else ''}brute_chunked"
        before = mk.LAUNCHES[key]
        got = mk.segment_call(state, slot, scene, 77, 0, 16, **kw)
        want = mk.segment_twin(state, slot, scene, 77, 0, 16, **kw)
    else:
        fn = mk.trace_record if kind == "record" else mk.trace_paths
        twin = mk.trace_record_twin if kind == "record" else mk.trace_paths_twin
        kw = ({"record_miss": True} if kind == "record_miss"
              else {"inject_bug": "schlick3"} if kind == "schlick3" else {})
        key = {"forward": "brute_chunked", "record": "record_brute_chunked",
               "record_miss": "brute_chunked_miss",
               "schlick3": "brute_chunked_schlick3"}[kind]
        before = mk.LAUNCHES[key]
        got = fn(o, d, t, scene, 5, 16, **kw)
        want = twin(o, d, t, scene, 5, 16, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[key] == before + 1
    assert _all_equal(got, want)


def test_large_scene_render_and_train_step_run_on_the_card(cuda_device):
    """Past the shared-memory budget `render(use_bvh=True)` goes through K8
    (the BVH walk) and `make_fast_train_step(bvh=)` through K5's bvh core,
    from a CPU scene and with no device given."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.grad import make_fast_train_step
    from raytracingproject_tpu_torch.render import render
    from raytracingproject_tpu_torch.scene import make_random_scene

    scene = make_random_scene(6000, seed=3)
    camera = Camera(**dict(COVER, image_width=96, samples_per_pixel=2, max_depth=8))
    mk.reset_launches()
    img = render(scene, camera)
    ref = render(scene, camera, settings=RenderSettings(use_bvh=False))
    assert mk.LAUNCHES["bvh"] > 0 and mk.LAUNCHES["brute_chunked"] > 0
    assert mk.LAUNCHES["front_hbm"] == 0
    assert img.is_cuda and torch.isfinite(img).all()
    assert abs(img.mean().item() - ref.mean().item()) <= 0.05 * ref.mean().item()
    tree = build_bvh(scene, leaf_size=8)
    params, opt, step = make_fast_train_step(reorder_scene(scene, tree), camera, spp=2, bvh=tree,
                                             trainable=("albedo", "fuzz", "ior"))
    params, opt, loss, grads = step(params, opt, None, ref)
    assert params.albedo.is_cuda and torch.isfinite(loss) and mk.LAUNCHES["record_bvh"] == 1


def test_render_past_shared_memory_equals_k7_ray_for_ray(cuda_device):
    """make_random_scene(50000, seed=3) at the preview's camera (400x225,
    depth 50, 3 spp): `prepare_scene` returns K8's tables over the tree it
    built, `render` launches K8 once a pass and K7 never, and K8 gives
    K7's radiance (a FrontTablesHBM over the same tree) on the same rays
    and seeds ray for ray, ties aside, and the same frame from the same
    generator."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.render import render
    from raytracingproject_tpu_torch.scene import make_random_scene

    camera = Camera(**dict(COVER, image_width=400, samples_per_pixel=3, max_depth=50))
    settings = RenderSettings(device=cuda_device)
    scene_cpu = make_random_scene(50000, seed=3)
    scene, tables = prepare_scene(scene_cpu, camera, settings)
    assert isinstance(tables, mk.BVHTables)
    tree = build_bvh(scene_cpu, leaf_size=8)
    assert torch.equal(scene.radius.cpu(), reorder_scene(scene_cpu, tree).radius)
    hbm = mk.front_tables_hbm(scene, tree)
    w, h = camera.image_size()
    derived = camera.derive(torch.float32, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    differ = total = 0
    for seed in (101, 202, 303):
        o, d, t = _slot_rays(derived, w, h, 1, gen, None)
        k8 = mk.trace_paths(o, d, t, scene, seed, 50, bvh=tables)
        k7 = mk.trace_paths(o, d, t, None, seed, 50, front=hbm)
        assert torch.isfinite(k8).all()
        differ += int((k8 != k7).any(dim=1).sum())
        total += o.shape[0]
    assert differ <= 1e-4 * total, (differ, total)

    def k7_tracer(o, d, t, _scene, seed, depth, bvh=None, front=None, **kw):
        return mk.trace_paths(o, d, t, None, seed, depth, front=hbm, **kw)

    frame_gen = lambda: torch.Generator(device=cuda_device).manual_seed(5)  # noqa: E731
    mk.reset_launches()
    img = render(scene_cpu, camera, frame_gen(), settings)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["bvh"] == 3 and mk.LAUNCHES["front_hbm"] == 0
    img7 = render(scene_cpu, camera, frame_gen(), settings, tracer=k7_tracer)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["front_hbm"] == 3
    assert (img != img7).any(dim=-1).double().mean().item() <= 1e-3


# ---- record_miss on the five monolithic modes, K6 and the depth-tail pipelines ----

def _route(mode, scene, front, tree, monkeypatch):
    """trace_paths' keyword arguments (and launch key) of one closest hit
    on the cover scene: brute, chunked (budget set low: the same chunked
    kernel, as every brute scan), front, bvh, hbm."""
    if mode in ("brute", "chunked"):
        if mode == "chunked":
            monkeypatch.setattr(mk, "SMEM_BUDGET_BYTES", 4096)
        return {}, "brute_chunked"
    if mode == "bvh":
        return {"bvh": tree}, "bvh"
    if mode == "hbm":
        return {"front": mk.front_tables_hbm(scene, tree)}, "front_hbm"
    return ({"front": front} if mode == "front" else {}), mode


@pytest.mark.parametrize("mode", ["brute", "chunked", "front", "bvh", "hbm"])
def test_record_miss_kernel_matches_twin(cuda_device, mode, monkeypatch):
    """K1's record_miss on each closest hit: rad + mthr * sky(mdir) equals
    the kernel without miss recording within 2e-6, never-missed planes are
    exactly 0, and the three outputs match the plain version (>= 99.9% of
    rays within 1e-3, bit-equal expected)."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.render import sky_color

    camera = Camera(**COVER)
    tree = build_bvh(make_cover_scene(0), leaf_size=8)
    scene = reorder_scene(make_cover_scene(0), tree).to(cuda_device)
    front = mk.front_tables(scene, tree, order_point=(13.0, 2.0, 3.0), repack=2)
    w, h = camera.image_size()
    o, d, t = _slot_rays(camera.derive(torch.float32, cuda_device), w, h, 1,
                         torch.Generator(device=cuda_device).manual_seed(5), None)
    kw, key = _route(mode, scene, front, tree, monkeypatch)
    plain = mk.trace_paths(o, d, t, scene, 31, 16, **kw)
    before = mk.LAUNCHES[f"{key}_miss"]
    rad, mdir, mthr = mk.trace_paths(o, d, t, scene, 31, 16, record_miss=True, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[f"{key}_miss"] == before + 1
    assert torch.abs(rad + mthr * sky_color(mdir) - plain).max().item() <= 2e-6
    never = (mdir == 0).all(dim=1)
    assert never.any() and not never.all() and bool((mthr[never] == 0).all())
    twin = mk.trace_paths_twin(o, d, t, scene, 31, 16, record_miss=True, **kw)
    for a, b in zip((rad, mdir, mthr), twin):
        assert _rays_differ(a, b) <= 1e-3


def _segment_inputs(device, record_miss, scene=None):
    """State after a first segment of 2 bounces (plain version) of the
    cover camera's rays in the cover scene (or `scene`), with the rays
    packed alive-first, and the scene and the cover scene's front."""
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt

    cover, front, (o, d, t) = _cover_rays(device)
    scene = cover if scene is None else scene
    state, slot = dt.initial_state(o, d, t, record_miss)
    state = mk.segment_twin(state, slot, scene, 77, 0, 2, record_miss=record_miss)
    src, _, _ = dt.alive_first_perm(state[mk.ST_ALIVE])
    return (scene, front, dt.take_ray_rows(state, src, dim=1).contiguous(),
            dt.take_ray_rows(slot, src).contiguous())


@pytest.mark.parametrize("scan", ["brute", "brute_chunked", "front"])
@pytest.mark.parametrize("kind", ["plain", "miss", "record"])
def test_segment_kernel_matches_twin(cuda_device, scan, kind):
    """K6 (each scan, plain, with miss planes, recording) against its plain
    version from the carried state a first segment left: every state plane
    within 1e-3 on >= 99.9% of rays (bit-equal expected), residual idx
    equal on >= 99.9%, ndir and refl equal where idx is. The chunked scan
    runs on 5,000 spheres, five staged chunks."""
    from raytracingproject_tpu_torch.scene import make_random_scene

    five = make_random_scene(5000, seed=3, device=cuda_device) if scan == "brute_chunked" else None
    scene, front, state, slot = _segment_inputs(cuda_device, kind == "miss", five)
    f = front if scan == "front" else None
    key = f"segment_{'' if kind == 'plain' else kind + '_'}{KEY.get(scan, scan)}"
    kw = dict(front=f, record_miss=kind == "miss", record=kind == "record")
    before = mk.LAUNCHES[key]
    got = mk.segment_call(state, slot, scene, 77, 2, 12, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[key] == before + 1
    want = mk.segment_twin(state, slot, scene, 77, 2, 12, **kw)
    if kind == "record":
        (got, planes), (want, wplanes) = got, want
        eq = planes[0] == wplanes[0]
        assert eq.double().mean().item() >= 0.999
        for a, b in zip(planes[1:], wplanes[1:]):
            assert torch.equal(a[eq], b[eq])
    assert torch.isfinite(got).all()
    assert ((torch.abs(got - want) <= 1e-3).all(dim=0)).double().mean().item() >= 0.999


@pytest.mark.parametrize("kind", ["plain", "miss", "record"])
@pytest.mark.parametrize("live", [0, 1, 5, 9, 17, 33, 65, 129, 256])
def test_front_segment_kernel_at_each_group_size(cuda_device, kind, live):
    """K6's front segment (plain, miss planes, recording) with `live` live
    rays in every block (warp w of block b traces the 32 rays of warp
    w x blocks + b, so the rays of its threads w x 32 + lane < live), the
    rest dead and parked in the carried state, as the pipelines leave
    them: each group size G = min(32, 256 / L rounded down to a power of
    two), all dead (L = 0) and a single live ray a block; bit-equal to the
    plain version."""
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt

    scene, front, (o, d, t) = _cover_rays(cuda_device)
    miss, record = kind == "miss", kind == "record"
    state, slot = dt.initial_state(o, d, t, miss)
    n_blocks = state.shape[1] // mk.TILE
    ray = torch.arange(state.shape[1], device=cuda_device)
    thread = (ray // 32) // n_blocks * 32 + ray % 32  # the ray's thread in its block
    dead = thread >= live
    state[mk.ST_ALIVE, dead] = 0.0
    state[0:3, dead], state[3:6, dead] = 1e18, 1.0  # parked
    key = f"segment_{'record_' if record else 'miss_' if miss else ''}front"
    kw = dict(front=front, record_miss=miss, record=record)
    before = mk.LAUNCHES[key]
    got = mk.segment_call(state, slot, scene, 77, 3, 13, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[key] == before + 1
    want = mk.segment_twin(state, slot, scene, 77, 3, 13, **kw)
    assert _all_equal(got, want)
    out = got[0] if record else got
    assert int((state[mk.ST_ALIVE] > 0).sum()) == min(live * n_blocks, o.shape[0])
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("path", ["brute", "front"])
def test_depth_tail_equals_monolithic_on_the_card(cuda_device, path):
    """Philox draws keyed by (seed, slot, bounce): two-phase, segmented and
    the two-phase record equal the monolithic kernels (brute bit-equal;
    front <= 0.1% of rays, its culling is decided per warp)."""
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt

    scene, front, (o, d, t) = _cover_rays(cuda_device)
    f = front if path == "front" else None
    mono = mk.trace_paths(o, d, t, scene, 13, 16, front=f)
    runs = [dt.trace_paths_twophase(o, d, t, scene, 13, 16, cuts=(4,), front=f),
            dt.trace_paths_twophase(o, d, t, scene, 13, 16, cuts=(2, 6), front=f),
            dt.trace_paths_segmented(o, d, t, scene, 13, 16, seg_len=4, front=f)]
    rad_m, res_m = mk.trace_record(o, d, t, scene, 13, 16, front=f)
    rad2, res1, res2, _, dest, _ = dt.trace_record_twophase(o, d, t, scene, 13, 16, cut=4,
                                                            front=f)
    runs.append(rad2)
    n = o.shape[0]
    idx = torch.cat([res1.idx[:, :n], dt.take_ray_rows(res2.idx, dest, dim=1)[:, :n]])
    for r in runs:
        assert torch.equal(r, mono) if path == "brute" else _rays_differ(r, mono) <= 1e-3
    if path == "brute":
        assert torch.equal(idx, res_m.idx)
    else:
        assert (idx == res_m.idx).all(dim=0).double().mean().item() >= 0.999
    # each pipeline against its plain version (K6's plain version on the card)
    assert _rays_differ(runs[0], dt.trace_paths_twophase_twin(o, d, t, scene, 13, 16, cuts=(4,),
                                                              front=f)) <= 1e-3
    assert _rays_differ(runs[2], dt.trace_paths_segmented_twin(o, d, t, scene, 13, 16,
                                                               seg_len=4, front=f)) <= 1e-3
    twin = dt.trace_record_twophase_twin(o, d, t, scene, 13, 16, cut=4, front=f)
    assert _rays_differ(rad2, twin[0]) <= 1e-3
    assert (res1.idx == twin[1].idx).double().mean().item() >= 0.999


def test_twophase_fast_radiance_kernel_gradients_match_twin(cuda_device):
    """make_fast_radiance_twophase with the K6 pipelines and with their
    plain versions on the card give the same gradients (relative norm 1e-5
    per field, deterministic algorithms, as for the monolithic one), and
    the monolithic fast radiance's."""
    from raytracingproject_tpu_torch.grad import (
        SceneParams, extract_params, make_fast_radiance, make_fast_radiance_twophase,
    )
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt

    scene, _, (o, d, t) = _cover_rays(cuda_device)
    w = torch.rand((o.shape[0], 3), generator=torch.Generator(device=cuda_device).manual_seed(2),
                   device=cuda_device)
    fns = [make_fast_radiance_twophase(scene, 12),
           make_fast_radiance_twophase(scene, 12, tracer=dt.trace_paths_twophase_twin,
                                       recorder=dt.trace_record_twophase_twin),
           make_fast_radiance(scene, 12)]
    grads = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for fn in fns:
            pp = SceneParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
            grads.append(torch.autograd.grad((fn(pp, o, d, t, 99) * w).sum(), list(pp)))
    finally:
        torch.use_deterministic_algorithms(False)
    for other in grads[1:]:
        for name, a, b in zip(SceneParams._fields, grads[0], other):
            a, b = a.double(), b.double()
            rel = (torch.linalg.norm(a - b) / (torch.linalg.norm(b) + 1e-6)).item()
            assert rel <= 1e-5, (name, rel)


def test_depth_tail_and_sky_texture_render_on_the_card(cuda_device):
    """render() with two_phase, depth_segment and a sky texture runs K6 and
    the record_miss kernels from a CPU scene; images finite, means within
    5% of the monolithic frame's; a two-phase train step runs K6's
    recording segments."""
    from raytracingproject_tpu_torch.grad import make_fast_train_step
    from raytracingproject_tpu_torch.render import render

    camera = Camera(**dict(COVER, samples_per_pixel=2, max_depth=12))
    ref = render(make_cover_scene(0), camera)
    tex = torch.rand((16, 32, 3), generator=torch.Generator().manual_seed(2))
    for kw, sky in (({"two_phase": 4}, None), ({"depth_segment": 4}, None), ({}, tex),
                    ({"two_phase": 4}, tex)):
        mk.reset_launches()
        img = render(make_cover_scene(0), camera, settings=RenderSettings(**kw), sky_texture=sky)
        seg = sum(v for k, v in mk.LAUNCHES.items() if k.startswith("segment_"))
        assert img.is_cuda and torch.isfinite(img).all()
        assert seg == (0 if not kw else 3 if "depth_segment" in kw else 2)  # one pass
        if sky is None:
            assert abs(img.mean().item() - ref.mean().item()) <= 0.05 * ref.mean().item()
        else:
            assert mk.LAUNCHES["front_miss"] + mk.LAUNCHES["segment_miss_front"] > 0
    mk.reset_launches()
    params, opt, step = make_fast_train_step(make_cover_scene(0), camera, spp=1, two_phase=4,
                                             trainable=("albedo",))
    params, opt, loss, grads = step(params, opt, None, ref)
    assert params.albedo.is_cuda and torch.isfinite(loss)
    assert mk.LAUNCHES["segment_record_brute_chunked"] == 2


# ---- the probe kernels (csrc/probes.cu) ----

def test_fma_and_mixed_probes_match_their_plain_versions(cuda_device):
    from raytracingproject_tpu_torch import probes
    from raytracingproject_tpu_torch.probes import roofline

    x = torch.linspace(0.5, 1.5, 5000, device=cuda_device)
    before = dict(probes.LAUNCHES)
    assert torch.equal(roofline.fma_chains(x), roofline.fma_chains_plain(x))
    tab = roofline.mixed_table(488).to(cuda_device)
    ox = torch.linspace(-14.0, 14.0, 3000, device=cuda_device)
    k, p = roofline.mixed_hits(tab, ox), roofline.mixed_hits_plain(tab, ox)
    assert torch.equal(k, p) and torch.isfinite(p).any()
    assert probes.LAUNCHES["fma"] == before["fma"] + 1
    assert probes.LAUNCHES["mixed"] == before["mixed"] + 1


@pytest.mark.parametrize("n_spheres", [None, 2000])
def test_closest_hit_probes_match_their_plain_versions(cuda_device, n_spheres):
    """kexp's six variants, kfront's brute and front probes, bit-equal to
    their plain versions on the 400x225 primary rays (cover scene, and
    2,000 random spheres: eight staged chunks, the front's table past
    48 KB)."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.probes import kexp, kfront

    scene = kfront.probe_scene(n_spheres)
    rays = kfront.primary_rays(cuda_device)
    sph = mk.scene_table(scene).to(cuda_device)
    for v in kexp.VARIANTS:
        assert torch.equal(kexp.run(rays, sph, v), kexp.run_plain(rays, sph, v)), v
    sphb = mk.scene_table(reorder_scene(scene, build_bvh(scene, leaf_size=8))).to(cuda_device)
    brute = kfront.run_brute(rays, sphb)
    assert torch.equal(brute, kfront.run_brute_plain(rays, sphb))
    for f in kfront.FRONTS:
        tabs = [t.to(cuda_device) for t in kfront.pack_front_tables(scene, max_nodes=f)]
        front = kfront.run_front(rays, *tabs)
        assert torch.equal(front, kfront.run_front_plain(rays, *tabs))
        assert torch.equal(front, brute)


def _hold_hit_probes(device, sph, what):
    """The eight probe_hit_kernel instantiations on the table `sph` (16,
    n), each bit-equal to its plain version: kexp's six and kfront's brute
    on the cover camera's primary rays, the mixed peak on its synthetic
    rays."""
    from raytracingproject_tpu_torch.probes import kexp, kfront, roofline

    rays = kfront.primary_rays(device)
    sph = sph.contiguous().to(device)
    for v in kexp.VARIANTS:
        assert torch.equal(kexp.run(rays, sph, v), kexp.run_plain(rays, sph, v)), (what, v)
    assert torch.equal(kfront.run_brute(rays, sph), kfront.run_brute_plain(rays, sph)), what
    ox = torch.linspace(-14.0, 14.0, 20000, device=device)
    assert torch.equal(roofline.mixed_hits(sph, ox), roofline.mixed_hits_plain(sph, ox)), what


@pytest.mark.parametrize("n", [1, 255, 256, 257, 2000],
                         ids=["1", "CHUNK-1", "CHUNK", "CHUNK+1", "2000"])
def test_hit_probes_at_the_chunk_edges(cuda_device, n):
    """probe_hit_kernel stages the table CHUNK (256, held to the source by
    test_torch_probes.py) spheres at a time: every instantiation bit-equal
    to its plain version on the first n columns of make_random_scene(2000,
    seed=3)'s table, at and around the edge of a chunk."""
    from raytracingproject_tpu_torch.probes import kfront

    sph = mk.scene_table(kfront.probe_scene(2000))[:, :n]
    _hold_hit_probes(cuda_device, sph, f"n = {n}")


@pytest.mark.parametrize("pairing", ["neighbours", "a chunk apart"])
def test_hit_probes_keep_the_first_of_exact_ties(cuda_device, pairing):
    """Every sphere twice, so every hit is an exact tie: beside itself, or
    300 columns on (in another chunk). The strict `<` scan keeps the first
    column, which kexp's slim variants write."""
    from raytracingproject_tpu_torch.probes import kfront

    base = mk.scene_table(kfront.probe_scene(2000))[:, :300]
    sph = (base.repeat_interleave(2, dim=1) if pairing == "neighbours"
           else torch.cat([base, base], dim=1))
    _hold_hit_probes(cuda_device, sph, pairing)


def test_front_probe_on_diverging_warps(cuda_device):
    """The front probe culls per ray: on warps whose even lanes aim into
    the densest subtree and whose odd lanes miss every box, it is bit-equal
    to its plain version and to the brute probe, every missing ray 0."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.probes import kfront

    scene = kfront.probe_scene(2000)
    for f in kfront.FRONTS:
        sph, ff, fi = kfront.pack_front_tables(scene, max_nodes=f)
        rays = [x.to(cuda_device) for x in kfront.diverging_rays(ff, fi, 4096)]
        tabs = [t.to(cuda_device) for t in (sph, ff, fi)]
        got = kfront.run_front(rays, *tabs)
        assert torch.equal(got, kfront.run_front_plain(rays, *tabs)), f
        sphb = mk.scene_table(reorder_scene(scene, build_bvh(scene, leaf_size=8))).to(cuda_device)
        assert torch.equal(got, kfront.run_brute(rays, sphb)), f
        assert (got[1::2] == 0).all() and (got[0::2] > 0).any()


def test_probe_occupancy_does_not_collapse_on_2000_spheres(cuda_device):
    """Shared memory no longer holds the whole [16, n] table: every
    closest-hit probe gets at least two blocks of an SM on
    make_random_scene(2000, seed=3) (its first port got one)."""
    from raytracingproject_tpu_torch import probes
    from raytracingproject_tpu_torch.probes import kfront

    for key in probes.HIT_ARGS:
        assert probes.blocks_per_sm(key) >= 2, key
    sph, ff, _ = kfront.pack_front_tables(kfront.probe_scene(2000), max_nodes=24)
    assert probes.blocks_per_sm("kfront_front", sph.shape[1], ff.shape[1]) >= 2


# ---- K3's options and K1's planted fault ----

def _option_fronts(device, max_nodes=None):
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene

    cpu = make_cover_scene(0)
    tree = build_bvh(cpu, leaf_size=8)
    scene = reorder_scene(cpu, tree).to(device)
    kw = dict(max_nodes=max_nodes, order_point=COVER["lookfrom"], repack=2)
    return scene, {"plain": mk.front_tables(scene, tree, **kw),
                   "word_earlyout": mk.front_tables(scene, tree, word_earlyout=True, **kw),
                   "sub_block": mk.front_tables(scene, tree, sub_block=True, **kw),
                   "both": mk.front_tables(scene, tree, sub_block=True, word_earlyout=True, **kw)}


@pytest.mark.parametrize("option", ["word_earlyout", "sub_block", "both"])
@pytest.mark.parametrize("record_miss", [False, True])
def test_front_option_kernels_equal_plain_front(cuda_device, option, record_miss):
    """The forward instantiations with K3's options (plain and record_miss)
    bit-equal to plain K3 and to their plain versions."""
    scene, fronts = _option_fronts(cuda_device)
    _, _, rays = _cover_rays(cuda_device)
    key = "front_opts_miss" if record_miss else "front_opts"
    before = mk.LAUNCHES[key]
    k = mk.trace_paths(*rays, scene, 77, 16, front=fronts[option], record_miss=record_miss)
    assert mk.LAUNCHES[key] == before + 1
    base = mk.trace_paths(*rays, scene, 77, 16, front=fronts["plain"], record_miss=record_miss)
    p = mk.trace_paths_twin(*rays, scene, 77, 16, front=fronts[option], record_miss=record_miss)
    k, base, p = ((x,) if not record_miss else x for x in (k, base, p))
    assert all(torch.equal(a, b) for a, b in zip(k, base))
    assert all(torch.equal(a, b) for a, b in zip(k, p))


def test_record_and_segment_kernels_with_word_earlyout(cuda_device):
    """K5's front core and K6's three front tails with word_earlyout,
    bit-equal to their plain K3 instantiations; a FrontTables with
    sub-block boxes records and segments without them."""
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt

    scene, fronts = _option_fronts(cuda_device)
    _, _, rays = _cover_rays(cuda_device)
    ra, pa = mk.trace_record(*rays, scene, 5, 12, front=fronts["plain"])
    before = mk.LAUNCHES["record_front_opts"]
    rb, pb = mk.trace_record(*rays, scene, 5, 12, front=fronts["both"])
    assert mk.LAUNCHES["record_front_opts"] == before + 1
    assert torch.equal(ra, rb)
    assert all(torch.equal(getattr(pa, f), getattr(pb, f)) for f in ("idx", "ndir", "refl"))
    for miss, rec in ((False, False), (True, False), (False, True)):
        state, slot = dt.initial_state(*rays, miss)
        key = f"segment_{'record_' if rec else 'miss_' if miss else ''}front_opts"
        before = mk.LAUNCHES[key]
        a = mk.segment_call(state, slot, scene, 9, 2, 6, front=fronts["plain"],
                            record_miss=miss, record=rec)
        b = mk.segment_call(state, slot, scene, 9, 2, 6, front=fronts["word_earlyout"],
                            record_miss=miss, record=rec)
        assert mk.LAUNCHES[key] == before + 1
        if rec:
            assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
        else:
            assert torch.equal(a, b)


def test_sub_block_with_fewer_bigger_subtrees(cuda_device):
    """sub_block on a front of 24 subtrees over 2,000 spheres (ksub > 8)."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu_torch.scene import make_random_scene

    cpu = make_random_scene(2000, seed=3)
    tree = build_bvh(cpu, leaf_size=8)
    scene = reorder_scene(cpu, tree).to(cuda_device)
    plain = mk.front_tables(scene, tree, max_nodes=24, order_point=COVER["lookfrom"])
    sub = mk.front_tables(scene, tree, max_nodes=24, order_point=COVER["lookfrom"],
                          sub_block=True, word_earlyout=True)
    assert sub.ksub > 8
    _, _, rays = _cover_rays(cuda_device)
    assert torch.equal(mk.trace_paths(*rays, scene, 3, 16, front=sub),
                       mk.trace_paths(*rays, scene, 3, 16, front=plain))


def test_schlick3_kernel_matches_its_plain_version(cuda_device):
    from raytracingproject_tpu_torch.scene import make_three_sphere_scene

    scene = make_three_sphere_scene(device=cuda_device)
    _, _, rays = _cover_rays(cuda_device)
    before = mk.LAUNCHES["brute_chunked_schlick3"]
    k = mk.trace_paths(*rays, scene, 21, 16, inject_bug="schlick3")
    assert mk.LAUNCHES["brute_chunked_schlick3"] == before + 1
    assert torch.equal(k, mk.trace_paths_twin(*rays, scene, 21, 16, inject_bug="schlick3"))
    with pytest.raises(ValueError, match="inject_bug"):
        mk.trace_paths(*rays, scene, 21, 16, inject_bug="schlick3", record_miss=True)


# ---- K3's warp-level lane groups: every front instantiation at each live count ----

FRONT_KINDS = ["front", "front_miss", "record_front", "front_opts", "front_opts_miss",
               "record_front_opts", "segment_front_opts", "segment_miss_front_opts",
               "segment_record_front_opts"]


def _front_kind(kind, rays, dead, scene, front, seed: int = 19, depth: int = 12):
    """(the kernel's result, its plain version's) of the front instantiation
    `kind` (its launch key) on `rays`, the rays where `dead` parked as the
    kernel parks a dead ray (the segments: dead in the carried state, so
    they take no part from the first bounce; the monolithic kernels: a miss
    at their first bounce)."""
    from raytracingproject_tpu_torch.ops.cuda import depth_tail as dt

    miss, rec = "miss" in kind, kind.startswith(("record", "segment_record"))
    if kind.startswith("segment"):
        state, slot = dt.initial_state(*rays, miss)
        off = torch.ones(state.shape[1], dtype=torch.bool, device=dead.device)
        off[:dead.shape[0]] = dead  # the padding rays are dead already
        state[mk.ST_ALIVE, off] = 0.0
        state[0:3, off], state[3:6, off] = 1e18, 1.0
        kw = dict(front=front, record_miss=miss, record=rec)
        return (mk.segment_call(state, slot, scene, seed, 2, depth, **kw),
                mk.segment_twin(state, slot, scene, seed, 2, depth, **kw))
    o, d, t = (x.clone() for x in rays)
    o[dead], d[dead] = 1e18, 1.0
    if rec:
        return (mk.trace_record(o, d, t, scene, seed, depth, front=front),
                mk.trace_record_twin(o, d, t, scene, seed, depth, front=front))
    return (mk.trace_paths(o, d, t, scene, seed, depth, front=front, record_miss=miss),
            mk.trace_paths_twin(o, d, t, scene, seed, depth, front=front, record_miss=miss))


@pytest.mark.parametrize("kind", FRONT_KINDS)
@pytest.mark.parametrize("live", [1, 2, 3, 16, 17, 32])
def test_front_kernels_at_each_live_count(cuda_device, kind, live):
    """K3's nine instantiations (forward, record_miss, K5's front core;
    with K3's options those and K6's three front tails) with `live` rays
    of every warp live (lanes < live), the rest parked: on K3's warp-level
    groups each group size G = 32 / L rounded down to a power of two, the
    groups fetched from any lane; on the segments' block-level list
    G = 256 / (8 L), at most 32; bit-equal to the plain version. The
    options kinds run the front with sub-block boxes and word_earlyout
    (the recording and segment kinds take word_earlyout alone)."""
    scene, fronts = _option_fronts(cuda_device)
    front = fronts["both" if "opts" in kind else "plain"]
    _, _, rays = _cover_rays(cuda_device)
    dead = torch.arange(rays[0].shape[0], device=cuda_device) % 32 >= live
    before = mk.LAUNCHES[kind]
    got, want = _front_kind(kind, rays, dead, scene, front)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[kind] == before + 1
    assert _all_equal(got, want)


@pytest.mark.parametrize("kind", ["front", "front_miss", "record_front", "segment_front_opts"])
def test_front_kernels_on_the_largest_front(cuda_device, kind):
    """make_random_scene(3000, seed=3): `render`'s route is still K3 (a
    FrontTables; its tables leave one block an SM), and the monolithic
    front kernels are bit-equal to their plain versions on it. A front
    segment (here with word_earlyout) refuses it: its live list does not
    fit beside the tables (the depth tail builds its fronts within
    SMEM_BUDGET_BYTES - SEGMENT_LIST_BYTES)."""
    import dataclasses

    from raytracingproject_tpu_torch.scene import make_random_scene

    scene, front = prepare_scene(make_random_scene(3000, seed=3), Camera(**COVER),
                                 RenderSettings(device=cuda_device))
    assert isinstance(front, mk.FrontTables) and front.sph.shape[1] > 3000
    if "opts" in kind:
        front = dataclasses.replace(front, word_earlyout=True)
    _, _, rays = _cover_rays(cuda_device)
    dead = torch.zeros(rays[0].shape[0], dtype=torch.bool, device=cuda_device)
    before = mk.LAUNCHES[kind]
    if kind.startswith("segment"):
        with pytest.raises(ValueError, match="shared memory"):
            _front_kind(kind, rays, dead, scene, front)
        assert mk.LAUNCHES[kind] == before
        return
    got, want = _front_kind(kind, rays, dead, scene, front)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[kind] == before + 1
    assert _all_equal(got, want)


def test_wavefront_on_the_card_runs_k4_and_is_reproducible(cuda_device):
    """The wavefront's closest hit on the card is K4, once an iteration,
    and two runs from one seed give the same image bit for bit (the
    per-pixel sums in slot order, no atomics)."""
    from raytracingproject_tpu_torch.ops.cuda import trace
    from raytracingproject_tpu_torch.wavefront import render_wavefront_image

    cam = Camera(**dict(COVER, image_width=64, samples_per_pixel=4))
    settings = RenderSettings(device=cuda_device)
    before = trace.LAUNCHES["closest_hit"]
    stats = {}
    a = render_wavefront_image(make_cover_scene(0), cam,
                               torch.Generator(device=cuda_device).manual_seed(3), settings,
                               stats=stats)
    assert trace.LAUNCHES["closest_hit"] - before == stats["iterations"] > 0
    b = render_wavefront_image(make_cover_scene(0), cam,
                               torch.Generator(device=cuda_device).manual_seed(3), settings)
    assert torch.isfinite(a).all() and torch.equal(a, b)


def test_sharded_paths_on_one_card(cuda_device):
    """A 1x1 NCCL mesh (make_mesh() starts a world of one): render_sharded
    with the megakernel is `_render_flat` of the whole image bit for bit,
    and the sharded fast step equals make_fast_train_step on the shard's
    derived generator (loss within 1e-5 relative, gradients within 1e-5
    of the largest)."""
    import torch.distributed as dist

    from raytracingproject_tpu_torch.grad import make_fast_train_step
    from raytracingproject_tpu_torch.parallel import make_mesh, make_sharded_train_step
    from raytracingproject_tpu_torch.parallel.shard import (
        _pixel_grid, _render_flat, draw_base, render_sharded, shard_generator,
    )

    mesh = make_mesh()
    try:
        assert dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
        cam = Camera(**dict(COVER, image_width=64, samples_per_pixel=2))
        scene = make_cover_scene(0)
        gen = lambda: torch.Generator(device=cuda_device).manual_seed(5)  # noqa: E731
        before = mk.LAUNCHES["brute_chunked"]
        img = render_sharded(scene, cam, gen(), mesh, use_megakernel=True)
        assert mk.LAUNCHES["brute_chunked"] == before + 2
        w, h = cam.image_size()
        i, j = _pixel_grid(w, h, 1)
        want = _render_flat(scene.to(cuda_device), cam.derive(torch.float32, cuda_device),
                            i.to(cuda_device), j.to(cuda_device),
                            shard_generator(draw_base(gen()), 0, 0, cuda_device),
                            max_depth=cam.max_depth, spp_local=2, use_megakernel=True)
        assert torch.equal(img, want.reshape(h, w, 3) / 2)
        target = torch.full((h, w, 3), 0.3, device=cuda_device)
        sp, so, sstep = make_sharded_train_step(scene, cam, mesh, spp=2, use_megakernel=True)
        up, uo, ustep = make_fast_train_step(scene, cam, spp=2)
        _, _, sloss, sg = sstep(sp, so, gen(), target)
        _, _, uloss, ug = ustep(up, uo, shard_generator(draw_base(gen()), 0, 0, cuda_device),
                                target)
        assert abs(float(sloss) - float(uloss)) <= 1e-5 * float(uloss)
        scale = max(float(g.abs().max()) for g in ug)
        assert max(float((a - b).abs().max()) for a, b in zip(sg, ug)) <= 1e-5 * scale
    finally:
        dist.destroy_process_group()
