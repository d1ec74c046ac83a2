"""The port's probe kernels (raytracingproject_tpu_torch/probes), their
plain PyTorch versions, against the Pallas probes of tools/ run in
interpret mode on the same inputs (numpy arrays from a seed or made by
the JAX package). The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracingproject_tpu import scene as jscene
from raytracingproject_tpu.camera import Camera as JCamera, generate_rays as jgenerate_rays
from raytracingproject_tpu.ops.pallas.megakernel import N_ROWS, _closest_hit_brute

from raytracingproject_tpu_torch import bridge, probes
from raytracingproject_tpu_torch.ops.cuda.megakernel import _sphere_t, scene_table
from raytracingproject_tpu_torch.probes import kexp, kfront, roofline
from raytracingproject_tpu_torch.probes.measure import marginal_ms


def _import_tools():
    """tools.roofline, tools.kfront, tools.kexp, with the JAX settings their
    import changes (a persistent compilation cache) put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    from tools import kexp as tkexp, kfront as tkfront, roofline as troofline
    for k, v in saved.items():
        jax.config.update(k, v)
    return troofline, tkfront, tkexp


troofline, tkfront, tkexp = _import_tools()

SUB, LANES = 8, 128
COVER_CAM = dict(aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=1, max_depth=1,
                 vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                 defocus_angle=0.6, focus_dist=10.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread: the shapes here are small, and several test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiles_call(kernel, in_specs, tiles):
    spec = pl.BlockSpec((SUB, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(kernel, grid=(tiles,), in_specs=in_specs + [spec], out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct((tiles * SUB, LANES), jnp.float32),
                          interpret=True)


def test_fma_plain_matches_the_pallas_probe():
    """fma_chains_plain (exact FMA steps) against tools/roofline.py's
    _fma_kernel on 2 tiles: relative 1e-6. XLA on the CPU need not contract
    x * a + b into an FMA, and each unfused step rounds twice; the gap
    measured here is printed (0 or a few ulps of the chains' sum)."""
    tiles = 2
    x = np.random.default_rng(0).uniform(0.5, 1.5, (tiles * SUB, LANES)).astype(np.float32)
    ref = np.asarray(_tiles_call(troofline._fma_kernel, [], tiles)(jnp.asarray(x)))
    got = roofline.fma_chains(torch.from_numpy(x)).numpy()
    rel = np.abs(got - ref) / np.abs(ref)
    print(f"fma plain vs Pallas: max relative gap {rel.max():.3e}, "
          f"{(got != ref).mean():.4f} of elements differ")
    assert np.isfinite(got).all()
    assert rel.max() <= 1e-6


def test_fma_plain_is_an_exact_fma():
    """Each step of the plain version is the correctly rounded c * a + b,
    held against float64 arithmetic on random chains (the ties included:
    c = 1.5 * 2^e makes c * a a midpoint between two float32 values)."""
    rng = np.random.default_rng(1)
    c = np.concatenate([rng.uniform(0.5, 2.0, 4096), [1.5, 0.75, 3.0]]).astype(np.float32)
    exact = c.astype(np.float64) * roofline.FMA_A + roofline.FMA_B  # exact: 48 + 1e-30
    lo = exact.astype(np.float32)
    # the float32 neighbour of `exact` on its other side, and the nearer of the two
    other = np.where(lo.astype(np.float64) < exact, np.nextafter(lo, np.float32(np.inf)),
                     np.nextafter(lo, np.float32(-np.inf)))
    nearer = np.where(np.abs(other.astype(np.float64) - exact)
                      < np.abs(lo.astype(np.float64) - exact), other, lo)
    up = torch.tensor(np.inf, dtype=torch.float64)
    got = torch.nextafter(torch.from_numpy(c).double() * roofline.FMA_A, up).float().numpy()
    np.testing.assert_array_equal(got, nearer)
    assert got[-3] == np.float32(1.5) + 2 * np.spacing(np.float32(1.5))  # the tie went up


def _mixed_pallas(tab: np.ndarray, x: np.ndarray) -> np.ndarray:
    """tools/roofline.py:136-154, the kernel of measure_mixed_peak, rebuilt
    around the JAX package's own _closest_hit_brute: the synthetic rays
    from one plane, the sum of every hit carry. The JAX carry's material
    slot holds mat + 4 * winner index; the port's carry holds the material
    alone, so the sum takes the slot back to the material (the table's
    materials are integers here)."""
    n_pad = tab.shape[1]

    def kernel(sph_ref, ox_ref, o_ref):
        ox = ox_ref[:]
        oy = ox * 0.5 + 2.0
        oz = ox * 0.25 + 3.0
        dx = ox * 1e-3 - 0.9
        dy = ox * 1e-3 - 0.1
        dz = ox * 1e-3 - 0.3
        tm = ox * 0.0
        a = dx * dx + dy * dy + dz * dz
        rays = (ox, oy, oz, dx, dy, dz, tm, a, 1.0 / a)
        hc = list(_closest_hit_brute(sph_ref, rays, 1e-3, n_pad, (SUB, LANES)))
        hc[5] = hc[5] - 4.0 * jnp.floor(hc[5] / 4.0)
        acc = hc[0]
        for h in hc[1:]:
            acc = acc + h
        o_ref[:] = acc

    smem = pl.BlockSpec((N_ROWS, n_pad), lambda i: (0, 0), memory_space=pltpu.SMEM)
    return np.asarray(_tiles_call(kernel, [smem], x.shape[0] // SUB)(jnp.asarray(tab),
                                                                       jnp.asarray(x)))


def test_mixed_plain_matches_the_pallas_probe():
    """The mixed peak's plain version against the Pallas kernel on 2 tiles
    of its synthetic rays (roofline.py's linspace, wider, so that some rays
    hit): the same rays miss (sum inf), and the sums of the hits agree
    within 1e-4 relative. XLA on the CPU may contract the quadratic's
    products into FMAs and the port's plain version does not; the rays
    start 10-20 units from 0.1-0.4 radius spheres, where the quadratic
    cancels ~12 bits, so t moves by up to ~1e-4 (3.4e-5 of the sum
    measured)."""
    tab = roofline.mixed_table(488).numpy()
    tab[7] = np.floor(tab[7] * 3.0)  # integer materials 0, 1, 2
    x = np.linspace(-14.0, 14.0, 2 * SUB * LANES, dtype=np.float32).reshape(2 * SUB, LANES)
    ref = _mixed_pallas(tab, x).reshape(-1)
    got = roofline.mixed_hits(torch.from_numpy(tab), torch.from_numpy(x.reshape(-1))).numpy()
    hit = np.isfinite(ref)
    print(f"mixed: {hit.sum()} of {hit.size} rays hit; max relative gap "
          f"{np.max(np.abs(got[hit] - ref[hit]) / np.abs(ref[hit])):.3e}")
    assert hit.sum() >= 100
    np.testing.assert_array_equal(np.isfinite(got), hit)
    np.testing.assert_allclose(got[hit], ref[hit], rtol=1e-4)


def _cover_pair():
    """(JAX cover scene, the port's scene made from its arrays)."""
    js = jscene.make_cover_scene(seed=0)
    return js, bridge.scene_from_arrays(*(np.array(x) for x in js))


@pytest.mark.parametrize("n_front", [24, 48])
def test_pack_front_tables_equal_to_tools(n_front):
    js, ps = _cover_pair()
    want = tkfront.pack_front_tables(js, max_nodes=n_front, unroll=8)
    got = kfront.pack_front_tables(ps, max_nodes=n_front)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _cover_rays(n=1024, seed=4):
    """n primary rays of the cover camera at random pixels (JAX), as the
    seven flat numpy planes and as the (n/128, 128) tiles the Pallas probes
    take."""
    cam = JCamera(**COVER_CAM)
    w, h = cam.image_size()
    key = jax.random.PRNGKey(seed)
    idx = jax.random.randint(key, (n,), 0, w * h)
    o, d, t = jgenerate_rays(cam.derive(), (idx % w).astype(jnp.int32),
                             (idx // w).astype(jnp.int32), jax.random.fold_in(key, 1))
    o, d, t = np.asarray(o), np.asarray(d), np.asarray(t)
    flat = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t]
    flat = [np.array(x, np.float32) for x in flat]
    return flat, tuple(jnp.asarray(x.reshape(-1, LANES)) for x in flat)


def _t64(flat, sph):
    """Each ray's closest t over the table in float64 (0 on a miss)."""
    ox, oy, oz, dx, dy, dz, tm = (torch.from_numpy(x).double() for x in flat)
    a = dx * dx + dy * dy + dz * dz
    t = _sphere_t(sph.double(), ox, oy, oz, dx, dy, dz, tm, a, 1.0 / a, 1e-3).min(1).values
    return torch.where(torch.isfinite(t), t, 0.0).numpy()


def _agree(got, ref, t64, what):
    """t within 1e-5 of the Pallas probe's, or, where the two differ more,
    both within 2e-4 of float64: the cover camera stands 13 units from
    0.2-radius spheres, where the float32 quadratic cancels ~12 bits, and
    XLA on the CPU contracts its products into FMAs while the port's plain
    version rounds each (measured: 4% of rays 1e-5 to 1.2e-4 apart, both
    packages up to 1.2e-4 off float64). At most 0.1% of rays may be
    neither: ties of two spheres to the last ulps."""
    close = np.abs(got - ref) <= 1e-5
    accurate = (np.abs(got - t64) <= 2e-4) & (np.abs(ref - t64) <= 2e-4)
    print(f"{what}: {close.mean():.5f} of rays within 1e-5 of the Pallas probe, the rest "
          f"both within 2e-4 of float64 but {(~close & ~accurate).sum()} ties; "
          f"{(got > 0).mean():.3f} hit")
    assert np.isfinite(got).all()
    assert (close | accurate).mean() >= 0.999


@pytest.mark.parametrize("n_front", [24, 48])
def test_run_front_plain_matches_the_pallas_probe(n_front):
    js, ps = _cover_pair()
    flat, comps = _cover_rays()
    jsph, jff, jfi = tkfront.pack_front_tables(js, max_nodes=n_front, unroll=8)
    ref = np.asarray(tkfront.run_front(comps, jsph, jff, jfi, n_front, 8,
                                       interpret=True)).reshape(-1)
    sph, ff, fi = kfront.pack_front_tables(ps, max_nodes=n_front)
    got = kfront.run_front([torch.from_numpy(x) for x in flat], sph, ff, fi).numpy()
    _agree(got, ref, _t64(flat, sph), f"front F={n_front}")


def test_run_brute_plain_matches_the_pallas_probe():
    js, ps = _cover_pair()
    flat, comps = _cover_rays()
    from raytracingproject_tpu.bvh import build_bvh, reorder_scene
    from raytracingproject_tpu.ops.pallas.megakernel import _scene_table

    jr = reorder_scene(js, build_bvh(js, leaf_size=8))
    n = int(jr.radius.shape[0])
    ref = np.asarray(tkfront.run_brute(comps, _scene_table(jr), n, 8,
                                       interpret=True)).reshape(-1)
    sph = scene_table(bridge.scene_from_arrays(*(np.asarray(x) for x in jr)))
    got = kfront.run_brute([torch.from_numpy(x) for x in flat], sph).numpy()
    _agree(got, ref, _t64(flat, sph), "brute")
    # the front probe finds the brute scan's t on every ray (same spheres)
    front = kfront.run_front([torch.from_numpy(x) for x in flat],
                             *kfront.pack_front_tables(ps, max_nodes=24)).numpy()
    np.testing.assert_array_equal(front, got)


@pytest.mark.parametrize("variant", kexp.VARIANTS)
def test_kexp_plain_matches_the_pallas_probe(variant):
    """Each kexp variant's plain version against tools/kexp.py's _kernel in
    interpret mode, t + 1e-7 * carry (the winner's centre x, or its index),
    held as `_agree` holds t (the carry term is at most ~1e-6); unrolling
    changes no value."""
    js, _ = _cover_pair()
    flat, comps = _cover_rays(seed=7)
    from raytracingproject_tpu.ops.pallas.megakernel import _scene_table

    tab = _scene_table(js)
    n = int(js.radius.shape[0])
    spec = pl.BlockSpec((SUB, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        functools.partial(tkexp._kernel, n=n, variant=variant),
        grid=(comps[0].shape[0] // SUB,),
        in_specs=[pl.BlockSpec((N_ROWS, n), lambda i: (0, 0), memory_space=pltpu.SMEM)]
        + [spec] * 7,
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(comps[0].shape, jnp.float32), interpret=True)
    ref = np.asarray(call(tab, *comps)).reshape(-1)
    sph = torch.from_numpy(np.asarray(tab))
    got = kexp.run([torch.from_numpy(x) for x in flat], sph, variant).numpy()
    _agree(got, ref, _t64(flat, sph), variant)
    # unrolling changes no value
    same = kexp.run([torch.from_numpy(x) for x in flat], sph, variant.split("_")[0]).numpy()
    np.testing.assert_array_equal(got, same)


def test_kexp_rejects_unknown_variants():
    with pytest.raises(ValueError, match="variant"):
        kexp.parse("full_u2")


def test_probes_refuse_the_cpu_for_measurements():
    """A measurement needs a card: no CPU number is reported as one."""
    with pytest.raises(RuntimeError, match="CUDA card"):
        roofline.fma_peak("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        kfront.measure(kfront.probe_scene(None), "cpu")


def test_marginal_ms_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        marginal_ms(lambda s: None, 1, 2, 1)


def test_probe_launch_counts_start_at_zero():
    probes.reset_launches()
    assert set(probes.LAUNCHES) == {"fma", "mixed", "kfront_front", "kfront_brute",
                                    *(f"kexp_{v}" for v in kexp.VARIANTS)}
    assert not any(probes.LAUNCHES.values())


def test_probe_constants_match_the_cuda_source():
    """The wrappers' constants are the kernels': rays a block (padding),
    the staged chunk (the tests' edges) and the eight probe_hit_kernel
    instantiations rtp_probe_hit dispatches to."""
    import re
    from pathlib import Path

    src = (Path(probes.__file__).parents[1] / "csrc" / "probes.cu").read_text()
    assert re.search(rf"constexpr int PTPB = {probes.PTPB};", src)
    assert re.search(rf"constexpr int CHUNK = {probes.CHUNK};", src)
    body = src[src.index("HitKernel hit_kernel("):]
    body = body[:body.index("return nullptr;")]
    names = {"WIDE": 0, "SLIM": 1, "OUT_T": 0, "OUT_KEXP": 1, "OUT_SUM": 2}
    found = {(names[v], int(u), names[o]) for v, u, o in
             re.findall(r"probe_hit_kernel<(\w+), (\d), (\w+)>", body)}
    assert found == set(probes.HIT_ARGS.values()) and len(found) == 8


def _schedule_lane_by_lane(rays, sph, ff, fi):
    """`kfront.warp_schedule` counted one warp, word and column position at
    a time, from each lane's own list."""
    n = rays[0].shape[0]
    rays = [torch.cat([x, x[:1].expand(-(-n // 32) * 32 - n)]) for x in rays]
    live = kfront.live_columns(rays, sph, ff, fi).numpy()
    word = kfront.column_owner(fi, sph.shape[1]).numpy() // 24
    out = {"pairs": 0, "steps": 0, "union_steps": 0, "loads": 0, "waves": 0}
    for w0 in range(0, live.shape[0], 32):
        for wd in np.unique(word):
            lists = [np.nonzero(live[w0 + lane] & (word == wd))[0] for lane in range(32)]
            longest = max(len(x) for x in lists)
            out["pairs"] += sum(len(x) for x in lists)
            out["steps"] += longest // 8
            out["union_steps"] += len(set().union(*(set(x) for x in lists))) // 8
            for i in range(longest):
                cols = {int(x[i]) for x in lists if i < len(x)}
                out["loads"] += 1
                out["waves"] += max(sum(c % 8 == q for c in cols) for q in range(8))
    return out


@pytest.mark.parametrize("case", ["cover F=24", "cover F=48", "diverging, 2,000 spheres"])
def test_warp_schedule_counts_each_lanes_own_list(case):
    """The front probe's pairs, warp steps, union steps and shared-memory
    wavefronts (`warp_schedule`, vectorised) equal a lane-by-lane count, on
    200 cover primary rays (padded to 7 warps) and on rays whose warps
    diverge (`diverging_rays`: lanes into the densest subtree beside lanes
    that miss every box), where the own lists are shorter than the
    union."""
    if case.startswith("cover"):
        _, ps = _cover_pair()
        tabs = kfront.pack_front_tables(ps, max_nodes=int(case[-2:]))
        flat, _ = _cover_rays(n=256, seed=9)
        rays = [torch.from_numpy(x[:200]) for x in flat]
    else:
        tabs = kfront.pack_front_tables(kfront.probe_scene(2000), max_nodes=24)
        rays = kfront.diverging_rays(tabs[1], tabs[2], 96)
    got = kfront.warp_schedule(rays, *tabs, chunk=64)
    assert got == _schedule_lane_by_lane(rays, *tabs)
    assert got["steps"] <= got["union_steps"] and got["loads"] <= got["waves"]
    if case.startswith("diverging"):
        assert got["steps"] < got["union_steps"]


def test_front_plain_on_diverging_warps_matches_the_brute_scan():
    """On warps whose lanes enter different subtrees (rays into the densest
    subtree beside rays that miss every box), the front probe's plain
    version finds the brute probe's t on every ray, and the missing rays
    write 0."""
    from raytracingproject_tpu_torch.bvh import build_bvh, reorder_scene

    scene = kfront.probe_scene(2000)
    sph, ff, fi = kfront.pack_front_tables(scene, max_nodes=24)
    rays = kfront.diverging_rays(ff, fi, 256)
    front = kfront.run_front(rays, sph, ff, fi)
    brute = kfront.run_brute(rays, scene_table(reorder_scene(scene, build_bvh(scene, 8))))
    assert torch.equal(front, brute)
    assert (front[1::2] == 0).all() and (front[0::2] > 0).any()
