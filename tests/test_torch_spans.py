"""The port's spans and counters (utils/profiling.py: `span`, `sync`,
`upload`, `COUNTS`): nothing is built while no profiler records; under
the profiler a render and a fast train step give the tree of `rtp.*`
ranges the benchmark reads, none of them a user annotation; the counters
count passes, host waits and uploaded bytes; a refused front shows in the
trace; the CLI's --trace writes the spans; the block order uploads on a
cold render alone. CPU only; imports nothing of the JAX package."""

import json
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import raytracingproject_tpu_torch as rt
from raytracingproject_tpu_torch.__main__ import main as cli_main
from raytracingproject_tpu_torch.grad import make_fast_train_step
from raytracingproject_tpu_torch.ops.cuda.megakernel import TILE
from raytracingproject_tpu_torch.parallel import make_mesh, make_sharded_train_step, render_sharded
from raytracingproject_tpu_torch.render import _block_order, _slot_gather, _slot_ij, prepare_scene
from raytracingproject_tpu_torch.scene import make_random_scene
from raytracingproject_tpu_torch.utils import profiling

CAM = rt.Camera(aspect_ratio=16 / 9, image_width=32, samples_per_pixel=8, max_depth=3, vfov=20.0,
                lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0))
# 32 x 18 pixels, 4 samples a pass: 2 passes
SETTINGS = rt.RenderSettings(device="cpu", rays_per_batch=32 * 18 * 4)
PASSES = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread: the shapes are too small to split."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def cover():
    return rt.make_cover_scene(0)


def cold_block_order():
    """Empty the block order's device caches: the next render uploads it."""
    _slot_ij.cache_clear()
    _slot_gather.cache_clear()


def render_cover():
    return rt.render(cover(), CAM, torch.Generator().manual_seed(1), SETTINGS)


def profiled(fn):
    """The `rtp.*` events of a CPU profile of `fn()`, as (name, start, end,
    is_user_annotation)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end, e.is_user_annotation)
            for e in prof.events() if e.name.startswith("rtp.")]


def inside(events, outer: str, inner: str) -> bool:
    """Every `inner` event lies in the interval of some `outer` event."""
    outs = [(s, e) for n, s, e, _ in events if n == outer]
    ins = [(s, e) for n, s, e, _ in events if n == inner]
    return bool(ins) and all(any(os <= s and e <= oe for os, oe in outs) for s, e in ins)


def names(events) -> list[str]:
    return [n for n, *_ in events]


def test_span_off_builds_nothing(monkeypatch):
    """With no profiler recording, a span is the one shared null context
    and no profiler range is ever built: a render runs with the range's
    constructor made to raise."""
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} was built with no profiler running")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    assert profiling.span("rtp.a") is profiling.span("rtp.b")
    img = rt.render(cover(), CAM, torch.Generator().manual_seed(1), SETTINGS)
    assert img.shape == (18, 32, 3) and torch.isfinite(img).all()
    assert profiling.COUNTS["passes"] == PASSES


def test_render_spans_nest_by_layer():
    """A cold render under the profiler: rtp.render holds rtp.prepare_scene,
    which holds the BVH build and the front build; one rtp.pass and one
    seed read a pass, each pass holding its rays and trace; the block
    order's one upload in the first pass's rays, the gather's in the image;
    and no range is a user annotation (the profiler would copy one onto the
    device's timeline)."""
    cold_block_order()
    ev = profiled(render_cover)
    n = names(ev)
    assert n.count("rtp.render") == 1 and n.count("rtp.prepare_scene") == 1
    assert n.count("rtp.pass") == PASSES and n.count("rtp.sync.seed") == PASSES
    assert n.count("rtp.pass.trace") == PASSES and n.count("rtp.upload.slot_order") == 1
    assert n.count("rtp.upload.gather") == 1
    first_rays = min((s, e) for name, s, e, _ in ev if name == "rtp.pass.rays")
    (upload,) = [(s, e) for name, s, e, _ in ev if name == "rtp.upload.slot_order"]
    assert first_rays[0] <= upload[0] and upload[1] <= first_rays[1]
    assert "rtp.prep.front_hbm" not in n  # the cover's front fits shared memory
    for outer, inner in [("rtp.render", "rtp.prepare_scene"), ("rtp.prepare_scene", "rtp.prep.bvh"),
                         ("rtp.prepare_scene", "rtp.prep.reorder"),
                         ("rtp.prepare_scene", "rtp.prep.front"), ("rtp.render", "rtp.pass"),
                         ("rtp.pass", "rtp.sync.seed"), ("rtp.pass", "rtp.pass.rays"),
                         ("rtp.pass.rays", "rtp.upload.slot_order"), ("rtp.pass", "rtp.pass.trace"),
                         ("rtp.render", "rtp.pass.image"), ("rtp.pass.image", "rtp.upload.gather"),
                         ("rtp.prepare_scene", "rtp.sync.table")]:
        assert inside(ev, outer, inner), (outer, inner)
    assert not any(ua for *_, ua in ev)


def test_warm_render_uploads_nothing():
    """A second render of the same shape reuses the block order on the
    device: no rtp.upload.* span, and every host wait is a seed or table
    read."""
    cold_block_order()
    render_cover()
    profiling.reset_counters()
    ev = profiled(render_cover)
    n = names(ev)
    assert n.count("rtp.pass") == PASSES and n.count("rtp.pass.image") == 1
    assert not [name for name in n if name.startswith("rtp.upload.")]
    assert profiling.COUNTS["upload_bytes"] == 0
    assert profiling.COUNTS["host_syncs"] == n.count("rtp.sync.seed") + n.count(
        "rtp.sync.table") >= PASSES + 1


def test_fit_step_spans_nest():
    """A fast train step under the profiler: rtp.fit.step holds the seed
    read, the recording forward, the replay backward (with its live-depth
    reads) and Adam; none a user annotation."""
    cam = rt.Camera(aspect_ratio=1.0, image_width=12, samples_per_pixel=2, max_depth=3, vfov=50.0,
                    lookfrom=(0, 0, 2), lookat=(0, 0, 0))
    ball = rt.SceneBuilder().add_lambertian((0, 0, 0), 0.7, (0.4, 0.4, 0.4)).build()
    params, opt, step = make_fast_train_step(ball, cam, spp=2, trainable=("albedo",),
                                             device="cpu")
    target = torch.full((12, 12, 3), 0.5)
    profiling.reset_counters()  # the step's waits only, not the set-up's
    ev = profiled(lambda: step(params, opt, None, target))
    n = names(ev)
    assert n.count("rtp.fit.step") == 1
    for inner in ("rtp.sync.seed", "rtp.fit.record", "rtp.fit.replay", "rtp.fit.adam"):
        assert n.count(inner) == 1 and inside(ev, "rtp.fit.step", inner), inner
    assert inside(ev, "rtp.fit.replay", "rtp.sync.live_depth")
    assert not any(ua for *_, ua in ev)
    # the seed and one live-depth read a replayed phase: one host wait each
    assert profiling.COUNTS["host_syncs"] == n.count("rtp.sync.seed") + n.count(
        "rtp.sync.live_depth") >= 2


@pytest.fixture
def world_of_one():
    """This process's own gloo world of one (make_mesh starts it), taken
    down after the test."""
    yield make_mesh("cpu")
    dist.destroy_process_group()


def ball_fit():
    cam = rt.Camera(aspect_ratio=1.0, image_width=12, samples_per_pixel=2, max_depth=3, vfov=50.0,
                    lookfrom=(0, 0, 2), lookat=(0, 0, 0))
    ball = rt.SceneBuilder().add_metal((0, 0, 0), 0.7, (0.6, 0.5, 0.4), 0.2).build()
    return ball, cam, torch.full((12, 12, 3), 0.5)


@pytest.mark.parametrize("two_phase", [None, 2])
def test_sharded_step_spans_and_collectives(world_of_one, two_phase):
    """A sharded fast step under the profiler: rtp.shard.step holds the
    base read, the forward (with its seed read), the image's reduce, the
    backward, the gradients' reduce and Adam, none a user annotation; its
    four all-reduces count with this rank's bytes: the image, the loss,
    and the flat gradient over each mesh axis."""
    ball, cam, target = ball_fit()
    params, opt, step = make_sharded_train_step(ball, cam, world_of_one, spp=2,
                                                use_megakernel=True, two_phase=two_phase,
                                                trainable=("albedo", "fuzz"))
    profiling.reset_counters()
    ev = profiled(lambda: step(params, opt, None, target))
    n = names(ev)
    assert n.count("rtp.shard.step") == 1
    for inner in ("rtp.sync.base", "rtp.shard.forward", "rtp.shard.reduce.image",
                  "rtp.shard.backward", "rtp.shard.reduce.grad", "rtp.fit.adam"):
        assert n.count(inner) == 1 and inside(ev, "rtp.shard.step", inner), inner
    assert inside(ev, "rtp.shard.forward", "rtp.sync.seed")
    assert not any(ua for *_, ua in ev)
    flat = sum(p.numel() for p in params) * 4
    assert profiling.COUNTS["collectives"] == 4
    assert profiling.COUNTS["collective_bytes"] == 12 * 12 * 3 * 4 + 4 + 2 * flat
    assert profiling.COUNTS["host_syncs"] == sum(x.startswith("rtp.sync.") for x in n)


def test_sharded_render_counts_its_collectives(world_of_one):
    """render_sharded's sample all-reduce and ray all-gather: two
    collectives over this rank's radiance sum, and no step span."""
    ball, cam, _ = ball_fit()
    ev = profiled(lambda: render_sharded(ball, cam, torch.Generator().manual_seed(2),
                                         world_of_one, use_megakernel=True))
    assert profiling.COUNTS["collectives"] == 2
    assert profiling.COUNTS["collective_bytes"] == 2 * 12 * 12 * 3 * 4
    assert "rtp.shard.step" not in names(ev) and "rtp.sync.base" in names(ev)


def test_counts_of_a_render():
    """One cold render counts its frame, its passes, a host wait for each
    seed read, table read and blocking upload, and the bytes of the host
    arrays it uploaded: the slot order and the gather, once each."""
    cold_block_order()
    render_cover()
    c = profiling.counters()
    slot_pix, gather = _block_order(32, 18, 4, TILE)
    assert c["frames"] == 1 and c["passes"] == PASSES
    assert c["upload_bytes"] == slot_pix.nbytes + gather.nbytes
    # seeds, the two uploads and at least one table read
    assert c["host_syncs"] >= PASSES + 3
    assert set(profiling.COUNTS) == {"frames", "passes", "host_syncs", "upload_bytes",
                                     "collectives", "collective_bytes", "routes.front",
                                     "routes.bvh", "routes.front_hbm", "front_refusals"}
    # the cover's front fits shared memory: K3's route, nothing refused
    assert c["routes.front"] == 1 and c["routes.bvh"] == c["front_refusals"] == 0
    assert c["collectives"] == c["collective_bytes"] == 0  # a render on one device
    # the plain versions launch no kernel
    assert c["launches.front"] == 0 and "launches.closest_hit" in c
    profiling.reset_counters()
    assert not any(profiling.COUNTS.values())


def test_counts_of_a_warm_render():
    """A warm render of the same shape uploads no byte and waits on the
    host for its seeds and table reads alone: the cold render's count less
    its two uploads."""
    cold_block_order()
    render_cover()
    cold = profiling.counters()
    profiling.reset_counters()
    render_cover()
    c = profiling.counters()
    assert c["frames"] == 1 and c["passes"] == PASSES
    assert c["upload_bytes"] == 0
    assert c["host_syncs"] == cold["host_syncs"] - 2 >= PASSES + 1


def _refused_once(n_spheres: int) -> bool:
    """Prepare make_random_scene(n_spheres) under the profiler: one
    `rtp.prep.front` span, then one `rtp.prep.bvh_nodes` (K8's node
    records), both in the scene's prep, no K7 front, one refusal and one
    `routes.bvh` counted. Returns whether a table was read inside the
    front's span."""
    scene = make_random_scene(n_spheres, seed=3)
    ev = profiled(lambda: prepare_scene(scene, CAM, rt.RenderSettings(device="cpu")))
    n = names(ev)
    assert n.count("rtp.prep.front") == 1 and n.count("rtp.prep.bvh_nodes") == 1
    assert "rtp.prep.front_hbm" not in n
    ((front_start, front_end),) = [(s, e) for name, s, e, _ in ev if name == "rtp.prep.front"]
    (nodes_start,) = [s for name, s, _, _ in ev if name == "rtp.prep.bvh_nodes"]
    assert front_end <= nodes_start
    assert inside(ev, "rtp.prepare_scene", "rtp.prep.front")
    assert inside(ev, "rtp.prepare_scene", "rtp.prep.bvh_nodes")
    c = profiling.counters()
    assert (c["front_refusals"], c["routes.bvh"], c["routes.front"]) == (1, 1, 0)
    return any(name == "rtp.sync.table" and front_start <= s and e <= front_end
               for name, s, e, _ in ev)


def test_front_over_budget_counts_one_refusal():
    """A scene whose front passes shared memory takes the BVH walk after one
    refusal (`_refused_once`). 4,000 spheres at 64 B each already pass the
    budget, so the refusal comes before any front is built: no table is
    read in the front's span."""
    assert not _refused_once(4000)


def test_front_refused_once_built_takes_the_walk():
    """3,500 spheres fall under the early bound: the front is built (the
    table read in its span), refused, and the scene takes the BVH walk
    (`_refused_once`)."""
    assert _refused_once(3500)


def test_cli_trace_writes_the_spans(tmp_path, capsys):
    """--trace DIR renders under the profiler and writes DIR/trace.json with
    the program's spans; stderr gives rays a second and the counters."""
    out = tmp_path / "img.ppm"
    assert cli_main(["--scene", "three", "--width", "32", "--spp", "2", "--depth", "3",
                     "--device", "cpu", "-o", str(out), "--trace", str(tmp_path / "prof")]) == 0
    assert out.read_text().startswith("P3\n32 18\n")
    events = json.loads(Path(tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    got = {e.get("name") for e in events}
    assert {"rtp.render", "rtp.pass"} <= got
    err = capsys.readouterr().err
    assert "Mrays/s" in err and "frames=1 passes=1" in err


@pytest.mark.cuda
def test_spans_have_no_device_copies_on_the_card():
    """On the card, under CPU and CUDA activity: the render's spans are in
    the trace, none on the device's timeline (a user annotation would be
    copied there and count as device work), and the kernels are."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    settings = rt.RenderSettings(device="cuda")
    rt.render(cover(), CAM, None, settings)  # builds the kernels outside the profile
    with torch.profiler.profile(activities=acts) as prof:
        rt.render(cover(), CAM, None, settings)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    host = {e.name for e in prof.events() if e.device_type != cuda}
    device = {e.name for e in prof.events() if e.device_type == cuda}
    assert {"rtp.render", "rtp.pass", "rtp.pass.trace"} <= host
    assert not {n for n in device if n.startswith("rtp.")}
    assert any("trace_kernel" in n for n in device)
