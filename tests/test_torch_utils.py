"""The port's utilities (raytracingproject_tpu_torch/utils): the contracts
of tests/test_utils.py case for case on the CPU (the rays-a-second meter,
device memory statistics, the resumable render, the training state's
round trip, the CLI's PPM), the profiler and the build directory, the
resumable render against the JAX package's, and on the card the meter's
synchronisation and the memory statistics.

The JAX package is imported inside the test that compares with it, so
the card's cases run where there is no jax:

    RTP_BACKEND=cuda python -m pytest tests/test_torch_utils.py -m cuda
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.camera import Camera
from raytracingproject_tpu_torch.config import RenderSettings
from raytracingproject_tpu_torch.grad.inverse import (
    extract_params, init_train_state, trainable_mask,
)
from raytracingproject_tpu_torch.ops.cuda import build
from raytracingproject_tpu_torch.scene import make_minimal_scene
from raytracingproject_tpu_torch.utils import checkpoint, profiling
from raytracingproject_tpu_torch.utils.cache import enable_compilation_cache
from raytracingproject_tpu_torch.utils.checkpoint import (
    load_training_state, render_checkpointed, save_training_state,
)

ROOT = Path(__file__).resolve().parents[1]
# the JAX package's default path (the oracle brute scan) and the port's
# (the megakernel with the front), both on the CPU, with rays_per_batch
# below pixels x spp so the render takes several chunks
SETTINGS = {
    "oracle": RenderSettings(device="cpu", use_megakernel=False, use_bvh=False,
                             rays_per_batch=32 * 32 * 4),
    "megakernel": RenderSettings(device="cpu", rays_per_batch=32 * 32 * 4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread for this module: its shapes are too small to
    split, and it keeps the workers of a parallel test run from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def small_camera(spp=16):
    return Camera(aspect_ratio=1.0, image_width=32, samples_per_pixel=spp, max_depth=4,
                  vfov=60.0, lookfrom=(0.0, 0.0, 2.0), lookat=(0.0, 0.0, -1.0),
                  defocus_angle=0.0)


def test_rays_per_second_meter():
    m = profiling.RaysPerSecond()
    m.start()
    rate = m.stop(1000)
    assert rate > 0 and m.total_rays == 1000
    assert m.average > 0
    with pytest.raises(RuntimeError, match="start"):
        m.stop(1)


def test_device_memory_stats():
    """Without a card: one entry, the CPU's, with no counts."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the CPU-only behaviour")
    stats = profiling.device_memory_stats()
    assert len(stats) == 1
    assert stats[0]["platform"] == "cpu" and stats[0]["bytes_in_use"] is None


@pytest.mark.parametrize("path", list(SETTINGS))
def test_render_checkpoint_resume(tmp_path, monkeypatch, path):
    """A render interrupted after its first chunk resumes from the
    checkpoint and gives exactly the image of an uninterrupted one: each
    chunk's generator is seeded from (seed, samples done), so nothing
    depends on where the run stopped."""
    scene = make_minimal_scene()
    cam = small_camera(spp=12)
    settings = SETTINGS[path]
    ck = tmp_path / "acc.npz"
    full = render_checkpointed(scene, cam, 7, ck, settings)
    assert not ck.exists()  # removed on completion

    calls = {"n": 0}
    orig = checkpoint.render_pass

    def interrupted(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:  # after the first chunk was saved: a preemption
            raise KeyboardInterrupt
        return orig(*a, **k)

    monkeypatch.setattr(checkpoint, "render_pass", interrupted)
    with pytest.raises(KeyboardInterrupt):
        render_checkpointed(scene, cam, 7, ck, settings, checkpoint_every=1)
    monkeypatch.setattr(checkpoint, "render_pass", orig)
    assert ck.exists()  # the partial state persisted
    with np.load(ck) as saved:
        assert int(saved["done"]) == 4
    resumed = render_checkpointed(scene, cam, 7, ck, settings)
    np.testing.assert_array_equal(resumed, full)
    assert full.shape == (32, 32, 3) and np.isfinite(full).all()


def test_checkpoint_of_another_render_is_not_resumed(tmp_path):
    """A checkpoint of another seed starts the render afresh."""
    scene = make_minimal_scene()
    cam = small_camera(spp=12)
    settings = SETTINGS["oracle"]
    ck = tmp_path / "acc.npz"
    np.savez(ck, acc=np.full((32, 32, 3), 1e6), done=4, spp_total=12, fingerprint="other")
    got = render_checkpointed(scene, cam, 7, ck, settings)
    np.testing.assert_array_equal(got, render_checkpointed(scene, cam, 7, tmp_path / "b.npz",
                                                           settings))


def test_render_checkpointed_matches_the_jax_package(tmp_path):
    """The resumable render against the JAX package's on its own default
    path (the oracle, passed explicitly to the port): the same scene and
    camera at 32 spp agree within Monte Carlo noise."""
    import jax

    from raytracingproject_tpu.camera import Camera as JCamera
    from raytracingproject_tpu.scene import make_minimal_scene as jminimal
    from raytracingproject_tpu.utils.checkpoint import render_checkpointed as jrender

    kw = dict(aspect_ratio=1.0, image_width=32, samples_per_pixel=32, max_depth=4, vfov=60.0,
              lookfrom=(0.0, 0.0, 2.0), lookat=(0.0, 0.0, -1.0), defocus_angle=0.0)
    got = render_checkpointed(make_minimal_scene(), Camera(**kw), 7, tmp_path / "a.npz",
                              SETTINGS["oracle"])
    want = np.asarray(jrender(jminimal(), JCamera(**kw), jax.random.PRNGKey(7),
                              tmp_path / "b.npz"))
    print(f"means: port {got.mean():.5f}, jax {want.mean():.5f}")
    assert abs(got.mean() - want.mean()) < 0.02 * want.mean()
    assert np.abs(got - want).mean() < 0.05


def test_training_state_roundtrip(tmp_path):
    """SceneParams and a torch.optim.Adam state (after two steps) survive
    a save and a load into a fresh state bit for bit; the loaded optimizer
    holds the loaded parameters and steps on as the saved one would."""
    scene = make_minimal_scene()
    mask = trainable_mask(("albedo", "center0"))
    params, opt = init_train_state(scene, mask, None, 1e-2)
    for _ in range(2):
        for p in (params.albedo, params.center0):
            p.grad = torch.ones_like(p)
        opt.step()
    p = tmp_path / "train.npz"
    save_training_state(p, params, opt, step=17)
    assert not (tmp_path / "train.tmp.npz").exists()
    fresh, fresh_opt = init_train_state(scene, mask, None, 1e-2)
    p2, o2, step = load_training_state(p, fresh, fresh_opt)
    assert step == 17 and p2 is fresh and o2 is fresh_opt
    for a, b in zip(params, p2):
        assert torch.equal(a.detach(), b.detach())
    sa, sb = opt.state_dict(), o2.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k in sa["state"]:
        for name, v in sa["state"][k].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb["state"][k][name])), name
    for o, ps in ((opt, params), (o2, p2)):
        for q in (ps.albedo, ps.center0):
            q.grad = torch.ones_like(q)
        o.step()
    assert torch.equal(params.albedo, p2.albedo) and torch.equal(params.center0, p2.center0)
    assert torch.equal(extract_params(scene).radius, p2.radius)


def test_cli_produces_ppm():
    """CLI on the CPU: a P3 image of the right size on stdout."""
    code = ("import sys; from raytracingproject_tpu_torch.__main__ import main;"
            "sys.exit(main(['--scene','minimal','--width','32','--spp','2','--depth','3',"
            "'--device','cpu','-o','-']))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert lines[:3] == ["P3", "32 18", "255"]
    assert len(lines) == 3 + 32 * 18
    assert "Done." in res.stderr


def test_trace_profiles_a_block(tmp_path):
    """`trace` yields the profiler and writes the Chrome trace where asked."""
    with profiling.trace(tmp_path / "prof") as prof:
        (torch.ones(256) * 2.0).sum()
    assert len(prof.key_averages()) > 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_compilation_cache_is_the_build_directory():
    """The port's cache is nvcc's build directory; it cannot be moved."""
    assert enable_compilation_cache() == build.BUILD_DIR
    assert enable_compilation_cache(str(build.BUILD_DIR)) == build.BUILD_DIR
    with pytest.raises(ValueError, match="build into"):
        enable_compilation_cache("elsewhere")


@pytest.mark.cuda
def test_meter_and_memory_stats_on_the_card(cuda_device):
    """On the card: the meter waits for queued work (its interval holds a
    kernel queued after start), and the memory statistics count what is
    allocated."""
    x = torch.ones((4096, 4096), device=cuda_device)
    stats = profiling.device_memory_stats()
    assert stats[0]["platform"] == "gpu" and stats[0]["bytes_in_use"] >= x.numel() * 4
    assert stats[0]["bytes_limit"] > stats[0]["bytes_in_use"]
    m = profiling.RaysPerSecond()
    m.start()
    for _ in range(50):
        x = x @ x / 4096.0
    m.stop(1)
    assert m.total_seconds > 0 and torch.isfinite(x).all()
