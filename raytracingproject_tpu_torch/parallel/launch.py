"""Run a function on every rank of a local world: the multi-rank runner
of the sharded entry points.

`run_world(fn, world_size, store_dir)` spawns `world_size` processes
(torch.multiprocessing, `spawn`), each of which joins one gloo process
group through a FileStore in a fresh directory under `store_dir`, builds
the CPU mesh (`make_mesh("cpu")`) and returns `fn(mesh, *args)`; the
results come back in rank order. Every rank runs PyTorch on one thread
(the first multi-threaded CPU op of a fresh process can round one
worker's share differently; ROADMAP Queue 3). Every wait is bounded by
`timeout_s`: a rank that fails or hangs fails the call, and every rank
is stopped. (Several cards are one process a card under a launcher such
as torchrun: `multihost_init(backend="nccl")`, then `make_mesh()`, which
puts each rank on card LOCAL_RANK.)

`fn` and its arguments are pickled into the ranks, so `fn` is a
module-level function: `render_job` and `train_job` below drive
`render_sharded` and the sharded train steps, and `run_jobs` runs several
jobs in one world.

    from raytracingproject_tpu_torch.parallel.launch import render_job, run_world
    images = run_world(render_job, 4, "/tmp/world", samples_axis_size=2,
                       args=(scene, camera, 0))
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from raytracingproject_tpu_torch.grad.inverse import SceneParams
from raytracingproject_tpu_torch.parallel.mesh import make_mesh, mesh_device
from raytracingproject_tpu_torch.parallel.shard import (
    make_sharded_soft_train_step, make_sharded_train_step, mesh_coords, render_sharded,
)


def _rank_main(rank: int, world_size: int, store_path: str, samples_axis_size: int,
               timeout_s: float, fn, args, results) -> None:
    """One rank: join the group, build the mesh, put (rank, fn's result,
    None) or (rank, None, traceback) on `results`."""
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world_size),
                                rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        mesh = make_mesh("cpu", samples_axis_size)
        results.put((rank, fn(mesh, *args), None))
    except Exception:  # the boundary of the rank: report to the parent, which raises
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world_size: int, store_dir: str, *, samples_axis_size: int = 1,
              timeout_s: float = 120.0, args: tuple = ()) -> list:
    """[fn(mesh, *args) of rank 0, ..., of rank world_size - 1], each run
    in its own process on a (world_size // samples_axis_size,
    samples_axis_size) CPU mesh. Raises RuntimeError with the rank's
    traceback when a rank fails, and TimeoutError when the world does not
    finish within `timeout_s`."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_path = os.path.join(tempfile.mkdtemp(dir=store_dir), "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, store_path, samples_axis_size, timeout_s, fn,
                               args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            try:
                rank, value, err = results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue_mod.Empty:
                raise TimeoutError(f"the world of {world_size} ranks did not finish in "
                                   f"{timeout_s} s (ranks done: {sorted(out)})") from None
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{err}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0) if len(out) == world_size
                   else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
    return [out[r] for r in range(world_size)]


def _numpy(x):
    return x.detach().cpu().numpy()


def run_jobs(mesh, jobs) -> list:
    """[fn(mesh, *args) for fn, args in jobs]: several jobs in one world,
    one after another (a world's start costs seconds)."""
    return [fn(mesh, *args) for fn, args in jobs]


def render_job(mesh, scene, camera, seed: int, spp: int | None = None,
               use_megakernel: bool = False, front=None) -> dict:
    """`render_sharded` with a generator seeded with `seed` on the mesh's
    device: {"image": the mean image [H, W, 3] as numpy, "coords": this
    rank's (ray_id, s_id, n_rays, n_samples)}."""
    gen = torch.Generator(device=mesh_device(mesh)).manual_seed(seed)
    img = render_sharded(scene, camera, gen, mesh, spp=spp, use_megakernel=use_megakernel,
                         front=front)
    return {"image": _numpy(img), "coords": mesh_coords(mesh)}


def train_job(mesh, scene, camera, target, seeds, soft: bool = False, mask=None,
              step_kwargs=None) -> dict:
    """Steps of `make_sharded_train_step` (or, with `soft`,
    `make_sharded_soft_train_step`) built with `step_kwargs`, one a seed
    of `seeds` (each step's generator seeded with it, on the mesh's
    device), against `target` [H, W, 3]. `mask` (a SceneParams of 0/1
    tensors) keeps only the masked entries of each update, as the JAX
    tests' masked steps do. Returns {"loss": [...], "grads":
    [SceneParams of numpy, one a step], "params": the last parameters as
    numpy}."""
    make = make_sharded_soft_train_step if soft else make_sharded_train_step
    device = mesh_device(mesh)
    params, opt, step = make(scene, camera, mesh, **(step_kwargs or {}))
    losses, grads = [], []
    for seed in seeds:
        gen = torch.Generator(device=device).manual_seed(seed)
        old = [p.detach().clone() for p in params]
        params, opt, loss, g = step(params, opt, gen, target.to(device))
        if mask is not None:
            with torch.no_grad():
                for p, o, m in zip(params, old, mask):
                    p.copy_(o + (p - o) * m.to(device))
        losses.append(float(loss))
        grads.append(SceneParams(*(_numpy(x) for x in g)))
    return {"loss": losses, "grads": grads, "params": SceneParams(*(_numpy(p) for p in params))}
