"""The mesh of ranks (counterpart of raytracingproject_tpu/parallel/mesh.py).

JAX meshes the devices of one process; PyTorch meshes ranks, one process
each (torch.distributed). The mesh is a `DeviceMesh` of shape
(world // samples_axis_size, samples_axis_size) with the axes:

- `rays`:    pixels are sharded along this axis (the renderer's DP);
- `samples`: spp is sharded along this axis, and the partial radiance
  sums are all-reduced over it.

The group is NCCL on the card and gloo on the CPU (`device="cpu"`); there
is no fallback from one to the other. NCCL takes one rank a card, so on
one card the mesh is 1x1.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from raytracingproject_tpu_torch.config import resolve_device

# The process group each device's tensors take.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _start_world_of_one(backend: str) -> None:
    """A process group of this process alone, through a FileStore in a
    temporary directory (no TCP port), removed when the process exits."""
    store_dir = tempfile.mkdtemp(prefix="rtp_mesh_")
    atexit.register(shutil.rmtree, store_dir, ignore_errors=True)
    store = dist.FileStore(os.path.join(store_dir, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def make_mesh(
    device=None,
    samples_axis_size: int = 1,
    axis_names: tuple[str, str] = ("rays", "samples"),
) -> DeviceMesh:
    """A 2D (rays x samples) mesh over the ranks of the process group.

    `samples_axis_size` must divide the world size; the remaining factor
    becomes the rays axis. Where no process group exists, a world of one
    is started (NCCL on the card, the default, through
    `config.resolve_device`; gloo for `device="cpu"`), so every sharded
    entry point runs unchanged on one card, as the JAX package's 1x1 mesh
    does. An existing group must have the device's backend. On the card,
    rank r computes on card `LOCAL_RANK` (else r modulo the card count)."""
    device = resolve_device(device)
    backend = BACKENDS.get(device.type)
    if backend is None:
        raise ValueError(f"the mesh runs on cuda or cpu, not {device}")
    if not dist.is_initialized():
        _start_world_of_one(backend)
    elif backend not in str(dist.get_backend()):
        raise ValueError(f"the process group's backend is {dist.get_backend()!r}, and "
                         f"{device.type} tensors need {backend!r}")
    n = dist.get_world_size()
    if n % samples_axis_size != 0:
        raise ValueError(
            f"samples_axis_size {samples_axis_size} does not divide world size {n}")
    if device.type == "cuda":
        rank = dist.get_rank()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    grid = torch.arange(n).reshape(n // samples_axis_size, samples_axis_size)
    return DeviceMesh(device.type, grid, mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: the CPU, or its current card."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def multihost_init(**kwargs) -> None:
    """`torch.distributed.init_process_group(**kwargs)`; a no-op when a
    process group already exists (JAX's `jax.distributed.initialize`
    wrapper). Nothing on a machine names its cluster, so pass the address
    (`init_method="tcp://host:port"`, or a `store`), `world_size` and
    `rank`."""
    if dist.is_initialized():
        return
    dist.init_process_group(**kwargs)
