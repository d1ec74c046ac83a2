"""Profiling and observability (counterpart of
raytracingproject_tpu/utils/profiling.py).

The reference's perf tooling is an FPS overlay and a device memory dump.
Here:
- `span`: a named range on the profiler's clock, opened at each layer
  boundary of the program (`rtp.*`), and nothing while no profiler
  records; `sync` is the span of a host wait for the device, counted;
- `COUNTS` / `count` / `counters`: always-on integer counters (frames,
  passes, host syncs, bytes uploaded, collectives and the bytes they
  reduce or gather) beside the kernel launches;
- `trace`: a torch.profiler capture of the host and, with a card, the
  device around a block, optionally written as a Chrome trace (the
  spans included);
- `RaysPerSecond`: a rays-a-second meter that waits for the card before
  it reads the clock;
- `device_memory_stats`: each card's allocator statistics.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

# Counters of the program's work, added to where the work happens; never
# a host read of a device value. `host_syncs` counts `sync` spans,
# `upload_bytes` the host arrays copied to the device, `collectives` the
# torch.distributed calls of parallel/ and `collective_bytes` the bytes of
# this rank's tensor in each; `routes.*` the closest hit each
# `render.prepare_scene` picks (K3's front, K8's tree, K7's front),
# `front_refusals` the shared-memory fronts it refused.
COUNTS = {"frames": 0, "passes": 0, "host_syncs": 0, "upload_bytes": 0, "collectives": 0,
          "collective_bytes": 0, "routes.front": 0, "routes.bvh": 0, "routes.front_hbm": 0,
          "front_refusals": 0}

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: while a torch.profiler session records, a range
    `name` in its trace, on the clock of the device's kernels and copies,
    nested in the ranges open on the thread; otherwise one shared null
    context (one flag read: no object built, no device synchronised).

    The range is not a user annotation (`record_function` makes one), so
    the profiler copies none of it onto the device's timeline, where it
    would count as device work."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    COUNTS[name] += n


def sync(name: str):
    """The span `name` of a host wait for the device, counted in
    `host_syncs`: a read of a device value, or a blocking copy from
    pageable host memory (torch's copy with non_blocking=False waits for
    the stream's queued work before it returns)."""
    COUNTS["host_syncs"] += 1
    return span(name)


def reset_counters() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def counters() -> dict:
    """`COUNTS` and the kernel launches (`launches.<key>`, from
    ops.cuda.megakernel.LAUNCHES and ops.cuda.trace.LAUNCHES), in one new
    dict."""
    from raytracingproject_tpu_torch.ops.cuda import megakernel, trace as closest_hit

    out = dict(COUNTS)
    for launches in (megakernel.LAUNCHES, closest_hit.LAUNCHES):
        out.update({f"launches.{k}": v for k, v in launches.items()})
    return out


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile the block (CPU activity, and CUDA activity with a card):

        with profiling.trace("prof") as prof:
            render(...)
        print(prof.key_averages().table())

    Yields the torch.profiler.profile; with `log_dir` its Chrome trace is
    written to log_dir/trace.json when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class RaysPerSecond:
    """Rays-a-second meter, the FPS overlay's analog (validation.h:31).
    start() and stop() wait for the card (when one is in use), so an
    interval holds the device work queued in it."""

    total_rays: int = 0
    total_seconds: float = 0.0
    _t0: float | None = field(default=None, repr=False)

    def start(self) -> None:
        _sync()
        self._t0 = time.perf_counter()

    def stop(self, rays: int) -> float:
        """Record `rays` traced since start(); returns that interval's rays/s."""
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        _sync()
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.total_rays += rays
        self.total_seconds += dt
        return rays / dt if dt > 0 else float("inf")

    @property
    def average(self) -> float:
        return self.total_rays / self.total_seconds if self.total_seconds else 0.0


def device_memory_stats() -> list[dict]:
    """One dict per card (torch.cuda.memory_stats: bytes in use and their
    peak, as the caching allocator counts them; the card's total memory as
    the limit), or, without a card, one for the CPU with no counts."""
    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "kind": "cpu", "bytes_in_use": None,
                 "bytes_limit": None, "peak_bytes_in_use": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "id": i,
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(i),
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        })
    return out
