"""Profiling and observability (counterpart of
raytracingproject_tpu/utils/profiling.py).

The reference's perf tooling is an FPS overlay and a device memory dump.
Here:
- `trace`: a torch.profiler capture of the host and, with a card, the
  device around a block, optionally written as a Chrome trace;
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
