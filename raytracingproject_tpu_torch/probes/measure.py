"""Device time of one pass of a kernel, as the marginal cost between two
pass counts (tools/measure.py of the JAX package, on CUDA events).

Each rep records events around k1 passes and then around k2 more, and
takes (t(k2) - t(k1)) / (k2 - k1): the launch latency and the event
overheads fall out. Every pass gets a fresh seed, which the caller uses to
pick fresh inputs.
"""

from __future__ import annotations

import os
import statistics
from typing import Callable

import torch


def fresh_salt() -> int:
    return int.from_bytes(os.urandom(4), "little") % (2**30)


def marginal_ms(fn: Callable[[int], object], k1: int = 4, k2: int = 12, reps: int = 3) -> float:
    """Median marginal milliseconds of one `fn(seed)` pass on the current
    CUDA device. A rep whose
    k2 passes took no longer than its k1 passes is dropped; if every rep is,
    it raises (the timing is broken, as in tools/measure.py)."""
    if not torch.cuda.is_available():
        raise RuntimeError("marginal_ms times kernels on a CUDA card; there is none")
    if not 0 < k1 < k2:
        raise ValueError(f"pass counts must satisfy 0 < k1 < k2, got {k1}, {k2}")
    fn(fresh_salt())  # warm: build, load, first launch
    torch.cuda.synchronize()
    marginals = []
    for _ in range(reps):
        salt = fresh_salt()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        for i in range(k1):
            fn(salt + i)
        ev[1].record()
        for i in range(k2):
            fn(salt + k1 + i)
        ev[2].record()
        torch.cuda.synchronize()
        d1, d2 = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        if d2 <= d1:
            continue
        marginals.append((d2 - d1) / (k2 - k1))
    if not marginals:
        raise RuntimeError("timing reps all showed dt(k2) <= dt(k1): the timing is broken")
    return statistics.median(marginals)
