"""A traffic kind of the tests, copied into a throwaway cell's directory:
a cell over several ranks (portbench/ranks.py) on gloo.

Each rank holds its slice of a vector drawn from the seed (every
`size`-th entry); unit k all-reduces k times the slices into a running
sum, which every rank keeps. Set-up runs one unit. The check: rank 0's
sum against numpy's over the whole vector.

Parameters: length (a rank's slice), fault (planted on rank `fault_rank`
at the window's first unit: "raise", "sleep" past any timeout, "die";
"jax" loads a stub `jax` at set-up; "" none), fault_rank, peak (rank r
reports r * peak bytes, 0: the device's own).
"""

from __future__ import annotations

import importlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from portbench import ranks
from portbench.harness import rng


class RankJob:
    def __init__(self, rank: int, size: int, params: dict, seed: int):
        self.rank, self.params = rank, params
        full = rng(seed, 7).standard_normal(params["length"] * size)
        self.mine = torch.from_numpy(full[rank::size].copy())
        self.total = torch.zeros_like(self.mine)
        self.count = 0
        planted = rank == params["fault_rank"]
        if planted and params["fault"] == "jax":
            importlib.import_module("jax")
        if rank and params["peak"]:
            ranks.peak_bytes = lambda device: rank * params["peak"]
        self.fault = params["fault"] if planted else ""

    def unit(self) -> None:
        self.count += 1
        if self.count == 2:  # the window's first unit
            if self.fault == "raise":
                raise ValueError("a planted fault")
            if self.fault == "sleep":
                time.sleep(3600)  # the launcher kills it
            if self.fault == "die":
                os._exit(3)
        part = self.mine * self.count
        dist.all_reduce(part)
        self.total += part

    def spans(self) -> dict:
        t = time.perf_counter()
        self.unit()
        return {"unit": [time.perf_counter() - t]}


def rank_job(rank: int, size: int, device, params: dict, seed: int) -> RankJob:
    return RankJob(rank, size, params, seed)


class Job:
    def __init__(self, bench, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.world = ranks.World(rank_job, cell, device, args=(cell.params, seed))
        self.world.unit()
        self.count = 0

    def unit(self) -> None:
        self.world.unit()
        self.count += 1

    def spans(self) -> dict:
        return self.world.spans()

    def peaks(self) -> list:
        return self.world.peaks

    def rank_spans(self) -> list:
        return self.world.rank_spans

    def release(self) -> None:
        self.world.release()

    def check(self) -> dict:
        local = self.world.local
        size, length = self.cell.chips, self.cell.params["length"]
        full = rng(self.seed, 7).standard_normal(length * size)
        want = full.reshape(length, size).sum(axis=1) * local.count * (local.count + 1) / 2
        gap = float(np.max(np.abs(local.total.numpy() - want)))
        return {"sum_gap": (gap, self.cell.limits["sum_gap"])}


def prepare(bench, cell, seed: int, device) -> Job:
    return Job(bench, cell, seed, device)
