"""Sharded fit traffic: a closed loop of train steps of
`parallel.make_sharded_train_step` over the cell's ranks, one process a
card (portbench/ranks.py): the recording forward of the two-phase
pipeline on the front, the path replay, the gradients' all-reduce and
Adam, each `step(params, opt_state, None, target)` to synchronised
params, loss and gradients on every rank.

The mesh is the configuration's `deployment.mesh` (rays x samples ranks,
`make_mesh`). Inputs, all from the seed and alike on every rank, as the
fit traffic makes them (fit.py): the true scene, the start scene, the
target (the plain reference's render, each rank rendering a quarter of
its pixels, gathered), the step generator. Set-up builds the step on
every rank and runs its first `check_steps` steps; the window goes on
with the same step.

Every rank counts the steps, of set-up and of the window, after which
its loss or a trained parameter is not finite; the counts are summed
over the ranks every step (on the host, over a gloo group, so that no
device work of the benchmark's lies in the window) and compared as
`nonfinite_steps`. The check (every reading on standard error, the
compared ones among them): the plain sharded reference
(reference/sharded_fit.py) follows the first steps from the same start,
target and step generator; compared as for the fit (`readings` of
fit.py), with two refusals more: a reference whose loss, gradient or
change is not finite, and a leaf with no sphere to compare, read NaN,
which fails every limit.

Parameters: fit.py's, and two_phase (the cut depth), cap_frac (the
survivor capacity). A traced run's every rank times `replay_units` steps
whole, then `SPAN_UNITS` steps more under a host-only profiler for their
`rtp.shard.*` spans.
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from portbench import ranks
from portbench.harness import rng, torch_seed
from portbench.reference import frame as ref_frame
from portbench.reference import sharded_fit as ref_sharded
from portbench.traffic.fit import COMPARED, change_of, in_order, order_of, perturbed, readings
from portbench.traffic.frame import camera_of, scene_of, sync

SPANS = "rtp.shard."
SPAN_UNITS = 3


def _target(arrays: dict, cam: dict, width: int, height: int, p: dict, seed: int, rank: int,
            size: int, device) -> torch.Tensor:
    """The reference's render of the true scene [H, W, 3]: this rank's
    share of the pixels (the list padded to a multiple of `size`), all
    gathered; every rank draws the whole frame's draws alike."""
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 5))
    n = width * height
    pix = np.concatenate([np.arange(n), np.zeros((-n) % size, np.int64)])
    mine = np.array_split(pix, size)[rank]
    part = ref_frame.pixels(arrays, cam, width, height, p["target_spp"], p["depth"], gen, mine)
    parts = [torch.empty_like(part) for _ in range(size)]
    dist.all_gather(parts, part.contiguous())
    return torch.cat(parts)[:n].reshape(height, width, 3)


class RankFit:
    """One rank's set-up, train steps and counts."""

    def __init__(self, rank: int, size: int, device, bench, cell, seed: int):
        from raytracingproject_tpu_torch.config import RenderSettings
        from raytracingproject_tpu_torch.parallel import make_mesh, make_sharded_train_step
        from raytracingproject_tpu_torch.render import prepare_scene

        p = self.params = cell.params
        self.rank, self.size, self.device = rank, size, torch.device(device)
        mesh_shape = cell.config["deployment"]["mesh"]
        if mesh_shape["rays"] * mesh_shape["samples"] != size:
            raise ValueError(f"the mesh {mesh_shape} does not hold {size} ranks")
        self.camera = camera_of(cell.config, p)
        self.width, self.height = self.camera.image_size()
        true = bench.scene_arrays(cell.config, seed)
        self.start = perturbed(true, p["perturb"], rng(seed, 4))
        self.target = _target(true, cell.config["camera"], self.width, self.height, p, seed,
                              rank, size, self.device)
        # the steps' non-finite counts, summed over the ranks on the host
        self.tally = dist.new_group(backend="gloo")
        self.nonfinite = torch.zeros(size, dtype=torch.int64)
        mesh = make_mesh(self.device, samples_axis_size=mesh_shape["samples"])
        settings = RenderSettings(device=self.device, two_phase=p["two_phase"])
        scene, front = prepare_scene(scene_of(self.start, self.device), self.camera, settings)
        self.order = order_of(scene, self.start)
        gen = torch.Generator(device=self.device).manual_seed(torch_seed(seed, 6))
        self.params_, self.opt, self.step = make_sharded_train_step(
            scene, self.camera, mesh, use_megakernel=True, front=front,
            two_phase=p["two_phase"], cap_frac=p["cap_frac"], trainable=tuple(p["trainable"]),
            learning_rate=p["lr"], spp=p["spp"], generator=gen)
        self.trained = {f: getattr(self.params_, f) for f in p["trainable"]}
        p0 = {f: v.detach().clone() for f, v in self.trained.items()}
        self.losses = []
        for k in range(int(p["check_steps"])):
            self.unit()
            if k == 0:
                beta1 = self.opt.param_groups[0]["betas"][0]
                self.grad1 = {f: self.opt.state[v].get("exp_avg", torch.zeros_like(v)).detach()
                              / (1.0 - beta1) for f, v in self.trained.items()}
        self.change = {f: v.detach() - p0[f] for f, v in self.trained.items()}
        self.grad1, self.change = in_order(self.grad1, self.order), in_order(self.change, self.order)

    def unit(self) -> None:
        self.params_, self.opt, loss, _ = self.step(self.params_, self.opt, None, self.target)
        sync(self.device)
        ok = torch.stack([torch.isfinite(loss).all()]
                         + [torch.isfinite(v).all() for v in self.trained.values()]).all()
        flags = torch.zeros(self.size, dtype=torch.int64)
        flags[self.rank] = int(not bool(ok))
        dist.all_reduce(flags, group=self.tally)
        self.nonfinite += flags
        if len(self.losses) < int(self.params["check_steps"]):
            self.losses.append(float(loss))

    def spans(self) -> dict:
        """Host seconds of `replay_units` whole steps ("step"), then of the
        program's `rtp.shard.*` spans in `SPAN_UNITS` steps more, recorded
        by a host-only profiler (one list a span, a step's value each)."""
        steps = []
        for _ in range(int(self.params["replay_units"])):
            t = time.perf_counter()
            self.unit()
            steps.append(time.perf_counter() - t)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(SPAN_UNITS):
                self.unit()
        out = {"step": steps}
        for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
            if ev.name.startswith(SPANS):
                out.setdefault(ev.name, []).append((ev.time_range.end - ev.time_range.start) * 1e-6)
        return out

    def release(self) -> None:
        self.step = self.opt = self.params_ = self.trained = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def rank_fit(rank: int, size: int, device, bench, cell, seed: int) -> RankFit:
    return RankFit(rank, size, device, bench, cell, seed)


class ShardedFitJob:
    """The cell's world of ranks (rank 0 here), its window's units and its
    check."""

    def __init__(self, bench, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.world = ranks.World(rank_fit, cell, device, args=(bench, cell, seed))
        self.local = self.world.local
        self.released = False
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
        if not self.released:
            self.world.release()
            self.released = True

    # what portbench.calibrate reads of a fit job: rank 0's first steps
    losses = property(lambda self: self.local.losses)
    grad1 = property(lambda self: self.local.grad1)
    change = property(lambda self: self.local.change)

    def reference(self, dtype=torch.float32, half: bool = False,
                  fault_step: int | None = None, alone: bool = False) -> dict:
        """The plain sharded reference's first steps in `dtype`, on rank
        0's card once the world is released (released here if it is not);
        `half`, `fault_step` and `alone` plant reference/sharded_fit.py's
        faults."""
        self.release()
        p, mesh = self.cell.params, self.cell.config["deployment"]["mesh"]
        gen = torch.Generator(device=self.device).manual_seed(torch_seed(self.seed, 6))
        local = self.local
        return ref_sharded.steps(local.start, local.target, self.cell.config["camera"],
                                 local.width, local.height, p["spp"], p["depth"], gen,
                                 int(p["check_steps"]), p["lr"], p["trainable"], mesh["rays"],
                                 mesh["samples"], dtype, half, fault_step, alone)

    def readings(self, ref: dict) -> dict:
        local = self.local
        out = strict_readings(local.losses, local.grad1, local.change, ref)
        out["nonfinite_steps"] = int(local.nonfinite.sum())
        out["nonfinite_by_rank"] = local.nonfinite.tolist()
        return out

    def check(self) -> dict:
        got = self.readings(self.reference())
        print(f"portbench: readings {json.dumps(got)}", file=sys.stderr)
        lim = self.cell.limits
        return {k: (float(got[k]), lim[k]) for k in (*COMPARED, "nonfinite_steps")}


def strict_readings(losses, grad1: dict, change: dict, ref: dict) -> dict:
    """fit.py's `readings`, and NaN for every compared number where the
    reference's losses, first gradient or change are not finite, and for
    a leaf's gap where no sphere of the leaf has a reference row to
    compare (fit.py reads such a leaf as 0)."""
    out = readings(losses, grad1, change, ref)
    c_ref = change_of(ref)
    values = [torch.as_tensor(x, dtype=torch.float64) for x in ref["loss"]]
    values += [v.double() for v in (*ref["grad"][0].values(), *c_ref.values())]
    if not all(bool(torch.isfinite(v).all()) for v in values):
        return {**out, **{k: math.nan for k in COMPARED}}
    moved = [f for f in c_ref if _moved(ref, f)]
    for key, leaves, table in (("grad1_gap", list(ref["grad"][0]), ref["grad"][0]),
                               ("change_gap", moved, c_ref)):
        for f in leaves:
            rows = table[f].reshape(table[f].shape[0], -1).norm(dim=1)
            if not bool((rows > 0).any()):
                out[f"{f}_{key}"] = out[key] = math.nan
    return out


def _moved(ref: dict, f: str) -> bool:
    """Whether fit.py's `readings` compares leaf `f`'s change (its first
    gradient's norm at least a thousandth of the median leaf's)."""
    norms = {g: float(v.norm()) for g, v in ref["grad"][0].items()}
    return norms[f] >= 1e-3 * float(np.median(list(norms.values())))


def prepare(bench, cell, seed: int, device) -> ShardedFitJob:
    return ShardedFitJob(bench, cell, seed, device)
