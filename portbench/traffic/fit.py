"""Fit traffic: a closed loop of train steps of
`grad.make_fast_train_step` (the recording forward on the front, the path
replay backward, Adam), each `step(params, opt_state, None, target)` to
synchronised params, loss and gradients.

Inputs, all from the seed: the true scene (the configuration's recipe),
the start scene (its trained materials perturbed), the target (the plain
reference's render of the true scene, `target_spp` samples) and the step
generator. Set-up builds the step once, runs its first `check_steps`
steps through the same call the window makes, and reads them; the window
goes on from there with the same step, parameters and optimizer.

The check: the plain reference follows those first steps from the same
start, target and draws (reference/fit.py). Compared: the first step's
loss, as a gap relative to the reference's; and, for every trained leaf,
the gradient of the first step as Adam holds it after that step (its
first moment over 1 - beta1) and the change of the parameters over the
steps, each sphere's gap relative to the reference's (row norms), read as
the leaf's `QUANTILE` over the spheres whose reference row is not zero,
the worst leaf compared (`sphere_gaps`). Leaves whose reference gradient
is under a thousandth of the median leaf's are left out of the change.
The program's spheres are matched to the reference's by centre and
radius. Beside them, not compared, the gaps of the leaves' norms
(`leaf_gaps`): one ray at a grazing hit or refraction can carry a
sphere's gradient to 1e24 on either side, and a norm with it.

Parameters: width, spp, depth, lr, trainable, perturb (albedo factor
range, fuzz offset, ior factor range), target_spp, check_steps,
trace_units, replay_units (the traced run's steps with the backward
timed, before its profiled window).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench.harness import rng, torch_seed, worst
from portbench.reference import fit as ref_fit
from portbench.reference import frame as ref_frame
from portbench.traffic.frame import camera_of, scene_of, sync


COMPARED = ("loss1_gap", "grad1_gap", "change_gap")
QUANTILE = 0.5  # of a leaf's spheres' gaps


def perturbed(arrays: dict, p: dict, gen: np.random.Generator) -> dict:
    """The start scene: albedo times U(lo, hi) clamped to [0, 1], metal
    fuzz plus U(-f, f) clamped to [0, 1], glass ior times U(lo, hi)."""
    n = arrays["radius"].shape[0]
    met, die = arrays["mat_type"] == 1, arrays["mat_type"] == 2
    out = dict(arrays)
    out["albedo"] = np.clip(arrays["albedo"] * gen.uniform(*p["albedo"], (n, 3)), 0.0, 1.0)
    out["fuzz"] = np.where(met, np.clip(arrays["fuzz"] + gen.uniform(-p["fuzz"], p["fuzz"], n),
                                        0.0, 1.0), arrays["fuzz"])
    out["ior"] = np.where(die, arrays["ior"] * gen.uniform(*p["ior"], n), arrays["ior"])
    return {k: v.astype(arrays[k].dtype) for k, v in out.items()}


def order_of(scene, arrays: dict) -> np.ndarray:
    """For each sphere of the program's `scene`, its index in `arrays`,
    matched by centre and radius."""
    at = {c.tobytes() + r.tobytes(): k
          for k, (c, r) in enumerate(zip(arrays["center0"], arrays["radius"]))}
    c0, rad = scene.center0.cpu().numpy(), scene.radius.cpu().numpy()
    if len(at) != len(rad):
        raise ValueError("two spheres share a centre and radius: no order to match")
    return np.array([at[c.tobytes() + r.tobytes()] for c, r in zip(c0, rad)])


def in_order(x: dict, order: np.ndarray) -> dict:
    """The program's per-sphere leaves `x` in the reference's order."""
    idx = torch.as_tensor(order, device=next(iter(x.values())).device)
    out = {}
    for f, v in x.items():
        out[f] = torch.empty_like(v)
        out[f][idx] = v
    return out


def sphere_gaps(got: dict, ref: dict, q: float = QUANTILE) -> dict:
    """Per leaf, the q-quantile over the spheres whose reference row is not
    zero of |got - ref| / |ref| (row norms)."""
    out = {}
    for f in ref:
        x, y = (t.reshape(t.shape[0], -1).double() for t in (got[f], ref[f]))
        size = y.norm(dim=1)
        on = size > 0
        rel = (x - y)[on].norm(dim=1) / size[on]
        out[f] = float(torch.quantile(rel, q)) if rel.numel() else 0.0
    return out


def leaf_gaps(got: dict, ref: dict, fields) -> list[float]:
    """Each leaf's gap of norms, against the larger of its own reference
    norm and the median leaf's."""
    norms = {f: float(ref[f].norm()) for f in ref}
    floor = statistics.median(norms.values())
    return [abs(float(got[f].float().norm()) - norms[f]) / (max(norms[f], floor) or 1.0)
            for f in fields]


class FitJob:
    """A fit cell's set-up (with its first, checked steps), its window's
    units (train steps) and its check."""

    def __init__(self, bench, cell, seed: int, device):
        from raytracingproject_tpu_torch.config import RenderSettings
        from raytracingproject_tpu_torch.grad import make_fast_train_step
        from raytracingproject_tpu_torch.render import prepare_scene

        p = self.params = cell.params
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.camera = camera_of(cell.config, p)
        self.width, _ = self.camera.image_size()
        self.height = self.camera.image_height
        true = bench.scene_arrays(cell.config, seed)
        self.start = perturbed(true, p["perturb"], rng(seed, 4))
        gen = torch.Generator(device=self.device).manual_seed(torch_seed(seed, 5))
        self.target = ref_frame.pixels(true, cell.config["camera"], self.width, self.height,
                                       p["target_spp"], p["depth"], gen,
                                       np.arange(self.width * self.height)
                                       ).reshape(self.height, self.width, 3)
        settings = RenderSettings(device=self.device)
        scene, front = prepare_scene(scene_of(self.start, self.device), self.camera, settings)
        self.order = order_of(scene, self.start)
        self.gen = torch.Generator(device=self.device).manual_seed(torch_seed(seed, 6))
        self.params_, self.opt, self.step = make_fast_train_step(
            scene, self.camera, spp=p["spp"], learning_rate=p["lr"],
            trainable=tuple(p["trainable"]), front=front, device=self.device,
            generator=self.gen)
        self.trained = {f: getattr(self.params_, f) for f in p["trainable"]}
        p0 = {f: v.detach().clone() for f, v in self.trained.items()}
        self.losses = []
        self.count = 0
        for k in range(int(p["check_steps"])):
            self.unit()
            if k == 0:
                beta1 = self.opt.param_groups[0]["betas"][0]
                self.grad1 = {f: self.opt.state[v].get("exp_avg", torch.zeros_like(v)).detach()
                              / (1.0 - beta1) for f, v in self.trained.items()}
        self.change = {f: v.detach() - p0[f] for f, v in self.trained.items()}
        self.grad1, self.change = in_order(self.grad1, self.order), in_order(self.change, self.order)
        self.count = 0

    def unit(self) -> None:
        self.params_, self.opt, loss, _ = self.step(self.params_, self.opt, None, self.target)
        sync(self.device)
        self.count += 1
        if len(self.losses) < int(self.params["check_steps"]):
            self.losses.append(float(loss))

    def spans(self) -> dict:
        """Host seconds of the path-replay backward (`_FastRadiance.backward`,
        synchronised at its start and end) and of the whole step, in
        `replay_units` more steps."""
        from raytracingproject_tpu_torch.grad import fast

        cls = getattr(fast, "_FastRadiance", None)
        if cls is None:
            return {}
        backward, times = cls.backward, []

        def timed(ctx, g):
            sync(self.device)
            t = time.perf_counter()
            out = backward(ctx, g)
            sync(self.device)
            times.append(time.perf_counter() - t)
            return out

        cls.backward = staticmethod(timed)
        steps = []
        try:
            for _ in range(int(self.params["replay_units"])):
                t = time.perf_counter()
                self.unit()
                steps.append(time.perf_counter() - t)
        finally:
            cls.backward = staticmethod(backward)
        return {"replay": times, "step": steps}

    def release(self) -> None:
        self.step = self.opt = self.params_ = self.trained = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float32, half: bool = False) -> dict:
        """The plain reference's first steps (reference/fit.py) in `dtype`;
        `half` plants the fault of half the batch left out."""
        p = self.params
        gen = torch.Generator(device=self.device).manual_seed(torch_seed(self.seed, 6))
        return ref_fit.steps(self.start, self.target, self.cell.config["camera"], self.width,
                             self.height, p["spp"], p["depth"], gen, int(p["check_steps"]),
                             p["lr"], p["trainable"], dtype, half)

    def check(self) -> dict:
        lim = self.cell.limits
        got = readings(self.losses, self.grad1, self.change, self.reference())
        return {k: (got[k], lim[k]) for k in COMPARED}


def change_of(ref: dict) -> dict:
    return {f: ref["params"][f] - ref["start"][f] for f in ref["params"]}


def readings(losses, grad1: dict, change: dict, ref: dict, q: float = QUANTILE) -> dict:
    """The compared numbers of a run's first steps (`grad1` and `change` in
    the reference's order) against the reference's `ref`: the first step's
    loss, and the worst leaf's `q`-quantile of the spheres' gaps of the
    first gradient and of the change. Beside them, not compared: every
    step's loss, each leaf's quantiles, and the worst leaf's gaps of norms."""
    g_ref, c_ref = ref["grad"][0], change_of(ref)
    norms = {f: float(g.norm()) for f, g in g_ref.items()}
    floor = statistics.median(norms.values())
    moved = [f for f in g_ref if norms[f] >= 1e-3 * floor]
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"])]
    grad, chg = sphere_gaps(grad1, g_ref, q), sphere_gaps(change, c_ref, q)
    out = {"loss1_gap": loss[0], "grad1_gap": worst(grad.values()),
           "change_gap": worst([chg[f] for f in moved]) if moved else 0.0,
           "loss_worst": worst(loss),
           "grad1_norm_gap": worst(leaf_gaps(grad1, g_ref, list(g_ref))),
           "change_norm_gap": worst(leaf_gaps(change, c_ref, moved)) if moved else 0.0}
    for f in g_ref:
        out[f"{f}_grad1_gap"], out[f"{f}_change_gap"] = grad[f], chg[f]
    return out


def prepare(bench, cell, seed: int, device) -> FitJob:
    return FitJob(bench, cell, seed, device)
