"""The readings a cell's limits are set from, on the card, in one process:
for each seed, what the program gives (the lower readings) and, on the
first seeds, what the control gives (the plain reference computed in
bfloat16 in the program's place, and for the fit the planted faults):
the upper readings. One JSON line a reading, then a summary line.

    python3 -m portbench.calibrate --workload <cell> --seed <first> --seeds 12 --control 3

Frames: the cell's set-up and `check_frames` frames of its own size, each
compared as a run compares it. Fit: set-up's first steps (no window).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from portbench.harness import Bench, guard


def frame_readings(job, control: bool) -> list[dict]:
    from portbench.traffic.frame import pixel_gaps

    for _ in range(int(job.params["check_frames"])):
        job.unit()
    out = []
    for i, img in job.kept:
        pix = job.sample(i)
        ref = job.reference(i, pix)
        got = img.reshape(-1, 3)[torch.as_tensor(pix, device=img.device)]
        rows = [("program", got)]
        if control:
            rows.append(("control_bf16", job.reference(i, pix, torch.bfloat16)))
        for side, val in rows:
            mean, gap = pixel_gaps(val, ref)
            out.append({"side": side, "frame": i, "pixel_mean_gap": mean, "pixel_max_gap": gap})
    return out


def fit_readings(job, control: bool, quantiles=(None,)) -> list[dict]:
    """The fit's readings, at each of `quantiles` (None: the cell's own
    `QUANTILE`) of a leaf's spheres' gaps."""
    from portbench.traffic.fit import QUANTILE, change_of, readings

    ref = job.reference()
    sides = [("program", job.losses, job.grad1, job.change)]
    if control:
        for side, alt in (("control_bf16", job.reference(torch.bfloat16)),
                          ("fault_half_batch", job.reference(half=True))):
            sides.append((side, alt["loss"], alt["grad"][0], change_of(alt)))
        zero = {f: torch.zeros_like(v) for f, v in ref["params"].items()}
        sides.append(("fault_state_unchanged", job.losses, job.grad1, zero))
    out = []
    for q in quantiles:
        tag = "" if q is None else f"@{q:g}"
        for side, loss, grad1, change in sides:
            out.append({"side": side + tag,
                        **readings(loss, grad1, change, ref, QUANTILE if q is None else q)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True, help="the first seed")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    ap.add_argument("--quantile", type=float, nargs="*", default=None,
                    help="fit: read at these quantiles of a leaf's spheres' gaps as well")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = Bench.at(Path.cwd())
    cell = bench.cell(args.workload)
    traffic = bench.module("traffic", cell.kind)
    quantiles = (None, *args.quantile) if args.quantile else (None,)
    read = frame_readings if cell.kind == "frame" else (
        lambda job, control: fit_readings(job, control, quantiles))
    worst: dict = {}
    for k in range(args.seeds):
        seed = args.seed + k
        t = time.perf_counter()
        job = traffic.prepare(bench, cell, seed, "cuda")
        for row in read(job, k < args.control):
            row.update(seed=seed, seconds=time.perf_counter() - t)
            print(json.dumps(row), flush=True)
            for key, v in row.items():
                if key.endswith("_gap"):
                    agg = worst.setdefault(row["side"], {}).setdefault(key, [v, v])
                    agg[0], agg[1] = min(agg[0], v), max(agg[1], v)
        del job
        torch.cuda.empty_cache()
    guard()
    print(json.dumps({"cell": cell.name, "limits": cell.limits, "min_max": worst,
                      "card": torch.cuda.get_device_name()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
