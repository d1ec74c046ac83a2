"""Run one cell of the port's benchmark on the card and print its result
line (the last line of standard output, one JSON object).

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, portbench/ and the
port (raytracingproject_tpu_torch/). With --trace 0 the line holds the
cell's end-to-end metrics, with --trace 1 its per-layer metrics read from
a torch.profiler window. Without a card, or with fewer cards than the cell
asks for, it exits 1 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def steady_host() -> None:
    """One thread for the host's numeric libraries and two cores for the
    process: the host paces every cell, and a multi-threaded pool (one
    wake-up per small host operation) or a migrating process made runs of
    one seed differ by up to 20% (PERF.md, section 6). Before numpy or
    torch is imported."""
    for var in THREAD_VARS:
        os.environ[var] = "1"
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[1:3] if len(cores) >= 3 else cores)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    steady_host()

    from portbench.harness import Bench, Refused, run_cell

    bench = Bench.at(Path.cwd())
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {cell.name} needs {cell.chips} card(s); this machine has "
              f"{have}", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = run_cell(bench, cell.name, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
