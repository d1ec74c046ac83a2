"""Fixtures of the benchmark's tests: throwaway cells made of files in a
temporary directory, and the card, looked for inside a fixture."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest

from portbench.harness import HERE, Bench

ROOT = HERE.parent
TINY_FRAME = {"kind": "frame",
              "params": {"width": 24, "spp": 2, "depth": 5, "check_frames": 2, "check_pixels": 64,
                         "trace_units": 2, "prep_calls": 2},
              "limits": {"pixel_mean_gap": 0.001, "pixel_max_gap": 0.05}}
TINY_FIT = {"kind": "fit",
            "params": {"width": 16, "spp": 2, "depth": 5, "lr": 0.01,
                       "trainable": ["albedo", "fuzz", "ior"],
                       "perturb": {"albedo": [0.7, 1.3], "fuzz": 0.1, "ior": [0.95, 1.05]},
                       "target_spp": 2, "check_steps": 3, "trace_units": 1,
                       "replay_units": 1},
            "limits": {"loss1_gap": 0.01, "grad1_gap": 0.03, "change_gap": 0.05}}


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def add_cell(tmp: Path, m: dict, name: str, config: str, spec: dict, like: str,
             chips: int = 1) -> None:
    """Add cell `name` on `chips` chips to manifest `m` as a file under
    `tmp`, reporting the metrics that cell `like` reports."""
    (tmp / "workloads").mkdir(parents=True, exist_ok=True)
    (tmp / "workloads" / f"{name}.json").write_text(json.dumps(spec))
    m["workloads"].append({"name": name, "config": config, "traffic": name, "chips": chips,
                           "why": "a throwaway cell of the tests"})
    for sec in ("end_to_end", "per_layer"):
        for e in m[sec]:
            if like in e.get("workloads", []):
                e["workloads"].append(name)


@pytest.fixture
def tiny(tmp_path) -> Bench:
    """The manifest with two throwaway cells on the cover scene, `tiny.frame`
    and `tiny.fit`, added as files under a temporary directory."""
    m = copy.deepcopy(manifest())
    add_cell(tmp_path, m, "tiny.frame", "cover488", TINY_FRAME, "rand50k.preview")
    add_cell(tmp_path, m, "tiny.fit", "cover488", TINY_FIT, "cover.fit")
    return Bench(m, [tmp_path, HERE])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.get_device_name()
