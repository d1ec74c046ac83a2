"""The manifest against the benchmark's contract, and every name in it
found as a file."""

from __future__ import annotations

import re

import pytest

from portbench.harness import HERE, Bench
from portbench.tests.conftest import ROOT, manifest

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == KEYS
    assert m["paths"] == ["portbench"]
    assert 1 <= len(m["command"]) <= 32 and all(isinstance(w, str) for w in m["command"])
    assert 1 <= m["run_seconds"] <= 51
    fixed = 2 * 90 * 24 + 1200
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + fixed <= 43200


def test_names_units_and_entries():
    m = manifest()
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for e in m[sec]]
    assert all(NAME.fullmatch(n) for n in names)
    for sec in ("configs", "workloads"):
        assert len({e["name"] for e in m[sec]}) == len(m[sec])
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({e["name"] for e in metrics}) == len(metrics)
    for e in metrics:
        assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert set(e) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert four_card_rule(m["workloads"])


def four_card_rule(workloads) -> bool:
    """Each cell asks for 1 or 4 chips, and at most a quarter of the cells,
    rounded down, for 4 (one always may)."""
    fours = sum(1 for w in workloads if w["chips"] == 4)
    return all(w["chips"] in (1, 4) for w in workloads) and fours <= max(1, len(workloads) // 4)


@pytest.mark.parametrize("chips,ok", [([1, 1, 1, 1], True), ([4, 1, 1, 1], True),
                                      ([4, 4, 1, 1], False), ([4], True), ([2, 1, 1, 1], False),
                                      ([4, 4] + [1] * 6, True), ([4, 4, 4] + [1] * 6, False)])
def test_four_card_rule(chips, ok):
    """One four-chip cell among four passes, a second does not; eight cells
    take two."""
    assert four_card_rule([{"chips": c} for c in chips]) is ok


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    m = manifest()
    bench = Bench(m)
    for w in m["workloads"]:
        e2e = {e["name"] for e in bench.metrics(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = bench.metrics(w["name"], "per_layer")
        assert layers
        for e in layers:  # each layer metric's cell reports what it moves
            assert e["moves"] in e2e


@pytest.mark.parametrize("sec,sub,suffix", [("configs", "configs", ".json"),
                                            ("end_to_end", "metrics", ".py"),
                                            ("per_layer", "metrics", ".py")])
def test_every_name_has_its_file(sec, sub, suffix):
    for e in manifest()[sec]:
        assert (HERE / sub / f"{e['name']}{suffix}").is_file()
    for c in manifest()["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_every_cell_resolves():
    m = manifest()
    bench = Bench(m)
    for w in m["workloads"]:
        cell = bench.cell(w["name"])
        assert (HERE / "traffic" / f"{cell.kind}.py").is_file()
        assert (HERE / "recipes" / f"{cell.config['recipe']}.py").is_file()
        assert cell.config["name"] == w["config"]
