"""The readers of the program's spans (portbench/spans.py and the metrics
that use it) on a hand-built trace: nested and overlapping host spans,
device intervals and the gaps between them."""

from __future__ import annotations

import pytest

from portbench.harness import UNIT, WINDOW, Bench, Run, Trace
from portbench.tests.conftest import manifest

# profiler microseconds; window [0, 100 ms], two units
DEVICE = [("k", 10e3, 20e3), ("k", 40e3, 60e3), ("memcpy", 90e3, 95e3)]
# gaps: [0, 10], [20, 40], [60, 90], [95, 100] ms
HOST = [
    (WINDOW, 0.0, 100e3, ""), (UNIT, 0.0, 50e3, ""), (UNIT, 50e3, 100e3, ""),
    ("rtp.render", 1e3, 99e3, ""),
    ("rtp.prepare_scene", 5e3, 30e3, ""),
    ("rtp.prep.front", 8e3, 25e3, ""),         # nested in prep
    ("rtp.prep.front_hbm", 25e3, 29e3, ""),    # not the front's span
    ("rtp.pass", 30e3, 70e3, ""),
    ("rtp.pass", 65e3, 98e3, ""),              # overlaps the first
    ("rtp.pass.trace", 40e3, 60e3, ""),
    ("rtp.sync.seed", 32e3, 36e3, ""),
    ("rtp.sync.table", 34e3, 38e3, ""),        # overlaps the seed read
    ("rtp.syncing", 50e3, 60e3, ""),           # not under rtp.sync.
    ("rtp.upload.slot_order", -5e3, 3e3, ""),  # starts before the window
    ("rtp.upload.gather", 99e3, 104e3, ""),    # ends after it
    ("rtp.fit.step", 40e3, 80e3, ""),
    ("rtp.fit.replay", 41e3, 62e3, ""),
    ("rtp.fit.replay", 75e3, 85e3, ""),        # ends after the step
    ("aten::add", 41e3, 42e3, "raytracingproject_tpu_torch/grad/replay.py"),
]
EXPECTED = {  # ms a unit; the share in per cent
    "prep_span_ms.frame": 25 / 2,
    "front_span_ms.frame": 17 / 2,
    "pass_idle_ms.frame": (10 + 30 + 3) / 2,  # [30, 40], [60, 90], [95, 98]
    "sync_span_ms.frame": (6 + 3 + 1) / 2,    # the reads and the uploads
    "upload_span_ms.frame": (3 + 1) / 2,
    "replay_share.fit": 100 * (21 + 5) / 40,  # [41, 62], [75, 80] of [40, 80]
}


def reader(name: str):
    return Bench(manifest()).module("metrics", name).read


def traced(host=HOST, device=DEVICE, units=2) -> Run:
    return Run(setup_s=1.0, trace=Trace(list(device), list(host), 0.0, 100e3, units))


def test_the_span_metrics_are_in_the_manifest():
    got = {m["name"] for m in manifest()["per_layer"]}
    assert set(EXPECTED) <= got


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_ms_a_unit(name):
    """Each reader's number on the hand-built trace (the share: per cent)."""
    assert reader(name)(traced()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_without_its_spans(name):
    """No trace, a trace without the program's spans (a program that has
    none), a trace with no device operation (a CPU run) or no unit: None."""
    read = reader(name)
    assert read(Run(setup_s=1.0)) is None
    assert read(traced(host=[h for h in HOST if not h[0].startswith("rtp.")])) is None
    assert read(traced(device=[])) is None
    assert read(traced(units=0)) is None


def test_spans_outside_the_window_are_not_read():
    host = [h for h in HOST if not h[0].startswith("rtp.")]
    host.append(("rtp.prepare_scene", 101e3, 120e3, ""))
    assert reader("prep_span_ms.frame")(traced(host=host)) is None


def test_idle_inside_a_span_with_a_busy_device_is_zero():
    host = [h for h in HOST if not h[0].startswith("rtp.")] + [("rtp.pass", 42e3, 58e3, "")]
    assert reader("pass_idle_ms.frame")(traced(host=host)) == 0.0


def test_share_needs_both_spans():
    """The replay's share reads None without the step's span or without the
    replay's, and 0 when the replay lies outside every step."""
    read = reader("replay_share.fit")
    assert read(traced(host=[h for h in HOST if h[0] != "rtp.fit.step"])) is None
    assert read(traced(host=[h for h in HOST if h[0] != "rtp.fit.replay"])) is None
    host = [h for h in HOST if not h[0].startswith("rtp.fit.")]
    host += [("rtp.fit.step", 10e3, 20e3, ""), ("rtp.fit.replay", 30e3, 40e3, "")]
    assert read(traced(host=host)) == 0.0


def test_sync_reads_each_wait_once():
    """A copy inside a read's span (nested waits) is counted once."""
    host = [h for h in HOST if not h[0].startswith("rtp.")]
    host += [("rtp.sync.seed", 10e3, 20e3, ""), ("rtp.upload.gather", 12e3, 14e3, ""),
             ("rtp.upload.slot_order", 30e3, 32e3, "")]
    assert reader("sync_span_ms.frame")(traced(host=host)) == pytest.approx(12 / 2, rel=1e-12)
