"""The sharded fit traffic (traffic/sharded_fit.py) and its plain sharded
reference (reference/sharded_fit.py), on the CPU: a four-rank gloo world
runs the program's `make_sharded_train_step` at a small size through the
rank launcher, and its first steps match the reference, which catches a
wrong draw planted in step 2; the reference derives each rank's stream as
the program does; and the check refuses a reference that is not finite or
a leaf with no sphere to compare."""

from __future__ import annotations

import copy
import math
import time

import pytest
import torch

from portbench import ranks
from portbench.harness import HERE, Bench, run_cell
from portbench.reference import sharded_fit as ref_sharded
from portbench.tests.conftest import add_cell, manifest
from portbench.traffic import sharded_fit

SEED = 2**31 + 4099
TINY = {"kind": "sharded_fit",
        "params": {"width": 16, "spp": 2, "depth": 5, "lr": 0.01,
                   "trainable": ["albedo", "fuzz", "ior"],
                   "perturb": {"albedo": [0.7, 1.3], "fuzz": 0.1, "ior": [0.95, 1.05]},
                   "target_spp": 2, "check_steps": 3, "two_phase": 2, "cap_frac": 0.25,
                   "trace_units": 1, "replay_units": 1},
        "limits": {"loss1_gap": 0.01, "grad1_gap": 0.01, "change_gap": 0.25,
                   "nonfinite_steps": 0}}


def quiet(*args, **kwargs):
    pass


def tiny_bench(tmp) -> Bench:
    m = copy.deepcopy(manifest())
    add_cell(tmp, m, "tiny.fit_x4", "cover488_dp4", TINY, "cover.fit_x4", chips=4)
    return Bench(m, [tmp, HERE])


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """The tiny cell's job after set-up (three checked steps on four gloo
    ranks), two window steps and its release."""
    bench = tiny_bench(tmp_path_factory.mktemp("cells"))
    cell = bench.cell("tiny.fit_x4")
    torch.set_num_threads(1)
    job = bench.module("traffic", cell.kind).prepare(bench, cell, SEED, "cpu")
    job.unit()
    job.unit()
    job.release()
    return job


def test_sharded_steps_match_the_reference(released):
    """Every rank's steps stay finite, and each step's loss, the first
    gradient and the change over the three steps match the plain sharded
    reference within the cell's limits (on the CPU, to rounding)."""
    got = released.readings(released.reference())
    assert got["nonfinite_steps"] == 0 and got["nonfinite_by_rank"] == [0, 0, 0, 0]
    assert got["loss_worst"] < 1e-5 and got["grad1_gap"] < 1e-4 and got["change_gap"] < 1e-4
    checks = released.check()
    assert set(checks) == {"loss1_gap", "grad1_gap", "change_gap", "nonfinite_steps"}
    assert all(v <= lim for v, lim in checks.values())
    assert released.count == 2 and len(released.peaks()) == 4


def test_wrong_draw_in_step_two_is_caught(released):
    """A reference that draws step 2's base twice (every rank's draws
    wrong from step 2 on) agrees on step 1 and fails the check: the later
    losses and the change part ways."""
    got = released.readings(released.reference(fault_step=2))
    lim = released.cell.limits
    assert got["loss1_gap"] < 1e-5
    assert got["loss_worst"] > 1e-3
    assert any(not got[k] <= lim[k] for k in ("loss1_gap", "grad1_gap", "change_gap"))


def test_dropped_gradient_exchange_is_caught(released):
    """A reference that leaves the gradients' all-reduce out (rank 0's
    update from its own pixels alone) agrees on step 1's loss and fails
    the check on the first gradient."""
    got = released.readings(released.reference(alone=True))
    assert got["loss1_gap"] < 1e-5
    assert not got["grad1_gap"] <= released.cell.limits["grad1_gap"]


def test_calibrate_reads_the_sharded_job(released):
    """`portbench.calibrate` reads the sharded job as it reads a fit's: the
    program's first steps and, for the control, the reference in bfloat16
    and the planted faults, each a reading of the change far over the
    program's."""
    from portbench.calibrate import fit_readings

    rows = {r["side"]: r for r in fit_readings(released, True)}
    assert set(rows) == {"program", "control_bf16", "fault_half_batch",
                         "fault_state_unchanged"}
    assert rows["program"]["change_gap"] < 1e-4
    for side in ("control_bf16", "fault_half_batch", "fault_state_unchanged"):
        assert rows[side]["change_gap"] > 0.25, side


def test_reference_streams_are_the_programs():
    """reference/sharded_fit.py's generator of the rank at (ray_id, s_id)
    draws what the program's `shard_generator` draws, for bases beyond 32
    bits; and its pixel slices are the program's `_local_pixels`."""
    from raytracingproject_tpu_torch.parallel.shard import _local_pixels, shard_generator

    for base in (0, 12345, 2**61 + 977, 2**62 - 1):
        for r, s in ((0, 0), (3, 0), (1, 1)):
            a = torch.rand(5, generator=ref_sharded.rank_generator(base, r, s, "cpu"))
            b = torch.rand(5, generator=shard_generator(base, r, s, "cpu"))
            assert torch.equal(a, b)
    for w, h, n in ((16, 9, 4), (7, 5, 4), (24, 13, 2)):
        for r, pix in enumerate(ref_sharded.slices(w, h, n)):
            i, j, _, _ = _local_pixels(w, h, n, r, "cpu")
            assert torch.equal(pix, (j.long() * w + i.long()))


def _ref(loss=0.1, grad=None, change=None) -> dict:
    grad = grad if grad is not None else {"albedo": torch.ones(4, 3), "fuzz": torch.ones(4)}
    start = {f: torch.zeros_like(v) for f, v in grad.items()}
    params = change if change is not None else {f: 0.01 * v for f, v in grad.items()}
    return {"loss": [loss, loss, loss], "grad": [grad], "params": params, "start": start}


def test_strict_readings_refuse_what_cannot_be_compared():
    """A sound reference reads gaps of 0 against itself; a reference with
    a non-finite loss, gradient or change makes every compared number NaN;
    a leaf whose reference rows are all zero reads NaN, not 0."""
    ref = _ref()
    grad1 = ref["grad"][0]
    change = {f: ref["params"][f] - ref["start"][f] for f in grad1}
    ok = sharded_fit.strict_readings([0.1] * 3, grad1, change, ref)
    assert ok["loss1_gap"] == ok["grad1_gap"] == ok["change_gap"] == 0.0
    bad_grad = {"albedo": torch.ones(4, 3), "fuzz": torch.tensor([1.0, math.nan, 1.0, 1.0])}
    for broken in (_ref(loss=math.inf), _ref(grad=bad_grad)):
        got = sharded_fit.strict_readings([0.1] * 3, grad1, change, broken)
        assert all(math.isnan(got[k]) for k in ("loss1_gap", "grad1_gap", "change_gap"))
    empty = _ref(grad={"albedo": torch.ones(4, 3), "fuzz": torch.zeros(4)})
    got = sharded_fit.strict_readings([0.1] * 3, grad1, change, empty)
    assert math.isnan(got["fuzz_grad1_gap"]) and math.isnan(got["grad1_gap"])


def test_traced_run_reads_its_layer_metrics(tmp_path, monkeypatch):
    """The tiny cell through `run_cell` with tracing on, on the CPU: it is
    correct, and of its layer metrics those with something to read there
    read: the host-clock step (the fit's metric) and every rank's
    backward span (the collectives' and the recording's device time needs
    a card)."""
    monkeypatch.setattr(ranks, "TIMEOUT_S", 60.0)
    monkeypatch.setattr(sharded_fit, "SPAN_UNITS", 2)
    torch.set_num_threads(1)
    out = run_cell(tiny_bench(tmp_path), "tiny.fit_x4", SEED, 2.0, True, "cpu",
                   time.perf_counter(), log=quiet)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"step_ms.fit", "rank_skew.fit_x4"}
    assert out["metrics"]["rank_skew.fit_x4"]["value"] >= 100.0
