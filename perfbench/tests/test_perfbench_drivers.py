"""The drivers end to end on the CPU at a tiny size (the program's plain
kernels), the reference against the program, and the check against the
control and the faults: each cell's run with the timed path broken
underneath has to come out not correct under the cell's own limits.

The tiny configurations run in float32 where a test needs the sound
program to agree with the reference to round-off (so that a fault, and
not the size, is what the check sees)."""
from __future__ import annotations

import pytest

import tiny
from harness import check, control, runner, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def kind(cell):
    return spec.load_json(spec.traffic_file(
        spec.cell(BENCH, cell)["traffic"]))["driver"]


#: each cell on its own configuration (None) and on every configuration
CELL_CONFIGS = [(c, None) for c in CELLS] + [
    (c, k["name"]) for c in CELLS for k in BENCH["configs"]]


@pytest.mark.parametrize("cell,config", CELL_CONFIGS)
def test_reference_is_the_program_in_fp32(cell, config):
    """The plain reference and the port agree to round-off when both
    compute in float32: the reference follows the configuration as the
    program runs it (every configuration's family on every cell's traffic
    included)."""
    rec = runner.drive(tiny.context(cell, "float32", config_name=config))
    assert rec["numbers"], rec
    for name, value in rec["numbers"].items():
        assert value < 1e-5, (name, value)


@pytest.mark.parametrize("cell", CELLS)
def test_run_end_to_end_on_the_cpu(cell):
    """Set-up, the window, the trace and the check run; the result line
    carries the contract's keys, the numbers under the cell's limits."""
    ctx = tiny.context(cell)
    ctx.trace = True
    rec = runner.drive(ctx)
    out = runner.result(ctx, rec, 1)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["check"]) == set(rec["numbers"])
    assert set(ctx.workload["limits"]) <= set(out["check"])
    # no device: the rates are not measured, nothing is read off a trace
    assert "busy_s" in out["device"] and out["device"]["busy_s"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    ctx = tiny.context(cell, "float32")
    rec = runner.drive(ctx)
    ok, shown = check.judge(rec["numbers"], ctx.workload["limits"])
    assert ok, shown


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in the program's place, in fp8: at this size it reads
    three times the bf16 program or more on one of the cell's compared
    numbers, and is not correct under the cell's limits where they hold at
    this size (the family's ``TINY_CONTROL_REFUSED``; where they do not,
    the control is held to the cell's limit on the card,
    ``tools/readings.py``)."""
    program = runner.drive(tiny.context(cell))["numbers"]
    ctx = tiny.context(cell, "float32")
    ctx.system = (control.ControlTrain(ctx.config, ctx.traffic, "cpu")
                  if kind(cell) == "train"
                  else control.ControlPrefill(ctx.config, "cpu"))
    numbers = runner.drive(ctx)["numbers"]
    limits = ctx.workload["limits"]
    assert any(numbers[n] >= 3 * program[n] for n in limits), (numbers,
                                                               program)
    if spec.family(ctx.config).TINY_CONTROL_REFUSED:
        assert not check.judge(numbers, limits)[0], numbers


def batch(cell):
    return spec.load_json(spec.traffic_file(
        spec.cell(BENCH, cell)["traffic"]))["batch"]


#: the faults a cell can have: no half or quarter of a batch of one prompt
FAULTS = [(c, f) for c in CELLS for f in (
    control.TRAIN_FAULTS if kind(c) == "train" else control.PREFILL_FAULTS)
    if not (f in ("half_batch", "quarter_altered") and batch(c) < 4)]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    ctx = tiny.context(cell, "float32")
    table = (control.TRAIN_FAULTS if kind(cell) == "train"
             else control.PREFILL_FAULTS)
    ctx.system = (table[fault](ctx.config, ctx.traffic, "cpu")
                  if kind(cell) == "train" else table[fault](ctx.config,
                                                             "cpu"))
    rec = runner.drive(ctx)
    ok, shown = check.judge(rec["numbers"], ctx.workload["limits"])
    assert not ok, shown
