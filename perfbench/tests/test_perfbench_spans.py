"""Reading the program's spans (``harness.spans``) and the span tool
(``tools/spans.py``): on synthetic event lists, a kernel inside nested
spans counts toward both, a gap toward the innermost span open at its
midpoint, and with the spans left out the timeline reads as it did
without them; on the CPU, a tiny cell's traced run counts each span's
calls; on the card, each reading is positive and nested as its spans
are."""
from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import tiny
from harness import runner, spans, spec, trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
TOOL = spec.load_module(spec.HERE / "tools" / "spans.py", "spans_tool")


def ev(name, a, b, children=(), device=CPU, corr=0):
    return SimpleNamespace(name=name, device_type=device, id=corr,
                           time_range=SimpleNamespace(start=a, end=b),
                           cpu_children=list(children))


def op(name, a, b, corr):
    """A host op whose launch call (correlation ``corr``) starts at a+1."""
    return ev(name, a, b, [ev("cudaLaunchKernel", a + 1, a + 2, corr=corr)])


def kernel(name, a, b, corr):
    return ev(name, a, b, device=CUDA, corr=corr)


def _walk(e):
    yield e
    for c in e.cpu_children:
        yield from _walk(c)


def timeline(with_spans: bool):
    """A step: AdamW launches k1 and k2, the MoE's slot scan k3 inside
    ``moe/slots`` inside ``moe/experts``, then a product k4; each kernel
    shares its launch call's correlation id; times in microseconds.
    Without spans the same ops run unwrapped."""
    mul, add = op("aten::mul", 12, 20, 1), op("aten::add", 30, 40, 2)
    scan, mm = op("aten::cumsum", 63, 70, 3), op("aten::mm", 82, 85, 4)
    if with_spans:
        adam = ev("optim/adamw", 10, 60, [mul, add])
        slots = ev("moe/slots", 62, 80, [scan])
        experts = ev("moe/experts", 61, 90, [slots, mm])
        top = [adam, experts]
    else:
        top = [mul, add, scan, mm]
    host = list(_walk(ev("bench.train_step", 0, 100, top)))
    dev = [kernel("k1", 20, 25, 1), kernel("k2", 41, 45, 2),
           kernel("k3", 70, 77, 3), kernel("k4", 86, 88, 4)]
    if with_spans:      # the spans' device-side rows
        dev += [ev("optim/adamw", 20, 45, device=CUDA),
                ev("moe/experts", 70, 88, device=CUDA)]
    return host + dev


def test_nested_spans_count_their_kernels_and_the_innermost_gaps():
    out = spans.read(timeline(True))
    s = out["spans"]
    assert out["bench_calls"] == 1
    assert s["optim/adamw"] == pytest.approx(
        {"calls": 1, "device_s": 9e-6, "launches": 2,
         "idle_s": (41 - 25) / 1e6 + (70 - 45) / 1e6})
    # k3 counts toward both MoE spans; k4 toward the outer one alone
    assert s["moe/slots"]["device_s"] == pytest.approx(7e-6)
    assert s["moe/experts"]["device_s"] == pytest.approx(9e-6)
    assert s["moe/experts"]["launches"] == 2
    # the gap 77..86 (midpoint 81.5) lies inside moe/experts alone; no gap
    # midpoint lies inside moe/slots
    assert s["moe/experts"]["idle_s"] == pytest.approx(9e-6)
    assert s["moe/slots"]["idle_s"] == 0
    assert s["attention/grad"]["calls"] == 0


def test_gap_at_a_nested_midpoint_goes_to_the_inner_span():
    inner = ev("moe/slots", 20, 40, [op("aten::cumsum", 21, 25, 1)])
    outer = ev("moe/experts", 0, 100, [inner])
    evs = list(_walk(outer)) + [kernel("k1", 22, 25, 1),
                                kernel("k2", 41, 50, 2)]
    s = spans.read(evs)["spans"]
    assert s["moe/slots"]["idle_s"] == pytest.approx(16e-6)
    assert s["moe/experts"]["idle_s"] == 0


def test_the_timeline_reads_as_without_spans():
    """With the program's spans left out, ``busy_s``, ``kernels``,
    ``device_ops`` and ``idle_gaps`` read as the same ops unwrapped."""
    plain = trace.read(timeline(False), 1e-4)
    got = TOOL._read_with_spans(trace.read)(timeline(True), 1e-4)
    for key in ("busy_s", "window_s", "kernels", "launches", "device_ops",
                "idle_gaps"):
        assert got[key] == plain[key], key
    assert got["bench_calls"] == 1 and "spans" in got


@pytest.mark.parametrize("cell", ["smollm-360m.train-b16-s2k",
                                  "deepseek-v2-lite-16b.prefill-b32-s1k"])
def test_tiny_traced_run_counts_each_span(cell, monkeypatch):
    """On the CPU no kernel runs on a card: the spans' calls are counted,
    their device time is none."""
    monkeypatch.setattr(trace, "read", TOOL._read_with_spans(trace.read))
    ctx = tiny.context(cell)
    ctx.trace = True
    rec = runner.drive(ctx)
    tr = rec["trace"]
    steps = ctx.traffic.get("trace_steps", ctx.traffic.get("trace_calls"))
    assert tr["bench_calls"] == steps
    layers = ctx.config["num_hidden_layers"]
    if rec["kind"] == "train":
        want = {"optim/adamw": steps, "model/unembed": steps}
    else:
        want = {"model/unembed": steps, "moe/experts": steps * layers,
                "moe/slots": steps * layers}
    for name, s in tr["spans"].items():
        assert s["calls"] == want.get(name, 0), name
        assert s["device_s"] == 0 and s["launches"] == 0
    table = TOOL.per_step(tr, rec["kind"])
    assert table["steps_or_calls"] == steps
    assert set(table["readings"]) <= {m for m, *_ in TOOL.READINGS[
        rec["kind"]]}


def test_span_cost_is_timed_with_the_profiler_off_and_on():
    out = TOOL.span_cost(200)
    assert len(out["us_off"]) == len(out["us_on"]) == 3
    assert all(x > 0 for x in out["us_off"] + out["us_on"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["smollm-360m.prefill-b32-s2k",
                                  "deepseek-v2-lite-16b.prefill-b32-s1k"])
def test_span_readings_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "perfbench/tools/spans.py", "--workload", cell,
         "--seed", "2147483661", "--seconds", "2"],
        capture_output=True, text=True, timeout=900, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    r = line["readings"]
    assert r["unembed_ms.prefill"] > 0
    if cell.startswith("deepseek"):
        assert 0 < r["moe_slots_ms.prefill"] <= r["moe_ms.prefill"]
