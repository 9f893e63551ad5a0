"""The DeepSeek-V3 configuration and its cell: the work counted by hand at
the published widths, the two span metrics it adds (``mla_ms.prefill``,
``moe_route_ms.prefill``) on a synthetic record and on a tiny traced run
of both MLA cells, and a checkout without the family's file refusing the
cell at once."""
from __future__ import annotations

import shutil
import subprocess
import sys
import time

import pytest

import tiny
from harness import counts, runner, spec, weights

BENCH = spec.benchmark()
CELL = "deepseek-v3-671b.prefill-b8-s4k"
MLA_CELLS = ["deepseek-v2-lite-16b.prefill-b32-s1k", CELL]
NEW = {"mla_ms.prefill": "attention/mla", "moe_route_ms.prefill": "moe/route"}
V3 = spec.load_json(spec.HERE / "configs" / "deepseek-v3-671b.json")


def test_published_widths_counted_by_hand():
    """27 layers of MLA with the query latent (187,105,280 weights: 7,168 x
    1,536, 1,536 x 128 x 192, 7,168 x 512, 2 x 512 x 128 x 128, 7,168 x
    64, 128 x 128 x 7,168), 3 dense MLPs of 18,432 (396,361,728 each) and
    24 MoE layers of a shared expert (44,040,192), the router (1,835,008)
    and a quarter of an expert a token (8 x 8 / 256): 7.606 B a token; a
    b8-s4k call 646.97 TFLOP, of which attention 148.47; B8's bound at
    128 heads of 192/128, S 4,096: 5.56 ms."""
    assert counts.active_params_per_token(V3) == (
        27 * 187_105_280 + 3 * 396_361_728
        + 24 * (44_040_192 + 1_835_008 + 44_040_192 // 4))
    assert counts.attention_flops(V3, 8, 4096) == pytest.approx(
        27 * 2 * 8 * 128 * 4096 * 4097 / 2 * 320)
    unembed = 2.0 * 8 * 7168 * 131072
    assert counts.prefill_flops(V3, 8, 4096) == pytest.approx(
        2 * 7_606_173_696 * 32768 + 148.4703e12 + unembed, rel=1e-6)
    peaks = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    assert counts.b8_bound_s(8, 128, 128, 4096, 192, 128, peaks) == \
        pytest.approx(5.560e-3, rel=1e-3)
    # 35.44 GB of weights: bf16 but the fp32 routers (7,169 x 256 each)
    assert weights.n_params(V3) == 17_677_153_280


def test_new_metrics_read_their_spans():
    spans = {span: {"calls": 81, "device_s": 0.9, "launches": 700,
                    "idle_s": 0.0} for span in NEW.values()}
    rec = {"kind": "prefill", "trace": {"bench_calls": 3, "spans": spans}}
    for name in NEW:
        reader = spec.load_module(spec.metric_file(name), "m_" + name)
        assert reader.read(rec) == pytest.approx(300.0), name
        assert reader.read({**rec, "kind": "train"}) is None
        assert reader.read({"kind": "prefill"}) is None
        assert reader.read({"kind": "prefill", "trace": {
            "bench_calls": 3, "spans": {}}}) is None


@pytest.mark.parametrize("cell", MLA_CELLS)
def test_tiny_traced_run_counts_the_mla_and_route_spans(cell):
    """On the CPU: ``attention/mla`` once a layer a call, the MoE's spans
    once an MoE layer a call (V3's leading dense layers have none), no
    device time; the two metrics read nothing there."""
    ctx = tiny.context(cell)
    ctx.trace = True
    rec = runner.drive(ctx)
    tr = rec["trace"]
    steps = ctx.traffic["trace_calls"]
    layers = ctx.config["num_hidden_layers"]
    n_moe = layers - ctx.config.get("first_k_dense_replace", 0)
    assert {k: s["calls"] for k, s in tr["spans"].items()} == {
        "model/unembed": steps, "attention/mla": steps * layers,
        "moe/experts": steps * n_moe, "moe/slots": steps * n_moe,
        "moe/route": steps * n_moe}
    out = runner.result(ctx, rec, 1)
    assert not set(NEW) & set(out["metrics"])
    listed = {m["name"] for m in spec.metrics_of(BENCH, cell, True)}
    assert set(NEW) <= listed


def test_a_checkout_without_the_family_refuses_the_cell_at_once(tmp_path):
    """A checkout with the configuration but not its family's file:
    ``run.py`` exits non-zero, prints no result line and names the missing
    file, before any weight is drawn.  (The parent of this configuration,
    given these benchmark files, fails as fast, at the port's missing
    ``YaRN``.)"""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "perfbench" / "families" / "deepseek_v3.py").unlink()
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed",
         "2147490001", "--seconds", "10", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "families/deepseek_v3.py" in out.stderr
    assert time.perf_counter() - t0 < 60
