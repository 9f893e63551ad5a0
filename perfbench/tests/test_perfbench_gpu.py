"""On the card: one short run of the cheapest cell through ``run.py``, its
result line whole and correct.  Skips without a card (decided in the
fixture)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from harness import spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_short_run_on_the_card(card):
    cell = "smollm-360m.prefill-b32-s2k"
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    names = {m["name"] for m in spec.metrics_of(spec.benchmark(), cell,
                                                True)}
    assert set(res["metrics"]) == names
    assert 0 < res["metrics"]["b8_roofline.prefill"]["value"] <= 100
