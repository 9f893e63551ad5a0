"""The benchmark's description and the files it names: every cell,
configuration, traffic mix, driver and metric is found by its name; names
and units keep to their characters; nothing the benchmark runs loads JAX
or the JAX package."""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from harness import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: keys of a configuration that are widths, which ``reduced`` may not name
WIDTHS = ("hidden_size", "intermediate_size", "moe_intermediate_size",
          "num_attention_heads", "num_key_value_heads",
          "num_experts_per_tok", "head_dim")


#: what a family file (``families/<reference>.py``) exposes
FAMILY_FUNCTIONS = ("block_layout", "model_config", "attention_shape",
                    "active_params_per_token")


def _width(key: str) -> bool:
    return key in WIDTHS or key.endswith(("_dim", "_rank"))


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(CELLS) <= 24 and len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_names_units_and_sources(m):
    assert NAME_RE.match(m["name"])
    assert UNIT_RE.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    if m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_every_metric_has_a_reader():
    for m in METRICS:
        mod = spec.load_module(spec.metric_file(m["name"]),
                               "test_metric_" + m["name"])
        assert callable(mod.read)


def test_layers_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", CELLS):
            assert c in e2e[m["moves"]].get("workloads", CELLS)
    for c in CELLS:
        reported = {m["name"] for m in spec.metrics_of(BENCH, c, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(BENCH, c, True)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = spec.cell(BENCH, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"])
    for name in (w["name"], w["config"], w["traffic"]):
        assert NAME_RE.match(name)
    assert spec.config_file(BENCH, w["config"]).is_file()
    traffic = spec.load_json(spec.traffic_file(w["traffic"]))
    assert spec.driver_file(traffic["driver"]).is_file()
    wl = spec.load_json(spec.workload_file(cell))
    assert wl["limits"], "a cell's check compares numbers under limits"


@pytest.mark.parametrize("c", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_configuration_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert _line(c["source"]) and _line(c["why"])
    assert c["file"].startswith("perfbench/")
    cfg = spec.load_json(spec.ROOT / c["file"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    # every key changed from the source is listed, and none is a width
    assert sorted(c["reduced"]) == sorted(cfg.get("source_values", {}))
    assert len(c["reduced"]) <= 16
    for key in c["reduced"]:
        assert NAME_RE.match(key) and key in cfg
        assert not _width(key)
        # a changed group keeps every width inside it as published
        published = cfg["source_values"][key]
        if isinstance(published, dict):
            assert isinstance(cfg[key], dict)
            for k, v in published.items():
                if _width(k):
                    assert cfg[key].get(k) == v, (key, k)
    assert (spec.HERE / "reference" / f"{cfg['reference']}.py").is_file()
    # its family: the weight layout, the port's model, the counts, the
    # tiny test sizes
    assert spec.family_file(cfg["reference"]).is_file()
    fam = spec.family(cfg)
    for fn in FAMILY_FUNCTIONS:
        assert callable(getattr(fam, fn)), fn
    assert isinstance(fam.TINY, dict) and fam.TINY
    assert isinstance(fam.TINY_CONTROL_REFUSED, bool)


@pytest.mark.parametrize("scaling, runs", [
    (None, True),
    ({"type": "yarn", "factor": 1, "mscale_all_dim": 0.707}, True),
    ({"type": "yarn", "factor": 40, "mscale_all_dim": 0.707}, False),
    ({"type": "linear", "factor": 1}, False),
])
def test_rope_scaling_runs_only_where_it_changes_nothing(scaling, runs):
    """The reference and the port rotate at rope_theta alone: a
    configuration whose scaling would change that is refused by both."""
    from harness import program
    from reference import common
    cfg = spec.load_json(spec.config_file(BENCH, "deepseek-v2-lite-16b"))
    cfg["rope_scaling"] = scaling
    if runs:
        common.plain_rope(cfg)
        program.model_config(cfg)
    else:
        with pytest.raises(ValueError, match="rope_scaling"):
            common.plain_rope(cfg)
        with pytest.raises(ValueError, match="rope_scaling"):
            program.model_config(cfg)


def _perfbench_sources():
    return sorted(p for p in spec.HERE.rglob("*.py")
                  if "tests" not in p.relative_to(spec.HERE).parts)


@pytest.mark.parametrize("path", _perfbench_sources(),
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_nothing_the_benchmark_loads_is_jax():
    """Import every module a run loads (harness, drivers, metrics, the
    reference and the families, the program's entry points) in a fresh
    interpreter and look
    at ``sys.modules``, top-level names compared whole."""
    code = f"""
import sys
sys.path[0:0] = [{str(spec.HERE)!r}, {str(spec.ROOT / 'src')!r}]
from harness import runner, spec, check, control, program, trace, counts
for f in sorted((spec.HERE / "drivers").glob("*.py")):
    spec.load_module(f, "d_" + f.stem)
for f in sorted((spec.HERE / "metrics").glob("*.py")):
    spec.load_module(f, "m_" + f.stem)
import importlib
for f in sorted((spec.HERE / "reference").glob("[!_]*.py")):
    importlib.import_module("reference." + f.stem)
for f in sorted((spec.HERE / "families").glob("*.py")):
    spec.load_module(f, "f_" + f.stem)
import repro_torch.models, repro_torch.optim
print(runner.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_the_card(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_a_checkout_without_the_program(tmp_path):
    """Only BENCHMARK.json and perfbench/: no result line."""
    import shutil
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert Path(tmp_path / "perfbench").is_dir()
