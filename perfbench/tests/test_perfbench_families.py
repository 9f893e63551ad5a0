"""A model family as files: ``families/<reference>.py`` beside
``reference/<reference>.py``.  What the families were moved out of the
harness with is pinned (``pinned.json``, read from the harness before the
move): each configuration's weight layout, the tiny tree the CPU draws
from a fixed seed, bit for bit, and the port's ``ModelConfig``.  A copy
of the benchmark takes a new family, configuration and cell by added
files and entries alone, and runs it correct; no source of the harness,
the drivers, the metrics or the tools names a family, nor the harness or
the drivers a program span."""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tiny
from harness import program, runner, spans, spec, weights

BENCH = spec.benchmark()
PINNED = spec.load_json(spec.HERE / "tests" / "pinned.json")
SEED = 2 ** 31 + 5


def _cfg(name):
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


def layout_hash(cfg: dict) -> str:
    rows = [[list(p), list(s), str(d), i]
            for p, s, d, i in weights.layout(cfg)]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def draw_hash(cfg: dict, seed: int) -> str:
    h = hashlib.sha256()
    tree = weights.draw(cfg, seed, "cpu")
    for p, _, _, _ in weights.layout(cfg):
        leaf = weights.get(tree, p)
        h.update(repr(p).encode())
        h.update(leaf.contiguous().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_layout_as_pinned(name):
    """Every leaf's path, shape, dtype and init, in order."""
    assert layout_hash(_cfg(name)) == PINNED[name]["layout"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(PINNED))
def test_tiny_draw_as_pinned(name, dtype):
    """The same tensors, bit for bit, from the same seed."""
    got = draw_hash(tiny.config(name, dtype), SEED)
    assert got == PINNED[name][f"draw_{dtype}"]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_model_config_as_pinned(name):
    """Every field the port's ``ModelConfig`` had is as it was."""
    got = json.loads(json.dumps(
        dataclasses.asdict(program.model_config(_cfg(name))), default=str))
    want = PINNED[name]["model_config"]
    assert {k: got.get(k) for k in want} == want


def test_a_configuration_without_its_family_file_is_refused(monkeypatch,
                                                           tmp_path):
    """Nothing falls through to another family: the layout, the port's
    model and a run's context all refuse, naming the missing file."""
    cfg = dict(_cfg(sorted(PINNED)[0]), reference="no_such_family")
    for call in (weights.layout, program.model_config):
        with pytest.raises(FileNotFoundError,
                           match=r"families/no_such_family\.py"):
            call(cfg)
    monkeypatch.setattr(spec, "family_file",
                        lambda name: tmp_path / "families" / f"{name}.py")
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        runner.context(BENCH["workloads"][0]["name"], 1, 1.0, False, 0.0)


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_family_enters_by_files_alone(tmp_path):
    """In a copy of the benchmark, a family ``toy`` (the first Llama-type
    configuration's family and reference, copied), its configuration, one
    prefill cell's ``workloads`` file and the ``BENCHMARK.json`` entries
    are added; nothing else is edited.  The cell runs through
    ``harness.runner`` at the family's tiny size on the CPU, in a fresh
    interpreter, and comes out correct."""
    src = next(c for c in BENCH["configs"]
               if spec.load_json(spec.ROOT / c["file"])["reference"]
               == "llama")
    base = next(w for w in BENCH["workloads"]
                if w["config"] == src["name"] and spec.load_json(
                    spec.traffic_file(w["traffic"]))["driver"] == "prefill")
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "perfbench"
    before = _files(here)
    shutil.copy(here / "families" / "llama.py", here / "families" / "toy.py")
    shutil.copy(here / "reference" / "llama.py",
                here / "reference" / "toy.py")
    cfg = dict(spec.load_json(spec.ROOT / src["file"]), name="toy",
               reference="toy")
    (here / "configs" / "toy.json").write_text(json.dumps(cfg, indent=1))
    cell = f"toy.{base['traffic']}"
    shutil.copy(spec.workload_file(base["name"]),
                here / "workloads" / f"{cell}.json")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(src, name="toy",
                                 file="perfbench/configs/toy.json"))
    bench["workloads"].append(dict(base, name=cell, config="toy"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    code = f"""
import json, sys
sys.path[0:0] = [{str(here)!r}, {str(here / 'tests')!r},
                 {str(spec.ROOT / 'src')!r}]
import torch
torch.set_num_threads(2)
import tiny
from harness import runner, spec
assert str(spec.HERE) == {str(here)!r}
ctx = tiny.context({cell!r}, "float32")
out = runner.result(ctx, runner.drive(ctx), 1)
print(json.dumps({{"correct": out["correct"], "check": out["check"],
                  "family": spec.family(ctx.config).__file__}}))
"""
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path,
                         env={**os.environ, "USE_FLAX": "0"})
    assert run.returncode == 0, run.stderr[-4000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["family"] == str(here / "families" / "toy.py")
    assert line["correct"], line["check"]
    after = _files(here)
    added = {p for p in after if p not in before}
    assert added == {Path(p) for p in (
        "families/toy.py", "reference/toy.py", "configs/toy.json",
        f"workloads/{cell}.json")}
    assert all(after[p] == before[p] for p in before)


#: the sources that name no family: what runs every configuration
GUARDED = ["harness", "drivers", "metrics", "tools", "run.py",
           "tests/tiny.py", "tests/test_perfbench_drivers.py"]
FAMILY_WORDS = re.compile(r"model_type|llama|deepseek", re.IGNORECASE)


def _guarded():
    out = []
    for g in GUARDED:
        p = spec.HERE / g
        out += sorted(p.rglob("*.py")) if p.is_dir() else [p]
    return out


def _program_spans() -> set:
    """The span names the program opens (``annotate("...")`` in its
    sources)."""
    names = set()
    for p in (spec.ROOT / "src" / "repro_torch").rglob("*.py"):
        names |= set(re.findall(r"""annotate\(\s*["']([^"']+)["']""",
                                p.read_text()))
    return names


def _strings(path):
    return [n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


@pytest.mark.parametrize("path", _guarded(),
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_source_names_a_family_or_a_span(path):
    """No string (docstrings included) names a family or ``model_type``;
    under ``harness/`` and ``drivers/`` none names a program span either,
    by the program's own names or by the convention.  A metric file and
    the tools name the span they read."""
    named = _program_spans()
    assert {"optim/adamw", "moe/experts"} <= named
    part = path.relative_to(spec.HERE).parts[0]
    for s in _strings(path):
        assert not FAMILY_WORDS.search(s), (path.name, s[:80])
        if part in ("harness", "drivers"):
            assert not spans.is_program_span(s), (path.name, s)
            assert not any(n in s for n in named), (path.name, s[:80])
    assert not FAMILY_WORDS.search(path.name)

