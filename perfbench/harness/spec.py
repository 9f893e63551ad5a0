"""The benchmark's description, read from ``BENCHMARK.json`` at the root of
the checkout, and the files it names: a cell (``workloads`` entry) joins a
configuration (``configs/<config>.json``), a traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``)
and the cell's own settings (``workloads/<cell>.json``: the limits of its
correctness check).  A configuration's ``reference`` key names its family:
``families/<reference>.py`` (weight layout, the port's model, the counts)
and ``reference/<reference>.py`` (the plain block).  Each metric is read by
``metrics/<name>.py``.  A later cell, configuration, family or metric adds
files and entries; nothing here names one."""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

#: the folder of the benchmark (``perfbench/``) and the checkout's root
HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    """The ``workloads`` entry called ``name`` (KeyError if none)."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, config: str) -> Path:
    for c in bench["configs"]:
        if c["name"] == config:
            return ROOT / c["file"]
    raise KeyError(f"no configuration {config!r} in BENCHMARK.json")


def traffic_file(traffic: str) -> Path:
    return HERE / "traffic" / f"{traffic}.json"


def workload_file(name: str) -> Path:
    return HERE / "workloads" / f"{name}.json"


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def driver_file(driver: str) -> Path:
    return HERE / "drivers" / f"{driver}.py"


def family_file(reference: str) -> Path:
    return HERE / "families" / f"{reference}.py"


def family(cfg: dict):
    """The family module of a configuration, ``families/<reference>.py``,
    loaded once; a configuration whose file is missing is refused."""
    path = family_file(cfg["reference"])
    if not path.is_file():
        raise FileNotFoundError(
            f"configuration {cfg.get('name')!r} names the family "
            f"{cfg['reference']!r}, but there is no {path}")
    return _load_family(path)


@functools.cache
def _load_family(path: Path):
    return load_module(path, "perfbench_family_" + path.stem)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module called ``name`` (metric
    and driver files carry dots and dashes in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell_name: str, per_layer: bool) -> list[dict]:
    """The metrics a cell reports: end-to-end ones whose ``workloads``
    list it (or that have none); per-layer ones whose ``workloads`` list
    it, or, without that key, that move an end-to-end metric it
    reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if not per_layer:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]
