"""The port stands alone: importing ``repro_torch`` pulls in neither JAX
nor the reference package, its sources never name them, and asking for
the card where there is none raises instead of running on the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(sum(n.startswith('repro_torch') for n in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20       # every subpackage imported


def test_sources_name_no_jax_and_no_reference_module():
    pattern = re.compile(r"\bimport\s+jax|\bfrom\s+jax\b|\bjax\.|"
                         r"\brepro\.(?!_)|\bimport\s+repro\b|"
                         r"\bfrom\s+repro\s+import")
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 20
    hits = [f"{p.relative_to(SRC)}:{i}: {line.strip()}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, hits


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.quant", "repro_torch.kernels.fused",
    "repro_torch.cache.quantized", "repro_torch.cache.pruned",
    "repro_torch.core.policies", "repro_torch.core.arena",
    "repro_torch.optim", "repro_torch.data", "repro_torch.distributed",
    "repro_torch.distributed.checkpoint",
    "repro_torch.distributed.fault_tolerance",
    "repro_torch.distributed.compression", "repro_torch.launch.train",
    "repro_torch.models.steps", "repro_torch.tree",
    "repro_torch.core.legacy_policies", "repro_torch.costing",
    "repro_torch.configs", "repro_torch.distributed.api",
    "repro_torch.distributed.sharding", "repro_torch.distributed.spmd",
    "repro_torch.launch.mesh", "repro_torch.launch.op_cost",
    "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
    "repro_torch.launch.profile_cell"])
def test_approximate_lookup_modules_stand_alone(module):
    """The modules of the approximate lookups, the baselines, the arena,
    the training path and the dry-run and sharding tooling import alone,
    with neither JAX nor the reference package (whose numpy-only twins
    they copy)."""
    code = (f"import sys, {module}\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_kernel_sources_ship_with_the_package():
    from repro_torch.kernels import _build
    for name in _build.SOURCES:
        text = (PORT / "csrc" / name).read_text()
        assert "Replaces:" in text and "extern \"C\"" in text


def test_cuda_without_a_card_raises_instead_of_running_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the card-less path")
    from repro_torch.cache import CacheConfig, KernelBackend, SemanticCache
    from repro_torch.core import (OASSTConfig, make_rac, oasst_style_trace,
                                  run_policy_batched)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KernelBackend(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SemanticCache(CacheConfig(capacity=8, dim=16))   # the defaults
    tr = oasst_style_trace(OASSTConfig(trace_len=20, dim=16, seed=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_policy_batched(tr, 8, make_rac())             # the defaults
    # the CPU runs only when asked for
    st = run_policy_batched(tr, 8, make_rac(), device="cpu")
    assert st.hits + st.misses == 20


def test_kernel_backend_cpu_keeps_its_mirrors_on_the_cpu():
    from repro_torch.cache import CacheConfig, SemanticCache
    cache = SemanticCache(CacheConfig(capacity=8, dim=16, device="cpu"))
    rng = np.random.default_rng(0)
    for cid in range(12):
        e = rng.standard_normal(16).astype(np.float32)
        cache.admit(cid, e / np.linalg.norm(e))
    cache.decide_batch(np.eye(16, dtype=np.float32)[:3])
    mirror = cache.backend._store_mirror.arrays["emb"]
    assert mirror.device.type == "cpu" and mirror.shape == (9, 16)


#: the reference's modules and exports the port names otherwise (the HLO
#: cost walk and its roofline become a dispatch-mode counter and its
#: roofline; the JAX power iteration a PyTorch one)
RENAMED_MODULES = {"launch.hlo_cost": "launch.op_cost",
                   "launch.hlo_analysis": "launch.roofline"}
RENAMED_EXPORTS = {"pagerank_power_jax": "pagerank_power"}


def test_the_port_covers_the_reference_module_tree_and_exports():
    """Every module of the reference package has its counterpart in the
    port, and every subpackage's ``__all__`` covers the reference's."""
    code = (
        "import importlib, pkgutil, sys, json\n"
        "out = {}\n"
        "for pkg in ('repro', 'repro_torch'):\n"
        "    root = importlib.import_module(pkg)\n"
        "    mods = [m.name[len(pkg) + 1:] for m in\n"
        "            pkgutil.walk_packages(root.__path__, pkg + '.')]\n"
        "    alls = {m: list(getattr(importlib.import_module(\n"
        "        pkg + '.' + m), '__all__', [])) for m in mods\n"
        "        if '.' not in m}\n"
        "    out[pkg] = [mods, alls]\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    import json
    got = json.loads(r.stdout.strip().splitlines()[-1])
    (ref_mods, ref_all), (port_mods, port_all) = got["repro"], \
        got["repro_torch"]
    missing = sorted(RENAMED_MODULES.get(m, m) for m in ref_mods
                     if RENAMED_MODULES.get(m, m) not in port_mods)
    assert not missing, missing
    for pkg, names in ref_all.items():
        gap = sorted(set(RENAMED_EXPORTS.get(n, n) for n in names)
                     - set(port_all[pkg]))
        assert not gap, (pkg, gap)
