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
