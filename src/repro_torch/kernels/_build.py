"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

All sources are compiled by ONE ``nvcc`` call for ``sm_90a`` into one
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build runs at first use, into ``build/repro_torch/<hash>/`` at the root of
the checkout, keyed on a hash of the sources and flags, so a fresh
checkout builds itself and an edited source rebuilds.  Every pointer and the stream are passed as
``c_void_p``; every C entry returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0.

No ``--use_fast_math``: ``exp2f`` has to stay close to XLA's ``exp2``,
and the similarity dots must stay IEEE fp32.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCES = ("sim_top1.cu", "victim_value.cu", "rac_value.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_LIB = None
_LOCK = threading.Lock()

#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0
#: what ``nvcc`` printed for the last build (register and spill report)
build_log = ""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sim_top1_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                        _I, _P],
    "victim_value_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _I, _P],
    "rac_value_launch": [_P, _P, _P, _P, _I, _I, _F, _F, _P, _I, _P],
}


# <checkout>/build/repro_torch (kernels -> repro_torch -> src -> checkout)
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if this hash has no library yet; returns its
    path.  Concurrent builders each write a private file and rename it into
    place, so a reader never sees a half-written library."""
    global build_seconds, build_log
    out_dir = _BUILD_ROOT / _source_hash()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        build_seconds = 0.0
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".build-{os.getpid()}-{threading.get_ident()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(_CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(err: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_of(t) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
