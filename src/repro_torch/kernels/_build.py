"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled for ``sm_90a`` by its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects into one shared
library with a plain C interface, loaded with :mod:`ctypes`.  The
build runs at first use, into ``build/repro_torch/<hash>/`` at the root of
the checkout, keyed on a hash of the sources, the ``csrc/*.cuh`` headers
and the flags, so a fresh checkout builds itself and an edited source or
header rebuilds.  Every pointer and the stream are passed as
``c_void_p``; every C entry returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0.

No ``--use_fast_math``: ``exp2f`` has to stay close to XLA's ``exp2``,
and the similarity dots keep their fixed split-TF32 arithmetic
(``csrc/sim_top1.cu``).
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

SOURCES = ("sim_top1.cu", "sim_topk.cu", "sim_topk_f32.cu", "sim_topk_q8.cu",
           "victim_value.cu", "rac_value.cu", "decode_attention.cu",
           "flash_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_LIB = None
_LOCK = threading.Lock()

#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0
#: what ``nvcc`` printed when the library in use was built (register and
#: spill report; kept beside the library, so a process that finds it built
#: reads it too)
build_log = ""

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_B = ctypes.c_char_p    # a packed argument block, passed without a copy
_SIGNATURES = {
    "sim_top1_launch": [_P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P,
                        _I, _P],
    "sim_topk_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _P, _P, _P, _P, _I, _P],
    "sim_topk_f32_launch": [_P, _L, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P, _P, _P, _P, _P, _I, _P],
    "sim_topk_f32_slots": [_I, _I, _I, _I, _I, _I, _P, _P],
    "sim_top1_multi_launch": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P,
                              _P, _P, _I, _P],
    "sim_topk_multi_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I,
                              _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    "sim_topk_q8_wgmma_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I,
                                 _I, _I, _I, _P, _P, _P, _P, _I, _P],
    "sim_topk_q8_wgmma_slots": [_I, _I, _I, _I, _I, _P],
    # the Eq. 1 kernels take one packed Eq1Args block (kernels/decision.py)
    "victim_value_launch": [_B],
    "victim_value_slots": [_B, _P],
    "rac_value_launch": [_B],
    "rac_value_slots": [_B, _P],
    "eq1_value_floor": [_B],
    "decode_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "decode_attention_slots": [_I, _I, _I, _I, _I, _I, _I, _P],
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _P, _I, _F, _I, _I, _I, _P],
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
    """The sources, every header they may include and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in _CSRC.glob("*.cuh"))
    for name in (*SOURCES, *headers):
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
    log_file = out_dir / "build.log"
    if lib.exists():
        build_seconds = 0.0
        build_log = log_file.read_text() if log_file.exists() else ""
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f".build-{os.getpid()}-{threading.get_ident()}"
    tmp = out_dir / f"{tag}.so"
    objs = [out_dir / f"{tag}-{Path(s).stem}.o" for s in SOURCES]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one compiler per source, all at once; then one link
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                               str(_CSRC / s)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed = ["link"]
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    log_tmp = out_dir / f"{tag}.log"
    log_tmp.write_text(build_log)
    os.replace(log_tmp, log_file)
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
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
    """The raw ``cudaStream_t`` of the current stream on ``t``'s device
    (read without building a ``torch.cuda.Stream``)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)
