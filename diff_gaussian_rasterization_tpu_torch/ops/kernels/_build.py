"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so it
builds in seconds.  It is compiled at first use into ``build/`` beside this
file (git-ignored), under a name that carries a hash of the source and the
flags: an edited source is rebuilt, an unchanged one is loaded as it is.
Every C entry point takes its pointers and the CUDA stream as
``ctypes.c_void_p`` and returns ``cudaGetLastError()`` as an int.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# No --use_fast_math (expf must round as the plain version's exp does), and
# no FMA contraction, so every operation rounds on its own like PyTorch's
# elementwise ops.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)

# C signature of each entry point, by source file.
SIGNATURES = {
    "render_fwd": {
        "render_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _F, _F, _F, _I, _P, _P],
        "tile_scatter_sum": [_P, _L, _P, _L, _P, _P, _I, _I, _P, _P, _P],
    },
    "render_bwd": {
        "render_bwd": [_P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I,
                       _I, _I, _F, _F, _F, _I, _I, _I, _P, _P],
        "render_bwd_pixel_map": [_I, _I, _P, _P],
        "segment_sum_rows": [_P, _P, _P, _P, _P, _I, _I, _P],
    },
    "render_jvp": {
        "render_jvp": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _F, _F, _F, _I, _I, _I, _I, _I, _P, _P],
        "render_jvp_cull_boxes": [_P, _I, _F, _P, _P],
    },
    "preprocess": {
        "preprocess_fwd": [_P] * 15,
        "preprocess_bwd": [_P] * 20,
        "preprocess_tangents": [_P] * 9 + [_I, _I, _P, _P],
    },
}

_libs: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _target(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (target, process) or (target,
    None) when the library is already built."""
    so = _target(name)
    if so.exists():
        return so, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, (proc, tmp)


def _finish(name: str, so: Path, job) -> str:
    """Wait for a build started by :func:`_start`; returns its log."""
    log_path = so.with_suffix(".log")
    if job is None:
        return log_path.read_text() if log_path.exists() else ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return log


def build_all(names=None) -> dict:
    """Build every source (one nvcc per source, all started together) and
    return {name: compiler log}."""
    names = list(SIGNATURES) if names is None else list(names)
    with _lock:
        jobs = {n: _start(n) for n in names}
        return {n: _finish(n, *jobs[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]
