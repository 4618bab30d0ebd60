"""ctypes binding of the native pose-graph solver (PyTorch port of the JAX
package's ``native.py``, ``pose_graph_optimize`` only).

At first use ``csrc/pose_graph.cpp`` (at the root of the repository) is
compiled with ``g++ -O3 -fPIC -shared -std=c++17`` into the port's
git-ignored build directory (``ops/kernels/build/``), under a name that
carries a hash of the source and the flags.  Nothing is compiled at import,
and a failed build raises: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .ops.kernels._build import BUILD_DIR

POSE_GRAPH_SRC = Path(__file__).resolve().parents[1] / "csrc" / \
    "pose_graph.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def build_pose_graph() -> Path:
    """Compile ``csrc/pose_graph.cpp`` unless it is built; returns the
    library's path."""
    if not POSE_GRAPH_SRC.exists():
        raise RuntimeError(f"{POSE_GRAPH_SRC} not found: the native solver "
                           "builds from the repository's csrc/")
    h = hashlib.sha256(POSE_GRAPH_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    so = BUILD_DIR / f"libposegraph_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) for csrc/pose_graph.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                          str(POSE_GRAPH_SRC)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for pose_graph.cpp:\n{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache()
def _posegraph_fn():
    fn = ctypes.CDLL(str(build_pose_graph())).pose_graph_optimize
    fn.restype = ctypes.c_double
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_int, ctypes.c_double,
    ]
    return fn


def pose_graph_optimize(views, edges, z_rel, weights=None, iters: int = 10,
                        damping: float = 1e-6):
    """Refine keyframe poses with relative-pose constraints (SE(3)
    Gauss-Newton in C++).

    Args:
      views: (K, 4, 4) row-convention view matrices (converted to and from
        the solver's column convention here).
      edges: (E, 2) int array of keyframe index pairs (i, j).
      z_rel: (E, 4, 4) measured row-convention relatives
        ``V_j @ inv(V_i)``.
      weights: (E,) edge weights (default 1).
      iters / damping: Gauss-Newton iterations and LM damping.

    Returns:
      (refined views (K, 4, 4) float32, row convention, final squared
      error).  Pose 0 is the gauge (held fixed).
    """
    views = np.asarray(views, np.float64)
    k = views.shape[0]
    poses = np.ascontiguousarray(np.transpose(views, (0, 2, 1)))
    edges = np.ascontiguousarray(np.asarray(edges, np.int32))
    zs = np.ascontiguousarray(
        np.transpose(np.asarray(z_rel, np.float64), (0, 2, 1)))
    e = edges.shape[0]
    if weights is None:
        weights = np.ones((e,), np.float64)
    weights = np.ascontiguousarray(np.asarray(weights, np.float64))
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    err = _posegraph_fn()(
        ptr(poses, ctypes.c_double), k, ptr(edges, ctypes.c_int32),
        ptr(zs, ctypes.c_double), ptr(weights, ctypes.c_double), e,
        int(iters), float(damping))
    if err < 0:
        raise RuntimeError("pose_graph_optimize failed (singular system?)")
    return np.transpose(poses, (0, 2, 1)).astype(np.float32), float(err)
