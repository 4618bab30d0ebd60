"""ctypes bindings of the native (C++) runtime components (PyTorch port of
the JAX package's ``native.py``):

- ``pose_graph_optimize``: SE(3) keyframe pose-graph Gauss-Newton
  (``csrc/pose_graph.cpp``);
- ``decode_rgbd_batch``: threaded JPEG / 16-bit PNG RGB-D frame decoding
  (``csrc/rgbd_io.cpp``, which links libpng and libjpeg).

At first use each source (in ``csrc/`` at the root of the repository) is
compiled with ``g++ -O3 -fPIC -shared -std=c++17`` into the port's
git-ignored build directory (``ops/kernels/build/``), under a name that
carries a hash of the source and the flags.  Nothing is compiled at import,
and a failed build raises with the compiler's message: there is no Python
fallback.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
POSE_GRAPH_SRC = CSRC / "pose_graph.cpp"
RGBD_IO_SRC = CSRC / "rgbd_io.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
RGBD_IO_LIBS = ["-lpng", "-ljpeg", "-lz", "-lpthread"]


def _build(src: Path, stem: str, libs=()) -> Path:
    """Compile ``src`` into ``BUILD_DIR/lib<stem>_<hash>.so`` unless it is
    built; returns the library's path."""
    if not src.exists():
        raise RuntimeError(f"{src} not found: the native components build "
                           "from the repository's csrc/")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join([*CXX_FLAGS, *libs]).encode())
    so = BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++) for csrc/{src.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src), *libs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name}:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def build_pose_graph() -> Path:
    """Compile ``csrc/pose_graph.cpp`` unless it is built; returns the
    library's path."""
    return _build(POSE_GRAPH_SRC, "posegraph")


def build_rgbd_io() -> Path:
    """Compile ``csrc/rgbd_io.cpp`` against libpng and libjpeg unless it is
    built; returns the library's path."""
    return _build(RGBD_IO_SRC, "rgbdio", RGBD_IO_LIBS)


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


@functools.lru_cache()
def _rgbdio_fn():
    fn = ctypes.CDLL(str(build_rgbd_io())).decode_rgbd_batch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    return fn


def decode_rgbd_batch(rgb_paths, depth_paths, height: int, width: int,
                      depth_scale: float, n_threads: int = 8):
    """Decode a batch of (JPEG rgb, 16-bit PNG depth) frames in parallel
    threads.

    Returns (rgb [N, 3, H, W] float32 in [0, 1], depth [N, H, W] float32
    in depth units / ``depth_scale``, the number of frames decoded); a frame
    that fails to decode stays zero.
    """
    if len(rgb_paths) != len(depth_paths):
        raise ValueError(f"{len(rgb_paths)} rgb paths but "
                         f"{len(depth_paths)} depth paths")
    n = len(rgb_paths)
    rgb = np.zeros((n, 3, height, width), np.float32)
    depth = np.zeros((n, height, width), np.float32)
    c_rgb = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in rgb_paths])
    c_dep = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in depth_paths])
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ok = _rgbdio_fn()(c_rgb, c_dep, n, int(height), int(width),
                      ctypes.c_float(depth_scale), ptr(rgb), ptr(depth),
                      int(n_threads))
    return rgb, depth, ok
