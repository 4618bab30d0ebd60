"""The port stands alone: no JAX, nothing of the JAX package.

A subprocess with ``jax`` and ``diff_gaussian_rasterization_tpu`` blocked
in ``sys.modules`` imports every module of the port (its reference-style
``api`` and its four ``examples`` too)
and its root scripts (``chip_smoke.py``, ``ab_render_fwd.py``), and builds
nothing while it does; a scan of their sources finds no import of either.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "diff_gaussian_rasterization_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "diff_gaussian_rasterization_tpu")

IMPORT_ALL = """
import importlib, pkgutil, sys
for name in {forbidden!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import diff_gaussian_rasterization_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import ab_render_fwd
assert not any(k == f or k.startswith(f + ".") for k in sys.modules
               for f in {forbidden!r} if sys.modules[k] is not None)
# importing builds nothing: no CUDA library loaded, no native solver built
from diff_gaussian_rasterization_tpu_torch import native
from diff_gaussian_rasterization_tpu_torch.ops.kernels import _build
assert not _build._libs and native._posegraph_fn.cache_info().currsize == 0
assert native._rgbdio_fn.cache_info().currsize == 0
for mod in ("api", "examples.bench_ate", "examples.render_ply",
            "examples.fit_scene", "examples.run_slam"):
    assert "diff_gaussian_rasterization_tpu_torch." + mod in names, mod
print(len(names))
"""


def port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "ab_render_fwd.py"]


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL.format(forbidden=FORBIDDEN)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 15


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_import(path):
    bad = [n for n in _imported_names(path)
           if any(n == f or n.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path}: imports {bad}"
