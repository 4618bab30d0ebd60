"""Nothing the harness loads is JAX or the JAX package, the reference
imports nothing of the program, and a machine without a card gets no
result."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from splatbench import run

PORT = "diff_gaussian_rasterization_tpu_torch"
JAXPKG = "diff_gaussian_rasterization_tpu"


def test_forbidden_names_are_whole_top_level_names():
    assert run.forbidden_modules([PORT, PORT + ".ops", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) \
        == ["flax", "jax", "jaxlib"]
    assert run.forbidden_modules([JAXPKG + ".ops", "jaxtyping"]) == [JAXPKG]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("name", ["reference", "scene", "work", "trace",
                                  "readers", "cells"])
def test_yardstick_imports_nothing_of_the_program(root, name):
    top = {m.split(".")[0] for m in _imports(root / "splatbench"
                                             / f"{name}.py")}
    assert not top & {PORT, JAXPKG, "jax", "jaxlib", "flax"}


def test_reference_loads_no_program_module(root):
    code = ("import sys, splatbench.reference, splatbench.scene, "
            "splatbench.work; print(sorted({m.split('.')[0] "
            "for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.replace("'", '"')))
    assert not loaded & {PORT, JAXPKG, "jax", "jaxlib", "flax"}


def test_no_card_no_result(root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "splatbench.run", "--workload", "replica-map",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no result" in out.stderr
