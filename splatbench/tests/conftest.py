"""Shared set-up of the benchmark's tests: the repository root on the
path, the small sizes a CPU run can hold, and the card fixture."""

from __future__ import annotations

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one torch thread a worker: several workers with a thread a core each
    # starve one another
    import torch
    torch.set_num_threads(1)

# every cell shrunk to a size the CPU runs in seconds: a 96x64 camera,
# 16x16 tiles, a room of ~1,700 Gaussians, a pool of 6 views
SMALL = {
    "config": {"camera": {"height": 64, "width": 96, "fx": 48.0,
                          "fy": 48.0},
               "scene": {"wall_res": 14},
               "raster": {"tile_h": 16, "tile_w": 16},
               "slam": {"capacity": 8000, "init_iters": 5},
               "mapping": {"iters": 3}},
    "mix": {"pool": 6, "schedule": 200, "check": 2, "check_span": 2,
            "cycles": 3, "frames": 40},
}


@pytest.fixture
def root() -> Path:
    return ROOT


@pytest.fixture
def card():
    """The CUDA device, or a skip where the machine has none (decided
    here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def small_parts(root: Path, name: str):
    """(configuration, mix) of the cell ``name`` at the small size."""
    import copy

    from splatbench import cells, run
    bench = cells.benchmark(root)
    w = cells.workload(bench, name)
    cfg, mix = cells.config(w["config"]), cells.mix(w["traffic"])
    run._deep_update(cfg, copy.deepcopy(SMALL["config"]))
    run._deep_update(mix, copy.deepcopy(SMALL["mix"]))
    return cfg, mix


@pytest.fixture
def small_entry(root):
    """A maker of a cell's entry at the small size on the CPU."""
    from splatbench import cells

    def make(name: str, seed: int, device="cpu"):
        cfg, mix = small_parts(root, name)
        return cells.entry(mix["entry"])(cfg, mix, seed, device)
    return make
