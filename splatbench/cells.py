"""Finding a cell's parts by name: ``BENCHMARK.json`` lists the cells and
the metrics, with each metric's unit, layer and cells; each configuration,
traffic mix, entry, limit set and metric reader is a file of its own under
this folder, named after it."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise KeyError(f"no such file: {path}")
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"unknown workload {name!r}")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return _json(HERE / "mixes" / f"{name}.json")


def limits(name: str) -> dict:
    """The limit of each number a workload's check compares."""
    return _json(HERE / "limits" / f"{name}.json")


def _module(folder: str, name: str):
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no reader for {name!r} in {folder}/")
    spec = importlib.util.spec_from_file_location(
        f"splatbench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    """The entry ``name`` that a mix drives: the ``ENTRY`` class of
    ``entries/<name>.py``."""
    return _module("entries", name).ENTRY


def metric_reader(name: str):
    """The per-layer metric ``name``'s reader module (``read(ctx)``)."""
    return _module("metrics", name)


def endtoend_reader(name: str):
    """The end-to-end metric ``name``'s reader module (``read(ctx)``)."""
    return _module("endtoend", name)


def reports(metric: dict, cell: str, bench: dict) -> bool:
    """Whether ``cell`` reports ``metric`` (an entry of ``end_to_end`` or
    ``per_layer``): its ``workloads`` list, or, without one, every cell
    that reports the end-to-end metric it moves (all cells for an
    end-to-end metric), so that a metric added later without a list is
    reported wherever the metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return reports(e2e[moves], cell, bench)
