"""The benchmark's parts are found by name, and BENCHMARK.json keeps to
the shape the harness reads."""

from __future__ import annotations

import json
import re

import pytest

from splatbench import cells, entry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def bench(root):
    return cells.benchmark(root)


def test_every_named_part_is_found(bench):
    for w in bench["workloads"]:
        cfg = cells.config(w["config"])
        assert cfg["name"] == w["config"]
        mix = cells.mix(w["traffic"])
        assert issubclass(cells.entry(mix["entry"]), entry.Entry)
        assert isinstance(cells.limits(w["name"]), dict)
    for m in bench["end_to_end"]:
        assert callable(cells.endtoend_reader(m["name"]).read)
    for m in bench["per_layer"]:
        assert callable(cells.metric_reader(m["name"]).read)


@pytest.mark.parametrize("finder", [cells.config, cells.mix, cells.limits,
                                    cells.entry, cells.metric_reader,
                                    cells.endtoend_reader])
def test_unknown_names_fail(finder):
    with pytest.raises(KeyError):
        finder("no-such-name")


def test_unknown_workload_fails(bench):
    with pytest.raises(KeyError):
        cells.workload(bench, "no-such-cell")


def test_benchmark_shape(bench, root):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert (root / c["file"]).is_file()
        assert c["file"].startswith(bench["paths"][0] + "/")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert cells.reports(e2e["setup_s"], w["name"], bench)
        assert any(cells.reports(m, w["name"], bench)
                   for m in bench["end_to_end"] if m["name"] != "setup_s")
        assert any(cells.reports(m, w["name"], bench)
                   for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert cells.reports(e2e[m["moves"]], w, bench)
    assert len(json.dumps(bench)) < 64 * 1024
