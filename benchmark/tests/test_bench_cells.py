"""BENCHMARK.json and the files it names: every cell, configuration,
traffic and per-layer metric is found by its name."""
from __future__ import annotations

import json
import os
import re

import pytest

from harness import cells, traffic

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files(w):
    spec = cells.find(BENCH, w)
    traffic.check(spec["traffic"])
    cfg = spec["config"]
    assert {"source", "reduced", "assumed", "config", "limits"} <= set(cfg)
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        r = cells.reader(m["name"])
        assert callable(r.read)
        assert m["moves"] in names


def test_every_config_and_traffic_is_used_and_named_right():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for entry in BENCH["configs"] + BENCH["workloads"] \
            + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)


def test_metric_readers_are_exactly_the_declared_metrics():
    here = os.path.join(cells.HERE, "metrics")
    files = {f[:-3] for f in os.listdir(here) if f.endswith(".py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


def test_a_cell_is_found_by_its_entries_alone(tmp_path):
    """A new cell on an existing configuration and traffic needs only
    its BENCHMARK.json entry."""
    bench = json.loads(json.dumps(BENCH))
    w = dict(bench["workloads"][0], name="replica-rgbd.copy")
    bench["workloads"].append(w)
    spec = cells.find(bench, "replica-rgbd.copy")
    assert spec["cell"]["traffic"] == w["traffic"]
    # metrics listing other cells are not read in the new one, metrics
    # without a list are
    bench["per_layer"].append({"name": "idle_share", "unit": "%"})
    names = [m["name"] for m in cells.find(bench, "replica-rgbd.copy")
             ["per_layer"]]
    assert names == ["idle_share"]


def test_an_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        cells.find(BENCH, "no-such.cell")
