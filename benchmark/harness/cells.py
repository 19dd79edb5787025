"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root names the cell, its configuration (whose ``file`` holds the
configuration as it is run) and its traffic (``traffic/<name>.json``);
each per-layer metric is read by ``metrics/<name>.py``.  Adding a cell
or a metric adds files and entries; nothing here changes."""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(bench: dict, workload: str) -> dict:
    """The cell `workload` with its configuration file's contents, its
    traffic's parameters and its per-layer metrics' entries."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in bench["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    return {"cell": cell, "config": config, "traffic": traffic,
            "per_layer": per_layer, "end_to_end": end_to_end}


def reader(name: str):
    """The module metrics/<name>.py: ``read(rec) -> number or None`` and,
    optionally, ``install(rec)``, called before the traced window."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
