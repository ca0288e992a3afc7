"""Finds what a cell is made of, by the names in ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<cell>.json``, whose ``loop`` names ``loops/<loop>.py``) and
each metric's reader (``metrics/<metric>.py``). A new configuration, cell
or metric is a new file and a new entry, and nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, cell_entry: dict, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == cell_entry["config"]:
            return load_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {cell_entry['config']!r}")


def traffic_of(cell_entry: dict, here: str = HERE) -> dict:
    return load_json(os.path.join(here, "traffic",
                                  cell_entry["name"] + ".json"))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(name: str, here: str = HERE):
    """The module ``loops/<name>.py``."""
    return _module(os.path.join(here, "loops", name + ".py"),
                   "portbench_loop_" + name.replace(".", "_"))


def reader(name: str, here: str = HERE):
    """The reader of metric ``name``: ``metrics/<name>.py``'s ``read``."""
    return _module(os.path.join(here, "metrics", name + ".py"),
                   "portbench_metric_" + name.replace(".", "_")).read


def metrics_for(bench: dict, cell_name: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics (``traced`` False) or per-layer ones
    (True): those whose ``workloads`` name the cell, or that have none."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]
