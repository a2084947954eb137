"""Finds a cell's parts by name: its entry in ``BENCHMARK.json`` at the
root of the checkout, its configuration file, its traffic mix
(``traffic/<mix>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``).  Adding a cell, a configuration, a mix or a
metric is adding a file and an entry; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict            # the configuration file's fields
    traffic_name: str
    traffic: dict           # the mix's parameters
    end_to_end: list[dict]  # the BENCHMARK.json metrics this cell reports
    per_layer: list[dict]
    root: pathlib.Path = ROOT


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, root: pathlib.Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of the benchmark at ``root``."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    # An end-to-end metric with no ``workloads`` is every cell's.
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"],
                traffic=load_traffic(w["traffic"], root), end_to_end=e2e,
                per_layer=per_layer, root=root)


def load_traffic(name: str, root: pathlib.Path = ROOT) -> dict:
    with open(root / HERE.name / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_reader(metric: str, root: pathlib.Path = ROOT):
    """The reader module of per-layer metric ``metric``: ``read(r)``, which
    returns the number or None, and its ``UNIT``, ``LAYER`` and ``MOVES``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    mod_name = "phybench_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
