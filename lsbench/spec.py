"""What a cell is, found by name: ``BENCHMARK.json``'s entry of the
workload, its configuration file (``lsbench/configs/<name>.json``) and its
traffic mix (``lsbench/traffic/<name>.json``). A later cell is new files
and new entries; nothing here changes for it."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list   # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_path: str = None, traffic_dir: str = None) -> Cell:
    bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(traffic_dir or os.path.join(HERE, "traffic"),
                                   w["traffic"] + ".json"))
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])
