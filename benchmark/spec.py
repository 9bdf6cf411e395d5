"""Finds what a cell needs by the names in BENCHMARK.json: its configuration
file, its traffic mix (`traffic/<mix>.json`), its limits
(`limits/<cell>.json`) and the reader of each per-layer metric
(`metrics/<metric>.py`, a function `read(ctx)` returning a number or
None). Adding a cell, a mix, a configuration or a metric is adding files
and entries; nothing here names one."""

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json and everything it names."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        self.bench = _load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.workload = cells[name]
        self.name = name
        cfgs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = cfgs[self.workload["config"]]
        self.config = _load_json(os.path.join(root, self.config_entry["file"]))
        bench_dir = os.path.join(root, self.bench["paths"][0])
        self.mix = _load_json(os.path.join(
            bench_dir, "traffic", self.workload["traffic"] + ".json"))
        self.limits = _load_json(os.path.join(bench_dir, "limits",
                                              name + ".json"))["limits"]
        self.metrics_dir = os.path.join(bench_dir, "metrics")

    def _reports(self, metric: dict) -> bool:
        ws = metric.get("workloads")
        return self.name in ws if ws is not None else True

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self._reports(m)]

    def per_layer(self) -> List[dict]:
        return [m for m in self.bench["per_layer"] if self._reports(m)]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        path = os.path.join(self.metrics_dir, metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def readings(cell: Cell, ctx: dict) -> Dict[str, dict]:
    """{metric: {"value", "unit"}} of the cell's per-layer metrics that
    found something to read."""
    out = {}
    for m in cell.per_layer():
        v = cell.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
