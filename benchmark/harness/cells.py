"""Everything of a cell found by name: its entry in BENCHMARK.json, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`) and the per-layer metrics that read it
(`metrics/<name>.py`). Adding any of them adds files and entries; no code
here names one."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cell:
    def __init__(self, spec: dict, name: str, bench_dir: str = HERE):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.spec = spec
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.bench_dir = bench_dir
        self.root = os.path.dirname(HERE)
        with open(os.path.join(self.root, self.config_entry["file"])) as f:
            self.config = json.load(f)
        self.traffic_path = os.path.join(bench_dir, "traffic",
                                         self.entry["traffic"] + ".json")
        with open(self.traffic_path) as f:
            self.traffic = json.load(f)
        self.config_path = os.path.join(self.root, self.config_entry["file"])

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def end_to_end(self) -> list:
        return [m for m in self.spec["end_to_end"] if self._has(m)]

    def per_layer(self) -> list:
        return [m for m in self.spec["per_layer"] if self._has(m)]

    def _has(self, m: dict) -> bool:
        return "workloads" not in m or self.name in m["workloads"]

    def metric_module(self, name: str):
        return load_metric(self.bench_dir, name)

    def cli_args(self) -> list:
        return list(self.config.get("cli", [])) + list(self.traffic.get("cli", []))


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_metric(bench_dir: str, name: str):
    """The reader of one per-layer metric, from metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
