"""Tiny cells for the CPU tests: the benchmark's configurations with a
2 Mb genome and few targets, and small traffic, in a temporary directory
laid out as the benchmark's own (BENCHMARK.json entries point at it)."""

from __future__ import annotations

import json
import os
import shutil

from conftest import BENCH, ROOT


def make(tmp: str, molecules: dict | None = None, targets: int = 4) -> tuple:
    """(spec, bench_dir) of tiny copies of the repo's cells."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    bench = os.path.join(tmp, "bench")
    os.makedirs(os.path.join(bench, "traffic"), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(bench, "metrics"))
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["genome"]["genome_bp"] = 2_000_000
        cfg["panel"]["targets"] = targets
        cfg["name"] = "tiny_" + cfg["name"]
        c["file"] = os.path.join(tmp, cfg["name"] + ".json")
        with open(c["file"], "w") as f:
            json.dump(cfg, f)
    molecules = molecules or {}
    for w in spec["workloads"]:
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            tr = json.load(f)
        tr["molecules_per_target"] = molecules.get(
            w["traffic"], max(10, tr["molecules_per_target"] // 14))
        with open(os.path.join(bench, "traffic", w["traffic"] + ".json"), "w") as f:
            json.dump(tr, f)
    return spec, bench
