"""Golden digests of the full-size deep-panel run, made with the JAX package.

A CUDA install of the port need not have JAX, so the full-size check of
`chip_smoke.py` compares the port's output with digests made beforehand
by the reference package on the CPU:

    python -m gencore_tpu_torch.tools.make_golden

generates (or reuses) `workloads.deep_panel()` — the 240k-read deep
panel, 40,000 fragments on 2 x 8 Mb contigs (bench.make_workload's
recipe), cached in build/workloads/ — runs
`python -m gencore_tpu.cli` on it in a subprocess (JAX on the CPU, its
default path), and writes gencore_tpu_torch/testdata/deep_panel_40k.json:
sha256 and count of the ordered decoded input and output records, and a
sha256 of the JSON report without its `command` line.

This module imports neither JAX nor the JAX package (the reference run is
a subprocess); the digest helpers serve chip_smoke.py.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(REPO, "gencore_tpu_torch", "testdata",
                      "deep_panel_40k.json")
WORKLOAD_DIR = os.path.join(REPO, "build", "workloads")


def digest_records(bam_path: str) -> tuple[int, str]:
    """(record count, sha256 of the records' decoded bytes in file order,
    each prefixed by its length)."""
    from gencore_tpu_torch.io import bam as bamio
    b = bamio.BamReader(bam_path).read_all()
    h = hashlib.sha256()
    for i in range(b.n):
        body = b.record_bytes(i)
        h.update(len(body).to_bytes(4, "little"))
        h.update(body)
    return int(b.n), h.hexdigest()


def digest_report(json_path: str) -> str:
    """sha256 of the JSON report's summary and stats sections (every line
    but `command`, which names the program and its paths)."""
    with open(json_path) as f:
        lines = [ln for ln in f.read().splitlines() if '"command"' not in ln]
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=GOLDEN)
    args = ap.parse_args(argv)
    from gencore_tpu_torch.tools import workloads
    bam_path, fa_path = workloads.deep_panel(WORKLOAD_DIR)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.bam")
        js = os.path.join(d, "report.json")
        env = dict(os.environ, JAX_PLATFORMS="cpu", GENCORE_PLATFORM="cpu",
                   GENCORE_COMPILE_CACHE="0", PYTHONPATH=REPO)
        subprocess.run([sys.executable, "-m", "gencore_tpu.cli", "-i",
                        bam_path, "-o", out, "-r", fa_path, "-j", js,
                        "--html", os.path.join(d, "report.html")],
                       check=True, env=env, cwd=REPO)
        n_in, h_in = digest_records(bam_path)
        n_out, h_out = digest_records(out)
        rep = digest_report(js)
    golden = {
        "workload": f"bench.make_workload() with N_FRAGMENTS="
                    f"{workloads.DEEP_PANEL_FRAGMENTS}",
        "made_by": "python -m gencore_tpu.cli (JAX package, CPU, default "
                   "path)",
        "input": {"records": n_in, "sha256": h_in},
        "output": {"records": n_out, "sha256": h_out},
        "report_stats_sha256": rep,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(json.dumps(golden))
    return 0


if __name__ == "__main__":
    sys.exit(main())
