"""The deep panel through the port's CLI, each run in a fresh process, for
checkouts of the port in turns.

    python -m gencore_tpu_torch.tools.fresh_cli_ab ROOT_A ROOT_B [...]
        [--rounds N] [--device cuda] [--fragments N] [--out DIR]

Users run the CLI once per sample, so what a process pays once (the CUDA
context, torch's lazy loading of the CUDA kernels it launches, the first
window's host work) is part of their wall time; a run inside a warm
process does not show it. Each ROOT is the root of a checkout of the
package: this one, or a `git archive` of another commit unpacked under
build/. The deep panel (workloads.deep_panel, 240k reads; --fragments
makes a smaller one of the same recipe) is made once by this checkout.
Every run is `python -m gencore_tpu_torch.cli -i BAM -o OUT -r FA --debug
--device DEVICE` in a new process with PYTHONPATH=ROOT and ROOT as its
working directory. Each root first runs once unrecorded
(it builds its kernels there), then the roots run in turns, A, B, ..., ...,
B, A per round. One JSON line per run: the wall seconds from the spawn to
the exit, and the stage sums the CLI prints under --debug (score.dispatch
among them, summed over the windows); then one line with each root's
medians. Output files go under --out (default build/fresh_cli_ab).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_once(root, bam, fa, out_dir, device):
    """One CLI run in a fresh process of the checkout at root: {"wall_s",
    "stages": {name: seconds}}; raises when the CLI fails."""
    out = os.path.join(out_dir, "out.bam")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "gencore_tpu_torch.cli", "-i",
                        bam, "-o", out, "-r", fa, "--debug", "--device",
                        device], cwd=root, env=env, capture_output=True,
                       text=True)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{root}: CLI exit code {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    # the streaming path's "[stage] name: 1.234s (summed over windows)",
    # or the in-memory paths' "  name     1.234s  12.3%  x5"
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^\[stage\] (\S+): ([0-9.]+)s", r.stderr, re.M)}
    stages.update((m.group(1), float(m.group(2))) for m in re.finditer(
        r"^  (\S+) +([0-9.]+)s +[0-9.]+%", r.stderr, re.M))
    return {"wall_s": wall, "stages": stages}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fragments", type=int, default=None)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "fresh_cli_ab"))
    opts = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from gencore_tpu_torch.tools import workloads
    os.makedirs(opts.out, exist_ok=True)
    bam, fa = workloads.deep_panel(
        os.path.join(opts.out, "workloads"),
        opts.fragments or workloads.DEEP_PANEL_FRAGMENTS)
    runs = {root: [] for root in opts.roots}
    for root in opts.roots:
        run_once(root, bam, fa, opts.out, opts.device)   # builds, unrecorded
    for rnd in range(opts.rounds):
        for root in opts.roots + opts.roots[::-1]:
            res = run_once(root, bam, fa, opts.out, opts.device)
            runs[root].append(res)
            print(json.dumps({"round": rnd, "root": root, **res}),
                  flush=True)
    summary = {}
    for root, rs in runs.items():
        names = sorted({k for r in rs for k in r["stages"]})
        summary[root] = {
            "runs": len(rs),
            "wall_s_median": statistics.median(r["wall_s"] for r in rs),
            "wall_s": [r["wall_s"] for r in rs],
            "stage_medians": {k: statistics.median(
                r["stages"].get(k, 0.0) for r in rs) for k in names}}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
