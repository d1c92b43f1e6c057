"""Golden digests of the on-card workloads, made with the JAX package.

A CUDA install of the port need not have JAX, so the full-size checks of
`chip_smoke.py` compare the port's output with digests made beforehand
by the reference package on the CPU:

    python -m gencore_tpu_torch.tools.make_golden [--workload NAME]
    python -m gencore_tpu_torch.tools.make_golden --case NAME [--case ...]
    python -m gencore_tpu_torch.tools.make_golden --cases

generates (or reuses) the workload (cached in build/workloads/), runs
`python -m gencore_tpu.cli` on it in a subprocess (JAX on the CPU, its
default path) with the workload's CLI arguments, and writes
gencore_tpu_torch/testdata/<file>: sha256 and count of the ordered
decoded input and output records, a sha256 of the JSON report without
its `command` line, and the CLI arguments. Workloads (`WORKLOADS`):

  * deep_panel (default) — the 240k-read deep panel, 40,000 fragments on
    2 x 8 Mb contigs (bench.make_workload's recipe): deep_panel_40k.json;
  * ultradeep — bench.make_ultradeep_workload's recipe, 40 loci x 1,500
    pairs, run with UMI grouping off (`-u ''`): ultradeep.json;
  * full_bins — workloads.full_bins_panel, reads with IUPAC codes:
    full_bins_panel.json;
  * long_amplicon — workloads.long_amplicon, a 2x300 UMI amplicon panel
    (every window stages dense, L = 320): long_amplicon.json.

`--case NAME` (repeatable) or `--cases` (all) does the same for the CLI
cases of tools/golden_compare.py at their full size: the JAX CLI's own
route with the case's arguments, into testdata/cases/<case>.json, which
also holds the sha256 of the normalized HTML report (`html_sha256`) and
the report's consensus read counts (`summary`: single-strand and duplex,
so that a case meant to merge duplexes shows that it does). For
a case with SAM output, `output` digests the SAM text.

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
TESTDATA = os.path.join(REPO, "gencore_tpu_torch", "testdata")
GOLDEN = os.path.join(TESTDATA, "deep_panel_40k.json")
WORKLOAD_DIR = os.path.join(REPO, "build", "workloads")

# name: (golden file, CLI arguments beyond -i/-o/-r/-j/--html, description)
WORKLOADS = {
    "deep_panel": ("deep_panel_40k.json", [],
                   "bench.make_workload() with N_FRAGMENTS=40000"),
    "ultradeep": ("ultradeep.json", ["-u", ""],
                  "bench.make_ultradeep_workload() (seed 21, 40 loci x "
                  "1,500 pairs), UMI grouping off"),
    "full_bins": ("full_bins_panel.json", [],
                  "workloads.full_bins_panel() (seed 31, 100 loci, IUPAC "
                  "codes, duplex UMIs, shifted right reads)"),
    "long_amplicon": ("long_amplicon.json", [],
                      "workloads.long_amplicon() (seed 31, 2x300 reads, 240 "
                      "amplicons of 400-560 bp x 80 UMI molecules of 1-4 "
                      "copies, quals 2-41 per read)"),
}


def golden_path(name: str) -> str:
    return os.path.join(TESTDATA, WORKLOADS[name][0])


def make_workload(name: str, out_dir: str = WORKLOAD_DIR):
    """(bam_path, fasta_path) of the named workload under out_dir."""
    from gencore_tpu_torch.tools import workloads
    return {"deep_panel": workloads.deep_panel,
            "ultradeep": workloads.ultradeep,
            "full_bins": workloads.full_bins_panel,
            "long_amplicon": workloads.long_amplicon}[name](out_dir)


def digest_records(path: str) -> tuple[int, str]:
    """(record count, sha256 of the records' decoded bytes in file order,
    each prefixed by its length) of a BAM or SAM file."""
    from gencore_tpu_torch.io.sam import open_alignment
    b = open_alignment(path).read_all()
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


def _jax_cli(args, cwd=REPO):
    """`python -m gencore_tpu.cli ARGS` on the CPU in a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", GENCORE_PLATFORM="cpu",
               GENCORE_COMPILE_CACHE="0", PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-m", "gencore_tpu.cli", *args],
                   check=True, env=env, cwd=cwd, stdout=subprocess.DEVNULL)


MADE_BY = "python -m gencore_tpu.cli (JAX package, CPU, default path)"


def _write(golden: dict, out_path: str):
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(json.dumps(golden))


def make_case(name: str, out_path: str = None):
    """The golden digests of one golden_compare case at its full size."""
    from gencore_tpu_torch.tools import golden_compare as gc
    case = gc.CASES[name]
    with tempfile.TemporaryDirectory() as d:
        inp, fa, bed, d_in = gc.prepare(case, d)
        stem = os.path.join(d, "jax")
        _jax_cli(gc.cli_args(case, "default", inp, fa, bed, stem))
        golden = {"workload": f"golden_compare case {name}: {case.workload}, "
                              f"{case.n} fragments",
                  "made_by": MADE_BY, "input": d_in,
                  **gc.output_digests(case, stem),
                  "summary": gc.report_summary(stem + ".json"),
                  "cli_args": list(case.args)}
    _write(golden, out_path or gc.golden_path(name))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="deep_panel",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--case", action="append", default=[],
                    help="a golden_compare case (repeatable)")
    ap.add_argument("--cases", action="store_true",
                    help="every golden_compare case")
    ap.add_argument("--out", default=None,
                    help="golden file (default: the workload's file in "
                         "gencore_tpu_torch/testdata, or the case's in "
                         "testdata/cases)")
    args = ap.parse_args(argv)
    if args.case or args.cases:
        from gencore_tpu_torch.tools.golden_compare import CASES
        names = list(CASES) if args.cases else args.case
        unknown = [n for n in names if n not in CASES]
        if unknown:
            ap.error(f"unknown case(s) {unknown}; known: {sorted(CASES)}")
        if args.out and len(names) > 1:
            ap.error("--out names one file: give one --case")
        for name in names:
            make_case(name, args.out)
        return 0
    fname, cli_args, desc = WORKLOADS[args.workload]
    out_path = args.out or golden_path(args.workload)
    bam_path, fa_path = make_workload(args.workload)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.bam")
        js = os.path.join(d, "report.json")
        _jax_cli(["-i", bam_path, "-o", out, "-r", fa_path, "-j", js,
                  "--html", os.path.join(d, "report.html"), *cli_args])
        n_in, h_in = digest_records(bam_path)
        n_out, h_out = digest_records(out)
        rep = digest_report(js)
    golden = {
        "workload": desc,
        "made_by": MADE_BY,
        "input": {"records": n_in, "sha256": h_in},
        "output": {"records": n_out, "sha256": h_out},
        "report_stats_sha256": rep,
    }
    if cli_args:
        golden["cli_args"] = cli_args
    _write(golden, out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
