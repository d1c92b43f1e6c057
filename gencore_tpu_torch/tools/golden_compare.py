"""The port's CLI over the JAX CLI's option surface: a registry of cases,
each a seeded workload, its CLI arguments and the routes the CLI allows
for it, held to golden digests that the JAX CLI made on the CPU
(gencore_tpu_torch/testdata/cases/<case>.json, written by
`python -m gencore_tpu_torch.tools.make_golden --case NAME`).

    python -m gencore_tpu_torch.tools.golden_compare [--case NAME ...]
        [--device cpu|cuda] [--quick]

At the full size each run of a case is held to its golden digests. With
`--quick` (300 fragments, golden_compare's quick size, no golden) the
routes of a case are held to one another. One JSON line per case, then
PASS or FAIL; the exit code is 1 on any difference.

The workload builders and the eight first cases (names, seeds, sizes and
arguments) are those of the engine-against-engine half of
tools/golden_compare.py; the five after them come from the JAX CLI's
surface and the JAX package's tests. Routes: `default` is the CLI's own
choice (in-memory single-shot for an input under 1 MB), `stream` adds
`--stream`, `windows3` adds `--windows 3`. The CLI refuses `--stream`
for SAM input or output and with `--quit_after_contig`, and with
`--quit_after_contig` it runs single-shot whatever `--windows` says, so
those cases take the default route only.

Digests of one run: the input records, the ordered output records (for
SAM output the SAM text, as written: neither package puts a program line
or command in the SAM header), the JSON report without its `command`
line, and the HTML report after `normalize_html` (version, command echo
and timestamps blanked, the BED path cut to its file name). This module
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
import sys
import tempfile
from dataclasses import dataclass

import numpy as np

from gencore_tpu_torch.tools.workloads import SyntheticBam

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CASES_DIR = os.path.join(REPO, "gencore_tpu_torch", "testdata", "cases")
QUICK_FRAGMENTS = 300

ROUTES = {"default": [], "stream": ["--stream"],
          "windows3": ["--windows", "3"]}
ALL_ROUTES = tuple(ROUTES)
IN_MEMORY_ROUTES = ("default", "windows3")

# capture regions over the first contig (tools/golden_compare.py:91-97)
BED_LINES = [f"chr1\t{1000 + 15000 * k}\t{6000 + 15000 * k}\tR{k}\n"
             for k in range(12)]


def wide_workload(seed, n_frags, dupmean=3, clen=400_000):
    rng = np.random.default_rng(seed)
    sb = SyntheticBam(seed=seed, contig_len=clen, n_contigs=2)
    umis = ["AAAA", "CCCC", "GGGG", "TTTT", "ACGT", "TGCA", "GATC", "CTAG"]
    for _ in range(n_frags):
        tid = int(rng.integers(0, 2))
        pos1 = int(rng.integers(100, clen - 1000))
        frag = int(rng.integers(160, 340))
        read_len = 150
        pos2 = max(pos1, pos1 + frag - read_len)
        a, b = rng.choice(umis, size=2, replace=False)
        ndup = 1 + int(rng.poisson(dupmean - 1))
        for _ in range(ndup):
            n_err = int(rng.random() < 0.3) * int(rng.integers(1, 3))
            sb.add_pair(tid, pos1, pos2, read_len=read_len, umi=f"{a}_{b}",
                        n_errors=n_err, qual=int(rng.choice([18, 30, 36])))
    return sb


def simple_workload(seed, n_frags, umi=False, clen=200_000):
    rng = np.random.default_rng(seed)
    sb = SyntheticBam(seed=seed, contig_len=clen, n_contigs=1)
    for _ in range(n_frags):
        pos1 = int(rng.integers(100, clen - 1000))
        pos2 = pos1 + int(rng.integers(10, 180))
        u = None
        if umi:
            u = "".join("ACGT"[i] for i in rng.integers(0, 4, 6))
        for _ in range(1 + int(rng.poisson(2))):
            sb.add_pair(0, pos1, pos2, read_len=100, umi=u,
                        n_errors=int(rng.integers(0, 3)),
                        qual=int(rng.choice([12, 22, 35])))
    return sb


def mi_minority_workload(seed, n_frags, clen=400_000):
    """UMIs in qnames for most reads, MI:Z aux tags on a small minority
    (whose qnames carry no UMI): the reference consults MI per read
    (bamutil.cpp:23-38), so the minority must still group by MI."""
    rng = np.random.default_rng(seed)
    sb = SyntheticBam(seed=seed, contig_len=clen, n_contigs=1)
    umis = ["AAAA_CCCC", "CCCC_AAAA", "GGGG_TTTT", "TTTT_GGGG"]
    for k in range(n_frags):
        pos1 = int(rng.integers(100, clen - 1000))
        pos2 = pos1 + int(rng.integers(20, 180))
        u = str(rng.choice(umis))
        for d in range(1 + int(rng.poisson(1.5))):
            if k % 41 == 17 and d == 0:
                # the MI value embeds the prefix so that getUMI parses it
                # non-empty under -u UMI (bamutil.cpp:44)
                sb.add_pair_mi(0, pos1, pos2, mi=f"UMI_{u}",
                               n_errors=int(rng.integers(0, 2)))
            else:
                sb.add_pair(0, pos1, pos2, read_len=100, umi=u,
                            n_errors=int(rng.integers(0, 2)),
                            qual=int(rng.choice([18, 35])))
    return sb


@dataclass(frozen=True)
class Case:
    """One CLI case: `build(n_fragments)` makes its SyntheticBam; `n` is
    its fragment count at the full size; `args` its CLI arguments (the
    input, output, reference and report paths are added); `routes` the
    routes the CLI allows for it."""
    name: str
    workload: str
    build: object
    n: int
    args: tuple
    routes: tuple = ALL_ROUTES
    sam_in: bool = False
    sam_out: bool = False
    bed: bool = False
    ref: bool = True


def _case_list():
    def simple(seed, umi=False):
        return lambda n: simple_workload(seed, n, umi=umi)

    def wide(seed, clen=400_000):
        return lambda n: wide_workload(seed, n, clen=clen)

    U = ("-u", "UMI")
    return [
        Case("defaults_noumi", "simple (seed 11), read length 100",
             simple(11), 1500, ()),
        Case("mi_minority", "mi_minority (seed 18)",
             lambda n: mi_minority_workload(18, n), 1500, U),
        Case("duplex_umi", "wide (seed 12)", wide(12), 1500, U),
        Case("s2_scores", "simple (seed 13)", simple(13), 1500,
             ("-s", "2", "-c", "8")),
        Case("umi_singlestrand", "simple (seed 14), UMIs", simple(14, True),
             1500, U + ("--no_duplex",)),
        Case("duplex_only", "wide (seed 15)", wide(15), 1500, U + ("-x",)),
        Case("bed_regions", "wide (seed 17) + 12 capture regions on chr1",
             wide(17), 1500, (), bed=True),
        Case("big_mixed", "wide (seed 16), 2 x 2 Mb contigs",
             wide(16, 2_000_000), 4000, U),
        Case("no_ref", "wide (seed 19), no FASTA passed", wide(19), 1500, U,
             ref=False),
        Case("thresholds", "wide (seed 20)", wide(20), 1500,
             U + ("-a", "0.7", "-c", "4", "--high_qual", "33",
                  "--moderate_qual", "25", "--low_qual", "12", "-d", "2",
                  "-D", "3")),
        Case("sam_in", "duplex_umi's input (wide, seed 12) written as SAM",
             wide(12), 1500, U, routes=IN_MEMORY_ROUTES, sam_in=True),
        Case("sam_out", "duplex_umi's input (wide, seed 12)", wide(12), 1500,
             U, routes=IN_MEMORY_ROUTES, sam_out=True),
        Case("quit_after_contig", "wide (seed 21)", wide(21), 1500,
             U + ("--quit_after_contig", "1"), routes=("default",)),
    ]


CASES = {c.name: c for c in _case_list()}


def golden_path(name: str) -> str:
    return os.path.join(CASES_DIR, f"{name}.json")


def n_fragments(case: Case, quick: bool) -> int:
    return QUICK_FRAGMENTS if quick else case.n


def prepare(case: Case, workdir: str, quick: bool = False):
    """Write the case's input under workdir; returns (input path, FASTA
    path or None, BED path or None, input digest dict). Reuses files made
    before in the same directory (one per case and size)."""
    os.makedirs(workdir, exist_ok=True)
    stem = os.path.join(workdir, f"{case.name}_{n_fragments(case, quick)}")
    inp = stem + (".sam" if case.sam_in else ".bam")
    fa = stem + ".fa"
    bed = stem + ".bed" if case.bed else None
    if not (os.path.exists(inp) and os.path.exists(fa)):
        sb = case.build(n_fragments(case, quick))
        bam_path = stem + ".bam.tmp" if case.sam_in else inp + ".tmp"
        sb.write_bam(bam_path)
        if case.sam_in:
            _bam_to_sam(bam_path, inp + ".tmp")
            os.remove(bam_path)
        sb.write_fasta(fa + ".tmp")
        os.replace(fa + ".tmp", fa)
        os.replace(inp + ".tmp", inp)
    if bed is not None:
        with open(bed, "w") as f:
            f.writelines(BED_LINES)
    from gencore_tpu_torch.tools.make_golden import digest_records
    n, h = digest_records(inp)
    return inp, (fa if case.ref else None), bed, {"records": n, "sha256": h}


def _bam_to_sam(bam_path: str, sam_path: str):
    from gencore_tpu_torch.io import bam as bamio
    from gencore_tpu_torch.io.sam import SamWriter
    rdr = bamio.BamReader(bam_path)
    batch = rdr.read_all()
    w = SamWriter(sam_path, rdr.header)
    for i in range(batch.n):
        w.write_record(batch.record_bytes(i))
    w.close()


def digest_sam_text(path: str) -> tuple[int, str]:
    """(record lines, sha256 of the SAM text). Neither package writes a
    program line into the SAM header, so the text is hashed as it is."""
    with open(path, "rb") as f:
        text = f.read()
    n = sum(1 for ln in text.splitlines() if ln and not ln.startswith(b"@"))
    return n, hashlib.sha256(text).hexdigest()


def normalize_html(path: str) -> str:
    """HTML comparison surface (tools/golden_compare.py:56-71): the version
    cell, the command echo and the timestamps blanked, and the BED path in
    the title of the BED coverage section cut to its file name (goldens
    are made in another directory); everything else is compared byte for
    byte."""
    with open(path, "rb") as f:
        s = f.read().decode("latin-1")
    s = re.sub(r"(Coverage statistics in BED:<font size=-2>)[^<]*/",
               r"\1", s)
    s = re.sub(r"gencore report at [0-9: -]+ </title>",
               "gencore report at T </title>", s)
    s = re.sub(r"<p>.*?</p>", "<p></p>", s, flags=re.S)
    s = re.sub(r"gencore(-tpu)? v?[0-9.]+, at [0-9: -]+ </div>",
               "gencore V, at T </div>", s)
    s = re.sub(r"<tr><td class='col1'>gencore(-tpu)? version:</td>"
               r"<td class='col2'>[^<]*",
               "<tr><td class='col1'>gencore version:</td>"
               "<td class='col2'>V", s)
    return s


def digest_html(path: str) -> str:
    return hashlib.sha256(normalize_html(path).encode("latin-1")).hexdigest()


def cli_args(case: Case, route: str, inp: str, fa, bed, out_stem: str):
    """The full argument list of one run; outputs at out_stem.*"""
    if route not in case.routes:
        raise ValueError(f"case {case.name} does not take route {route}")
    out = out_stem + (".sam" if case.sam_out else ".bam")
    args = ["-i", inp, "-o", out, "-j", out_stem + ".json",
            "--html", out_stem + ".html"]
    if fa is not None:
        args += ["-r", fa]
    if bed is not None:
        args += ["-b", bed]
    return args + list(case.args) + ROUTES[route]


def output_digests(case: Case, out_stem: str) -> dict:
    """Digests of one run's outputs at out_stem.*"""
    from gencore_tpu_torch.tools.make_golden import (digest_records,
                                                     digest_report)
    if case.sam_out:
        n, h = digest_sam_text(out_stem + ".sam")
    else:
        n, h = digest_records(out_stem + ".bam")
    return {"output": {"records": n, "sha256": h},
            "report_stats_sha256": digest_report(out_stem + ".json"),
            "html_sha256": digest_html(out_stem + ".html")}


def run_route(case: Case, route: str, workdir: str, device: str = "cuda",
              quick: bool = False) -> dict:
    """One run of the port's CLI (in this process) on the case's input by
    `route`; returns {"input", "output", "report_stats_sha256",
    "html_sha256", "io_line"}. Raises when the CLI exits non-zero."""
    from gencore_tpu_torch import cli
    inp, fa, bed, d_in = prepare(case, workdir, quick)
    stem = os.path.join(workdir, f"{case.name}_{route}_port")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(cli_args(case, route, inp, fa, bed, stem)
                      + ["--device", device])
    if rc != 0:
        raise RuntimeError(f"{case.name}/{route}: CLI exit code {rc}: "
                           f"{err.getvalue()[-2000:]}")
    io_line = next((ln for ln in err.getvalue().splitlines()
                    if ln.startswith("I/O: ")), None)
    return {"input": d_in, **output_digests(case, stem), "io_line": io_line}


DIGEST_KEYS = ("input", "output", "report_stats_sha256", "html_sha256")


def differences(got: dict, want: dict) -> list:
    """Names of the digests in which two results differ."""
    return [k for k in DIGEST_KEYS if got.get(k) != want.get(k)]


def load_golden(name: str) -> dict:
    with open(golden_path(name)) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", action="append", choices=sorted(CASES),
                    help="a case to run (repeatable; default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help=f"{QUICK_FRAGMENTS} fragments per case; routes held "
                         "to one another instead of to the golden digests")
    a = ap.parse_args(argv)
    failures = 0
    with tempfile.TemporaryDirectory() as wd:
        for name in a.case or list(CASES):
            case = CASES[name]
            want = None if a.quick else load_golden(name)
            res = {}
            for route in case.routes:
                got = run_route(case, route, wd, a.device, a.quick)
                if want is None:
                    want = got
                res[route] = differences(got, want)
            ok = not any(res.values())
            failures += not ok
            print(json.dumps({"case": name, "ok": ok,
                              "held_to": "routes" if a.quick else "golden",
                              "differences": res}), flush=True)
    print("PASS" if not failures else f"FAIL: {failures} case(s) differ")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
