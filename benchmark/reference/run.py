"""Run the reference on one part of a sample: gencore's options from the
same command-line flags the program is given, the part's records, and
the part's output records and statistics."""

from __future__ import annotations

import argparse
import functools

from reference import bam as bamio
from reference.bed import BedRegions
from reference.fasta import FastaRef
from reference.jsonreport import report_lines
from reference.options import Options
from reference.partition import PartEngine, subset


def options(argv: list) -> Options:
    """gencore's thresholds from its flags (OpenGene/gencore src/main.cpp);
    file flags and flags of the program's engine are ignored here."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("-u", "--umi_prefix", default="auto")
    p.add_argument("-s", "--supporting_reads", type=int, default=1)
    p.add_argument("-a", "--ratio_threshold", type=float, default=0.8)
    p.add_argument("-c", "--score_threshold", type=int, default=6)
    p.add_argument("-d", "--umi_diff_threshold", type=int, default=1)
    p.add_argument("-D", "--duplex_diff_threshold", type=int, default=2)
    p.add_argument("--high_qual", type=int, default=30)
    p.add_argument("--moderate_qual", type=int, default=20)
    p.add_argument("--low_qual", type=int, default=15)
    p.add_argument("--coverage_sampling", type=int, default=10000)
    p.add_argument("-x", "--duplex_only", action="store_true")
    p.add_argument("--no_duplex", action="store_true")
    a, _ = p.parse_known_args(argv)
    return Options(
        umi_prefix=a.umi_prefix, cluster_size_req=a.supporting_reads,
        base_score_req=a.score_threshold,
        score_percent_req=a.ratio_threshold, high_quality=a.high_qual,
        moderate_quality=a.moderate_qual, low_quality=a.low_qual,
        coverage_step=a.coverage_sampling,
        proper_reads_umi_diff_threshold=a.umi_diff_threshold,
        duplex_mismatch_threshold=a.duplex_diff_threshold,
        duplex_only=a.duplex_only, disable_duplex=a.no_duplex).validate()


def run_part(bam: str, fasta: str, bed: str, argv: list, lo: int, hi: int,
             last: bool, qual_shift: int = 0) -> dict:
    """Records lo..hi-1 of the sample through the reference. Returns the
    output records' bytes in file order and the part's two Stats."""
    opt = options(argv)
    if opt.umi_prefix == "auto":
        raise ValueError("give the reference the UMI prefix (-u)")
    header, batch, ref = _inputs(bam, fasta)
    regions = None
    if bed:
        regions = BedRegions.load(bed, header.names)
        opt.has_bed_file = True
    eng = PartEngine(opt, header, fasta=ref, bed=regions)
    out = eng.run_part(subset(batch, lo, hi), lo, last, qual_shift)
    return {"records": [r.encode() for r in out], "pre": eng.pre_stats,
            "post": eng.post_stats, "has_bed": opt.has_bed_file}


@functools.lru_cache(maxsize=1)
def _inputs(bam: str, fasta: str) -> tuple:
    """The sample decoded and the genome loaded once a process: a worker
    runs several parts of one sample."""
    reader = bamio.BamReader(bam)
    return reader.header, reader.read_all(), FastaRef.load(fasta)


def merged_report(parts: list) -> list:
    """The JSON report's lines (all but the command) of the whole run from
    its parts' statistics."""
    pre, post = parts[0]["pre"], parts[0]["post"]
    for p in parts[1:]:
        pre.merge_from(p["pre"])
        post.merge_from(p["post"])
    return report_lines(pre, post, parts[0]["has_bed"])
