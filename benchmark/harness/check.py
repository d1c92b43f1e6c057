"""The comparison that decides `correct`: the program's output BAM and JSON
report against the plain reference's, run over the same sample in parts,
one process a part at a time on every core.

The numbers compared, each with the limit 0 (the guarantee is exact):

  * records_differing: output records that differ from the reference's,
    in order, plus the difference in their counts (records are compared
    by 128-bit BLAKE2b digests of their bytes, which a run keeps of the
    reference's records beside the seed's sample);
  * report_lines_differing: lines of the JSON report (all but the
    command) that differ;
  * samples_failed: samples of the window that failed, left the streaming
    path, or wrote another report or output size than the window's first.
"""

from __future__ import annotations

import hashlib
import multiprocessing as mp
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LIMITS = {"records_differing": 0, "report_lines_differing": 0,
          "samples_failed": 0}

DIGEST = 16          # bytes of a record's digest

_W = {}


def digests(records: list) -> list:
    return [hashlib.blake2b(r, digest_size=DIGEST).digest() for r in records]


def _init(bench_dir: str, bam: str, fasta: str, bed: str, argv: list,
          qual_shift: int):
    if bench_dir not in sys.path:
        sys.path.insert(0, bench_dir)
    _W.update(bam=bam, fasta=fasta, bed=bed, argv=argv, qual_shift=qual_shift)


def _part(args):
    lo, hi, last = args
    from reference.run import run_part
    r = run_part(_W["bam"], _W["fasta"], _W["bed"], _W["argv"], lo, hi, last,
                 _W["qual_shift"])
    r["records"] = [bytes(x) for x in r["records"]]
    return r


def part_bounds(bam: str, starts: list, parts: int) -> list:
    """(lo, hi, last) record ranges of about equal size, cut only at the
    given (tid, pos) points (between targets), the last one holding the
    whole run's last flush (reference/partition.py)."""
    from reference import bam as bamio
    from reference.partition import FLUSH_EVERY, cut_points
    n = bamio.BamReader(bam).read_all()
    batch, n = n, n.n
    last_flush = n // FLUSH_EVERY * FLUSH_EVERY - 1
    if last_flush < 0:
        return [(0, n, True)]
    cuts = np.array(sorted(set(int(c) for c in cut_points(batch, starts))
                           - {0, n}), dtype=np.int64)
    cuts = cuts[cuts <= last_flush]
    edges = {0, n}
    if len(cuts):
        for w in np.linspace(0, n, parts + 1)[1:-1]:
            edges.add(int(cuts[np.argmin(np.abs(cuts - w))]))
    edges = sorted(edges)
    return [(a, b, b == n) for a, b in zip(edges[:-1], edges[1:])]


def reference(bam: str, fasta: str, bed: str, argv: list, starts: list,
              workers: int, qual_shift: int = 0) -> tuple:
    """(records, report lines) of the reference over the whole sample
    (qual_shift: the control's narrower qualities, reference/partition.py)."""
    sys.path.insert(0, HERE) if HERE not in sys.path else None
    from reference.run import merged_report
    bounds = part_bounds(bam, starts, max(1, 3 * workers))
    ctx = mp.get_context("spawn")
    with ctx.Pool(workers, initializer=_init,
                  initargs=(HERE, bam, fasta, bed, argv, qual_shift)) as pool:
        parts = pool.map(_part, bounds, chunksize=1)
        pool.close()
        pool.join()
    records = [r for p in parts for r in p["records"]]
    return records, merged_report(parts)


def output_records(bam: str) -> list:
    from reference import bam as bamio
    b = bamio.BamReader(bam).read_all()
    return [b.record_bytes(i) for i in range(b.n)]


def report_body(json_path: str) -> list:
    """The report's lines without the command line and the closing brace."""
    with open(json_path) as f:
        lines = f.read().split("\n")
    return [ln for ln in lines if not ln.startswith('\t"command": ')][:-1]


def compare(out_records: list, ref_records: list, out_report: list,
            ref_report: list) -> tuple:
    """(numbers, first differences for the log)."""
    n = min(len(out_records), len(ref_records))
    bad = [i for i in range(n) if out_records[i] != ref_records[i]]
    rec = len(bad) + abs(len(out_records) - len(ref_records))
    m = max(len(out_report), len(ref_report))
    pad = lambda x: x + [None] * (m - len(x))
    lines = [i for i, (a, b) in enumerate(zip(pad(out_report), pad(ref_report))) if a != b]
    notes = []
    if bad:
        notes.append(f"first differing record {bad[0]} of {n}")
    if len(out_records) != len(ref_records):
        notes.append(f"records: program {len(out_records)}, reference {len(ref_records)}")
    for i in lines[:3]:
        a = out_report[i] if i < len(out_report) else None
        b = ref_report[i] if i < len(ref_report) else None
        notes.append(f"report line {i}: program {str(a)[:150]!r} reference {str(b)[:150]!r}")
    return {"records_differing": rec, "report_lines_differing": len(lines)}, notes


def bed_starts(bed: str, names: list, margin: int = 2000) -> list:
    """(tid, pos) points just before each BED interval: where a sample may
    be cut into parts."""
    tid = {n: i for i, n in enumerate(names)}
    out = []
    with open(bed) as f:
        for line in f:
            c, s = line.split("\t")[:2]
            out.append((tid[c], int(s) - margin))
    return out
