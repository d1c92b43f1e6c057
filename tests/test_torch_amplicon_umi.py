"""The MiSeq 2x300 UMI amplicon configuration of the benchmark
(`benchmark/configs/miseq_amplicon_umi_2x300.json`) at a small size through
`gencore_tpu_torch.cli.main`'s streaming path on the CPU: its output records
and report equal the benchmark's plain reference; the run's counters, on
its `cli.sample` span, show the dense upload route and the gathered vote;
each `grouping` span's
`cmp` equals the distance rows of the greedy UMI grouping counted from the
sample itself. 3 amplicons: 60 molecules a target give ~3,600 reads (no
tick checkpoint: every cluster keeps the unflushed UMI threshold 0), 170
give ~10,200 (a checkpoint flushes the first amplicons, threshold 1)."""

import io
import json
import os
import re
import sys
import types
from collections import defaultdict
from contextlib import redirect_stderr

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)   # after the repo, so it shadows nothing

from harness import check, gen  # noqa: E402
from reference import bam as refbam  # noqa: E402
from reference.grouping import greedy_umi_groups  # noqa: E402
from reference.run import merged_report, run_part  # noqa: E402

from gencore_tpu_torch import cli  # noqa: E402
from gencore_tpu_torch.utils import tracing  # noqa: E402

CONFIG = os.path.join(BENCH, "configs", "miseq_amplicon_umi_2x300.json")
TRAFFIC = os.path.join(BENCH, "traffic", "amplicon_families.json")
TICK = 10_000                 # gencore.cpp:319-322
SEED = 2**31 + 19
ROUTE = {"upload.dense_rows", "upload.sparse_rows", "upload.qual_raw_rows",
         "vote.window_jobs", "vote.gathered_jobs", "vote.gathered_members"}


def _config():
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["genome"]["genome_bp"] = 2_000_000
    cfg["panel"]["targets"] = 3
    return cfg


@pytest.fixture(scope="module", params=[60, 170], ids=lambda m: f"mol{m}")
def run(request, tmp_path_factory):
    """The sample, and one --debug CLI run over it: (cfg, paths, reads,
    stderr, spans)."""
    cfg = _config()
    with open(TRAFFIC) as f:
        traffic = json.load(f)
    traffic["molecules_per_target"] = request.param
    d = tmp_path_factory.mktemp(f"amplicon{request.param}")
    fa, bed = gen.write_reference(cfg, str(d))
    bam = str(d / "s.bam")
    made = gen.sample(cfg, traffic, SEED, bam)
    paths = {"bam": bam, "fa": fa, "bed": bed, "out": str(d / "o.bam"),
             "json": str(d / "o.json")}
    tracing.disable()
    tracing.take()
    err = io.StringIO()
    with redirect_stderr(err):
        rc = cli.main(["-i", bam, "-o", paths["out"], "-r", fa, "-b", bed,
                       "-j", paths["json"], "-h", str(d / "o.html"),
                       "--device", "cpu", "--stream", "--windows", "3",
                       "--debug", *cfg["cli"]])
    assert rc == 0
    return cfg, paths, made["reads"], err.getvalue(), tracing.take()


def test_streaming_output_and_report_equal_the_reference(run):
    cfg, p, reads, err, _spans = run
    assert "I/O: native core" in err and "streaming path" in err
    ref = run_part(p["bam"], p["fa"], p["bed"], cfg["cli"], 0, reads, True)
    out = check.output_records(p["out"])
    numbers, notes = check.compare(out, ref["records"],
                                   check.report_body(p["json"]),
                                   merged_report([ref]))
    assert numbers == {"records_differing": 0,
                       "report_lines_differing": 0}, notes
    assert len(out) > 0


def test_counters_show_the_dense_route_and_the_gathered_vote(run):
    _cfg, _p, reads, err, spans = run
    (root,) = [s for s in spans if s.name == "cli.sample"]
    total = root.attrs
    assert total["upload.sparse_rows"] == 0
    assert total["vote.window_jobs"] == 0
    # every read is a row of the dense route, with its raw qualities
    # (23 values: no value table), and a member of a gathered job
    assert total["upload.dense_rows"] == reads
    assert total["upload.qual_raw_rows"] == reads
    assert total["vote.gathered_members"] == reads
    assert total["vote.gathered_jobs"] > 0
    assert total["wire.d2hMB"] > 0 and total["wire.h2dMB"] > 0
    # the same totals as the [count] lines
    printed = dict(re.findall(r"^\[count\] (\S+): ([0-9.]+)$", err, re.M))
    assert ROUTE <= set(printed) and set(printed) == set(total)
    for name, v in total.items():
        assert float(printed[name]) == pytest.approx(v, abs=1e-3), name
    assert int(printed["upload.dense_rows"]) == reads


def _greedy_cmp(bam: str, threshold: int) -> dict:
    """From the sample alone: the position clusters whose pairs carry more
    than two distinct UMIs, and the sum over them of UMIs x groups the
    greedy grouping emits (threshold for clusters the last tick flushed,
    0 for the others, gencore.cpp:319-389)."""
    b = refbam.BamReader(bam).read_all()
    tid, pos = b.tid.astype(np.int64), b.pos.astype(np.int64)
    ck = None
    if b.n >= TICK:
        last = (b.n // TICK) * TICK - 1
        ck = (int(tid[last]), int(pos[last]))
    umis = defaultdict(list)
    for i in range(b.n):
        if b.flag[i] != 99:         # one read a pair: R1, the left mate
            continue
        key = (int(tid[i]), int(pos[i]), int(pos[i]) + int(b.isize[i]) - 1)
        umis[key].append(b.qname(i).decode().rsplit(":UMI_", 1)[1])
    out = {"clusters": 0, "umis": 0, "cmp": 0, "pairs_max": 0}
    for (t, left, right), us in umis.items():
        u = len(set(us))
        if u <= 2:
            continue
        flushed = ck is not None and (t < ck[0] or (
            t == ck[0] and left < ck[1] and right < ck[1]))
        groups = greedy_umi_groups(us, threshold if flushed else 0)
        out["clusters"] += 1
        out["umis"] += u
        out["cmp"] += u * len(groups)
        out["pairs_max"] = max(out["pairs_max"], len(us))
    return out


def test_grouping_cmp_is_the_greedy_loops_distance_rows(run):
    cfg, p, reads, _err, spans = run
    grouping = [s for s in spans if s.name == "grouping"]
    assert len(grouping) >= 2
    got = {"clusters": 0, "umis": 0, "cmp": 0, "pairs_max": 0}
    for s in grouping:
        for k in ("clusters", "umis", "cmp"):
            got[k] += s.attrs[k]
        got["pairs_max"] = max(got["pairs_max"], s.attrs["pairs_max"])
    threshold = int(cfg["cli"][cfg["cli"].index("-d") + 1])
    want = _greedy_cmp(p["bam"], threshold)
    assert got == want
    assert want["clusters"] == 3
    if reads >= TICK:
        # the flushed amplicons' UMI errors join their molecules' groups:
        # fewer groups than UMIs
        assert want["cmp"] < sum(s.attrs["umis"] ** 2 for s in grouping)


def test_recording_off_counts_and_annotates_nothing(tmp_path, monkeypatch):
    cfg = _config()
    with open(TRAFFIC) as f:
        traffic = json.load(f)
    traffic["molecules_per_target"] = 20
    fa, bed = gen.write_reference(cfg, str(tmp_path))
    bam = str(tmp_path / "s.bam")
    gen.sample(cfg, traffic, SEED, bam)
    tracing.disable()
    tracing.take()
    annotated = []
    monkeypatch.setattr(tracing, "annotate",
                        lambda **attrs: annotated.append(attrs))
    rc = cli.main(["-i", bam, "-o", str(tmp_path / "o.bam"), "-r", fa,
                   "--device", "cpu", "--stream", *cfg["cli"]])
    assert rc == 0
    assert tracing.take() == [] and annotated == []


def test_gauge_reads_beside_a_half_imported_torch(monkeypatch):
    """The gauge's thread took its whole reading while the CLI's first
    sample imported torch on the main thread, found the module without
    its `cuda` attribute and died; a torch without a whole cuda module has
    no CUDA context, so the reading gives 0 pinned and reserved bytes."""
    monkeypatch.setitem(sys.modules, "torch", types.ModuleType("torch"))
    r = tracing._Reader()
    try:
        g = r.whole()
    finally:
        r.close()
    assert g.pinned == 0 and g.device_reserved == 0 and g.rss > 0
