"""The reference that decides `correct`: its array form equals the scalar
oracle it was copied from, a run cut into parts equals one run over the
whole file, and it equals the program's own scalar oracle
(`cli.main --oracle`) byte for byte."""

import contextlib
import io
import json

import pytest

from conftest import bench_json
from harness import check, gen
from reference import oracle, postmerge, umi
from reference import run as rr


def cell(tmp_path, cfg_name, traffic, molecules, targets, seed):
    with open(bench_json("configs", cfg_name)) as f:
        cfg = json.load(f)
    cfg["genome"]["genome_bp"] = 2_000_000
    cfg["panel"]["targets"] = targets
    with open(bench_json("traffic", traffic)) as f:
        tr = json.load(f)
    tr["molecules_per_target"] = molecules
    fa, bed = gen.write_reference(cfg, str(tmp_path / "cache"))
    bam = str(tmp_path / "s.bam")
    n = gen.sample(cfg, tr, seed, bam)["reads"]
    return cfg, bam, fa, bed, n


def _scalar_post(singles, has_umi, opt, pre_stats, post_stats):
    results = []
    if has_umi and not opt.disable_duplex:
        while singles:
            p1 = singles.pop()
            found = False
            for i, p2 in enumerate(singles):
                if umi.is_duplex(p1.umi, p2.umi):
                    found = True
                    d = postmerge.duplex_merge(p1, p2)
                    pre_stats.add_molecule(p1.merge_reads + p2.merge_reads,
                                           p1.left is not None and p1.right is not None)
                    if d <= opt.duplex_mismatch_threshold:
                        if p1.merge_reads + p2.merge_reads >= opt.cluster_size_req:
                            p1.is_duplex = True
                            p1.reverse_merge_reads = p2.merge_reads
                            p1.write_sscs_dcs_tag()
                            post_stats.add_dcs()
                            results.append(p1)
                    del singles[i]
                    break
            if not found:
                pre_stats.add_molecule(p1.merge_reads,
                                       p1.left is not None and p1.right is not None)
                if not opt.duplex_only and p1.merge_reads >= opt.cluster_size_req:
                    p1.write_sscs_dcs_tag()
                    post_stats.add_sscs()
                    results.append(p1)
    else:
        return postmerge.postprocess_cluster(singles, has_umi, opt, pre_stats, post_stats)
    if results:
        post_stats.add_cluster(len(results) > 1)
    return results


@pytest.mark.parametrize("cfg_name,traffic,molecules", [
    ("cfdna_duplex_2x150", "families", 120), ("amplicon_umi_2x300", "umi", 60)])
def test_array_form_equals_scalar_oracle(tmp_path, monkeypatch, cfg_name, traffic, molecules):
    cfg, bam, fa, bed, n = cell(tmp_path, cfg_name, traffic, molecules, 3, 21)
    fast = rr.run_part(bam, fa, bed, cfg["cli"], 0, n, True)
    monkeypatch.setattr(oracle.OPair, "compute_score", oracle.OPair.compute_score_scalar)
    monkeypatch.setattr(oracle.OGroup, "make_consensus", oracle.OGroup.make_consensus_scalar)
    monkeypatch.setattr(oracle, "postprocess_cluster", _scalar_post)
    slow = rr.run_part(bam, fa, bed, cfg["cli"], 0, n, True)
    assert len(fast["records"]) > 100
    assert fast["records"] == slow["records"]
    assert rr.merged_report([fast]) == rr.merged_report([slow])


def test_parts_equal_one_run(tmp_path):
    # 4 targets of about 12k reads: several flushes, cuts between targets
    cfg, bam, fa, bed, n = cell(tmp_path, "cfdna_duplex_2x150", "families", 1000, 4, 5)
    whole = rr.run_part(bam, fa, bed, cfg["cli"], 0, n, True)
    p = gen.panel(cfg)
    starts = [(int(t), int(s) - 2000) for t, s in zip(p["tid"], p["start"])]
    bounds = check.part_bounds(bam, starts, 4)
    assert len(bounds) >= 3 and bounds[-1][2]
    parts = [rr.run_part(bam, fa, bed, cfg["cli"], lo, hi, last) for lo, hi, last in bounds]
    assert [r for q in parts for r in q["records"]] == whole["records"]
    assert rr.merged_report(parts) == rr.merged_report([whole])
    recs, report = check.reference(bam, fa, bed, cfg["cli"], starts, 2)
    assert recs == whole["records"] and report == rr.merged_report([whole])


@pytest.mark.parametrize("cfg_name,traffic,molecules", [
    ("cfdna_duplex_2x150", "families", 150), ("amplicon_umi_2x300", "umi", 80)])
def test_reference_equals_the_programs_oracle(tmp_path, cfg_name, traffic, molecules):
    from gencore_tpu_torch import cli
    cfg, bam, fa, bed, n = cell(tmp_path, cfg_name, traffic, molecules, 3, 33)
    out, js = str(tmp_path / "o.bam"), str(tmp_path / "o.json")
    with contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["-i", bam, "-o", out, "-r", fa, "-b", bed, "-j", js,
                       "-h", str(tmp_path / "o.html"), "--oracle"] + cfg["cli"])
    assert rc == 0
    ref = rr.run_part(bam, fa, bed, cfg["cli"], 0, n, True)
    assert check.output_records(out) == ref["records"]
    assert check.report_body(js) == rr.merged_report([ref])
