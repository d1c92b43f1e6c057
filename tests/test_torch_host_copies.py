"""The port's copies of the host modules it shares with the JAX package
(gencore_tpu_torch/{io,options,stats,report,utils,core/...}) and of the
test suite's BAM generator (gencore_tpu_torch/tools/workloads.py) against
the originals, on the CPU: the same seed and recipe write the same BAM
(equal after BGZF inflation; equal as files too when both packages
deflate with the same library, since each has its own native core and
codec), both readers decode it to the same records, and the oracle's JSON
and HTML reports of one small run are identical."""

import datetime

import numpy as np
import pytest

from gencore_tpu.core.oracle import OracleEngine
from gencore_tpu.io import bam
from gencore_tpu.io.fasta import FastaRef
from gencore_tpu.options import Options
from gencore_tpu.report import htmlreport, jsonreport
from gencore_tpu_torch.core.oracle import OracleEngine as TOracleEngine
from gencore_tpu_torch.io import bam as tbam
from gencore_tpu_torch.io.fasta import FastaRef as TFastaRef
from gencore_tpu_torch.options import Options as TOptions
from gencore_tpu_torch.report import htmlreport as thtmlreport
from gencore_tpu_torch.report import jsonreport as tjsonreport
from gencore_tpu_torch.tools import workloads
from tests import datagen
from tests.test_torch_native import inflate, same_codec


def _recipe(cls):
    """One generator of each kind, driven through every record builder."""
    sb = cls(seed=17, contig_len=60_000, n_contigs=2)
    rng = np.random.default_rng(18)
    for k in range(60):
        pos = 500 + 700 * k
        for _ in range(int(rng.integers(1, 4))):
            sb.add_pair(k % 2, pos, pos + 120, read_len=100,
                        umi="ACGT_TTGA" if k % 3 else "TTGA_ACGT",
                        n_errors=int(rng.integers(0, 3)),
                        qual=int(rng.choice([18, 30, 36])), softclip_left=k % 4)
    sb.add_single(0, 45_000, umi="AAAA_CCCC", flag=0)
    sb.add_single(-1, -1, read_len=50, flag=4)
    sb.add_cross_pair(0, 46_000, 1, 46_500, umi="GGGG_TTTT")
    sb.add_pair_mi(1, 47_000, 47_150, mi="ACGTACGT", n_errors=1)
    return sb


def _fixed_now(monkeypatch):
    """Both HTML reports stamp datetime.datetime.now(): fix it."""
    class _Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2024, 1, 2, 3, 4, 5)

    monkeypatch.setattr(datetime, "datetime", _Clock)


@pytest.mark.parametrize("check", ["bam_bytes", "bam_decode", "reports"])
def test_host_copies_match_the_jax_package(tmp_path, monkeypatch, check):
    ref_bam, port_bam = str(tmp_path / "ref.bam"), str(tmp_path / "port.bam")
    ref_fa, port_fa = str(tmp_path / "ref.fa"), str(tmp_path / "port.fa")
    for cls, b, f in ((datagen.SyntheticBam, ref_bam, ref_fa),
                      (workloads.SyntheticBam, port_bam, port_fa)):
        sb = _recipe(cls)
        sb.write_bam(b)
        sb.write_fasta(f)
    if check == "bam_bytes":
        plain = inflate(ref_bam)
        assert plain == inflate(port_bam) and len(plain) > 20_000
        if same_codec():
            with open(ref_bam, "rb") as a, open(port_bam, "rb") as b:
                assert a.read() == b.read()
        with open(ref_fa, "rb") as a, open(port_fa, "rb") as b:
            assert a.read() == b.read()
        return
    jb = bam.BamReader(ref_bam)
    tb = tbam.BamReader(ref_bam)
    if check == "bam_decode":
        a, b = jb.read_all(), tb.read_all()
        assert jb.header.text == tb.header.text
        assert jb.header.names == tb.header.names
        assert a.n == b.n > 100
        assert all(a.record_bytes(i) == b.record_bytes(i) for i in range(a.n))
        return
    oeng = OracleEngine(Options(), jb.header, fasta=FastaRef.load(ref_fa))
    out = sorted(r.encode() for r in oeng.run(jb.read_all()))
    teng = TOracleEngine(TOptions(), tb.header, fasta=TFastaRef.load(ref_fa))
    tout = sorted(r.encode() for r in teng.run(tb.read_all()))
    assert out == tout and len(out) > 50
    _fixed_now(monkeypatch)
    cmd = "gencore -i in.bam -o out.bam -r ref.fa"
    reports = []
    for eng, opt, js, ht in ((oeng, Options(), jsonreport, htmlreport),
                             (teng, TOptions(), tjsonreport, thtmlreport)):
        tag = ht.__name__.split(".")[0]
        js.write_json_report(str(tmp_path / f"{tag}.json"), opt,
                             eng.pre_stats, eng.post_stats, cmd)
        ht.write_html_report(str(tmp_path / f"{tag}.html"), opt,
                             eng.pre_stats, eng.post_stats, cmd)
        reports.append([(tmp_path / f"{tag}.{ext}").read_bytes()
                        for ext in ("json", "html")])
    assert reports[0] == reports[1]
    assert b"2024-01-02" in reports[0][1]
