"""The sample generator: one seed makes one sample, every seed makes the
same number of reads, and the distributions the configurations state."""

import json

import numpy as np
import pytest

from conftest import bench_json
from harness import gen
from reference import bam as bamio


def load(name):
    kind, stem = name[:-len(".json")].split("/")
    with open(bench_json(kind, stem)) as f:
        return json.load(f)


def small(cfg_name, targets=3, genome=2_000_000):
    cfg = load(f"configs/{cfg_name}.json")
    cfg["genome"]["genome_bp"] = genome
    cfg["panel"]["targets"] = targets
    return cfg


def test_same_seed_same_bytes_other_seed_same_size(tmp_path):
    cfg = small("cfdna_duplex_2x150")
    tr = load("traffic/families.json")
    tr["molecules_per_target"] = 200
    a = gen.sample(cfg, tr, 2**31 + 7, str(tmp_path / "a.bam"))
    b = gen.sample(cfg, tr, 2**31 + 7, str(tmp_path / "b.bam"))
    c = gen.sample(cfg, tr, -5, str(tmp_path / "c.bam"))
    assert (tmp_path / "a.bam").read_bytes() == (tmp_path / "b.bam").read_bytes()
    assert (tmp_path / "a.bam").read_bytes() != (tmp_path / "c.bam").read_bytes()
    assert a == b
    assert a["reads"] == c["reads"] and a["pairs"] == c["pairs"]


def test_bam_decodes_sorted_with_the_stated_fields(tmp_path):
    cfg = small("cfdna_duplex_2x150")
    tr = load("traffic/families.json")
    tr["molecules_per_target"] = 100
    n = gen.sample(cfg, tr, 3, str(tmp_path / "s.bam"))
    b = bamio.BamReader(str(tmp_path / "s.bam")).read_all()
    assert b.n == n["reads"]
    key = b.tid.astype(np.int64) * 2**32 + b.pos
    assert (np.diff(key) >= 0).all()
    assert set(np.unique(b.flag)) == {99, 147}
    assert (b.l_qseq >= 100).all() and (b.l_qseq <= 150).all()
    assert b.bin[0] == gen.reg2bin(b.pos[:1].astype(np.int64),
                                  b.pos[:1].astype(np.int64) + b.l_qseq[:1])[0]
    q = b.qual(0)
    assert set(np.unique(q)) <= {2, 12, 23, 37}
    name = b.qname(0).decode()
    assert ":UMI_" in name and len(name.split(":UMI_")[1]) == 17


def test_family_sizes_and_fragments_follow_the_configuration():
    fam = gen.family_sizes({"kind": "one_plus_poisson", "mean_extra": 5.0}, 84000)
    assert fam.min() == 1 and abs(fam.mean() - 6.0) < 0.02
    assert abs(np.var(fam) - 5.0) < 0.1
    uni = gen.family_sizes({"kind": "uniform", "lo": 1, "hi": 4}, 100000)
    assert sorted(np.bincount(uni)[1:]) == [25000] * 4
    frag = gen.fragment_lengths(load("configs/cfdna_duplex_2x150.json")["fragment"], 100000)
    assert frag.min() >= 100 and frag.max() <= 400
    assert np.bincount(frag).argmax() in range(163, 172)


def test_umi_errors_and_duplex_strands():
    cfg = small("cfdna_duplex_2x150", targets=4)
    tr = load("traffic/families.json")
    tr["molecules_per_target"] = 2000
    mol = gen.molecules(cfg, tr, 11)
    pr = gen.pairs(cfg, mol, 11)
    true = mol["umi"][pr["mol"]]
    swap = pr["strand"] == 1
    true[swap] = np.concatenate([true[swap, 8:], true[swap, :8]], axis=1)
    rate = (pr["umi"] != true).mean()
    assert 0.004 < rate < 0.006
    # about 5% of the molecules of more than one pair read one strand only
    m = np.bincount(pr["mol"], weights=pr["strand"]) / mol["family"]
    multi = mol["family"] > 3
    one_sided = ((m == 0) | (m == 1))[multi].mean()
    assert 0.04 < one_sided < 0.10


def test_amplicon_reads_overlap_and_carry_per_read_quals(tmp_path):
    cfg = small("amplicon_umi_2x300", targets=6)
    tr = load("traffic/umi.json")
    tr["molecules_per_target"] = 50
    gen.sample(cfg, tr, 9, str(tmp_path / "a.bam"))
    b = bamio.BamReader(str(tmp_path / "a.bam")).read_all()
    assert (b.l_qseq == 300).all()
    left = b.flag == 99
    overlap = 300 - (b.mpos[left] - b.pos[left])
    assert overlap.min() >= 40 and overlap.max() <= 200
    for i in range(0, b.n, 97):
        assert len(set(b.qual(i).tolist())) == 1
    assert int(b.get_int_tag(0, b"NM")) in (0, 1, 2)


@pytest.mark.parametrize("cfg_name", ["cfdna_duplex_2x150", "amplicon_umi_2x300"])
def test_reference_files_are_fixed_by_the_configuration(tmp_path, cfg_name):
    cfg = small(cfg_name)
    fa, bed = gen.write_reference(cfg, str(tmp_path / "c1"))
    fa2, bed2 = gen.write_reference(cfg, str(tmp_path / "c2"))
    assert open(fa, "rb").read() == open(fa2, "rb").read()
    assert open(bed).read() == open(bed2).read()
    lines = open(bed).read().splitlines()
    assert len(lines) == cfg["panel"]["targets"]
