"""Synthetic sorted-BAM workloads for the port's on-card checks.

`SyntheticBam` is a copy of the test suite's generator (tests/datagen.py),
writing through this package's io: the same seed and calls give the same
bytes (tests/test_torch_host_copies.py holds the two to that). Two recipes
build on it:

  * `deep_panel` — the 240k-read deep panel: 40,000 duplex-UMI fragments
    on 2 x 8 Mb contigs, ~3 duplicates each (the recipe of
    bench.make_workload, seed 7);
  * `small_panel` — ~3k reads: duplex UMIs, 40-pair clusters and
    lenDiff-shifted right reads, so every vote entry point runs;
  * `ultradeep` — the ultra-deep amplicon pile of
    bench.make_ultradeep_workload (seed 21, 2 x 8 Mb contigs, 40 loci x
    1,500 pairs, ~120k reads); run without `-u`, each locus is one job of
    1,500 members per side, voted by the gathered path;
  * `full_bins_panel` — a few hundred pairs of which some reads carry
    IUPAC codes (nt16 codes outside =ACGTN), with duplex UMIs and
    lenDiff-shifted right reads, so the full-bins vote runs.
  * `long_amplicon` — a MiSeq-style 2x300 UMI amplicon panel (seed 31,
    2 contigs, 240 amplicons of 400-560 bp, so mates overlap by 40-200
    bases; 80 molecules per amplicon with random 8+8 UMIs and 1-4 copies
    each, ~96k reads; 0-2 errors per read; each read's quality drawn
    from 2-41, so quals ship raw): reads longer than 256 bases, so every
    window stages dense and votes at L = 320.

Each writes `<out_dir>/{name}.bam` and `<out_dir>/{name}_ref.fa`.

`upload_staging` makes random inputs of the upload-and-score program
(engine._upload_score_fn) with its edges, for the tests and the on-card
check of csrc/upload_score.cu; `dense_staging` and `score_geometry` those
of the dense route's unpack and score map (csrc/upload_dense.cu).
"""

from __future__ import annotations

import os

import numpy as np

from gencore_tpu_torch.io import bam
from gencore_tpu_torch.io.bam import BamHeader, BamWriter, encode_record
from gencore_tpu_torch.utils import cigar as cig

BASES = "ACGT"
CODE = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15}


def random_ref(rng: np.random.Generator, length: int) -> str:
    return "".join(BASES[i] for i in rng.integers(0, 4, size=length))


class SyntheticBam:
    """Builds a sorted BAM + matching FASTA in memory, then writes both."""

    def __init__(self, seed: int = 0, contig_len: int = 200_000, n_contigs: int = 1):
        self.rng = np.random.default_rng(seed)
        self.contigs = [random_ref(self.rng, contig_len) for _ in range(n_contigs)]
        self.names = [f"chr{i+1}" for i in range(n_contigs)]
        self.header = BamHeader(
            text=("\n".join(
                [f"@SQ\tSN:{n}\tLN:{len(c)}" for n, c in zip(self.names, self.contigs)]
            ) + "\n").encode(),
            names=list(self.names),
            lengths=[len(c) for c in self.contigs],
        )
        self.records = []  # (tid, pos, body_builder_args)
        self._serial = 0

    def write_fasta(self, path: str):
        with open(path, "w") as f:
            for n, c in zip(self.names, self.contigs):
                f.write(f">{n}\n")
                for i in range(0, len(c), 70):
                    f.write(c[i:i + 70] + "\n")

    def _qname(self, umi: str | None) -> str:
        self._serial += 1
        base = f"SIM:1:FC:1:{self._serial:06d}:{self.rng.integers(1000,9999)}:{self.rng.integers(1000,9999)}"
        if umi:
            return f"{base}:UMI_{umi}"
        return base

    def read_seq(self, tid: int, pos: int, length: int, n_errors: int = 0,
                 softclip_left: int = 0) -> tuple[str, str]:
        """Sequence drawn from the reference with optional random errors.
        Returns (seq, cigar_str)."""
        ref = self.contigs[tid]
        core = ref[pos:pos + length - softclip_left]
        clip = "".join(BASES[i] for i in self.rng.integers(0, 4, size=softclip_left))
        seq = list(clip + core)
        for _ in range(n_errors):
            i = int(self.rng.integers(softclip_left, length))
            cur = seq[i]
            seq[i] = BASES[(BASES.index(cur) + 1 + int(self.rng.integers(0, 3))) % 4] \
                if cur in BASES else "A"
        cigar_str = (f"{softclip_left}S" if softclip_left else "") + f"{length - softclip_left}M"
        return "".join(seq), cigar_str

    def add_pair(self, tid: int, pos1: int, pos2: int, read_len: int = 100,
                 umi: str | None = None, n_errors: int = 0, qual: int = 35,
                 qual2: int | None = None, softclip_left: int = 0,
                 nm: int | None = None):
        """Add a proper FR pair; pos1 <= pos2. TLEN spans fragment."""
        qname = self._qname(umi)
        tlen = pos2 + read_len - pos1
        seq1, cg1 = self.read_seq(tid, pos1, read_len, n_errors, softclip_left)
        seq2, cg2 = self.read_seq(tid, pos2, read_len, n_errors)
        q2 = qual if qual2 is None else qual2
        nm1 = n_errors if nm is None else nm
        self._add(tid, pos1, qname, 99, cg1, tid, pos2, tlen, seq1, qual, nm1)
        self._add(tid, pos2, qname, 147, cg2, tid, pos1, -tlen, seq2, q2, nm1)

    def add_single(self, tid: int, pos: int, read_len: int = 100, umi: str | None = None,
                   flag: int = 0, mtid: int = -1, mpos: int = -1, tlen: int = 0,
                   n_errors: int = 0, qual: int = 35, nm: int | None = None,
                   cigar: str | None = None):
        qname = self._qname(umi)
        if tid >= 0:
            seq, cg = self.read_seq(tid, pos, read_len, n_errors)
        else:
            seq = "".join(BASES[i] for i in self.rng.integers(0, 4, size=read_len))
            cg = ""
        if cigar is not None:
            cg = cigar
        self._add(tid, pos, qname, flag, cg, mtid, mpos, tlen, seq, qual,
                  n_errors if nm is None else nm)

    def add_cross_pair(self, tid1: int, pos1: int, tid2: int, pos2: int,
                       read_len: int = 100, umi: str | None = None,
                       n_errors: int = 0, qual: int = 35):
        """Mates on different contigs (isize 0): the reference clusters each
        end separately with a negative surrogate right key (gencore.cpp:311)."""
        qname = self._qname(umi)
        seq1, cg1 = self.read_seq(tid1, pos1, read_len, n_errors)
        seq2, cg2 = self.read_seq(tid2, pos2, read_len, n_errors)
        self._add(tid1, pos1, qname, 97, cg1, tid2, pos2, 0, seq1, qual, n_errors)
        self._add(tid2, pos2, qname, 145, cg2, tid1, pos1, 0, seq2, qual, n_errors)

    def add_pair_mi(self, tid: int, pos1: int, pos2: int, mi: str,
                    read_len: int = 100, n_errors: int = 0, qual: int = 35):
        """Pair carrying the UMI in an MI:Z: aux tag (bamutil.cpp:23-38)."""
        qname = self._qname(None)
        tlen = pos2 + read_len - pos1
        seq1, cg1 = self.read_seq(tid, pos1, read_len, n_errors)
        seq2, cg2 = self.read_seq(tid, pos2, read_len, n_errors)
        mi_aux = b"MIZ" + mi.encode() + b"\x00"
        self._add(tid, pos1, qname, 99, cg1, tid, pos2, tlen, seq1, qual,
                  n_errors, extra_aux=mi_aux)
        self._add(tid, pos2, qname, 147, cg2, tid, pos1, -tlen, seq2, qual,
                  n_errors, extra_aux=mi_aux)

    def _add(self, tid, pos, qname, flag, cigar_str, mtid, mpos, tlen, seq,
             qual, nm, extra_aux: bytes = b""):
        codes = bam.seq_str_to_codes(seq)
        cg = cig.from_string(cigar_str) if cigar_str else np.zeros(0, dtype=np.uint32)
        if isinstance(qual, int):
            quals = np.full(len(seq), qual, dtype=np.uint8)
        else:
            quals = np.asarray(qual, dtype=np.uint8)
        aux = b"NMC" + bytes([nm & 0xFF]) + extra_aux
        body = encode_record(tid, pos, qname.encode(), flag, 60, cg, mtid, mpos,
                             tlen, codes, quals, aux)
        self.records.append((tid if tid >= 0 else 1 << 30, pos, len(self.records), body))

    def write_bam(self, path: str):
        w = BamWriter(path, self.header)
        for _, _, _, body in sorted(self.records, key=lambda r: (r[0], r[1], r[2])):
            w.write_record(body)
        w.close()


DEEP_PANEL_FRAGMENTS = 40_000
DEEP_PANEL_DUP_MEAN = 3   # mean duplicates per fragment -> ~240k reads


def deep_panel(out_dir: str, n_fragments: int = DEEP_PANEL_FRAGMENTS):
    """The deep panel (bench.make_workload's recipe); reuses the files
    when both exist. Returns (bam_path, fasta_path)."""
    os.makedirs(out_dir, exist_ok=True)
    bam_path = os.path.join(out_dir, f"deep_panel_{n_fragments}.bam")
    fa_path = os.path.join(out_dir, "deep_panel_ref.fa")
    if os.path.exists(bam_path) and os.path.exists(fa_path):
        return bam_path, fa_path
    rng = np.random.default_rng(7)
    sb = SyntheticBam(seed=7, contig_len=8_000_000, n_contigs=2)
    umis = ["AAAA", "CCCC", "GGGG", "TTTT", "ACGT", "TGCA", "GATC", "CTAG"]
    for k in range(n_fragments):
        tid = int(rng.integers(0, 2))
        pos1 = int(rng.integers(100, 7_900_000))
        frag = int(rng.integers(160, 340))
        read_len = 150
        pos2 = max(pos1, pos1 + frag - read_len)
        a, b = rng.choice(umis, size=2, replace=False)
        umi = f"{a}_{b}"
        ndup = 1 + int(rng.poisson(DEEP_PANEL_DUP_MEAN - 1))
        for _ in range(ndup):
            n_err = int(rng.random() < 0.3) * int(rng.integers(1, 3))
            sb.add_pair(tid, pos1, pos2, read_len=read_len, umi=umi,
                        n_errors=n_err, qual=int(rng.choice([18, 30, 36])))
    sb.write_bam(bam_path)
    sb.write_fasta(fa_path)
    return bam_path, fa_path


def small_panel(out_dir: str):
    """~3k reads that take every vote entry point: the fused window,
    the per-bucket gathered vote (40-pair clusters of mixed UMIs) and the
    pre-gathered vote of lenDiff-shifted right reads. Returns
    (bam_path, fasta_path, n_reads)."""
    os.makedirs(out_dir, exist_ok=True)
    bam_path = os.path.join(out_dir, "small_panel.bam")
    fa_path = os.path.join(out_dir, "small_panel_ref.fa")
    sb = SyntheticBam(seed=11, contig_len=400_000, n_contigs=2)
    rng = np.random.default_rng(12)
    umis = ["AAAA", "CCCC", "GGGG", "TTTT", "ACGT", "TGCA"]
    for k in range(560):
        tid = k % 2
        pos1 = 1000 + 600 * (k // 2)
        pos2 = pos1 + int(rng.integers(20, 160))
        a, b = rng.choice(umis, size=2, replace=False)
        deep = k % 60 == 0
        for _ in range(40 if deep else int(rng.integers(1, 4))):
            umi = f"{a}_{b}" if rng.random() < 0.5 else f"{b}_{a}"
            sb.add_pair(tid, pos1, pos2, read_len=150, umi=umi,
                        n_errors=int(rng.random() < 0.3) * 2,
                        qual=int(rng.choice([18, 30, 36])))
    for k in range(30):   # right reads of mixed length, same right end
        pos1 = 380_000 + 400 * k
        end2 = pos1 + 240
        sb.add_pair(0, pos1, end2 - 100, read_len=100, umi="ACGT_TTGA")
        qname = sb._qname("ACGT_TTGA")
        seq1, cg1 = sb.read_seq(0, pos1, 100)
        seq2, cg2 = sb.read_seq(0, end2 - 80, 80)
        sb._add(0, pos1, qname, 99, cg1, 0, end2 - 80, 240, seq1, 35, 0)
        sb._add(0, end2 - 80, qname, 147, cg2, 0, pos1, -240, seq2, 35, 0)
    sb.write_bam(bam_path)
    sb.write_fasta(fa_path)
    return bam_path, fa_path, len(sb.records)


def ultradeep_bam(n_loci: int = 40, pairs: int = 1500,
                  contig_len: int = 8_000_000) -> SyntheticBam:
    """bench.make_ultradeep_workload's recipe (seed 21): n_loci piles of
    `pairs` pairs, each pile at one position, UMIs in the read names."""
    rng = np.random.default_rng(21)
    sb = SyntheticBam(seed=21, contig_len=contig_len, n_contigs=2)
    umis = ["AAAA", "CCCC", "GGGG", "TTTT", "ACGT", "TGCA", "GATC", "CTAG"]
    for locus in range(n_loci):
        tid = locus % 2
        pos1 = 200_000 + 380_000 * (locus // 2)
        pos2 = pos1 + 160
        for _ in range(pairs):
            a, b = rng.choice(umis, size=2, replace=False)
            n_err = int(rng.random() < 0.3) * int(rng.integers(1, 3))
            sb.add_pair(tid, pos1, pos2, read_len=150, umi=f"{a}_{b}",
                        n_errors=n_err, qual=int(rng.choice([18, 30, 36])))
    return sb


def ultradeep(out_dir: str):
    """The ultra-deep pile at full size; reuses the files when both
    exist. Returns (bam_path, fasta_path)."""
    os.makedirs(out_dir, exist_ok=True)
    bam_path = os.path.join(out_dir, "ultradeep.bam")
    fa_path = os.path.join(out_dir, "ultradeep_ref.fa")
    if not (os.path.exists(bam_path) and os.path.exists(fa_path)):
        sb = ultradeep_bam()
        sb.write_bam(bam_path)
        sb.write_fasta(fa_path)
    return bam_path, fa_path


IUPAC = "MRWSYKVHDB"   # the nt16 codes outside =ACGTN: 3, 5-7, 9-14


def _with_iupac(rng, seq: str, n: int) -> str:
    s = list(seq)
    for i in rng.integers(0, len(s), size=n):
        s[int(i)] = IUPAC[int(rng.integers(0, len(IUPAC)))]
    return "".join(s)


def full_bins_bam(seed: int, n_loci: int, umi_mode: str = "duplex",
                  shifted: bool = True) -> SyntheticBam:
    """Clusters of 1-5 pairs at n_loci loci, about a third of the reads
    carrying 1-3 IUPAC codes; umi_mode "none", "single" or "duplex"
    (both strand orders of one UMI pair). With `shifted`, n_loci/4 extra
    loci hold a 100 and an 80 base right read with the same right end
    (lenDiff-shifted members, group.cpp:339-349)."""
    sb = SyntheticBam(seed=seed, contig_len=60_000 + 800 * n_loci)
    rng = np.random.default_rng(seed + 1)
    umis = ["AAAA", "CCCC", "GGGG", "TTTT", "ACGT", "TGCA"]
    for k in range(n_loci):
        pos1 = 1000 + 500 * k
        pos2 = pos1 + int(rng.integers(20, 150))
        a, b = rng.choice(umis, size=2, replace=False)
        for _ in range(int(rng.integers(1, 6))):
            umi = {"none": None, "single": f"{a}_{b}",
                   "duplex": f"{a}_{b}" if rng.random() < 0.5
                   else f"{b}_{a}"}[umi_mode]
            qname = sb._qname(umi)
            n_err = int(rng.random() < 0.3) * 2
            seq1, cg1 = sb.read_seq(0, pos1, 100, n_errors=n_err)
            seq2, cg2 = sb.read_seq(0, pos2, 100)
            if rng.random() < 0.35:
                seq1 = _with_iupac(rng, seq1, int(rng.integers(1, 4)))
            if rng.random() < 0.35:
                seq2 = _with_iupac(rng, seq2, int(rng.integers(1, 4)))
            q = int(rng.choice([18, 30, 36]))
            tlen = pos2 + 100 - pos1
            sb._add(0, pos1, qname, 99, cg1, 0, pos2, tlen, seq1, q, n_err)
            sb._add(0, pos2, qname, 147, cg2, 0, pos1, -tlen, seq2, q, 0)
    if shifted:
        umi = None if umi_mode == "none" else "ACGT_TTGA"
        for k in range(max(n_loci // 4, 1)):
            pos1 = 2000 + 500 * n_loci + 400 * k
            end2 = pos1 + 240
            for rl in (100, 80):
                qname = sb._qname(umi)
                seq1, cg1 = sb.read_seq(0, pos1, 100)
                seq2, cg2 = sb.read_seq(0, end2 - rl, rl)
                seq2 = _with_iupac(rng, seq2, 1)
                sb._add(0, pos1, qname, 99, cg1, 0, end2 - rl, 240, seq1,
                        35, 0)
                sb._add(0, end2 - rl, qname, 147, cg2, 0, pos1, -240, seq2,
                        35, 0)
    return sb


def full_bins_panel(out_dir: str):
    """~700 reads of full-bins data (full_bins_bam, seed 31, 100 loci,
    duplex UMIs, shifted right reads). Returns (bam_path, fasta_path)."""
    os.makedirs(out_dir, exist_ok=True)
    bam_path = os.path.join(out_dir, "full_bins_panel.bam")
    fa_path = os.path.join(out_dir, "full_bins_panel_ref.fa")
    sb = full_bins_bam(31, 100)
    sb.write_bam(bam_path)
    sb.write_fasta(fa_path)
    return bam_path, fa_path


LONG_READ_LEN = 300


def long_amplicon_bam(n_amplicons: int = 240, molecules: int = 80,
                      contig_len: int = 1_200_000,
                      seed: int = 31) -> SyntheticBam:
    """The long_amplicon recipe: n_amplicons amplicons spread over 2
    contigs, each read pair spanning a 400-560 bp amplicon with 300-base
    reads, `molecules` UMI molecules per amplicon (8+8 random bases) of
    1-4 copies each; 0-2 errors per read and a quality per read from
    2-41."""
    rng = np.random.default_rng(seed)
    sb = SyntheticBam(seed=seed, contig_len=contig_len, n_contigs=2)
    per_contig = -(-n_amplicons // 2)
    step = (contig_len - 2000) // per_contig
    rl = LONG_READ_LEN
    for a in range(n_amplicons):
        pos1 = 1000 + step * (a // 2)
        pos2 = pos1 + int(rng.integers(400, 561)) - rl
        for _ in range(molecules):
            umi = "_".join("".join(BASES[i] for i in rng.integers(0, 4, 8))
                           for _ in range(2))
            for _ in range(int(rng.integers(1, 5))):
                sb.add_pair(a % 2, pos1, pos2, read_len=rl, umi=umi,
                            n_errors=int(rng.integers(0, 3)),
                            qual=int(rng.integers(2, 42)),
                            qual2=int(rng.integers(2, 42)))
    return sb


def long_amplicon(out_dir: str):
    """The long_amplicon panel at full size; reuses the files when both
    exist. Returns (bam_path, fasta_path)."""
    os.makedirs(out_dir, exist_ok=True)
    bam_path = os.path.join(out_dir, "long_amplicon.bam")
    fa_path = os.path.join(out_dir, "long_amplicon_ref.fa")
    if not (os.path.exists(bam_path) and os.path.exists(fa_path)):
        sb = long_amplicon_bam()
        sb.write_bam(bam_path)
        sb.write_fasta(fa_path)
    return bam_path, fa_path


def upload_staging(rng: np.random.Generator, n: int, w: int, L: int, *,
                   pair_edges: bool = False, **flags):
    """Random sparse upload staging of n rows of width w (L the padded
    width) in the layout the engine ships, with the program's edges:
    a non-zero reserved row 0 (2-bit mode must zero it), genome slots past
    the genome's end (they clamp), rows without edits, a row of 14 edits
    (more than the 12 applied), repeated edit positions in a row (the
    later edit wins), edit positions >= w (they match nothing), rows of
    length 0, mate pairs whose overlap wraps past L (mate_start + cmp_len
    > L) and unscored rows; mate pairs lie anywhere in the window, so most
    span the kernel's blocks. flags: kernels.UPLOAD_FLAGS, each False
    unless given; mate32 ships u32 mate rows (else u16, which needs n <=
    65,536). pair_edges (with mates): also scored rows whose mate is
    themselves, whose mate is scored but names another row, whose mate
    names them back unscored, and whose mate lies past the rows (it
    clamps).
    Returns the 16 arguments of _upload_score_fn's function in order (sd,
    src, scnt, epos, ecode, base, q_src, qd, qcnt, qpos, qval, lens16,
    mate, meta, genome, gsl), the genome as a host array."""
    from gencore_tpu_torch.core.kernels import UPLOAD_FLAGS
    from gencore_tpu_torch.engine import _pack_score_meta
    f = {k: bool(flags.pop(k, False)) for k in UPLOAD_FLAGS}
    if flags:
        raise TypeError(f"upload_staging: unknown flags {sorted(flags)}")
    mdt = np.uint32 if f["mate32"] else np.uint16
    if n > (1 << 16) and not f["mate32"]:
        raise ValueError(f"upload_staging: {n} rows need mate32")
    codes = np.array([1, 2, 4, 8], dtype=np.uint8)
    # src is u16: the dense and genome rows stay below 65,536 together
    nd = max(2, min(n // 3, 40_000))
    if f["mode2"]:
        sd = rng.integers(0, 256, size=(nd, -(-w // 4))).astype(np.uint8)
    else:
        nib = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
        bw = -(-w // 2)
        sd = ((nib[rng.integers(0, 5, size=(nd, bw))] << 4)
              | nib[rng.integers(0, 5, size=(nd, bw))]).astype(np.uint8)
    genome = np.pad(codes[rng.integers(0, 4, size=3000)], (0, 4096))
    if f["has_genome"]:
        ns = max(2, min(n // 20, 20_000))
        gsl = rng.integers(0, 3000, size=ns).astype(np.int32)
        gsl[0] = len(genome) - w // 2      # past the end: clamps
        gsl[1] = 0
    else:
        ns = 0
        gsl = np.zeros(1, dtype=np.int32)
    src = rng.integers(0, nd + ns, size=n).astype(np.uint16)
    src[::7] = 0
    z1 = np.zeros(1, dtype=np.uint8)

    def edits(vals):
        cnt = rng.integers(0, 13, size=n).astype(np.uint8)
        cnt[rng.random(n) < 0.3] = 0
        cnt[n // 2] = 14
        tot = int(cnt.sum())
        pos = rng.integers(0, w, size=tot).astype(np.int64)
        far = (rng.random(tot) < 0.1) & (w < 256)
        pos[far] = rng.integers(min(w, 255), 256, size=int(far.sum()))
        off = np.cumsum(cnt.astype(np.int64)) - cnt
        twice = np.flatnonzero((cnt >= 2) & (rng.random(n) < 0.4))
        pos[off[twice] + 1] = pos[off[twice]]
        return cnt, pos.astype(np.uint8), vals[rng.integers(0, len(vals),
                                                             size=tot)]

    if f["has_sedit"]:
        scnt, epos, ecode = edits(np.array([1, 2, 4, 8, 15], np.uint8))
    else:
        scnt = epos = ecode = z1
    qvals = np.array([2, 12, 20, 25, 30, 37, 41], dtype=np.uint8)
    base = qvals[rng.integers(0, len(qvals), size=n)]
    if f["has_qdense"]:
        nq = max(1, n // 10)
        q_src = np.zeros(n, dtype=np.uint16)
        q_src[rng.choice(n, size=nq, replace=False)] = np.arange(1, nq + 1)
        qd = rng.integers(2, 42, size=(nq + 1, w)).astype(np.uint8)
    else:
        q_src = np.zeros(1, dtype=np.uint16)
        qd = np.zeros((1, 1), dtype=np.uint8)
    if f["has_qedit"]:
        qcnt, qpos, qval = edits(np.arange(2, 42, dtype=np.uint8))
    else:
        qcnt = qpos = qval = z1
    if f["const_lens"]:
        lens16 = np.array([w - 3, n - 2], dtype=np.int32)
    else:
        lens16 = rng.integers(0, w + 1, size=n).astype(np.uint16)
        lens16[::5] = w
        lens16[3::11] = 0
    if f["no_overlap"]:
        mate = np.zeros(1, dtype=mdt)
        meta = np.packbits(rng.random(n) < 0.6, bitorder="little")
    else:
        rows = rng.permutation(n)[:(n // 2) * 2 - 2].reshape(-1, 2)
        ls = rng.integers(0, L, size=len(rows))
        rs = rng.integers(0, L, size=len(rows))
        cl = rng.integers(-3, L + 1, size=len(rows))
        mate, meta = _pack_score_meta(n, rows[:, 0], rows[:, 1], ls, rs, cl)
        mate = mate.astype(mdt)
        if pair_edges and n >= 8:
            k = max(1, n // 40)
            a, b, c, d = rng.choice(n, size=(4, k), replace=False)
            on = np.uint32(1 << 26)
            meta[a] |= on             # scored, the mate itself
            mate[a] = a
            meta[b] |= on             # scored, a mate naming another row
            mate[b] = c
            meta[c] |= on             # scored, its mate names it back
            mate[c] = d               # but is unscored
            meta[d] &= ~on
            mate[d] = c
            mate[a[0]] = min(n + 3, np.iinfo(mdt).max)   # past the rows
    return (sd, src, scnt, epos, ecode, base, q_src, qd, qcnt, qpos, qval,
            lens16, mate, meta, genome, gsl)


def dense_staging(rng: np.random.Generator, n: int, w: int, seq_mode: str,
                  qual_mode: str):
    """Random dense upload staging (engine._upload_unpack_fn's inputs) as
    _WorkArrays ships it: n rows of w bases 2-bit or 4-bit packed, quals
    as 2-bit or 4-bit indices or raw [n, w] bytes, int32 lengths with 0,
    odd values, w and past w among them, and a qual table whose entry 0
    (never decoded) is not 0. Returns (seq_up, qual_up, lens, qtable)."""
    pw = (w + 1) // 2
    ow = (pw + 1) // 2
    seq_up = rng.integers(0, 256, size=(n, ow if seq_mode == "2bit" else pw),
                          dtype=np.uint8)
    qw = {"2bit": ow, "4bit": pw, "raw": w}[qual_mode]
    qual_up = rng.integers(0, 42 if qual_mode == "raw" else 256,
                           size=(n, qw), dtype=np.uint8)
    lens = rng.integers(0, w + 1, size=n).astype(np.int32)
    lens[::7] = w
    lens[1::11] = 0
    lens[2::13] |= 1
    lens[3::97] = w + 5
    qtable = np.zeros(16, dtype=np.uint8)
    qtable[1:] = rng.integers(2, 42, size=15)
    qtable[0] = 77
    return seq_up, qual_up, lens, qtable


def score_geometry(rng: np.random.Generator, N: int, L: int, packed: bool):
    """Random inputs of the overlap score map as the dense route gives
    them: seq and qual [N, L] (=ACGTN codes, quals of seven values so that
    ties are common, zero at and beyond each length), mate pairs whose
    geometry does not mirror and some that do, self mates, mate rows past
    the matrix (clamped), unscored rows, mate starts on both sides of the
    row's own, and the edges of a kernel that takes a mate pair once
    (_pair_edges): pairs with one row unscored, mates that name a third
    row, pairs across each 16th and 128th row. Packed: (seq, qual,
    lengths, mate rows, meta) with meta's u32 bits as int32
    (kernels.score_map_kernel_packed); else (seq, qual, mate_row,
    my_start, mate_start, cmp_len (some negative), my_len, is_left,
    scored), int32 and u8 flags (kernels.score_map_kernel)."""
    codes = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
    seq = codes[rng.integers(0, 5, size=(N, L))]
    qual = rng.choice(np.array([2, 12, 18, 25, 30, 36, 41], np.uint8),
                      size=(N, L))
    my_len = rng.integers(0, L + 1, size=N).astype(np.int32)
    my_len[::5] = L
    beyond = np.arange(L)[None, :] >= my_len[:, None]
    seq[beyond] = 0
    qual[beyond] = 0
    perm = rng.permutation(N)
    a, b = perm[:N // 5 * 4].reshape(2, -1)
    mate = np.arange(N, dtype=np.int64)
    mate[a] = b
    mate[b] = a
    mate[perm[-(N // 50 + 1):]] = N + 7
    lim = min(L, 256)
    ms = rng.integers(0, lim, size=N)
    ts = rng.integers(0, lim, size=N)
    is_left = rng.random(N) < 0.5
    scored = rng.random(N) < 0.9
    if packed:
        cl = rng.integers(0, 512, size=N)
    else:
        mate[perm[:N // 100 + 1]] = -3
        cl = rng.integers(-8, L, size=N)
    _pair_edges(N, perm, a, b, mate, ms, ts, cl, is_left, scored)
    if packed:
        meta = (ms | ts << 8 | cl << 16 | is_left.astype(np.int64) << 25
                | scored.astype(np.int64) << 26)
        return (seq, qual, my_len, mate.astype(np.int32),
                meta.astype(np.int32))
    i32 = np.int32
    return (seq, qual, mate.astype(i32), ms.astype(i32), ts.astype(i32),
            cl.astype(i32), my_len, is_left.astype(np.uint8),
            scored.astype(np.uint8))


def _pair_edges(N, perm, a, b, mate, ms, ts, cl, is_left, scored):
    """score_geometry's mate-pair edges, in place and without drawing:
    every 5th pair (a, b) mirrored as the engine pairs mates (each row's
    mate start the other's start, one cmp_len, the left flag on a), every
    7th with one row unscored, rows past the pairs naming a paired row
    (a mate that names a third row), and rows (k - 1, k) paired across
    each 16th and 128th row (a warp takes 4-16 rows of the score kernel,
    a block 8 warps; their former mates are left naming a third row)."""
    m = a[1::5], b[1::5]
    ms[m[1]], ts[m[1]] = ts[m[0]], ms[m[0]]
    cl[m[1]] = cl[m[0]]
    is_left[m[0]], is_left[m[1]] = True, False
    scored[a[::7]], scored[b[::7]] = False, True
    third = perm[len(a) * 2:len(a) * 2 + N // 40]
    mate[third] = a[:len(third)]
    scored[third] = True
    for step, count in ((16, 40), (128, 40)):
        for k in range(step, min(N, step * (count + 1)), step):
            mate[k - 1], mate[k] = k, k - 1
