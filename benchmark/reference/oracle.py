"""Scalar oracle: a faithful, slow re-implementation of the reference
consensus pipeline, used as the golden model for the vectorized/TPU engine.

Every routine documents the reference source it models (file:line under
the reference gencore's src/). This is an independent implementation from the
published behavior — the TPU engine is validated against it, and it is
validated against the reference's own unit-test vectors and documented
semantics.

Scope: Pair overlap scoring (pair.cpp:70-172), UMI clustering
(cluster.cpp:55-188), template election + consensus voting
(group.cpp:68-579), duplex merging (cluster.cpp:190-258), the streaming
cluster/flush engine (gencore.cpp:162-477) and stats wiring.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from reference import bam as bamio
from reference.options import Options
from reference.stats import Stats
from reference import cigar as cig
from reference.grouping import greedy_umi_groups
from reference.postmerge import postprocess_cluster
from reference.umi import get_umi_from_qname

N4BITS = 15  # BamUtil::base2fourbits('N')

# FastaReader 4-bit code is different from BAM's; we work in ASCII chars for
# ref bases (fastareader.cpp:106-128) and BAM nt16 codes for read bases.
_CHAR_TO_NT16 = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15}
_ASCII_TO_NT16 = np.zeros(256, dtype=np.int64)
for _c, _v in _CHAR_TO_NT16.items():
    if _c != "N":
        _ASCII_TO_NT16[ord(_c)] = _v


@functools.lru_cache(maxsize=8)
def _q2s_table(high, moderate, low, s_high, s_moderate, s_low, s_bad) -> np.ndarray:
    """OPair.qual2score as a table over 0..511 (a sum of two qualities
    halved, or a difference, stays below 256)."""
    q = np.arange(512)
    t = np.select([q >= high, q >= moderate, q >= low], [s_high, s_moderate, s_low], s_bad)
    t.setflags(write=False)
    return t


def _lex_last_max(score: np.ndarray, qual: np.ndarray) -> np.ndarray:
    """Per column, the row a scan over rows 0..15 ends on when it takes a
    row whose (score, qual) is at least the current one's: the largest
    row among those of the greatest score, then the greatest qual."""
    cand = score == score.max(0)
    best_q = np.where(cand, qual, -1).max(0)
    cand &= qual == best_q
    return cand.shape[0] - 1 - np.argmax(cand[::-1], axis=0)


@dataclass
class ORead:
    """Mutable working copy of one BAM record (the oracle's bam1_t)."""
    tid: int
    pos: int
    mtid: int
    mpos: int
    isize: int
    flag: int
    mapq: int
    bin: int
    qname: bytes
    cigar: np.ndarray          # packed uint32
    seq: np.ndarray            # nt16 codes uint8[l_qseq] (mutable)
    qual: np.ndarray           # uint8[l_qseq] (mutable)
    aux: bytes                 # original aux blob
    nm_val: int = 0
    nm_typ: str = ""
    mi_tag: str | None = None
    serial: int = 0            # stable stream order (replaces bam1_t pointer)
    # pending output edits
    nm_new: int | None = None
    fr_tag: int | None = None
    rr_tag: int | None = None

    @property
    def l_qseq(self) -> int:
        return len(self.seq)

    @property
    def n_cigar(self) -> int:
        return len(self.cigar)

    def padded_l_qname(self) -> int:
        """htslib in-memory l_qname incl. NUL padding (see bam.padded_qname_len)."""
        return bamio.padded_qname_len(len(self.qname))

    def right_ref_pos(self) -> int:
        return cig.right_ref_pos(self.pos, self.cigar)

    def encode(self, bin_: int = 0) -> bytes:
        aux = bytearray(self.aux)
        if self.nm_new is not None and self.nm_typ == "C":
            # NM is 1-byte 'C' typed; patch in place (group.cpp:567-572)
            i = _find_aux_offset(bytes(aux), b"NM")
            if i is not None:
                aux[i] = self.nm_new & 0xFF
        if self.fr_tag is not None:
            aux += b"FRC" + bytes([self.fr_tag & 0xFF])
        if self.rr_tag is not None:
            aux += b"RRC" + bytes([self.rr_tag & 0xFF])
        return bamio.encode_record(
            self.tid, self.pos, self.qname, self.flag, self.mapq, self.cigar,
            self.mtid, self.mpos, self.isize, self.seq, self.qual, bytes(aux),
            bin_=self.bin)


def _find_aux_offset(aux: bytes, tag: bytes):
    """Value offset of `tag` within an aux blob (htslib bam_aux_get walk)."""
    arr = np.frombuffer(aux, dtype=np.uint8)
    a = 0
    end = len(aux)
    while a + 3 <= end:
        t = aux[a:a + 2]
        typ = chr(aux[a + 2])
        val = a + 3
        if t == tag:
            return val
        a = val + bamio._aux_value_size(arr, val, typ)
    return None


def oread_from_batch(batch: bamio.RecordBatch, i: int, serial: int | None = None) -> ORead:
    nm_off, nm_typ = batch.find_tag(i, b"NM")
    return ORead(
        tid=int(batch.tid[i]), pos=int(batch.pos[i]), mtid=int(batch.mtid[i]),
        mpos=int(batch.mpos[i]), isize=int(batch.isize[i]), flag=int(batch.flag[i]),
        mapq=int(batch.mapq[i]), bin=int(batch.bin[i]), qname=batch.qname(i),
        cigar=batch.cigar(i).copy(), seq=batch.seq_codes(i).copy(),
        qual=batch.qual(i).copy(), aux=batch.aux(i).tobytes(),
        nm_val=batch.get_int_tag(i, b"NM", 0) if nm_off is not None else 0,
        nm_typ=nm_typ or "",
        mi_tag=batch.get_str_tag(i, b"MI"),
        serial=i if serial is None else serial,
    )


def get_umi(read: ORead, prefix: str) -> str:
    """reference bamutil.cpp:23-38: MI tag wins over qname."""
    if read.mi_tag is not None:
        return get_umi_from_qname(read.mi_tag, prefix)
    return get_umi_from_qname(read.qname.decode("latin-1"), prefix)


class OPair:
    """reference src/pair.{h,cpp}."""

    def __init__(self, opt: Options):
        self.opt = opt
        self.left: ORead | None = None
        self.right: ORead | None = None
        self.left_score: np.ndarray | None = None
        self.right_score: np.ndarray | None = None
        self.merge_reads = 1
        self.reverse_merge_reads = 0
        self.merge_left_diff = 0
        self.merge_right_diff = 0
        self.is_duplex = False
        self.umi = ""

    def set_left(self, r: ORead):
        self.left = r
        self.umi = get_umi(r, self.opt.umi_prefix)

    def set_right(self, r: ORead):
        self.right = r
        umi = get_umi(r, self.opt.umi_prefix)
        if self.umi and umi != self.umi:
            raise ValueError(
                f"The UMI of a read pair should be identical, but we got {self.umi} and {umi}")
        if not self.umi:
            self.umi = umi

    def qname(self) -> bytes:
        if self.left is not None:
            return self.left.qname
        if self.right is not None:
            return self.right.qname
        return b""

    def pair_found(self) -> bool:
        return self.left is not None and self.right is not None

    # --- overlap scoring (reference pair.cpp:70-172) ---
    def qual2score(self, q: int) -> int:
        o = self.opt
        if o.high_quality <= q:
            return o.score_not_overlapped_high_qual
        if o.moderate_quality <= q:
            return o.score_not_overlapped_moderate_qual
        if o.low_quality <= q:
            return o.score_not_overlapped_low_qual
        return o.score_not_overlapped_bad_qual

    def _q2s(self, q: np.ndarray) -> np.ndarray:
        """qual2score of every element of q (q >= 0)."""
        o = self.opt
        return _q2s_table(o.high_quality, o.moderate_quality, o.low_quality,
                          o.score_not_overlapped_high_qual,
                          o.score_not_overlapped_moderate_qual,
                          o.score_not_overlapped_low_qual,
                          o.score_not_overlapped_bad_qual)[q]

    def compute_score(self):
        """compute_score_scalar over whole arrays: the same scores and the
        same quality edits in the overlap."""
        o = self.opt
        if self.left is not None and self.left_score is None:
            self.left_score = np.full(self.left.l_qseq,
                                      o.score_not_overlapped_moderate_qual, dtype=np.int32)
        if self.right is not None and self.right_score is None:
            self.right_score = np.full(self.right.l_qseq,
                                       o.score_not_overlapped_moderate_qual, dtype=np.int32)
        if self.left_score is None or self.right_score is None:
            return
        lmoff, lmlen = cig.first_m_offset_len(self.left.cigar)
        rmoff, rmlen = cig.first_m_offset_len(self.right.cigar)
        if lmlen <= 0 or rmlen <= 0:
            return
        pos_dis = self.right.pos - self.left.pos
        if pos_dis >= 0:
            left_start = lmoff + pos_dis
            right_start = rmoff
            cmp_len = min(lmlen - pos_dis, rmlen)
        else:
            left_start = lmoff
            right_start = rmoff - pos_dis
            cmp_len = min(lmlen, rmlen + pos_dis)
        lseq, rseq = self.left.seq, self.right.seq
        lqual, rqual = self.left.qual, self.right.qual
        for arr, qual, start, ln in ((self.left_score, lqual, left_start, self.left.l_qseq),
                                     (self.right_score, rqual, right_start, self.right.l_qseq)):
            head = min(ln, start)
            if head > 0:
                arr[:head] = self._q2s(qual[:head].astype(np.int64))
            tail = max(0, start + cmp_len)
            if tail < ln:
                arr[tail:] = self._q2s(qual[tail:].astype(np.int64))
        if cmp_len <= 0:
            return
        li = slice(left_start, left_start + cmp_len)
        ri = slice(right_start, right_start + cmp_len)
        lq = lqual[li].astype(np.int64)
        rq = rqual[ri].astype(np.int64)
        same = lseq[li] == rseq[ri]
        both = self._q2s((lq + rq) // 2) + 4
        lwin = lq >= rq
        self.left_score[li] = np.where(same, both, np.where(lwin, self._q2s(lq - rq) - 3, 0))
        self.right_score[ri] = np.where(same, both, np.where(lwin, 0, self._q2s(rq - lq) - 3))
        lqual[li] = np.where(same, lq, np.maximum(0, lq - rq))
        rqual[ri] = np.where(same, rq, np.maximum(0, rq - lq))

    def compute_score_scalar(self):
        """The scalar form, kept as the check of compute_score."""
        o = self.opt
        if self.left is not None and self.left_score is None:
            self.left_score = np.full(self.left.l_qseq,
                                      o.score_not_overlapped_moderate_qual, dtype=np.int32)
        if self.right is not None and self.right_score is None:
            self.right_score = np.full(self.right.l_qseq,
                                       o.score_not_overlapped_moderate_qual, dtype=np.int32)
        if self.left_score is None or self.right_score is None:
            return
        lmoff, lmlen = cig.first_m_offset_len(self.left.cigar)
        rmoff, rmlen = cig.first_m_offset_len(self.right.cigar)
        if lmlen <= 0 or rmlen <= 0:
            return
        pos_dis = self.right.pos - self.left.pos
        if pos_dis >= 0:
            left_start = lmoff + pos_dis
            right_start = rmoff
            cmp_len = min(lmlen - pos_dis, rmlen)
        else:
            left_start = lmoff
            right_start = rmoff - pos_dis
            cmp_len = min(lmlen, rmlen + pos_dis)
        lseq, rseq = self.left.seq, self.right.seq
        lqual, rqual = self.left.qual, self.right.qual
        # non-overlap regions (pair.cpp:124-131)
        for arr, qual, start, ln in ((self.left_score, lqual, left_start, self.left.l_qseq),
                                     (self.right_score, rqual, right_start, self.right.l_qseq)):
            for i in range(0, min(ln, start)):
                arr[i] = self.qual2score(int(qual[i]))
            for i in range(max(0, start + cmp_len), ln):
                arr[i] = self.qual2score(int(qual[i]))
        # overlap region (pair.cpp:132-169)
        for i in range(cmp_len):
            l = left_start + i
            r = right_start + i
            lq = int(lqual[l])
            rq = int(rqual[r])
            if lseq[l] == rseq[r]:
                q = (lq + rq) // 2
                s = self.qual2score(q) + 4
                self.left_score[l] = s
                self.right_score[r] = s
            else:
                lqual[l] = max(0, lq - rq)
                rqual[r] = max(0, rq - lq)
                if lq >= rq:
                    self.left_score[l] = self.qual2score(lq - rq) - 3
                    self.right_score[r] = 0
                else:
                    self.left_score[l] = 0
                    self.right_score[r] = self.qual2score(rq - lq) - 3

    def get_left_score(self):
        if self.left_score is None:
            self.compute_score()
        return self.left_score

    def get_right_score(self):
        if self.right_score is None:
            self.compute_score()
        return self.right_score

    def write_sscs_dcs_tag(self):
        """reference pair.cpp:43-68 incl. the 1-byte 'C' truncation quirk."""
        val = min(self.merge_reads, 65535) & 0xFF
        for b in (self.left, self.right):
            if b is not None:
                b.fr_tag = val
                if self.is_duplex:
                    b.rr_tag = min(self.reverse_merge_reads, 65535) & 0xFF


class RefLookup:
    """Reference genome arbitration source (reference.cpp:33-71 semantics)."""

    def __init__(self, fasta, target_names):
        self.fasta = fasta  # FastaRef or None
        self.target_names = target_names

    def get_contig(self, tid: int, pos: int, length: int):
        """Returns the whole-contig uint8 ASCII array, or None per the
        reference's guards (contig missing, or pos+len >= contig size),
        emitting the reference's one-shot stderr warnings
        (reference.cpp:51-65) on each failed guard."""
        if self.fasta is None or tid < 0 or tid >= len(self.target_names):
            return None
        name = self.target_names[tid]
        contig = self.fasta.get_contig(name)
        len_ok = contig is not None and pos + length < len(contig)
        if not self.fasta.guard(name, len_ok):
            return None
        return contig if len_ok else None


class OGroup:
    """reference src/group.{h,cpp}: one UMI group -> one consensus pair."""

    def __init__(self, opt: Options, ref: RefLookup):
        self.opt = opt
        self.ref = ref
        self.pairs: dict = {}  # qname bytes -> OPair, kept sorted on iteration

    def add_pair(self, p: OPair):
        self.pairs[p.qname()] = p

    def sorted_pairs(self) -> list:
        return [self.pairs[k] for k in sorted(self.pairs)]

    def consensus_merge(self, cross_contig: bool) -> OPair:
        """reference group.cpp:68-134."""
        opt = self.opt
        if len(self.pairs) == 1:
            only = next(iter(self.pairs.values()))
            if only.right is None:
                self.pairs.clear()
                return only

        name_to_copy: ORead | None = None
        if cross_contig:
            cur_len = 0
            for p in self.sorted_pairs():
                if p.left is None:
                    continue
                if name_to_copy is None:
                    name_to_copy = p.left
                    cur_len = p.left.padded_l_qname()
                    continue
                pl = p.left.padded_l_qname()
                if pl < cur_len or (pl == cur_len and p.left.qname < name_to_copy.qname):
                    name_to_copy = p.left
                    cur_len = pl

        left, left_diff = self.consensus_merge_bam(True)
        right, right_diff = self.consensus_merge_bam(False)

        p = OPair(opt)
        p.merge_reads = len(self.pairs)
        if cross_contig:
            if left is not None and name_to_copy is not None and name_to_copy is not left:
                left.qname = name_to_copy.qname
        elif left is not None and right is not None:
            # compare the htslib PADDED lengths (getQName returns l_qname incl.
            # NUL padding, group.cpp:115-122)
            if left.padded_l_qname() <= right.padded_l_qname():
                right.qname = left.qname
            else:
                left.qname = right.qname
        if left is not None:
            p.set_left(left)
            p.merge_left_diff = left_diff
        if right is not None:
            p.set_right(right)
            p.merge_right_diff = right_diff
        return p

    def consensus_merge_bam(self, is_left: bool):
        """reference group.cpp:136-318. Returns (ORead|None, diff)."""
        opt = self.opt
        all_pairs = self.sorted_pairs()
        npairs = len(all_pairs)

        # low-complexity skip (group.cpp:142-175)
        if npairs > opt.skip_low_complexity_cluster_threshold:
            cigars = set()
            first_read = None
            for p in all_pairs:
                b = p.left if is_left else p.right
                if b is not None:
                    cigars.add(cig.to_string(b.cigar))
                    if first_read is None:
                        first_read = b
            if len(cigars) > npairs * 0.1 and first_read is not None:
                seq = first_read.seq
                diff_neighbor = int((seq[:-1] != seq[1:]).sum())
                if diff_neighbor < len(seq) * 0.5:
                    return None, 0

        left_read_mode = is_left
        if not is_left:
            # if all right reads share one pos, treat as left-aligned
            # (group.cpp:177-194)
            left_aligned = True
            last_pos = -1
            for p in all_pairs:
                if p.right is not None:
                    if last_pos >= 0 and p.right.pos != last_pos:
                        left_aligned = False
                        break
                    last_pos = p.right.pos
            if left_aligned:
                left_read_mode = True

        # template election (group.cpp:196-233)
        contained_by = [0] * npairs
        for i in range(npairs):
            part = all_pairs[i].left if is_left else all_pairs[i].right
            if part is None:
                continue
            cby = 1
            for j in range(npairs):
                if i == j:
                    continue
                whole = all_pairs[j].left if is_left else all_pairs[j].right
                if whole is None:
                    continue
                if not is_left:
                    if part.right_ref_pos() != whole.right_ref_pos():
                        continue
                if cig.is_part_of(part.cigar, whole.cigar, left_read_mode):
                    cby += 1
            contained_by[i] = cby
            if npairs > opt.skip_low_complexity_cluster_threshold and cby >= npairs // 2:
                break

        most_id = -1
        most_num = -1
        for i in range(npairs):
            if contained_by[i] > most_num:
                most_num = contained_by[i]
                most_id = i
            elif contained_by[i] == most_num and most_id >= 0:
                # tie: shorter read wins (group.cpp:241-260)
                this_len = 0
                cur_len = 0
                bi = all_pairs[i].left if is_left else all_pairs[i].right
                bc = all_pairs[most_id].left if is_left else all_pairs[most_id].right
                if bi is not None:
                    this_len = bi.l_qseq
                if bc is not None:
                    cur_len = bc.l_qseq
                if this_len < cur_len:
                    most_num = contained_by[i]
                    most_id = i

        # no majority (group.cpp:264-266)
        if most_num < npairs * 0.4 and npairs != 1:
            return None, 0

        if is_left:
            out = all_pairs[most_id].left
            out_score = all_pairs[most_id].get_left_score()
            all_pairs[most_id].left = None
        else:
            out = all_pairs[most_id].right
            out_score = all_pairs[most_id].get_right_score()
            all_pairs[most_id].right = None
        if out is None:
            return None, 0

        reads = [out]
        scores = [out_score]
        for j in range(npairs):
            if j == most_id:
                continue
            read = all_pairs[j].left if is_left else all_pairs[j].right
            score = all_pairs[j].get_left_score() if is_left else all_pairs[j].get_right_score()
            if read is None or score is None:
                continue
            if cig.is_part_of(out.cigar, read.cigar, left_read_mode):
                reads.append(read)
                scores.append(score)

        diff = self.make_consensus(reads, out, scores, left_read_mode)
        return out, diff

    def make_consensus(self, reads, out: ORead, scores, is_left: bool) -> int:
        """make_consensus_scalar over whole arrays (every position at once):
        the same bases, qualities, NM and rollback."""
        opt = self.opt
        seq_bak = out.seq.copy()
        qual_bak = out.qual.copy()
        len_diff = []
        for r in reads:
            d = r.l_qseq - out.l_qseq
            if d != 0:
                if r.pos == out.pos and cig.is_part_of(out.cigar, r.cigar, True):
                    d = 0
            len_diff.append(d)
        length = out.l_qseq
        if out.n_cigar == 0:
            for r in reads:
                if r.l_qseq < length:
                    length = r.l_qseq
        refdata = None
        if out.isize != 0:
            reflen = cig.ref_offset(out.cigar, length - 1) + 1
            refdata = self.ref.get_contig(out.tid, out.pos, reflen)
        ref_offsets = cig.ref_offsets_vector(out.cigar, length) if out.n_cigar else None

        # every member's base, quality and score at each position, read
        # where the scalar loop reads them (a negative index wraps, as in
        # Python; one past the end raises)
        R = len(reads)
        ar = np.arange(length)
        S = np.empty((R, length), dtype=np.int64)
        Q = np.empty((R, length), dtype=np.int64)
        C = np.empty((R, length), dtype=np.int64)
        for r_i, r in enumerate(reads):
            idx = ar if is_left else ar + len_diff[r_i]
            n = len(r.seq)
            idx = np.where(idx < 0, idx + n, idx)
            if length and (idx.min() < 0 or idx.max() >= n):
                raise IndexError("consensus member shorter than its template")
            S[r_i] = r.seq[idx]
            Q[r_i] = r.qual[idx]
            C[r_i] = np.asarray(scores[r_i])[idx]
        counts = np.zeros((16, length), dtype=np.int64)
        bscore = np.zeros((16, length), dtype=np.int64)
        quals = np.zeros((16, length), dtype=np.int64)
        topq = np.zeros((16, length), dtype=np.int64)
        bins = np.unique(S)
        hot = S[None, :, :] == bins[:, None, None]
        hq = hot * Q[None]
        counts[bins] = hot.sum(1)
        bscore[bins] = (hot * C[None]).sum(1)
        quals[bins] = hq.sum(1)
        topq[bins] = hq.max(1) if R else 0
        total = C.sum(0)
        top = _lex_last_max(bscore, quals)
        top_score = bscore[top, ar]
        top_num = counts[top, ar]
        top_qual = topq[top, ar]
        others = bscore.copy()
        others[top, ar] = np.iinfo(np.int64).min
        sec = _lex_last_max(others, quals)
        sec_num = counts[sec, ar]
        sec_qual = quals[sec, ar]

        keep = ((sec_num == 0) & (top_score >= opt.base_score_req)
                & (top_qual >= opt.moderate_quality))
        need = sec_num == 0
        sec1 = sec_num == 1
        low = sec_qual <= opt.low_quality
        need |= sec1 & low & (top_num < 2) & (top_qual < opt.high_quality)
        need |= sec1 & ~low & ((top_num < 3) | (top_qual < opt.high_quality))
        need |= (sec_num > 1) & ((top_score < opt.score_percent_req * total)
                                 | (top_qual < opt.moderate_quality))
        need |= (top_score < opt.base_score_req) | (top_qual <= opt.low_quality)

        refbase = np.zeros(length, dtype=np.int64)
        if refdata is not None and ref_offsets is not None:
            ro = np.full(length, -1, dtype=np.int64)
            ro[:min(length, len(ref_offsets))] = ref_offsets[:length]
            at = np.flatnonzero((ro >= 0) & ~keep)
            refbase[at] = refdata[out.pos + ro[at]]
        ref4 = _ASCII_TO_NT16[refbase]   # 0 where not A, C, G or T
        arb = need & ~keep & (ref4 != 0)
        match = S == ref4[None, :]
        ref_base_qual = np.where(match, Q, 0).max(0) if R else np.zeros(length, np.int64)
        high = (match & (Q >= opt.high_quality)).any(0)
        top = np.where(arb & high, ref4, top)
        top = np.where(arb & (top_qual < opt.moderate_quality), ref4, top)
        top_qual = np.where(arb & (top == ref4), ref_base_qual, top_qual)

        out_base = out.seq[:length].astype(np.int64)
        changed = ~keep & (out_base != top)
        diff = int(changed.sum())
        known = changed & (ref4 != 0)
        mismatch_inc = int((known & (out_base == ref4)).sum()
                           - (known & (out_base != ref4) & (top == ref4)).sum())
        out.seq[:length] = np.where(changed, top, out_base).astype(np.uint8)
        out.qual[:length] = top_qual.astype(np.uint8)

        if mismatch_inc != 0:
            new_nm = out.nm_val + mismatch_inc
            if mismatch_inc > 5:
                # abnormal: restore (group.cpp:538-566)
                out.seq[:] = seq_bak
                out.qual[:] = qual_bak
            else:
                if out.nm_typ == "C" and 0 <= new_nm <= 255:
                    out.nm_new = new_nm
        return diff

    def make_consensus_scalar(self, reads, out: ORead, scores, is_left: bool) -> int:
        """reference group.cpp:320-579 (the voting kernel, scalar form),
        kept as the check of make_consensus."""
        opt = self.opt
        diff = 0
        mismatch_inc = 0
        seq_bak = out.seq.copy()
        qual_bak = out.qual.copy()

        # right-aligned length offsets + aligner WAR (group.cpp:339-349)
        len_diff = []
        for r in reads:
            d = r.l_qseq - out.l_qseq
            if d != 0:
                if r.pos == out.pos and cig.is_part_of(out.cigar, r.cigar, True):
                    d = 0
            len_diff.append(d)

        length = out.l_qseq
        if out.n_cigar == 0:
            for r in reads:
                if r.l_qseq < length:
                    length = r.l_qseq

        refdata = None
        if out.isize != 0:
            reflen = cig.ref_offset(out.cigar, length - 1) + 1
            refdata = self.ref.get_contig(out.tid, out.pos, reflen)

        ref_offsets = cig.ref_offsets_vector(out.cigar, length) if out.n_cigar else None

        for i in range(length):
            counts = [0] * 16
            base_scores = [0] * 16
            quals = [0] * 16
            top_quals = [0] * 16
            total_score = 0
            for r_i, r in enumerate(reads):
                readpos = i if is_left else i + len_diff[r_i]
                base = int(r.seq[readpos])
                q = int(r.qual[readpos])
                counts[base] += 1
                base_scores[base] += int(scores[r_i][readpos])
                total_score += int(scores[r_i][readpos])
                quals[base] += q
                if q > top_quals[base]:
                    top_quals[base] = q

            top_base = 0
            top_score = -0x7FFFFFFF
            for b in range(16):
                if base_scores[b] > top_score or (
                        base_scores[b] == top_score and quals[b] >= quals[top_base]):
                    top_score = base_scores[b]
                    top_base = b
            top_num = counts[top_base]
            top_qual = top_quals[top_base]

            sec_base = 0
            sec_score = -0x7FFFFFFF
            for b in range(16):
                if b == top_base:
                    continue
                if base_scores[b] > sec_score or (
                        base_scores[b] == sec_score and quals[b] >= quals[sec_base]):
                    sec_score = base_scores[b]
                    sec_base = b
            sec_num = counts[sec_base]

            need_ref = False
            if sec_num == 0:
                if top_score >= opt.base_score_req and top_qual >= opt.moderate_quality:
                    out.qual[i] = top_qual
                    continue
                need_ref = True

            refbase = 0  # char code, 0 = none
            if refdata is not None and ref_offsets is not None:
                refpos = int(ref_offsets[i]) if i < len(ref_offsets) else -1
                if refpos >= 0:
                    refbase = int(refdata[out.pos + refpos])
            if refbase not in (65, 84, 67, 71):  # A T C G
                refbase = 0

            if sec_num == 1:
                if quals[sec_base] <= opt.low_quality:
                    if top_num < 2 and top_qual < opt.high_quality:
                        need_ref = True
                else:
                    if top_num < 3 or top_qual < opt.high_quality:
                        need_ref = True
            if sec_num > 1:
                if top_score < opt.score_percent_req * total_score or top_qual < opt.moderate_quality:
                    need_ref = True
            if top_score < opt.base_score_req or top_qual <= opt.low_quality:
                need_ref = True

            if need_ref and refbase != 0:
                refbase4bit = _CHAR_TO_NT16[chr(refbase)]
                ref_base_qual = 0
                for r_i, r in enumerate(reads):
                    readpos = i if is_left else i + len_diff[r_i]
                    base = int(r.seq[readpos])
                    q = int(r.qual[readpos])
                    if base == refbase4bit:
                        if q > ref_base_qual:
                            ref_base_qual = q
                        if q >= opt.high_quality:
                            top_base = refbase4bit
                if top_qual < opt.moderate_quality:
                    top_base = refbase4bit
                if top_base == refbase4bit:
                    top_qual = ref_base_qual

            out_base = int(out.seq[i])
            if out_base != top_base:
                out.seq[i] = top_base
                diff += 1
                if refbase != 0:
                    refbase4bit = _CHAR_TO_NT16[chr(refbase)]
                    if out_base == refbase4bit:
                        mismatch_inc += 1
                    elif top_base == refbase4bit:
                        mismatch_inc -= 1
            out.qual[i] = top_qual

        if mismatch_inc != 0:
            new_nm = out.nm_val + mismatch_inc
            if mismatch_inc > 5:
                # abnormal: restore (group.cpp:538-566)
                out.seq[:] = seq_bak
                out.qual[:] = qual_bak
            else:
                if out.nm_typ == "C" and 0 <= new_nm <= 255:
                    out.nm_new = new_nm
        return diff


class OCluster:
    """reference src/cluster.{h,cpp}: one (tid,left,right) position cluster."""

    def __init__(self, opt: Options, ref: RefLookup):
        self.opt = opt
        self.ref = ref
        self.pairs: dict = {}  # qname -> OPair

    def add_read(self, r: ORead):
        qname = r.qname
        p = self.pairs.get(qname)
        if p is not None:
            p.set_right(r)
        else:
            p = OPair(self.opt)
            p.set_left(r)
            self.pairs[qname] = p

    def cluster_by_umi(self, umi_diff_threshold: int, pre_stats: Stats,
                       post_stats: Stats, cross_contig: bool) -> list:
        """reference cluster.cpp:55-188."""
        opt = self.opt
        keys = sorted(self.pairs)
        pairs = [self.pairs[k] for k in keys]
        umis = [p.umi for p in pairs]
        has_umi = any(umis)

        idx_groups = greedy_umi_groups(umis, umi_diff_threshold)
        groups = []
        for idxs in idx_groups:
            g = OGroup(opt, self.ref)
            for i in idxs:
                g.add_pair(pairs[i])
            groups.append(g)
        self.pairs.clear()

        pre_stats.add_cluster(len(groups) > 1)
        single = [g.consensus_merge(cross_contig) for g in groups]
        return postprocess_cluster(single, has_umi, opt, pre_stats, post_stats)


class OracleEngine:
    """Streaming cluster/flush engine (reference gencore.cpp:162-477).

    Consumes a decoded RecordBatch in stream order, reproduces the cluster
    keying, the every-10000-reads watermark flush (with
    properReadsUmiDiffThreshold), the end-of-stream finish (with
    unproperReadsUmiDiffThreshold — a reference quirk: leftover clusters
    use the stricter threshold, gencore.cpp:409), pass-through of mate-less
    reads, dropping of unmapped reads, and the ordered output set.
    """

    def __init__(self, opt: Options, header, fasta=None, bed=None):
        self.opt = opt
        self.header = header
        self.ref = RefLookup(fasta, header.names)
        pre_bed = bed
        post_bed = bed.copy_structure() if bed is not None else None
        self.pre_stats = Stats(opt.coverage_step, header.names, header.lengths,
                               bed_stats=pre_bed, is_post=False)
        self.post_stats = Stats(opt.coverage_step, header.names, header.lengths,
                                bed_stats=post_bed, is_post=True)
        self.clusters: dict = {}   # tid -> {left -> {right -> OCluster}}
        self.out_records: list = []  # (sortkey, ORead)
        self._tick = 0
        self._serial = 0
        self._finished = False
        # mProcessedTid/Pos (gencore.cpp:16-17,324-389): output-drain
        # watermark; records at/above it are written only in ~Gencore,
        # AFTER report(), so they are excluded from reported post-stats
        self._wm = (-1, -1)

    # --- output side ---
    def _emit_read(self, r: ORead):
        self._serial += 1
        key = (r.tid if r.tid >= 0 else 0x7FFFFFFF, r.pos, r.mtid, r.mpos,
               r.isize, self._serial)
        self.out_records.append((key, r))

    def _emit_pair(self, p: OPair):
        # outputPair (gencore.cpp:145-160)
        self.post_stats.add_molecule(1, p.left is not None and p.right is not None)
        if p.left is not None:
            self._emit_read(p.left)
        if p.right is not None:
            self._emit_read(p.right)

    # --- cluster keying (gencore.cpp:295-313) ---
    def _add_to_proper_cluster(self, r: ORead):
        tid = r.tid
        left = r.pos
        if r.mtid == r.tid and abs(r.mpos - r.pos) < 100000:
            if r.isize < 0:
                left = r.mpos
            right = left + abs(r.isize) - 1
        else:
            if r.mtid < 0:
                # mate-less: pass through
                self._emit_read(r)
                return
            right = -1 * self.header.lengths[r.tid] * (r.mtid + 1) + r.mpos

        c = (self.clusters.setdefault(tid, {})
             .setdefault(left, {})
             .setdefault(right, OCluster(self.opt, self.ref)))
        c.add_read(r)

        self._tick += 1
        if self._tick % 10000 == 0:
            self._flush(tid, r.pos)

    def _flush(self, cur_tid: int, cur_pos: int):
        """Watermark flush (gencore.cpp:324-389): consensus all clusters with
        tid < cur_tid, or same tid with left < cur_pos and right < cur_pos."""
        for tid in sorted(self.clusters):
            if tid > cur_tid:
                break
            by_left = self.clusters[tid]
            for left in sorted(by_left):
                if tid == cur_tid and left >= cur_pos:
                    break
                by_right = by_left[left]
                for right in sorted(by_right):
                    if tid == cur_tid and right >= cur_pos:
                        break
                    self._consensus_cluster(by_right.pop(right),
                                            self.opt.proper_reads_umi_diff_threshold,
                                            right < 0)
                if not by_right:
                    del by_left[left]
            if not by_left:
                del self.clusters[tid]
        # new watermark = lexmin remaining (tid, left); unchanged when the
        # sweep leaves nothing (curProcessedTid stays INT_MAX, gencore.cpp:386)
        rem = [(t, l) for t, bl in self.clusters.items() for l in bl]
        if rem:
            self._wm = min(rem)

    def _consensus_cluster(self, cluster: OCluster, umi_thr: int, cross_contig: bool):
        for p in cluster.cluster_by_umi(umi_thr, self.pre_stats,
                                        self.post_stats, cross_contig):
            self._emit_pair(p)

    def _finish(self):
        """finishConsensus on remaining clusters — with the UNPROPER
        threshold (gencore.cpp:409)."""
        for tid in sorted(self.clusters):
            by_left = self.clusters[tid]
            for left in sorted(by_left):
                for right in sorted(by_left[left]):
                    self._consensus_cluster(by_left[left][right],
                                            self.opt.unproper_reads_umi_diff_threshold,
                                            right < 0)
        self.clusters.clear()

    # --- main drive (gencore.cpp:205-293) ---
    def run(self, batch: bamio.RecordBatch) -> list:
        """Process all records; returns output records in final file order."""
        opt = self.opt
        is_first = True
        for i in range(batch.n):
            tid = int(batch.tid[i])
            pos = int(batch.pos[i])
            if is_first:
                if opt.umi_prefix == "auto":
                    qname = batch.qname(i).decode("latin-1")
                    if "umi_" in qname:
                        opt.umi_prefix = "umi"
                    elif "UMI_" in qname:
                        opt.umi_prefix = "UMI"
                    else:
                        opt.umi_prefix = ""
                is_first = False
            self.pre_stats.add_read(tid, pos, int(batch.l_qseq[i]),
                                    batch.get_int_tag(i, b"NM", 0))
            if opt.max_contig > 0 and tid >= opt.max_contig:
                break
            if tid < 0 or pos < 0:
                # unmapped: triggers finish, then is dropped (gencore.cpp:254-266)
                if not self._finished:
                    self._finished = True
                    self._finish()
                continue
            flag = int(batch.flag[i])
            if flag & (bamio.FSECONDARY | bamio.FSUPPLEMENTARY):
                continue
            self._add_to_proper_cluster(oread_from_batch(batch, i))
        if not self._finished:
            self._finished = True
            self._finish()
        # final ordered drain: bamComp order (gencore.h:19-47) — unmapped
        # last; ties broken by insertion order (stands in for the pointer)
        self.out_records.sort(key=lambda kr: kr[0])
        out = [r for _, r in self.out_records]
        # reported post-stats: only records the reference wrote before
        # report() — strictly below the drain watermark (writeBam feeds
        # post-stats, gencore.cpp:83-111; final drain is post-report)
        wt, wp = self._wm
        if wp != -1:
            for r in out:
                st = r.tid if r.tid >= 0 else 0x7FFFFFFF
                if st < wt or (st == wt and r.pos < wp):
                    nm_out = r.nm_new if r.nm_new is not None else r.nm_val
                    self.post_stats.add_read(r.tid, r.pos, r.l_qseq, nm_out)
        return out
