"""Vectorized output-record assembly.

The reference writes records one at a time through htslib after in-place
edits (seq/qual rewrite, NM patch, qname copy+squeeze, FR/RR append —
group.cpp:503-573, bamutil.cpp:338-366, pair.cpp:54-68). The TPU engine
instead collects lightweight per-output descriptors (`OutRead`) and builds
the entire output payload in one columnar pass: multi-slice gathers from
the input payload for unchanged sections, vectorized 4-bit seq packing and
row scatters for edited sections, byte patches for l_read_name/NM, and
appended FR/RR tag blobs.
"""

from __future__ import annotations

import numpy as np


def multi_slice_indices(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flat source indices for concatenated slices src[s_i : s_i+l_i]."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    pre = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], out=pre[1:])
    return np.repeat(starts - pre, lengths) + np.arange(total, dtype=np.int64)


class OutRead:
    """One output record: the template record plus pending edits.

    seq/qual arrays are set for consensus outputs; passthrough records keep
    them None (raw copy). Duplex merging may lazily materialize them.
    """

    __slots__ = ("batch", "rec", "qname_rec", "_seq", "_qual", "nm_new",
                 "fr_tag", "rr_tag", "serial")

    def __init__(self, batch, rec: int, seq=None, qual=None):
        self.batch = batch
        self.rec = rec
        self.qname_rec = rec      # record whose qname this output carries
        self._seq = seq
        self._qual = qual
        self.nm_new = None
        self.fr_tag = None
        self.rr_tag = None
        self.serial = 0

    # --- fields postmerge/dedup logic needs ---
    @property
    def l_qseq(self) -> int:
        return int(self.batch.l_qseq[self.rec])

    @property
    def tid(self) -> int:
        return int(self.batch.tid[self.rec])

    @property
    def pos(self) -> int:
        return int(self.batch.pos[self.rec])

    @property
    def seq(self) -> np.ndarray:
        if self._seq is None:
            self._seq = self.batch.seq_codes(self.rec).copy()
        return self._seq

    @property
    def qual(self) -> np.ndarray:
        if self._qual is None:
            self._qual = np.asarray(self.batch.qual(self.rec)).copy()
        return self._qual

    @property
    def qname(self) -> bytes:
        return self.batch.qname(self.qname_rec)

    @qname.setter
    def qname(self, value):
        raise AttributeError("set qname_rec instead")

    def padded_l_qname(self) -> int:
        from gencore_tpu_torch.io.bam import padded_qname_len
        return padded_qname_len(len(self.qname))


class OutBlock:
    """Columnar run of output records (the vectorized emission path):
    equal-length arrays, with consensus seq/qual referenced as rows of
    shared dense buffers instead of per-record views. nm_new/fr_tag use
    -1 for 'absent' (real values are 0..255). buf -1 = raw copy unless
    the local position appears in `ovr` (materialized row pairs)."""

    __slots__ = ("rec", "qname_rec", "nm_new", "fr_tag", "rr_tag",
                 "serial", "bufs", "buf", "row", "ovr")

    def __init__(self, rec, qname_rec, nm_new, fr_tag, serial, bufs,
                 buf, row, rr_tag=None):
        self.rec = rec
        self.qname_rec = qname_rec
        self.nm_new = nm_new
        self.fr_tag = fr_tag
        # RR tag values for duplex consensus records (-1 = absent,
        # pair.cpp:61-67); None = no duplex entries in this block
        self.rr_tag = rr_tag
        self.serial = serial
        self.bufs = bufs          # list of (seq2d, qual2d)
        self.buf = buf            # int per entry, -1 = raw/override
        self.row = row
        self.ovr = {}             # local pos -> (seq_row, qual_row)


class OutputTable:
    """Sorted columnar output set; builds the BAM payload in one pass.

    Internally fully columnar: OutRead entries (scalar paths) are folded
    into the same column arrays as OutBlock runs, so the payload builders
    never walk per-entry python objects."""

    def __init__(self, batch, entries: list, nm_vals: np.ndarray,
                 nm_patch_off: np.ndarray):
        """entries: OutRead and/or OutBlock items in emission order (each
        with .serial already set); nm_vals/nm_patch_off: per-input-record
        NM value and byte offset of the 1-byte 'C' NM value in the
        payload (-1 when not patchable)."""
        self.batch = batch
        recs = []
        serials = []
        qrecs = []
        nms = []
        frs = []
        rrs = []
        bufids = []
        rows = []
        bufs = []
        bufmap = {}
        ovr = {}
        pos = 0
        for e in entries:
            if isinstance(e, OutBlock):
                m = len(e.rec)
                recs.append(np.asarray(e.rec, dtype=np.int64))
                serials.append(np.asarray(e.serial, dtype=np.int64))
                qrecs.append(np.asarray(e.qname_rec, dtype=np.int64))
                nms.append(np.asarray(e.nm_new, dtype=np.int64))
                frs.append(np.asarray(e.fr_tag, dtype=np.int64))
                rrs.append(np.full(m, -1, dtype=np.int64)
                           if e.rr_tag is None
                           else np.asarray(e.rr_tag, dtype=np.int64))
                bi = np.full(m, -1, dtype=np.int64)
                eb = np.asarray(e.buf, dtype=np.int64)
                has = eb >= 0
                if has.any():
                    lut = np.full(len(e.bufs), -1, dtype=np.int64)
                    for k, b2 in enumerate(e.bufs):
                        key = id(b2[0])
                        g = bufmap.get(key)
                        if g is None:
                            g = len(bufs)
                            bufs.append(b2)
                            bufmap[key] = g
                        lut[k] = g
                    bi[has] = lut[eb[has]]
                bufids.append(bi)
                rows.append(np.asarray(e.row, dtype=np.int64))
                for lp, sq in e.ovr.items():
                    ovr[pos + lp] = sq
                    bi[lp] = -1
                pos += m
            else:
                recs.append(np.array([e.rec], dtype=np.int64))
                serials.append(np.array([e.serial], dtype=np.int64))
                qrecs.append(np.array([e.qname_rec], dtype=np.int64))
                nms.append(np.array(
                    [-1 if e.nm_new is None else e.nm_new], dtype=np.int64))
                frs.append(np.array(
                    [-1 if e.fr_tag is None else e.fr_tag], dtype=np.int64))
                rrs.append(np.array(
                    [-1 if e.rr_tag is None else e.rr_tag], dtype=np.int64))
                bufids.append(np.array([-1], dtype=np.int64))
                rows.append(np.array([0], dtype=np.int64))
                if e._seq is not None:
                    ovr[pos] = (e._seq, e._qual)
                pos += 1

        def cat(parts):
            return (np.concatenate(parts) if parts
                    else np.zeros(0, dtype=np.int64))

        rec = cat(recs)
        serial = cat(serials)
        self.n = len(rec)
        # bamComp order (gencore.h:19-47): tid,pos,mtid,mpos,isize, then
        # insertion order standing in for the pointer tie-break
        tids = batch.tid[rec].astype(np.int64)
        sort_tid = np.where(tids >= 0, tids, 0x7FFFFFFF)
        order = np.lexsort((serial, batch.isize[rec].astype(np.int64),
                            batch.mpos[rec].astype(np.int64),
                            batch.mtid[rec].astype(np.int64),
                            batch.pos[rec].astype(np.int64), sort_tid))
        self.rec = rec[order]
        self._qrec = cat(qrecs)[order]
        self._nm = cat(nms)[order]
        self._fr = cat(frs)[order]
        self._rr = cat(rrs)[order]
        self._buf = cat(bufids)[order]
        self._rowi = cat(rows)[order]
        self._bufs = bufs
        inv = np.empty(self.n, dtype=np.int64)
        inv[order] = np.arange(self.n, dtype=np.int64)
        self._ovr = {int(inv[i]): sq for i, sq in ovr.items()}
        self._edited = self._buf >= 0
        for i in self._ovr:
            self._edited[i] = True
        self.nm_vals = nm_vals
        self.nm_patch_off = nm_patch_off
        self._payload = None
        self._doff = None

    def _edit_of(self, i: int):
        """(seq_row, qual_row) for an edited entry, None for raw copies.
        Buffer rows are sliced to the record's read length."""
        o = self._ovr.get(i)
        if o is not None:
            return o
        bi = int(self._buf[i])
        if bi < 0:
            return None
        sb, qb = self._bufs[bi]
        r = int(self._rowi[i])
        n = int(self.batch.l_qseq[self.rec[i]])
        return sb[r][:n], qb[r][:n]

    # --- stats surface ---
    def stats_arrays(self):
        rec = self.rec
        b = self.batch
        nm = np.where(self._nm >= 0, self._nm, self.nm_vals[rec])
        return (b.tid[rec].astype(np.int64), b.pos[rec].astype(np.int64),
                b.l_qseq[rec].astype(np.int64), nm)

    # --- payload construction ---
    def build_payload(self) -> np.ndarray:
        if self._payload is not None:
            return self._payload
        if self.n == 0:
            self._doff = np.zeros(1, dtype=np.int64)
            self._payload = np.zeros(0, dtype=np.uint8)
            return self._payload
        from gencore_tpu_torch.io import native
        if native.get_lib() is not None and self.batch.data.flags.c_contiguous:
            out = self._build_payload_native(native)
            if out is not None:
                return out
        return self._build_payload_numpy()

    def _geometry(self):
        b = self.batch
        n = self.n
        rec = self.rec
        l_qseq = b.l_qseq[rec].astype(np.int64)
        n_cigar = b.n_cigar[rec].astype(np.int64)
        seqbytes = (l_qseq + 1) >> 1
        aux_len = b.end[rec] - b.aux_off[rec]
        qrec = self._qrec
        qname_len = b.l_read_name[qrec].astype(np.int64)
        has_fr = self._fr >= 0
        has_rr = self._rr >= 0
        tag_len = has_fr * 4 + has_rr * 4
        body_len = 32 + qname_len + 4 * n_cigar + seqbytes + l_qseq + aux_len + tag_len
        doff = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(body_len + 4, out=doff[1:])
        return (rec, l_qseq, n_cigar, seqbytes, aux_len, qrec, qname_len,
                has_fr, has_rr, tag_len, body_len, doff)

    def _edited_matrices(self, esel: np.ndarray, l_qseq: np.ndarray):
        """Dense (seq, qual) matrices for the edited entries `esel`:
        one fancy gather per shared buffer, python only for the few
        scalar-path overrides. Seq columns beyond each row's read length
        are zeroed (the odd-length last nibble must pack as 0)."""
        lq = l_qseq[esel]
        lmax = int(lq.max())
        bmax = (lmax + 1) // 2
        m = np.zeros((len(esel), bmax * 2), dtype=np.uint8)
        q = np.zeros((len(esel), lmax), dtype=np.uint8)
        bsel = self._buf[esel]
        for g in np.unique(bsel[bsel >= 0]):
            mask = bsel == g
            sb, qb = self._bufs[g]
            r = self._rowi[esel[mask]]
            w = min(sb.shape[1], bmax * 2)
            m[mask, :w] = sb[r][:, :w]
            wq = min(qb.shape[1], lmax)
            q[mask, :wq] = qb[r][:, :wq]
        for row in np.nonzero(bsel < 0)[0]:
            s, qq = self._ovr[int(esel[row])]
            m[row, :len(s)] = s
            q[row, :len(qq)] = qq
        # zero the tail beyond each row's length (buffer rows carry the
        # template's full-width content)
        cols = np.arange(bmax * 2, dtype=np.int64)[None, :]
        m[cols >= lq[:, None]] = 0
        return m, q

    def _build_payload_native(self, native) -> np.ndarray:
        """Fast path: whole-body memcpy per record + targeted overwrites.
        Layout-shifting records (qname length changed) fall back per record.
        """
        b = self.batch
        n = self.n
        (rec, l_qseq, n_cigar, seqbytes, aux_len, qrec, qname_len,
         has_fr, has_rr, tag_len, body_len, doff) = self._geometry()
        src = b.data
        orig_off = b.off[rec]
        orig_body_len = b.end[rec] - orig_off
        orig_qname_len = b.l_read_name[rec].astype(np.int64)
        shifted = qname_len != orig_qname_len

        total = int(doff[-1])
        out = np.zeros(total, dtype=np.uint8)
        self._doff = doff
        body = doff[:-1] + 4

        # block_size prefixes
        bs = body_len
        for k in range(4):
            out[doff[:-1] + k] = ((bs >> (8 * k)) & 0xFF).astype(np.uint8)

        un = np.nonzero(~shifted)[0]
        native.gather_slices(src, orig_off[un], orig_body_len[un], out, body[un])

        # qname overwrite where a same-length foreign qname was copied in
        qswap = (~shifted) & (qrec != rec)
        if qswap.any():
            sel = np.nonzero(qswap)[0]
            native.gather_slices(src, b.qname_off[qrec[sel]], qname_len[sel],
                                 out, body[sel] + 32)

        # edited seq/qual overwrites
        cg_dst = body + 32 + qname_len
        seq_dst = cg_dst + 4 * n_cigar
        qual_dst = seq_dst + seqbytes
        edited = self._edited
        esel = np.nonzero(edited & ~shifted)[0]
        if len(esel):
            m, q = self._edited_matrices(esel, l_qseq)
            native.pack_seq_rows(m, l_qseq[esel], out, seq_dst[esel])
            native.gather_slices(q.reshape(-1),
                                 np.arange(len(esel), dtype=np.int64)
                                 * q.shape[1],
                                 l_qseq[esel], out, qual_dst[esel])

        # NM byte patches
        aux_dst = qual_dst + l_qseq
        nm_new = self._nm
        patch = (nm_new >= 0) & (self.nm_patch_off[rec] >= 0) & ~shifted
        if patch.any():
            sel = np.nonzero(patch)[0]
            delta = self.nm_patch_off[rec[sel]] - b.aux_off[rec[sel]]
            out[aux_dst[sel] + delta] = (nm_new[sel] & 0xFF).astype(np.uint8)

        # FR / RR tags
        tag_dst = aux_dst + aux_len
        self._write_tags(out, tag_dst, has_fr & ~shifted, has_rr & ~shifted)

        # rare layout-shifting records: per-record assembly
        for i in np.nonzero(shifted)[0]:
            self._assemble_one(out, int(doff[i]), int(i))

        self._payload = out
        return out

    def _write_tags(self, out, tag_dst, has_fr, has_rr):
        if has_fr.any():
            sel = np.nonzero(has_fr)[0]
            vals = self._fr[sel]
            out[tag_dst[sel]] = ord("F")
            out[tag_dst[sel] + 1] = ord("R")
            out[tag_dst[sel] + 2] = ord("C")
            out[tag_dst[sel] + 3] = (vals & 0xFF).astype(np.uint8)
        if has_rr.any():
            sel = np.nonzero(has_rr)[0]
            fr_here = self._fr[sel] >= 0
            base = tag_dst[sel] + np.where(fr_here, 4, 0)
            vals = self._rr[sel]
            out[base] = ord("R")
            out[base + 1] = ord("R")
            out[base + 2] = ord("C")
            out[base + 3] = (vals & 0xFF).astype(np.uint8)

    def _assemble_one(self, out, doff_i: int, i: int):
        """Single-record assembly (layout-shifted records)."""
        import struct
        b = self.batch
        rec = int(self.rec[i])
        qr = int(self._qrec[i])
        qname = b.data[b.qname_off[qr]:
                       b.qname_off[qr] + b.l_read_name[qr]].tobytes()
        fixed = bytearray(b.data[b.off[rec]:b.off[rec] + 32].tobytes())
        fixed[8] = len(qname)
        cigar = b.data[b.cigar_off[rec]:b.seq_off[rec]].tobytes()
        edit = self._edit_of(i)
        if edit is not None:
            from gencore_tpu_torch.io.bam import pack_seq
            seqb = pack_seq(edit[0]).tobytes()
            qualb = np.asarray(edit[1], dtype=np.uint8).tobytes()
        else:
            seqb = b.data[b.seq_off[rec]:b.qual_off[rec]].tobytes()
            qualb = b.data[b.qual_off[rec]:b.aux_off[rec]].tobytes()
        aux = bytearray(b.data[b.aux_off[rec]:b.end[rec]].tobytes())
        if self._nm[i] >= 0 and self.nm_patch_off[rec] >= 0:
            aux[int(self.nm_patch_off[rec] - b.aux_off[rec])] = \
                int(self._nm[i]) & 0xFF
        tags = b""
        if self._fr[i] >= 0:
            tags += b"FRC" + bytes([int(self._fr[i]) & 0xFF])
        if self._rr[i] >= 0:
            tags += b"RRC" + bytes([int(self._rr[i]) & 0xFF])
        bodyb = bytes(fixed) + qname + cigar + seqb + qualb + bytes(aux) + tags
        blob = struct.pack("<i", len(bodyb)) + bodyb
        out[doff_i:doff_i + len(blob)] = np.frombuffer(blob, dtype=np.uint8)

    def _build_payload_numpy(self) -> np.ndarray:
        b = self.batch
        n = self.n
        rec = self.rec
        src = b.data
        orig_off = b.off[rec]
        orig_end = b.end[rec]

        l_qseq = b.l_qseq[rec].astype(np.int64)
        n_cigar = b.n_cigar[rec].astype(np.int64)
        seqbytes = (l_qseq + 1) >> 1
        aux_off = b.aux_off[rec]
        aux_len = orig_end - aux_off

        qrec = self._qrec
        qname_len = b.l_read_name[qrec].astype(np.int64)  # incl NUL
        has_fr = self._fr >= 0
        has_rr = self._rr >= 0
        tag_len = has_fr * 4 + has_rr * 4

        body_len = 32 + qname_len + 4 * n_cigar + seqbytes + l_qseq + aux_len + tag_len
        total = int((body_len + 4).sum())
        out = np.zeros(total, dtype=np.uint8)
        doff = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(body_len + 4, out=doff[1:])
        self._doff = doff

        # block_size prefixes
        bs = body_len.astype(np.int64)
        for k in range(4):
            out[doff[:-1] + k] = ((bs >> (8 * k)) & 0xFF).astype(np.uint8)
        body = doff[:-1] + 4

        # fixed 32 bytes from original, then patch l_read_name (offset 8)
        fi = multi_slice_indices(orig_off, np.full(n, 32, dtype=np.int64))
        di = multi_slice_indices(body, np.full(n, 32, dtype=np.int64))
        out[di] = src[fi]
        out[body + 8] = qname_len.astype(np.uint8)

        # qname (from qname_rec, includes NUL)
        qsrc = b.qname_off[qrec]
        out[multi_slice_indices(body + 32, qname_len)] = \
            src[multi_slice_indices(qsrc, qname_len)]

        # cigar (unchanged)
        cg_dst = body + 32 + qname_len
        cg_len = 4 * n_cigar
        out[multi_slice_indices(cg_dst, cg_len)] = \
            src[multi_slice_indices(b.cigar_off[rec], cg_len)]

        # seq: packed from final codes (matrix scatter for edited rows,
        # raw copy otherwise)
        seq_dst = cg_dst + cg_len
        edited = self._edited
        if (~edited).any():
            sel = np.nonzero(~edited)[0]
            out[multi_slice_indices(seq_dst[sel], seqbytes[sel])] = \
                src[multi_slice_indices(b.seq_off[rec[sel]], seqbytes[sel])]
        qual_dst = seq_dst + seqbytes
        if (~edited).any():
            sel = np.nonzero(~edited)[0]
            out[multi_slice_indices(qual_dst[sel], l_qseq[sel])] = \
                src[multi_slice_indices(b.qual_off[rec[sel]], l_qseq[sel])]
        if edited.any():
            sel = np.nonzero(edited)[0]
            m, q = self._edited_matrices(sel, l_qseq)
            bmax = m.shape[1] // 2
            packed = (m[:, 0::2] << 4) | m[:, 1::2]
            pi = multi_slice_indices(
                np.arange(len(sel), dtype=np.int64) * bmax, seqbytes[sel])
            out[multi_slice_indices(seq_dst[sel], seqbytes[sel])] = packed.ravel()[pi]
            pi = multi_slice_indices(
                np.arange(len(sel), dtype=np.int64) * q.shape[1], l_qseq[sel])
            out[multi_slice_indices(qual_dst[sel], l_qseq[sel])] = q.ravel()[pi]

        # aux blob (original), then NM byte patch, then appended tags
        aux_dst = qual_dst + l_qseq
        out[multi_slice_indices(aux_dst, aux_len)] = \
            src[multi_slice_indices(aux_off, aux_len)]
        nm_new = self._nm
        patch = (nm_new >= 0) & (self.nm_patch_off[rec] >= 0)
        if patch.any():
            sel = np.nonzero(patch)[0]
            delta = self.nm_patch_off[rec[sel]] - aux_off[sel]
            out[aux_dst[sel] + delta] = (nm_new[sel] & 0xFF).astype(np.uint8)

        # FR / RR tags ('C' typed single byte — pair.cpp:54-68 quirk)
        tag_dst = aux_dst + aux_len
        self._write_tags(out, tag_dst, has_fr, has_rr)

        self._payload = out
        return out

    def record_keys(self) -> np.ndarray:
        """bamComp sort keys [n, 5] for cross-shard merging."""
        b = self.batch
        rec = self.rec
        tids = b.tid[rec].astype(np.int64)
        return np.stack([
            np.where(tids >= 0, tids, 0x7FFFFFFF),
            b.pos[rec].astype(np.int64),
            b.mtid[rec].astype(np.int64),
            b.mpos[rec].astype(np.int64),
            b.isize[rec].astype(np.int64),
        ], axis=1)

    def encoded_records(self) -> list:
        """Record bodies (without block_size) in output order — test surface."""
        payload = self.build_payload()
        doff = self._doff
        out = []
        for i in range(self.n):
            out.append(payload[doff[i] + 4:doff[i + 1]].tobytes())
        return out

    def __len__(self):
        return self.n
