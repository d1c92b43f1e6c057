"""SAM text input/output (reference accepts "sorted bam/sam" input and
writes SAM when the output name ends with "sam" — main.cpp:31,
gencore.cpp:170-173 via htslib's text mode). The reader reproduces
htslib sam_parse1 semantics: integer aux tags re-encoded at the smallest
width, bin recomputed via reg2bin, '*' qual -> 0xFF fill."""

from __future__ import annotations

import struct

import numpy as np

from gencore_tpu_torch.io import bam as bamio
from gencore_tpu_torch.utils import cigar as cig

_CIGAR_OPS = "MIDNSHP=X"


def _cigar_str(cigar: np.ndarray) -> str:
    if len(cigar) == 0:
        return "*"
    ops, lens = cig.ops_lens(cigar)
    return "".join(f"{l}{_CIGAR_OPS[o]}" for o, l in zip(ops, lens))


def _aux_str(aux: np.ndarray) -> str:
    out = []
    a = 0
    end = len(aux)
    data = aux
    while a + 3 <= end:
        tag = bytes(data[a:a + 2]).decode("latin-1")
        typ = chr(data[a + 2])
        v = a + 3
        if typ in "cC":
            val = int(np.int8(data[v])) if typ == "c" else int(data[v])
            out.append(f"{tag}:i:{val}")
            a = v + 1
        elif typ in "sS":
            raw = data[v:v + 2].tobytes()
            val = int(np.frombuffer(raw, dtype=np.int16 if typ == "s" else np.uint16)[0])
            out.append(f"{tag}:i:{val}")
            a = v + 2
        elif typ in "iI":
            raw = data[v:v + 4].tobytes()
            val = int(np.frombuffer(raw, dtype=np.int32 if typ == "i" else np.uint32)[0])
            out.append(f"{tag}:i:{val}")
            a = v + 4
        elif typ == "f":
            val = float(np.frombuffer(data[v:v + 4].tobytes(), dtype=np.float32)[0])
            out.append(f"{tag}:f:{val:g}")
            a = v + 4
        elif typ == "A":
            out.append(f"{tag}:A:{chr(data[v])}")
            a = v + 1
        elif typ in "ZH":
            j = v
            while j < end and data[j] != 0:
                j += 1
            out.append(f"{tag}:{typ}:{bytes(data[v:j]).decode('latin-1')}")
            a = j + 1
        elif typ == "B":
            sub = chr(data[v])
            cnt = int(np.frombuffer(data[v + 1:v + 5].tobytes(), dtype=np.uint32)[0])
            width = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            dtype = {"c": np.int8, "C": np.uint8, "s": np.int16, "S": np.uint16,
                     "i": np.int32, "I": np.uint32, "f": np.float32}[sub]
            vals = np.frombuffer(data[v + 5:v + 5 + cnt * width].tobytes(), dtype=dtype)
            out.append(f"{tag}:B:{sub}," + ",".join(str(x) for x in vals))
            a = v + 5 + cnt * width
        else:
            break
    return "\t".join(out)


def record_to_sam(batch_like, header: bamio.BamHeader, qname: bytes, flag: int,
                  tid: int, pos: int, mapq: int, cigar, mtid: int, mpos: int,
                  isize: int, seq_codes, qual, aux) -> str:
    rname = header.names[tid] if tid >= 0 else "*"
    if mtid < 0:
        rnext = "*"
    elif mtid == tid:
        rnext = "="
    else:
        rnext = header.names[mtid]
    seq = bamio.codes_to_seq_str(np.asarray(seq_codes)) if len(seq_codes) else "*"
    q = np.asarray(qual)
    qstr = "".join(chr(min(int(x), 93) + 33) for x in q) if len(q) else "*"
    fields = [qname.decode("latin-1"), str(flag), rname, str(pos + 1),
              str(mapq), _cigar_str(np.asarray(cigar)), rnext, str(mpos + 1),
              str(isize), seq, qstr]
    tags = _aux_str(np.asarray(aux))
    if tags:
        fields.append(tags)
    return "\t".join(fields)


def header_text(header: bamio.BamHeader) -> str:
    text = header.text.decode("latin-1")
    if not text.endswith("\n") and text:
        text += "\n"
    return text


def reg2bin(beg: int, end: int) -> int:
    """htslib hts_reg2bin(min_shift=14, n_lvls=5): BAI bin of [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


_B_SUB = {"c": ("<b", 1), "C": ("<B", 1), "s": ("<h", 2), "S": ("<H", 2),
          "i": ("<i", 4), "I": ("<I", 4), "f": ("<f", 4)}


def _encode_aux_field(field: str) -> bytes:
    """One SAM "TAG:TYPE:VALUE" -> BAM aux bytes, with htslib's integer
    width optimization (sam_parse1: smallest of c/C/s/S/i/I)."""
    tag, typ, val = field.split(":", 2)
    t = tag.encode("latin-1")
    if typ == "i":
        x = int(val)
        if x < 0:
            if x >= -128:
                return t + b"c" + struct.pack("<b", x)
            if x >= -32768:
                return t + b"s" + struct.pack("<h", x)
            return t + b"i" + struct.pack("<i", x)
        if x <= 255:
            return t + b"C" + struct.pack("<B", x)
        if x <= 65535:
            return t + b"S" + struct.pack("<H", x)
        return t + b"I" + struct.pack("<I", x)
    if typ == "A":
        return t + b"A" + val[:1].encode("latin-1")
    if typ == "f":
        return t + b"f" + struct.pack("<f", float(val))
    if typ in ("Z", "H"):
        return t + typ.encode() + val.encode("latin-1") + b"\x00"
    if typ == "B":
        parts = val.split(",")
        sub = parts[0]
        fmt, _ = _B_SUB[sub]
        vals = [float(p) if sub == "f" else int(p) for p in parts[1:]]
        out = t + b"B" + sub.encode() + struct.pack("<I", len(vals))
        for v in vals:
            out += struct.pack(fmt, v)
        return out
    raise ValueError(f"unsupported SAM aux type {typ!r}")


class SamReader:
    """Parses a SAM text file into the same BamHeader/RecordBatch surface
    as BamReader (reference reads SAM via htslib auto-detection,
    main.cpp:31; record semantics follow htslib sam_parse1)."""

    def __init__(self, path: str):
        import sys
        if path == "-":
            text = sys.stdin.read()
        else:
            with open(path, "r") as f:
                text = f.read()
        names: list = []
        lengths: list = []
        header_lines: list = []
        body_start = 0
        for line in text.splitlines(keepends=True):
            if not line.startswith("@"):
                break
            header_lines.append(line)
            body_start += len(line)
            if line.startswith("@SQ"):
                sn, ln = None, None
                for fld in line.rstrip("\n").split("\t")[1:]:
                    if fld.startswith("SN:"):
                        sn = fld[3:]
                    elif fld.startswith("LN:"):
                        ln = int(fld[3:])
                if sn is not None and ln is not None:
                    names.append(sn)
                    lengths.append(ln)
        htext = "".join(header_lines)
        self.header = bamio.BamHeader(htext.encode("latin-1"), names, lengths)
        self._body_text = text[body_start:]
        self._tid_of = {n: i for i, n in enumerate(names)}

    def read_all(self) -> bamio.RecordBatch:
        tid_of = self._tid_of
        bodies: list = []
        for line in self._body_text.splitlines():
            if not line or line.startswith("@"):
                continue
            f = line.split("\t")
            qname = f[0].encode("latin-1")
            flag = int(f[1])
            tid = tid_of.get(f[2], -1) if f[2] != "*" else -1
            pos = int(f[3]) - 1
            mapq = int(f[4])
            cigar = (cig.from_string(f[5]) if f[5] != "*"
                     else np.zeros(0, dtype=np.uint32))
            if f[6] == "*":
                mtid = -1
            elif f[6] == "=":
                mtid = tid
            else:
                mtid = tid_of.get(f[6], -1)
            mpos = int(f[7]) - 1
            isize = int(f[8])
            if f[9] == "*":
                codes = np.zeros(0, dtype=np.uint8)
            else:
                codes = bamio.seq_str_to_codes(f[9])
            if f[10] == "*":
                qual = np.full(len(codes), 0xFF, dtype=np.uint8)
            else:
                qual = (np.frombuffer(f[10].encode("latin-1"), dtype=np.uint8)
                        .astype(np.uint8) - 33)
            aux = b"".join(_encode_aux_field(x) for x in f[11:])
            rlen = cig.ref_len(cigar) if len(cigar) else 1
            bin_ = reg2bin(pos, pos + max(rlen, 1))
            bodies.append(bamio.encode_record(
                tid, pos, qname, flag, mapq, cigar, mtid, mpos, isize,
                codes, qual, aux, bin_=bin_))
        data = np.frombuffer(b"".join(bodies), dtype=np.uint8)
        off = np.zeros(len(bodies) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in bodies], out=off[1:])
        return bamio.RecordBatch(data, off)


def spool_stdin(chunk: int = 8 << 20):
    """Spool stdin to an UNLINKED temp file in bounded chunks; returns
    (path, keeper, is_bam). The reference streams pipes straight through
    htslib at O(window) memory (gencore.cpp:164-173); the two-pass
    streaming design needs a seekable source, so the pipe lands on disk
    once. The inode is unlinked immediately and accessed via
    /proc/self/fd/<n> (valid while `keeper` stays open, reopenable by the
    native ranged readers), so the spool vanishes automatically however
    the process exits."""
    import os
    import shutil
    import sys
    import tempfile
    sniff = sys.stdin.buffer.read(4)
    is_bam = sniff[:2] == b"\x1f\x8b" or sniff == b"BAM\x01"
    tf = tempfile.NamedTemporaryFile(delete=False, suffix=".spool",
                                     mode="wb")
    tf.write(sniff)
    shutil.copyfileobj(sys.stdin.buffer, tf, length=chunk)
    tf.close()
    keeper = open(tf.name, "rb")
    path = f"/proc/self/fd/{keeper.fileno()}"
    if os.path.exists(path):
        os.unlink(tf.name)
    else:  # no procfs (non-Linux): fall back to the named temp file
        path = tf.name
    return path, keeper, is_bam


def open_alignment(path: str):
    """BAM/SAM auto-detecting reader factory (htslib-style detection:
    BGZF/gzip magic or raw BAM magic -> BamReader, else SAM text)."""
    if path == "-":
        path, keeper, is_bam = spool_stdin()
        rdr = (bamio.BamReader(path) if is_bam  # loads payload eagerly
               else SamReader(path))
        rdr._stdin_keeper = keeper  # keeps the unlinked spool alive
        return rdr
    with open(path, "rb") as fh:
        sniff = fh.read(4)
    if sniff[:2] == b"\x1f\x8b" or sniff == b"BAM\x01":
        return bamio.BamReader(path)
    return SamReader(path)


class SamWriter:
    """Writes records (as record-body bytes) to SAM text."""

    def __init__(self, path: str, header: bamio.BamHeader):
        import sys
        self.header = header
        self._own = path != "-"
        self.f = open(path, "w") if self._own else sys.stdout
        self.f.write(header_text(header))

    def write_record(self, body: bytes):
        b = bamio.RecordBatch(np.frombuffer(body, dtype=np.uint8),
                              np.array([0, len(body)], dtype=np.int64))
        line = record_to_sam(
            b, self.header, b.qname(0), int(b.flag[0]), int(b.tid[0]),
            int(b.pos[0]), int(b.mapq[0]), b.cigar(0), int(b.mtid[0]),
            int(b.mpos[0]), int(b.isize[0]), b.seq_codes(0), b.qual(0), b.aux(0))
        self.f.write(line + "\n")

    def write_table(self, table):
        for body in table.encoded_records():
            self.write_record(body)

    def close(self):
        if self._own:
            self.f.close()
