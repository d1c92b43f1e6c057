"""The one sample generator: a coordinate-sorted paired-end BAM with UMIs in
the read names, its FASTA and its BED, made from a configuration (the
library: genome, panel, fragment profile, UMIs, errors, qualities) and a
traffic mix (molecules per target and the family-size distribution).

The files fix every size: the targets, the number of molecules and the
multiset of family sizes and fragment lengths. The seed draws only the
content: fragment starts, UMIs, which strand each pair reads, errors,
qualities, read names and the order of the multisets. So every seed makes
a sample of the same number of reads.

Run as a script it writes `<out>/sample.bam` and then `<out>/made.json`
(its counts; written last, so a directory that holds it holds a whole
sample) and prints that JSON on one line. The genome's FASTA and
the BED depend on the configuration alone and are written once into a
cache directory.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import struct
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

NT16 = np.array([1, 2, 4, 8], dtype=np.uint8)       # A C G T as BAM nt16
ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
BGZF_BLOCK = 65280
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")

FIXED = np.dtype([("block_size", "<i4"), ("tid", "<i4"), ("pos", "<i4"),
                  ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                  ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                  ("mtid", "<i4"), ("mpos", "<i4"), ("tlen", "<i4")])


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed; any whole number is a seed."""
    seed = int(seed)
    return np.random.default_rng(
        np.random.SeedSequence([abs(seed), int(seed < 0), *stream]))


# --- what the configuration alone fixes --------------------------------

def genome_codes(cfg: dict) -> list:
    """Contigs as arrays of base indices 0..3 (A C G T), from the
    configuration's own seed."""
    g = cfg["genome"]
    rng = rng_for(g["seed"], 0)
    n = g["contigs"]
    clen = g["genome_bp"] // n
    return [rng.integers(0, 4, size=clen, dtype=np.uint8) for _ in range(n)]


def panel(cfg: dict) -> dict:
    """Targets (capture) or amplicons, spread over the contigs: tid, start,
    end (the BED interval) and, for amplicons, the insert length."""
    g, p = cfg["genome"], cfg["panel"]
    rng = rng_for(g["seed"], 1)
    n, nc = p["targets"], g["contigs"]
    clen = g["genome_bp"] // nc
    tid = np.arange(n) % nc
    slot = np.arange(n) // nc
    per = -(-n // nc)
    step = (clen - 20_000) // per
    start = 10_000 + step * slot + step // 4 + rng.integers(0, step // 2, size=n)
    if p["kind"] == "capture":
        length = np.full(n, p["target_bp"])
    elif p["kind"] == "amplicon":
        lo, hi = p["insert_bp"]
        length = rng.integers(lo, hi + 1, size=n)
    else:
        raise ValueError(f"unknown panel kind {p['kind']!r}")
    return {"tid": tid.astype(np.int64), "start": start.astype(np.int64),
            "end": (start + length).astype(np.int64),
            "length": length.astype(np.int64)}


def write_reference(cfg: dict, cache_dir: str) -> tuple:
    """The configuration's FASTA and BED under cache_dir, written once
    (atomically, so concurrent runs never read a partial file)."""
    os.makedirs(cache_dir, exist_ok=True)
    fa = os.path.join(cache_dir, "genome.fa")
    bed = os.path.join(cache_dir, "panel.bed")
    names = contig_names(cfg)
    if not os.path.exists(fa):
        tmp = f"{fa}.partial{os.getpid()}"
        with open(tmp, "wb") as f:
            for name, c in zip(names, genome_codes(cfg)):
                f.write(f">{name}\n".encode())
                f.write(_fasta_lines(ASCII[c]))
        os.replace(tmp, fa)
    if not os.path.exists(bed):
        p = panel(cfg)
        tmp = f"{bed}.partial{os.getpid()}"
        with open(tmp, "w") as f:
            for t, s, e in zip(p["tid"], p["start"], p["end"]):
                f.write(f"{names[t]}\t{s}\t{e}\n")
        os.replace(tmp, bed)
    return fa, bed


def contig_names(cfg: dict) -> list:
    return [f"chr{i + 1}" for i in range(cfg["genome"]["contigs"])]


def _fasta_lines(seq: np.ndarray, width: int = 70) -> bytes:
    full = len(seq) // width * width
    body = np.empty((full // width, width + 1), dtype=np.uint8)
    body[:, :width] = seq[:full].reshape(-1, width)
    body[:, width] = ord("\n")
    tail = seq[full:].tobytes() + (b"\n" if len(seq) > full else b"")
    return body.tobytes() + tail


# --- fixed multisets, shuffled by the seed ------------------------------

def quantile_multiset(pmf_values: np.ndarray, pmf: np.ndarray, n: int) -> np.ndarray:
    """n values whose histogram follows pmf as closely as n allows: the
    value at each quantile (i + 0.5) / n. The same for every seed."""
    cdf = np.cumsum(pmf / pmf.sum())
    q = (np.arange(n) + 0.5) / n
    return pmf_values[np.minimum(np.searchsorted(cdf, q), len(cdf) - 1)]


def family_sizes(dist: dict, n: int) -> np.ndarray:
    """Read pairs per molecule: one_plus_poisson (1 + Poisson(mean_extra))
    or uniform (lo..hi inclusive)."""
    if dist["kind"] == "one_plus_poisson":
        lam = float(dist["mean_extra"])
        k = np.arange(0, int(lam + 12 * math.sqrt(lam + 1) + 10))
        pmf = np.exp(k * math.log(lam) - lam
                     - np.array([math.lgamma(x + 1) for x in k])) if lam > 0 \
            else (k == 0).astype(float)
        return 1 + quantile_multiset(k, pmf, n)
    if dist["kind"] == "uniform":
        lo, hi = dist["lo"], dist["hi"]
        k = np.arange(lo, hi + 1)
        return quantile_multiset(k, np.ones(len(k)), n)
    raise ValueError(f"unknown family distribution {dist['kind']!r}")


def fragment_lengths(prof: dict, n: int) -> np.ndarray:
    """cfDNA insert sizes: mixture of normal peaks (mono- and
    di-nucleosomal) and a flat shoulder, cut to [min, max]."""
    x = np.arange(prof["min"], prof["max"] + 1)
    pmf = np.zeros(len(x))
    for mu, sd, w in prof["peaks"]:
        pmf += w * np.exp(-0.5 * ((x - mu) / sd) ** 2) / sd
    lo, hi, w = prof["flat"]
    pmf += w * ((x >= lo) & (x <= hi)) / (hi - lo + 1)
    return quantile_multiset(x, pmf, n)


# --- the sample ---------------------------------------------------------

def molecules(cfg: dict, traffic: dict, seed: int) -> dict:
    """Per molecule: target, start, insert length, family size, UMI halves."""
    p = panel(cfg)
    T = len(p["tid"])
    mpt = traffic["molecules_per_target"]
    M = T * mpt
    rng = rng_for(seed, 10)
    target = np.repeat(np.arange(T), mpt)
    fam = rng.permutation(family_sizes(traffic["family"], M))
    kind = cfg["panel"]["kind"]
    if kind == "capture":
        frag = rng.permutation(fragment_lengths(cfg["fragment"], M))
        j = cfg["panel"]["jitter_bp"]
        start = p["start"][target] + rng.integers(-j, j + 1, size=M)
    else:
        frag = p["length"][target]
        start = p["start"][target].copy()
    u = cfg["umi"]
    umi = rng.integers(0, 4, size=(M, sum(u["halves"])), dtype=np.uint8) \
        if u["mode"] != "none" else np.zeros((M, 0), dtype=np.uint8)
    return {"target": target, "tid": p["tid"][target], "start": start,
            "frag": frag.astype(np.int64), "family": fam.astype(np.int64),
            "umi": umi}


def pairs(cfg: dict, mol: dict, seed: int) -> dict:
    """Expand molecules to read pairs: strand, UMI as read (with errors),
    positions and read length."""
    rng = rng_for(seed, 11)
    M = len(mol["family"])
    m = np.repeat(np.arange(M), mol["family"])
    P = len(m)
    u = cfg["umi"]
    strand = np.zeros(P, dtype=np.int8)
    if u["mode"] == "duplex":
        # a share of molecules lost its partner strand: all its pairs read
        # one strand; the others' pairs split at random between both
        lone = rng.random(M) < u["no_partner_share"]
        strand = rng.integers(0, 2, size=P).astype(np.int8)
        which = rng.integers(0, 2, size=M).astype(np.int8)
        strand = np.where(lone[m], which[m], strand)
    umi = mol["umi"][m].copy()
    if u["mode"] == "duplex":
        a, b = u["halves"]
        swap = strand == 1
        umi[swap] = np.concatenate([umi[swap, a:], umi[swap, :a]], axis=1)
    if umi.shape[1] and u["error_per_base"] > 0:
        hit = rng.random(umi.shape) < u["error_per_base"]
        umi[hit] = (umi[hit] + rng.integers(1, 4, size=int(hit.sum()))) % 4
    rl = cfg["read_bp"]
    frag = mol["frag"][m]
    length = np.minimum(rl, frag)
    pos1 = mol["start"][m]
    pos2 = pos1 + frag - length
    return {"mol": m, "tid": mol["tid"][m], "pos1": pos1, "pos2": pos2,
            "len": length, "umi": umi, "strand": strand,
            "serial": rng.permutation(P)}


def _umi_text(cfg: dict, umi: np.ndarray) -> np.ndarray:
    """UMI bytes as fastp writes them after the prefix: halves joined by _."""
    if umi.shape[1] == 0:
        return np.zeros((len(umi), 0), dtype=np.uint8)
    parts, at = [], 0
    for h in cfg["umi"]["halves"]:
        if parts:
            parts.append(np.full((len(umi), 1), ord("_"), dtype=np.uint8))
        parts.append(ASCII[umi[:, at:at + h]])
        at += h
    return np.concatenate(parts, axis=1)


def _digits(v: np.ndarray, width: int) -> np.ndarray:
    out = np.empty((len(v), width), dtype=np.uint8)
    x = v.astype(np.int64).copy()
    for k in range(width - 1, -1, -1):
        out[:, k] = ord("0") + x % 10
        x //= 10
    return out


def qnames(cfg: dict, pr: dict) -> np.ndarray:
    """Fixed-width read names, NUL ended: SIM:1:FC:1:<serial>:UMI_<umi>."""
    P = len(pr["serial"])
    head = np.frombuffer(b"SIM:1:FC:1:", dtype=np.uint8)
    parts = [np.broadcast_to(head, (P, len(head))), _digits(pr["serial"], 9)]
    text = _umi_text(cfg, pr["umi"])
    if text.shape[1]:
        pre = np.frombuffer(f":{cfg['umi']['prefix']}_".encode(), dtype=np.uint8)
        parts += [np.broadcast_to(pre, (P, len(pre))), text]
    parts.append(np.zeros((P, 1), dtype=np.uint8))
    return np.concatenate(parts, axis=1)


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The BAM bin of [beg, end) (SAM specification, section 5.3)."""
    e = end - 1
    out = np.zeros(len(beg), dtype=np.int64)
    done = np.zeros(len(beg), dtype=bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (e >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def reads(cfg: dict, pr: dict, genome: list, seed: int) -> dict:
    """Both reads of each pair in coordinate order, with their sequences,
    qualities and NM, as columns."""
    rng = rng_for(seed, 12)
    P = len(pr["mol"])
    tid = np.concatenate([pr["tid"], pr["tid"]])
    pos = np.concatenate([pr["pos1"], pr["pos2"]])
    mpos = np.concatenate([pr["pos2"], pr["pos1"]])
    length = np.concatenate([pr["len"], pr["len"]])
    span = pr["pos2"] + pr["len"] - pr["pos1"]
    tlen = np.concatenate([span, -span])
    flag = np.concatenate([np.full(P, 99), np.full(P, 147)])
    pair = np.concatenate([np.arange(P), np.arange(P)])
    mate = np.concatenate([np.zeros(P, np.int64), np.ones(P, np.int64)])
    order = np.lexsort((mate, pr["serial"][pair], pos, tid))
    cols = {"tid": tid[order], "pos": pos[order], "mpos": mpos[order],
            "len": length[order], "tlen": tlen[order], "flag": flag[order],
            "pair": pair[order]}
    n = 2 * P
    # sequences by read length (few distinct lengths), with substitutions
    seqs, nm, quals = {}, np.zeros(n, dtype=np.int64), {}
    e = cfg["errors"]
    q = cfg["quals"]
    qual_per_read = None
    if q["mode"] == "per_read":
        qual_per_read = rng.integers(q["lo"], q["hi"] + 1, size=n).astype(np.uint8)
    for L in np.unique(cols["len"]):
        idx = np.flatnonzero(cols["len"] == L)
        k = len(idx)
        s = np.empty((k, L), dtype=np.uint8)
        for a in range(0, k, 65536):
            rows = idx[a:a + 65536]
            for c, g in enumerate(genome):
                on = cols["tid"][rows] == c
                s[a:a + len(rows)][on] = g[cols["pos"][rows][on][:, None]
                                           + np.arange(L)]
        if e["mode"] == "per_base":
            n_err = int(rng.binomial(k * L, e["rate"]))
            flat = np.unique(rng.integers(0, k * L, size=n_err))
        else:
            # lo..hi errors a read at distinct positions
            per = rng.integers(e["lo"], e["hi"] + 1, size=k)
            col = np.sort(rng.integers(0, L, size=(k, e["hi"])), axis=1)
            keep = np.arange(e["hi"])[None, :] < per[:, None]
            keep[:, 1:] &= col[:, 1:] != col[:, :-1]
            flat = (np.arange(k)[:, None] * L + col)[keep]
        sf = s.reshape(-1)
        sf[flat] = (sf[flat] + rng.integers(1, 4, size=len(flat))) % 4
        nm[idx] = np.bincount(flat // L, minlength=k)
        seqs[int(L)] = (idx, NT16[s])
        if q["mode"] == "binned":
            major = q["values"][q["major"]]
            qv = np.full((k, L), major, dtype=np.uint8)
            qf = qv.reshape(-1)
            for v, share in zip(q["values"], q["shares"]):
                if v != major:
                    qf[rng.integers(0, k * L, size=int(round(share * k * L)))] = v
        else:
            qv = np.repeat(qual_per_read[idx][:, None], L, axis=1)
        quals[int(L)] = qv
    cols["nm"] = nm
    cols["seqs"] = seqs
    cols["quals"] = quals
    cols["qname"] = qnames(cfg, pr)[cols["pair"]]
    return cols


def encode(cfg: dict, cols: dict) -> bytes:
    """The BAM body: header, then every record in order."""
    names = contig_names(cfg)
    clen = cfg["genome"]["genome_bp"] // cfg["genome"]["contigs"]
    text = ("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{nm}\tLN:{clen}\n" for nm in names)).encode()
    head = [b"BAM\x01", struct.pack("<i", len(text)), text,
            struct.pack("<i", len(names))]
    for nm in names:
        nb = nm.encode() + b"\x00"
        head += [struct.pack("<i", len(nb)), nb, struct.pack("<i", clen)]
    n = len(cols["pos"])
    lq = cols["qname"].shape[1]
    L = cols["len"]
    size = 36 + lq + 4 + (L + 1) // 2 + L + 4
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(size, out=off[1:])
    buf = np.zeros(int(off[-1]), dtype=np.uint8)
    fx = np.zeros(n, dtype=FIXED)
    fx["block_size"] = size - 4
    fx["tid"] = cols["tid"]
    fx["pos"] = cols["pos"]
    fx["l_read_name"] = lq
    fx["mapq"] = 60
    fx["bin"] = reg2bin(cols["pos"], cols["pos"] + L)
    fx["n_cigar"] = 1
    fx["flag"] = cols["flag"]
    fx["l_seq"] = L
    fx["mtid"] = cols["tid"]
    fx["mpos"] = cols["mpos"]
    fx["tlen"] = cols["tlen"]
    fixed = fx.view(np.uint8).reshape(n, 36)
    for Lv, (idx, codes) in cols["seqs"].items():
        k = len(idx)
        if Lv % 2:
            codes = np.concatenate([codes, np.zeros((k, 1), np.uint8)], axis=1)
        packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
        cigar = np.full(k, Lv << 4, dtype="<u4").view(np.uint8).reshape(k, 4)
        aux = np.empty((k, 4), dtype=np.uint8)
        aux[:, :3] = np.frombuffer(b"NMC", dtype=np.uint8)
        aux[:, 3] = np.minimum(cols["nm"][idx], 255)
        rec = np.concatenate([fixed[idx], cols["qname"][idx], cigar, packed,
                              cols["quals"][Lv], aux], axis=1)
        w = rec.shape[1]
        for a in range(0, k, 32768):
            rows = slice(a, a + 32768)
            buf[off[idx[rows]][:, None] + np.arange(w)] = rec[rows]
    return b"".join(head) + buf.tobytes()


def _block(chunk: bytes) -> bytes:
    comp = zlib.compress(chunk, 6, wbits=-15)
    hdr = struct.pack("<4BIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                      66, 67, 2, len(comp) + 25)
    return hdr + comp + struct.pack("<II", zlib.crc32(chunk), len(chunk))


def write_bgzf(path: str, payload: bytes, threads: int) -> None:
    """BGZF blocks of 65,280 bytes, deflated over threads (zlib releases
    the interpreter lock), then the EOF block."""
    view = memoryview(payload)
    chunks = [view[i:i + BGZF_BLOCK] for i in range(0, len(payload), BGZF_BLOCK)]
    with ThreadPoolExecutor(threads) as ex, open(path, "wb") as f:
        for blk in ex.map(lambda c: _block(bytes(c)), chunks):
            f.write(blk)
        f.write(BGZF_EOF)


def sample(cfg: dict, traffic: dict, seed: int, path: str,
           threads: int = 4) -> dict:
    """Write one sample's BAM; returns its counts."""
    genome = genome_codes(cfg)
    mol = molecules(cfg, traffic, seed)
    pr = pairs(cfg, mol, seed)
    cols = reads(cfg, pr, genome, seed)
    write_bgzf(path, encode(cfg, cols), threads)
    return {"reads": int(len(cols["pos"])), "bases": int(cols["len"].sum()),
            "pairs": int(len(pr["mol"])), "molecules": int(len(mol["family"])),
            "targets": int(mol["target"].max()) + 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="configuration JSON")
    ap.add_argument("--traffic", required=True, help="traffic JSON")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True, help="directory for the sample")
    ap.add_argument("--cache", required=True, help="directory for FASTA, BED")
    ap.add_argument("--threads", type=int, default=4)
    a = ap.parse_args(argv)
    with open(a.config) as f:
        cfg = json.load(f)
    with open(a.traffic) as f:
        traffic = json.load(f)
    os.makedirs(a.out, exist_ok=True)
    write_reference(cfg, a.cache)
    path = os.path.join(a.out, "sample.bam")
    tmp = f"{path}.partial{os.getpid()}"
    res = {"counts": sample(cfg, traffic, a.seed, tmp, a.threads)}
    os.replace(tmp, path)
    tmp = os.path.join(a.out, f"made.json.partial{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(res, f)
    os.replace(tmp, os.path.join(a.out, "made.json"))
    print(json.dumps(res))
    return 0

if __name__ == "__main__":
    sys.exit(main())
