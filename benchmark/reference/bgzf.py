"""BGZF block codec (pure-Python fallback path).

BGZF is a series of gzip members, each carrying a BC extra subfield with the
compressed block size, ending with a fixed 28-byte EOF block. The reference
gets this from htslib (not available in this image); the fast path is the C++
core in csrc/gcio.cpp — this module is the always-available fallback and the
spec oracle for tests.
"""

from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes([
    0x1F, 0x8B, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xFF, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1B, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00,
])

MAX_BLOCK_INPUT = 65280  # uncompressed bytes per block (htslib convention)


def decompress_file(path: str) -> bytes:
    """Decompress a whole BGZF (or plain gzip) file to bytes."""
    with open(path, "rb") as f:
        return decompress_bytes(f.read())


def decompress_bytes(data: bytes) -> bytes:
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos:pos + 2] != b"\x1f\x8b":
            raise ValueError(f"bad gzip magic at offset {pos}")
        # parse member header to find extra BSIZE if present
        flg = data[pos + 3]
        hdr_len = 10
        bsize = None
        if flg & 4:  # FEXTRA
            xlen = struct.unpack_from("<H", data, pos + 10)[0]
            xpos = pos + 12
            xend = xpos + xlen
            while xpos + 4 <= xend:
                si1, si2, slen = data[xpos], data[xpos + 1], struct.unpack_from("<H", data, xpos + 2)[0]
                if si1 == 66 and si2 == 67 and slen == 2:
                    bsize = struct.unpack_from("<H", data, xpos + 4)[0] + 1
                xpos += 4 + slen
            hdr_len = 12 + xlen
        if bsize is not None:
            comp = data[pos + hdr_len:pos + bsize - 8]
            isize = struct.unpack_from("<I", data, pos + bsize - 4)[0]
            if isize:
                out.append(zlib.decompress(comp, -15))
            pos += bsize
        else:
            # plain gzip member: let zlib find the end
            d = zlib.decompressobj(31)
            out.append(d.decompress(data[pos:]))
            consumed = len(data) - pos - len(d.unused_data)
            pos += consumed
    return b"".join(out)


def compress_to_file(path: str, payload: bytes, level: int = 6) -> None:
    """Write payload as BGZF blocks + EOF marker."""
    with open(path, "wb") as f:
        for i in range(0, len(payload), MAX_BLOCK_INPUT):
            chunk = payload[i:i + MAX_BLOCK_INPUT]
            f.write(compress_block(chunk, level))
        f.write(BGZF_EOF)


def compress_block(chunk: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(chunk) + co.flush()
    bsize = len(comp) + 26  # 12 hdr + 6 extra + comp + 8 trailer
    if bsize > 65536:
        raise ValueError("BGZF block too large")
    hdr = struct.pack(
        "<4BIBBH BBHH",
        0x1F, 0x8B, 0x08, 0x04,  # magic, deflate, FEXTRA
        0, 0, 0xFF,              # mtime, xfl, os
        6,                       # xlen
        66, 67, 2, bsize - 1,    # BC subfield
    )
    trailer = struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))
    return hdr + comp + trailer
