"""ctypes bindings for the port's native I/O core (csrc/gcio.cpp).

The core does threaded BGZF inflate/deflate and BAM record scanning; the
columnar field decode stays in vectorized numpy (io/bam.py). It is built
with the C++ compiler at first use into build/gencore_tpu_torch/, one
library per hash of its sources, flags and DEFLATE codec: libdeflate
where that is installed, else zlib. Any number of processes may start at
once on an empty build directory: the build runs under an exclusive file
lock, compiles to a temporary name and renames it into place, so a
process only ever loads a whole library. A compiler's refusal (no
libdeflate.h, say) is recorded beside the libraries under the same key, so
only the first process pays for it. Where there is no compiler or no
codec library, get_lib() is None, why_not() says why, and callers use the
pure-Python codec.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shlex
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "gencore_tpu_torch")
SOURCES = ("gcio.cpp", "gcio_codec.h")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
# codec -> (define, link flag), in the order an unnamed build tries them
CODECS = {"libdeflate": ("-DGCIO_CODEC_LIBDEFLATE", "-ldeflate"),
          "zlib": ("-DGCIO_CODEC_ZLIB", "-lz")}
# the ThreadSanitizer exerciser of the core (csrc/test_gcio.cpp)
TSAN_SOURCES = ("gcio.cpp", "gcio_codec.h", "test_gcio.cpp")
TSAN_FLAGS = ("-O1", "-g", "-std=c++17", "-Wall", "-pthread",
              "-fsanitize=thread")

_lib = None
_tried = False
_lib_lock = threading.Lock()
# why the core is absent (get_lib() returned None), else ""
BUILD_LOG = ""


class NativeCoreError(RuntimeError):
    """The native core could not be compiled or linked."""


def _compiler() -> list:
    return shlex.split(os.environ.get("CXX", "") or "g++")


def _build_key(codec: str, flags, sources) -> str:
    h = hashlib.sha256(" ".join((*_compiler(), *flags,
                                 *CODECS[codec])).encode())
    for name in sources:
        h.update(name.encode())
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(codec: str) -> str:
    """Path of the core for the current sources, flags and `codec`."""
    return os.path.join(BUILD_DIR, f"libgcio_{codec}_"
                        f"{_build_key(codec, CXXFLAGS, SOURCES)}.so")


def _failed_path(path: str) -> str:
    """Where a compiler's refusal to build `path` is recorded."""
    return os.path.splitext(path)[0] + ".failed"


def _recorded_failure(path: str):
    """Raise the failure recorded for `path`, if there is one."""
    try:
        with open(_failed_path(path)) as f:
            msg = f.read()
    except OSError:
        return
    raise NativeCoreError(f"{msg} (recorded in {_failed_path(path)}: "
                          "delete it to try again)")


def _compile(codec: str, path: str, flags, sources):
    define, link = CODECS[codec]
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [*_compiler(), *flags, define,
           *(os.path.join(CSRC_DIR, n) for n in sources
             if n.endswith(".cpp")), "-o", tmp, link]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            # the same sources, flags and compiler will fail the same way
            # (a missing header or library): later processes read this
            # instead of compiling again under the lock
            msg = (f"{' '.join(cmd[:1])} failed for codec {codec} (exit "
                   f"{r.returncode}): {r.stderr.strip()[-400:]}")
            with open(tmp, "w") as f:
                f.write(msg)
            os.replace(tmp, _failed_path(path))
            raise NativeCoreError(msg)
        os.replace(tmp, path)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeCoreError(f"{cmd[0]}: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _check_codec(codec: str):
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}: one of {sorted(CODECS)}")


def _build(codec: str, path: str, flags, sources) -> str:
    if not os.path.exists(path):
        _recorded_failure(path)
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, "gcio.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if not os.path.exists(path):      # else built while we waited
                _recorded_failure(path)       # or refused while we waited
                _compile(codec, path, flags, sources)
    return path


def build(codec: str) -> str:
    """Path of the core built with `codec` ("libdeflate" or "zlib");
    compiles it first when this build directory lacks it. Raises
    NativeCoreError."""
    _check_codec(codec)
    return _build(codec, library_path(codec), CXXFLAGS, SOURCES)


def build_tsan(codec: str) -> str:
    """Path of csrc/test_gcio.cpp and the core linked into one program
    under ThreadSanitizer (`-fsanitize=thread`) with `codec`, built as
    build() builds the core (same lock, same record of a refusal). Run
    it with a scratch directory as its argument: it exits 0 when every
    check holds, and TSan reports a race on stderr as `WARNING:
    ThreadSanitizer`. Raises NativeCoreError when the compiler refuses
    the build (no TSan runtime, say)."""
    _check_codec(codec)
    path = os.path.join(BUILD_DIR, f"test_gcio_tsan_{codec}_"
                        f"{_build_key(codec, TSAN_FLAGS, TSAN_SOURCES)}")
    return _build(codec, path, TSAN_FLAGS, TSAN_SOURCES)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry point's argument and result types."""
    lib.gc_codec_name.restype = ctypes.c_char_p
    lib.gc_codec_name.argtypes = []
    lib.gc_bgzf_read.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.gc_bgzf_read.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.gc_bgzf_write.restype = ctypes.c_int
    lib.gc_bgzf_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.gc_bgzf_write_ex.restype = ctypes.c_int
    lib.gc_bgzf_write_ex.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.gc_bgzf_block_table.restype = ctypes.c_int64
    lib.gc_bgzf_block_table.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_void_p]
    lib.gc_bgzf_read_blocks.restype = ctypes.c_int
    lib.gc_bgzf_read_blocks.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_int]
    lib.gc_bgzf_read_span.restype = ctypes.c_int
    lib.gc_bgzf_read_span.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int]
    lib.gc_bam_scan.restype = ctypes.c_int64
    lib.gc_bam_scan.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.gc_bam_scan_partial.restype = ctypes.c_int64
    lib.gc_bam_scan_partial.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.gc_assemble.restype = None
    lib.gc_assemble.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.gc_gather_slices.restype = None
    lib.gc_gather_slices.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int]
    lib.gc_unpack_seq_rows.restype = None
    lib.gc_unpack_seq_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int]
    lib.gc_copy_rows.restype = None
    lib.gc_copy_rows.argtypes = lib.gc_unpack_seq_rows.argtypes
    lib.gc_pack_seq_rows.restype = None
    lib.gc_pack_seq_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int]
    lib.gc_free.restype = None
    lib.gc_free.argtypes = [ctypes.c_void_p]
    lib.gc_hist_rows.restype = None
    lib.gc_hist_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64,
                                 ctypes.c_void_p]
    lib.gc_pack_nib_rows.restype = None
    lib.gc_pack_nib_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_int]
    lib.gc_unpack_nib_dense.restype = None
    lib.gc_unpack_nib_dense.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_int]
    lib.gc_umi_spans.restype = None
    lib.gc_umi_spans.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int]
    lib.gc_pack2_rows.restype = ctypes.c_int
    lib.gc_pack2_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int]
    lib.gc_seq_edits.restype = None
    lib.gc_seq_edits.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int]
    lib.gc_qual_edits.restype = None
    lib.gc_qual_edits.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int]
    lib.gc_nm_extract.restype = None
    lib.gc_nm_extract.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int]
    lib.gc_bam_index.restype = ctypes.c_int64
    lib.gc_bam_index.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_int64,
         ctypes.POINTER(ctypes.c_int64)]
        + [ctypes.c_void_p] * 8 + [ctypes.c_int])
    lib.gc_ref_edits.restype = None
    lib.gc_ref_edits.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int]
    lib.gc_nib_seen.restype = None
    lib.gc_nib_seen.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int]
    lib.gc_mi_flags.restype = None
    lib.gc_mi_flags.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_int]
    lib.gc_greedy_group.restype = ctypes.c_int64
    lib.gc_greedy_group.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_void_p]
    lib.gc_fasta_scan.restype = ctypes.c_int64
    lib.gc_fasta_scan.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64)]
    lib.gc_fasta_fill.restype = ctypes.c_int64
    lib.gc_fasta_fill.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_void_p]
    lib.gc_nt16.restype = None
    lib.gc_nt16.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    return lib


def load(codec: str | None = None) -> ctypes.CDLL:
    """Build if need be and load the core with its entry points declared.
    codec as for build(); None takes the first of CODECS whose library
    builds and loads here (a build directory carried over from a machine
    that had libdeflate holds one that does not). A library of its own, not
    the one get_lib() caches: the tests hold one codec's build against the
    other's. Raises NativeCoreError."""
    errors = []
    for c in ([codec] if codec else list(CODECS)):
        try:
            return _bind(ctypes.CDLL(build(c)))
        except (NativeCoreError, OSError) as e:
            errors.append(str(e))
    raise NativeCoreError("; ".join(errors))


def get_lib():
    """The process's native core, or None when GENCORE_NO_NATIVE is set or
    the core cannot be built or loaded here; why_not() then says why."""
    global _lib, _tried, BUILD_LOG
    with _lib_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GENCORE_NO_NATIVE"):
            BUILD_LOG = "GENCORE_NO_NATIVE is set"
            return None
        try:
            _lib = load()
        except NativeCoreError as e:
            BUILD_LOG = str(e)
        return _lib


def why_not() -> str:
    """Why get_lib() returned None ("" when it loaded or was not asked)."""
    return "" if _lib is not None else BUILD_LOG


def codec() -> str | None:
    """Name of the DEFLATE codec of the loaded core ("libdeflate" or
    "zlib"), None when there is no native core."""
    lib = get_lib()
    return None if lib is None else lib.gc_codec_name().decode()


def bgzf_read(path: str, n_threads: int = 0):
    """Threaded BGZF decompress. Returns numpy uint8 array or None."""
    lib = get_lib()
    if lib is None:
        return None
    out_len = ctypes.c_int64(0)
    ptr = lib.gc_bgzf_read(path.encode(), ctypes.byref(out_len), n_threads)
    if not ptr:
        return None
    n = out_len.value
    # copy into numpy-owned memory, then free the C buffer
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.gc_free(ptr)
    return arr


def bgzf_write(path: str, payload: np.ndarray, level: int = 6,
               n_threads: int = 0) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    r = lib.gc_bgzf_write(path.encode(), payload.ctypes.data,
                          len(payload), level, n_threads)
    return r == 0


def bgzf_write_ex(path: str, payload: np.ndarray, level: int = 6,
                  n_threads: int = 0, append: bool = False,
                  write_eof: bool = True) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    r = lib.gc_bgzf_write_ex(path.encode(), payload.ctypes.data, len(payload),
                             level, n_threads, int(append), int(write_eof))
    return r == 0


def bgzf_block_table(path: str):
    """(table int64[n,2] of (comp_off, out_off), total_uncompressed) or
    None. Row i covers uncompressed span [out_off[i], out_off[i+1])."""
    lib = get_lib()
    if lib is None:
        return None
    cap = 4096
    while True:
        table = np.empty((cap, 2), dtype=np.int64)
        total = ctypes.c_int64(0)
        n = lib.gc_bgzf_block_table(path.encode(), table.ctypes.data, cap,
                                    ctypes.byref(total))
        if n == -2:
            cap *= 4
            continue
        if n < 0:
            return None
        return table[:n], int(total.value)


def bgzf_read_blocks(path: str, block_lo: int, block_hi: int, out_len: int):
    """Decompress blocks [block_lo, block_hi) into a fresh array."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(out_len, dtype=np.uint8)
    r = lib.gc_bgzf_read_blocks(path.encode(), block_lo, block_hi,
                                out.ctypes.data, out_len, 0)
    return out if r == 0 else None


def bgzf_read_span(path: str, file_lo: int, file_hi: int, out_len: int):
    """Decompress the blocks spanning file bytes [file_lo, file_hi)
    (block-start offsets from bgzf_block_table); reads ONLY that span
    from disk, so streaming callers' I/O stays O(span)."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(out_len, dtype=np.uint8)
    r = lib.gc_bgzf_read_span(path.encode(), file_lo, file_hi,
                              out.ctypes.data, out_len, 0)
    return out if r == 0 else None


def bam_scan(payload: np.ndarray, body_start: int):
    """Record-boundary scan. Returns int64 offsets array [n+1] (body offsets
    into payload; last entry = payload length) or None."""
    lib = get_lib()
    if lib is None:
        return None
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    cap = max(1024, len(payload) // 40)
    while True:
        offsets = np.empty(cap, dtype=np.int64)
        n = lib.gc_bam_scan(payload.ctypes.data, len(payload), body_start,
                            offsets.ctypes.data, cap)
        if n == -2:
            cap *= 2
            continue
        if n < 0:
            return None
        return offsets[:n + 1]


def bam_scan_partial(payload: np.ndarray, body_start: int):
    """Record scan that stops at a trailing partial record. Returns
    (offsets int64[n+1] with offsets[n] = consumed, consumed) or None
    (no lib / corrupt record)."""
    lib = get_lib()
    if lib is None:
        return None
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    cap = max(1024, len(payload) // 40)
    while True:
        offsets = np.empty(cap, dtype=np.int64)
        consumed = ctypes.c_int64(0)
        n = lib.gc_bam_scan_partial(payload.ctypes.data, len(payload),
                                    body_start, offsets.ctypes.data, cap,
                                    ctypes.byref(consumed))
        if n == -2:
            cap *= 2
            continue
        if n < 0:
            return None
        return offsets[:n + 1], int(consumed.value)


def assemble(src: np.ndarray, src_off: np.ndarray, src_len: np.ndarray,
             dst: np.ndarray, dst_off: np.ndarray) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    lib.gc_assemble(
        np.ascontiguousarray(src, dtype=np.uint8).ctypes.data,
        np.ascontiguousarray(src_off, dtype=np.int64).ctypes.data,
        np.ascontiguousarray(src_len, dtype=np.int64).ctypes.data,
        len(src_off), dst.ctypes.data,
        np.ascontiguousarray(dst_off, dtype=np.int64).ctypes.data)
    return True


def _c64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _c32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def gather_slices(src: np.ndarray, src_off, src_len, dst: np.ndarray, dst_off) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    so, sl, do = _c64(src_off), _c64(src_len), _c64(dst_off)
    lib.gc_gather_slices(np.ascontiguousarray(src, dtype=np.uint8).ctypes.data,
                         so.ctypes.data, sl.ctypes.data, len(so),
                         dst.ctypes.data, do.ctypes.data, 0)
    return True


def unpack_seq_rows(src: np.ndarray, src_off, lens, L: int):
    lib = get_lib()
    if lib is None:
        return None
    so, ln = _c64(src_off), _c32(lens)
    out = np.empty((len(so), L), dtype=np.uint8)
    lib.gc_unpack_seq_rows(np.ascontiguousarray(src, dtype=np.uint8).ctypes.data,
                           so.ctypes.data, ln.ctypes.data, len(so),
                           out.ctypes.data, L, 0)
    return out


def copy_rows(src: np.ndarray, src_off, lens, L: int):
    lib = get_lib()
    if lib is None:
        return None
    so, ln = _c64(src_off), _c32(lens)
    out = np.empty((len(so), L), dtype=np.uint8)
    lib.gc_copy_rows(np.ascontiguousarray(src, dtype=np.uint8).ctypes.data,
                     so.ctypes.data, ln.ctypes.data, len(so),
                     out.ctypes.data, L, 0)
    return out


def gather_rows_into(src: np.ndarray, src_off, lens, out: np.ndarray) -> bool:
    """Copy ragged byte runs into the first len(src_off) rows of `out`
    (zero-filling each row tail). `out` may have more (pre-zeroed) rows."""
    lib = get_lib()
    if lib is None:
        return False
    so, ln = _c64(src_off), _c32(lens)
    lib.gc_copy_rows(np.ascontiguousarray(src, dtype=np.uint8).ctypes.data,
                     so.ctypes.data, ln.ctypes.data, len(so),
                     out.ctypes.data, out.shape[1], 0)
    return True


def hist_rows(src: np.ndarray, src_off, lens):
    """Byte histogram over per-record runs. Returns int64[256] or None."""
    lib = get_lib()
    if lib is None:
        return None
    so, ln = _c64(src_off), _c32(lens)
    out = np.zeros(256, dtype=np.int64)
    lib.gc_hist_rows(np.ascontiguousarray(src, dtype=np.uint8).ctypes.data,
                     so.ctypes.data, ln.ctypes.data, len(so), out.ctypes.data)
    return out


def pack_nib_rows(src: np.ndarray, src_off, lens, lut: np.ndarray, pw: int,
                  out: np.ndarray | None = None, n_rows: int | None = None):
    """LUT-translate ragged byte runs and nibble-pack into [n_rows, pw]
    (zero-padded). Returns the packed matrix or None."""
    lib = get_lib()
    if lib is None:
        return None
    so, ln = _c64(src_off), _c32(lens)
    n = len(so)
    if out is None:
        out = np.zeros((n_rows or n, pw), dtype=np.uint8)
    lut = np.ascontiguousarray(lut, dtype=np.uint8)
    lib.gc_pack_nib_rows(np.ascontiguousarray(src, dtype=np.uint8).ctypes.data,
                         so.ctypes.data, ln.ctypes.data, n,
                         lut.ctypes.data, out.ctypes.data, pw, 0)
    return out


def umi_spans(qmat: np.ndarray, qlen, pset: np.ndarray, umi_ok: np.ndarray,
              mode: int):
    """Threaded UMI span scan (see gc_umi_spans). Returns (start, len)
    int64 arrays or None without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    qmat = np.ascontiguousarray(qmat, dtype=np.uint8)
    n, w = qmat.shape
    ql = np.ascontiguousarray(qlen, dtype=np.int64)
    ps = np.ascontiguousarray(pset, dtype=np.uint8)
    uo = np.ascontiguousarray(umi_ok, dtype=np.uint8)
    start = np.empty(n, dtype=np.int64)
    length = np.empty(n, dtype=np.int64)
    lib.gc_umi_spans(qmat.ctypes.data, n, w, ql.ctypes.data, ps.ctypes.data,
                     uo.ctypes.data, mode, start.ctypes.data,
                     length.ctypes.data, 0)
    return start, length


def seq_edits(packed: np.ndarray, rep_idx, lens, cap: int):
    """Threaded per-row nibble diff vs representative rows (gc_seq_edits).
    Returns (cnt u8[n], pos u8[n,cap], code u8[n,cap]) with cnt==255
    marking overflow, or None without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    n, pw = packed.shape
    rep = _c64(rep_idx)
    ln = _c32(lens)
    cnt = np.zeros(n, dtype=np.uint8)
    pos = np.zeros((n, cap), dtype=np.uint8)
    code = np.zeros((n, cap), dtype=np.uint8)
    lib.gc_seq_edits(packed.ctypes.data, n, pw, rep.ctypes.data,
                     ln.ctypes.data, cap, cnt.ctypes.data, pos.ctypes.data,
                     code.ctypes.data, 0)
    return cnt, pos, code


def qual_edits(data: np.ndarray, qual_off, lens, cap: int):
    """Threaded per-record qual base+deviation scan (gc_qual_edits).
    Returns (base u8[n], cnt u8[n], pos u8[n,cap], val u8[n,cap],
    seen u8[256] distinct-value mask) with cnt==255 marking overflow, or
    None without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    qo = _c64(qual_off)
    ln = _c32(lens)
    n = len(qo)
    base = np.zeros(n, dtype=np.uint8)
    cnt = np.zeros(n, dtype=np.uint8)
    pos = np.zeros((n, cap), dtype=np.uint8)
    val = np.zeros((n, cap), dtype=np.uint8)
    seen = np.zeros(256, dtype=np.uint8)
    lib.gc_qual_edits(np.ascontiguousarray(data, dtype=np.uint8).ctypes.data,
                      qo.ctypes.data, n, ln.ctypes.data, cap,
                      base.ctypes.data, cnt.ctypes.data, pos.ctypes.data,
                      val.ctypes.data, seen.ctypes.data, 0)
    return base, cnt, pos, val, seen


def bam_index(payload: np.ndarray, body_start: int):
    """One-pass record scan + index-column + NM extraction (gc_bam_index):
    returns (bounds int64[n+1] with bounds[n]=consumed, cols dict of
    int32 arrays tid/pos/mtid/mpos/isize/flag/l_qseq/nm) or None without
    the native lib. Stops cleanly at a trailing partial record."""
    lib = get_lib()
    if lib is None:
        return None
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    cap = max(len(payload) // 36 + 2, 16)
    while True:
        offs = np.empty(cap, dtype=np.int64)
        cols = {k: np.empty(cap, dtype=np.int32)
                for k in ("tid", "pos", "mtid", "mpos", "isize", "flag",
                          "l_qseq", "nm")}
        consumed = ctypes.c_int64(0)
        n = lib.gc_bam_index(
            payload.ctypes.data, len(payload), body_start,
            offs.ctypes.data, cap, ctypes.byref(consumed),
            *[cols[k].ctypes.data for k in ("tid", "pos", "mtid", "mpos",
                                            "isize", "flag", "l_qseq",
                                            "nm")], 0)
        if n == -2:
            cap *= 2
            continue
        if n < 0:
            return None
        bounds = offs[:n + 1].copy()
        bounds[n] = consumed.value
        return bounds, {k: v[:n] for k, v in cols.items()}


def ref_edits(packed: np.ndarray, lens, genome: np.ndarray, gpos,
              cap: int):
    """Threaded per-row nibble diff vs NT16 genome slices (gc_ref_edits).
    Returns (cnt u8[n], pos u8[n,cap], code u8[n,cap]); cnt 255 =
    overflow, 254 = ineligible (gpos<0 / out of range). None without the
    native lib."""
    lib = get_lib()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    n, pw = packed.shape
    ln = _c32(lens)
    gp = _c64(gpos)
    g = np.ascontiguousarray(genome, dtype=np.uint8)
    cnt = np.zeros(n, dtype=np.uint8)
    pos = np.zeros((n, cap), dtype=np.uint8)
    code = np.zeros((n, cap), dtype=np.uint8)
    lib.gc_ref_edits(packed.ctypes.data, n, pw, ln.ctypes.data,
                     g.ctypes.data, len(g), gp.ctypes.data, cap,
                     cnt.ctypes.data, pos.ctypes.data, code.ctypes.data, 0)
    return cnt, pos, code


def nm_extract(data: np.ndarray, aux_off, end):
    """Threaded NM tag extraction (gc_nm_extract): (vals int64[n],
    patch int64[n]) with patch = payload offset of a 1-byte 'C' value
    (-1 otherwise), or None without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    ao = _c64(aux_off)
    en = _c64(end)
    n = len(ao)
    vals = np.zeros(n, dtype=np.int64)
    patch = np.full(n, -1, dtype=np.int64)
    lib.gc_nm_extract(np.ascontiguousarray(data, np.uint8).ctypes.data,
                      ao.ctypes.data, en.ctypes.data, n, vals.ctypes.data,
                      patch.ctypes.data, 0)
    return vals, patch


def mi_flags(data: np.ndarray, aux_off, end):
    """Per-record MI:Z candidate flags via threaded memchr over aux spans
    (gc_mi_flags). Returns uint8[n] or None without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    ao = _c64(aux_off)
    en = _c64(end)
    n = len(ao)
    out = np.zeros(n, dtype=np.uint8)
    lib.gc_mi_flags(np.ascontiguousarray(data, dtype=np.uint8).ctypes.data,
                    ao.ctypes.data, en.ctypes.data, n, out.ctypes.data, 0)
    return out


def nib_seen(packed: np.ndarray, lens, n: int = None):
    """(seen256, seen16) byte/odd-tail-nibble presence masks over the
    first `n` rows of a packed nibble matrix (gc_nib_seen), or None
    without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    rows, pw = packed.shape
    if n is None:
        n = rows
    ln = _c32(lens)
    seen256 = np.zeros(256, dtype=np.uint8)
    seen16 = np.zeros(16, dtype=np.uint8)
    lib.gc_nib_seen(packed.ctypes.data, min(n, rows), pw, ln.ctypes.data,
                    seen256.ctypes.data, seen16.ctypes.data, 0)
    return seen256, seen16


def pack2_rows(packed: np.ndarray, lens, lut: np.ndarray,
               ok_full: np.ndarray, ok_odd: np.ndarray,
               out: np.ndarray) -> int:
    """Validate + LUT-map + pairwise-pack nibble rows (threaded); see
    gc_pack2_rows. Returns 1 when valid (out filled), 0 on a check
    failure, -1 without the native lib."""
    lib = get_lib()
    if lib is None:
        return -1
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    lut8 = np.ascontiguousarray(lut, dtype=np.uint8)
    okf8 = np.ascontiguousarray(ok_full, dtype=np.uint8)
    oko8 = np.ascontiguousarray(ok_odd, dtype=np.uint8)
    n, pw = packed.shape
    assert out.shape[1] == (pw + 1) // 2 and out.flags.c_contiguous
    return lib.gc_pack2_rows(
        packed.ctypes.data, n, pw, lens32.ctypes.data, lut8.ctypes.data,
        okf8.ctypes.data, oko8.ctypes.data, out.ctypes.data, 0)


def unpack_nib_dense(packed: np.ndarray, lut: np.ndarray):
    """[n, pw] packed nibbles -> [n, 2*pw] bytes via a 16-entry LUT
    (threaded). Returns None without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    lut16 = np.zeros(16, dtype=np.uint8)
    lut16[:len(lut)] = lut[:16]
    n, pw = packed.shape
    out = np.empty((n, 2 * pw), dtype=np.uint8)
    lib.gc_unpack_nib_dense(packed.ctypes.data, n, pw, lut16.ctypes.data,
                            out.ctypes.data, 0)
    return out


def pack_seq_rows(rows: np.ndarray, lens, dst: np.ndarray, dst_off) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    ln, do = _c32(lens), _c64(dst_off)
    lib.gc_pack_seq_rows(rows.ctypes.data, rows.shape[1], ln.ctypes.data,
                         len(do), dst.ctypes.data, do.ctypes.data, 0)
    return True


def fasta_scan(path: str):
    """First pass over a FASTA file (gc_fasta_scan): (kept int64[n], each
    record's sequence bytes, record 0 being what precedes the first
    header; headers, the n records' header texts as bytes, b"" for record
    0; the file's size). None without the native lib; OSError when the
    file cannot be read (FileNotFoundError where it is missing, as open()
    raises it)."""
    lib = get_lib()
    if lib is None:
        return None
    kept_p = ctypes.POINTER(ctypes.c_int64)()
    end_p = ctypes.POINTER(ctypes.c_int64)()
    names_p = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_int64(0)
    n = lib.gc_fasta_scan(path.encode(), ctypes.byref(kept_p),
                          ctypes.byref(end_p), ctypes.byref(names_p),
                          ctypes.byref(size))
    if n < 0:
        with open(path, "rb"):    # the system's own error, where it has one
            pass
        raise OSError(f"cannot read the FASTA file {path}")
    try:
        kept = np.ctypeslib.as_array(kept_p, shape=(n,)).copy()
        ends = np.ctypeslib.as_array(end_p, shape=(n,)).tolist()
        names = ctypes.string_at(names_p, ends[-1])
    finally:
        for p in (kept_p, end_p, names_p):
            lib.gc_free(p)
    starts = [0] + ends[:-1]
    return kept, [names[a:b] for a, b in zip(starts, ends)], int(size.value)


def fasta_fill(path: str, dest: np.ndarray, kept: np.ndarray,
               out: np.ndarray) -> int:
    """Second pass (gc_fasta_fill): record r's sequence bytes, upper-cased,
    into out[dest[r]:] where dest[r] >= 0. Returns the bytes read; OSError
    when the file cannot be read or no longer has the records `kept`
    counts. The native lib must be loaded."""
    dest, kept = _c64(dest), _c64(kept)
    assert out.dtype == np.uint8 and out.flags.c_contiguous
    got = get_lib().gc_fasta_fill(path.encode(), dest.ctypes.data,
                                  kept.ctypes.data, len(kept),
                                  out.ctypes.data)
    if got < 0:
        raise OSError(f"the FASTA file {path} changed while it was read")
    return int(got)


def nt16(src: np.ndarray, out: np.ndarray) -> bool:
    """out[:] = the NT16 codes of the ASCII bases `src` (gc_nt16: A, C, G,
    T to 1, 2, 4, 8, every other byte to 0), uint8 arrays of one length;
    False without the native lib."""
    lib = get_lib()
    if lib is None:
        return False
    assert (src.dtype == out.dtype == np.uint8 and len(src) == len(out)
            and src.flags.c_contiguous and out.flags.c_contiguous)
    lib.gc_nt16(src.ctypes.data, len(src), out.ctypes.data)
    return True
