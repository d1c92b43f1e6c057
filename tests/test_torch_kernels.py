"""The port's plain-torch device programs (overlap scoring, upload
reconstruction, refbase assembly, dense pulls) against the JAX package's
XLA versions on the same seeded inputs. Every comparison is exact."""

import numpy as np
import pytest
import torch

from gencore_tpu import engine as jeng
from gencore_tpu.core import kernels as jk
from gencore_tpu_torch import engine as teng
from gencore_tpu_torch.core import kernels as tk
from gencore_tpu_torch.core import vote
from gencore_tpu_torch.core.vote import to_device
from gencore_tpu_torch.tools import workloads

torch.set_num_threads(1)

SCORE_KW = dict(hi=30, mod=20, lo=15, s_hi=12, s_mod=8, s_lo=6, s_bad=4)


def _dev(*arrays):
    return [to_device(a, "cpu") for a in arrays]


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert (a == b).all()


@pytest.mark.parametrize("v", [0.8, 0.75, 0.6666667, 1.0, 0.05])
def test_ratio_fraction_matches_jax(v):
    assert tk.ratio_fraction(v) == jk.ratio_fraction(v)


def _score_rows(rng, N, L):
    codes = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
    seq = codes[rng.integers(0, 5, size=(N, L))]
    qual = rng.integers(0, 42, size=(N, L)).astype(np.uint8)
    return seq, qual


@pytest.mark.parametrize("seed,N,L", [(0, 48, 64), (1, 48, 64),
                                      (2, 300, 320), (3, 70_001, 32)])
def test_score_map_kernel_matches_jax(seed, N, L):
    """The int32 form at the engine's small shape, at L = 320 (reads past
    256 bases) and past 65,536 rows at a narrow L."""
    rng = np.random.default_rng(seed)
    seq, qual = _score_rows(rng, N, L)
    mate_row = rng.integers(0, N, size=N).astype(np.int32)
    my_start = rng.integers(0, L, size=N).astype(np.int32)
    mate_start = rng.integers(0, L, size=N).astype(np.int32)
    cmp_len = rng.integers(-5, L, size=N).astype(np.int32)
    my_len = rng.integers(1, L + 1, size=N).astype(np.int32)
    is_left = rng.random(N) < 0.5
    scored = rng.random(N) < 0.8
    args = (seq, qual, mate_row, my_start, mate_start, cmp_len, my_len,
            is_left, scored)
    want = jk.score_map_kernel(*args, **SCORE_KW)
    got = tk.score_map_kernel(*_dev(*args), **SCORE_KW)
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.uint8
    for a, b in zip(got, want):
        _eq(a, b)


def _geometry(rng, N, L):
    """Mate pairs over most rows, packed as the engine packs them (the
    port's packer is held to the JAX one)."""
    rows = rng.permutation(N)[:N // 2 * 2 - 2].reshape(-1, 2)
    lrow, rrow = rows[:, 0], rows[:, 1]
    ls = rng.integers(0, L // 2, size=len(lrow))
    rs = rng.integers(0, L // 2, size=len(lrow))
    cl = rng.integers(-3, L // 2, size=len(lrow))
    mate16, meta = jeng._pack_score_meta(N, lrow, rrow, ls, rs, cl)
    for a, b in zip(teng._pack_score_meta(N, lrow, rrow, ls, rs, cl),
                    (mate16, meta)):
        assert a.dtype == b.dtype and (a == b).all()
    return mate16, meta


@pytest.mark.parametrize("N,L", [(40, 96), (300, 320)])
def test_score_map_kernel_packed_matches_jax(N, L):
    rng = np.random.default_rng(3 + L)
    seq, qual = _score_rows(rng, N, L)
    lens = rng.integers(1, L + 1, size=N).astype(np.int32)
    mate16, meta = _geometry(rng, N, L)
    want = jk.score_map_kernel_packed(seq, qual, lens, mate16, meta,
                                      **SCORE_KW)
    got = tk.score_map_kernel_packed(*_dev(seq, qual, lens, mate16, meta),
                                     **SCORE_KW)
    for a, b in zip(got, want):
        _eq(a, b)


def _staging(rng, *, w, L, n, mode2, has_sedit, has_qdense, has_qedit,
             const_lens, has_genome):
    """Sparse upload staging with the layout _WorkArrays ships."""
    nd = 7
    bw = (w // 2 + 1) // 2 if mode2 else w // 2
    sd = rng.integers(0, 256, size=(nd, bw)).astype(np.uint8)
    if not mode2:
        nib = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
        sd = (nib[rng.integers(0, 5, size=(nd, bw))] << 4) | \
            nib[rng.integers(0, 5, size=(nd, bw))]
    sd[0] = 0
    codes = np.array([1, 2, 4, 8], dtype=np.uint8)
    genome = np.pad(codes[rng.integers(0, 4, size=3000)], (0, 4096))
    ns = 4 if has_genome else 0
    gsl = (rng.integers(0, 3000, size=ns).astype(np.int32) if has_genome
           else np.zeros(1, np.int32))
    src = rng.integers(0, nd + ns, size=n).astype(np.uint16)
    z1 = np.zeros(1, dtype=np.uint8)
    if has_sedit:
        scnt = rng.integers(0, 13, size=n).astype(np.uint8)
        E = int(scnt.sum())
        epos = rng.integers(0, w, size=E).astype(np.uint8)
        ecode = codes[rng.integers(0, 4, size=E)]
    else:
        scnt = epos = ecode = z1
    base = rng.choice(np.array([12, 30, 37], np.uint8), size=n)
    if has_qdense:
        nq = 3
        q_src = np.zeros(n, dtype=np.uint16)
        q_src[rng.choice(n, size=nq, replace=False)] = np.arange(1, nq + 1)
        qd = rng.integers(2, 41, size=(nq + 1, w)).astype(np.uint8)
    else:
        q_src = np.zeros(1, dtype=np.uint16)
        qd = np.zeros((1, 1), dtype=np.uint8)
    if has_qedit:
        qcnt = rng.integers(0, 13, size=n).astype(np.uint8)
        Eq = int(qcnt.sum())
        qpos = rng.integers(0, w, size=Eq).astype(np.uint8)
        qval = rng.integers(2, 41, size=Eq).astype(np.uint8)
    else:
        qcnt = qpos = qval = z1
    if const_lens:
        lens16 = np.array([w - 6, n - 3], dtype=np.int32)
    else:
        lens16 = rng.integers(0, w + 1, size=n).astype(np.uint16)
    return (sd, src, scnt, epos, ecode, base, q_src, qd, qcnt, qpos, qval,
            lens16), genome, gsl


UPLOAD_CASES = [
    # mode2, has_genome, has_sedit, has_qdense, has_qedit, const_lens, no_ov,
    # edges: workloads.upload_staging's inputs (a non-zero reserved row,
    # repeated edit positions in a row, positions >= w, rows without
    # edits, a row of more edits than are applied, rows of length 0,
    # overlaps that wrap past L, unscored rows), at an odd width
    (True, True, True, True, True, True, False, False),
    (False, False, False, True, False, False, True, False),
    (True, False, True, False, True, False, True, False),
    (False, True, False, False, True, True, False, False),
] + [(m2, g, True, True, True, cl, no, True)
     for m2 in (False, True) for g in (False, True) for no in (False, True)
     for cl in ((False, True) if (m2, g, no) == (True, True, False)
                else (m2 != g,))]


@pytest.mark.parametrize("case", UPLOAD_CASES)
def test_upload_score_fn_matches_jax(case):
    (mode2, has_genome, has_sedit, has_qdense, has_qedit, const_lens, no_ov,
     edges) = case
    rng = np.random.default_rng(sum((1 << i) * v for i, v in enumerate(case)))
    w, L, n = (37, 64, 60) if edges else (40, 64, 30)
    if edges:
        *staging, mate16, meta, genome, gsl = workloads.upload_staging(
            rng, n, w, L, mode2=mode2, has_sedit=has_sedit,
            has_qdense=has_qdense, has_qedit=has_qedit,
            const_lens=const_lens, has_genome=has_genome, no_overlap=no_ov)
        staging = tuple(staging)
    else:
        staging, genome, gsl = _staging(
            rng, w=w, L=L, n=n, mode2=mode2, has_sedit=has_sedit,
            has_qdense=has_qdense, has_qedit=has_qedit,
            const_lens=const_lens, has_genome=has_genome)
        if no_ov:
            mate16 = np.zeros(1, dtype=np.uint16)
            meta = np.packbits(rng.random(n) < 0.6, bitorder="little")
        else:
            mate16, meta = _geometry(rng, n, w)
    g = genome if has_genome else np.zeros(1, np.uint8)
    sk = SCORE_KW
    static = (w, L, mode2, has_sedit, has_qdense, has_qedit, const_lens,
              sk["hi"], sk["mod"], sk["lo"], sk["s_hi"], sk["s_mod"],
              sk["s_lo"], sk["s_bad"], has_genome, no_ov)
    args = (*staging, mate16, meta, g, gsl)
    want = jeng._upload_score_fn(*static)(*args)
    got = teng._upload_score_fn(*static)(*_dev(*args))
    for a, b in zip(got, want):
        _eq(a, b)
    # the standalone upload program shares the reconstruction
    want_up = jeng._upload_sparse_fn(*static[:7], has_genome)(*staging, g, gsl)
    got_up = teng._upload_sparse_fn(*static[:7], has_genome)(
        *_dev(*staging, g, gsl))
    for a, b in zip(got_up, want_up):
        _eq(a, b)


# (mode2, has_sedit, has_qdense, has_qedit, const_lens, has_genome,
#  no_overlap) of the windows past 65,536 rows: the deep panel's flags,
# with no_overlap, 4-bit rows with dense quals and without edits, 4-bit
# rows with edits and genome rows, 2-bit rows without edits or genome
U32_CASES = [(True, True, False, True, True, True, False),
             (True, True, False, True, True, True, True),
             (False, False, True, False, False, False, False),
             (False, True, True, True, False, True, True),
             (True, False, False, False, True, False, False)]


@pytest.mark.parametrize("case", U32_CASES)
def test_upload_score_u32_mates_match_jax_nondeferred(case):
    """Past 65,536 rows the engine ships u32 mate rows (mate32) to the
    upload-and-score program, where the JAX engine takes its non-deferred
    route: _upload_sparse_fn, then score_map_kernel with int32 mate rows
    and geometry. The twin equals that pair byte for byte (70,001 rows of
    width 32; edits, genome slots and overlaps as workloads.upload_staging
    makes them)."""
    flags = dict(zip(tk.UPLOAD_FLAGS, case + (True,)))
    rng = np.random.default_rng(70_001 + sum(1 << i for i, v in
                                             enumerate(case) if v))
    n, w, L = 70_001, 32, 32
    *staging, mate, meta, genome, gsl = workloads.upload_staging(
        rng, n, w, L, **flags)
    assert mate.dtype == np.uint32
    g = genome if flags["has_genome"] else np.zeros(1, np.uint8)
    sk = SCORE_KW
    static = (w, L, flags["mode2"], flags["has_sedit"], flags["has_qdense"],
              flags["has_qedit"], flags["const_lens"], sk["hi"], sk["mod"],
              sk["lo"], sk["s_hi"], sk["s_mod"], sk["s_lo"], sk["s_bad"],
              flags["has_genome"], flags["no_overlap"], True)
    got = teng._upload_score_fn(*static)(*_dev(*staging, mate, meta, g, gsl))
    seq, qual, lens = jeng._upload_sparse_fn(*static[:7], flags["has_genome"])(
        *staging, g, gsl)
    if flags["no_overlap"]:
        scored = np.unpackbits(meta, bitorder="little")[:n].astype(bool)
        mate_row = np.arange(n, dtype=np.int32)
        geo = np.zeros((3, n), dtype=np.int32)
        is_left = np.zeros(n, dtype=bool)
    else:
        m = meta.astype(np.int64)
        mate_row = mate.astype(np.int32)
        geo = np.stack([m & 0xFF, (m >> 8) & 0xFF, (m >> 16) & 0x1FF]
                       ).astype(np.int32)
        is_left = ((m >> 25) & 1).astype(bool)
        scored = ((m >> 26) & 1).astype(bool)
    score, qual2 = jk.score_map_kernel(seq, qual, mate_row, *geo, lens,
                                       is_left, scored, **SCORE_KW)
    for a, b in zip(got, (seq, qual2, score)):
        _eq(a, b)


@pytest.mark.parametrize("seq_mode,qual_mode", [
    ("2bit", "2bit"), ("4bit", "4bit"), ("4bit", "raw"), ("2bit", "raw")])
@pytest.mark.parametrize("w,L,n", [(34, 64, 20), (304, 320, 40)])
def test_upload_unpack_fn_matches_jax(seq_mode, qual_mode, w, L, n):
    rng = np.random.default_rng(len(seq_mode + qual_mode) + w)
    pw = w // 2
    ow = (pw + 1) // 2
    seq_up = rng.integers(0, 256, size=(n, ow if seq_mode == "2bit" else pw)
                          ).astype(np.uint8)
    if qual_mode == "raw":
        qual_up = rng.integers(0, 42, size=(n, w)).astype(np.uint8)
    else:
        qual_up = rng.integers(0, 256, size=(n, ow if qual_mode == "2bit"
                                             else pw)).astype(np.uint8)
    lens = rng.integers(0, w + 1, size=n).astype(np.int32)
    qtable = np.zeros(16, dtype=np.uint8)
    qtable[1:16] = rng.integers(2, 42, size=15)
    args = (seq_up, qual_up, lens, qtable)
    want = jeng._upload_unpack_fn(w, L, qual_mode, seq_mode)(*args)
    got = teng._upload_unpack_fn(w, L, qual_mode, seq_mode)(*_dev(*args))
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("seq_mode,qual_mode", [("2bit", "raw"),
                                                ("4bit", "4bit")])
def test_dense_staging_unpack_matches_jax(seq_mode, qual_mode):
    """workloads.dense_staging's edges (lengths 0, odd, w and past w; a
    qual table entry 0 that is never decoded) at the 2x300 width."""
    w, L = 304, 320
    args = workloads.dense_staging(np.random.default_rng(9), 300, w,
                                   seq_mode, qual_mode)
    want = jeng._upload_unpack_fn(w, L, qual_mode, seq_mode)(*args)
    got = teng._upload_unpack_fn(w, L, qual_mode, seq_mode)(*_dev(*args))
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("packed", [True, False])
def test_score_geometry_matches_jax(packed):
    """workloads.score_geometry's edges (self, clamped and negative mate
    rows, negative cmp_len, ties) through both packages' score maps."""
    N, L = 500, 320
    args = workloads.score_geometry(np.random.default_rng(10), N, L, packed)
    if packed:
        jargs = (*args[:4], args[4].astype(np.uint32))
        want = jk.score_map_kernel_packed(*jargs, **SCORE_KW)
        got = tk.score_map_kernel_packed(*_dev(*args), **SCORE_KW)
    else:
        # negative mate rows: the port clamps them to row 0 (as the
        # kernel does), where JAX's gather would count from the end
        jargs = list(args)
        jargs[2] = np.maximum(args[2], 0)
        jargs[7:9] = [a.astype(bool) for a in args[7:9]]
        want = jk.score_map_kernel(*jargs, **SCORE_KW)
        got = tk.score_map_kernel(*_dev(*args), **SCORE_KW)
    for a, b in zip(got, want):
        _eq(a, b)


def test_dense_entries_cpu_use_twins(monkeypatch):
    """On CPU tensors the dense route's entry points run their plain
    twins and never reach a kernel wrapper; the wrappers refuse CPU
    tensors with nothing launched."""
    def no_kernel(*a, **k):
        raise AssertionError("a kernel wrapper ran on CPU tensors")

    calls = []
    for mod, name in ((teng, "_upload_unpack_plain"),
                      (tk, "score_map_plain"),
                      (tk, "score_map_packed_plain")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    monkeypatch.setattr(tk, "upload_unpack", no_kernel)
    monkeypatch.setattr(tk, "score_map", no_kernel)
    rng = np.random.default_rng(4)
    stag = workloads.dense_staging(rng, 30, 40, "2bit", "raw")
    teng._upload_unpack_fn(40, 64, "raw", "2bit")(*_dev(*stag))
    packed = workloads.score_geometry(rng, 30, 64, True)
    tk.score_map_kernel_packed(*_dev(*packed), **SCORE_KW)
    geo = workloads.score_geometry(rng, 30, 64, False)
    tk.score_map_kernel(*_dev(*geo), **SCORE_KW)
    assert calls == ["_upload_unpack_plain", "score_map_packed_plain",
                     "score_map_plain", "score_map_plain"]
    monkeypatch.undo()
    n0 = (tk.UPLOAD_UNPACK_LAUNCHES, tk.SCORE_MAP_LAUNCHES)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.upload_unpack(*_dev(*stag), w=40, L=64, seq_mode="2bit",
                         qual_mode="raw")
    s, q, ml, mate, meta = _dev(*packed)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.score_map(s, q, mate, ml, meta=meta, **SCORE_KW)
    assert (tk.UPLOAD_UNPACK_LAUNCHES, tk.SCORE_MAP_LAUNCHES) == n0


def test_upload_score_plain_never_reaches_kernel_entries(monkeypatch):
    """engine._upload_score_plain, csrc/upload_score.cu's twin, scores
    through the plain score map: neither the dispatching entry points nor
    the kernel wrapper of csrc/upload_dense.cu take part, so the twin the
    kernel is held to stays plain on the card too."""
    def no_entry(*a, **k):
        raise AssertionError("the twin reached a kernel entry point")

    for name in ("score_map_kernel_packed", "score_map_kernel", "score_map"):
        monkeypatch.setattr(tk, name, no_entry)
    rng = np.random.default_rng(12)
    n, w, L = 200, 40, 64
    flags = dict(zip(tk.UPLOAD_FLAGS, (True, True, False, True, False,
                                       False, False, False)))
    *staging, mate, meta, genome, gsl = workloads.upload_staging(
        rng, n, w, L, **flags)
    static = (w, L, True, True, False, True, False, *SCORE_KW.values(),
              False, False, False)
    seq, qual, score = teng._upload_score_plain(*static)(
        *_dev(*staging, mate, meta, np.zeros(1, np.uint8), gsl))
    assert score.shape == (n, L) and score.dtype == torch.int8


def test_refbase_combine_matches_jax():
    rng = np.random.default_rng(11)
    L, J = 64, 25
    genome = np.pad(rng.choice(np.array([1, 2, 4, 8], np.uint8), size=500),
                    (0, 4096))
    gpos = rng.integers(0, 500, size=J).astype(np.int32)
    gpos[:2] = len(genome) - 5          # clamped slice start
    # negative starts count once from the genome's end (as
    # jax.lax.dynamic_slice takes them), then clamp: inside the genome,
    # before its end by less than L, and still negative (clamps to 0)
    gpos[2:5] = (-3000, -5, -2 * len(genome))
    hr = rng.choice(np.array([0, 1, 2, 4, 8], np.uint8), size=(5, L))
    hm = rng.integers(-1, 7, size=J).astype(np.int16)   # 5, 6 clamp
    jl = rng.integers(0, L + 1, size=J).astype(np.uint16)
    args = (genome, gpos, hr, hm, jl)
    want = jeng._refbase_combine_fn(L)(*args)
    I32 = torch.int32
    got = vote.refbase_combine(
        to_device(genome, "cpu"), to_device(gpos, "cpu", I32),
        to_device(hr, "cpu"), to_device(hm, "cpu", I32),
        to_device(jl, "cpu", I32), L)
    _eq(got, want)


def test_pull_dense_and_gathers_match_jax():
    rng = np.random.default_rng(12)
    pseq = rng.integers(0, 256, size=(30, 20)).astype(np.uint8)
    qual = rng.integers(0, 42, size=(30, 40)).astype(np.uint8)
    idx = np.array([3, 0, 29, 31, 7], dtype=np.int32)   # 31 clamps
    _eq(teng._pull_dense_fn()(*_dev(pseq, qual, idx)),
        jeng._pull_dense_fn()(pseq, qual, idx))
    score = rng.integers(-3, 13, size=(30, 40)).astype(np.int8)
    q_t, s_t = teng._pull_rows(*_dev(qual, score), to_device(idx, "cpu"))
    _eq(q_t, qual[np.clip(idx, 0, 29)])
    _eq(s_t, score[np.clip(idx, 0, 29)])


def _fused_vote_inputs(rng, J, K, L, N, full_bins):
    """Members of all 16 nt16 codes (or =ACGTN) with stored 255s, lenDiff
    shifts, absent members, job lengths below L and jobs without a
    reference base."""
    codes = (np.arange(16, dtype=np.uint8) if full_bins
             else np.array([0, 1, 2, 4, 8, 15], dtype=np.uint8))
    seq = codes[rng.integers(0, len(codes), size=(N, L))]
    seq[rng.random((N, L)) < 0.02] = 255
    qual = rng.choice(np.array([0, 2, 12, 18, 25, 30, 36, 41], np.uint8),
                      size=(N, L))
    score = rng.integers(-4, 13, size=(N, L)).astype(np.int8)
    rows = rng.integers(0, N, size=(J, K)).astype(np.int32)
    shifts = np.where(rng.random((J, K)) < 0.3,
                      rng.integers(0, 12, size=(J, K)), 0).astype(np.int32)
    valid = rng.random((J, K)) < 0.8
    valid[::5, 0] = False
    valid[3] = False                       # a job with no member at all
    job_len = rng.integers(0, L + 1, size=J).astype(np.int32)
    job_len[::4] = L
    refbase = np.array([0, 1, 2, 4, 8, 3, 5], np.uint8)[
        rng.integers(0, 7, size=(J, L))]
    refbase[::3] = 0                       # jobs without a reference base
    # job 1 rolls back: its template matches the reference everywhere and
    # every other member votes for another base with high quality
    refbase[1] = 4
    rows[1] = [0] + [1] * (K - 1)
    shifts[1] = 0
    valid[1] = True
    job_len[1] = L
    seq[0], qual[0], score[0] = 4, 12, 8
    seq[1], qual[1], score[1] = 2, 41, 12
    return seq, qual, score, rows, shifts, valid, job_len, refbase


VOTE_KW = dict(hi=30, mod=20, lo=15, base_score_req=6, ratio_num=4,
               ratio_den=5)


@pytest.mark.parametrize("full_bins", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_vote_kernel_matches_jax(seed, full_bins):
    """The port's fused_vote_kernel (plain version on the CPU) equals the
    JAX function exactly, for both bin sets."""
    rng = np.random.default_rng(40 + seed)
    J, K, L, N = 37, [3, 8, 16][seed], 48, 200
    args = _fused_vote_inputs(rng, J, K, L, N, full_bins)
    kw = dict(VOTE_KW, full_bins=full_bins)
    if seed == 2:      # the ratio test wraps in int32 on both sides
        kw.update(ratio_num=999_983, ratio_den=1_000_003)
    want = jk.fused_vote_kernel(*args, **kw)
    got = tk.fused_vote_kernel(*_dev(*args), **kw)
    assert [g.dtype for g in got] == [torch.uint8, torch.uint8, torch.int32,
                                      torch.int32]
    for a, b in zip(got, want):
        _eq(a, b)
    # job 1 rolls back; other jobs change positions
    assert np.asarray(want[3])[1] > 5
    assert (np.asarray(want[2]) > 0).sum() > 1


@pytest.mark.parametrize("full_bins", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vote_core_matches_jax(seed, full_bins):
    """_vote_core on pre-gathered [J, K, L] members equals the JAX
    consensus_kernel (the same core) exactly."""
    rng = np.random.default_rng(60 + seed)
    J, K, L = 21, [1, 5, 12][seed], 40
    seq, qual, score, rows, _sh, valid, job_len, refbase = _fused_vote_inputs(
        rng, J, K, L, J * K, full_bins)
    gseq = seq[rows % len(seq)].reshape(J, K, L)
    gqual = qual[rows % len(qual)].reshape(J, K, L)
    gscore = score[rows % len(score)].reshape(J, K, L).astype(np.int32)
    pos_valid = np.arange(L)[None, :] < job_len[:, None]
    args = (gseq, gqual, gscore, valid, pos_valid, refbase)
    th = (30, 20, 15, 6, 4, 5)
    want = jk.consensus_kernel(*args, hi=30, mod=20, lo=15, base_score_req=6,
                               ratio_num=4, ratio_den=5, full_bins=full_bins)
    got = tk._vote_core(*_dev(*args), *th, full_bins)
    for a, b in zip(got, want):
        _eq(a, b)


# tiers that wrap the int8 cast, reach outside the byte range (a threshold
# above 255 never reached, one at or below 0 always) or are unordered
EDGE_TIERS = [
    dict(hi=30, mod=20, lo=15, s_hi=126, s_mod=-127, s_lo=127, s_bad=-3),
    dict(hi=300, mod=0, lo=-4, s_hi=9, s_mod=1000, s_lo=-200, s_bad=5),
    dict(hi=15, mod=30, lo=20, s_hi=3, s_mod=-9, s_lo=7, s_bad=255)]


@pytest.mark.parametrize("tiers", range(len(EDGE_TIERS)))
@pytest.mark.parametrize("packed", [True, False])
def test_score_geometry_tiers_match_jax(packed, tiers):
    """The twins against the JAX score maps with the edge tiers, on
    workloads.score_geometry's mate-pair edges at a row count that is no
    multiple of a warp's or a block's batch."""
    kw = EDGE_TIERS[tiers]
    N, L = 301, 160
    args = workloads.score_geometry(np.random.default_rng(20 + tiers), N,
                                    L, packed)
    if packed:
        jargs = (*args[:4], args[4].astype(np.uint32))
        want = jk.score_map_kernel_packed(*jargs, **kw)
        got = tk.score_map_kernel_packed(*_dev(*args), **kw)
    else:
        jargs = list(args)
        jargs[2] = np.maximum(args[2], 0)
        jargs[7:9] = [a.astype(bool) for a in args[7:9]]
        want = jk.score_map_kernel(*jargs, **kw)
        got = tk.score_map_kernel(*_dev(*args), **kw)
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("seq_mode,qual_mode", [
    ("2bit", "2bit"), ("2bit", "4bit"), ("4bit", "raw")])
@pytest.mark.parametrize("w", [8, 34, 152])
def test_dense_staging_edge_widths_match_jax(w, seq_mode, qual_mode):
    """workloads.dense_staging at widths whose 2-bit rows (2, 9 and 38
    bytes) are no multiple of a word, so that most rows start off one, at
    a row count that is no multiple of a block's tasks."""
    L = -(-w // 32) * 32
    args = workloads.dense_staging(np.random.default_rng(30 + w), 1001, w,
                                   seq_mode, qual_mode)
    want = jeng._upload_unpack_fn(w, L, qual_mode, seq_mode)(*args)
    got = teng._upload_unpack_fn(w, L, qual_mode, seq_mode)(*_dev(*args))
    for a, b in zip(got, want):
        _eq(a, b)
