"""The port's vote (gencore_tpu_torch.core.vote) against the JAX package's
Pallas vote, run in interpret mode on the CPU as tests/test_pallas_vote.py
runs it. On CPU tensors the port runs the kernels' plain twins; every
comparison is exact (all vote math is int32, tolerance 0). Also the host
side of the kernel wrappers: the window kernel's one upload and the
argument checks each wrapper makes before it launches."""

import numpy as np
import pytest
import torch

from gencore_tpu import engine as jeng
from gencore_tpu.core import pallas_vote as jpv
from gencore_tpu_torch.core import vote
from tests.test_pallas_vote import _batch

torch.set_num_threads(1)

KW = dict(hi=30, mod=20, lo=15, base_score_req=6, ratio_num=4, ratio_den=5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


TH = dict(hi=KW["hi"], mod=KW["mod"], lo=KW["lo"], bsr=KW["base_score_req"],
          rnum=KW["ratio_num"], rden=KW["ratio_den"])


def _port_core(seq, qual, score, valid, refbase):
    """vote_core_plain over pre-gathered [K, J, L] members via the [K*J, L]
    view with rows k*J + j."""
    K, J, L = seq.shape
    rows = (np.arange(K, dtype=np.int32)[:, None] * J
            + np.arange(J, dtype=np.int32)[None, :])
    return vote.vote_core_plain(
        _t(seq.reshape(K * J, L)), _t(qual.reshape(K * J, L)),
        _t(score.reshape(K * J, L)), _t(rows), _t(valid.astype(np.uint8)),
        _t(refbase), **TH)


@pytest.mark.parametrize("K", [1, 3, 16])
@pytest.mark.parametrize("variant", ["ref", "noref", "neg_invalid0"])
def test_vote_core_plain_matches_pallas_core(K, variant):
    rng = np.random.default_rng(100 + K)
    J, L = 16, 128
    seq, qual, score, valid, job_len, refbase = _batch(
        rng, J, K, L, with_ref=variant != "noref", neg=variant != "ref")
    if variant == "neg_invalid0":
        # absent templates and stored sentinel bases
        valid[0, ::5] = False
        seq[rng.random(seq.shape) < 0.02] = vote.SENTINEL
    want = jpv._pallas_stage(seq, qual, score, refbase, valid, tj=8,
                             interpret=True, **KW)
    got = _port_core(seq, qual, score, valid, refbase)
    for a, b, name in zip(got, want, ("cseq", "cqual", "chg", "minc")):
        assert a.dtype == torch.int32, name
        assert (a.numpy() == np.asarray(b)).all(), (K, variant, name)


def _window_inputs(rng, L, out_len, classes, refs="mixed"):
    """Device matrices, genome and per-class args shaped as the engine
    ships them to _pallas_window_all. `refs` picks the refbase sources:
    "mixed" genome slices (starts past the end clamp) and host rows;
    "host_rows" host rows only, some indices past the last row (they
    clamp); "genome_rows" genome slices only, starts clamped at both ends
    and lengths below L; "one_host_row" a single all-zero host row."""
    n_pad = 300
    codes = np.array([0, 1, 2, 4, 8, 15], dtype=np.uint8)
    seq_dev = codes[rng.integers(0, 6, size=(n_pad, L))]
    seq_dev[:, out_len:] = 0
    qual_dev = rng.choice(np.array([0, 12, 18, 25, 30, 37], np.uint8),
                          size=(n_pad, L))
    score_dev = rng.integers(-3, 13, size=(n_pad, L)).astype(np.int8)
    genome = np.pad(codes[1:5][rng.integers(0, 4, size=5000)], (0, 4096))
    nj = sum(j2 for _, j2 in classes)
    gp = rng.integers(0, 5000, size=nj).astype(np.int32)
    gp[:3] = len(genome) - L + 7   # starts past the end clamp
    nh = 1 if refs == "one_host_row" else 6
    hr = codes[:5][rng.integers(0, 5, size=(nh, L))]
    hr[0] = 0
    hm = rng.integers(-1, nh, size=nj).astype(np.int16)
    jp = rng.integers(0, out_len + 1, size=nj).astype(np.uint16)
    if refs == "host_rows":
        hm = rng.integers(0, nh + 3, size=nj).astype(np.int16)
    elif refs == "genome_rows":
        hm[:] = -1
        # negative starts count once from the end (dynamic_slice), then clamp
        gp[3:7] = [-7, -1, 0, -len(genome) - 9]
        jp = rng.integers(0, L // 2, size=nj).astype(np.uint16)
        jp[::4] = L
    elif refs == "one_host_row":
        hm = rng.integers(-1, 3, size=nj).astype(np.int16)
    class_args = []
    for K, J2 in classes:
        J = J2 - 3                 # real jobs; the tail is padding
        base_row = np.full(J2, n_pad - 1, dtype=np.uint16)
        base_row[:J] = rng.integers(0, n_pad - K, size=J)
        counts = np.zeros(J2, dtype=np.uint8)
        counts[:J] = rng.integers(1, K + 1, size=J)
        jl = np.zeros(J2, dtype=np.uint16)
        jl[:J] = rng.integers(1, out_len + 1, size=J)
        ridx = np.zeros(J2, dtype=np.uint16)
        ridx[:J] = rng.integers(0, nj, size=J)
        class_args.extend((base_row, counts, jl, ridx))
    return (seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp,
            class_args)


def _window_vs_jax(seed, with_qtable, refs="mixed"):
    """pallas_vote_window on CPU tensors against _pallas_window_all in
    interpret mode: the wire buffer and the dense fallbacks, byte for
    byte, and the refbase rows its twin votes with (refbase_combine)
    against the JAX program's refbase_dev."""
    rng = np.random.default_rng(seed)
    L, out_len = 128, 104
    classes = ((4, 16), (16, 8))
    tjs = tuple(min(max(8, min(32, 1024 // K)), j2) for K, j2 in classes)
    (seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp,
     class_args) = _window_inputs(rng, L, out_len, classes, refs)
    qtable = None
    if with_qtable:
        qtable = np.zeros(16, dtype=np.uint8)
        qtable[1:8] = [5, 6, 7, 12, 18, 25, 30]   # 37 and diffs escape
    kw = dict(classes=classes, L=L, out_len=out_len, **KW)
    flat_j, ref_j, dense_j = jpv._pallas_window_all(
        seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp, qtable,
        *class_args, tjs=tjs, interpret=True, **kw)
    flat_t, dense_t = vote.pallas_vote_window(
        _t(seq_dev), _t(qual_dev), _t(score_dev), _t(genome), gp, hr, hm, jp,
        qtable, class_args, **kw)
    cpu, I32 = torch.device("cpu"), torch.int32
    ref_t = vote.refbase_combine(
        _t(genome), vote.to_device(gp, cpu, I32), _t(hr),
        vote.to_device(hm, cpu, I32), vote.to_device(jp, cpu, I32), L)
    assert flat_t.dtype == torch.uint8
    assert ref_t.dtype == torch.uint8 and ref_t.shape == (len(gp), L)
    assert (ref_t.numpy() == np.asarray(ref_j)).all()
    assert flat_t.numpy().tobytes() == np.asarray(flat_j).tobytes()
    for (ps_t, q_t), (ps_j, q_j) in zip(dense_t, dense_j):
        assert (ps_t.numpy() == np.asarray(ps_j)).all()
        assert (q_t.numpy() == np.asarray(q_j)).all()
    return ref_t.numpy(), hm, jp


@pytest.mark.parametrize("with_qtable", [False, True])
def test_window_program_matches_jax(with_qtable):
    _window_vs_jax(7 + with_qtable, with_qtable)


@pytest.mark.parametrize("refs", ["host_rows", "genome_rows",
                                  "one_host_row"])
def test_window_refbase_matches_jax(refs):
    """The refbase assembly the window kernel does in its own blocks, held
    by its twin to the JAX program: host rows only (indices clamp),
    genome slices only (starts clamp at both ends, zero beyond the job
    length) and a single host row."""
    ref, hm, jp = _window_vs_jax(50 + len(refs), True, refs)
    if refs == "genome_rows":
        short = np.nonzero(jp < 128)[0]
        assert len(short) and not ref[short[0], jp[short[0]]:].any()
    if refs == "one_host_row":
        assert not ref[hm >= 0].any()


def _gathered_inputs(rng, K, J, L):
    """Device matrices of K*J rows and member rows drawn from [0, 200):
    rows past the matrix clamp, as a JAX gather clamps them."""
    n_pad = 200
    seq, qual, score, valid, job_len, refbase = _batch(rng, J, K, L,
                                                       neg=True)
    seq_dev = seq.reshape(K * J, L)[:n_pad].copy()
    qual_dev = qual.reshape(K * J, L)[:n_pad].copy()
    score_dev = score.reshape(K * J, L)[:n_pad].copy()
    rows_t = rng.integers(0, n_pad, size=(K, J)).astype(np.int32)
    row0 = np.ascontiguousarray(rows_t[0])
    return seq_dev, qual_dev, score_dev, rows_t, row0, valid, job_len, refbase


def _gathered_vs_jax(seed, mode, variant="base"):
    """pallas_vote_gathered on CPU tensors against the JAX function in
    interpret mode, every output and encoded field exact. `variant`:
    "base"; "invalid0" absent members 0 (the vote's template is then the
    sentinel, the epilogue's the raw row) and stored sentinel bases;
    "short" an output length of half of L."""
    rng = np.random.default_rng(seed)
    K, J, L = 8, 16, 128
    out_len = 64 if variant == "short" else 120
    (seq_dev, qual_dev, score_dev, rows_t, row0, valid, job_len,
     refbase) = _gathered_inputs(rng, K, J, L)
    if variant == "invalid0":
        valid[0, ::3] = False
        seq_dev[rng.random(seq_dev.shape) < 0.02] = vote.SENTINEL
    assert (rows_t >= len(seq_dev)).any()       # rows past the matrix
    qtable = None
    if mode == "sparse_qtable":
        qtable = np.zeros(16, dtype=np.uint8)
        qtable[1:15] = np.arange(3, 45, 3)
    sparse = mode != "dense"
    kw = dict(out_len=out_len, sparse=sparse, **KW)
    want = jpv.pallas_vote_gathered(seq_dev, qual_dev, score_dev, rows_t,
                                    row0, valid, job_len, refbase, qtable,
                                    tj=8, interpret=True, **kw)
    got = vote.pallas_vote_gathered(_t(seq_dev), _t(qual_dev), _t(score_dev),
                                    rows_t, row0, valid, job_len, refbase,
                                    qtable, **kw)
    assert len(got) == len(want)
    for a, b in zip(got[:4], want[:4]):
        assert a.numpy().dtype == np.asarray(b).dtype
        assert (a.numpy() == np.asarray(b)).all()
    if sparse:
        for k, (a, b) in enumerate(zip(got[4], want[4])):
            assert a.numpy().dtype == np.asarray(b).dtype, k
            assert a.shape == np.asarray(b).shape, k
            assert (a.numpy() == np.asarray(b)).all(), k


@pytest.mark.parametrize("mode", ["dense", "sparse", "sparse_qtable"])
def test_gathered_matches_jax(mode):
    _gathered_vs_jax(21, mode)


@pytest.mark.parametrize("mode,variant", [
    ("dense", "invalid0"), ("sparse_qtable", "invalid0"),
    ("sparse", "short"), ("sparse_qtable", "short")])
def test_gathered_variants_match_jax(mode, variant):
    _gathered_vs_jax(60 + len(mode) + len(variant), mode, variant)


def _refsrc_inputs(rng, J, L, case):
    """A window's refbase sources as engine._refbase_host_args makes them
    (genome NT16-coded and padded as _genome_dev pads it, hm int16, jp
    u16) and a bucket's refbase row per job, ridx, in the window's
    numbering. `case`: "mixed" genome slices and host rows; "genome"
    slices only; "host_rows" host rows only, some indices past the last
    row (they clamp); "zero_len" slices of length 0 among the rest;
    "edge_starts" starts negative (counted once from the end) and past
    the end (they clamp); "ridx_order" rows repeated, unsorted and past
    the window's (they clamp)."""
    codes = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
    genome = np.pad(codes[rng.integers(0, 5, size=3000)], (0, 4096))
    Jw = J + 9
    nh = 5
    gp = rng.integers(0, 3000, size=Jw).astype(np.int32)
    hr = codes[rng.integers(0, 5, size=(nh, L))]
    hr[0] = 0
    hm = rng.integers(-1, nh, size=Jw).astype(np.int16)
    jp = rng.integers(1, L + 1, size=Jw).astype(np.uint16)
    ridx = rng.permutation(Jw)[:J].astype(np.int32)
    if case == "genome":
        hm[:] = -1
    elif case == "host_rows":
        hm = rng.integers(0, nh + 3, size=Jw).astype(np.int16)
    elif case == "zero_len":
        hm[::2] = -1
        jp[::3] = 0
    elif case == "edge_starts":
        hm[:] = -1
        edges = [-7, -1, len(genome) - L + 9, -len(genome) - 5, 0,
                 len(genome) + 40]
        gp[:len(edges)] = edges
        ridx[:len(edges)] = np.arange(len(edges))
    elif case == "ridx_order":
        ridx = rng.integers(0, Jw + 4, size=J).astype(np.int32)
        ridx[1::4] = ridx[0]
    return genome, gp, hr, hm, jp, ridx


def _refsrc_vs_jax(seed, case, L, mode, K, J):
    """pallas_vote_gathered with its refbase rows named by index in the
    window's sources (vote.window_refsrc), run by its plain twin on CPU
    tensors, against the JAX pallas_vote_gathered in interpret mode fed
    the JAX engine's refbase assembly and row gather
    (_refbase_combine_fn, _gather_one): every output and encoded field
    exact."""
    rng = np.random.default_rng(seed)
    (seq_dev, qual_dev, score_dev, rows_t, row0, valid, job_len,
     _rb) = _gathered_inputs(rng, K, J, L)
    genome, gp, hr, hm, jp, ridx = _refsrc_inputs(rng, J, L, case)
    table = np.array(jeng._refbase_combine_fn(L)(genome, gp, hr, hm, jp))
    refbase = np.asarray(jeng._gather_one(table, ridx))
    if case == "zero_len":
        r = np.clip(ridx, 0, len(gp) - 1)
        assert not refbase[(hm[r] < 0) & (jp[r] == 0)].any()
    qtable = None
    if mode == "sparse_qtable":
        qtable = np.zeros(16, dtype=np.uint8)
        qtable[1:15] = np.arange(3, 45, 3)
    kw = dict(out_len=min(L - 16, 256) if mode != "dense" else L - 16,
              sparse=mode != "dense", **KW)
    want = jpv.pallas_vote_gathered(seq_dev, qual_dev, score_dev, rows_t,
                                    row0, valid, job_len, refbase, qtable,
                                    tj=8, interpret=True, **kw)
    refsrc = (*vote.window_refsrc(_t(genome), gp, hm, jp, hr), ridx)
    got = vote.pallas_vote_gathered(_t(seq_dev), _t(qual_dev), _t(score_dev),
                                    rows_t, row0, valid, job_len, None,
                                    qtable, refsrc=refsrc, **kw)
    assert len(got) == len(want)
    for a, b in zip(got[:4], want[:4]):
        assert a.numpy().dtype == np.asarray(b).dtype
        assert (a.numpy() == np.asarray(b)).all()
    if kw["sparse"]:
        for k, (a, b) in enumerate(zip(got[4], want[4])):
            assert a.shape == np.asarray(b).shape, k
            assert (a.numpy() == np.asarray(b)).all(), k


@pytest.mark.parametrize("case,L,mode,K,J", [
    ("genome", 160, "dense", 8, 16),
    ("host_rows", 160, "sparse", 8, 16),
    ("zero_len", 160, "sparse_qtable", 8, 16),
    ("edge_starts", 160, "dense", 8, 16),
    ("ridx_order", 160, "sparse", 8, 16),
    ("mixed", 160, "sparse_qtable", 8, 16),
    ("mixed", 320, "dense", 8, 8),
    ("edge_starts", 320, "dense", 8, 8),
    ("mixed", 160, "sparse_qtable", 96, 8),
    ("ridx_order", 160, "dense", 96, 8)])
def test_gathered_refsrc_matches_jax(case, L, mode, K, J):
    """The source form at L = 160 and 320, dense and sparse, and at a
    bucket the kernel splits (K = 96, J = 8: split 2; the others split
    1)."""
    assert (vote.split_size(K, J) > 1) == (K > 64)
    _refsrc_vs_jax(107 + K + J + L + len(case), case, L, mode, K, J)


def test_pack_parts_layout():
    """A bucket's host arrays in one buffer, each at a 16-byte aligned
    offset in the dtype pallas_vote_gathered casts it to (bool and u16
    widened; values cast to int32 must fit), as the gathered entry's one
    pinned copy (vote.pinned_parts) sends them."""
    rows = np.arange(12, dtype=np.int64).reshape(3, 4).T
    valid = np.array([[True, False, True]] * 4)
    jl = np.array([5, 6, 7], dtype=np.uint16)
    qt = np.arange(16, dtype=np.uint8)
    host = [vote._host_as("f", a, dt) for a, dt in (
        (rows, np.int32), (valid, np.uint8), (jl, np.int32),
        (qt, np.uint8))]
    buf, offs = vote.pack_parts([np.ascontiguousarray(a) for a in host])
    assert offs == [0, 48, 64, 80] and len(buf) == 96
    assert (buf[:48].view(np.int32).reshape(4, 3) == rows).all()
    assert (buf[48:60] == valid.astype(np.uint8).reshape(-1)).all()
    assert (buf[64:76].view(np.int32) == [5, 6, 7]).all()
    assert (buf[80:] == qt).all()
    assert [a.dtype for a in host] == [np.int32, np.uint8, np.int32,
                                       np.uint8]
    with pytest.raises(ValueError, match="does not fit int32"):
        vote._host_as("f", np.array([2**31], dtype=np.int64), np.int32)


def _shifted_block(rng, K, S, L):
    """Host-gathered [K, S, L] members as engine._vote_pallas builds them
    for lenDiff-shifted jobs: absent members all sentinel with zero qual
    and score, present ones shifted left by d with zeros at the tail."""
    codes = np.array([1, 2, 4, 8], dtype=np.uint8)
    seq = np.full((K, S, L), vote.SENTINEL, dtype=np.uint8)
    qual = np.zeros((K, S, L), dtype=np.uint8)
    score = np.zeros((K, S, L), dtype=np.int8)
    valid = rng.random((K, S)) < 0.75
    valid[0, ::3] = False
    base = codes[rng.integers(0, 4, size=(S, L))]
    for k in range(K):
        for j in range(S):
            if not valid[k, j]:
                continue
            d = int(rng.integers(0, 9))
            row = np.where(rng.random(L) < 0.05, codes[rng.integers(0, 4)],
                           base[j])
            seq[k, j, :L - d] = row[d:]
            seq[k, j, L - d:] = 0
            qual[k, j, :L - d] = rng.integers(2, 42, size=L - d)
            score[k, j, :L - d] = rng.integers(-3, 13, size=L - d)
    job_len = rng.integers(L // 2, L + 1, size=S).astype(np.int32)
    refbase = np.where(rng.random((S, L)) < 0.2, 0,
                       codes[rng.integers(0, 4, size=(S, L))]).astype(np.uint8)
    return seq, qual, score, valid, job_len, refbase


@pytest.mark.parametrize("trial", range(3))
def test_pregathered_matches_jax(trial):
    rng = np.random.default_rng(40 + trial)
    K, S, L = 5, 8, 128
    if trial < 2:
        seq, qual, score, valid, job_len, refbase = _batch(
            rng, S, K, L, with_ref=trial == 0, neg=True)
    else:   # the lenDiff-shifted jobs the engine re-gathers on the host
        seq, qual, score, valid, job_len, refbase = _shifted_block(
            rng, K, S, L)
    kw = dict(out_len=96, **KW)
    want = jpv.pallas_vote(seq, qual, score, valid, job_len, refbase, tj=8,
                           interpret=True, **kw)
    got = vote.pallas_vote(seq, qual, score, valid, job_len, refbase, **kw)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert (a.numpy() == np.asarray(b)).all()


@pytest.mark.parametrize("case", ["zero", "negative", "past_end",
                                  "in_range", "host_rows"])
def test_shifted_refsrc_matches_jax(case):
    """pallas_vote (the lenDiff-shifted jobs' host-gathered block) with
    its refbase rows named by index in the window's sources, as the
    engine hands them (the genome NT16-coded and padded as _genome_dev
    pads it, hm int16, jp u16), run by its plain twin, against the JAX
    pallas_vote in interpret mode fed the JAX engine's refbase assembly
    and row gather: starts of 0, negative (counted once from the padded
    end), past the end (clamped) and in range, job lengths 0..L; and host
    rows, indices past the rows (clamped). Exact."""
    rng = np.random.default_rng(70 + len(case))
    K, S, L, G0, Jw = 4, 16, 128, 3000, 30
    seq, qual, score, valid, job_len, _rb = _shifted_block(rng, K, S, L)
    codes = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
    genome = np.pad(codes[rng.integers(0, 5, size=G0)], (0, 4096))
    G = len(genome)
    gp = {"zero": np.zeros(Jw), "negative": -rng.integers(1, 2 * G, size=Jw),
          "past_end": G0 - rng.integers(-G, L, size=Jw),
          "in_range": rng.integers(0, G0 - L, size=Jw),
          "host_rows": rng.integers(0, G0, size=Jw)}[case].astype(np.int32)
    hr = codes[rng.integers(0, 5, size=(6, L))]
    hm = np.full(Jw, -1, dtype=np.int16)
    if case == "host_rows":
        hm = rng.integers(-1, 9, size=Jw).astype(np.int16)
    jp = rng.integers(0, L + 1, size=Jw).astype(np.uint16)
    jp[:3] = (0, L, 1)
    ridx = rng.permutation(Jw)[:S].astype(np.int32)
    ridx[:3] = (0, 1, 2)
    table = np.array(jeng._refbase_combine_fn(L)(genome, gp, hr, hm, jp))
    refbase = np.asarray(jeng._gather_one(table, ridx))
    kw = dict(out_len=96, **KW)
    want = jpv.pallas_vote(seq, qual, score, valid, job_len, refbase, tj=8,
                           interpret=True, **kw)
    refsrc = (*vote.window_refsrc(_t(genome), gp, hm, jp, hr), ridx)
    got = vote.pallas_vote(seq, qual, score, valid, job_len, None,
                           refsrc=refsrc, **kw)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert (a.numpy() == np.asarray(b)).all()


def test_epilogue_first_index_semantics():
    """Edit/run positions follow jnp.argmax (first maximum, 0 when the row
    has none) — checked directly on the sparse encoding."""
    J, L = 3, 16
    seq0 = torch.zeros((J, L), dtype=torch.uint8)
    cseq = torch.zeros((J, L), dtype=torch.int32)
    cseq[1, 5] = 4
    cseq[2, [2, 9]] = 8
    cqual = torch.full((J, L), 30, dtype=torch.int32)
    cqual[2, 4:] = 12
    zero = torch.zeros((J, L), dtype=torch.int32)
    jl = torch.full((J,), L, dtype=torch.int32)
    enc = vote._epilogue_core(cseq, cqual, (cseq != 0).to(torch.int32), zero,
                              seq0, cqual[:, :1].expand(J, L).to(torch.uint8),
                              jl, sparse=True)[4]
    qv, qs, nr, sp, sb, nd = (e.numpy() for e in enc[:6])
    assert list(nd) == [0, 1, 2]
    assert list(sp[0]) == [0, 0, 0, 0]
    assert list(sp[1]) == [5, 0, 0, 0]
    assert list(sp[2]) == [2, 9, 0, 0]
    assert list(nr) == [1, 1, 2]
    assert list(qs[2][:3]) == [0, 4, 0]
    assert list(qv[2][:3]) == [30, 12, 30]


@pytest.mark.parametrize("with_qtable", [False, True])
def test_window_kernel_host_side(with_qtable):
    """What the fused window kernel's wrapper computes on the host: the
    buffer size it allocates equals the plain composition's, and its job
    table lists every class's jobs in order, counts clipped to [0, K]."""
    rng = np.random.default_rng(30 + with_qtable)
    L, out_len = 128, 104
    classes = ((4, 16), (16, 8), (256, 5))
    (seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp,
     class_args) = _window_inputs(rng, L, out_len, classes)
    class_args[1] = class_args[1].copy()
    class_args[1][0] = 9          # more members than the class holds
    class_args[9][0] = 255        # uint8 counts of the 256 class
    qtable = np.arange(16, dtype=np.uint8) if with_qtable else None
    flat, dense = vote.pallas_vote_window(
        _t(seq_dev), _t(qual_dev), _t(score_dev), _t(genome), gp, hr, hm, jp,
        qtable, class_args, classes=classes, L=L, out_len=out_len, **KW)
    assert flat.numel() == vote.wire_size(29, len(classes), qtable)
    assert [d[0].shape for d in dense] == [(16, 52), (8, 52), (5, 52)]
    tab = vote.window_job_table(class_args, classes)
    assert tab.dtype == np.int32 and tab.shape == (6, 29)
    assert list(tab[4]) == [0] * 16 + [1] * 8 + [2] * 5
    assert list(tab[5]) == [4] * 16 + [16] * 8 + [256] * 5
    assert tab[1, 0] == 4 and tab[1, 24] == 255
    assert (tab[0, 16:24] == class_args[4]).all()
    assert (tab[2, 16:24] == class_args[6]).all()
    assert (tab[3, 16:24] == class_args[7]).all()
    with pytest.raises(ValueError, match="class 1 needs 9 jobs"):
        vote.window_job_table(class_args, ((4, 16), (16, 9), (256, 5)))

    # the kernel's one upload: job table, gp, hm, jp as int32, the qual
    # table, then 16-byte aligned the host rows
    Jw = len(gp)
    buf, lay = vote.window_upload(class_args, classes, gp, hm, jp, qtable,
                                  hr)
    assert lay == vote.window_upload_layout(
        29, Jw, 0 if qtable is None else 16, hr.nbytes)
    assert buf.dtype == np.uint8 and buf.size == lay["size"]
    assert [lay[k] for k in ("jobs", "gp", "hm", "jp", "qtable")] == [
        0, 24 * 29, 24 * 29 + 4 * Jw, 24 * 29 + 8 * Jw, 24 * 29 + 12 * Jw]
    assert lay["hr"] % 16 == 0
    assert lay["qtable"] + (16 if qtable is not None else 0) <= lay["hr"]
    assert lay["hr"] < lay["qtable"] + (16 if qtable is not None else 0) + 16
    assert lay["size"] == lay["hr"] + hr.nbytes
    ints = buf[:lay["qtable"]].view(np.int32)
    assert (ints[:6 * 29].reshape(6, 29) == tab).all()
    for k, a in (("gp", gp), ("hm", hm), ("jp", jp)):
        got = ints[lay[k] // 4:lay[k] // 4 + len(a)]
        assert (got == a.astype(np.int64)).all(), k
    assert (hm < 0).any() and (ints[lay["hm"] // 4:][:Jw] < 0).any()
    if qtable is not None:
        assert buf[lay["qtable"]:lay["qtable"] + 16].tobytes() == \
            qtable.tobytes()
    assert buf[lay["hr"]:].tobytes() == hr.tobytes()
    # host rows that lie on the device stay out of the upload
    small, slay = vote.window_upload(class_args, classes, gp, hm, jp, qtable)
    assert slay["size"] == lay["hr"] and small.size == slay["size"]
    assert small.tobytes() == buf.tobytes()[:lay["hr"]]
    # the buffer is alloc's, of exactly the size
    got = []
    pinned, _ = vote.window_upload(
        class_args, classes, gp, hm, jp, qtable, hr,
        alloc=lambda n: got.append(np.zeros(n, np.uint8)) or got[0])
    assert pinned is got[0] and pinned.tobytes() == buf.tobytes()
    with pytest.raises(ValueError, match="one entry per job"):
        vote.window_upload(class_args, classes, gp, hm[:-1], jp)
    with pytest.raises(ValueError, match="gp does not fit int32"):
        vote.window_upload(class_args, classes, gp.astype(np.int64) + 2**31,
                           hm, jp)


def _gathered_args(K=4, J=6, L=32, N=40):
    g = torch.Generator().manual_seed(0)
    seq = torch.randint(0, 16, (N, L), generator=g, dtype=torch.uint8)
    return dict(seq_src=seq, qual_src=seq.clone(),
                score_src=seq.to(torch.int8),
                rows=torch.zeros((K, J), dtype=torch.int32),
                row0=torch.zeros(J, dtype=torch.int32),
                valid=torch.ones((K, J), dtype=torch.uint8),
                job_len=torch.full((J,), L, dtype=torch.int32),
                refbase=torch.zeros((J, L), dtype=torch.uint8))


@pytest.mark.parametrize("change,err,match", [
    (dict(score_src=torch.zeros((40, 32), dtype=torch.int32)), TypeError,
     "score_src is torch.int32"),
    (dict(rows=torch.zeros((6, 4), dtype=torch.int32).t()), ValueError,
     "rows is not contiguous"),
    (dict(valid=torch.ones((4, 5), dtype=torch.uint8)), ValueError,
     "valid has shape"),
    (dict(row0=torch.zeros(5, dtype=torch.int32)), ValueError,
     "row0 has shape"),
    (dict(job_len=torch.zeros(6, dtype=torch.int64)), TypeError,
     "job_len is torch.int64"),
    (dict(qtable=torch.zeros(15, dtype=torch.uint8)), ValueError,
     "qtable has shape"),
    (dict(out_len=31), ValueError, "must be even"),
    (dict(), ValueError, "needs CUDA tensors")])
def test_gathered_kernel_checks_arguments(change, err, match):
    """What vote_gathered checks before it launches csrc/vote.cu; valid
    arguments on the CPU reach the device check (the kernel runs on CUDA
    tensors only)."""
    args = _gathered_args()
    kw = dict(KW)
    for k, v in change.items():
        (kw if k == "out_len" else args)[k] = v
    with pytest.raises(err, match=match):
        vote.vote_gathered(**args, **kw)
    # the plain twin takes the same valid arguments
    if not change:
        out = vote.vote_gathered_plain(**_gathered_args(), sparse=True, **KW)
        assert [tuple(t.shape) for t in out[4]] == [
            (6, 10), (6, 10), (6,), (6, 4), (6, 2), (6,), (6,), (6,), ()]
    with pytest.raises(ValueError, match="<= 256"):
        a = _gathered_args(L=320)
        vote.vote_gathered(**a, sparse=True, **KW)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        a = _gathered_args()
        vote.vote_core(a["seq_src"], a["qual_src"], a["score_src"],
                       a["rows"], a["valid"], a["refbase"], **KW)


@pytest.mark.parametrize("form,err,match", [
    ("both", ValueError, "refbase and refsrc both given"),
    ("parts", ValueError, "got 2 parts"),
    ("ridx_i64", TypeError, "ridx is torch.int64"),
    ("hr_width", ValueError, "hr has shape"),
    ("short_genome", ValueError, "at least L=32 bases"),
    ("no_host_row", ValueError, r"a host row \(0\)"),
    ("hm_i16", TypeError, "hm is torch.int16"),
    ("ok_sources", ValueError, "needs CUDA tensors")])
def test_gathered_kernel_checks_refsrc(form, err, match):
    """What vote_gathered checks of the refbase source form before it
    launches; a valid form on the CPU reaches the device check, and the
    plain twin takes it."""
    args = _gathered_args()
    J, L = args["refbase"].shape
    I32 = torch.int32
    ridx = torch.arange(J, dtype=I32)
    src = [torch.zeros(L + 5, dtype=torch.uint8),
           torch.zeros(J + 2, dtype=I32), torch.full((J + 2,), -1, dtype=I32),
           torch.full((J + 2,), L, dtype=I32),
           torch.zeros((1, L), dtype=torch.uint8), ridx]
    refbase = None
    refsrc = list(src)
    if form == "both":
        refbase = args["refbase"]
    elif form == "parts":
        refsrc = [torch.zeros((J + 2, L), dtype=torch.uint8), ridx]
    elif form == "ridx_i64":
        refsrc[5] = ridx.long()
    elif form == "hr_width":
        refsrc[4] = torch.zeros((1, 16), dtype=torch.uint8)
    elif form == "short_genome":
        refsrc[0] = src[0][:L - 1]
    elif form == "no_host_row":
        refsrc[4] = torch.zeros((0, L), dtype=torch.uint8)
    elif form == "hm_i16":
        refsrc[2] = src[2].short()
    args["refbase"] = refbase
    with pytest.raises(err, match=match):
        vote.vote_gathered(**args, refsrc=tuple(refsrc), **KW)
    if form.startswith("ok"):
        out = vote.vote_gathered_plain(**args, refsrc=tuple(refsrc), **KW)
        assert out[0].shape == (J, L // 2)


def test_window_kernel_checks_arguments():
    """What vote_window checks before it uploads and launches; valid
    arguments on the CPU reach the device check."""
    rng = np.random.default_rng(9)
    L, out_len = 128, 104
    classes = ((4, 16),)
    (seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp,
     class_args) = _window_inputs(rng, L, out_len, classes)
    mats = [_t(seq_dev), _t(qual_dev), _t(score_dev)]
    kw = dict(classes=classes, L=L, out_len=out_len, **KW)

    def call(mats=mats, genome=_t(genome), gp=gp, hr=hr, hm=hm, **over):
        return vote.vote_window(*mats, genome, gp, hr, hm, jp, None,
                                class_args, **{**kw, **over})

    with pytest.raises(ValueError, match="needs CUDA tensors"):
        call()
    with pytest.raises(TypeError, match="score_dev is torch.uint8"):
        call(mats=[mats[0], mats[1], mats[0]])
    with pytest.raises(ValueError, match="multiple of 16"):
        call(mats=[m[:, :120].contiguous() for m in mats], L=120,
             out_len=120)
    with pytest.raises(ValueError, match="shorter than"):
        call(genome=_t(genome[:100]))
    with pytest.raises(ValueError, match="hr has shape"):
        call(hr=hr[:, :64])
    with pytest.raises(ValueError, match="one entry per job"):
        call(hm=hm[:-1])
    with pytest.raises(ValueError, match="must be even"):
        call(out_len=103)


@pytest.mark.parametrize("K,J,want", [(4, 8, 1), (64, 8, 1), (128, 8, 4),
                                      (512, 8, 16), (2048, 26, 16),
                                      (512, 128, 4), (4096, 4096, 1)])
def test_split_size(K, J, want):
    """CTAs per job for csrc/vote.cu: one for buckets of K <= 64 or enough
    jobs to fill two waves of the card, else a power of two up to 16 that
    leaves each CTA >= 32 members."""
    assert vote.split_size(K, J) == want
