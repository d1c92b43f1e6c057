"""The port's vote (gencore_tpu_torch.core.vote) against the JAX package's
Pallas vote, run in interpret mode on the CPU as tests/test_pallas_vote.py
runs it. On CPU tensors the port runs the kernel's plain twin; every
comparison is exact (all vote math is int32)."""

import numpy as np
import pytest
import torch

from gencore_tpu.core import pallas_vote as jpv
from gencore_tpu_torch.core import vote
from tests.test_pallas_vote import _batch

torch.set_num_threads(1)

KW = dict(hi=30, mod=20, lo=15, base_score_req=6, ratio_num=4, ratio_den=5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_core(seq, qual, score, valid, refbase):
    """vote_core over pre-gathered [K, J, L] members via the [K*J, L] view
    with rows k*J + j."""
    K, J, L = seq.shape
    rows = (np.arange(K, dtype=np.int32)[:, None] * J
            + np.arange(J, dtype=np.int32)[None, :])
    return vote.vote_core(_t(seq.reshape(K * J, L)), _t(qual.reshape(K * J, L)),
                          _t(score.reshape(K * J, L)), _t(rows),
                          _t(valid.astype(np.uint8)), _t(refbase), **KW)


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


def _window_inputs(rng, L, out_len, classes):
    """Device matrices, genome and per-class args shaped as the engine
    ships them to _pallas_window_all."""
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
    hr = codes[:5][rng.integers(0, 5, size=(6, L))]
    hr[0] = 0
    hm = rng.integers(-1, 6, size=nj).astype(np.int16)
    jp = rng.integers(0, out_len + 1, size=nj).astype(np.uint16)
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


@pytest.mark.parametrize("with_qtable", [False, True])
def test_window_program_matches_jax(with_qtable):
    rng = np.random.default_rng(7 + with_qtable)
    L, out_len = 128, 104
    classes = ((4, 16), (16, 8))
    tjs = tuple(min(max(8, min(32, 1024 // K)), j2) for K, j2 in classes)
    (seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp,
     class_args) = _window_inputs(rng, L, out_len, classes)
    qtable = None
    if with_qtable:
        qtable = np.zeros(16, dtype=np.uint8)
        qtable[1:8] = [5, 6, 7, 12, 18, 25, 30]   # 37 and diffs escape
    kw = dict(classes=classes, L=L, out_len=out_len, **KW)
    flat_j, ref_j, dense_j = jpv._pallas_window_all(
        seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp, qtable,
        *class_args, tjs=tjs, interpret=True, **kw)
    flat_t, ref_t, dense_t = vote.pallas_vote_window(
        _t(seq_dev), _t(qual_dev), _t(score_dev), _t(genome), gp, hr, hm, jp,
        qtable, class_args, **kw)
    assert flat_t.dtype == torch.uint8
    assert (ref_t.numpy() == np.asarray(ref_j)).all()
    assert flat_t.numpy().tobytes() == np.asarray(flat_j).tobytes()
    for (ps_t, q_t), (ps_j, q_j) in zip(dense_t, dense_j):
        assert (ps_t.numpy() == np.asarray(ps_j)).all()
        assert (q_t.numpy() == np.asarray(q_j)).all()


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


@pytest.mark.parametrize("mode", ["dense", "sparse", "sparse_qtable"])
def test_gathered_matches_jax(mode):
    rng = np.random.default_rng(21)
    K, J, L, out_len = 8, 16, 128, 120
    (seq_dev, qual_dev, score_dev, rows_t, row0, valid, job_len,
     refbase) = _gathered_inputs(rng, K, J, L)
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
    for a, b in zip(got[:4], want[:4]):
        assert (a.numpy() == np.asarray(b)).all()
    if sparse:
        for k, (a, b) in enumerate(zip(got[4], want[4])):
            assert a.numpy().dtype == np.asarray(b).dtype, k
            assert (a.numpy() == np.asarray(b)).all(), k


@pytest.mark.parametrize("trial", range(2))
def test_pregathered_matches_jax(trial):
    rng = np.random.default_rng(40 + trial)
    K, S, L = 5, 8, 128
    seq, qual, score, valid, job_len, refbase = _batch(
        rng, S, K, L, with_ref=trial == 0, neg=True)
    kw = dict(out_len=96, **KW)
    want = jpv.pallas_vote(seq, qual, score, valid, job_len, refbase, tj=8,
                           interpret=True, **kw)
    got = vote.pallas_vote(seq, qual, score, valid, job_len, refbase, **kw)
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
    flat, _ref, dense = vote.pallas_vote_window(
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


@pytest.mark.parametrize("K,J,want", [(4, 8, 1), (64, 8, 1), (128, 8, 4),
                                      (512, 8, 16), (2048, 26, 16),
                                      (512, 128, 4), (4096, 4096, 1)])
def test_split_size(K, J, want):
    """CTAs per job for csrc/vote.cu: one for buckets of K <= 64 or enough
    jobs to fill two waves of the card, else a power of two up to 16 that
    leaves each CTA >= 32 members."""
    assert vote.split_size(K, J) == want
