"""Tests of the CUDA vote kernels: they need an NVIDIA card and skip
elsewhere. Run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py imports JAX, which a CUDA-only install lacks.)

Each kernel is held to its plain twin on the same inputs with 0
mismatches (csrc/vote.cu's gathered entry, Bins6 with the epilogue, to
vote_gathered_plain; its vote alone to vote_core_plain; its Bins16
instantiation to kernels.fused_vote_plain; csrc/vote_window.cu to
vote_window_plain, byte for byte), and the engine on CUDA to the oracle.
The gathered entry's refbase source form (each job's row read by index
where it lies, in the window's sources sent up by vote.window_refsrc) is
held to vote_gathered_plain fed vote.refbase_rows. The upload-and-score kernel
(csrc/upload_score.cu) is held to its twin engine._upload_score_plain on
the CPU, and the dense route's
unpack and score map (csrc/upload_dense.cu) to engine._upload_unpack_plain
and kernels.score_map_plain / score_map_packed_plain, byte for byte, with
the edges of their designs: mate pairs taken once, third-row and clamped
mates, tiers outside the byte range, rows off a word or a granule."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from gencore_tpu_torch.core import kernels, vote

pytestmark = pytest.mark.cuda

KW = dict(hi=30, mod=20, lo=15, base_score_req=6, ratio_num=4, ratio_den=5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the vote kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _members(rng, K, J, L, N):
    codes = np.array([0, 1, 2, 4, 8, 15, vote.SENTINEL], dtype=np.uint8)
    seq = codes[rng.choice(7, size=(N, L), p=[.05, .22, .22, .22, .22, .05,
                                              .02])]
    qual = rng.integers(0, 42, size=(N, L)).astype(np.uint8)
    score = rng.integers(-4, 13, size=(N, L)).astype(np.int8)
    rows = rng.integers(-2, N + 2, size=(K, J)).astype(np.int32)  # clamps
    valid = (rng.random((K, J)) < 0.85).astype(np.uint8)
    valid[0, ::7] = 0
    refbase = np.array([0, 1, 2, 4, 8], np.uint8)[
        rng.integers(0, 5, size=(J, L))]
    refbase[::5] = 0
    return seq, qual, score, rows, valid, refbase


TH = dict(hi=KW["hi"], mod=KW["mod"], lo=KW["lo"], bsr=KW["base_score_req"],
          rnum=KW["ratio_num"], rden=KW["ratio_den"])

# (K, J, L): K not a multiple of the per-CTA slice or of the 8-member
# stage (255, 2047), 16 CTAs per job (K = 2048 at J = 8), J = 4096 with
# one CTA per job, L above one 256-position tile
SHAPES = [(1, 300, 160), (4, 4096, 160), (16, 300, 160), (64, 300, 160),
          (255, 8, 160), (256, 1, 160), (256, 300, 160), (2047, 8, 160),
          (2048, 8, 160), (2048, 1, 96), (300, 5, 320)]


@pytest.mark.parametrize("K,J,L", SHAPES)
def test_vote_kernel_matches_twin(cuda, K, J, L):
    rng = np.random.default_rng(K + J + L)
    N = min(K * J, 20000) + 50
    arrs = _members(rng, K, J, L, N)
    valid = arrs[4]
    valid[:, 1::17] = 0                 # jobs with every member absent
    cpu = [torch.from_numpy(a) for a in arrs]
    gpu = [t.to(cuda) for t in cpu]
    n0 = vote.VOTE_ONLY_LAUNCHES
    got = vote.vote_core(*gpu, **KW)
    torch.cuda.synchronize(cuda)
    assert vote.VOTE_ONLY_LAUNCHES == n0 + 1
    want = vote.vote_core_plain(*gpu, **TH)
    for a, b in zip(got, want):
        assert int((a != b).sum()) == 0


def _qtable():
    """A qual table with escapes (41, 42+) and a value listed twice (the
    last matching index wins)."""
    qt = np.zeros(16, dtype=np.uint8)
    qt[1:8] = [2, 7, 12, 18, 25, 30, 36]
    qt[11] = 30
    return qt


def _gathered_case(rng, K, J, L, mode):
    """Members as _members makes them plus the epilogue's inputs: template
    rows row0 (some past the matrix: they clamp), job lengths 0..L and,
    for `mode`, the output length and qual table."""
    N = min(K * J, 20000) + 50
    seq, qual, score, rows, valid, refbase = _members(rng, K, J, L, N)
    valid[:, 1::17] = 0                 # jobs with every member absent
    row0 = rows[0].copy()
    row0[::9] = N + 3
    job_len = rng.integers(0, L + 1, size=J).astype(np.int32)
    job_len[::4] = L
    sparse = mode != "dense"
    out_len = L if not sparse else min(L, 256) - 8
    qtable = _qtable() if mode == "sparse_qtable" else None
    args = (seq, qual, score, rows, row0, valid, job_len, refbase, qtable)
    return args, dict(out_len=out_len, sparse=sparse)


def _equal_outputs(got, want):
    """Every output and encoded field equal, dtype and shape included."""
    flat_g = list(got[:4]) + list(got[4] if len(got) > 4 else ())
    flat_w = list(want[:4]) + list(want[4] if len(want) > 4 else ())
    assert len(flat_g) == len(flat_w)
    for i, (a, b) in enumerate(zip(flat_g, flat_w)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a.cpu(), b.cpu()), i


# (K, J, L, mode): every shape of SHAPES (one CTA per job up to K = 64,
# splits of 2..16 above, tiles past 256 positions) and K = 4096, each
# mode on small and split shapes
GATHERED = ([(K, J, L, m) for (K, J, L), m in zip(
    SHAPES + [(4096, 8, 160), (4096, 32, 160)],
    ["dense", "sparse", "sparse_qtable"] * 5)]
    + [(16, 300, 160, "dense"), (16, 300, 160, "sparse"),
       (512, 128, 160, "sparse_qtable"), (2048, 8, 160, "dense"),
       (4096, 32, 160, "sparse"),
       (300, 5, 320, "sparse_qtable")])


@pytest.mark.parametrize("K,J,L,mode", GATHERED)
def test_vote_gathered_kernel_matches_twin(cuda, K, J, L, mode):
    """csrc/vote.cu's gathered entry (vote and epilogue in one launch, one
    or several CTAs per job) against vote_core_plain + _epilogue_core on
    the card, every output byte."""
    rng = np.random.default_rng(11 * K + J + L + len(mode))
    args, kw = _gathered_case(rng, K, J, L, mode)
    gpu = [None if a is None else torch.from_numpy(a).to(cuda) for a in args]
    gpu[5] = gpu[5].to(torch.uint8)
    n0 = vote.LAUNCHES
    got = vote.vote_gathered(*gpu, **KW, **kw)
    torch.cuda.synchronize(cuda)
    assert vote.LAUNCHES == n0 + 1
    want = vote.vote_gathered_plain(*gpu, **KW, **kw)
    _equal_outputs(got, want)
    if mode == "sparse_qtable":   # escapes happened, and were counted
        assert int(want[4][8]) > 0


def _full_members(rng, K, J, L, N):
    """The K9 inputs [J, K]: all 16 nt16 codes, stored 255s, shifts,
    clamped row indices, absent members, job lengths below L."""
    seq = rng.integers(0, 16, size=(N, L)).astype(np.uint8)
    seq[rng.random((N, L)) < 0.02] = 255
    qual = rng.integers(0, 42, size=(N, L)).astype(np.uint8)
    score = rng.integers(-4, 13, size=(N, L)).astype(np.int8)
    rows = rng.integers(-2, N + 2, size=(J, K)).astype(np.int32)
    shifts = np.where(rng.random((J, K)) < 0.3,
                      rng.integers(0, 20, size=(J, K)), 0).astype(np.int32)
    valid = rng.random((J, K)) < 0.85
    valid[::7, 0] = False
    valid[1::17] = False
    job_len = rng.integers(0, L + 1, size=J).astype(np.int32)
    job_len[::3] = L
    refbase = np.array([0, 1, 2, 4, 8, 5, 12], np.uint8)[
        rng.integers(0, 7, size=(J, L))]
    refbase[::5] = 0
    return seq, qual, score, rows, shifts, valid, job_len, refbase


@pytest.mark.parametrize("K,J,L", SHAPES)
def test_vote_full_kernel_matches_twin(cuda, K, J, L):
    """The Bins16 instantiation (kernels.fused_vote_kernel on CUDA tensors)
    against its plain twin on the card."""
    rng = np.random.default_rng(7 + K + J + L)
    N = min(K * J, 20000) + 50
    gpu = [torch.from_numpy(a).to(cuda)
           for a in _full_members(rng, K, J, L, N)]
    n0 = vote.FULL_LAUNCHES
    got = kernels.fused_vote_kernel(*gpu, **KW, full_bins=True)
    torch.cuda.synchronize(cuda)
    assert vote.FULL_LAUNCHES == n0 + 1
    want = kernels.fused_vote_plain(*gpu, **KW, full_bins=True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="full_bins=True"):
        kernels.fused_vote_kernel(*gpu, **KW, full_bins=False)


def test_vote_kernel_rejects_bad_inputs(cuda):
    rng = np.random.default_rng(0)
    seq, qual, score, rows, valid, refbase = (
        torch.from_numpy(a).to(cuda) for a in _members(rng, 4, 8, 32, 50))
    with pytest.raises(TypeError):
        vote.vote_core(seq, qual, score.to(torch.int32), rows, valid,
                       refbase, **KW)
    with pytest.raises(ValueError):
        vote.vote_core(seq, qual, score, rows.t(), valid, refbase, **KW)


def test_epilogue_cuda_matches_cpu(cuda):
    """The epilogue fused in csrc/vote.cu (rollback, nibble packing, the
    sparse encoding with argmax-first edit and run positions and the qual
    table) equals the plain epilogue on the CPU: the gathered entry on the
    card against vote_gathered_plain on CPU copies, with piles whose
    members mostly agree (few edits, long qual runs) and rollbacks."""
    rng = np.random.default_rng(5)
    K, J, L = 6, 200, 160
    N = K * J
    codes = np.array([1, 2, 4, 8], np.uint8)
    base = codes[rng.integers(0, 4, size=(J, L))]
    seq = np.repeat(base, K, axis=0)
    seq[rng.random((N, L)) < 0.03] = 15
    qual = rng.choice(np.array([12, 30, 37, 41], np.uint8), size=(N, 1))
    qual = np.repeat(qual, L, axis=1)
    qual[rng.random((N, L)) < 0.02] = 18
    score = rng.integers(-2, 13, size=(N, L)).astype(np.int8)
    rows = (np.arange(J)[None, :] * K + np.arange(K)[:, None]).astype(np.int32)
    row0 = rows[0].copy()
    valid = (rng.random((K, J)) < 0.9).astype(np.uint8)
    job_len = rng.integers(1, L + 1, size=J).astype(np.int32)
    refbase = np.where(rng.random((J, L)) < 0.5, base,
                       codes[rng.integers(0, 4, size=(J, L))]).astype(np.uint8)
    refbase[::7] = 0
    # every fifth job: the template equals the reference and the other
    # members agree on 20 other bases, so the vote changes 20 positions
    # that matched the reference (minc = 20 > 5) and the row rolls back
    for j in range(0, J, 5):
        at = rng.choice(L, size=20, replace=False)
        seq[rows[0, j]] = refbase[j] = base[j]
        valid[:, j] = 1
        for k in range(1, K):
            seq[rows[k, j], at] = codes[(np.searchsorted(codes, base[j, at])
                                         + 1) % 4]
            qual[rows[k, j]] = 37
        job_len[j] = L
    cpu = [torch.from_numpy(a) for a in (seq, qual, score, rows, row0, valid,
                                         job_len, refbase, _qtable())]
    res = []
    for kw in (dict(out_len=152, sparse=True), dict(out_len=L)):
        want = vote.vote_gathered_plain(*cpu, **KW, **kw)
        got = vote.vote_gathered(*[t.to(cuda) for t in cpu], **KW, **kw)
        _equal_outputs(got, want)
        res.append(want)
    assert (res[0][3][::5] > 5).all()       # the planted rows rolled back
    nd = res[0][4][5]
    assert (nd > 0).any() and (nd > 4).any()    # edits, some past the slots


def test_kernel_launch_rejects_bad_arguments(cuda):
    """The C entries refuse what they cannot take (cudaErrorInvalidValue)
    and the wrappers raise on a failed launch."""
    rng = np.random.default_rng(1)
    args, kw = _gathered_case(rng, 8, 16, 160, "sparse")
    gpu = [None if a is None else torch.from_numpy(a).to(cuda) for a in args]
    gpu[5] = gpu[5].to(torch.uint8)
    lib = vote.build_library()
    outs = [torch.empty(n, dtype=torch.uint8, device=cuda)
            for n in (16 * 80, 16 * 160, 64, 64)]
    ptrs = [None if t is None else t.data_ptr()
            for t in gpu[:8] + [None] * 6 + gpu[8:] + outs]
    th = [30, 20, 15, 6, 4, 5]
    for ol in (3, 0, 320):   # odd, too short, longer than L
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            vote._launch("gc_vote_epilogue", lib.gc_vote_epilogue,
                         ptrs + [None] * 9,
                         [8, 16, 160, len(args[0]), ol, 16, 0, 0, *th],
                         8, 16, 160, 27, cuda)
    # refbase rows named by index: a [J, L] refbase with Jw != J and no
    # ridx, a refbase beside ridx, and sources without their genome (or
    # one shorter than L)
    ridx = torch.zeros(16, dtype=torch.int32, device=cuda)
    for refs, ints in (([gpu[7]] + [None] * 6, [17, 0, 0]),
                       ([gpu[7], ridx] + [None] * 5, [16, 0, 0]),
                       ([None, ridx] + [None] * 5, [16, 0, 0]),
                       ([None, ridx, gpu[7], ridx, ridx, ridx, gpu[7]],
                        [16, 100, 1])):
        p = [None if t is None else t.data_ptr()
             for t in gpu[:7] + refs + gpu[8:] + outs]
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            vote._launch("gc_vote_epilogue", lib.gc_vote_epilogue,
                         p + [None] * 9,
                         [8, 16, 160, len(args[0]), 160, *ints, *th],
                         8, 16, 160, 27, cuda)
    n0 = vote.LAUNCHES
    with pytest.raises(ValueError, match="must be even"):
        vote.vote_gathered(*gpu, **KW, out_len=151, sparse=True)
    with pytest.raises(ValueError, match="on cpu, expected cuda"):
        vote.vote_gathered(*gpu[:4], gpu[4].cpu(), *gpu[5:], **KW, **kw)
    assert vote.LAUNCHES == n0


def _window_args(rng, classes, L, N, Jw, ridx_of=None):
    """Per-class (base_row, counts, job_len, refbase row) as the engine
    stages them, with empty jobs, jobs of one member, of exactly one
    shared-memory stage of the window kernel and of one more, full
    classes, member rows running past the matrix (they clamp), job
    lengths up to L, and refbase rows drawn with repeats (or from
    ridx_of(J))."""
    args = []
    stage = vote.window_stage()
    for K, J in classes:
        base = rng.integers(0, N, size=J).astype(np.uint16)
        base[:4] = N - 2
        kmax = min(K, 255)            # counts are uint8
        counts = rng.integers(0, kmax + 1, size=J).astype(np.uint8)
        counts[::11] = 0
        counts[1::13] = kmax
        counts[2::17] = 1
        if kmax > stage:
            counts[3::7] = stage
            counts[4::7] = stage + 1
        jl = rng.integers(0, L + 1, size=J).astype(np.uint16)
        jl[::7] = L
        ridx = (rng.integers(0, Jw, size=J) if ridx_of is None
                else ridx_of(J)).astype(np.uint16)
        args.extend((base, counts, jl, ridx))
    return args


def _refbase_sources(rng, Jw, L, G=20000, nh=40):
    """A window's refbase sources: the padded genome, genome starts (some
    negative or past the end: dynamic_slice's wrap and clamp), host rows
    (indices past the last clamp) and job lengths 0..L."""
    genome = np.pad(np.array([1, 2, 4, 8], np.uint8)[
        rng.integers(0, 4, size=G)], (0, 4096))
    gp = rng.integers(0, G, size=Jw).astype(np.int32)
    gp[:5] = [-3, -G - 4096 - 7, len(genome) - L + 9, 2**31 - 1, 0]
    hr = np.array([0, 1, 2, 4, 8], np.uint8)[rng.integers(0, 5, size=(nh, L))]
    hr[0] = 0
    hm = np.where(rng.random(Jw) < 0.6, -1,
                  rng.integers(0, nh + 4, size=Jw)).astype(np.int16)
    jp = rng.integers(0, L + 1, size=Jw).astype(np.uint16)
    jp[::3] = L
    return genome, gp, hr, hm, jp


# (L, out_len, qual table, layout): "mixed" is a window of four classes
# (K = 4, 16, 64, 256) with refbase rows drawn with repeats; "grid_*" put
# the job count below, at and at many times the kernel's persistent grid;
# "rows_once" references every refbase row once, "rows_one" names the same
# row for every job
WINDOW_CASES = [
    (160, 160, False, "mixed"), (160, 160, True, "mixed"),
    (160, 136, False, "mixed"), (160, 136, True, "mixed"),
    (16, 16, True, "mixed"), (16, 8, False, "mixed"),
    (128, 104, True, "mixed"), (256, 256, True, "mixed"),
    (256, 200, False, "mixed"),
    (160, 160, True, "grid_below"), (160, 160, True, "grid_equal"),
    (160, 160, True, "grid_many"),
    (128, 128, True, "rows_once"), (128, 128, False, "rows_one"),
]


def _window_case(rng, cuda, L, layout):
    """(classes, Jw, ridx_of) of one WINDOW_CASES layout."""
    if layout == "mixed":
        return ((4, 300), (16, 200), (64, 120), (256, 40)), 900, None
    if layout.startswith("grid_"):
        cap = vote.window_grid(L, 1 << 30, cuda)
        Jt = {"grid_below": max(1, cap // 3), "grid_equal": cap,
              "grid_many": 5 * cap + 7}[layout]
        assert vote.window_grid(L, Jt, cuda) == min(Jt, cap)
        J4 = (3 * Jt) // 4
        classes = ((4, J4), (16, Jt - J4)) if Jt - J4 else ((4, J4),)
        return classes, Jt + Jt // 4, None
    classes = ((4, 500), (32, 100))
    if layout == "rows_once":
        perm = rng.permutation(600)
        parts = iter((perm[:500], perm[500:]))
        return classes, 600, lambda J: next(parts)
    return classes, 1800, lambda J: np.zeros(J, dtype=np.int64)


@pytest.mark.parametrize("L,out_len,with_qtable,layout", WINDOW_CASES)
def test_vote_window_kernel_matches_twin(cuda, L, out_len, with_qtable,
                                         layout):
    """gc_vote_window's flat wire buffer and dense fallback equal the
    plain composition's (vote_window_plain on CPU copies) byte for byte,
    every class of a window in one launch, the refbase rows read in the
    kernel from the genome and the host rows; at the widths
    and layouts of WINDOW_CASES, with member counts 0, 1, one stage and
    one more, clamped member rows, a qual table listing a value twice (the
    last matching index wins)."""
    rng = np.random.default_rng(3 + with_qtable + out_len + L)
    N = 3000
    classes, Jw, ridx_of = _window_case(rng, cuda, L, layout)
    codes = np.array([0, 1, 2, 4, 8, 15, vote.SENTINEL], dtype=np.uint8)
    seq = codes[rng.choice(7, size=(N, L), p=[.04, .23, .23, .23, .23, .03,
                                              .01])]
    qual = rng.choice(np.array([2, 12, 18, 25, 30, 36, 41], np.uint8),
                      size=(N, L))
    score = rng.integers(-4, 13, size=(N, L)).astype(np.int8)
    genome, gp, hr, hm, jp = _refbase_sources(rng, Jw, L)
    class_args = _window_args(rng, classes, L, N, Jw, ridx_of)
    ridx = np.concatenate([a.astype(np.int64) for a in class_args[3::4]])
    if layout == "rows_once":
        assert sorted(ridx) == list(range(Jw))
    elif layout == "rows_one":
        assert not ridx.any()
    else:
        assert len(np.unique(ridx)) < len(ridx)   # rows shared by jobs
    qtable = _qtable() if with_qtable else None
    kw = dict(classes=classes, L=L, out_len=out_len, **KW)
    cpu = [torch.from_numpy(a) for a in (seq, qual, score)]
    want = vote.vote_window_plain(*cpu, torch.from_numpy(genome), gp, hr, hm,
                                  jp, qtable, class_args, **kw)
    n0 = vote.WINDOW_LAUNCHES
    got = vote.vote_window(*[t.to(cuda) for t in cpu],
                           torch.from_numpy(genome).to(cuda), gp, hr, hm, jp,
                           qtable, class_args, **kw)
    torch.cuda.synchronize(cuda)
    assert vote.WINDOW_LAUNCHES == n0 + 1
    assert got[0].cpu().numpy().tobytes() == want[0].numpy().tobytes()
    for (gp_, gq), (wp, wq) in zip(got[1], want[1]):
        assert torch.equal(gp_.cpu(), wp)
        assert torch.equal(gq.cpu(), wq)
    if with_qtable and layout == "mixed":   # the escape counts are not all 0
        assert want[0][-4 * len(classes):].any()
    # host rows and a qual table that already lie on the card
    got2 = vote.vote_window(*[t.to(cuda) for t in cpu],
                            torch.from_numpy(genome).to(cuda), gp,
                            torch.from_numpy(hr).to(cuda), hm, jp,
                            None if qtable is None else
                            torch.from_numpy(qtable).to(cuda), class_args,
                            **kw)
    assert torch.equal(got2[0], got[0])
    for (ap, aq), (bp, bq) in zip(got2[1], got[1]):
        assert torch.equal(ap, bp) and torch.equal(aq, bq)


def test_vote_window_escape_counts_exact_every_launch(cuda):
    """The per-class escape counts (the wire buffer's last 4 * nb bytes)
    are exact in every one of many launches when the escapes lie only in
    each block's last job: at Jt = 3 grid every block votes jobs b,
    b + grid and b + 2 grid, and only the rows of the last third hold a
    qual value outside the table, so each count is added just before its
    block takes the last-block ticket."""
    L = 160
    grid = vote.window_grid(L, 1 << 30, cuda)
    Jt = 3 * grid
    J0 = 2 * grid + grid // 2
    classes = ((4, J0), (16, Jt - J0))
    rng = np.random.default_rng(41)
    N = 4 * Jt
    seq = np.array([1, 2, 4, 8], np.uint8)[rng.integers(0, 4, size=(N, L))]
    score = rng.integers(-4, 13, size=(N, L)).astype(np.int8)
    qual = np.full((N, L), 30, np.uint8)
    esc = qual.copy()
    esc[4 * 2 * grid:, ::7] = 41
    base = (4 * np.arange(Jt)).astype(np.uint32)
    counts = rng.integers(1, 5, size=Jt).astype(np.uint8)
    jl = np.full(Jt, L, np.uint16)
    ridx = np.arange(Jt, dtype=np.uint32)
    class_args = []
    for lo, hi in ((0, J0), (J0, Jt)):
        class_args += [base[lo:hi], counts[lo:hi], jl[lo:hi], ridx[lo:hi]]
    genome, gp, hr, hm, jp = _refbase_sources(rng, Jt, L)
    qtable = _qtable()
    kw = dict(classes=classes, L=L, out_len=L, **KW)

    def plain(q):
        cpu = [torch.from_numpy(a) for a in (seq, q, score, genome)]
        return vote.vote_window_plain(*cpu, gp, hr, hm, jp, qtable,
                                      class_args, **kw)[0].numpy()

    assert not plain(qual)[-8:].any()
    want = plain(esc)
    assert (np.frombuffer(want[-8:].tobytes(), "<i4") > 0).all()
    dev = [torch.from_numpy(a).to(cuda) for a in (seq, esc, score, genome)]
    for _ in range(64):
        got = vote.vote_window(*dev, gp, hr, hm, jp, qtable, class_args,
                               **kw)[0]
        assert got.cpu().numpy().tobytes() == want.tobytes()


def test_vote_window_rejects_bad_inputs(cuda):
    L, N = 40, 10     # L not a multiple of 16
    seq = torch.zeros((N, L), dtype=torch.uint8, device=cuda)
    genome = torch.zeros(5000, dtype=torch.uint8, device=cuda)
    hr = np.zeros((1, L), np.uint8)
    args = [np.zeros(3, np.int32)] * 4
    src = [np.zeros(3, np.int32)] * 1
    kw = dict(classes=((4, 3),), L=L, out_len=L, **KW)
    with pytest.raises(ValueError, match="multiple of 16"):
        vote.vote_window(seq, seq, seq.to(torch.int8), genome, *src, hr,
                         *src, *src, None, args, **kw)
    seq = torch.zeros((N, 32), dtype=torch.uint8, device=cuda)
    kw.update(L=32, out_len=32)
    with pytest.raises(TypeError):
        vote.vote_window(seq, seq, seq, genome, *src, hr[:, :32], *src,
                         *src, None, args, **kw)
    with pytest.raises(ValueError, match="on cpu, expected cuda"):
        vote.vote_window(seq, seq, seq.to(torch.int8), genome.cpu(), *src,
                         hr[:, :32], *src, *src, None, args, **kw)


def test_engine_on_cuda_matches_oracle(cuda, tmp_path):
    from gencore_tpu.core.oracle import OracleEngine
    from gencore_tpu.io import bam
    from gencore_tpu.io.fasta import FastaRef
    from gencore_tpu.options import Options
    from gencore_tpu_torch.engine import VectorEngine
    from gencore_tpu_torch.io import bam as tbam
    from gencore_tpu_torch.io.fasta import FastaRef as TFastaRef
    from gencore_tpu_torch.options import Options as TOptions

    # by path: an installed package named
    # `tests` would shadow this directory
    spec = importlib.util.spec_from_file_location(
        "_torch_cuda_datagen", pathlib.Path(__file__).with_name("datagen.py"))
    datagen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(datagen)
    SyntheticBam = datagen.SyntheticBam

    rng = np.random.default_rng(2)
    sb = SyntheticBam(seed=2, contig_len=300_000)
    for k in range(150):
        pos = 1000 + 900 * k
        for _ in range(int(rng.integers(1, 6))):
            sb.add_pair(0, pos, pos + 160, read_len=150, umi="ACGT_TTGA",
                        n_errors=int(rng.integers(0, 3)),
                        qual=int(rng.choice([18, 30, 36])))
    sb.write_bam(str(tmp_path / "in.bam"))
    sb.write_fasta(str(tmp_path / "ref.fa"))
    reader = bam.BamReader(str(tmp_path / "in.bam"))
    ref = FastaRef.load(str(tmp_path / "ref.fa"))
    oeng = OracleEngine(Options(), reader.header, fasta=ref)
    want = sorted(r.encode() for r in oeng.run(reader.read_all()))
    treader = tbam.BamReader(str(tmp_path / "in.bam"))
    n0 = vote.WINDOW_LAUNCHES
    u0 = kernels.UPLOAD_SCORE_LAUNCHES
    eng = VectorEngine(TOptions(), treader.header,
                       fasta=TFastaRef.load(str(tmp_path / "ref.fa")),
                       device=cuda)
    got = sorted(eng.run(treader.read_all()).encoded_records())
    assert vote.WINDOW_LAUNCHES > n0
    assert kernels.UPLOAD_SCORE_LAUNCHES > u0
    assert got == want


def test_window_pipeline_on_cuda_matches_single_shot(cuda, tmp_path):
    """parallel/pipeline.run_pipelined on the card: the windows' merged
    records and payload equal one VectorEngine.run, and every window
    launched the fused window kernel."""
    from gencore_tpu_torch.engine import VectorEngine
    from gencore_tpu_torch.io import bam as tbam
    from gencore_tpu_torch.io.fasta import FastaRef as TFastaRef
    from gencore_tpu_torch.options import Options as TOptions
    from gencore_tpu_torch.parallel import pipeline, windows
    from gencore_tpu_torch.tools import workloads

    bam_path, fa, _ = workloads.small_panel(str(tmp_path))
    reader = tbam.BamReader(bam_path)
    ref = TFastaRef.load(fa)
    eng = VectorEngine(TOptions(), reader.header, fasta=ref, device=cuda)
    want = eng.run(reader.read_all()).encoded_records()
    n0 = vote.WINDOW_LAUNCHES
    tables, pre, post = pipeline.run_pipelined(
        TOptions(), tbam.BamReader(bam_path).read_all(), reader.header,
        fasta=ref, n_windows=4, device=cuda)
    assert len(tables) > 1
    assert vote.WINDOW_LAUNCHES - n0 >= len(tables)
    assert windows.merged_records(tables) == want
    payload = pipeline.merged_payload(tables).tobytes()
    assert payload == b"".join(len(b).to_bytes(4, "little") + b
                               for b in want)
    assert (post.read, post.base) == (eng.post_stats.read,
                                      eng.post_stats.base)
    assert pre.molecule == eng.pre_stats.molecule


def _jobs(rng, J, K, L):
    """Pre-gathered jobs [J, K, L] for consensus_kernel: IUPAC codes,
    absent members, ragged job lengths, positions without a reference."""
    bases = np.array([1, 2, 4, 8], dtype=np.uint8)
    seq = bases[rng.integers(0, 4, size=(J, K, L))]
    seq = np.where(rng.random((J, K, L)) < 0.9, seq[:, :1, :], seq)
    seq = np.where(rng.random((J, K, L)) < 0.03,
                   rng.integers(0, 16, size=(J, K, L)), seq).astype(np.uint8)
    qual = rng.integers(0, 42, size=(J, K, L)).astype(np.uint8)
    score = rng.integers(-4, 13, size=(J, K, L)).astype(np.int32)
    valid = rng.random((J, K)) < 0.85
    valid[:, 0] = True
    pos_valid = np.arange(L)[None, :] < rng.integers(1, L + 1, size=J)[:, None]
    refbase = np.where(rng.random((J, L)) < 0.2, 0,
                       bases[rng.integers(0, 4, size=(J, L))]).astype(np.uint8)
    return seq, qual, score, valid, pos_valid, refbase


@pytest.mark.parametrize("J,K,L", [(64, 4, 160), (7, 300, 96)])
def test_consensus_kernel_cuda_matches_plain(cuda, J, K, L):
    """kernels.consensus_kernel on CUDA tensors (the Bins16 kernel over the
    [J, K, L] block viewed as rows) against consensus_plain on the CPU."""
    cpu = [torch.from_numpy(a) for a in _jobs(np.random.default_rng(J), J, K,
                                              L)]
    n0 = vote.FULL_LAUNCHES
    got = kernels.consensus_kernel(*[t.to(cuda) for t in cpu], **KW)
    torch.cuda.synchronize()
    assert vote.FULL_LAUNCHES == n0 + 1
    want = kernels.consensus_plain(*cpu, **KW)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    gpu = [t.to(cuda) for t in cpu]
    gpu[4] = ~gpu[4]                                  # not a prefix mask
    with pytest.raises(ValueError, match="prefix mask"):
        kernels.consensus_kernel(*gpu, **KW)
    with pytest.raises(ValueError, match="full_bins"):
        kernels.consensus_kernel(*[t.to(cuda) for t in cpu], full_bins=False,
                                 **KW)


def test_mesh_on_one_cuda_device_matches_plain(cuda):
    from gencore_tpu_torch.options import Options
    from gencore_tpu_torch.parallel import mesh as pmesh
    batch = _jobs(np.random.default_rng(3), 32, 6, 160)
    opt = Options()
    m = pmesh.make_mesh(1, device=cuda)
    got = pmesh.sharded_consensus_step(m, *batch, opt)
    rnum, rden = kernels.ratio_fraction(opt.score_percent_req)
    want = kernels.consensus_plain(
        *[torch.from_numpy(a) for a in batch], hi=opt.high_quality,
        mod=opt.moderate_quality, lo=opt.low_quality,
        base_score_req=opt.base_score_req, ratio_num=rnum, ratio_den=rden)
    for g, w in zip(got[:4], want):
        assert torch.equal(g.cpu(), w)
    assert int(got[4]) == int(want[2].sum())
    assert int(got[5]) == int((want[3] > 5).sum())
    parts = np.arange(7, dtype=np.int64)[None, :] * 3
    assert pmesh.stats_psum(m, parts).cpu().tolist() == parts[0].tolist()
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA device"):
            pmesh.make_mesh(2, device=cuda)


SCORE_KW = dict(hi=30, mod=20, lo=15, s_hi=12, s_mod=8, s_lo=6, s_bad=4)


def _upload_both(cuda, staging, w, L, flags):
    """csrc/upload_score.cu (through engine._upload_score_fn on the card,
    host arrays) and its plain twin on the CPU, on the same staging."""
    from gencore_tpu_torch import engine
    from gencore_tpu_torch.core.kernels import UPLOAD_FLAGS
    f = dict(zip(UPLOAD_FLAGS, flags))
    static = (w, L, f["mode2"], f["has_sedit"], f["has_qdense"],
              f["has_qedit"], f["const_lens"], *SCORE_KW.values(),
              f["has_genome"], f["no_overlap"], f.get("mate32", False))
    fn = engine._upload_score_fn(*static)
    args = list(staging)
    if f["has_genome"]:
        args[14] = torch.from_numpy(staging[14]).to(cuda)
    n0 = kernels.UPLOAD_SCORE_LAUNCHES
    got = fn(*args, device=cuda)
    torch.cuda.synchronize(cuda)
    assert kernels.UPLOAD_SCORE_LAUNCHES == n0 + 1
    want = fn(*staging, device="cpu")
    return got, want


def _same_bytes(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert int((a.cpu() != b).sum()) == 0


@pytest.mark.parametrize("bits", range(256))
def test_upload_score_kernel_matches_twin(cuda, bits):
    """Every combination of the eight static flags (mode2, has_sedit,
    has_qdense, has_qedit, const_lens, has_genome, no_overlap, mate32) on
    staging with the program's edges (workloads.upload_staging: the
    reserved row, genome slots past the end, repeated and out-of-range
    edit positions, rows without edits and of length 0, overlaps wrapping
    past L): every byte of seq, qual and score equal to the twin's."""
    from gencore_tpu_torch.tools import workloads
    flags = tuple(bool(bits >> i & 1) for i in range(8))
    rng = np.random.default_rng(500 + bits)
    n, w, L = 700, 151, 160
    staging = workloads.upload_staging(
        rng, n, w, L, **dict(zip(kernels.UPLOAD_FLAGS, flags)))
    _same_bytes(*_upload_both(cuda, staging, w, L, flags))


@pytest.mark.parametrize("n,w,L", [(1, 8, 32), (33, 31, 32), (20000, 150, 160),
                                   (3000, 256, 256)])
def test_upload_score_kernel_shapes(cuda, n, w, L):
    """One row, a row count that is not a multiple of the block's warps,
    more rows than one chunk per block of the resident grid, the widest
    rows; every flag on but no_overlap, then no_overlap."""
    from gencore_tpu_torch.tools import workloads
    for no_ov in (False, True):
        flags = (True, True, True, True, False, True, no_ov)
        if n < 4:
            flags = (False, True, False, True, True, False, no_ov)
        rng = np.random.default_rng(n + w + no_ov)
        staging = workloads.upload_staging(
            rng, n, w, L, **dict(zip(kernels.UPLOAD_FLAGS, flags)))
        _same_bytes(*_upload_both(cuda, staging, w, L, flags))


@pytest.mark.parametrize("mate32", [False, True])
@pytest.mark.parametrize("bits", [0b0101011, 0b0111111, 0b0010100])
def test_upload_score_kernel_pair_edges(cuda, bits, mate32):
    """Mate pairs the kernel must not take as pairs (a scored row whose
    mate is itself, whose mate names another row, whose mate names it
    back unscored, whose mate lies past the rows) beside real pairs, over
    20,000 rows, so that pairs span blocks; with u16 and u32 mate rows."""
    from gencore_tpu_torch.tools import workloads
    flags = tuple(bool(bits >> i & 1) for i in range(7)) + (mate32,)
    rng = np.random.default_rng(bits + 7 * mate32)
    n, w, L = 20000, 150, 160
    staging = workloads.upload_staging(
        rng, n, w, L, pair_edges=True,
        **dict(zip(kernels.UPLOAD_FLAGS, flags)))
    _same_bytes(*_upload_both(cuda, staging, w, L, flags))


@pytest.mark.parametrize("no_overlap", [False, True])
def test_upload_score_kernel_u32_window(cuda, no_overlap):
    """A window of more than 65,536 rows (u32 mate rows), with the deep
    panel's flags and with no_overlap."""
    from gencore_tpu_torch.tools import workloads
    flags = (True, True, False, True, True, True, no_overlap, True)
    staging = workloads.upload_staging(
        np.random.default_rng(72), 72000, 150, 160,
        **dict(zip(kernels.UPLOAD_FLAGS, flags)))
    _same_bytes(*_upload_both(cuda, staging, 150, 160, flags))


def test_upload_score_kernel_rejects_misaligned_output(cuda):
    """The kernel stores 16 bytes at a time: an output 1 byte past an
    aligned address raises, with nothing launched and no plain fallback."""
    from gencore_tpu_torch.tools import workloads
    rng = np.random.default_rng(3)
    n, w, L = 64, 40, 64
    flags = dict(has_sedit=True, has_qedit=True)
    staging = workloads.upload_staging(rng, n, w, L, **flags)
    arrays = list(staging[:14]) + [staging[15]]
    kw = dict(device=cuda, w=w, L=L, mode2=False, has_sedit=True,
              has_qdense=False, has_qedit=True, const_lens=False,
              has_genome=False, no_overlap=False, **SCORE_KW)
    buf = torch.empty(n * L + 16, dtype=torch.uint8, device=cuda)
    good = [torch.empty((n, L), dtype=dt, device=cuda)
            for dt in (torch.uint8, torch.uint8, torch.int8)]
    bad = buf[1:1 + n * L].view(n, L)
    n0 = kernels.UPLOAD_SCORE_LAUNCHES
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.upload_score(arrays, None, out=(bad, *good[1:]), **kw)
    assert kernels.UPLOAD_SCORE_LAUNCHES == n0
    got = kernels.upload_score(arrays, None, out=good, **kw)
    assert all(g is o for g, o in zip(got, good))
    assert kernels.UPLOAD_SCORE_LAUNCHES == n0 + 1


def test_upload_score_kernel_rejects_bad_staging(cuda):
    from gencore_tpu_torch.tools import workloads
    rng = np.random.default_rng(1)
    flags = dict(has_sedit=True, has_qedit=True)
    staging = list(workloads.upload_staging(rng, 50, 40, 64, **flags))
    arrays = staging[:14] + staging[15:]
    kw = dict(device=cuda, w=40, L=64, mode2=False, has_sedit=True,
              has_qdense=False, has_qedit=True, const_lens=False,
              has_genome=False, no_overlap=False, **SCORE_KW)
    bad = list(arrays)
    bad[1] = bad[1].astype(np.int32)
    with pytest.raises(TypeError, match="src is int32"):
        kernels.upload_score(bad, None, **kw)
    with pytest.raises(ValueError, match="scnt has 3 entries"):
        kernels.upload_score(arrays[:2] + [arrays[2][:3]] + arrays[3:], None,
                             **kw)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        kernels.upload_score(arrays, None, **dict(kw, device="cpu"))
    with pytest.raises(ValueError, match="genome"):
        kernels.upload_score(arrays, None, **dict(kw, has_genome=True))
    with pytest.raises(TypeError, match="mate is uint16"):
        kernels.upload_score(arrays, None, **dict(kw, mate32=True))


def _refsrc_case(rng, J, L, Jw, G0=20000, nh=40):
    """A window's refbase sources as engine._refbase_host_args makes them
    (genome NT16-coded and padded as engine._genome_dev pads it, hm int16,
    jp u16): genome slices with negative, overlong and in-range starts,
    short and zero job lengths, host rows with their index clamped; and a
    bucket's ridx, rows repeated, unsorted and past the window's."""
    genome = np.pad(np.array([1, 2, 4, 8, 15], np.uint8)[
        rng.integers(0, 5, size=G0)], (0, 4096))
    G = len(genome)
    gp = rng.integers(0, G0, size=Jw).astype(np.int32)
    gp[::7] = -rng.integers(1, G, size=len(gp[::7]))
    gp[1::9] = G - L + rng.integers(1, 50, size=len(gp[1::9]))
    gp[2::11] = -3 * G
    hm = np.where(rng.random(Jw) < 0.3, rng.integers(0, nh + 3, size=Jw),
                  -1).astype(np.int16)
    jp = rng.integers(0, L + 1, size=Jw).astype(np.uint16)
    jp[::3] = L
    hr = np.array([0, 1, 2, 4, 8], np.uint8)[rng.integers(0, 5, size=(nh, L))]
    ridx = rng.integers(0, Jw + 2, size=J).astype(np.int32)
    return genome, gp, hr, hm, jp, ridx


# (K, J, L, mode): the source form at L = 128, 160 and 320, one CTA per
# job and splits of 8 and 16, dense, sparse and sparse with a qual table,
# and buckets of one job and of none
REFSRC = [(16, 300, 128, "sparse"), (16, 300, 128, "dense"),
          (64, 300, 160, "sparse_qtable"), (16, 4096, 160, "sparse_qtable"),
          (2048, 8, 160, "sparse_qtable"), (2048, 8, 160, "dense"),
          (300, 5, 320, "dense"), (300, 5, 320, "sparse"),
          (4, 1, 160, "sparse_qtable"), (2048, 1, 160, "sparse"),
          (8, 0, 160, "sparse"), (8, 0, 320, "dense")]


@pytest.mark.parametrize("K,J,L,mode", REFSRC)
def test_vote_gathered_refsrc_kernel_matches_twin(cuda, K, J, L, mode):
    """csrc/vote.cu's gathered entry reading each job's refbase row by
    index, as the engine calls it (vote.pallas_vote_gathered with the
    bucket's host arrays, sent up in one pinned copy; the window's
    sources through vote.window_refsrc), against vote_gathered_plain fed
    vote.refbase_rows on the card, every output byte; and the rows
    refbase_rows reads against vote.refbase_combine on the CPU."""
    rng = np.random.default_rng(13 * K + J + L + len(mode))
    args, kw = _gathered_case(rng, K, max(J, 1), L, mode)
    seq, qual, score, rows, row0, valid, job_len, _rb, qtable = args
    rows, row0, valid, job_len = (rows[:, :J], row0[:J], valid[:, :J],
                                  job_len[:J])
    genome, gp, hr, hm, jp, ridx = _refsrc_case(rng, J, L, max(J, 1) + 5)
    mats = [torch.from_numpy(a).to(cuda) for a in (seq, qual, score)]
    src = vote.window_refsrc(torch.from_numpy(genome).to(cuda), gp, hm, jp,
                             hr)
    table = vote.refbase_combine(*(torch.from_numpy(a) for a in (
        genome, gp, hr, hm.astype(np.int32), jp.astype(np.int32))), L)
    want_rows = table[torch.from_numpy(ridx).long().clamp(0, len(gp) - 1)]
    n0, s0 = vote.LAUNCHES, vote.REFSRC_LAUNCHES
    got = vote.pallas_vote_gathered(*mats, rows, row0, valid, job_len, None,
                                    qtable, refsrc=(*src, ridx), **KW, **kw)
    torch.cuda.synchronize(cuda)
    assert vote.LAUNCHES == n0 + 1 and vote.REFSRC_LAUNCHES == s0 + 1
    dev_ridx = torch.from_numpy(ridx).to(cuda)
    assert torch.equal(vote.refbase_rows((*src, dev_ridx), L).cpu(),
                       want_rows)
    want = vote.vote_gathered_plain(
        *mats, *(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
            rows, row0, valid.astype(np.uint8), job_len)), None,
        None if qtable is None else torch.from_numpy(qtable).to(cuda),
        refsrc=(*src, dev_ridx), **KW, **kw)
    _equal_outputs(got, want)
    # the same rows given ready-made: the [J, L] form
    again = vote.pallas_vote_gathered(*mats, rows, row0, valid, job_len,
                                      want_rows.numpy(), qtable, **KW, **kw)
    _equal_outputs(again, want)


@pytest.mark.parametrize("K,S,L,sparse", [(3, 16, 160, True),
                                           (70, 8, 320, False)])
def test_pregathered_refsrc_kernel_matches_twin(cuda, K, S, L, sparse):
    """vote.pallas_vote (the lenDiff-shifted jobs' host-gathered block,
    voted over its [K*S, L] view) with its refbase rows named by index in
    the window's sources, as the engine calls it, on the card against the
    same call on CPU copies (the plain twin), every output byte; one CTA
    per job and a split."""
    rng = np.random.default_rng(7 * K + S + L)
    codes = np.array([1, 2, 4, 8, vote.SENTINEL], np.uint8)
    seq = codes[rng.choice(5, size=(K, S, L), p=[.24, .24, .24, .24, .04])]
    qual = rng.integers(2, 42, size=(K, S, L)).astype(np.uint8)
    score = rng.integers(-3, 13, size=(K, S, L)).astype(np.int8)
    valid = rng.random((K, S)) < 0.8
    job_len = rng.integers(L // 2, L + 1, size=S).astype(np.int32)
    genome, gp, hr, hm, jp, ridx = _refsrc_case(rng, S, L, S + 5)
    kw = dict(out_len=L, sparse=sparse, **KW)
    host = (seq, qual, score, valid, job_len, None)
    n0 = vote.REFSRC_LAUNCHES
    got = vote.pallas_vote(*host, refsrc=(*vote.window_refsrc(
        torch.from_numpy(genome).to(cuda), gp, hm, jp, hr), ridx),
        device=cuda, **kw)
    torch.cuda.synchronize(cuda)
    assert vote.REFSRC_LAUNCHES == n0 + 1
    assert (vote.split_size(K, S) > 1) == (K > 64)
    want = vote.pallas_vote(*host, refsrc=(*vote.window_refsrc(
        torch.from_numpy(genome), gp, hm, jp, hr), ridx), **kw)
    _equal_outputs(got, want)


DENSE_MODES = [(sm, qm) for sm in ("2bit", "4bit")
               for qm in ("2bit", "4bit", "raw")]


@pytest.mark.parametrize("seq_mode,qual_mode", DENSE_MODES)
@pytest.mark.parametrize("n,w,L", [(1, 8, 32), (777, 34, 64),
                                   (3000, 152, 160), (2000, 304, 320),
                                   (500, 600, 608)])
def test_upload_unpack_kernel_matches_twin(cuda, n, w, L, seq_mode,
                                           qual_mode):
    """csrc/upload_dense.cu's unpack through the engine's entry on CUDA
    tensors against engine._upload_unpack_plain on the CPU: every mode
    pair, widths past 256 bases, lengths 0, odd, w and past w; every
    byte and length equal, one launch."""
    from gencore_tpu_torch import engine
    from gencore_tpu_torch.tools import workloads
    host = workloads.dense_staging(np.random.default_rng(n + w), n, w,
                                   seq_mode, qual_mode)
    gpu = [torch.from_numpy(a).to(cuda) for a in host]
    n0 = kernels.UPLOAD_UNPACK_LAUNCHES
    got = engine._upload_unpack_fn(w, L, qual_mode, seq_mode)(*gpu)
    torch.cuda.synchronize(cuda)
    assert kernels.UPLOAD_UNPACK_LAUNCHES == n0 + 1
    want = engine._upload_unpack_plain(w, L, qual_mode, seq_mode)(
        *[torch.from_numpy(a) for a in host])
    _same_bytes(got, want)


# tiers whose scores wrap when cast to int8 (s_hi + 4 > 127, s_mod - 3 <
# -128 on a won mismatch of a moderate difference)
WRAP_KW = dict(hi=30, mod=20, lo=15, s_hi=126, s_mod=-127, s_lo=127,
               s_bad=-3)


@pytest.mark.parametrize("tiers", ["default", "wrap"])
@pytest.mark.parametrize("N,L,packed", [(1, 32, True), (1, 32, False),
                                        (5000, 160, True),
                                        (5000, 320, False),
                                        (70001, 32, False),
                                        (3000, 256, True)])
def test_score_map_kernel_matches_twin(cuda, N, L, packed, tiers):
    """csrc/upload_dense.cu's score map through score_map_kernel_packed
    and score_map_kernel on CUDA tensors against the same entry on the
    CPU (the plain twins): mate pairs, self, clamped and negative mate
    rows, negative cmp_len, ties, unscored rows; every byte equal."""
    from gencore_tpu_torch.tools import workloads
    kw = SCORE_KW if tiers == "default" else WRAP_KW
    host = workloads.score_geometry(np.random.default_rng(N + L), N, L,
                                    packed)
    cpu = [torch.from_numpy(a) for a in host]
    gpu = [t.to(cuda) for t in cpu]
    fn = (kernels.score_map_kernel_packed if packed
          else kernels.score_map_kernel)
    n0 = kernels.SCORE_MAP_LAUNCHES
    got = fn(*gpu, **kw)
    torch.cuda.synchronize(cuda)
    assert kernels.SCORE_MAP_LAUNCHES == n0 + 1
    _same_bytes(got, fn(*cpu, **kw))


# tiers that reach outside the byte range (a threshold above 255 never
# reached, one at or below 0 always) and unordered ones, beside WRAP_KW
EDGE_TIERS = [WRAP_KW,
              dict(hi=300, mod=0, lo=-4, s_hi=9, s_mod=1000, s_lo=-200,
                   s_bad=5),
              dict(hi=15, mod=30, lo=20, s_hi=3, s_mod=-9, s_lo=7,
                   s_bad=255),
              dict(hi=256, mod=255, lo=1, s_hi=1, s_mod=2, s_lo=3, s_bad=4)]


@pytest.mark.parametrize("tiers", range(len(EDGE_TIERS)))
@pytest.mark.parametrize("N,L,packed", [(5003, 160, True),
                                        (5003, 160, False),
                                        (4999, 320, False), (129, 32, True)])
def test_score_map_kernel_edge_tiers(cuda, N, L, packed, tiers):
    """The score map with tiers outside the byte range or unordered, at
    row counts that are no multiple of a warp's (4-16 rows, by the
    grid's size) or a block's (8 warps) batch, on
    workloads.score_geometry's mate-pair edges."""
    from gencore_tpu_torch.tools import workloads
    kw = EDGE_TIERS[tiers]
    host = workloads.score_geometry(np.random.default_rng(N + tiers), N, L,
                                    packed)
    cpu = [torch.from_numpy(a) for a in host]
    fn = (kernels.score_map_kernel_packed if packed
          else kernels.score_map_kernel)
    got = fn(*[t.to(cuda) for t in cpu], **kw)
    torch.cuda.synchronize(cuda)
    _same_bytes(got, fn(*cpu, **kw))


@pytest.mark.parametrize("packed", [True, False])
def test_score_map_kernel_pair_edges(cuda, packed):
    """Mate pairs the kernel takes once, by the warp of the lower row, and
    rows it must not pair: a pair whose geometry does not mirror, a pair
    with one row unscored, pairs across a warp's (rows 15, 16; a warp
    takes 4-16 rows) and a block's (127, 128) batch, a pair made by
    clamping (row 21 names a row
    past the matrix, the last row names 21), mates that name a third row
    (rows 20 and 22, one of them through a negative index), self mates;
    every byte equal to the twin's."""
    N, L = 300, 64
    rng = np.random.default_rng(11)
    codes = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
    seq = codes[rng.integers(0, 5, size=(N, L))]
    qual = rng.choice(np.array([2, 12, 18, 25, 30, 36], np.uint8),
                      size=(N, L))
    my_len = rng.integers(L // 2, L + 1, size=N).astype(np.int32)
    mate = np.arange(N, dtype=np.int32)
    for x, y in ((0, 5), (7, 8), (15, 16), (127, 128), (200, 3)):
        mate[x], mate[y] = y, x
    mate[21], mate[N - 1] = N + 40, 21
    mate[20], mate[22] = 0, -5
    ms = rng.integers(0, L // 2, size=N)
    ts = rng.integers(0, L // 2, size=N)
    cl = rng.integers(1, L, size=N)
    is_left = rng.random(N) < 0.5
    scored = np.ones(N, dtype=bool)
    scored[8] = False
    scored[rng.integers(0, N, size=20)] = False
    scored[[0, 5, 15, 16, 127, 128, 20, 21, 22, N - 1]] = True
    if packed:
        meta = (ms | ts << 8 | cl << 16 | is_left.astype(np.int64) << 25
                | scored.astype(np.int64) << 26).astype(np.int32)
        host = (seq, qual, my_len, mate, meta)
        fn = kernels.score_map_kernel_packed
    else:
        i32 = np.int32
        host = (seq, qual, mate, ms.astype(i32), ts.astype(i32),
                cl.astype(i32), my_len, is_left.astype(np.uint8),
                scored.astype(np.uint8))
        fn = kernels.score_map_kernel
    cpu = [torch.from_numpy(a) for a in host]
    for kw in (SCORE_KW, WRAP_KW):
        got = fn(*[t.to(cuda) for t in cpu], **kw)
        torch.cuda.synchronize(cuda)
        _same_bytes(got, fn(*cpu, **kw))


@pytest.mark.parametrize("seq_mode,qual_mode", DENSE_MODES)
@pytest.mark.parametrize("w", [8, 34, 152])
def test_upload_unpack_kernel_edge_widths(cuda, w, seq_mode, qual_mode):
    """Widths whose 2-bit rows (2, 9 and 38 bytes) are no multiple of a
    word, so that most rows start off one, at 1,001 rows (no multiple of
    a block's tasks), and the staging at offsets 1, 3 and 7 bytes off a
    16-byte boundary: every byte equal to the twin's."""
    from gencore_tpu_torch import engine
    from gencore_tpu_torch.tools import workloads
    L = -(-w // 32) * 32
    host = workloads.dense_staging(np.random.default_rng(w), 1001, w,
                                   seq_mode, qual_mode)
    want = engine._upload_unpack_plain(w, L, qual_mode, seq_mode)(
        *[torch.from_numpy(a) for a in host])
    for off in (0, 1, 3, 7):
        gpu = [torch.from_numpy(a).to(cuda) for a in host]
        for i in (0, 1):     # seq_up and qual_up at `off` bytes
            buf = torch.zeros(gpu[i].numel() + 16, dtype=torch.uint8,
                              device=cuda)
            view = buf[off:off + gpu[i].numel()].view(gpu[i].shape)
            view.copy_(gpu[i])
            gpu[i] = view
        got = kernels.upload_unpack(*gpu, w=w, L=L, seq_mode=seq_mode,
                                    qual_mode=qual_mode)
        torch.cuda.synchronize(cuda)
        _same_bytes(got, want)


def test_dense_kernels_reject_bad_inputs(cuda):
    """Wrong dtypes, shapes and widths and misaligned rows raise before
    any launch; no plain fallback."""
    from gencore_tpu_torch.tools import workloads
    rng = np.random.default_rng(2)
    stag = [torch.from_numpy(a).to(cuda) for a in
            workloads.dense_staging(rng, 40, 48, "2bit", "raw")]
    geo = [torch.from_numpy(a).to(cuda) for a in
           workloads.score_geometry(rng, 40, 64, True)]
    n0 = (kernels.UPLOAD_UNPACK_LAUNCHES, kernels.SCORE_MAP_LAUNCHES)
    kw = dict(w=48, L=64, seq_mode="2bit", qual_mode="raw")
    with pytest.raises(TypeError, match="lens is torch.int64"):
        kernels.upload_unpack(*stag[:2], stag[2].long(), stag[3], **kw)
    with pytest.raises(ValueError, match="multiple of 16"):
        kernels.upload_unpack(*stag, **dict(kw, L=72))
    with pytest.raises(ValueError, match="do not hold"):
        kernels.upload_unpack(*stag, **dict(kw, w=60))
    seq, qual, ml, mate, meta = geo
    with pytest.raises(TypeError, match="meta is torch.int64"):
        kernels.score_map(seq, qual, mate, ml, meta=meta.long(), **SCORE_KW)
    buf = torch.zeros(40 * 64 + 16, dtype=torch.uint8, device=cuda)
    bad = buf[1:1 + 40 * 64].view(40, 64)
    bad.copy_(seq)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.score_map(bad, qual, mate, ml, meta=meta, **SCORE_KW)
    assert (kernels.UPLOAD_UNPACK_LAUNCHES, kernels.SCORE_MAP_LAUNCHES) == n0


@pytest.mark.parametrize("chunk,n", [(1000, 4_321), (None, 9_000_001)])
def test_genome_upload_through_the_pinned_ring(cuda, monkeypatch, chunk, n):
    """The device genome sent up through the two pinned buffers equals
    the one-shot NT16 coding it replaced, padded, byte for byte."""
    from gencore_tpu_torch import engine
    from gencore_tpu_torch.utils import tracing
    if chunk is not None:
        monkeypatch.setattr(engine, "_GENOME_CHUNK", chunk)
    g = np.random.default_rng(4).integers(0, 256, n).astype(np.uint8)
    g[::3] = np.frombuffer(b"ACGT", np.uint8)[np.arange(len(g[::3])) % 4]
    want = np.pad(engine._ASCII_TO_NT16[g], (0, engine._GENOME_PAD))
    tracing.take()
    with tracing.recording(), tracing.span("genome.upload"):
        dev = engine._upload_genome(g, cuda)
    (span,) = tracing.take()
    assert span.attrs == {"chunks": -(-n // engine._GENOME_CHUNK),
                          "pinned": 1}
    assert dev.device == cuda and dev.dtype == torch.uint8
    assert dev.cpu().numpy().tobytes() == want.tobytes()
