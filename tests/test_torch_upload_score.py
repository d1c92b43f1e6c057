"""The host side of the upload-and-score kernel and of the refbase rows
the votes read by index, on the CPU.

* The kernel's one upload (kernels.upload_score_pack) holds the staging's
  15 host arrays in their own dtypes: unpacked, it equals them, every part
  16-byte aligned, the barrier bytes zero; the refbase kernel's upload
  (vote.refbase_upload) likewise.
* The refbase rows the engine's votes name by index: the window
  kernel's jobs each their own row of the window's, and every gathered
  bucket of a window with a reference its rows by index in the window's
  sources (no rows handed over ready-made), on every window of the deep
  panel (a small scale of its recipe) and on every case of the case
  matrix (tools/golden_compare.py)."""

import numpy as np
import pytest
import torch

from gencore_tpu_torch import cli
from gencore_tpu_torch.core import kernels, vote
from gencore_tpu_torch.tools import golden_compare as gc
from gencore_tpu_torch.tools import workloads

torch.set_num_threads(1)

NAMES = [name for name, _dt in kernels.UPLOAD_PARTS]


@pytest.mark.parametrize("flags", [
    dict(mode2=True, has_sedit=True, has_qdense=True, has_qedit=True,
         has_genome=True),
    dict(const_lens=True, no_overlap=True),
    dict(has_sedit=True, has_qedit=True, no_overlap=True, const_lens=True),
    dict(mode2=True, has_sedit=True, has_genome=True, mate32=True),
])
def test_upload_score_layout_round_trip(flags):
    rng = np.random.default_rng(len(flags))
    *parts, mate, meta, _genome, gsl = workloads.upload_staging(
        rng, 45, 33, 64, **flags)
    arrays = (*parts, mate, meta, gsl)
    buf, lay = kernels.upload_score_pack(arrays)
    assert lay == kernels.upload_score_layout(arrays)
    assert buf.dtype == np.uint8 and buf.size == lay["size"]
    assert list(lay["parts"]) == NAMES
    back = {name: buf[off:off + int(np.prod(shape)) * dt.itemsize].view(dt)
            .reshape(shape) for name, (off, dt, shape) in lay["parts"].items()}
    end = 0
    for name, a in zip(NAMES, arrays):
        got = back[name]
        assert got.dtype == a.dtype and got.shape == a.shape, name
        assert (got == a).all(), name
        off = lay["parts"][name][0]
        assert off % 16 == 0 and off >= end, name
        assert not buf[end:off].any(), name   # the gaps are zero
        end = off + a.nbytes
    assert lay["bar"] % 16 == 0 and lay["bar"] >= end
    assert lay["size"] == lay["bar"] + 16 and not buf[end:].any()
    # u16 and u32 parts cross as they are, not widened
    assert back["src"].dtype == np.uint16 and back["lens16"].dtype == (
        np.int32 if flags.get("const_lens") else np.uint16)
    assert back["meta"].dtype == (np.uint8 if flags.get("no_overlap")
                                  else np.uint32)
    assert back["mate"].dtype == (np.uint32 if flags.get("mate32")
                                  else np.uint16)
    # alloc supplies the buffer
    room = []
    got, lay2 = kernels.upload_score_pack(
        arrays, alloc=lambda size: room.append(np.empty(size, np.uint8))
        or room[0])
    assert lay2 == lay and got is room[0] and got.tobytes() == buf.tobytes()


def test_refbase_upload_layout():
    rng = np.random.default_rng(5)
    J, L, nh = 13, 48, 4
    gp = rng.integers(-50, 5000, size=J).astype(np.int32)
    hm = rng.integers(-1, nh, size=J).astype(np.int16)
    jp = rng.integers(0, L + 1, size=J).astype(np.uint16)
    hr = rng.integers(0, 16, size=(nh, L)).astype(np.uint8)
    buf, lay = vote.refbase_upload(gp, hr, hm, jp)
    assert lay == vote.window_upload_layout(0, J, 0, hr.nbytes)
    assert buf.size == lay["size"] and lay["hr"] % 16 == 0
    ints = buf[:lay["qtable"]].view(np.int32)
    for k, a in (("gp", gp), ("hm", hm), ("jp", jp)):
        assert (ints[lay[k] // 4:lay[k] // 4 + J] == a).all(), k
    assert not buf[lay["qtable"]:lay["hr"]].any()
    assert (buf[lay["hr"]:].reshape(nh, L) == hr).all()
    with pytest.raises(ValueError, match="one entry per job"):
        vote.refbase_upload(gp, hr, hm[:-1], jp)


def _checked_votes(seen):
    """Stand-ins for vote.pallas_vote_window and pallas_vote_gathered that
    record, per launch, whether its refbase rows are named as the engine
    must name them: a window's jobs each their own row of the window's
    (distinct, in [0, Jw)); a gathered bucket's, with refsrc, rows in
    [0, Jw) of sources for every job of the window. Records ("window" or
    "sources" or "rows", ok)."""
    orig_w = vote.pallas_vote_window
    orig_g = vote.pallas_vote_gathered

    def window(seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp, qtable,
               class_args, **kw):
        ridx = vote.window_job_table(class_args, kw["classes"])[3]
        Jw = len(np.asarray(gp))
        seen.append(("window", len(np.unique(ridx)) == len(ridx)
                     and 0 <= ridx.min() and ridx.max() < Jw))
        return orig_w(seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp,
                      qtable, class_args, **kw)

    def gathered(*a, refsrc=None, **k):
        ok = a[7] is not None
        if refsrc is not None:
            ridx = np.asarray(refsrc[-1])
            ok = (a[7] is None and len(refsrc) == 6
                  and 0 <= ridx.min() and ridx.max() < len(refsrc[1]))
        seen.append(("rows" if refsrc is None else "sources", ok))
        return orig_g(*a, refsrc=refsrc, **k)

    return window, gathered


def _patch_votes(monkeypatch, seen):
    window, gathered = _checked_votes(seen)
    monkeypatch.setattr(vote, "pallas_vote_window", window)
    monkeypatch.setattr(vote, "pallas_vote_gathered", gathered)


def test_engine_refbase_rows_deep_panel(tmp_path, monkeypatch):
    bam, fa = workloads.deep_panel(str(tmp_path), n_fragments=2000)
    seen = []
    _patch_votes(monkeypatch, seen)
    monkeypatch.setenv("GENCORE_NO_STREAM", "1")
    assert cli.main(["-i", bam, "-o", str(tmp_path / "out.bam"), "-r", fa,
                     "--windows", "4", "--device", "cpu"]) == 0
    assert sum(kind == "window" for kind, _ok in seen) >= 4, seen
    assert all(ok for _kind, ok in seen), seen
    assert not any(kind == "rows" for kind, _ok in seen), seen


@pytest.mark.parametrize("name", list(gc.CASES))
def test_engine_refbase_rows_cases(name, tmp_path, monkeypatch):
    case = gc.CASES[name]
    seen = []
    _patch_votes(monkeypatch, seen)
    gc.run_route(case, "default", str(tmp_path), device="cpu")
    assert all(ok for _kind, ok in seen), seen
    if case.ref:
        assert any(kind == "window" for kind, _ok in seen), \
            "the case launched no window vote"
        assert not any(kind == "rows" for kind, _ok in seen), seen


def test_window_upload_exact_size():
    """window_upload fills a buffer of exactly its size from alloc, the
    same bytes it writes without one."""
    rng = np.random.default_rng(9)
    Jw, L = 40, 32
    classes = ((4, 10), (16, 6))
    class_args = []
    for K, J in classes:
        class_args += [rng.integers(0, 100, size=J).astype(np.uint16),
                       rng.integers(0, K + 1, size=J).astype(np.uint8),
                       rng.integers(0, L + 1, size=J).astype(np.uint16),
                       rng.choice(Jw, size=J, replace=False).astype(np.uint16)]
    gp = rng.integers(0, 1000, size=Jw).astype(np.int32)
    hm = np.full(Jw, -1, np.int16)
    jp = np.full(Jw, L, np.uint16)
    want, lay = vote.window_upload(class_args, classes, gp, hm, jp)
    room = []
    got, lay2 = vote.window_upload(
        class_args, classes, gp, hm, jp,
        alloc=lambda size: room.append(np.empty(size, np.uint8)) or room[0])
    assert lay2 == lay and got.tobytes() == want.tobytes()
    assert room[0].size == lay["size"] == want.size


def test_upload_checks_mate_dtype():
    """The mate rows' dtype follows mate32: u16 without it, u32 with it;
    either mismatch is refused before anything is uploaded."""
    for mate32 in (False, True):
        flags = dict(zip(kernels.UPLOAD_FLAGS, [False] * 8))
        flags.update(has_sedit=True, mate32=mate32)
        staging = workloads.upload_staging(np.random.default_rng(9), 40, 32,
                                           32, **flags)
        arrays = [*staging[:14], staging[15]]
        assert kernels._upload_checks(arrays, flags, 32, 32)[0] == 40
        wrong = np.uint16 if mate32 else np.uint32
        arrays[12] = arrays[12].astype(wrong)
        with pytest.raises(TypeError, match=f"mate is {np.dtype(wrong)}"):
            kernels._upload_checks(arrays, flags, 32, 32)
        with pytest.raises(ValueError, match="multiple of 16"):
            kernels._upload_checks(staging[:14] + staging[15:], flags, 32,
                                   40)


@pytest.mark.parametrize("N", [65_536, 65_537])
def test_pack_score_meta_mate_dtype(N):
    """u16 mate rows up to 65,536 rows (the JAX package's packing, byte for
    byte), u32 above: every row's mate fits."""
    from gencore_tpu import engine as jeng
    from gencore_tpu_torch import engine as teng
    rng = np.random.default_rng(N)
    rows = rng.permutation(N)[:2000].reshape(-1, 2)
    rows[0] = (N - 1, 0)     # the last row pairs with the first
    lrow, rrow = rows[:, 0], rows[:, 1]
    ls, rs = rng.integers(0, 150, size=(2, len(rows)))
    cl = rng.integers(-3, 150, size=len(rows))
    mate, meta = teng._pack_score_meta(N, lrow, rrow, ls, rs, cl)
    assert mate.dtype == (np.uint16 if N <= 1 << 16 else np.uint32)
    want = np.arange(N)
    want[lrow], want[rrow] = rrow, lrow
    assert (mate.astype(np.int64) == want).all()
    jmate, jmeta = jeng._pack_score_meta(N, lrow, rrow, ls, rs, cl)
    assert (meta == jmeta).all() and meta.dtype == jmeta.dtype
    if N <= 1 << 16:
        assert jmate.dtype == mate.dtype and (jmate == mate).all()
