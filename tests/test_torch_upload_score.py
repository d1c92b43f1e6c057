"""The host side of the upload-and-score kernel and of the window kernel's
unreferenced refbase rows, on the CPU.

* The kernel's one upload (kernels.upload_score_pack) holds the staging's
  15 host arrays in their own dtypes: unpacked, it equals them, every part
  16-byte aligned, the barrier bytes zero; the refbase kernel's upload
  (vote.refbase_upload) likewise.
* The engine's list of the refbase rows that no window class votes with,
  which it passes to the window kernel, equals vote.unreferenced_rows of
  the launch's job table, on every window of the deep panel (a small
  scale of its recipe) and on every case of the case matrix
  (tools/golden_compare.py)."""

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
    assert lay == vote.window_upload_layout(0, J, 0, 0, hr.nbytes)
    assert buf.size == lay["size"] and lay["hr"] % 16 == 0
    ints = buf[:lay["qtable"]].view(np.int32)
    for k, a in (("gp", gp), ("hm", hm), ("jp", jp)):
        assert (ints[lay[k] // 4:lay[k] // 4 + J] == a).all(), k
    assert not buf[lay["qtable"]:lay["hr"]].any()
    assert (buf[lay["hr"]:].reshape(nh, L) == hr).all()
    with pytest.raises(ValueError, match="one entry per job"):
        vote.refbase_upload(gp, hr, hm[:-1], jp)


def _checked_window(seen):
    """vote.pallas_vote_window that first holds the engine's `unref` to
    unreferenced_rows of the launch's job table."""
    orig = vote.pallas_vote_window

    def f(seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp, qtable,
          class_args, **kw):
        tab = vote.window_job_table(class_args, kw["classes"])
        want = vote.unreferenced_rows(tab[3], len(np.asarray(gp)))
        got = kw["unref"]
        seen.append((got.dtype == np.int32 and np.array_equal(got, want),
                     len(want), len(np.asarray(gp))))
        return orig(seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp,
                    qtable, class_args, **kw)

    return f


def test_engine_unreferenced_rows_deep_panel(tmp_path, monkeypatch):
    bam, fa = workloads.deep_panel(str(tmp_path), n_fragments=2000)
    seen = []
    monkeypatch.setattr(vote, "pallas_vote_window", _checked_window(seen))
    monkeypatch.setenv("GENCORE_NO_STREAM", "1")
    assert cli.main(["-i", bam, "-o", str(tmp_path / "out.bam"), "-r", fa,
                     "--windows", "4", "--device", "cpu"]) == 0
    assert len(seen) >= 4, seen
    assert all(ok for ok, _nu, _jw in seen), seen
    assert any(nu < jw for _ok, nu, jw in seen)


@pytest.mark.parametrize("name", list(gc.CASES))
def test_engine_unreferenced_rows_cases(name, tmp_path, monkeypatch):
    case = gc.CASES[name]
    seen = []
    monkeypatch.setattr(vote, "pallas_vote_window", _checked_window(seen))
    gc.run_route(case, "default", str(tmp_path), device="cpu")
    assert all(ok for ok, _nu, _jw in seen), seen
    if case.ref:
        assert seen, "the case launched no window vote"


def test_window_upload_with_the_engine_list():
    """window_upload with `unref` given writes what it computes without,
    into a buffer of exactly its size."""
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
    unref = vote.unreferenced_rows(
        vote.window_job_table(class_args, classes)[3], Jw)
    room = []
    got, lay2 = vote.window_upload(
        class_args, classes, gp, hm, jp, unref=unref,
        alloc=lambda size: room.append(np.empty(size, np.uint8)) or room[0])
    assert lay2 == lay and got.tobytes() == want.tobytes()
    assert room[0].size == lay["size"]


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
