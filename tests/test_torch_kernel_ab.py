"""gencore_tpu_torch/tools/kernel_ab.py on the CPU: which wrapper module
drives the library built from each variant's csrc directory, and the CPU
side of --upload (its arguments, its shapes and which variants run each).
The A/B itself builds and times kernels, so it needs a card."""

import pathlib

import pytest

from gencore_tpu_torch.core import vote
from gencore_tpu_torch.tools import kernel_ab


def test_wrapper_of_each_variant(tmp_path):
    # the csrc directory of another checkout runs with that checkout's
    # core/vote.py (its own upload layout and launch arguments)
    pkg = tmp_path / "other" / "gencore_tpu_torch"
    (pkg / "core").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    other = pkg / "core" / "vote.py"
    other.write_text(pathlib.Path(vote.__file__).read_text()
                     + "\nCHECKOUT = 'other'\n")
    mod = kernel_ab._wrapper(str(pkg / "csrc"), vote)
    assert mod is not vote and mod.CHECKOUT == "other"
    assert pathlib.Path(mod.__file__) == other
    # a bare copy of csrc runs with this checkout's wrapper, in a module
    # of its own, so that the variants' libraries and counters stay apart
    bare = tmp_path / "variant" / "csrc"
    bare.mkdir(parents=True)
    a = kernel_ab._wrapper(str(bare), vote)
    b = kernel_ab._wrapper(str(bare), vote)
    assert a is not vote and a is not b
    assert a.__file__ == vote.__file__ and not hasattr(a, "CHECKOUT")
    a.WINDOW_LAUNCHES += 5
    assert b.WINDOW_LAUNCHES == 0


def test_upload_arguments():
    opts = kernel_ab.parse_args(["A", "B", "--upload", "--reps", "20",
                                 "--rounds", "2"])
    assert opts.dirs == ["A", "B"] and opts.upload and not opts.window
    assert (opts.reps, opts.rounds) == (20, 2)
    opts = kernel_ab.parse_args(["A"])
    assert not opts.upload and not opts.window and opts.rounds == 1
    with pytest.raises(SystemExit):   # one entry at a time
        kernel_ab.parse_args(["A", "--upload", "--window"])


def test_upload_shapes_leave_out_variants_without_mate32(tmp_path):
    """The generated --upload shapes: phase 2e's 48,000 rows with u16 mate
    rows for every variant, then 72,000 rows with u32 mate rows for the
    variants whose upload_score takes mate32 (a checkout from before it,
    here a copy of core/kernels.py whose upload_score lacks it, is left
    out)."""
    from gencore_tpu_torch.core import kernels
    pkg = tmp_path / "old" / "gencore_tpu_torch"
    (pkg / "core").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    src = pathlib.Path(kernels.__file__).read_text()
    assert src.count("mate32=False,") == 1
    (pkg / "core" / "kernels.py").write_text(src.replace("mate32=False,",
                                                         ""))
    old = kernel_ab._kernels_module(str(pkg / "csrc"), vote, kernels)
    new = kernel_ab._kernels_module(str(tmp_path / "variant" / "csrc"), vote,
                                    kernels)
    assert old.vote is vote and new is not kernels
    assert not kernel_ab.takes_mate32(old) and kernel_ab.takes_mate32(new)
    shapes = kernel_ab.upload_shapes({"old": old, "new": new})
    assert [(name, n, m32) for name, n, m32, _ in shapes] == [
        ("2e", 48_000, False), ("mate32", 72_000, True)]
    assert shapes[0][3] == ["old", "new"] and shapes[1][3] == ["new"]
    assert all(n > 1 << 16 for _, n, m32, _ in shapes if m32)


def _chip_smoke_constants(*names):
    """Module-level constants of chip_smoke.py, read without importing it
    (its import blocks JAX for the whole process)."""
    import ast
    import types
    tree = ast.parse((pathlib.Path(__file__).parent.parent
                      / "chip_smoke.py").read_text())
    found = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and getattr(node.targets[0], "id", None) in names:
            found[node.targets[0].id] = ast.literal_eval(node.value)
    assert set(found) == set(names)
    return types.SimpleNamespace(**found)


def test_dense_arguments():
    opts = kernel_ab.parse_args(["A", "B", "--dense", "--rounds", "2"])
    assert opts.dense and not opts.upload and not opts.window
    assert opts.rounds == 2
    assert not kernel_ab.parse_args(["A"]).dense
    for other in ("--upload", "--window"):
        with pytest.raises(SystemExit):   # one entry at a time
            kernel_ab.parse_args(["A", "--dense", other])


def test_dense_shapes_are_phase_2f():
    """--dense's generated shapes: phase 2f's timed unpacks (each of
    DENSE_SHAPES with its mode pair) and its timed score maps, packed and
    int32 (the long_amplicon panel's recorded calls follow them)."""
    cs = _chip_smoke_constants("DENSE_SHAPES", "DENSE_TIMED_MODES",
                               "DENSE_SCORE_SHAPES")
    shapes = kernel_ab.dense_shapes(cs)
    assert shapes == [
        ("upload_unpack", "2f", dict(n=239_499, w=152, L=160,
                                     seq_mode="2bit", qual_mode="2bit")),
        ("upload_unpack", "2f", dict(n=48_000, w=304, L=320,
                                     seq_mode="2bit", qual_mode="raw")),
        ("score_map", "2f", dict(N=48_000, L=160, packed=True)),
        ("score_map", "2f", dict(N=239_499, L=160, packed=False)),
        ("score_map", "2f", dict(N=48_000, L=320, packed=False))]
    assert set(kernel_ab.DENSE_SPLIT_PARTS) == {"upload_unpack",
                                                "score_map"}


def test_takes_refsrc_of_each_variant(tmp_path):
    """The gathered A/B runs the refbase source form only for variants
    whose vote_gathered takes `refsrc` (a checkout from before it, here a
    copy of core/vote.py without the keyword, runs the rows form
    alone)."""
    assert kernel_ab.takes_refsrc(vote)
    pkg = tmp_path / "old" / "gencore_tpu_torch"
    (pkg / "core").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    src = pathlib.Path(vote.__file__).read_text()
    old = ("                  ratio_num, ratio_den, out_len=None, sparse=False,\n"
           "                  refsrc=None):")
    assert src.count(old) == 1
    (pkg / "core" / "vote.py").write_text(src.replace(
        old, "                  ratio_num, ratio_den, out_len=None, "
             "sparse=False):"))
    assert not kernel_ab.takes_refsrc(kernel_ab._wrapper(str(pkg / "csrc"),
                                                         vote))


def test_bucket_calls_match_the_rows_form():
    """The gathered A/B's host timing calls for this checkout
    (kernel_ab.bucket_calls: the window's refbase sources sent up once,
    then a bucket dispatched from host arrays with its rows named by
    index, as the engine does) on CPU tensors, where the plain twin runs:
    the bucket equals the rows form given vote.refbase_rows, and the
    window call gives the sources it was handed."""
    import numpy as np
    import torch
    rng = np.random.default_rng(3)
    K, J, L, N, Jw = 4, 6, 32, 40, 9
    seq = rng.choice(np.array([1, 2, 4, 8], np.uint8), size=(N, L))
    qual = rng.integers(2, 42, size=(N, L)).astype(np.uint8)
    score = rng.integers(-3, 13, size=(N, L)).astype(np.int8)
    rows = rng.integers(0, N, size=(K, J)).astype(np.int32)
    valid = (rng.random((K, J)) < 0.8).astype(np.uint8)
    jl = rng.integers(L // 2, L + 1, size=J).astype(np.int32)
    qtable = np.arange(16, dtype=np.uint8)
    genome = torch.from_numpy(np.pad(rng.choice(
        np.array([1, 2, 4, 8], np.uint8), size=400), (0, 64)))
    gp = rng.integers(-50, 500, size=Jw).astype(np.int32)
    hm = rng.integers(-1, 3, size=Jw).astype(np.int16)
    jp = rng.integers(0, L + 1, size=Jw).astype(np.uint16)
    hr = rng.choice(np.array([0, 1, 2, 4, 8], np.uint8), size=(2, L))
    ridx = torch.from_numpy(rng.integers(0, Jw + 2, size=J).astype(np.int32))
    src = (*vote.window_refsrc(genome, gp, hm, jp, hr), ridx)
    gpu = [torch.from_numpy(a) for a in (seq, qual, score, rows, rows[0],
                                         valid, jl)]
    gpu += [vote.refbase_rows(src, L), torch.from_numpy(qtable)]
    kw = dict(hi=30, mod=20, lo=15, base_score_req=6, ratio_num=4,
              ratio_den=5, out_len=L, sparse=True)
    window, bucket = kernel_ab.bucket_calls(vote, gpu, src, kw)
    want = vote.vote_gathered_plain(*gpu, **kw)
    got = bucket()
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    for a, b in zip(got[4], want[4]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(window(), src[:5]))
