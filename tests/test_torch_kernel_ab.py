"""gencore_tpu_torch/tools/kernel_ab.py on the CPU: which wrapper module
drives the library built from each variant's csrc directory. The A/B
itself builds and times kernels, so it needs a card."""

import pathlib

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
