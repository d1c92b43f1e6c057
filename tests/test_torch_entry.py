"""The port's entry points (gencore_tpu_torch/entry.py) on the CPU:
entry() against the JAX package's __graft_entry__.entry() on the same
example batch, exact (int32 outputs); dryrun_multichip over two CPU
"devices" at a reduced size; and the default device raising without a
card."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from gencore_tpu_torch import entry

torch.set_num_threads(1)


def test_entry_matches_the_jax_entry():
    fn, args = entry.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    assert tuple(args[0].shape) == (256, 4, 128)
    jfn, jargs = jax_entry.entry()
    for a, j in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(j))
    got = fn(*args)
    want = jfn(*jargs)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy().astype(np.int64), w.astype(np.int64))
    assert int(got[2].sum()) > 0   # some positions changed


def test_entry_default_device_is_cuda():
    if torch.cuda.is_available():
        fn, args = entry.entry()
        assert args[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.entry()


def test_dryrun_multichip_on_two_cpu_devices(capsys):
    res = entry.dryrun_multichip(2, device="cpu", n_fragments=2000,
                                 busy_reps=2)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): ") and line.endswith(" OK")
    assert "padded-rows-per-window=none(the port pads no rows)" in line
    assert res["record_equivalent"] and res["records"] > 1000
    assert res["devices"] == ["cpu", "cpu"]
    assert len(res["psum_stats"]) == len(entry.STAT_COUNTERS)
    assert min(res["psum_stats"][:3]) > 0   # reads, bases, SSCS
    assert len(res["planned_rows_per_window"]) == 2
    assert res["planned_rows_spread"] < 0.05
    assert len(res["device_busy_per_window"]) == 2
