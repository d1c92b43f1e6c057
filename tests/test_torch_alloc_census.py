"""gencore_tpu_torch/tools/alloc_census.py's reading of torch.profiler's
memory events (the census itself runs the deep panel: minutes)."""

from gencore_tpu_torch.tools import alloc_census

MB = 1 << 20


def test_torch_peak_from_memory_events():
    def mem(ts, addr, nbytes, total):
        return {"name": "[memory]", "ts": ts,
                "args": {"Addr": addr, "Bytes": nbytes,
                         "Total Allocated": total}}
    events = [
        mem(1, 10, 8 * MB, 8 * MB),
        mem(2, 11, 3 * MB, 11 * MB),
        mem(3, 12, 1024, 11 * MB + 1024),
        mem(4, 10, -8 * MB, 3 * MB + 1024),        # freed before the peak
        mem(5, 13, 9 * MB, 12 * MB + 1024),        # the peak
        mem(6, 13, -9 * MB, 3 * MB + 1024),
        {"name": "aten::where", "ph": "X", "cat": "cpu_op", "ts": 4.5,
         "dur": 1.0},
        {"name": "aten::add", "ph": "X", "cat": "cpu_op", "ts": 1, "dur": 1},
    ]
    peak = alloc_census._torch_peak(events)
    assert peak["total_mb"] == (12 * MB + 1024) / MB
    assert peak["in_op"] == "aten::where"
    assert peak["blocks_over_1mb"] == 2 and peak["block_mb"] == [9.0, 3.0]
    assert alloc_census._torch_peak([]) is None
