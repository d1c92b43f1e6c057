"""gencore_tpu_torch/tools/measure_rss.py on the CPU at a tiny size: one
JSON line with the residency of each mode, and the in-memory pipeline's
and the streaming path's outputs holding the same records."""

import json

from gencore_tpu_torch.tools import measure_rss


def test_measure_rss_prints_residency_and_equal_outputs(tmp_path, capsys):
    rc = measure_rss.main(["--fragments", "300", "--device", "cpu",
                           "--workdir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    res = json.loads(lines[0])
    assert res["outputs_identical"] is True
    assert res["fragments"] == 300 and res["device"] == "cpu"
    assert res["output_records"] > 100
    for mode in ("in_memory", "streaming"):
        for k in ("seconds", "peak_rss_mb", "sampled_rss_peak_mb",
                  "tracemalloc_peak_mb"):
            assert res[f"{mode}_{k}"] > 0, (mode, k)
        # here the kernel reports VmHWM; the 10 ms samples of the resident
        # set stay below it (statm and VmHWM may differ by a few pages)
        assert res[f"{mode}_peak_rss_from"] == "VmHWM"
        peak, sampled = (res[f"{mode}_peak_rss_mb"],
                         res[f"{mode}_sampled_rss_peak_mb"])
        assert peak / 2 < sampled <= peak * 1.01
        # CUDA residency only where the run was on a card
        assert f"{mode}_cuda_max_allocated_mb" not in res
    assert res["payload_mb"] is None or res["payload_mb"] > res["input_mb"]
