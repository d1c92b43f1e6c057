"""On-card A/B of kernel source variants of csrc/vote.cu.

    python3 -m gencore_tpu_torch.tools.kernel_ab DIR_A DIR_B [...] [--profile]

Each DIR is a copy of gencore_tpu_torch/csrc with one change. The script
builds a kernel library from each (nvcc, as core/vote.py builds it, into
build/kernel_ab/<dir name>/), then for every shape runs the gathered
entry vote.vote_gathered (the vote with its epilogue, sparse with a qual
table, as the engine runs it) with each library in turns (A, B, ..., ...,
B, A), checks that all outputs are equal, and prints one JSON line per
shape with each variant's device ms per call (CUDA events around each
call, the stream kept busy ahead of them, median of 7). With --profile it
also prints each kernel's median duration by name from a torch.profiler
trace. Shapes: the deep piles of chip_smoke.py phase 2c at J in {8, 32,
128} and the k-classes 16, 64 and 256 of phase 2a at J = 4096. Needs a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SHAPES = ([("pile", J, K) for J, K in ((8, 512), (32, 2048), (32, 4096),
                                       (128, 4096))]
          + [("2a", 4096, K) for K in (16, 64, 256)])


def _kernel_medians(torch, cs, fn, reps=10):
    """{kernel name: median duration in ms} over a profiled run of fn."""
    from statistics import median

    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(cs.WORK, "kernel_ab_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    by = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            m = re.search(r"(\w+_kernel)<[^>]*?(Bins\d+)", e.get("name", ""))
            name = " ".join(m.groups()) if m else e.get("name", "")[:48]
            by.setdefault(name, []).append(float(e["dur"]) / 1e3)
    return {k: median(v) for k, v in by.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--profile", action="store_true")
    opts = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs
    from gencore_tpu_torch.core import vote
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(cs.WORK, exist_ok=True)
    dev = torch.device("cuda", 0)
    libs = {}
    for d in opts.dirs:
        vote.CSRC_DIR = os.path.abspath(d)
        vote.BUILD_DIR = os.path.join(REPO, "build", "kernel_ab",
                                      os.path.basename(os.path.normpath(d)))
        vote._lib = None
        libs[d] = vote.build_library()
    for kind, J, K in SHAPES:
        arrs = (cs._pile_inputs(np, K, J, 160, J + K) if kind == "pile"
                else cs._vote_inputs(np, K, J, 160, 40960, K))
        args, kw = cs._gathered_args(np, arrs, J + K, "sparse_qtable")
        gpu = [None if a is None else torch.from_numpy(a).to(dev)
               for a in args]

        def call():
            return vote.vote_gathered(*gpu, **kw)

        outs, ms, kernels = {}, {}, {}
        for d in list(libs) + list(libs)[::-1]:
            vote._lib = libs[d]
            outs[d] = call()
            ms.setdefault(d, []).append(cs._kernel_ms(torch, call, 7))
            if opts.profile and d not in kernels:
                kernels[d] = _kernel_medians(torch, cs, call)
        ref = outs[opts.dirs[0]]
        equal = all(cs._compare(o, ref)[0] == 0 for o in outs.values())
        print(json.dumps({"shape": kind, "J": J, "K": K, "split":
                          vote.split_size(K, J), "outputs_equal": equal,
                          "ms": ms, "kernel_ms": kernels or None}),
              flush=True)
        if not equal:
            return 1
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
