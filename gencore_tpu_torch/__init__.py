"""gencore_tpu_torch — the gencore-tpu consensus engine on PyTorch and CUDA.

A second package beside the JAX reference (`gencore_tpu`): the same
BAM-to-BAM consensus path (windowed decode, clustering, overlap scoring,
consensus vote, duplex merge, reports) with every device program in plain
PyTorch and the consensus vote as hand-written CUDA kernels for Hopper
(`csrc/vote_window.cu` on the window path, `csrc/vote.cu` on the others).

The package is self-contained: it keeps its own copies of the host modules
it shares with `gencore_tpu` (io, options, stats, report, utils/cigar,
utils/umi, core/{oracle,grouping,postmerge,cigartable,umivec,output}) under
the same relative names, and imports neither JAX nor anything of
`gencore_tpu`: `tests/test_torch_nojax.py` imports every module with both
blocked.
"""

__version__ = "0.1.0"
