// The refbase rows of a window's jobs, for the routes that do not fuse
// the window (the ultra-deep pile's leftover buckets, GENCORE_NO_SPARSE,
// an output length above 256, GENCORE_NO_CONTIG_VOTE): row r is the
// device genome's slice at gp[r] where hm[r] < 0 (zero at and beyond
// jp[r]), else the host-built row hm[r].
//
// Replaces the JAX package's jitted refbase assembly,
// gencore_tpu/engine.py:3097 _refbase_combine_fn (a vmapped
// dynamic_slice of the genome, a host-row gather and a select), which the
// port ran as ~18 plain-torch launches and four host-to-device copies per
// call (core/vote.py refbase_combine, now this kernel's twin).
//
// Bound: bytes. Each output byte is written once and read from one
// source byte (a genome byte or a host-row byte); per row the kernel
// reads 12 bytes of sources. A thread per output byte, consecutive
// threads on consecutive positions of a row, so the genome and host-row
// reads and the row writes coalesce. The sources' upload is the host's
// one pinned copy (vote.refbase_upload).

#include <cuda_runtime.h>
#include <stdint.h>

#include "refbase.cuh"

namespace {

using gc_refsrc::RefSrc;
using gc_refsrc::refbase_at;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) refbase_kernel(const RefSrc s, uint8_t* out,
                                                           int J, int L) {
  const size_t total = static_cast<size_t>(J) * L;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    const int r = static_cast<int>(i / L);
    const int p = static_cast<int>(i - static_cast<size_t>(r) * L);
    out[i] = static_cast<uint8_t>(refbase_at(s, r, p, L));
  }
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 = success). genome u8 [G]
// (G >= L); gp, hm, jp i32 [J]; hr u8 [nh, L] (nh >= 1); out u8 [J, L].
extern "C" int gc_refbase(const void* genome, const void* gp, const void* hm,
                          const void* jp, const void* hr, void* out, int G, int nh,
                          int J, int L, void* stream) {
  if (J <= 0) return 0;
  if (L <= 0 || G < L || nh <= 0) return static_cast<int>(cudaErrorInvalidValue);
  RefSrc s;
  s.genome = static_cast<const uint8_t*>(genome);
  s.gp = static_cast<const int32_t*>(gp);
  s.hm = static_cast<const int32_t*>(hm);
  s.jp = static_cast<const int32_t*>(jp);
  s.hr = static_cast<const uint8_t*>(hr);
  s.G = G;
  s.nh = nh;
  const size_t total = static_cast<size_t>(J) * L;
  const size_t want = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  refbase_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<uint8_t*>(out), J, L);
  return static_cast<int>(cudaGetLastError());
}
