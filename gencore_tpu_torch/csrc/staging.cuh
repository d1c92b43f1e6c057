// Shared-memory staging of member rows with cp.async, shared by the two
// vote kernels (vote.cu and vote_window.cu).
//
// A member row is three byte arrays of the [N, L] matrices (seq, qual,
// score). stage_rows copies one segment of each, 16 bytes per thread and
// instruction, into a buffer laid out [member][seq | qual | score][W];
// the caller commits the group and waits for it (cp_async_commit /
// cp_async_wait), so the copy of one chunk of members is in flight while
// the previous chunk is voted. Requires 16-byte aligned matrices, L % 16
// == 0, and a segment [seg, seg + W) with seg % 16 == 0 and W % 16 == 0.

#pragma once

#include <stdint.h>

namespace gc_staging {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Start copying bytes [seg, seg + W) of members 0..m-1 into `buf`; member
// mi is matrix row row_of(mi) (already clamped to the matrix).
template <class RowOf>
__device__ __forceinline__ void stage_rows(uint8_t* buf,
                                           const uint8_t* __restrict__ seq,
                                           const uint8_t* __restrict__ qual,
                                           const int8_t* __restrict__ score,
                                           RowOf row_of, int m, int L, int seg,
                                           int W) {
  const int vpr = W >> 4;  // 16-byte vectors per array
  const int per_member = 3 * vpr;
  const int total = m * per_member;
  for (int v = threadIdx.x; v < total; v += blockDim.x) {
    const int mi = v / per_member;
    const int rem = v - mi * per_member;
    const int a = rem / vpr;
    const int off = (rem - a * vpr) << 4;
    const uint8_t* src =
        a == 0 ? seq : (a == 1 ? qual : reinterpret_cast<const uint8_t*>(score));
    cp_async16(buf + static_cast<size_t>(mi * 3 + a) * W + off,
               src + static_cast<size_t>(row_of(mi)) * L + seg + off);
  }
}

}  // namespace gc_staging
