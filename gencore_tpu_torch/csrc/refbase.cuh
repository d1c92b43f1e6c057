// The refbase row of a job, read where its bytes lie: a slice of the
// device genome or a host-built row. Shared by the window kernel
// (vote_window.cu), which builds each row while it votes, and the
// standalone assembly of the routes that do not fuse the window
// (refbase.cu).

#pragma once

#include <stdint.h>

#include "staging.cuh"

namespace gc_refsrc {

using gc_staging::clampi;

// Where the refbase rows come from: per job r of the window, the genome
// start gp[r], host row hm[r] (< 0: the genome) and length jp[r]; host
// rows hr [nh, L]; the device genome [G] (G >= L).
struct RefSrc {
  const uint8_t* genome;
  const int32_t* gp;
  const int32_t* hm;
  const int32_t* jp;
  const uint8_t* hr;
  int G, nh;
};

// The genome start of a slice as jax.lax.dynamic_slice takes it: a
// negative start counts once from the end, then it clamps to [0, G - L].
__device__ __forceinline__ int genome_start(int g, int G, int L) {
  return clampi(g < 0 ? g + G : g, 0, G - L);
}

// Refbase row r at position p (vote.refbase_combine), read where it lies.
__device__ __forceinline__ int refbase_at(const RefSrc& s, int r, int p,
                                          int L) {
  const int h = s.hm[r];
  if (h >= 0) return s.hr[static_cast<size_t>(clampi(h, 0, s.nh - 1)) * L + p];
  if (p >= s.jp[r]) return 0;
  return s.genome[static_cast<size_t>(genome_start(s.gp[r], s.G, L)) + p];
}

}  // namespace gc_refsrc
