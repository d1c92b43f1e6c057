// The refbase row of a job, read where its bytes lie: a slice of the
// device genome or a host-built row. Shared by the window kernel
// (vote_window.cu), which stages each job's row while it votes, and the
// gathered vote (vote.cu), which reads each job's row by its index in the
// window's numbering; they replace the JAX package's refbase assembly,
// gencore_tpu/engine.py:3097 _refbase_combine_fn.

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

// A refbase row where it lies: byte p is row[p] below len, else 0.
struct RefRow {
  const uint8_t* row;
  int len;
};

// The genome start of a slice as jax.lax.dynamic_slice takes it: a
// negative start counts once from the end, then it clamps to [0, G - L].
__device__ __forceinline__ int genome_start(int g, int G, int L) {
  return clampi(g < 0 ? g + G : g, 0, G - L);
}

// Where a refbase row lies (vote.refbase_combine), from its fields hm,
// gp and jp: host row h, or the genome slice at g, zero at and beyond n.
__device__ __forceinline__ RefRow row_of(const RefSrc& s, int h, int g, int n,
                                         int L) {
  if (h >= 0) return {s.hr + static_cast<size_t>(clampi(h, 0, s.nh - 1)) * L, L};
  return {s.genome + genome_start(g, s.G, L), n};
}

// Byte p of a refbase row where it lies.
__device__ __forceinline__ int ref_byte(const RefRow& r, int p) {
  return p < r.len ? r.row[p] : 0;
}

}  // namespace gc_refsrc
