// Shared pieces of the merge kernels: geometry and a block-wide scan.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rb2 {

constexpr int BS = 4096;          // output symbols (or pending rows) per CTA
constexpr int THREADS = 256;      // threads per CTA
constexpr int PER = BS / THREADS; // 16 consecutive outputs per thread
constexpr int LANE = 128;         // symbols per count row
constexpr int NSYM = 6;
constexpr int WARPS = THREADS / 32;
constexpr int8_t PAD = 6;

// Exclusive prefix of one int per thread over the CTA, in thread order.
// Returns the thread's exclusive prefix; `warp_tot` is WARPS ints of shared
// scratch.  Contains __syncthreads(): every thread of the CTA must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < WARPS) warp_tot[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  return (warp ? warp_tot[warp - 1] : 0) + x - v;
}

// Per-row symbol counts: each thread holds PER consecutive symbols, so 8
// consecutive lanes cover one 128-symbol row.  Sums the 6 counters over
// those 8 lanes; lane 0 of each group writes the row.
__device__ __forceinline__ void write_row_counts(int (&cs)[NSYM],
                                                 int32_t* row_out) {
#pragma unroll
  for (int s = 0; s < NSYM; ++s) {
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      cs[s] += __shfl_xor_sync(0xffffffffu, cs[s], o);
  }
  if ((threadIdx.x & 7) == 0) {
#pragma unroll
    for (int s = 0; s < NSYM; ++s) row_out[s] = cs[s];
  }
}

}  // namespace rb2
