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

// ---- helpers of the coalesced kernels (merge, pending, merge_packed) ----

constexpr uint32_t PAD_WORD = 0x01010101u * PAD;  // four PAD bytes

// the number of bytes of x that are not 0 (every byte < 0x80)
__device__ __forceinline__ int nonzero_bytes(uint32_t x) {
  return __popc((x + 0x7F7F7F7Fu) & 0x80808080u);
}

// The 16 bytes at byte offset `off` (any alignment) of a 16-byte-aligned
// shared buffer: five aligned words funnel-shifted with __byte_perm.  The
// buffer must be readable up to the word that holds byte off + 19.
__device__ __forceinline__ uint4 window16(const uint8_t* buf, int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf) + (off >> 2);
  const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)(off & 3);
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
  return make_uint4(__byte_perm(w0, w1, sel), __byte_perm(w1, w2, sel),
                    __byte_perm(w2, w3, sel), __byte_perm(w3, w4, sel));
}

// Counts of the 6 symbols among 16 symbols held one a byte in v (every
// byte < 16), packed three to a word in 8-bit fields: a = c0 | c1 << 8 |
// c2 << 16, b = c3 | c4 << 8 | c5 << 16.  Bit-sliced: the 16 bytes fold
// into 16 nibbles (z0, z1), bit i of every nibble is gathered into plane
// p_i (z0's in bit 0 of a nibble, z1's in bit 1), and a symbol's 16 match
// flags are one three-input logic operation on the planes, counted by one
// __popc: about 40 instructions for the 96 compares and adds of a count
// symbol by symbol.
__device__ __forceinline__ void count16_packed(uint4 v, uint32_t& a,
                                               uint32_t& b) {
  constexpr uint32_t L = 0x11111111u, H = 0x22222222u;
  const uint32_t z0 = v.x | (v.y << 4), z1 = v.z | (v.w << 4);
  const uint32_t p0 = (z0 & L) | ((z1 << 1) & H);
  const uint32_t p1 = ((z0 >> 1) & L) | (z1 & H);
  const uint32_t p2 = ((z0 >> 2) & L) | ((z1 >> 1) & H);
  const uint32_t p3 = ((z0 >> 3) & L) | ((z1 >> 2) & H);
  const uint32_t up = p2 | p3;    // not one of 0..3
  const uint32_t mid = p2 & ~p3;  // one of 4..7
  const uint32_t c0 = __popc(~(p0 | p1 | up) & (L | H));
  const uint32_t c1 = __popc(p0 & ~p1 & ~up);
  const uint32_t c2 = __popc(~p0 & p1 & ~up);
  const uint32_t c3 = __popc(p0 & p1 & ~up);
  const uint32_t c4 = __popc(~p0 & ~p1 & mid);
  const uint32_t c5 = __popc(p0 & ~p1 & mid);
  a = c0 | c1 << 8 | c2 << 16;
  b = c3 | c4 << 8 | c5 << 16;
}

// Row counts from count16_packed: 8 consecutive lanes cover one 128-symbol
// row, whose counts (at most 128 each) still fit the 8-bit fields, so the
// 8-lane sum is 6 shuffles.  Lanes 0-5 of each group then write one count
// each: a warp's four rows go out as 96 consecutive bytes.  `row_out` is
// the group's row.
__device__ __forceinline__ void write_row_counts_packed(uint32_t a, uint32_t b,
                                                        int32_t* row_out) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int g = threadIdx.x & 7;
  if (g < NSYM)
    row_out[g] = (int32_t)(((g < 3 ? a : b) >> (8 * (g % 3))) & 0xFFu);
}

}  // namespace rb2
