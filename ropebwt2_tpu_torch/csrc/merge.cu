// Merge kernel: apply one BCR round's (or one pending flush's) insertions to
// the flat int8 BWT and emit per-128-symbol counts of the 6 symbols.
//
// Replaces: ropebwt2_tpu/index/merge_pallas.py, merge_pallas ->
// _merge_kernel/_merge_body (the TPU kernel).
//
// What it computes: output position p takes insmap[p]-1 where insmap[p] != 0
// (an insertion destination pos+stream), else old[p - c(p)], with c(p) the
// number of destinations <= p.  Work stops at the live prefix n + #ins:
// CTAs wholly past it write zero counts and return.
//
// What bounds it on the card: bytes.  Per live symbol it reads 2 B (old
// symbol, insmap byte) and writes 1 B, plus 24 B of counts per 128-symbol
// row; the arithmetic is a few integer ops per byte.  So it is a streaming
// pass bound by HBM bandwidth.
//
// What the design does about it: one pass, one CTA per 4096-symbol output
// block.  The block's insertion prefix start[b] comes from outside (an
// M-sized scatter and a small cumsum), so a CTA knows where its old
// symbols begin without looking at other blocks: they are the contiguous
// run old[b*4096 - start[b] ...].  The CTA stages that run in shared memory
// with coalesced byte loads, reads its insmap bytes as one 16-byte load per
// thread, scans the insertion flags CTA-wide, and writes 16 output bytes
// per thread as one 16-byte store.  None of the TPU kernel's machinery
// (log-shift expand, aligned DMA windows, double buffering) is needed.

#include "common.cuh"

using namespace rb2;

namespace {

union Chunk {
  uint4 v;
  int8_t b[PER];
};

__global__ void __launch_bounds__(THREADS)
merge_kernel(const int8_t* __restrict__ old, const int8_t* __restrict__ insmap,
             const int64_t* __restrict__ start,
             const int64_t* __restrict__ n_ptr, int8_t* __restrict__ out,
             int32_t* __restrict__ rows, int64_t alloc, int64_t nb) {
  __shared__ int8_t win[BS];
  __shared__ int warp_tot[WARPS];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t p0 = b * BS;
  int32_t* row_out = rows + (b * (BS / LANE) + (t >> 3)) * NSYM;

  if (p0 >= *n_ptr + start[nb]) {  // wholly past the live prefix
    if ((t & 7) == 0) {
#pragma unroll
      for (int s = 0; s < NSYM; ++s) row_out[s] = 0;
    }
    return;
  }

  // this block's old symbols are the contiguous run starting at o0
  const int64_t o0 = p0 - start[b];
  for (int i = t; i < BS; i += THREADS) {
    const int64_t q = o0 + i;
    win[i] = q < alloc ? old[q] : PAD;
  }

  const int64_t pt = p0 + (int64_t)t * PER;
  Chunk ins;
  ins.v = *reinterpret_cast<const uint4*>(insmap + pt);
  int k = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) k += ins.b[j] != 0;
  // insertions before this thread's first position (also the barrier that
  // publishes the staged window)
  int c = block_exclusive_scan(k, warp_tot);

  Chunk o;
  int cs[NSYM] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    int8_t v;
    if (ins.b[j]) {
      v = ins.b[j] - 1;
      ++c;
    } else {
      v = win[t * PER + j - c];
    }
    o.b[j] = v;
#pragma unroll
    for (int s = 0; s < NSYM; ++s) cs[s] += v == s;
  }
  if (pt + PER <= alloc) *reinterpret_cast<uint4*>(out + pt) = o.v;
  write_row_counts(cs, row_out);
}

}  // namespace

// old: int8[alloc]; insmap: int8[nb*4096] (sym+1 at destinations, else 0);
// start: int64[nb+1] exclusive per-block insertion prefix; n: int64 scalar
// on the device; out: int8[alloc]; rows: int32[nb*32, 6].
// alloc % 16 == 0.  Returns cudaGetLastError().
extern "C" int rb2_merge(const void* old, const void* insmap,
                         const void* start, const void* n, void* out,
                         void* rows, long long alloc, long long nb,
                         void* stream) {
  if (nb > 0) {
    merge_kernel<<<(unsigned)nb, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)old, (const int8_t*)insmap, (const int64_t*)start,
        (const int64_t*)n, (int8_t*)out, (int32_t*)rows, alloc, nb);
  }
  return (int)cudaGetLastError();
}
