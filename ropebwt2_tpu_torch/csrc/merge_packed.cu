// Packed merge kernel: apply one BCR round's (or one pending flush's)
// insertions to the 4-bit packed BWT and emit per-plane counts of the 6
// symbols for every packed row.
//
// Replaces: ropebwt2_tpu/index/merge_pallas_packed.py, merge_pallas_packed
// -> _merge_kernel_packed/_merge_body_packed (the TPU kernel).
//
// Layout (index/packed.py): symbol p lives in byte (p >> 8) * 128 +
// (p & 127), low nibble when symbol row p >> 7 is even, high when odd.  So
// the 4096 output symbols [4096 b, 4096 b + 4096) of one CTA are exactly
// the 2048 bytes of packed rows [16 b, 16 b + 16).
//
// What it computes: the same merge as merge.cu.  Output position p takes
// the insertion nibble minus 1 where the packed insertion map has one,
// else old[p - c(p)], with c(p) the number of destinations <= p.  CTAs
// wholly past the live prefix n + #ins write zero counts and return.
//
// What bounds it on the card: bytes.  Per live symbol it reads 0.5 B of old
// data and 0.5 B of insertion map and writes 0.5 B, plus 48 B of counts per
// 256 symbols: about 1.7 B per symbol, against merge.cu's ~3.2.
//
// What the design does about it: one pass, one CTA per 4096-symbol output
// block, as in merge.cu.  The block's insertion prefix start[b] comes from
// outside, so its old symbols are the contiguous run from p0 - start[b];
// the CTA unpacks that run from nibbles into shared memory.  Each thread
// owns 16 consecutive outputs of one symbol row: it reads their insertion
// nibbles as one 16-byte load, a CTA-wide scan of the insertion flags
// gives each thread its shift, and it gathers from shared memory.  The
// thread holding the high plane of a byte hands its 16 symbols to the
// thread holding the low plane (a warp shuffle: they are 8 lanes apart),
// which stores the 16 packed bytes as one 16-byte store.  None of the TPU
// kernel's machinery (log-shift ladder, plane-algebra rotates, 2048-symbol
// window alignment, MXU counts, double buffering) is needed: it exists
// because Mosaic has no gather.

#include "common.cuh"

using namespace rb2;

namespace {

union Chunk {
  uint4 v;
  uint8_t b[PER];
  uint32_t w[PER / 4];
};

// byte of symbol p: packed row p >> 8 holds 128 bytes
__device__ __forceinline__ int64_t byte_of(int64_t p) {
  return (p >> 8) * LANE + (p & (LANE - 1));
}

__global__ void __launch_bounds__(THREADS)
merge_packed_kernel(const uint8_t* __restrict__ old,
                    const uint8_t* __restrict__ insmap,
                    const int64_t* __restrict__ start,
                    const int64_t* __restrict__ n_ptr,
                    uint8_t* __restrict__ out, int32_t* __restrict__ rows,
                    int64_t alloc_bytes, int64_t nb) {
  __shared__ uint8_t win[BS];
  __shared__ int warp_tot[WARPS];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t p0 = b * BS;
  // symbol row of this thread's 16 outputs, in the CTA and globally
  int32_t* row_out = rows + (b * (BS / LANE) + (t >> 3)) * NSYM;

  if (p0 >= *n_ptr + start[nb]) {  // wholly past the live prefix
    if ((t & 7) == 0) {
#pragma unroll
      for (int s = 0; s < NSYM; ++s) row_out[s] = 0;
    }
    return;
  }

  // this block's old symbols are the contiguous run starting at o0
  const int64_t alloc_syms = 2 * alloc_bytes;
  const int64_t o0 = p0 - start[b];
  for (int i = t; i < BS; i += THREADS) {
    const int64_t q = o0 + i;
    uint8_t v = PAD;
    if (q < alloc_syms) {
      const uint8_t byte = old[byte_of(q)];
      v = ((q >> 7) & 1) ? (byte >> 4) : (byte & 0xF);
    }
    win[i] = v;
  }

  // 16 outputs of one plane of one packed row: 16 contiguous map bytes
  const int64_t pt = p0 + (int64_t)t * PER;
  const int hi = (t >> 3) & 1;  // p0 / 128 is even, so the plane is t's
  Chunk ins;
  ins.v = *reinterpret_cast<const uint4*>(insmap + byte_of(pt));
  uint8_t nib[PER];
  int k = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    nib[j] = hi ? (ins.b[j] >> 4) : (ins.b[j] & 0xF);
    k += nib[j] != 0;
  }
  // insertions before this thread's first position (also the barrier that
  // publishes the staged window)
  int c = block_exclusive_scan(k, warp_tot);

  Chunk o;
  int cs[NSYM] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    uint8_t v;
    if (nib[j]) {
      v = nib[j] - 1;
      ++c;
    } else {
      v = win[t * PER + j - c];
    }
    o.b[j] = v;
#pragma unroll
    for (int s = 0; s < NSYM; ++s) cs[s] += v == s;
  }
  // the high-plane thread of each byte run is 8 lanes above its low one
#pragma unroll
  for (int w = 0; w < PER / 4; ++w) {
    const uint32_t up = __shfl_down_sync(0xffffffffu, o.w[w], 8);
    o.w[w] |= up << 4;  // nibbles are < 16: no carry across bytes
  }
  const int64_t ob = byte_of(pt);
  if (!hi && ob + PER <= alloc_bytes) *reinterpret_cast<uint4*>(out + ob) = o.v;
  write_row_counts(cs, row_out);
}

}  // namespace

// old: uint8[alloc_bytes] packed; insmap: uint8[nb*2048] packed insertion
// nibbles (sym+1 at destinations, else 0); start: int64[nb+1] exclusive
// per-block insertion prefix; n: int64 scalar on the device; out:
// uint8[alloc_bytes]; rows: int32[nb*32, 6], one row per 128-symbol row
// (packed row r's low plane is row 2r, its high plane row 2r+1).
// alloc_bytes % 128 == 0.  Returns cudaGetLastError().
extern "C" int rb2_merge_packed(const void* old, const void* insmap,
                                const void* start, const void* n, void* out,
                                void* rows, long long alloc_bytes,
                                long long nb, void* stream) {
  if (nb > 0) {
    merge_packed_kernel<<<(unsigned)nb, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)old, (const uint8_t*)insmap, (const int64_t*)start,
        (const int64_t*)n, (uint8_t*)out, (int32_t*)rows, alloc_bytes, nb);
  }
  return (int)cudaGetLastError();
}
