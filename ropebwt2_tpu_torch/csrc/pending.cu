// Pending-merge kernel: merge one BCR round's new rows into the sorted
// pending side index (two planes: virtual positions vp and symbols psym)
// and emit per-128-row counts of the 6 symbols.
//
// Replaces: ropebwt2_tpu/index/pending_pallas.py, pending_merge_pallas ->
// _pend_kernel/_pend_body (the TPU kernel), reached from pending_add via
// _pending_add_pallas.
//
// What it computes: a new slot p (sarr[p] != 0) takes (varr[p], sarr[p]-1).
// An old row i = p - c(p) moves to p with vp[i] + c(p), clamped to INF,
// where c(p) is the number of new slots <= p.  Rows >= p_after are written
// as INF/PAD here, so no repair pass follows.
//
// What bounds it on the card: bytes.  Per pending row it reads 10 B (vp,
// psym, sarr; 8 more for varr at a new slot) and writes 9 B, plus 24 B of
// counts per 128 rows; a few integer ops per row.  A streaming pass bound
// by HBM bandwidth, over the whole pending capacity every round.
//
// What the design does about it: one pass, one CTA per 4096 rows.  The
// block's new-row prefix start[b] comes from outside, so a CTA's old rows
// are the contiguous run starting at b*4096 - start[b]; it stages that run
// of both planes in shared memory with coalesced loads, scans its new-row
// flags CTA-wide, and writes its outputs.  CTAs wholly past p_after only
// write INF/PAD and zero counts.

#include "common.cuh"

using namespace rb2;

namespace {

union Chunk {
  uint4 v;
  int8_t b[PER];
};

__global__ void __launch_bounds__(THREADS)
pending_kernel(const int64_t* __restrict__ vp, const int8_t* __restrict__ psym,
               const int64_t* __restrict__ varr,
               const int8_t* __restrict__ sarr,
               const int64_t* __restrict__ start,
               const int64_t* __restrict__ p_after_ptr,
               int64_t* __restrict__ vp_out, int8_t* __restrict__ psym_out,
               int32_t* __restrict__ rows, int64_t pcap, int64_t inf) {
  __shared__ int64_t wv[BS];
  __shared__ int8_t ws[BS];
  __shared__ int warp_tot[WARPS];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t p0 = b * BS;
  const int64_t pt = p0 + (int64_t)t * PER;
  const bool mine = pt < pcap;  // pcap % 16 == 0: a chunk is wholly in or out
  const int64_t p_after = *p_after_ptr;
  int32_t* row_out = rows + (b * (BS / LANE) + (t >> 3)) * NSYM;

  if (p0 >= p_after) {  // wholly past the live rows
    if (mine) {
#pragma unroll
      for (int j = 0; j < PER; ++j) vp_out[pt + j] = inf;
      Chunk pad;
#pragma unroll
      for (int j = 0; j < PER; ++j) pad.b[j] = PAD;
      *reinterpret_cast<uint4*>(psym_out + pt) = pad.v;
    }
    if ((t & 7) == 0) {
#pragma unroll
      for (int s = 0; s < NSYM; ++s) row_out[s] = 0;
    }
    return;
  }

  const int64_t base = start[b];
  const int64_t o0 = p0 - base;  // first old row this block consumes
  for (int i = t; i < BS; i += THREADS) {
    const int64_t q = o0 + i;
    const bool in = q < pcap;
    wv[i] = in ? vp[q] : inf;
    ws[i] = in ? psym[q] : PAD;
  }

  Chunk sa;
  sa.v = mine ? *reinterpret_cast<const uint4*>(sarr + pt) : make_uint4(0, 0, 0, 0);
  int k = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) k += sa.b[j] != 0;
  int c = block_exclusive_scan(k, warp_tot);

  Chunk so;
  int cs[NSYM] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int64_t p = pt + j;
    int64_t v;
    int8_t s;
    if (sa.b[j]) {
      v = mine ? varr[p] : inf;
      s = sa.b[j] - 1;
      ++c;
    } else if (p >= p_after) {
      v = inf;
      s = PAD;
    } else {
      const int idx = t * PER + j - c;
      const int64_t shifted = wv[idx] + base + c;
      v = shifted < inf ? shifted : inf;
      s = ws[idx];
    }
    if (mine) vp_out[p] = v;
    so.b[j] = s;
#pragma unroll
    for (int q = 0; q < NSYM; ++q) cs[q] += s == q;
  }
  if (mine) *reinterpret_cast<uint4*>(psym_out + pt) = so.v;
  write_row_counts(cs, row_out);
}

}  // namespace

// vp/varr: int64[pcap]; psym/sarr: int8[pcap] (sarr = sym+1 at new slots,
// else 0); start: int64[nb+1] exclusive per-block new-row prefix; p_after:
// int64 scalar on the device; vp_out: int64[pcap]; psym_out: int8[pcap];
// rows: int32[nb*32, 6].  pcap % 16 == 0.  Returns cudaGetLastError().
extern "C" int rb2_pending_merge(const void* vp, const void* psym,
                                 const void* varr, const void* sarr,
                                 const void* start, const void* p_after,
                                 void* vp_out, void* psym_out, void* rows,
                                 long long pcap, long long nb, long long inf,
                                 void* stream) {
  if (nb > 0) {
    pending_kernel<<<(unsigned)nb, THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)vp, (const int8_t*)psym, (const int64_t*)varr,
        (const int8_t*)sarr, (const int64_t*)start, (const int64_t*)p_after,
        (int64_t*)vp_out, (int8_t*)psym_out, (int32_t*)rows, pcap, inf);
  }
  return (int)cudaGetLastError();
}
