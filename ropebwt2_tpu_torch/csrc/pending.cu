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
// where c(p) is the number of new slots <= p.  Rows >= p_after of a
// launched CTA are written as INF/PAD.
//
// What bounds it on the card: bytes.  Per live row it reads 10 B (vp, psym,
// sarr; 8 more for varr at a new slot) and writes 9 B, plus 24 B of counts
// per 128 rows; a few integer ops per row.  At 9 to 18 B a row the pass is
// only as fast as its accesses are wide and as many of them are in flight:
// a warp instruction that touches 32 different 128-byte lines costs what
// 32 coalesced ones do.
//
// What the design does about it:
// - Ownership that coalesces.  A CTA takes 4096 rows, a warp 512 of them
//   in 16 steps of 32: lane l owns row base + l of a step.  Every global
//   access of the int64 planes (vp, varr, vp_out) is 32 consecutive words
//   of a warp, except where a new slot lies between two lanes.
// - No window in shared memory.  The block's new-row prefix start[b]
//   comes from outside, so the old row that moves to slot p is row
//   p - start[b] - c(p) of the input planes: neighbouring lanes read
//   neighbouring rows straight from global memory.  The loads of 8 steps
//   (one 8-byte and one 1-byte load a row, predicated, none behind a
//   branch) are started before the first of them is used.  On an NVIDIA
//   H100 80GB HBM3 at 700 W, at pcap 2^24 with 2^20 new rows and half
//   full: 0.0862 ms so (80 registers); 0.0915 with 4 steps in flight (58
//   registers), 0.0914 with 16 (128 registers), 0.0973 with the window of
//   both planes staged in 36 KB of shared memory first.  The warp's sarr
//   bytes are loaded at the top of the kernel, beside p_after and
//   start[b] and not after them: 0.0828 ms.
// - The byte planes move 16 bytes a lane where they can: sarr comes in as
//   the warp's own 512 bytes, and the output symbols are collected in
//   shared memory (over the sarr bytes they replace) and leave as one
//   16-byte store a lane.
// - c(p) from ballots: the new-slot flags of a step are one __ballot_sync,
//   a lane's prefix is __popc of the ballot under its lane mask, the
//   prefix of the steps is a running sum every lane keeps, and one
//   CTA-wide exchange of the 8 warp totals replaces the shuffle scan.
// - Counts from ballots: __popc(__ballot_sync(sym == q)) for the 6
//   symbols, four steps to a count row; lane j < 24 of a warp keeps count
//   j % 6 of the warp's row j / 6, so the warp's four rows leave as one
//   96-byte store.  No compare chains per thread, no shuffle tree.
// - No tail rewrite.  The caller owns the output planes and launches only
//   the CTAs that can hold live rows (a host-known bound of p_after); the
//   kernel touches nothing past them.  The caller keeps INF/PAD there
//   (index/pending.py: two plane pairs used in turn).
//
// The blocked-to-striped exchange through shared memory (16 rows a thread,
// transposed for the stores) was the alternative; the striped ownership
// needs no exchange of the int64 plane at all, so it was taken.

#include "common.cuh"

using namespace rb2;

namespace {

constexpr int STEP = 32;                    // rows of one warp step
constexpr int WROWS = BS / WARPS;           // 512 rows a warp
constexpr int STEPS = WROWS / STEP;         // 16 steps a warp
constexpr int STEPS_PER_ROW = LANE / STEP;  // 4 steps to a count row
constexpr int WCOUNTS = WROWS / LANE * NSYM;  // 24 counts a warp
constexpr int HALF = STEPS / 2;  // steps whose loads are in flight together
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
pending_kernel(const int64_t* __restrict__ vp, const int8_t* __restrict__ psym,
               const int64_t* __restrict__ varr,
               const int8_t* __restrict__ sarr,
               const int64_t* __restrict__ start,
               const int64_t* __restrict__ p_after_ptr,
               int64_t* __restrict__ vp_out, int8_t* __restrict__ psym_out,
               int32_t* __restrict__ rows, int64_t pcap, int64_t inf) {
  __shared__ __align__(16) uint8_t sa[BS];  // new-slot map, then the output
  __shared__ int warp_tot[WARPS];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int64_t b = blockIdx.x;
  const int64_t p0 = b * BS;
  const int64_t p_after = *p_after_ptr;
  int32_t* row_out = rows + b * (BS / LANE) * NSYM;
  const uint4 pad16 = make_uint4(PAD_WORD, PAD_WORD, PAD_WORD, PAD_WORD);
  // the 16 byte-plane rows this lane loads and stores (pcap % 16 == 0: a
  // chunk is wholly in or out)
  const int wr = w * WROWS;
  const int64_t pc = p0 + wr + lane * PER;
  // the warp's new-slot map goes out beside p_after and start[b], ahead of
  // the test for a dead CTA (rare: only a loose bound launches one)
  const uint4 sav = pc < pcap ? *reinterpret_cast<const uint4*>(sarr + pc)
                              : make_uint4(0, 0, 0, 0);
  const int64_t base = start[b];

  if (p0 >= p_after) {  // launched by a loose bound: wholly past the live rows
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int64_t p = p0 + j * THREADS + t;
      if (p < pcap) vp_out[p] = inf;
    }
    if (pc < pcap) *reinterpret_cast<uint4*>(psym_out + pc) = pad16;
    if (t < BS / LANE * NSYM) row_out[t] = 0;
    return;
  }

  // the old rows this block consumes: the contiguous run from o0
  const int64_t o0 = p0 - base;
  reinterpret_cast<uint4*>(sa)[w * STEP + lane] = sav;
  __syncwarp();

  // new-slot flags of every step of this warp, and the warp's total
  uint32_t bal[STEPS];
  int tot = 0;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    bal[s] = __ballot_sync(FULL, sa[wr + s * STEP + lane] != 0);
    tot += __popc(bal[s]);
  }
  if (lane == 0) warp_tot[w] = tot;
  __syncthreads();
  int c0 = 0;  // new slots of this CTA before the step's first row
#pragma unroll
  for (int i = 0; i < WARPS - 1; ++i) c0 += i < w ? warp_tot[i] : 0;

  const uint32_t le = FULL >> (31 - lane);  // this lane and the ones below
  const int sel = lane % NSYM, grp = lane / NSYM;
  int acc = 0;  // lane j < 24: count of symbol j % 6 in the warp's row j / 6
#pragma unroll
  for (int h = 0; h < STEPS; h += HALF) {
    // every load of HALF steps first, none behind a branch: one 8-byte and
    // one 1-byte load a row, all in flight together
    int64_t v[HALF];
    uint8_t sy[HALF];
    int cc[HALF];
#pragma unroll
    for (int s = 0; s < HALF; ++s) {
      const int r = wr + (h + s) * STEP + lane;  // row within the CTA
      const int64_t p = p0 + r;
      const int c = c0 + __popc(bal[h + s] & le);  // new slots at or before p
      const uint8_t f = sa[r];  // a new slot lies below pcap: sarr past it
                                // was staged as 0
      const bool old = !f && p < p_after;
      const int64_t q = o0 + r - c;  // the old row that moves to p
      v[s] = inf;
      if (f || old) v[s] = *(f ? varr + p : vp + q);
      sy[s] = f ? f - 1 : PAD;
      if (old) sy[s] = (uint8_t)psym[q];
      cc[s] = old ? c : -1;
      c0 += __popc(bal[h + s]);
    }
#pragma unroll
    for (int s = 0; s < HALF; ++s) {
      const int r = wr + (h + s) * STEP + lane;
      const int64_t p = p0 + r;
      if (cc[s] >= 0) {
        const int64_t shifted = v[s] + base + cc[s];
        v[s] = shifted < inf ? shifted : inf;
      }
      if (p < pcap) vp_out[p] = v[s];
      sa[r] = sy[s];
      uint32_t m[NSYM];
#pragma unroll
      for (int q = 0; q < NSYM; ++q) m[q] = __ballot_sync(FULL, sy[s] == q);
      uint32_t mine = m[0];
#pragma unroll
      for (int q = 1; q < NSYM; ++q) mine = sel == q ? m[q] : mine;
      if (grp == (h + s) / STEPS_PER_ROW) acc += __popc(mine);
    }
  }
  if (lane < WCOUNTS) row_out[w * WCOUNTS + lane] = acc;
  __syncwarp();
  if (pc < pcap)
    *reinterpret_cast<uint4*>(psym_out + pc) =
        reinterpret_cast<const uint4*>(sa)[w * STEP + lane];
}

}  // namespace

// vp/varr: int64[pcap]; psym/sarr: int8[pcap] (sarr = sym+1 at new slots,
// else 0; varr is read at new slots only); start: int64[>= ncta] exclusive
// per-block new-row prefix; p_after: int64 scalar on the device; vp_out:
// int64[pcap]; psym_out: int8[pcap]; rows: int32[>= ncta*32, 6].  ncta CTAs
// are launched: rows [0, ncta*4096) of the output planes and count rows
// [0, ncta*32) are written, nothing past them; p_after <= ncta*4096.
// pcap % 16 == 0; psym, sarr and psym_out 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int rb2_pending_merge(const void* vp, const void* psym,
                                 const void* varr, const void* sarr,
                                 const void* start, const void* p_after,
                                 void* vp_out, void* psym_out, void* rows,
                                 long long pcap, long long ncta, long long inf,
                                 void* stream) {
  if (ncta > 0) {
    pending_kernel<<<(unsigned)ncta, THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)vp, (const int8_t*)psym, (const int64_t*)varr,
        (const int8_t*)sarr, (const int64_t*)start, (const int64_t*)p_after,
        (int64_t*)vp_out, (int8_t*)psym_out, (int32_t*)rows, pcap, inf);
  }
  return (int)cudaGetLastError();
}
