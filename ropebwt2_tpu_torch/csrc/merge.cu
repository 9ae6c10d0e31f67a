// Merge kernel: apply one BCR round's (or one pending flush's) insertions to
// the flat int8 BWT and emit its 128-symbol rank prefix in the same pass.
//
// Replaces: ropebwt2_tpu/index/merge_pallas.py, merge_pallas ->
// _merge_kernel/_merge_body (the TPU kernel), and the cumsum after it
// (merge_pallas.py:679-700) that turns the kernel's counts into the rank
// prefix.
//
// What it computes: output position p takes insmap[p]-1 where insmap[p] != 0
// (an insertion destination pos+stream), else old[p - c(p)], with c(p) the
// number of destinations <= p; and prefix row r holds the count of each
// symbol in out[0, 128 r).  Both are exact on the live prefix L = n + #ins:
// out on [0, L), prefix in rows 0 .. L / 128.  Past L both are unspecified:
// out holds whatever old held there, which may be any byte, so the count of
// the row that holds the live end may be wrong (count16_packed wants bytes
// below 16), and with it every prefix row past L / 128.  Blocks wholly
// past L write nothing.
//
// What bounds it on the card: bytes.  Per live symbol it reads 2 B (old
// symbol, insmap byte) and writes 1 B, plus one prefix row (24 B int32 or
// 48 B int64) per 128 symbols and 48 B of look-back status per tile (see
// below).  That is a streaming pass bound by HBM bandwidth, provided the
// instructions a symbol and the chain of dependent loads a block stay
// short.
//
// What the design does about it: a CTA takes a tile of G consecutive
// 4096-symbol blocks (G = 1..8, merge_cuda.tile_blocks) and does them one
// after the other.  A block's insertion prefix start[b] comes from outside
// (an M-sized scatter and a small cumsum), so a CTA knows where the block's
// old symbols begin without looking at other blocks: the contiguous run
// from o0 = b*4096 - start[b].
// - Loads before uses.  The first block's map, start and window loads go
//   out before the dead-tile test waits for the live end.
// - 16-byte staging.  The run lies in the 257 aligned 16-byte chunks from
//   o0 & ~15; they go to shared memory as they are (PAD past the
//   allocation) and are read at offset o0 & 15.
// - Word copy.  A thread with no insertion among its 16 outputs copies 16
//   window bytes at its shift (window16: five word loads, four
//   __byte_perm); a thread with insertions walks its 16 symbols.
// - Bit-sliced counts (count16_packed), summed over the 8 lanes of a row in
//   8-bit fields (6 shuffles); one warp scans the block's 32 rows in 16-bit
//   fields (15 shuffles) on top of the tile's blocks before it.
// - The rank prefix by decoupled look-back (Merrill and Garland,
//   "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016; the
//   design of CUB's DeviceScan), one scan per symbol over the tiles.  A
//   tile's status for symbol s is one 64-bit word, its count above a 2-bit
//   flag (aggregate or inclusive prefix), so a word is written and read
//   whole and needs no fence.  The tile publishes its aggregate; warp s
//   then reads the words of the 32 tiles before it at once, waits until
//   those up to the nearest inclusive one are there, sums them, and steps
//   back 32 more if none was inclusive; then the tile publishes its
//   inclusive prefix and writes its blocks' prefix rows.  The tile index
//   is a ticket from an atomic counter, not blockIdx.x, so a CTA waits
//   only on tiles that hold smaller tickets and are resident or done; live
//   tiles are a prefix of the tickets, and a dead one publishes nothing.
//   The caller zeroes the status words and the ticket on the launch's
//   stream before every launch.
// - Why tiles: a tile's look-back costs hops of an L2 round trip (about
//   0.4 us each), and a wave of tiles that publish together waits until
//   the inclusive prefix has swept it, 32 tiles a hop.  On an NVIDIA H100
//   80GB HBM3 at 700 W, at the sustained regime's flush (35,901 live
//   blocks): 0.43-0.49 ms with one block a tile, 0.31-0.40 with 2,
//   0.25-0.30 with 4, 0.22-0.25 with 8; without the look-back 0.16-0.17.
//   Small allocations take fewer blocks a tile so that their live blocks
//   still spread over the SMs.  Not faster, and not kept: reading 64 or
//   128 tiles a hop, a back-off sleep in the wait, cp.async double
//   buffering of the next block, tiles that grow from 1 to 8 blocks over
//   the first wave, a 32-register cap (8 CTAs an SM, 20 B of spills;
//   0.231 against 0.227 ms at the flush), and merging a thread's
//   insertions without branches (53 registers; 0.248 ms).
// None of the TPU kernel's machinery (log-shift expand, aligned DMA
// windows, double buffering) is needed.

#include "common.cuh"

using namespace rb2;

namespace {

constexpr int ROWS = BS / LANE;  // 32 count rows a block
constexpr int GMAX = 8;          // blocks a tile (G * 4096 < 2^16)
constexpr uint64_t AGGREGATE = 1, INCLUSIVE = 2;  // status flags (0: none)
constexpr uint32_t FULL = 0xffffffffu;

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// symbol s's count of a row scanned in 16-bit fields (s, s+1 in one word)
__device__ __forceinline__ uint32_t field16(const uint32_t* f, int s) {
  return (f[s >> 1] >> (16 * (s & 1))) & 0xFFFFu;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const uint8_t* __restrict__ old,
             const uint8_t* __restrict__ insmap,
             const int64_t* __restrict__ start,
             const int64_t* __restrict__ n_ptr, uint8_t* __restrict__ out,
             T* __restrict__ prefix, uint64_t* __restrict__ status,
             unsigned long long* __restrict__ ticket, int64_t alloc,
             int64_t nb, int G, int64_t ntiles) {
  __shared__ __align__(16) uint8_t win[BS + 32];
  __shared__ int warp_tot[WARPS];
  __shared__ uint2 row_cnt[ROWS];  // a row's counts, 8-bit fields
  // inclusive prefix of the tile's rows, 16-bit fields
  __shared__ uint32_t row_pre[GMAX][ROWS][3];
  __shared__ uint32_t tile_tot[3];     // the tile's counts, 16-bit fields
  __shared__ int64_t tile_excl[NSYM];  // the tile's exclusive prefix
  __shared__ int tile;
  __shared__ int tile_live;  // the tile's blocks that hold live symbols
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if (t == 0) tile = (int)atomicAdd(ticket, 1ull);
  __syncthreads();
  const int q = tile;
  if (t == 0) {  // the tile's blocks that hold live symbols
    const int64_t b0 = (int64_t)q * G, live = *n_ptr + start[nb];
    const int64_t most = nb - b0 < G ? nb - b0 : G;
    const int64_t k = (live - b0 * BS + BS - 1) / BS;
    tile_live = (int)(k < 0 ? 0 : k < most ? k : most);
#pragma unroll
    for (int i = 0; i < 3; ++i) tile_tot[i] = 0;
  }
  // block b's map, and the 257 aligned 16-byte chunks that hold its old
  // run (alloc % 16 == 0: a chunk is wholly in the buffer or out of it)
  uint4 iv, w0, w1;
  int64_t o0;
  auto load = [&](int b) {
    const int64_t p0 = (int64_t)b * BS;
    iv = *reinterpret_cast<const uint4*>(insmap + p0 + 16 * t);
    o0 = p0 - start[b];
    const int64_t c0 = (o0 & ~int64_t(15)) + 16 * t;
    w0 = w1 = make_uint4(PAD_WORD, PAD_WORD, PAD_WORD, PAD_WORD);
    if (c0 + 16 <= alloc) w0 = *reinterpret_cast<const uint4*>(old + c0);
    if (t == 0 && c0 + BS + 16 <= alloc)
      w1 = *reinterpret_cast<const uint4*>(old + c0 + BS);
  };
  load(q * G);  // the first block's loads go out before the test
  __syncthreads();
  const int nlive = tile_live;
  if (nlive == 0) return;  // the tile is wholly past the live prefix

  for (int g = 0; g < nlive; ++g) {
    const int64_t pt = (int64_t)(q * G + g) * BS + t * PER;
    if (g > 0) load(q * G + g);

    const int k = nonzero_bytes(iv.x) + nonzero_bytes(iv.y) +
                  nonzero_bytes(iv.z) + nonzero_bytes(iv.w);
    *reinterpret_cast<uint4*>(win + 16 * t) = w0;
    if (t == 0) *reinterpret_cast<uint4*>(win + BS) = w1;
    // insertions before this thread's first position (also the barrier
    // that publishes the staged window)
    const int c = block_exclusive_scan(k, warp_tot);

    const int off = (int)(o0 & 15) + t * PER - c;  // first source symbol
    uint4 o;
    if (k == 0) {
      o = window16(win, off);
    } else {
      const uint32_t iw[4] = {iv.x, iv.y, iv.z, iv.w};
      uint32_t ow[4];
      int src = off;
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        uint32_t acc = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t ib = (iw[wd] >> (8 * j)) & 0xFFu;
          const uint32_t v = ib ? ib - 1 : win[src];
          src += ib ? 0 : 1;
          acc |= v << (8 * j);
        }
        ow[wd] = acc;
      }
      o = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    }
    if (pt + PER <= alloc) *reinterpret_cast<uint4*>(out + pt) = o;

    // row counts: 8 lanes a row, at most 128 a field
    uint32_t ca, cb;
    count16_packed(o, ca, cb);
#pragma unroll
    for (int d = 4; d > 0; d >>= 1) {
      ca += __shfl_xor_sync(FULL, ca, d);
      cb += __shfl_xor_sync(FULL, cb, d);
    }
    if ((t & 7) == 0) row_cnt[t >> 3] = make_uint2(ca, cb);
    __syncthreads();  // also: every thread is done with win

    // the block's 32 rows scanned by warp 0 in 16-bit fields, on top of
    // the tile's blocks before it: f = {c0 | c1 << 16, c2 | c3 << 16,
    // c4 | c5 << 16}, at most G * 4096 each
    if (warp == 0) {
      const uint2 r = row_cnt[lane];
      uint32_t f[3] = {(r.x & 0xFFu) | (r.x & 0xFF00u) << 8,
                       (r.x >> 16 & 0xFFu) | (r.y & 0xFFu) << 16,
                       (r.y >> 8 & 0xFFu) | (r.y & 0xFF0000u)};
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const uint32_t y = __shfl_up_sync(FULL, f[i], d);
          if (lane >= d) f[i] += y;
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) row_pre[g][lane][i] = tile_tot[i] + f[i];
      __syncwarp();
      if (lane == 31) {
#pragma unroll
        for (int i = 0; i < 3; ++i) tile_tot[i] += f[i];
      }
    }
  }

  // lane s < 6 publishes the tile's aggregate of symbol s; tile 0's
  // aggregate is its inclusive prefix
  if (warp == 0) {
    __syncwarp();
    if (lane < NSYM)
      store_status(status + lane * ntiles + q,
                   (uint64_t)field16(tile_tot, lane) << 2 |
                       (q == 0 ? INCLUSIVE : AGGREGATE));
  }
  __syncthreads();

  // warp s looks back for symbol s's exclusive prefix
  if (warp < NSYM) {
    const int s = warp;
    const uint64_t* st = status + s * ntiles;
    int64_t excl = 0;
    for (int base = q - 1; q > 0;) {  // lane l reads tile base - l
      const int j = base - lane;
      const uint64_t w = j >= 0 ? load_status(st + j) : INCLUSIVE;
      const uint32_t inc = __ballot_sync(FULL, (w & 3) == INCLUSIVE);
      // the lanes up to the nearest inclusive prefix (all without one)
      const uint32_t need = inc ? inc ^ (inc - 1) : FULL;
      if (__ballot_sync(FULL, (w & 3) == 0) & need) continue;  // wait
      int64_t v = need >> lane & 1 ? (int64_t)(w >> 2) : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
      excl += v;
      if (inc) break;
      base -= 32;
    }
    if (lane == 0) {
      if (q > 0)
        store_status(status + s * ntiles + q,
                     (uint64_t)(excl + field16(tile_tot, s)) << 2 |
                         INCLUSIVE);
      tile_excl[s] = excl;
    }
  }
  __syncthreads();

  // prefix rows b*32 + 1 .. b*32 + 32 of each live block b: 192
  // consecutive values
  if (t < ROWS * NSYM) {
    const int r = t / NSYM, s = t % NSYM;
    for (int h = 0; h < nlive; ++h)
      prefix[((int64_t)(q * G + h) * ROWS + 1) * NSYM + t] =
          (T)(tile_excl[s] + field16(row_pre[h][r], s));
  }
  if (q == 0 && t < NSYM) prefix[t] = 0;
}

}  // namespace

// old: int8[alloc]; insmap: int8[nb*4096] (sym+1 at destinations, else 0);
// start: int64[nb+1] exclusive per-block insertion prefix; n: int64 scalar
// on the device; out: int8[alloc]; prefix: int32 (wide == 0) or int64
// [nb*32 + 1, 6]; G: 4096-symbol blocks a tile (a CTA), 1 to 8; scratch:
// int64[6 * ceil(nb / G) + 1], the look-back's status words and the
// ticket, zero on entry.  alloc % 16 == 0.  Returns cudaGetLastError().
extern "C" int rb2_merge(const void* old, const void* insmap,
                         const void* start, const void* n, void* out,
                         void* prefix, void* scratch, long long alloc,
                         long long nb, long long G, long long wide,
                         void* stream) {
  if (G < 1 || G > GMAX) return (int)cudaErrorInvalidValue;
  if (nb > 0) {
    const long long ntiles = (nb + G - 1) / G;
    uint64_t* status = (uint64_t*)scratch;
    auto* ticket = (unsigned long long*)(status + NSYM * ntiles);
    const cudaStream_t s = (cudaStream_t)stream;
    if (wide)
      merge_kernel<int64_t><<<(unsigned)ntiles, THREADS, 0, s>>>(
          (const uint8_t*)old, (const uint8_t*)insmap, (const int64_t*)start,
          (const int64_t*)n, (uint8_t*)out, (int64_t*)prefix, status, ticket,
          alloc, nb, (int)G, ntiles);
    else
      merge_kernel<int32_t><<<(unsigned)ntiles, THREADS, 0, s>>>(
          (const uint8_t*)old, (const uint8_t*)insmap, (const int64_t*)start,
          (const int64_t*)n, (uint8_t*)out, (int32_t*)prefix, status, ticket,
          alloc, nb, (int)G, ntiles);
  }
  return (int)cudaGetLastError();
}
