// Rank kernels: the 6-symbol rank (occ) at a batch of positions, counted
// inside the 128-symbol row, for the flat tier, the packed tier, the
// pending index, and the virtual (base + pending) sequence of a deferred
// round.
//
// Replaces: no Pallas kernel.  The plain versions are the JAX package's
// XLA code (ropebwt2_tpu/index/rank.py rank_global,
// ropebwt2_tpu/index/packed.py rank_global_packed,
// ropebwt2_tpu/index/pending.py pending_rank and rank_virtual): a (Q, 128)
// row gather, a (Q, 128) mask, a (Q, 128, 6) compare, an `&` and a sum
// over 128, each a pass over device memory.
//
// What it computes (index/rank_cuda.py holds the plain versions' contract
// bit for bit, clamps of out-of-range positions included):
// - rank_flat:    out[q, s] = prefix[blk] + |{ j < within : row[j] == s }|
//   with blk = floor(x / K), within = x - blk K, x = pos[q]; the prefix
//   and the row clamped to their tables;
// - rank_packed:  the same over the nibble plane of symbol row blk (byte j
//   of packed row blk >> 1, shifted by 4 (blk & 1)), with the base
//   blkA[x >> 24] + blkB[blkb_row(blk)], int64, at x = pos[q] - sub[q]
//   plus extra[q] when given (the packed tier's deferred rank: the base
//   at g - p plus the pending counts, after the pending kernel);
// - rank_pend:    p[q] = |{ i : vp[i] < g[q] }| (vp ascending), then
//   occ[q, s] = prefix[jb] + the count of s among psym rows [jb 128, p),
//   jb = max(p - 1, 0) >> 7, int32;
// - rank_virtual: rank_flat at x = clamp(g - p, lo, hi) plus rank_pend's
//   occ at g, in the flat prefix's type: a deferred round's rank in one
//   launch, with nothing between the two counts in device memory.
//
// What bounds it on the card.  A flat query needs its 8-byte position,
// the row bytes below `within` (64 on average at K = 128), a 6-entry
// prefix row and its 6-entry answer: ~110 B, 33 us for 2^20 queries at
// 3.35 TB/s.  A pending query needs the vp rows next to its answer, the
// psym bytes below it in their row and a prefix row.  The earlier design
// (8 threads a query, a runtime 64-bit floor division in every thread, a
// 12-shuffle group sum; a lower bound over all of vp, one dependent load
// a level) was bound by issue slots: its flat kernel issued about as many
// instructions as the card can in the time it took.  This design issues
// a quarter as many a query; what bounds it now are its dependent loads:
// the flat rank's row loads alone take nearly all of its time, and the
// pending rank's search (a chain of dependent loads) and its count (the
// instructions) take about as long apart as together.  Both were measured
// by parts (csrc/probes/rank_variants.cu, run on request by
// `chip_smoke.py --rank-variants`); PERF.md has the times.
//
// What the design does about it:
// - No 64-bit division: K = 128 KB is a template constant (KB 1..8), so
//   blk is a shift (a multiply for a KB that is not a power of two), once
//   a query and thread.
// - Two threads a query, two queries a pair: thread h of a pair counts
//   the 16-byte chunks at 32 j + 16 h of both its queries' rows, so that
//   a warp's load moves 16 whole 32-byte sectors, and the 8 loads of a
//   thread (both queries, K = 128) are in flight together.  The pair's
//   counts meet in two shuffles a query, and each thread writes three of
//   the six answers.  The pairs take queries P and P + 16 of their warp,
//   so that a warp's stores cover 16 consecutive answers.
// - Counting: a byte that is not a symbol 0..5, or is at or past
//   `within`, becomes 7; the 16 bytes fold into three bit planes, and a
//   symbol's 16 match flags are one logic operation and a __popc,
//   accumulated in 16-bit fields (a K-row holds up to 1024 of a symbol).
// - The pending search runs in two levels that the caches serve: a lower
//   bound over the blocks' last rows (vp[128 j + 127], one 32-byte sector
//   a block: 4 MB at pcap 2^24, which stays in the 50 MB L2; its upper
//   levels are shared in L1 by a CTA's sorted queries) with a trip count
//   that depends on the capacity alone, then the block's 7 line ends
//   loaded together, then the 16 rows of one line loaded together.
// - rank_virtual: one search a thread (query `lane` of its warp); the
//   pair then loads the pending rows and the flat rows of its two queries
//   together and counts them; p and g - p stay in registers.
// - CTAs of 64 threads, so that a long-read round's 4096 queries spread
//   over 64 SMs.

#include <type_traits>

#include "common.cuh"

using namespace rb2;

namespace {

constexpr int GROUP = 8;               // threads a query (packed)
constexpr int QPB = THREADS / GROUP;   // 32 queries a CTA (packed)
constexpr int ACHUNK_LOG = 24;         // symbols per int64 anchor row: 2^24
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;  // b > 0
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// 0x80 in each byte of a word at or past `valid` bytes (valid <= 0: all
// four, valid >= 4: none)
__device__ __forceinline__ uint32_t past_mask(int64_t valid) {
  if (valid >= 4) return 0u;
  if (valid <= 0) return 0x80808080u;
  return 0x80808080u << (8 * (int)valid);
}

// a word of symbol bytes as count16_packed takes them: a byte 0..5 stays,
// any other byte (6..255 unsigned) and every byte flagged in `past`
// becomes 15, which is none of the six symbols
__device__ __forceinline__ uint32_t as_nibbles(uint32_t x, uint32_t past) {
  const uint32_t big =
      ((((x & 0x7F7F7F7Fu) + 0x7A7A7A7Au) | x) & 0x80808080u) | past;
  return (x & 0x0F0F0F0Fu) | ((big >> 7) * 0x0Fu);
}

// adds the counts of the six symbols among the bytes of v before byte
// `valid` to (a, b): 8-bit fields, as count16_packed packs them
__device__ __forceinline__ void count_before(uint4 v, int64_t valid,
                                             uint32_t& a, uint32_t& b) {
  v.x = as_nibbles(v.x, past_mask(valid));
  v.y = as_nibbles(v.y, past_mask(valid - 4));
  v.z = as_nibbles(v.z, past_mask(valid - 8));
  v.w = as_nibbles(v.w, past_mask(valid - 12));
  uint32_t ca, cb;
  count16_packed(v, ca, cb);
  a += ca;
  b += cb;
}

// The group's count of symbol g (g = lane within the group of 8; the
// value is meaningful in g < 6): the 8 lanes' 8-bit fields widened to
// 16 bits and summed by shuffles.  Every lane of the warp must call it.
__device__ __forceinline__ uint32_t group_count(uint32_t a, uint32_t b,
                                                int g) {
  uint32_t w0 = a & 0x00FF00FFu, w1 = (a >> 8) & 0xFFu;  // c0 | c2, c1
  uint32_t w2 = b & 0x00FF00FFu, w3 = (b >> 8) & 0xFFu;  // c3 | c5, c4
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    w0 += __shfl_xor_sync(FULL, w0, o);
    w1 += __shfl_xor_sync(FULL, w1, o);
    w2 += __shfl_xor_sync(FULL, w2, o);
    w3 += __shfl_xor_sync(FULL, w3, o);
  }
  const uint32_t pair = g < 3 ? w0 : w2;
  const uint32_t single = g < 3 ? w1 : w3;
  const int f = g % 3;
  return f == 1 ? single : (f == 0 ? pair & 0xFFFFu : pair >> 16);
}

// base + count (+ extra), wrapping as the plain version's integer adds do
template <typename T>
__device__ __forceinline__ T add_wrap(T base, uint32_t c, int64_t extra) {
  using U = typename std::conditional<sizeof(T) == 8, uint64_t,
                                      uint32_t>::type;
  return (T)((U)base + (U)c + (U)extra);
}

__global__ void __launch_bounds__(THREADS)
rank_packed_kernel(const uint8_t* __restrict__ pbwt,
                   const int64_t* __restrict__ blkA,
                   const int32_t* __restrict__ blkB,
                   const int64_t* __restrict__ pos,
                   const int64_t* __restrict__ sub,
                   const int32_t* __restrict__ extra,
                   int64_t* __restrict__ out, int64_t Q, int64_t nprows,
                   int64_t nrp, int64_t nanchor) {
  const int g = threadIdx.x & (GROUP - 1);
  const int64_t q0 = (int64_t)blockIdx.x * QPB + (threadIdx.x >> 3);
  const bool live = q0 < Q;
  const int64_t q = live ? q0 : Q - 1;
  const int64_t x = pos[q] - (sub ? sub[q] : 0);
  const int64_t blk = clamp64(floor_div(x, LANE), 0, 2 * nprows + 1);
  const int64_t within = x - blk * LANE;
  const int64_t off = 16 * g;
  uint32_t a = 0, b = 0;
  if (within > off) {
    const int64_t prow = (blk >> 1) < nrp - 1 ? (blk >> 1) : nrp - 1;
    uint4 v = *reinterpret_cast<const uint4*>(pbwt + prow * LANE + off);
    const int sh = (int)(blk & 1) * 4;  // the nibble plane of symbol row blk
    v.x = (v.x >> sh) & 0x0F0F0F0Fu;
    v.y = (v.y >> sh) & 0x0F0F0F0Fu;
    v.z = (v.z >> sh) & 0x0F0F0F0Fu;
    v.w = (v.w >> sh) & 0x0F0F0F0Fu;
    count_before(v, within - off, a, b);
  }
  const uint32_t c = group_count(a, b, g);
  if (live && g < NSYM) {
    const int64_t an = clamp64(floor_div(x, (int64_t)1 << ACHUNK_LOG), 0,
                               nanchor - 1);
    const int64_t brow = (blk >> 1) + (blk & 1) * (nprows + 1);
    const int64_t base = blkA[an * NSYM + g] + (int64_t)blkB[brow * NSYM + g];
    out[q * NSYM + g] =
        add_wrap<int64_t>(base, c, extra ? extra[q * NSYM + g] : 0);
  }
}

// ---- the pair design (rank_flat, rank_pend, rank_virtual) ----

// threads (and queries) a CTA: small CTAs spread a small batch (4096
// queries a long-read round) over 64 SMs
constexpr int RT = 64;

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}

// a read-only load of a 4- or 8-byte integer
template <typename T>
__device__ __forceinline__ T ldg(const T* p) {
  if constexpr (sizeof(T) == 8)
    return (T)__ldg(reinterpret_cast<const long long*>(p));
  else
    return (T)__ldg(reinterpret_cast<const int*>(p));
}

// floor(x / (128 KB)) for a compile-time KB
template <int KB>
__device__ __forceinline__ int64_t kblock(int64_t x) {
  const int64_t y = x >> 7;  // floor(x / 128): an arithmetic shift
  if constexpr ((KB & (KB - 1)) == 0) {
    return y >> ilog2(KB);
  } else {
    const int64_t q = y / KB;  // a constant divisor: a multiply
    return q * KB > y ? q - 1 : q;
  }
}

// 0x80 in each byte of a word at or past valid8 / 8 bytes (valid8 = 8 x
// the word's valid bytes, any value: <= 0 flags all four, >= 32 none)
__device__ __forceinline__ uint32_t past_word(int valid8) {
  return __funnelshift_lc(0u, 0x80808080u, (unsigned)max(valid8, 0));
}

// a word of symbol bytes as count16_sym3 takes them: a byte 0..5 stays,
// any other byte (6..255 unsigned) and every byte flagged in `past`
// becomes 7, which is none of the six symbols
__device__ __forceinline__ uint32_t as_sym3(uint32_t x, uint32_t past) {
  const uint32_t big =
      ((((x & 0x7F7F7F7Fu) + 0x7A7A7A7Au) | x) & 0x80808080u) | past;
  return (x & 0x07070707u) | ((big >> 7) * 7u);
}

// the six counts in 16-bit fields: c01 = c0 | c1 << 16, c23, c45
struct Counts {
  uint32_t c01, c23, c45;
};

// Adds the counts of the six symbols among the bytes of v before byte
// valid8 / 8 to c.  Bit-sliced as count16_packed (common.cuh) is, over
// three planes: the 16 bytes (each 0..5 or 7) fold into 16 nibbles, bit i
// of every nibble is gathered into plane p_i, and a symbol's 16 match
// flags are one logic operation on the planes, counted by one __popc.
__device__ __forceinline__ void count16_sym3(uint4 v, int valid8,
                                             Counts& c) {
  constexpr uint32_t L = 0x11111111u, H = 0x22222222u;
  const uint32_t x = as_sym3(v.x, past_word(valid8));
  const uint32_t y = as_sym3(v.y, past_word(valid8 - 32));
  const uint32_t z = as_sym3(v.z, past_word(valid8 - 64));
  const uint32_t w = as_sym3(v.w, past_word(valid8 - 96));
  const uint32_t z0 = x | (y << 4), z1 = z | (w << 4);
  const uint32_t p0 = (z0 & L) | ((z1 << 1) & H);
  const uint32_t p1 = ((z0 >> 1) & L) | (z1 & H);
  const uint32_t p2 = ((z0 >> 2) & L) | ((z1 >> 1) & H);
  c.c01 += __popc(~(p0 | p1 | p2) & (L | H)) +
           ((uint32_t)__popc(p0 & ~p1 & ~p2) << 16);
  c.c23 += __popc(~p0 & p1 & ~p2) + ((uint32_t)__popc(p0 & p1 & ~p2) << 16);
  c.c45 += __popc(~p0 & ~p1 & p2) + ((uint32_t)__popc(p0 & ~p1 & p2) << 16);
}

// this thread's four chunks (32 j + 16 h from off0 = 128 s + 16 h) of a
// row's 128-byte step s; a chunk at or past `within` is not loaded
__device__ __forceinline__ void load4(const int8_t* row, int within,
                                      int off0, uint4 (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int off = off0 + 32 * j;
    a[j] = within > off ? __ldg(reinterpret_cast<const uint4*>(row + off))
                        : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void count4(const uint4 (&a)[4], int within,
                                       int off0, Counts& c) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    count16_sym3(a[j], 8 * (within - off0 - 32 * j), c);
}

// The pair's sum of one query's counts: symbols 3h .. 3h + 2 in thread h.
// Every lane of the warp must call it.
__device__ __forceinline__ void pair_sum(Counts c, int h, uint32_t (&s)[3]) {
  const uint32_t t = __shfl_xor_sync(FULL, h ? c.c01 : c.c45, 1);
  const uint32_t m = c.c23 + __shfl_xor_sync(FULL, c.c23, 1);
  if (h == 0) {
    const uint32_t a = c.c01 + t;
    s[0] = a & 0xFFFFu;
    s[1] = a >> 16;
    s[2] = m & 0xFFFFu;
  } else {
    const uint32_t b = c.c45 + t;
    s[0] = m >> 16;
    s[1] = b & 0xFFFFu;
    s[2] = b >> 16;
  }
}

// A flat query at x: its row, its `within` and this thread's three prefix
// entries (symbols 3h .. 3h + 2), loaded now
template <typename T, int KB>
struct FlatQ {
  const int8_t* row;
  int within;
  T base[3];

  __device__ __forceinline__ FlatQ(int64_t x, const int8_t* bwt,
                                   const T* prefix, int64_t nprefix,
                                   int64_t nrows, int h) {
    const int64_t blk = kblock<KB>(x);
    within = (int)(x - blk * (128 * KB));
    row = bwt + clamp64(blk, 0, nrows - 1) * (128 * KB);
    const T* b = prefix + clamp64(blk, 0, nprefix - 1) * NSYM + 3 * h;
#pragma unroll
    for (int k = 0; k < 3; ++k) base[k] = ldg(b + k);
  }
};

// A pending query with answer p: the psym row of row p - 1, its `within`
// and this thread's three prefix entries, loaded now
struct PendQ {
  const int8_t* row;
  int within;
  int32_t base[3];

  __device__ __forceinline__ PendQ(int64_t p, const int8_t* psym,
                                   const int32_t* prefix, int h) {
    const int64_t jb = (p > 0 ? p - 1 : 0) >> 7;
    within = (int)(p - jb * LANE);
    row = psym + jb * LANE;
    const int32_t* b = prefix + jb * NSYM + 3 * h;
#pragma unroll
    for (int k = 0; k < 3; ++k) base[k] = ldg(b + k);
  }
};

// the last row of pending block j
__device__ __forceinline__ int64_t block_end(const int64_t* __restrict__ vp,
                                             int j) {
  return ldg(vp + (int64_t)j * LANE + (LANE - 1));
}

// |{ i : vp[i] < x }| over the ascending vp[0, 128 nblk), nblk >= 1
__device__ __forceinline__ int64_t pend_search(const int64_t* __restrict__ vp,
                                               int nblk, int64_t x) {
  // the first block whose last row is >= x (nblk if none): a lower bound
  // over the block ends whose trip count depends on nblk alone
  int base = 0, len = nblk;
  while (len > 1) {
    const int half = len >> 1;
    if (block_end(vp, base + half) < x) base += half;
    len -= half;
  }
  if (block_end(vp, base) < x) {
    if (base == nblk - 1) return (int64_t)nblk * LANE;
    ++base;
  }
  // the lines of 16 rows whose last row is < x (line 7 ends the block,
  // which holds a row >= x), then the rows < x of the next line
  const int64_t* blk = vp + (int64_t)base * LANE;
  int line = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) line += ldg(blk + 16 * k + 15) < x;
  const longlong2* r = reinterpret_cast<const longlong2*>(blk + 16 * line);
  int c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const longlong2 v = __ldg(r + k);
    c += (v.x < x) + (v.y < x);
  }
  return (int64_t)base * LANE + 16 * line + c;
}

template <typename T, int KB>
__global__ void __launch_bounds__(RT)
rank_flat_kernel(const int8_t* __restrict__ bwt, const T* __restrict__ prefix,
                 const int64_t* __restrict__ pos, T* __restrict__ out,
                 int64_t Q, int64_t nprefix, int64_t nrows) {
  const int lane = threadIdx.x & 31, h = lane & 1, P = lane >> 1;
  const int64_t qw = (int64_t)blockIdx.x * RT + (threadIdx.x & ~31);
  // the pair's queries, P and P + 16 of the warp (both threads load them)
  const int64_t q0 = qw + P, q1 = qw + P + 16;
  const int64_t c0 = q0 < Q ? q0 : Q - 1, c1 = q1 < Q ? q1 : Q - 1;
  FlatQ<T, KB> a(ldg(pos + c0), bwt, prefix, nprefix, nrows, h);
  FlatQ<T, KB> b(ldg(pos + c1), bwt, prefix, nprefix, nrows, h);
  Counts ca{0u, 0u, 0u}, cb{0u, 0u, 0u};
#pragma unroll 1
  for (int s = 0; s < KB; ++s) {
    uint4 ra[4], rb[4];
    const int off0 = 128 * s + 16 * h;
    load4(a.row, a.within, off0, ra);
    load4(b.row, b.within, off0, rb);
    count4(ra, a.within, off0, ca);
    count4(rb, b.within, off0, cb);
  }
  uint32_t sa[3], sb[3];
  pair_sum(ca, h, sa);
  pair_sum(cb, h, sb);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (q0 < Q) out[q0 * NSYM + 3 * h + k] = add_wrap<T>(a.base[k], sa[k], 0);
    if (q1 < Q) out[q1 * NSYM + 3 * h + k] = add_wrap<T>(b.base[k], sb[k], 0);
  }
}

// The occ of the warp's 32 queries from qw, whose pending answers p lane
// `lane` holds for query qw + lane: the pair counts queries P and P + 16.
// Every lane of the warp must call it.
__device__ __forceinline__ void pend_count(int64_t p,
                                           const int8_t* __restrict__ psym,
                                           const int32_t* __restrict__ prefix,
                                           int32_t* __restrict__ occ,
                                           int64_t qw, int64_t Q, int lane) {
  const int h = lane & 1, P = lane >> 1;
  const int64_t q0 = qw + P, q1 = qw + P + 16;
  PendQ a(__shfl_sync(FULL, p, P), psym, prefix, h);
  PendQ b(__shfl_sync(FULL, p, P + 16), psym, prefix, h);
  uint4 ra[4], rb[4];
  load4(a.row, a.within, 16 * h, ra);
  load4(b.row, b.within, 16 * h, rb);
  Counts ca{0u, 0u, 0u}, cb{0u, 0u, 0u};
  count4(ra, a.within, 16 * h, ca);
  count4(rb, b.within, 16 * h, cb);
  uint32_t sa[3], sb[3];
  pair_sum(ca, h, sa);
  pair_sum(cb, h, sb);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (q0 < Q)
      occ[q0 * NSYM + 3 * h + k] = add_wrap<int32_t>(a.base[k], sa[k], 0);
    if (q1 < Q)
      occ[q1 * NSYM + 3 * h + k] = add_wrap<int32_t>(b.base[k], sb[k], 0);
  }
}

__global__ void __launch_bounds__(RT)
rank_pend_kernel(const int64_t* __restrict__ vp,
                 const int8_t* __restrict__ psym,
                 const int32_t* __restrict__ prefix,
                 const int64_t* __restrict__ gq, int64_t* __restrict__ p_out,
                 int32_t* __restrict__ occ, int64_t Q, int nblk) {
  const int lane = threadIdx.x & 31;
  const int64_t qw = (int64_t)blockIdx.x * RT + (threadIdx.x & ~31);
  // one search a thread: query `lane` of the warp
  const int64_t qt = qw + lane;
  const int64_t p = pend_search(vp, nblk, ldg(gq + (qt < Q ? qt : Q - 1)));
  if (qt < Q) p_out[qt] = p;
  pend_count(p, psym, prefix, occ, qw, Q, lane);
}

template <typename T, int KB>
__global__ void __launch_bounds__(RT)
rank_virtual_kernel(const int8_t* __restrict__ bwt,
                    const T* __restrict__ prefix,
                    const int64_t* __restrict__ vp,
                    const int8_t* __restrict__ psym,
                    const int32_t* __restrict__ pprefix,
                    const int64_t* __restrict__ gq, T* __restrict__ out,
                    int64_t Q, int64_t nprefix, int64_t nrows, int nblk,
                    int64_t lo, int64_t hi) {
  const int lane = threadIdx.x & 31, h = lane & 1, P = lane >> 1;
  const int64_t qw = (int64_t)blockIdx.x * RT + (threadIdx.x & ~31);
  // one search a thread: query `lane` of the warp, and its base position
  const int64_t qt = qw + lane;
  const int64_t g = ldg(gq + (qt < Q ? qt : Q - 1));
  const int64_t p = pend_search(vp, nblk, g);
  const int64_t x = clamp64(g - p, lo, hi);
  // the pair counts queries P and P + 16: their pending rows and their
  // flat rows, all loaded before any is counted
  const int64_t q0 = qw + P, q1 = qw + P + 16;
  PendQ pa(__shfl_sync(FULL, p, P), psym, pprefix, h);
  PendQ pb(__shfl_sync(FULL, p, P + 16), psym, pprefix, h);
  FlatQ<T, KB> fa(__shfl_sync(FULL, x, P), bwt, prefix, nprefix, nrows, h);
  FlatQ<T, KB> fb(__shfl_sync(FULL, x, P + 16), bwt, prefix, nprefix, nrows,
                  h);
  Counts pca{0u, 0u, 0u}, pcb{0u, 0u, 0u}, fca{0u, 0u, 0u}, fcb{0u, 0u, 0u};
  {
    uint4 ra[4], rb[4], rc[4], rd[4];
    load4(pa.row, pa.within, 16 * h, ra);
    load4(pb.row, pb.within, 16 * h, rb);
    load4(fa.row, fa.within, 16 * h, rc);
    load4(fb.row, fb.within, 16 * h, rd);
    count4(ra, pa.within, 16 * h, pca);
    count4(rb, pb.within, 16 * h, pcb);
    count4(rc, fa.within, 16 * h, fca);
    count4(rd, fb.within, 16 * h, fcb);
  }
#pragma unroll 1
  for (int s = 1; s < KB; ++s) {
    uint4 rc[4], rd[4];
    const int off0 = 128 * s + 16 * h;
    load4(fa.row, fa.within, off0, rc);
    load4(fb.row, fb.within, off0, rd);
    count4(rc, fa.within, off0, fca);
    count4(rd, fb.within, off0, fcb);
  }
  uint32_t spa[3], spb[3], sfa[3], sfb[3];
  pair_sum(pca, h, spa);
  pair_sum(pcb, h, spb);
  pair_sum(fca, h, sfa);
  pair_sum(fcb, h, sfb);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // the pending count in int32 (as pending_rank's occ), then widened
    if (q0 < Q)
      out[q0 * NSYM + 3 * h + k] = add_wrap<T>(
          fa.base[k], sfa[k], add_wrap<int32_t>(pa.base[k], spa[k], 0));
    if (q1 < Q)
      out[q1 * NSYM + 3 * h + k] = add_wrap<T>(
          fb.base[k], sfb[k], add_wrap<int32_t>(pb.base[k], spb[k], 0));
  }
}

}  // namespace

#define RB2_KB_CASES(CALL) \
  case 1: CALL(1); break;  \
  case 2: CALL(2); break;  \
  case 3: CALL(3); break;  \
  case 4: CALL(4); break;  \
  case 5: CALL(5); break;  \
  case 6: CALL(6); break;  \
  case 7: CALL(7); break;  \
  case 8: CALL(8); break;  \
  default: return (int)cudaErrorInvalidValue;

// bwt: int8[nrows * K], 16-byte aligned; prefix: T[nprefix, 6] (T int32
// when wide == 0, int64 when 1); pos: int64[Q]; out: T[Q, 6].  K = 128 KB,
// KB in 1..8.  Returns cudaGetLastError() (cudaErrorInvalidValue for
// another K).
template <typename T>
int rank_flat_launch(const void* bwt, const void* prefix, const void* pos,
                     void* out, long long Q, long long K, long long nprefix,
                     long long nrows, cudaStream_t s) {
  const unsigned grid = (unsigned)((Q + RT - 1) / RT);
#define RB2_FLAT(KB)                                                      \
  rank_flat_kernel<T, KB><<<grid, RT, 0, s>>>(                            \
      (const int8_t*)bwt, (const T*)prefix, (const int64_t*)pos, (T*)out, \
      Q, nprefix, nrows)
  switch (K / LANE) { RB2_KB_CASES(RB2_FLAT) }
#undef RB2_FLAT
  return (int)cudaGetLastError();
}

extern "C" int rb2_rank_flat(const void* bwt, const void* prefix,
                             const void* pos, void* out, long long Q,
                             long long K, long long nprefix, long long nrows,
                             long long wide, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  if (K % LANE) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return wide ? rank_flat_launch<int64_t>(bwt, prefix, pos, out, Q, K,
                                          nprefix, nrows, s)
              : rank_flat_launch<int32_t>(bwt, prefix, pos, out, Q, K,
                                          nprefix, nrows, s);
}

// pbwt: uint8[nrp * 128], 16-byte aligned; blkA: int64[nanchor, 6]; blkB:
// int32[2 * nprows + 2, 6]; pos: int64[Q]; sub: int64[Q] or null; extra:
// int32[Q, 6] or null; out: int64[Q, 6].  Returns cudaGetLastError().
extern "C" int rb2_rank_packed(const void* pbwt, const void* blkA,
                               const void* blkB, const void* pos,
                               const void* sub, const void* extra, void* out,
                               long long Q, long long nprows, long long nrp,
                               long long nanchor, void* stream) {
  if (Q > 0) {
    rank_packed_kernel<<<(unsigned)((Q + QPB - 1) / QPB), THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)pbwt, (const int64_t*)blkA, (const int32_t*)blkB,
        (const int64_t*)pos, (const int64_t*)sub, (const int32_t*)extra,
        (int64_t*)out, Q, nprows, nrp, nanchor);
  }
  return (int)cudaGetLastError();
}

// vp: int64[pcap] ascending, 16-byte aligned; psym: int8[pcap], 16-byte
// aligned; prefix: int32[pcap / 128 + 1, 6]; g: int64[Q]; p: int64[Q];
// occ: int32[Q, 6].  pcap a multiple of 128 in [128, 2^38).  Returns
// cudaGetLastError().
extern "C" int rb2_rank_pend(const void* vp, const void* psym,
                             const void* prefix, const void* g, void* p,
                             void* occ, long long Q, long long pcap,
                             void* stream) {
  if (Q > 0) {
    rank_pend_kernel<<<(unsigned)((Q + RT - 1) / RT), RT, 0,
                       (cudaStream_t)stream>>>(
        (const int64_t*)vp, (const int8_t*)psym, (const int32_t*)prefix,
        (const int64_t*)g, (int64_t*)p, (int32_t*)occ, Q, (int)(pcap / LANE));
  }
  return (int)cudaGetLastError();
}

// bwt, prefix, nprefix, nrows, K, wide as rb2_rank_flat; vp, psym, pprefix,
// pcap as rb2_rank_pend's vp, psym, prefix, pcap; g: int64[Q]; out: T[Q,
// 6]; lo <= hi: the clamp of the base position g - p.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for a K that rb2_rank_flat
// does not take).
template <typename T>
int rank_virtual_launch(const void* bwt, const void* prefix, const void* vp,
                        const void* psym, const void* pprefix, const void* g,
                        void* out, long long Q, long long K,
                        long long nprefix, long long nrows, long long pcap,
                        long long lo, long long hi, cudaStream_t s) {
  const unsigned grid = (unsigned)((Q + RT - 1) / RT);
#define RB2_VIRTUAL(KB)                                                   \
  rank_virtual_kernel<T, KB><<<grid, RT, 0, s>>>(                         \
      (const int8_t*)bwt, (const T*)prefix, (const int64_t*)vp,           \
      (const int8_t*)psym, (const int32_t*)pprefix, (const int64_t*)g,    \
      (T*)out, Q, nprefix, nrows, (int)(pcap / LANE), lo, hi)
  switch (K / LANE) { RB2_KB_CASES(RB2_VIRTUAL) }
#undef RB2_VIRTUAL
  return (int)cudaGetLastError();
}

extern "C" int rb2_rank_virtual(const void* bwt, const void* prefix,
                                const void* vp, const void* psym,
                                const void* pprefix, const void* g,
                                void* out, long long Q, long long K,
                                long long nprefix, long long nrows,
                                long long pcap, long long lo, long long hi,
                                long long wide, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  if (K % LANE) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return wide ? rank_virtual_launch<int64_t>(bwt, prefix, vp, psym, pprefix,
                                             g, out, Q, K, nprefix, nrows,
                                             pcap, lo, hi, s)
              : rank_virtual_launch<int32_t>(bwt, prefix, vp, psym, pprefix,
                                             g, out, Q, K, nprefix, nrows,
                                             pcap, lo, hi, s);
}
