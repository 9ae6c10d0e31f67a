// Rank kernels: the 6-symbol rank (occ) at a batch of positions, counted
// inside the 128-symbol row, for the flat tier, the packed tier and the
// pending index.
//
// Replaces: the (Q, 128, 6) one-hot count of the plain versions, which are
// the JAX package's jnp code (ropebwt2_tpu/index/rank.py rank_global,
// ropebwt2_tpu/index/packed.py rank_global_packed,
// ropebwt2_tpu/index/pending.py pending_rank; XLA code, no Pallas kernel):
// a (Q, 128) row gather, a (Q, 128) mask, a (Q, 128, 6) compare, an `&`
// and a sum over 128, each a pass over device memory.
//
// What it computes (index/rank_cuda.py holds the plain versions' contract
// bit for bit, clamps of out-of-range positions included):
// - rank_flat:   out[q, s] = prefix[blk] + |{ j < within : row[j] == s }|
//   with blk = floor(x / K), within = x - blk K, x = pos[q] (- sub[q]);
//   the prefix and the row clamped to their tables; + extra[q, s] if given;
// - rank_packed: the same over the nibble plane of symbol row blk (byte j
//   of packed row blk >> 1, shifted by 4 (blk & 1)), with the base
//   blkA[x >> 24] + blkB[blkb_row(blk)], int64;
// - rank_pend:   p[q] = |{ i : vp[i] < g[q] }| by a binary search over the
//   sorted vp, then occ[q, s] = prefix[jb] + the count of s among psym
//   rows [jb 128, p), jb = max(p - 1, 0) >> 7, int32.
//
// What bounds it on the card: bytes.  A query needs its 8-byte position,
// the bytes of its row below `within` (128 at most), a 6-entry prefix row
// and its 6-entry answer: ~230 B at most, a few dozen integer operations
// a query.  The rows are scattered, so the row reads are what costs: one
// 128-byte line a query.
//
// What the design does about it:
// - A group of 8 threads a query, 32 queries a CTA: each thread loads 16
//   bytes of the row with one 16-byte load (K / 128 of them when K > 128),
//   so a warp's load instruction moves four whole rows; a thread whose
//   16 bytes all lie at or past `within` loads nothing.
// - Bytes become nibbles that count16_packed (common.cuh) counts: any
//   byte that is not a symbol 0..5 (an unspecified byte past the live
//   prefix, PAD, a negative int8) and any byte at or past `within`
//   becomes 15, which is no symbol, in five word operations; the six
//   counts then ride in 8-bit fields, widened to 16 bits for the 8-lane
//   shuffle sum (a K-row holds up to 1024 of a symbol).
// - Lanes 0-5 of the group add their symbol's prefix entry and write the
//   answer: a warp's four queries leave as 24 consecutive entries.
// - The pending index is searched one query a thread (a lower bound over
//   vp, as torch.searchsorted does), 256 queries a CTA, so that 2048
//   searches an SM keep their dependent loads in flight; each group of 8
//   then counts the 8 rows of its own lanes' queries in turn.
// - `sub` and `extra` fold rank_virtual_base's `g - p` and `+ occ` into
//   the base count, so a deferred round's virtual rank is two launches.

#include <type_traits>

#include "common.cuh"

using namespace rb2;

namespace {

constexpr int GROUP = 8;               // threads a query
constexpr int QPB = THREADS / GROUP;   // 32 queries a CTA (flat, packed)
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
rank_flat_kernel(const int8_t* __restrict__ bwt, const T* __restrict__ prefix,
                 const int64_t* __restrict__ pos,
                 const int64_t* __restrict__ sub,
                 const int32_t* __restrict__ extra, T* __restrict__ out,
                 int64_t Q, int64_t K, int64_t nprefix, int64_t nrows) {
  const int g = threadIdx.x & (GROUP - 1);
  const int64_t q0 = (int64_t)blockIdx.x * QPB + (threadIdx.x >> 3);
  const bool live = q0 < Q;
  const int64_t q = live ? q0 : Q - 1;
  const int64_t x = pos[q] - (sub ? sub[q] : 0);
  const int64_t blk = floor_div(x, K);
  const int64_t within = x - blk * K;
  const int8_t* row = bwt + clamp64(blk, 0, nrows - 1) * K;
  uint32_t a = 0, b = 0;
  for (int64_t off = 16 * g; off < K; off += 16 * GROUP) {
    if (within > off)
      count_before(*reinterpret_cast<const uint4*>(row + off), within - off,
                   a, b);
  }
  const uint32_t c = group_count(a, b, g);
  if (live && g < NSYM) {
    const T base = prefix[clamp64(blk, 0, nprefix - 1) * NSYM + g];
    out[q * NSYM + g] = add_wrap<T>(base, c, extra ? extra[q * NSYM + g] : 0);
  }
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

__global__ void __launch_bounds__(THREADS)
rank_pend_kernel(const int64_t* __restrict__ vp,
                 const int8_t* __restrict__ psym,
                 const int32_t* __restrict__ prefix,
                 const int64_t* __restrict__ gq, int64_t* __restrict__ p_out,
                 int32_t* __restrict__ occ, int64_t Q, int64_t pcap) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (GROUP - 1);
  const int64_t q0 = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t q = q0 < Q ? q0 : Q - 1;
  // this thread's query: the first row with vp >= g (a lower bound)
  const int64_t x = gq[q];
  int64_t lo = 0, n = pcap;
  while (n > 0) {
    const int64_t half = n >> 1;
    if (vp[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  if (q0 < Q) p_out[q0] = lo;
  // the group counts the rows of its 8 lanes' queries, one after another
  const int64_t gfirst = q0 - g;
#pragma unroll 1
  for (int i = 0; i < GROUP; ++i) {
    const int64_t p = __shfl_sync(FULL, lo, (lane & ~(GROUP - 1)) + i);
    const int64_t jb = (p > 0 ? p - 1 : 0) >> 7;
    const int64_t within = p - jb * LANE;
    const int64_t off = 16 * g;
    uint32_t a = 0, b = 0;
    if (within > off)
      count_before(*reinterpret_cast<const uint4*>(psym + jb * LANE + off),
                   within - off, a, b);
    const uint32_t c = group_count(a, b, g);
    const int64_t qi = gfirst + i;
    if (qi < Q && g < NSYM)
      occ[qi * NSYM + g] = add_wrap<int32_t>(prefix[jb * NSYM + g], c, 0);
  }
}

}  // namespace

// bwt: int8[nrows * K], 16-byte aligned; prefix: T[nprefix, 6] (T int32
// when wide == 0, int64 when 1); pos: int64[Q]; sub: int64[Q] or null;
// extra: int32[Q, 6] or null; out: T[Q, 6].  K % 128 == 0, K <= 1024.
// Returns cudaGetLastError().
extern "C" int rb2_rank_flat(const void* bwt, const void* prefix,
                             const void* pos, const void* sub,
                             const void* extra, void* out, long long Q,
                             long long K, long long nprefix, long long nrows,
                             long long wide, void* stream) {
  if (Q > 0) {
    const unsigned grid = (unsigned)((Q + QPB - 1) / QPB);
    const cudaStream_t s = (cudaStream_t)stream;
    if (wide)
      rank_flat_kernel<int64_t><<<grid, THREADS, 0, s>>>(
          (const int8_t*)bwt, (const int64_t*)prefix, (const int64_t*)pos,
          (const int64_t*)sub, (const int32_t*)extra, (int64_t*)out, Q, K,
          nprefix, nrows);
    else
      rank_flat_kernel<int32_t><<<grid, THREADS, 0, s>>>(
          (const int8_t*)bwt, (const int32_t*)prefix, (const int64_t*)pos,
          (const int64_t*)sub, (const int32_t*)extra, (int32_t*)out, Q, K,
          nprefix, nrows);
  }
  return (int)cudaGetLastError();
}

// pbwt: uint8[nrp * 128], 16-byte aligned; blkA: int64[nanchor, 6]; blkB:
// int32[2 * nprows + 2, 6]; pos, sub, extra as rb2_rank_flat; out:
// int64[Q, 6].  Returns cudaGetLastError().
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

// vp: int64[pcap] ascending; psym: int8[pcap], 16-byte aligned; prefix:
// int32[pcap / 128 + 1, 6]; g: int64[Q]; p: int64[Q]; occ: int32[Q, 6].
// pcap % 128 == 0.  Returns cudaGetLastError().
extern "C" int rb2_rank_pend(const void* vp, const void* psym,
                             const void* prefix, const void* g, void* p,
                             void* occ, long long Q, long long pcap,
                             void* stream) {
  if (Q > 0) {
    rank_pend_kernel<<<(unsigned)((Q + THREADS - 1) / THREADS), THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const int64_t*)vp, (const int8_t*)psym, (const int32_t*)prefix,
        (const int64_t*)g, (int64_t*)p, (int32_t*)occ, Q, pcap);
  }
  return (int)cudaGetLastError();
}
