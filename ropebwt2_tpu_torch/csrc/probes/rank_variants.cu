// The rank kernels measured by parts, to find what bounds them; run on
// request (`chip_smoke.py --rank-variants`), on no build path.
//
// 1. The earlier design (namespace `earlier`): the flat and the packed
//    rank with 8 threads a query (a thread's 16 bytes of the row, the six
//    counts summed over the group by 12 shuffles) and a runtime 64-bit
//    floor division in every thread, and the pending rank with one lower
//    bound over all of vp a thread.  Its flat kernel in three modes takes
//    one cost away at a time:
//      mode 0: as it was (K at run time: blk = floor(x / K) by a 64-bit
//              division and remainder, a software routine);
//      mode 1: K = 128 a compile-time constant (the division becomes
//              shifts);
//      mode 2: mode 1 without the count (each thread folds its loaded
//              words into its fields, so the loads stay live): loads,
//              index arithmetic, the group sum and the stores alone.  Its
//              answers are no rank.
//    Its flat and packed kernels also take sub and extra (rank(pos -
//    sub) + extra), as the earlier deferred rank's second launch did
//    (the packed tier's until the fused packed kernel).
// 2. csrc/rank.cu's kernels (included here) by parts, built from its
//    device functions: the flat and the packed rank's loads without
//    their count (K = 128, int32 tables for the flat; no rank), the
//    pending rank's search alone (p written) and its count alone from a
//    given p.
// 3. csrc/rank.cu's packed kernels under other launch bounds: under
//    __launch_bounds__(RT) alone (as they were first compiled) and for
//    12 and 20 CTAs an SM, beside rank.cu's PACKED_CTAS.
// Modes 0 and 1, the earlier packed and pending kernels, the count alone
// and the other launch bounds compute what their plain versions do;
// chip_smoke.py holds each against the plain version before it times
// it.
//
// Replaces: no TPU kernel (a measurement of csrc/rank.cu's design).
//
// What bounds it: PERF.md has the measured answer; the bytes are those of
// csrc/rank.cu's kernels (probes/_timing.py rank_flat_bytes,
// rank_packed_bytes, rank_pend_bytes).

#include "../rank.cu"

// the earlier design's kernels and helpers (clamp64 and add_wrap are
// csrc/rank.cu's)
namespace earlier {

constexpr int GROUP = 8;              // threads a query
constexpr int QPB = THREADS / GROUP;  // 32 queries a CTA

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;  // b > 0
  return (a % b != 0 && a < 0) ? q - 1 : q;
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

// the packed rank as PR 11 wrote it
__global__ void __launch_bounds__(THREADS)
rankvar_packed_kernel(const uint8_t* __restrict__ pbwt,
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

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
rankvar_flat_kernel(const int8_t* __restrict__ bwt,
                    const T* __restrict__ prefix,
                    const int64_t* __restrict__ pos,
                    const int64_t* __restrict__ sub,
                    const int32_t* __restrict__ extra, T* __restrict__ out,
                    int64_t Q, int64_t Krt, int64_t nprefix, int64_t nrows) {
  const int64_t K = MODE == 0 ? Krt : 128;  // modes 1, 2: a constant
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
    if (within > off) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + off);
      if (MODE == 2) {  // the loads without the count
        a += v.x ^ v.y;
        b += v.z ^ v.w;
      } else {
        count_before(v, within - off, a, b);
      }
    }
  }
  const uint32_t c = group_count(a, b, g);
  if (live && g < NSYM) {
    const T base = prefix[clamp64(blk, 0, nprefix - 1) * NSYM + g];
    out[q * NSYM + g] = add_wrap<T>(base, c, extra ? extra[q * NSYM + g] : 0);
  }
}

__global__ void __launch_bounds__(THREADS)
rankvar_pend_kernel(const int64_t* __restrict__ vp,
                    const int8_t* __restrict__ psym,
                    const int32_t* __restrict__ prefix,
                    const int64_t* __restrict__ gq,
                    int64_t* __restrict__ p_out, int32_t* __restrict__ occ,
                    int64_t Q, int64_t pcap) {
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

}  // namespace earlier

template <typename T>
int rankvar_flat_launch(long long mode, const void* bwt, const void* prefix,
                        const void* pos, const void* sub, const void* extra,
                        void* out, long long Q, long long K,
                        long long nprefix, long long nrows, cudaStream_t s) {
  const unsigned grid =
      (unsigned)((Q + earlier::QPB - 1) / earlier::QPB);
#define RB2_VAR(M)                                                        \
  earlier::rankvar_flat_kernel<T, M><<<grid, THREADS, 0, s>>>(            \
      (const int8_t*)bwt, (const T*)prefix, (const int64_t*)pos,          \
      (const int64_t*)sub, (const int32_t*)extra, (T*)out, Q, K, nprefix, \
      nrows)
  switch (mode) {
    case 0: RB2_VAR(0); break;
    case 1: RB2_VAR(1); break;
    case 2: RB2_VAR(2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RB2_VAR
  return (int)cudaGetLastError();
}

// rank(pos - sub) + extra (sub: int64[Q] or null, extra: int32[Q, 6] or
// null) over rb2_rank_flat's (csrc/rank.cu) other arguments, in mode 0, 1
// or 2 (1 and 2 need K = 128).  Returns cudaGetLastError().
extern "C" int rb2_rankvar_flat(long long mode, const void* bwt,
                                const void* prefix, const void* pos,
                                const void* sub, const void* extra,
                                void* out, long long Q, long long K,
                                long long nprefix, long long nrows,
                                long long wide, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  if (mode != 0 && K != 128) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return wide ? rankvar_flat_launch<int64_t>(mode, bwt, prefix, pos, sub,
                                             extra, out, Q, K, nprefix,
                                             nrows, s)
              : rankvar_flat_launch<int32_t>(mode, bwt, prefix, pos, sub,
                                             extra, out, Q, K, nprefix,
                                             nrows, s);
}

// as rb2_rank_pend (csrc/rank.cu)
extern "C" int rb2_rankvar_pend(const void* vp, const void* psym,
                                const void* prefix, const void* g, void* p,
                                void* occ, long long Q, long long pcap,
                                void* stream) {
  if (Q > 0) {
    earlier::rankvar_pend_kernel<<<(unsigned)((Q + THREADS - 1) / THREADS),
                                   THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)vp, (const int8_t*)psym, (const int32_t*)prefix,
        (const int64_t*)g, (int64_t*)p, (int32_t*)occ, Q, pcap);
  }
  return (int)cudaGetLastError();
}

// as rb2_rank_packed (csrc/rank.cu) at pos - sub (int64[Q] or null)
// plus extra (int32[Q, 6] or null).  Returns cudaGetLastError().
extern "C" int rb2_rankvar_packed(const void* pbwt, const void* blkA,
                                  const void* blkB, const void* pos,
                                  const void* sub, const void* extra,
                                  void* out, long long Q, long long nprows,
                                  long long nrp, long long nanchor,
                                  void* stream) {
  if (Q > 0) {
    earlier::rankvar_packed_kernel<<<
        (unsigned)((Q + earlier::QPB - 1) / earlier::QPB), THREADS, 0,
        (cudaStream_t)stream>>>(
        (const uint8_t*)pbwt, (const int64_t*)blkA, (const int32_t*)blkB,
        (const int64_t*)pos, (const int64_t*)sub, (const int32_t*)extra,
        (int64_t*)out, Q, nprows, nrp, nanchor);
  }
  return (int)cudaGetLastError();
}

// ---- csrc/rank.cu's kernels by parts ----

namespace {

// rank_flat_kernel<int32_t, 1> without its count: the same loads, each
// thread's words folded into its fields so that they stay live
__global__ void __launch_bounds__(RT)
rankpart_flat_kernel(const int8_t* __restrict__ bwt,
                     const int32_t* __restrict__ prefix,
                     const int64_t* __restrict__ pos,
                     int32_t* __restrict__ out, int64_t Q, int64_t nprefix,
                     int64_t nrows) {
  const int lane = threadIdx.x & 31, h = lane & 1, P = lane >> 1;
  const int64_t qw = (int64_t)blockIdx.x * RT + (threadIdx.x & ~31);
  const int64_t q0 = qw + P, q1 = qw + P + 16;
  const int64_t c0 = q0 < Q ? q0 : Q - 1, c1 = q1 < Q ? q1 : Q - 1;
  FlatQ<int32_t, 1> a(ldg(pos + c0), bwt, prefix, nprefix, nrows, h);
  FlatQ<int32_t, 1> b(ldg(pos + c1), bwt, prefix, nprefix, nrows, h);
  uint4 ra[4], rb[4];
  load4(a.row, a.within, 16 * h, ra);
  load4(b.row, b.within, 16 * h, rb);
  Counts ca{0u, 0u, 0u}, cb{0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ca.c01 += ra[j].x ^ ra[j].y;
    ca.c23 += ra[j].z ^ ra[j].w;
    cb.c01 += rb[j].x ^ rb[j].y;
    cb.c23 += rb[j].z ^ rb[j].w;
  }
  uint32_t sa[3], sb[3];
  pair_sum(ca, h, sa);
  pair_sum(cb, h, sb);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (q0 < Q)
      out[q0 * NSYM + 3 * h + k] = add_wrap<int32_t>(a.base[k], sa[k], 0);
    if (q1 < Q)
      out[q1 * NSYM + 3 * h + k] = add_wrap<int32_t>(b.base[k], sb[k], 0);
  }
}

// rank_packed_kernel without its count: the same loads (and launch
// bounds), each thread's words folded into its fields so that they stay
// live
__global__ void __launch_bounds__(RT, PACKED_CTAS)
rankpart_packed_kernel(PackedBase t, const int64_t* __restrict__ pos,
                       int64_t* __restrict__ out, int64_t Q) {
  const int lane = threadIdx.x & 31, h = lane & 1, P = lane >> 1;
  const int64_t qw = (int64_t)blockIdx.x * RT + (threadIdx.x & ~31);
  const int64_t q0 = qw + P, q1 = qw + P + 16;
  const int64_t c0 = q0 < Q ? q0 : Q - 1, c1 = q1 < Q ? q1 : Q - 1;
  PackedQ a(ldg(pos + c0), t, h);
  PackedQ b(ldg(pos + c1), t, h);
  uint4 ra[4], rb[4];
  load4(a.row, a.within, 16 * h, ra);
  load4(b.row, b.within, 16 * h, rb);
  Counts ca{0u, 0u, 0u}, cb{0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ca.c01 += ra[j].x ^ ra[j].y;
    ca.c23 += ra[j].z ^ ra[j].w;
    cb.c01 += rb[j].x ^ rb[j].y;
    cb.c23 += rb[j].z ^ rb[j].w;
  }
  uint32_t sa[3], sb[3];
  pair_sum(ca, h, sa);
  pair_sum(cb, h, sb);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (q0 < Q)
      out[q0 * NSYM + 3 * h + k] = add_wrap<int64_t>(a.base[k], sa[k], 0);
    if (q1 < Q)
      out[q1 * NSYM + 3 * h + k] = add_wrap<int64_t>(b.base[k], sb[k], 0);
  }
}

// rank_pend_kernel's search alone (count 0) or its count alone from the
// answers p_out holds (count 1)
template <int COUNT>
__global__ void __launch_bounds__(RT)
rankpart_pend_kernel(const int64_t* __restrict__ vp,
                     const int8_t* __restrict__ psym,
                     const int32_t* __restrict__ prefix,
                     const int64_t* __restrict__ gq,
                     int64_t* __restrict__ p_out, int32_t* __restrict__ occ,
                     int64_t Q, int nblk) {
  const int lane = threadIdx.x & 31;
  const int64_t qw = (int64_t)blockIdx.x * RT + (threadIdx.x & ~31);
  const int64_t qt = qw + lane, qc = qt < Q ? qt : Q - 1;
  if constexpr (COUNT) {
    pend_count(ldg(p_out + qc), psym, prefix, occ, qw, Q, lane);
  } else {
    const int64_t p = pend_search(vp, nblk, ldg(gq + qc));
    if (qt < Q) p_out[qt] = p;
  }
}

}  // namespace

// rank_flat_kernel's loads without the count (K = 128, int32 tables) over
// rb2_rank_flat's arguments; its answers are no rank.  Returns
// cudaGetLastError().
extern "C" int rb2_rankpart_flat(const void* bwt, const void* prefix,
                                 const void* pos, void* out, long long Q,
                                 long long nprefix, long long nrows,
                                 void* stream) {
  if (Q > 0) {
    rankpart_flat_kernel<<<(unsigned)((Q + RT - 1) / RT), RT, 0,
                           (cudaStream_t)stream>>>(
        (const int8_t*)bwt, (const int32_t*)prefix, (const int64_t*)pos,
        (int32_t*)out, Q, nprefix, nrows);
  }
  return (int)cudaGetLastError();
}

// rank_pend_kernel's search alone (count 0: p written) or its count alone
// from the p given in p (count 1: occ written), over rb2_rank_pend's
// arguments.  Returns cudaGetLastError().
extern "C" int rb2_rankpart_pend(long long count, const void* vp,
                                 const void* psym, const void* prefix,
                                 const void* g, void* p, void* occ,
                                 long long Q, long long pcap, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  const unsigned grid = (unsigned)((Q + RT - 1) / RT);
  const cudaStream_t s = (cudaStream_t)stream;
#define RB2_PART(C)                                                       \
  rankpart_pend_kernel<C><<<grid, RT, 0, s>>>(                            \
      (const int64_t*)vp, (const int8_t*)psym, (const int32_t*)prefix,    \
      (const int64_t*)g, (int64_t*)p, (int32_t*)occ, Q, (int)(pcap / LANE))
  if (count) RB2_PART(1); else RB2_PART(0);
#undef RB2_PART
  return (int)cudaGetLastError();
}

// rank_packed_kernel's loads without the count over rb2_rank_packed's
// arguments; its answers are no rank.  Returns cudaGetLastError().
extern "C" int rb2_rankpart_packed(const void* pbwt, const void* blkA,
                                   const void* blkB, const void* pos,
                                   void* out, long long Q, long long nprows,
                                   long long nrp, long long nanchor,
                                   void* stream) {
  if (Q > 0) {
    const PackedBase t{(const uint8_t*)pbwt, (const int64_t*)blkA,
                       (const int32_t*)blkB, nprows, nrp, nanchor};
    rankpart_packed_kernel<<<(unsigned)((Q + RT - 1) / RT), RT, 0,
                             (cudaStream_t)stream>>>(t, (const int64_t*)pos,
                                                     (int64_t*)out, Q);
  }
  return (int)cudaGetLastError();
}

// ---- csrc/rank.cu's packed kernels under other launch bounds ----

namespace {

__global__ void __launch_bounds__(RT)
rankbound0_packed_kernel(PackedBase t, const int64_t* __restrict__ pos,
                         int64_t* __restrict__ out, int64_t Q) {
  rank_packed_body(t, pos, out, Q);
}

template <int CTAS>
__global__ void __launch_bounds__(RT, CTAS)
rankbound_packed_kernel(PackedBase t, const int64_t* __restrict__ pos,
                        int64_t* __restrict__ out, int64_t Q) {
  rank_packed_body(t, pos, out, Q);
}

__global__ void __launch_bounds__(RT)
rankbound0_virtual_packed_kernel(PackedBase t,
                                 const int64_t* __restrict__ vp,
                                 const int8_t* __restrict__ psym,
                                 const int32_t* __restrict__ pprefix,
                                 const int64_t* __restrict__ gq,
                                 int64_t* __restrict__ out, int64_t Q,
                                 int nblk) {
  rank_virtual_packed_body(t, vp, psym, pprefix, gq, out, Q, nblk);
}

template <int CTAS>
__global__ void __launch_bounds__(RT, CTAS)
rankbound_virtual_packed_kernel(PackedBase t, const int64_t* __restrict__ vp,
                                const int8_t* __restrict__ psym,
                                const int32_t* __restrict__ pprefix,
                                const int64_t* __restrict__ gq,
                                int64_t* __restrict__ out, int64_t Q,
                                int nblk) {
  rank_virtual_packed_body(t, vp, psym, pprefix, gq, out, Q, nblk);
}

}  // namespace

// rb2_rank_packed (csrc/rank.cu) compiled for `ctas` CTAs an SM (12 or
// 20; 0: __launch_bounds__(RT) alone).  Returns cudaGetLastError().
extern "C" int rb2_rankbound_packed(long long ctas, const void* pbwt,
                                    const void* blkA, const void* blkB,
                                    const void* pos, void* out, long long Q,
                                    long long nprows, long long nrp,
                                    long long nanchor, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  const PackedBase t{(const uint8_t*)pbwt, (const int64_t*)blkA,
                     (const int32_t*)blkB, nprows, nrp, nanchor};
  const unsigned grid = (unsigned)((Q + RT - 1) / RT);
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t* p = (const int64_t*)pos;
  int64_t* o = (int64_t*)out;
  switch (ctas) {
    case 0: rankbound0_packed_kernel<<<grid, RT, 0, s>>>(t, p, o, Q); break;
    case 12: rankbound_packed_kernel<12><<<grid, RT, 0, s>>>(t, p, o, Q); break;
    case 20: rankbound_packed_kernel<20><<<grid, RT, 0, s>>>(t, p, o, Q); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// rb2_rank_virtual_packed (csrc/rank.cu) compiled for `ctas` CTAs an SM
// (12 or 20; 0: __launch_bounds__(RT) alone).  Returns
// cudaGetLastError().
extern "C" int rb2_rankbound_virtual_packed(
    long long ctas, const void* pbwt, const void* blkA, const void* blkB,
    const void* vp, const void* psym, const void* pprefix, const void* g,
    void* out, long long Q, long long nprows, long long nrp,
    long long nanchor, long long pcap, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  const PackedBase t{(const uint8_t*)pbwt, (const int64_t*)blkA,
                     (const int32_t*)blkB, nprows, nrp, nanchor};
  const unsigned grid = (unsigned)((Q + RT - 1) / RT);
  const cudaStream_t s = (cudaStream_t)stream;
#define RB2_BOUND(KERNEL)                                                 \
  KERNEL<<<grid, RT, 0, s>>>(t, (const int64_t*)vp, (const int8_t*)psym,  \
                             (const int32_t*)pprefix, (const int64_t*)g,  \
                             (int64_t*)out, Q, (int)(pcap / LANE))
  switch (ctas) {
    case 0: RB2_BOUND(rankbound0_virtual_packed_kernel); break;
    case 12: RB2_BOUND(rankbound_virtual_packed_kernel<12>); break;
    case 20: RB2_BOUND(rankbound_virtual_packed_kernel<20>); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RB2_BOUND
  return (int)cudaGetLastError();
}
