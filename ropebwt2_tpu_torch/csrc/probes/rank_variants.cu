// The rank kernels measured by parts, to find what bounds them; run on
// request (`chip_smoke.py --rank-variants`), on no build path.
//
// 1. The earlier design (namespace `earlier`): the flat rank with 8
//    threads a query (a thread's 16 bytes of the row, the six counts
//    summed over the group by 12 shuffles) and a runtime 64-bit floor
//    division by K in every thread, and the pending rank with one lower
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
//    Its flat kernel also takes sub and extra (rank(pos - sub) + extra),
//    as the earlier deferred rank's second launch did.
// 2. csrc/rank.cu's kernels (included here) by parts, built from its
//    device functions: the flat rank's loads without its count (K = 128,
//    int32 tables; no rank), the pending rank's search alone (p written)
//    and its count alone from a given p.
// Modes 0 and 1, the earlier pending kernel and the count alone compute
// what their plain versions do; chip_smoke.py holds each against the
// plain version before it times it.
//
// Replaces: no TPU kernel (a measurement of csrc/rank.cu's design).
//
// What bounds it: PERF.md has the measured answer; the bytes are those of
// csrc/rank.cu's kernels (probes/_timing.py rank_flat_bytes,
// rank_pend_bytes).

#include "../rank.cu"

// the earlier design's kernels; its helpers (floor_div, count_before,
// group_count, add_wrap) are csrc/rank.cu's, which rank_packed still uses
namespace earlier {

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
  const unsigned grid = (unsigned)((Q + QPB - 1) / QPB);
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
