// The candidate forms of the k-mer search kernels, for tools/query_forms.py:
// the package's group kernels (csrc/query.cu, included whole: the groups of
// a warp step together) and their refill form (persistent groups whose
// query slots take the next query as soon as theirs is done) at every
// queries-a-group count and row-load policy, and the first form's one thread a query with lo's and
// hi's shared row fetched once. Built with
// -DFORMS_MIN_BLOCKS=b, every kernel's launch bound asks for b blocks an
// SM (the package's kernels ask for 1 and 8).

#include <cuda_runtime.h>

#ifdef FORMS_MIN_BLOCKS
#undef __launch_bounds__
#define __launch_bounds__(threads, blocks) \
  __attribute__((launch_bounds(threads, FORMS_MIN_BLOCKS)))
#endif

#include "../rust_msbwt_tpu_torch/csrc/query.cu"

namespace {

// The refill form of the group kernels: the grid holds no more groups than
// the card keeps resident (launch_refill); group g serves Q query slots, and slot k takes queries gQ + k, then that
// plus the grid's query slots, and so on: a slot whose query is done writes
// it and takes its next one at once, so a warp's lanes stay busy when its
// queries end at different steps (ragged lengths, the pair tier's empty
// ranges) and the batch has no tail of part-empty waves. Every row load of
// a step is issued before any is used.
template <int Q, bool kL1>
__global__ void __launch_bounds__(kThreads, 1) packed_refill_kernel(const QueryArgs a) {
  __shared__ int s_starts[kStarts];
  if (threadIdx.x < kStarts) s_starts[threadIdx.x] = a.starts[threadIdx.x];
  __syncthreads();
  const Lane l = lane_of();
  const int64_t stride = (int64_t)gridDim.x * (kThreads / kGroup) * Q;
  int64_t q[Q];
  int t[Q], end[Q], bound[Q];
  const uint8_t* km[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    q[k] = l.group * Q + k;
    km[k] = seed(a, l.upper, q[k], end[k], bound[k]);
    t[k] = a.cache_k;
  }
  // lane 0 of a quad loads the occurrence piece of the symbol, lanes 1..3
  // plane j - 1
  const unsigned plane = max(l.j - 1, 0);
  for (;;) {
    bool live = false;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      if (q[k] < a.B && t[k] >= end[k]) {  // done: its range out, the next query in
        if (l.j == 0) (l.upper ? a.out1 : a.out0)[q[k]] = bound[k];
        q[k] += stride;
        km[k] = seed(a, l.upper, q[k], end[k], bound[k]);
        t[k] = a.cache_k;
      }
      live |= q[k] < a.B;
    }
    if (!__any_sync(kFull, live)) break;
    int s[Q];
    int4 v[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const bool act = t[k] < end[k];
      s[k] = act ? km[k][a.K - 1 - t[k]] : 0;
      v[k] = make_int4(0, 0, 0, 0);
      if (act) {
        const int4* row =
            reinterpret_cast<const int4*>(a.table + (int64_t)(bound[k] >> kBinShift) * kRow);
        v[k] = row_piece<kL1>(row + (l.j == 0 ? s[k] >> 2 : kPackedPlane + plane));
      }
    }
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const uint4 x = l.j == 0 ? ones4() : plane_match(v[k], 0u - ((s[k] >> plane) & 1u));
      const int c = quad_rank(x, l.j == 0 ? lane_of4(v[k], s[k] & 3) : 0,
                              bound[k] & kBinMask, l.j);
      if (t[k] < end[k]) {
        bound[k] = s_starts[s[k]] + c;
        ++t[k];
      }
    }
  }
}

template <int Q, bool kL1>
__global__ void __launch_bounds__(kThreads, 8) pair_refill_kernel(const QueryArgs a) {
  __shared__ int s_starts[kStarts];
  __shared__ int s_d[kPairs];  // C[s1] + D[s1][s2] at s1 * 6 + s2
  if (threadIdx.x < kStarts) s_starts[threadIdx.x] = a.starts[threadIdx.x];
  if (threadIdx.x < kPairs)
    s_d[threadIdx.x] = a.starts[threadIdx.x / kSyms] + a.dmat[threadIdx.x];
  __syncthreads();
  const Lane l = lane_of();
  const int64_t stride = (int64_t)gridDim.x * (kThreads / kGroup) * Q;
  int64_t q[Q];
  int t[Q], end[Q], bound[Q], other[Q];  // other: the group's other bound
  const uint8_t* km[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    q[k] = l.group * Q + k;
    km[k] = seed(a, l.upper, q[k], end[k], bound[k]);
    t[k] = a.cache_k;
  }
  for (;;) {
    bool live = false;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      other[k] = __shfl_xor_sync(kFull, bound[k], 4);
      // done (no symbol left, or an empty range): its count out, the next
      // query in
      if (q[k] < a.B && !(t[k] < end[k] && bound[k] != other[k])) {
        if (l.j == 0 && !l.upper) a.out0[q[k]] = other[k] - bound[k];
        q[k] += stride;
        km[k] = seed(a, l.upper, q[k], end[k], bound[k]);
        t[k] = a.cache_k;
      }
      live |= q[k] < a.B;
      other[k] = __shfl_xor_sync(kFull, bound[k], 4);
    }
    if (!__any_sync(kFull, live)) break;
    bool act[Q], two[Q];
    int code[Q], occ_lane[Q];
    int4 va[Q], vb[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      act[k] = t[k] < end[k] && bound[k] != other[k];
      two[k] = t[k] + 1 < end[k];  // two symbols left: s2, then s1
      const int s2 = act[k] ? km[k][a.K - 1 - t[k]] : 0;
      const int s1 = act[k] && two[k] ? km[k][a.K - 2 - t[k]] : 0;
      int64_t b = bound[k] >> kBinShift;
      if (b > a.nb - 1) b = a.nb - 1;
      const int4* row = reinterpret_cast<const int4*>(a.table + b * kPairLanes);
      // lane j loads plane j (a round) or plane 3 + j (a tail, lanes
      // 0..2), and a second piece: plane 4 + j (a round, lanes 0..1), the
      // code's occurrence piece (a round, lane 2); a tail's lane 3 loads
      // the two pieces that hold the symbol's six occurrence lanes
      code[k] = two[k] ? (s2 << 3) | s1 : s2 << 3;
      occ_lane[k] = s2 * kSyms + (two[k] ? s1 : 0);
      const bool occ_q = l.j == (two[k] ? 2 : 3);
      const int piece_a = occ_q && !two[k] ? occ_lane[k] >> 2
                                           : kPlanePiece + l.j + (two[k] ? 0 : 3);
      const int piece_b = occ_q ? (occ_lane[k] >> 2) + !two[k] : kPlanePiece + 4 + l.j;
      va[k] = vb[k] = make_int4(0, 0, 0, 0);
      if (act[k]) {
        va[k] = row_piece<kL1>(row + piece_a);
        if (two[k] ? l.j < 3 : l.j == 3) vb[k] = row_piece<kL1>(row + piece_b);
      }
    }
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const bool occ_q = l.j == (two[k] ? 2 : 3);
      const int plane_a = l.j + (two[k] ? 0 : 3);
      uint4 x = occ_q && !two[k] ? ones4()
                                 : plane_match(va[k], 0u - ((code[k] >> plane_a) & 1u));
      if (two[k] && l.j < 2)
        x = and4(x, plane_match(vb[k], 0u - ((code[k] >> (4 + l.j)) & 1u)));
      int occ = 0;
      if (occ_q)  // a round: one lane; a tail: lanes 6s..6s+5 from lane 0 or 2 of va on
        occ = two[k] ? lane_of4(vb[k], occ_lane[k] & 3)
                     : va[k].z + va[k].w + vb[k].x + vb[k].y
                           + ((occ_lane[k] & 3) == 0 ? va[k].x + va[k].y : vb[k].z + vb[k].w);
      int64_t b = bound[k] >> kBinShift;
      if (b > a.nb - 1) b = a.nb - 1;
      const int c = quad_rank(x, occ, bound[k] - (int)(b << kBinShift), l.j);  // offset 0..128
      if (act[k]) {
        const int s2 = code[k] >> 3, s1 = code[k] & 7;
        bound[k] = (two[k] ? s_d[s1 * kSyms + s2] : s_starts[s2]) + c;
        t[k] += 2;
      }
    }
  }
}

// A grid of at most the blocks of Kernel the card keeps resident (found
// once a process), each of kThreads lanes, for B queries q a group.
template <void (*Kernel)(QueryArgs)>
int launch_refill(const QueryArgs& a, int q, void* stream) {
  static const int64_t resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, 0);
    return (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }();
  if (a.B > 0) {
    const int64_t need = ((a.B + q - 1) / q * kGroup + kThreads - 1) / kThreads;
    Kernel<<<(unsigned)(need < resident ? need : resident), kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

__device__ __forceinline__ void thread_seed(const QueryArgs& a, const uint8_t* km, int& lo,
                                            int& hi) {
  lo = 0;
  hi = a.n;
  if (a.cache_k > 0) {
    int64_t code = 0;
    for (int c = a.K - a.cache_k; c < a.K; ++c) code = code * kSyms + km[c];
    lo = __ldg(a.cache_lo + code);
    hi = __ldg(a.cache_hi + code);
  }
}

// The packed rank off four pieces: the symbol's occurrence piece, planes 0..2.
__device__ __forceinline__ int packed_rank4(const int4* v, int s, int pos) {
  const unsigned s0 = 0u - (unsigned)(s & 1), s1 = 0u - (unsigned)((s >> 1) & 1),
                 s2 = 0u - (unsigned)((s >> 2) & 1);
  const int r = pos & kBinMask;
#define M(c) (~((unsigned)v[1].c ^ s0) & ~((unsigned)v[2].c ^ s1) & ~((unsigned)v[3].c ^ s2))
  return lane_of4(v[0], s & 3) + below(M(x), r, 0) + below(M(y), r, 1) + below(M(z), r, 2)
         + below(M(w), r, 3);
#undef M
}

// One thread a query (the first form), hi's loads skipped when lo's row is hi's.
__global__ void __launch_bounds__(kThreads, 1) packed_thread_kernel(const QueryArgs a) {
  __shared__ int s_starts[kStarts];
  if (threadIdx.x < kStarts) s_starts[threadIdx.x] = a.starts[threadIdx.x];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.B) return;
  const uint8_t* km = a.kmers + i * a.K;
  const int end = min(a.lengths[i], a.K);
  int lo, hi;
  thread_seed(a, km, lo, hi);
  for (int t = a.cache_k; t < end; ++t) {
    const int s = km[a.K - 1 - t];
    const int4* rl = reinterpret_cast<const int4*>(a.table + (int64_t)(lo >> kBinShift) * kRow);
    const int4* rh = reinterpret_cast<const int4*>(a.table + (int64_t)(hi >> kBinShift) * kRow);
    int4 lv[4], hv[4];
    lv[0] = __ldg(rl + (s >> 2));
#pragma unroll
    for (int p = 1; p < 4; ++p) lv[p] = __ldg(rl + kPackedPlane + p - 1);
    if (rl != rh) {
      hv[0] = __ldg(rh + (s >> 2));
#pragma unroll
      for (int p = 1; p < 4; ++p) hv[p] = __ldg(rh + kPackedPlane + p - 1);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) hv[p] = lv[p];
    }
    const int c = s_starts[s];
    const int new_lo = c + packed_rank4(lv, s, lo);
    hi = c + packed_rank4(hv, s, hi);
    lo = new_lo;
  }
  a.out0[i] = lo;
  a.out1[i] = hi;
}

// The pair row's occurrences and planes for a round (code, occ lane) or a
// tail (planes 3..5, six occurrence lanes), and its rank.
__device__ __forceinline__ void pair_pieces(const int32_t* row, bool two, int s2, int s1, int4* v,
                                            int& occ) {
  const int4* planes = reinterpret_cast<const int4*>(row + kPlanePiece * 4);
#pragma unroll
  for (int p = 0; p < 6; ++p)
    if (two || p >= 3) v[p] = __ldg(planes + p);
  if (two) {
    occ = __ldg(row + s2 * kSyms + s1);
  } else {
    const int2* o = reinterpret_cast<const int2*>(row + s2 * kSyms);
    const int2 o0 = __ldg(o), o1 = __ldg(o + 1), o2 = __ldg(o + 2);
    occ = o0.x + o0.y + o1.x + o1.y + o2.x + o2.y;
  }
}

__device__ __forceinline__ int pair_rank6(const int4* v, int occ, bool two, int code, int r) {
  unsigned m0 = kFull, m1 = kFull, m2 = kFull, m3 = kFull;
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    if (!two && p < 3) continue;
    const unsigned sp = 0u - (unsigned)((code >> p) & 1);
    m0 &= ~((unsigned)v[p].x ^ sp);
    m1 &= ~((unsigned)v[p].y ^ sp);
    m2 &= ~((unsigned)v[p].z ^ sp);
    m3 &= ~((unsigned)v[p].w ^ sp);
  }
  return occ + below(m0, r, 0) + below(m1, r, 1) + below(m2, r, 2) + below(m3, r, 3);
}

__global__ void __launch_bounds__(kThreads, 1) pair_thread_kernel(const QueryArgs a) {
  __shared__ int s_starts[kStarts];
  __shared__ int s_d[kPairs];
  if (threadIdx.x < kStarts) s_starts[threadIdx.x] = a.starts[threadIdx.x];
  if (threadIdx.x < kPairs)
    s_d[threadIdx.x] = a.starts[threadIdx.x / kSyms] + a.dmat[threadIdx.x];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.B) return;
  const uint8_t* km = a.kmers + i * a.K;
  const int end = min(a.lengths[i], a.K);
  int lo, hi;
  thread_seed(a, km, lo, hi);
  for (int t = a.cache_k; t < end && lo != hi; t += 2) {
    const int s2 = km[a.K - 1 - t];
    const bool two = t + 1 < end;
    const int s1 = two ? km[a.K - 2 - t] : 0;
    const int code = two ? (s2 << 3) | s1 : s2 << 3;
    const int64_t bl = (lo >> kBinShift) < a.nb ? lo >> kBinShift : a.nb - 1;
    const int64_t bh = (hi >> kBinShift) < a.nb ? hi >> kBinShift : a.nb - 1;
    int4 vl[6], vh[6];
    int ol, oh;
    pair_pieces(a.table + bl * kPairLanes, two, s2, s1, vl, ol);
    if (bh != bl) {
      pair_pieces(a.table + bh * kPairLanes, two, s2, s1, vh, oh);
    } else {
#pragma unroll
      for (int p = 0; p < 6; ++p) vh[p] = vl[p];
      oh = ol;
    }
    const int d = two ? s_d[s1 * kSyms + s2] : s_starts[s2];
    const int new_lo = d + pair_rank6(vl, ol, two, code, lo - (int)(bl << kBinShift));
    hi = d + pair_rank6(vh, oh, two, code, hi - (int)(bh << kBinShift));
    lo = new_lo;
  }
  a.out0[i] = hi - lo;
}

template <typename Kernel>
int launch_thread(Kernel kernel, const QueryArgs& a, void* stream) {
  if (a.B > 0)
    kernel<<<(unsigned)((a.B + kThreads - 1) / kThreads), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// form: 0 = one thread a query; else 16 * kind + 2 * (queries a group) +
// (1 if the row loads go through L1), queries 1, 2 or 4, kind 1 for the
// package's (lockstep) form and 2 for the refill form. The other
// arguments are msbwt_kmer_ranges_packed's.
int forms_packed(int form, const void* table, const void* starts, const void* kmers,
                 const void* lengths, const void* cache_lo, const void* cache_hi, void* lo,
                 void* hi, int64_t B, int K, int cache_k, int n, void* stream) {
  QueryArgs a = {};
  a.table = (const int32_t*)table;
  a.starts = (const int32_t*)starts;
  a.kmers = (const uint8_t*)kmers;
  a.lengths = (const int32_t*)lengths;
  a.cache_lo = (const int32_t*)cache_lo;
  a.cache_hi = (const int32_t*)cache_hi;
  a.out0 = (int32_t*)lo;
  a.out1 = (int32_t*)hi;
  a.B = B;
  a.K = K;
  a.cache_k = cache_k;
  a.n = n;
  switch (form) {
    case 0: return launch_thread(packed_thread_kernel, a, stream);
    case 18: return launch<kmer_ranges_packed_kernel<1, false>>(a, 1, stream);
    case 19: return launch<kmer_ranges_packed_kernel<1, true>>(a, 1, stream);
    case 20: return launch<kmer_ranges_packed_kernel<2, false>>(a, 2, stream);
    case 21: return launch<kmer_ranges_packed_kernel<2, true>>(a, 2, stream);
    case 24: return launch<kmer_ranges_packed_kernel<4, false>>(a, 4, stream);
    case 25: return launch<kmer_ranges_packed_kernel<4, true>>(a, 4, stream);
    case 34: return launch_refill<packed_refill_kernel<1, false>>(a, 1, stream);
    case 35: return launch_refill<packed_refill_kernel<1, true>>(a, 1, stream);
    case 36: return launch_refill<packed_refill_kernel<2, false>>(a, 2, stream);
    case 37: return launch_refill<packed_refill_kernel<2, true>>(a, 2, stream);
    case 40: return launch_refill<packed_refill_kernel<4, false>>(a, 4, stream);
    case 41: return launch_refill<packed_refill_kernel<4, true>>(a, 4, stream);
  }
  return -1;
}

// As forms_packed, with msbwt_kmer_counts_pair's other arguments.
int forms_pair(int form, const void* table2, const void* starts, const void* dmat,
               const void* kmers, const void* lengths, const void* cache_lo,
               const void* cache_hi, void* counts, int64_t B, int64_t nb, int K, int cache_k,
               int n, void* stream) {
  QueryArgs a = {};
  a.table = (const int32_t*)table2;
  a.starts = (const int32_t*)starts;
  a.dmat = (const int32_t*)dmat;
  a.kmers = (const uint8_t*)kmers;
  a.lengths = (const int32_t*)lengths;
  a.cache_lo = (const int32_t*)cache_lo;
  a.cache_hi = (const int32_t*)cache_hi;
  a.out0 = (int32_t*)counts;
  a.B = B;
  a.nb = nb;
  a.K = K;
  a.cache_k = cache_k;
  a.n = n;
  switch (form) {
    case 0: return launch_thread(pair_thread_kernel, a, stream);
    case 18: return launch<kmer_counts_pair_kernel<1, false>>(a, 1, stream);
    case 19: return launch<kmer_counts_pair_kernel<1, true>>(a, 1, stream);
    case 20: return launch<kmer_counts_pair_kernel<2, false>>(a, 2, stream);
    case 21: return launch<kmer_counts_pair_kernel<2, true>>(a, 2, stream);
    case 24: return launch<kmer_counts_pair_kernel<4, false>>(a, 4, stream);
    case 25: return launch<kmer_counts_pair_kernel<4, true>>(a, 4, stream);
    case 34: return launch_refill<pair_refill_kernel<1, false>>(a, 1, stream);
    case 35: return launch_refill<pair_refill_kernel<1, true>>(a, 1, stream);
    case 36: return launch_refill<pair_refill_kernel<2, false>>(a, 2, stream);
    case 37: return launch_refill<pair_refill_kernel<2, true>>(a, 2, stream);
    case 40: return launch_refill<pair_refill_kernel<4, false>>(a, 4, stream);
    case 41: return launch_refill<pair_refill_kernel<4, true>>(a, 4, stream);
  }
  return -1;
}

// The device's L2 fetch granularity hint: set to `bytes` when it is > 0;
// returns the value after (negative: the CUDA error of the set).
int forms_l2_fetch(int bytes) {
  if (bytes > 0) {
    const cudaError_t e = cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes);
    if (e != cudaSuccess) return -(int)e;
  }
  size_t v = 0;
  cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity);
  return (int)v;
}

}  // extern "C"
