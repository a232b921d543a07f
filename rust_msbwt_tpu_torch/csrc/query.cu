// K-mer backward search for Hopper (sm_90a): the packed tier's range search
// (kmer_ranges_packed) and the pair tier's counts (kmer_counts_pair), one
// thread a query, one launch a batch.
//
// The JAX package has no Pallas kernel for these: it runs them as XLA
// fusions inside one compiled program (a fori_loop over the steps). What
// they replace there:
//   kmer_ranges_packed  rust_msbwt_tpu/ops/packed_rank.py::_kmer_ranges_packed_impl
//                       (:122), with rank_packed (:82) and the cache seed
//                       ops/rank.py::_cache_seed (:168);
//   kmer_counts_pair    rust_msbwt_tpu/ops/pair_rank.py::_count_kmers_pair_impl
//                       (:363), with _rows_of (:300) and _decode_rank (:305).
// Before these kernels the port ran the same loops as eager torch ops: per
// step a [2B, 32] or [2B, 60] row gather, int64 SWAR popcounts, masks and
// wheres, tens of kernels and host launches a step (and, for the pair tier,
// a host sync a batch for the set of query lengths).
//
// What bounds them: memory latency. Each step is a dependent random row
// read per bound (the next row depends on this step's rank), ~100 B of row
// a bound against ~30 integer operations. A thread keeps its query's lo and
// hi in registers from the cache seed to the end, and the loads of both
// bounds go out together. A warp's k-mer byte loads are uncoalesced
// (row-major [B, K]); a thread's K bytes sit in one or two sectors that
// stay in L1 over its steps. This is the first form: no shared-memory
// staging, one query a thread.
//
// The packed tier reads the PackedOccIndex table through rank.cuh's
// rank_at, the rank the BCR stage step and the LF walks take (lf.cu). It
// has no early exit: an empty range keeps stepping, as the JAX function
// does, so lo and hi are bit-exact for locate_kmers; a step past the
// query's length leaves them as they are.
//
// The pair table (ops/pair_rank.py): int32 [nb, 60] per 128-position bin
// (240 B rows, 16 B-aligned, no terminal row); lanes 0..35 count pair code
// (s << 3 | prev) at lane s*6 + prev before the bin; lane 36 + 4p + l holds
// bit plane p (of 6) of word l (of 4) of the bin's pair codes (the pad
// code 63 past n). A round consumes two symbols (s2, then s1) off one row a
// bound: l' = C[s1] + D[s1][s2] + rank2_{(s2, s1)}(l), all six planes; a
// query with one symbol left takes the three symbol planes (3..5) and the
// six occurrence lanes of its symbol. The reader takes row min(pos / 128,
// nb - 1) and lets the in-bin offset reach 128 (a full-bin mask), as the
// port's plain reader does. A query whose range is empty stops: its count
// is 0 either way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rank.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairLanes = 60;  // int32 lanes per pair-table row
constexpr int kPlaneBase = 36;  // first bit-plane lane of a pair row
constexpr int kPairs = kSyms * kSyms;

struct QueryArgs {
  const int32_t* table;     // packed [nb + 1, 32] or pair [nb, 60], 16 B-aligned
  const int32_t* starts;    // [7]: C array of the index
  const int32_t* dmat;      // pair: [36], D[s1 * 6 + s2]
  const uint8_t* kmers;     // [B, K], right-aligned, symbols 0..5
  const int32_t* lengths;   // [B]
  const int32_t* cache_lo;  // [6^cache_k] (null when cache_k == 0)
  const int32_t* cache_hi;
  int32_t* out0;            // packed: lo [B]; pair: hi - lo [B]
  int32_t* out1;            // packed: hi [B]
  int64_t B;
  int64_t nb;               // pair: table rows
  int K;
  int cache_k;              // 0: no cache
  int n;
};

// [lo, hi) of the query's last cache_k symbols off the prefix cache (its
// code: the symbols' base-6 digits, most significant first), or [0, n).
__device__ __forceinline__ void seed(const QueryArgs& a, const uint8_t* km, int& lo, int& hi) {
  lo = 0;
  hi = a.n;
  if (a.cache_k > 0) {
    int64_t code = 0;
    for (int c = a.K - a.cache_k; c < a.K; ++c) code = code * kSyms + km[c];
    lo = __ldg(a.cache_lo + code);
    hi = __ldg(a.cache_hi + code);
  }
}

// The pair row of pos (clamped to the last row) and the in-bin offset 0..128.
__device__ __forceinline__ const int32_t* pair_row(const QueryArgs& a, int pos, int& r) {
  int64_t b = pos >> kBinShift;
  if (b > a.nb - 1) b = a.nb - 1;
  r = pos - (int)(b << kBinShift);
  return a.table + b * kPairLanes;
}

// the four plane-match words ANDed with plane words v, bit sp of the code
#define PAIR_MATCH(v, sp) \
  m0 &= ~((unsigned)(v).x ^ (sp)); \
  m1 &= ~((unsigned)(v).y ^ (sp)); \
  m2 &= ~((unsigned)(v).z ^ (sp)); \
  m3 &= ~((unsigned)(v).w ^ (sp));

// rank of pair code (s2 << 3 | s1) in the pair stream before pos.
__device__ __forceinline__ int pair_rank2(const QueryArgs& a, int pos, int s2, int s1) {
  int r;
  const int32_t* row = pair_row(a, pos, r);
  const int4* planes = reinterpret_cast<const int4*>(row + kPlaneBase);
  const int occ = __ldg(row + s2 * kSyms + s1);
  const int code = (s2 << 3) | s1;
  unsigned m0 = kFull, m1 = kFull, m2 = kFull, m3 = kFull;
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const int4 v = __ldg(planes + p);
    const unsigned sp = 0u - (unsigned)((code >> p) & 1);
    PAIR_MATCH(v, sp)
  }
  return occ + below(m0, r, 0) + below(m1, r, 1) + below(m2, r, 2) + below(m3, r, 3);
}

// rank of symbol s (any prev) before pos: its six occurrence lanes and the
// symbol planes 3..5.
__device__ __forceinline__ int pair_rank1(const QueryArgs& a, int pos, int s) {
  int r;
  const int32_t* row = pair_row(a, pos, r);
  const int4* planes = reinterpret_cast<const int4*>(row + kPlaneBase);
  // lanes s*6 .. s*6+5 start 24 s bytes into a 16 B-aligned row: 8 B-aligned
  const int2* occ = reinterpret_cast<const int2*>(row + s * kSyms);
  const int2 o0 = __ldg(occ), o1 = __ldg(occ + 1), o2 = __ldg(occ + 2);
  unsigned m0 = kFull, m1 = kFull, m2 = kFull, m3 = kFull;
#pragma unroll
  for (int p = 3; p < 6; ++p) {
    const int4 v = __ldg(planes + p);
    const unsigned sp = 0u - (unsigned)((s >> (p - 3)) & 1);
    PAIR_MATCH(v, sp)
  }
  return o0.x + o0.y + o1.x + o1.y + o2.x + o2.y + below(m0, r, 0) + below(m1, r, 1)
         + below(m2, r, 2) + below(m3, r, 3);
}

#undef PAIR_MATCH

__global__ void __launch_bounds__(kThreads) kmer_ranges_packed_kernel(const QueryArgs a) {
  __shared__ int s_starts[kStarts];
  if (threadIdx.x < kStarts) s_starts[threadIdx.x] = a.starts[threadIdx.x];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.B) return;
  const uint8_t* km = a.kmers + i * a.K;
  const int end = min(a.lengths[i], a.K);  // steps t < end are active
  int lo, hi;
  seed(a, km, lo, hi);
  for (int t = a.cache_k; t < end; ++t) {
    const int s = km[a.K - 1 - t];
    const int c = s_starts[s];
    const int new_lo = c + rank_at(a.table, s, lo);
    hi = c + rank_at(a.table, s, hi);
    lo = new_lo;
  }
  a.out0[i] = lo;
  a.out1[i] = hi;
}

__global__ void __launch_bounds__(kThreads) kmer_counts_pair_kernel(const QueryArgs a) {
  __shared__ int s_starts[kStarts];
  __shared__ int s_d[kPairs];  // C[s1] + D[s1][s2] at s1 * 6 + s2
  if (threadIdx.x < kStarts) s_starts[threadIdx.x] = a.starts[threadIdx.x];
  if (threadIdx.x < kPairs)
    s_d[threadIdx.x] = a.starts[threadIdx.x / kSyms] + a.dmat[threadIdx.x];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.B) return;
  const uint8_t* km = a.kmers + i * a.K;
  const int end = min(a.lengths[i], a.K);
  int lo, hi;
  seed(a, km, lo, hi);
  for (int t = a.cache_k; t < end && lo != hi; t += 2) {
    const int s2 = km[a.K - 1 - t];
    int new_lo;
    if (t + 1 < end) {  // two symbols left: s2, then s1
      const int s1 = km[a.K - 2 - t];
      const int d = s_d[s1 * kSyms + s2];
      new_lo = d + pair_rank2(a, lo, s2, s1);
      hi = d + pair_rank2(a, hi, s2, s1);
    } else {  // one symbol left
      const int c = s_starts[s2];
      new_lo = c + pair_rank1(a, lo, s2);
      hi = c + pair_rank1(a, hi, s2);
    }
    lo = new_lo;
  }
  a.out0[i] = hi - lo;
}

template <typename Kernel>
int launch(Kernel kernel, const QueryArgs& a, void* stream) {
  if (a.B > 0) {
    const unsigned blocks = (unsigned)((a.B + kThreads - 1) / kThreads);
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The packed tier's range search: B right-aligned k-mers u8 [B, K] of
// lengths i32 [B] over the packed table i32 [nb + 1, 32] (16 B-aligned) and
// its C array starts i32 [7], each seeded from the prefix cache
// cache_lo / cache_hi i32 [6^cache_k] (cache_k 0: none, null pointers) ->
// lo, hi i32 [B]. Launches on `stream`; returns cudaGetLastError().
int msbwt_kmer_ranges_packed(const void* table, const void* starts, const void* kmers,
                             const void* lengths, const void* cache_lo, const void* cache_hi,
                             void* lo, void* hi, int64_t B, int K, int cache_k, int n,
                             void* stream) {
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
  return launch(kmer_ranges_packed_kernel, a, stream);
}

// The pair tier's counts: as msbwt_kmer_ranges_packed over the pair table
// i32 [nb, 60] (16 B-aligned) with dmat i32 [36] -> counts (hi - lo) i32 [B].
int msbwt_kmer_counts_pair(const void* table2, const void* starts, const void* dmat,
                           const void* kmers, const void* lengths, const void* cache_lo,
                           const void* cache_hi, void* counts, int64_t B, int64_t nb, int K,
                           int cache_k, int n, void* stream) {
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
  return launch(kmer_counts_pair_kernel, a, stream);
}

}  // extern "C"
