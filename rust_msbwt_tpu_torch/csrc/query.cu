// K-mer backward search for Hopper (sm_90a): the packed tier's range search
// (kmer_ranges_packed) and the pair tier's counts (kmer_counts_pair), one
// launch a batch, a group of eight lanes a query (or two).
//
// The JAX package has no Pallas kernel for these: it runs them as XLA
// fusions inside one compiled program (a fori_loop over the steps). What
// they replace there:
//   kmer_ranges_packed  rust_msbwt_tpu/ops/packed_rank.py::_kmer_ranges_packed_impl
//                       (:122), with rank_packed (:82) and the cache seed
//                       ops/rank.py::_cache_seed (:168);
//   kmer_counts_pair    rust_msbwt_tpu/ops/pair_rank.py::_count_kmers_pair_impl
//                       (:363), with _rows_of (:300) and _decode_rank (:305).
//
// What bounds them: dependent random row reads. Each step reads one table
// row a bound, at a position that depends on the step before; the tables
// (379 MB packed, 947 MB pair at 505M symbols) are many times the 50 MB L2,
// so nearly every read goes to device memory in whole 32 B sectors: ~100 B
// of row against a few dozen integer operations. On an H100 at 505M
// symbols both kernels now move their access model's bytes (96 B a packed
// row, 128 B a pair row, one a bound a step) at 2.0-2.5 TB/s, where the
// first form, one thread a query, reached 1.35-2.0 TB/s; what is left to
// gain lies in fewer sectors, not in the instructions around them.
//
// The design: a query is served by a group of eight lanes of one warp, a
// quad for lo and a quad for hi. Each lane loads whole 16 B pieces of its
// bound's row, so one warp-wide load instruction reads the contiguous
// pieces of eight rows instead of one piece of each of 32 unrelated rows,
// and when lo and hi fall in one row their quads' loads are one request
// (the load unit merges them). A quad ANDs its lanes' plane-match words
// transposed (two shuffles; lane j ends with word 2(j & 1) + (j >> 1)),
// counts that word below the in-bin offset with one __popc and sums the
// quad (two more shuffles). Every lane stays in the loop to the end of its
// warp's longest query (a warp-wide vote ends it), so no shuffle names a
// lane that has left; a lane past its query's length, or past the end of
// the batch, loads nothing and keeps its bound. A packed group holds two
// queries and issues both rows' loads before it uses either; a pair group
// holds one and its loads allocate no L1 line. These forms were timed
// against the others tried (one, two or four queries a group, either load
// policy, other register budgets, persistent groups that take a new query
// as soon as one is done, one thread a query; PERF.md §6, forms tried).
//
// The packed tier reads the PackedOccIndex row (rank.cuh; the rank that
// lf.cu's rank_at takes, cooperatively here): lane 0 of a quad the
// occurrence piece of the step's symbol (lanes 0..3 or 4..7 of the row),
// lanes 1..3 the bit planes 0..2. It has no early exit: an empty range
// keeps stepping, as the JAX function does, so lo and hi are bit-exact for
// locate_kmers; a step past the query's length leaves them as they are.
//
// The pair table (ops/pair_rank.py): int32 [nb, 60] per 128-position bin
// (240 B rows, 16 B-aligned, no terminal row); lanes 0..35 count pair code
// (s << 3 | prev) at lane s*6 + prev before the bin; lane 36 + 4p + l
// holds bit plane p (of 6) of word l (of 4) of the bin's pair codes (the
// pad code 63 past n), so plane p is the row's 16 B piece 9 + p. A round
// consumes two symbols (s2, then s1) off one row a bound:
// l' = C[s1] + D[s1][s2] + rank2_{(s2, s1)}(l); lane j of a quad loads
// plane j and a second piece (plane 4, plane 5, the occurrence piece of
// the code, nothing). A query with one symbol left takes the three symbol
// planes (3..5, lanes 0..2) and the two pieces that hold its symbol's six
// occurrence lanes (lane 3). The reader takes row min(pos / 128, nb - 1)
// and lets the in-bin offset reach 128 (a full-bin mask), as the port's
// plain reader does. A query whose range is empty stops: its count is 0
// either way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rank.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;        // lanes a query: a quad for lo, a quad for hi
constexpr int kPairLanes = 60;   // int32 lanes per pair-table row
constexpr int kPlanePiece = 9;   // pair row: plane p is 16 B piece kPlanePiece + p
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

// This lane's place in its query group: quad lane j (0..3), whether its
// quad holds hi (else lo), and the group's index.
struct Lane {
  int j;
  bool upper;
  int64_t group;
};

__device__ __forceinline__ Lane lane_of() {
  const int g = threadIdx.x & (kGroup - 1);
  return {g & 3, (g & 4) != 0, ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kGroup};
}

// Query q's k-mer row, its steps (t < end are active) and this quad's seed
// bound: lo or hi of its last cache_k symbols off the prefix cache (its
// code: the symbols' base-6 digits, most significant first), or 0 / n. A
// query past the end of the batch has no steps.
__device__ __forceinline__ const uint8_t* seed(const QueryArgs& a, bool upper, int64_t q,
                                               int& end, int& bound) {
  end = 0;
  bound = 0;
  if (q >= a.B) return a.kmers;
  const uint8_t* km = a.kmers + q * a.K;
  end = min(__ldg(a.lengths + q), a.K);
  bound = upper ? a.n : 0;
  if (a.cache_k > 0) {
    int64_t code = 0;
    for (int c = a.K - a.cache_k; c < a.K; ++c) code = code * kSyms + km[c];
    bound = __ldg((upper ? a.cache_hi : a.cache_lo) + code);
  }
  return km;
}

// A read-only 16 B row piece, through L1 (kL1) or allocating no L1 line,
// so that the k-mer bytes each step reads stay there.
template <bool kL1>
__device__ __forceinline__ int4 row_piece(const int4* p) {
  if constexpr (kL1) {
    return __ldg(p);
  } else {
    int4 v;
    asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
  }
}

__device__ __forceinline__ uint4 and4(const uint4& a, const uint4& b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// The kept forms (the others timed: PERF.md §6, forms tried): two
// interleaved queries a group whose row loads go through L1 for the packed
// tier (at least one block an SM: ptxas keeps 56 registers and issues both
// queries' loads ahead of the shuffles), one query a group whose row loads
// allocate no L1 line for the pair tier (eight blocks an SM: 32 registers,
// 256 queries in flight an SM).
constexpr int kPackedQueries = 2;
constexpr bool kPackedL1 = true;
constexpr int kPairQueries = 1;
constexpr bool kPairL1 = false;

// kPackedQueries queries a group, interleaved: every row load of a step is
// issued before any is used. The groups of a warp step together until the
// warp's longest query is done (a lane past its query's end loads nothing).
__global__ void __launch_bounds__(kThreads, 1) kmer_ranges_packed_kernel(const QueryArgs a) {
  __shared__ int s_starts[kStarts];
  if (threadIdx.x < kStarts) s_starts[threadIdx.x] = a.starts[threadIdx.x];
  __syncthreads();
  const Lane l = lane_of();
  int end[kPackedQueries], bound[kPackedQueries];
  const uint8_t* km[kPackedQueries];
  int last = 0;
#pragma unroll
  for (int k = 0; k < kPackedQueries; ++k) {
    km[k] = seed(a, l.upper, l.group * kPackedQueries + k, end[k], bound[k]);
    last = max(last, end[k]);
  }
  // lane 0 of a quad loads the occurrence piece of the symbol, lanes 1..3
  // plane j - 1
  const unsigned plane = max(l.j - 1, 0);
  for (int t = a.cache_k; __any_sync(kFull, t < last); ++t) {
    int s[kPackedQueries];
    int4 v[kPackedQueries];
#pragma unroll
    for (int k = 0; k < kPackedQueries; ++k) {
      const bool act = t < end[k];
      s[k] = act ? km[k][a.K - 1 - t] : 0;
      v[k] = make_int4(0, 0, 0, 0);
      if (act) {
        const int4* row =
            reinterpret_cast<const int4*>(a.table + (int64_t)(bound[k] >> kBinShift) * kRow);
        v[k] = row_piece<kPackedL1>(row + (l.j == 0 ? s[k] >> 2 : kPackedPlane + plane));
      }
    }
#pragma unroll
    for (int k = 0; k < kPackedQueries; ++k) {
      const uint4 x = l.j == 0 ? ones4() : plane_match(v[k], 0u - ((s[k] >> plane) & 1u));
      const int c = quad_rank(x, l.j == 0 ? lane_of4(v[k], s[k] & 3) : 0,
                              bound[k] & kBinMask, l.j);
      if (t < end[k]) bound[k] = s_starts[s[k]] + c;
    }
  }
#pragma unroll
  for (int k = 0; k < kPackedQueries; ++k) {
    const int64_t q = l.group * kPackedQueries + k;
    if (q < a.B && l.j == 0) (l.upper ? a.out1 : a.out0)[q] = bound[k];
  }
}

__global__ void __launch_bounds__(kThreads, 8) kmer_counts_pair_kernel(const QueryArgs a) {
  __shared__ int s_starts[kStarts];
  __shared__ int s_d[kPairs];  // C[s1] + D[s1][s2] at s1 * 6 + s2
  if (threadIdx.x < kStarts) s_starts[threadIdx.x] = a.starts[threadIdx.x];
  if (threadIdx.x < kPairs)
    s_d[threadIdx.x] = a.starts[threadIdx.x / kSyms] + a.dmat[threadIdx.x];
  __syncthreads();
  const Lane l = lane_of();
  int end[kPairQueries], bound[kPairQueries];
  int other[kPairQueries];  // the group's other bound
  const uint8_t* km[kPairQueries];
#pragma unroll
  for (int k = 0; k < kPairQueries; ++k) {
    km[k] = seed(a, l.upper, l.group * kPairQueries + k, end[k], bound[k]);
    other[k] = __shfl_xor_sync(kFull, bound[k], 4);
  }
  for (int t = a.cache_k;; t += 2) {
    bool act[kPairQueries], two[kPairQueries];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kPairQueries; ++k) {
      act[k] = t < end[k] && bound[k] != other[k];
      two[k] = t + 1 < end[k];  // two symbols left: s2, then s1
      any |= act[k];
    }
    if (!__any_sync(kFull, any)) break;
    int code[kPairQueries], occ_lane[kPairQueries];
    int4 va[kPairQueries], vb[kPairQueries];
#pragma unroll
    for (int k = 0; k < kPairQueries; ++k) {
      const int s2 = act[k] ? km[k][a.K - 1 - t] : 0;
      const int s1 = act[k] && two[k] ? km[k][a.K - 2 - t] : 0;
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
        va[k] = row_piece<kPairL1>(row + piece_a);
        if (two[k] ? l.j < 3 : l.j == 3) vb[k] = row_piece<kPairL1>(row + piece_b);
      }
    }
#pragma unroll
    for (int k = 0; k < kPairQueries; ++k) {
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
      }
      other[k] = __shfl_xor_sync(kFull, bound[k], 4);
    }
  }
#pragma unroll
  for (int k = 0; k < kPairQueries; ++k) {
    const int64_t q = l.group * kPairQueries + k;
    if (q < a.B && l.j == 0 && !l.upper) a.out0[q] = other[k] - bound[k];
  }
}

// One group for each q queries, kThreads lanes a block.
template <void (*Kernel)(QueryArgs)>
int launch(const QueryArgs& a, int q, void* stream) {
  if (a.B > 0) {
    const int64_t groups = (a.B + q - 1) / q;
    const unsigned blocks = (unsigned)((groups * kGroup + kThreads - 1) / kThreads);
    Kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
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
  return launch<kmer_ranges_packed_kernel>(a, kPackedQueries, stream);
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
  return launch<kmer_counts_pair_kernel>(a, kPairQueries, stream);
}

}  // extern "C"
