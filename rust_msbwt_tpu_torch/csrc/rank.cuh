// The rank over the packed rank table, shared by lf.cu (the BCR stage step
// and the LF walks) and query.cu (the packed tier's k-mer search): one rank,
// one place.
//
// Table layout (PackedOccIndex, as merge_insert.cu writes it): one 32-lane
// int32 row per 128-symbol bin; lanes 0..5 count each symbol strictly
// before the bin, lanes 8+4p+w hold bit plane p of word w (bit k = plane-p
// bit of bin position 32w+k), other lanes 0; a terminal row (totals,
// planes 0) serves a rank at pos == n when n % 128 == 0. Positions past n
// are PAD (7), which no symbol 0..5 matches.
//
// Two ways to read a row. rank_at (one thread): five 16 B loads of the row
// (sectors 0-2, 96 B) whose addresses depend on the position alone, the
// occurrence lane of the symbol picked in registers, and row_rank's count.
// A quad (four lanes of a warp) instead loads whole 16 B pieces of one row,
// a piece a lane, so that one warp-wide load reads eight rows; quad_rank
// ANDs and counts its lanes' plane-match words. The in-bin count is
// ~(w ^ -bit_p(f)) ANDed over the three planes, masked to the positions
// below pos % 128, one __popc a word.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBinShift = 7;           // 128 symbols per bin (one table row)
constexpr int kBinMask = (1 << kBinShift) - 1;
constexpr int kRow = 32;               // int32 lanes per packed table row
constexpr int kSyms = 6;               // alphabet $ A C G N T
constexpr int kStarts = kSyms + 1;
constexpr int kPackedPlane = 2;        // packed row: plane p is 16 B piece 2 + p
constexpr unsigned kFull = 0xffffffffu;

// Bits of plane-match word w below in-bin position r (0..128: r = 128 is a
// full word at every w).
__device__ __forceinline__ int below(unsigned match, int r, int w) {
  const int sh = r - 32 * w;
  const unsigned mask = sh <= 0 ? 0u : sh >= 32 ? kFull : (1u << sh) - 1u;
  return __popc(match & mask);
}

__device__ __forceinline__ int lane_of4(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Occurrences of symbol f (0..5) at in-bin positions below r, plus the
// row's count of f before the bin: the row's occurrence pieces o0 (lanes
// 0..3), o1 (lanes 4..7) and planes p0..p2.
__device__ __forceinline__ int row_rank(const int4& o0, const int4& o1, const int4& p0,
                                        const int4& p1, const int4& p2, int f, int r) {
  const int occ = f < 4 ? lane_of4(o0, f) : f == 4 ? o1.x : o1.y;
  const unsigned s0 = 0u - (unsigned)(f & 1);
  const unsigned s1 = 0u - (unsigned)((f >> 1) & 1);
  const unsigned s2 = 0u - (unsigned)((f >> 2) & 1);
#define MATCH(c) (~((unsigned)p0.c ^ s0) & ~((unsigned)p1.c ^ s1) & ~((unsigned)p2.c ^ s2))
  return occ + below(MATCH(x), r, 0) + below(MATCH(y), r, 1) + below(MATCH(z), r, 2)
         + below(MATCH(w), r, 3);
#undef MATCH
}

// Occurrences of symbol f (0..5) in bwt[0:pos], off the packed row of pos.
__device__ __forceinline__ int rank_at(const int32_t* __restrict__ table, int f, int pos) {
  const int4* row = reinterpret_cast<const int4*>(table + (int64_t)(pos >> kBinShift) * kRow);
  const int4 o0 = __ldg(row);      // lanes 0..3
  const int4 o1 = __ldg(row + 1);  // lanes 4..7
  const int4 p0 = __ldg(row + 2);  // plane 0, words 0..3
  const int4 p1 = __ldg(row + 3);  // plane 1
  const int4 p2 = __ldg(row + 4);  // plane 2
  return row_rank(o0, o1, p0, p1, p2, f, pos & kBinMask);
}

__device__ __forceinline__ uint4 ones4() { return make_uint4(kFull, kFull, kFull, kFull); }

// ~(v ^ sp) a word: the positions whose plane bit is the bit sp (0 or all
// ones) stands for.
__device__ __forceinline__ uint4 plane_match(const int4& v, unsigned sp) {
  return make_uint4(~((unsigned)v.x ^ sp), ~((unsigned)v.y ^ sp), ~((unsigned)v.z ^ sp),
                    ~((unsigned)v.w ^ sp));
}

// The quad's rank: its four lanes' match words x ANDed over the quad and
// counted below in-bin offset r, plus every lane's occ. Transposed: after
// the xor-1 exchange lane j holds words 2(j & 1) + {0, 1}, after the xor-2
// exchange word 2(j & 1) + (j >> 1), so each lane counts one word and the
// quad sums four counts. Every lane of the warp calls it.
__device__ __forceinline__ int quad_rank(const uint4& x, int occ, int r, int j) {
  const bool odd = j & 1;
  const unsigned a0 = (odd ? x.z : x.x) & __shfl_xor_sync(kFull, odd ? x.x : x.z, 1);
  const unsigned a1 = (odd ? x.w : x.y) & __shfl_xor_sync(kFull, odd ? x.y : x.w, 1);
  const bool two = j & 2;
  const unsigned m = (two ? a1 : a0) & __shfl_xor_sync(kFull, two ? a0 : a1, 2);
  int c = occ + below(m, r, ((j & 1) << 1) | (j >> 1));
  c += __shfl_xor_sync(kFull, c, 1);
  return c + __shfl_xor_sync(kFull, c, 2);
}

}  // namespace
