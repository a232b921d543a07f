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
// rank_at reads 96 B of the row, sectors 0-2 (lanes 0..7 and 8..19), as
// five 16 B loads whose addresses depend on the position alone, so a caller
// can issue them together with a symbol load; the occurrence lane of the
// symbol is picked in registers. The in-bin count is ~(w ^ -bit_p(f))
// ANDed over the three planes, masked to the positions below pos % 128, one
// __popc a word.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBinShift = 7;           // 128 symbols per bin (one table row)
constexpr int kBinMask = (1 << kBinShift) - 1;
constexpr int kRow = 32;               // int32 lanes per packed table row
constexpr int kSyms = 6;               // alphabet $ A C G N T
constexpr int kStarts = kSyms + 1;
constexpr unsigned kFull = 0xffffffffu;

// Bits of plane-match word w below in-bin position r (0..128: r = 128 is a
// full word at every w).
__device__ __forceinline__ int below(unsigned match, int r, int w) {
  const int sh = r - 32 * w;
  const unsigned mask = sh <= 0 ? 0u : sh >= 32 ? kFull : (1u << sh) - 1u;
  return __popc(match & mask);
}

// Occurrences of symbol f (0..5) in bwt[0:pos], off the packed row of pos.
__device__ __forceinline__ int rank_at(const int32_t* __restrict__ table, int f, int pos) {
  const int4* row = reinterpret_cast<const int4*>(table + (int64_t)(pos >> kBinShift) * kRow);
  const int4 o0 = __ldg(row);      // lanes 0..3
  const int4 o1 = __ldg(row + 1);  // lanes 4..7
  const int4 p0 = __ldg(row + 2);  // plane 0, words 0..3
  const int4 p1 = __ldg(row + 3);  // plane 1
  const int4 p2 = __ldg(row + 4);  // plane 2
  const int occ = f == 0 ? o0.x : f == 1 ? o0.y : f == 2 ? o0.z : f == 3 ? o0.w
                : f == 4 ? o1.x : o1.y;
  const unsigned s0 = 0u - (unsigned)(f & 1);
  const unsigned s1 = 0u - (unsigned)((f >> 1) & 1);
  const unsigned s2 = 0u - (unsigned)((f >> 2) & 1);
  const int r = pos & kBinMask;
#define MATCH(c) (~((unsigned)p0.c ^ s0) & ~((unsigned)p1.c ^ s1) & ~((unsigned)p2.c ^ s2))
  return occ + below(MATCH(x), r, 0) + below(MATCH(y), r, 1) + below(MATCH(z), r, 2)
         + below(MATCH(w), r, 3);
#undef MATCH
}

}  // namespace
