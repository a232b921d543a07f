// BCR merge-insert pass with the fused packed rank table, for Hopper (sm_90a).
//
// Replaces the TPU kernel rust_msbwt_tpu/ops/pallas_merge.py::_merge_kernel
// (launched by _merge_call, with its insert and shift maps made by
// merge_insert_phys before it). One pass over a logical buffer of n symbols
// merges N inserts given as slots:
//
//   new[p] = v[i]                         where p == q[i] for an active i
//          = old[p - #{active q <= p}]    elsewhere
//
// (active slots distinct and < n; inactive inserts are ignored, whatever
// their q) and writes the rank table of the merged buffer in the
// PackedOccIndex layout, one 32-lane int32 row per 128-symbol bin:
//
//   lanes 0..5     occurrences of each symbol strictly before the bin
//   lanes 8+4q+j   bit plane q word j: bit k = plane-q bit of position 32j+k
//   other lanes    0;  row NB (terminal) = totals, planes 0.
//
// Positions p >= n read as PAD (7): they count for no symbol and set every
// plane bit, exactly as the padded tail of a PackedOccIndex does.
//
// What bounds it: memory traffic. The pass must read old (n B) and the
// inserts (q, v, active: 6 B each) and write new (n B) and the table (128 B
// per 128-symbol bin: n B), 3n + 6N bytes with no arithmetic to speak of.
// The TPU form (and this kernel's first port) read two n-sized maps made
// by torch ops just before, an int8 insert map and an int32 shift map, and
// streamed one byte a lane: ~8 B per position plus the maps' own ~8 B.
// This design ("Form 2") moves only the bound's bytes:
//   * the inserts are bucketed by output tile (kTile positions) in O(N) +
//     O(tiles) work with no random global access per insert (a two-level
//     partition), and each tile's block builds its insert byte map in
//     shared memory and block-scans its insert counts: no insert map and
//     no shift map in device memory;
//   * old's window for a tile is contiguous, so it is staged in shared
//     memory with 16 B loads; each thread owns 4 groups of 16 consecutive
//     positions, the tile's groups tid + 256 g, reads each group's sources
//     as one unaligned 16 B span of the window, splices in the group's
//     inserts (only where there are any) and stores the 16 merged symbols
//     with one 16 B store, consecutive threads on consecutive words;
//   * bit planes come from a multiply that gathers one bit of each byte,
//     bin counts from popcounts, and each table row is written once, as
//     eight 16 B stores (its planes as soon as its slice is merged, its
//     counts once the tile's prefix is known);
//   * the global occurrence prefix is a single-pass decoupled look-back:
//     tiles take tickets in launch order and publish their sums (aggregate,
//     then inclusive prefix) in one 64-bit word per symbol, and warp 0 reads
//     32 earlier tiles at a time, so no second pass over the table is needed.
// What still holds it back (measured in PERF.md): it runs at about 40% of
// its byte bound. The look-back's waits are small; the stores of new and
// of the table rows cost far more than their bytes at the memory rate, and
// each tile is a chain of dependent steps (offsets, then the window and
// bucket loads, barriers) with five blocks per SM to overlap them. Measured
// slower: a persistent variant that staged the next tile's window with
// cp.async, wider look-back windows, and other tile shapes and occupancies.
// The bucketing kernels take about a fifth of the merge time.
//
// Launches (all on the caller's stream; the caller gives the scratch):
//   memset              superbucket counts and cursors, tile offsets,
//                       look-back states, ticket, m
//   count_superbuckets  (N > 0) per block of 4096 inserts, a shared-memory
//                       histogram by superbucket (64 tiles), added to global
//   scan_superbuckets   (N > 0) one block: superbucket offsets; m = the total
//   place_superbuckets  (N > 0) each block's inserts into one run per
//                       superbucket (one global atomic a run)
//   sort_tiles          (N > 0) one block per superbucket: its inserts by
//                       tile, as (slot - tile start) << 3 | v, and the tile
//                       offsets
//   merge_tiles         one block per tile: new, its table rows, the
//                       terminal row

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kBin = 128;              // symbols per bin (one table row)
constexpr int kRow = 32;               // int32 lanes per table row
constexpr int kTileShift = 14;
constexpr int kTile = 1 << kTileShift; // positions per tile (128 bins)
constexpr int kSbShift = 20;           // superbucket: the inserts of 64 tiles
constexpr int kSbSpan = 1 << kSbShift;
constexpr int kSbTiles = kSbSpan / kTile;
constexpr int kMaxSb = 2048;           // superbuckets of n < 2^31
static_assert(kSbTiles == 64, "sort_tiles scans 64 tile counts with one warp");
static_assert(kMaxSb % 256 == 0 && kMaxSb <= 65536, "superbucket ids fit 16 bits");
constexpr int kChunkIns = 4096;        // inserts per block of the partition
constexpr int kPer = 16;               // positions per group (one 16 B word)
constexpr int kWin = kTile + 32;       // staged window: alignment + over-read slack
constexpr int kScanThreads = 1024;
static_assert(kMaxSb % kScanThreads == 0, "scan_superbuckets: whole groups a thread");
constexpr int kFlatThreads = 256;      // the bucketing kernels
constexpr int kSortThreads = 1024;     // sort_tiles
constexpr int kSortBatch = 8;          // entries a sort_tiles thread loads at once
constexpr int kStateStride = 8;        // u64 look-back words per tile (6 used)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;        // merge_tiles' carveout: one flag a device
constexpr unsigned long long kAggregate = 1ull << 32;  // flag: the tile's own sum
constexpr unsigned long long kInclusive = 2ull << 32;  // flag: prefix through the tile

// Scratch layout, in int32 words. Everything before `stage` is zeroed by
// the launcher; `state` starts on an 8 B boundary.
struct Layout {
  int64_t m = 0, ticket = 1, sb = 4, sb_cur, off, state, stage, bucket, total;
  Layout(int64_t n_tiles, int64_t n_sb, int64_t n_ins) {
    sb_cur = sb + ((n_sb + 4) & ~int64_t(3));      // sb: [n_sb + 1]
    off = sb_cur + ((n_sb + 3) & ~int64_t(3));     // sb_cur: [n_sb]
    state = off + ((n_tiles + 2) & ~int64_t(1));   // off: [n_tiles + 1]
    stage = state + 2 * kStateStride * n_tiles;    // state: u64 [n_tiles * 8]
    bucket = stage + n_ins;                        // stage: [n_ins]
    total = bucket + n_ins;                        // bucket: [n_ins]
  }
};

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }
int64_t superbuckets_of(int64_t n) { return (n + kSbSpan - 1) / kSbSpan; }

// 16 bytes of old at the 16 B-aligned offset `at`; bytes at or past n read 0.
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ old, int64_t at,
                                            int64_t n) {
  if (at + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(old + at));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (at + j < n) w[j >> 2] |= (uint32_t)old[at + j] << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bit k = bit 0 of byte k of w (k < 4): a multiply gathers the four bits.
__device__ __forceinline__ unsigned gather4(uint32_t w) {
  return ((w & 0x01010101u) * 0x01020408u) >> 24;
}

// Bit j = bit p of byte j of the 16 bytes w[0..3].
__device__ __forceinline__ unsigned byte_bits(const uint32_t w[4], int p) {
  return gather4(w[0] >> p) | gather4(w[1] >> p) << 4 | gather4(w[2] >> p) << 8 |
         gather4(w[3] >> p) << 12;
}

// w with byte `val` put at byte k/8 and the bytes from there moved up one
// place (the top byte falls off).
__device__ __forceinline__ uint64_t splice(uint64_t w, int k, uint64_t val) {
  const uint64_t keep = (1ull << k) - 1;  // bytes below stay
  return (w & keep) | ((w << 8) & ~(keep | 0xffull << k)) | (val << k);
}

// Insert byte `val` at byte j of the 128-bit (hi:lo).
__device__ __forceinline__ void insert_byte(uint64_t& lo, uint64_t& hi, int j,
                                            uint64_t val) {
  if (j < 8) {
    hi = (hi << 8) | (lo >> 56);
    lo = splice(lo, 8 * j, val);
  } else {
    hi = splice(hi, 8 * (j - 8), val);
  }
}

// The inserts are bucketed by tile in two levels, so that no step makes
// one random global access per insert: (1) a block-local histogram of a
// chunk of inserts by superbucket (kSbTiles tiles), added to global counts;
// (2) those counts scanned; (3) each chunk's inserts placed into their
// superbucket's range, each block taking one run per superbucket with one
// atomic; (4) one block per superbucket sorts its inserts by tile and
// writes the tile offsets.

constexpr int kInsPerThread = kChunkIns / kFlatThreads;
constexpr int kBinsPerThread = kMaxSb / kFlatThreads;

// The block's chunk of inserts, kInsPerThread a thread (strided, so loads
// coalesce), all loaded before any is used: each insert's superbucket (-1
// when it is not kept: inactive inserts never reach a tile) and its entry
// (slot - superbucket start) << 3 | v.
__device__ __forceinline__ void load_inserts(const int32_t* __restrict__ q,
                                             const uint8_t* __restrict__ v,
                                             const uint8_t* __restrict__ active,
                                             int64_t n_ins, int64_t n,
                                             int sb[kInsPerThread],
                                             int32_t entry[kInsPerThread]) {
  const int64_t i0 = (int64_t)blockIdx.x * kChunkIns + threadIdx.x;
  int32_t p[kInsPerThread];
  uint8_t on[kInsPerThread], sym[kInsPerThread];
#pragma unroll
  for (int k = 0; k < kInsPerThread; ++k) {
    const int64_t i = i0 + k * kFlatThreads;
    const bool in = i < n_ins;
    p[k] = in ? q[i] : -1;
    on[k] = in ? active[i] : 0;
    sym[k] = in && v ? v[i] : 0;
  }
#pragma unroll
  for (int k = 0; k < kInsPerThread; ++k) {
    const bool keep = on[k] && p[k] >= 0 && p[k] < n;
    sb[k] = keep ? p[k] >> kSbShift : -1;
    entry[k] = ((p[k] & (kSbSpan - 1)) << 3) | (sym[k] & 7);
  }
}

__global__ void __launch_bounds__(kFlatThreads)
count_superbuckets(const int32_t* __restrict__ q, const uint8_t* __restrict__ active,
                   int64_t n_ins, int64_t n, int n_sb, int32_t* __restrict__ counts) {
  __shared__ int hist[kMaxSb];
  for (int i = threadIdx.x; i < n_sb; i += kFlatThreads) hist[i] = 0;
  int sb[kInsPerThread];
  int32_t entry[kInsPerThread];
  load_inserts(q, nullptr, active, n_ins, n, sb, entry);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kInsPerThread; ++k)
    if (sb[k] >= 0) atomicAdd(&hist[sb[k]], 1);
  __syncthreads();
  for (int i = threadIdx.x; i < n_sb; i += kFlatThreads)
    if (hist[i]) atomicAdd(&counts[i], hist[i]);
}

// One block: the superbucket counts (n_sb <= kMaxSb) scanned in place into
// offsets, with the cursors and the total (sb[n_sb] and m).
__global__ void __launch_bounds__(kScanThreads)
scan_superbuckets(int32_t* __restrict__ sb, int32_t* __restrict__ cur,
                  int32_t* __restrict__ m, int n_sb) {
  constexpr int kGroup = kMaxSb / kScanThreads;  // consecutive counts a thread
  const int t = kGroup * threadIdx.x;
  int x[kGroup], v[1] = {0}, total[1];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    x[k] = t + k < n_sb ? sb[t + k] : 0;
    v[0] += x[k];
  }
  block_exclusive_scan<kScanThreads, 1>(v, total);
  int run = v[0];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    if (t + k < n_sb) {
      sb[t + k] = run;
      cur[t + k] = run;
    }
    run += x[k];
  }
  if (threadIdx.x == 0) {
    sb[n_sb] = total[0];
    *m = total[0];
  }
}

__global__ void __launch_bounds__(kFlatThreads)
place_superbuckets(const int32_t* __restrict__ q, const uint8_t* __restrict__ v,
                   const uint8_t* __restrict__ active, int64_t n_ins, int64_t n, int n_sb,
                   int32_t* __restrict__ cur, int32_t* __restrict__ stage) {
  // the block's inserts are sorted by superbucket in shared memory first,
  // so that each superbucket's run goes out as consecutive words
  __shared__ int slot[kMaxSb];     // counts, then the next local slot
  __shared__ int delta[kMaxSb];    // global run start - local run start
  __shared__ int32_t sorted[kChunkIns];
  __shared__ uint16_t sorted_sb[kChunkIns];
  const int tid = threadIdx.x;
  for (int i = tid; i < n_sb; i += kFlatThreads) slot[i] = 0;
  int sb[kInsPerThread];
  int32_t entry[kInsPerThread];
  load_inserts(q, v, active, n_ins, n, sb, entry);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kInsPerThread; ++k)
    if (sb[k] >= 0) atomicAdd(&slot[sb[k]], 1);
  __syncthreads();
  // this thread's kBinsPerThread bins: local run starts, and one global
  // atomic a non-empty bin for the block's run, all in flight together
  int c[kBinsPerThread], start[kBinsPerThread], got[kBinsPerThread];
  int local[1] = {0}, kept_total[1];
#pragma unroll
  for (int k = 0; k < kBinsPerThread; ++k) {
    const int b = kBinsPerThread * tid + k;
    c[k] = b < n_sb ? slot[b] : 0;
    local[0] += c[k];
  }
  block_exclusive_scan<kFlatThreads, 1>(local, kept_total);
#pragma unroll
  for (int k = 0; k < kBinsPerThread; ++k) {
    const int b = kBinsPerThread * tid + k;
    start[k] = local[0];
    local[0] += c[k];
    got[k] = c[k] ? atomicAdd(&cur[b], c[k]) : 0;
  }
#pragma unroll
  for (int k = 0; k < kBinsPerThread; ++k) {
    const int b = kBinsPerThread * tid + k;
    if (c[k]) {
      delta[b] = got[k] - start[k];
      slot[b] = start[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kInsPerThread; ++k) {
    if (sb[k] < 0) continue;
    const int r = atomicAdd(&slot[sb[k]], 1);
    sorted[r] = entry[k];
    sorted_sb[r] = (uint16_t)sb[k];
  }
  __syncthreads();
  for (int r = tid; r < kept_total[0]; r += kFlatThreads)
    stage[delta[sorted_sb[r]] + r] = sorted[r];
}

// One block per superbucket: its inserts sorted by tile into `bucket` as
// (slot - tile start) << 3 | v, and its tiles' offsets.
__global__ void __launch_bounds__(kSortThreads)
sort_tiles(const int32_t* __restrict__ sb_off, const int32_t* __restrict__ stage,
           int32_t* __restrict__ bucket, int32_t* __restrict__ off, int64_t n_tiles,
           int n_sb) {
  __shared__ int cnt[kSbTiles];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int e0 = sb_off[b], e1 = sb_off[b + 1];
  if (tid < kSbTiles) cnt[tid] = 0;
  __syncthreads();
  for (int e = e0 + tid; e < e1; e += kSortThreads * kSortBatch) {
    int32_t x[kSortBatch];  // loads in flight together
#pragma unroll
    for (int k = 0; k < kSortBatch; ++k)
      x[k] = e + k * kSortThreads < e1 ? stage[e + k * kSortThreads] : -1;
#pragma unroll
    for (int k = 0; k < kSortBatch; ++k)
      if (x[k] >= 0) atomicAdd(&cnt[x[k] >> (kTileShift + 3)], 1);
  }
  __syncthreads();
  if (tid < 32) {  // exclusive scan of the kSbTiles counts, two a lane
    const int x0 = cnt[2 * tid], x1 = cnt[2 * tid + 1];
    int incl = x0 + x1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (tid >= o) incl += y;
    }
    const int ex0 = e0 + incl - x0 - x1;
    cnt[2 * tid] = ex0;
    cnt[2 * tid + 1] = ex0 + x0;
    const int64_t t = (int64_t)b * kSbTiles + 2 * tid;
    if (t < n_tiles) off[t] = ex0;
    if (t + 1 < n_tiles) off[t + 1] = ex0 + x0;
  }
  if (b == n_sb - 1 && tid == 0) off[n_tiles] = e1;
  __syncthreads();
  for (int e = e0 + tid; e < e1; e += kSortThreads * kSortBatch) {
    int32_t x[kSortBatch];
#pragma unroll
    for (int k = 0; k < kSortBatch; ++k)
      x[k] = e + k * kSortThreads < e1 ? stage[e + k * kSortThreads] : -1;
#pragma unroll
    for (int k = 0; k < kSortBatch; ++k)
      if (x[k] >= 0)
        bucket[atomicAdd(&cnt[x[k] >> (kTileShift + 3)], 1)] = x[k] & ((kTile << 3) - 1);
  }
}

constexpr int kSub = 4;                  // 16-position groups per thread
constexpr int kThreads = kTile / (kPer * kSub);  // 256 threads per block (one tile)
constexpr int kMinBlocks = 5;            // blocks per SM: 5 x 33 KB of shared memory
static_assert(kThreads % 8 == 0, "eight threads a bin in each slice");

// One block per tile. The look-back waits only on lower tiles, which were
// taken first: tiles are taken in ticket order, so every tile waited on
// belongs to a block that is running.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
merge_tiles(const uint8_t* __restrict__ old, const int32_t* __restrict__ off,
            const int32_t* __restrict__ bucket, uint8_t* __restrict__ out,
            int32_t* __restrict__ table, unsigned long long* __restrict__ state,
            int32_t* __restrict__ ticket, int64_t n, int64_t nb, int64_t n_tiles) {
  __shared__ __align__(16) uint8_t imap[kTile];  // v+1 at insert slots, else 0
  __shared__ __align__(16) uint8_t win[kWin];    // old's window, from a 16 B boundary
  __shared__ int s_tile;
  __shared__ int s_prefix[6];
  __shared__ int slice_sums[kSub][kThreads / 32][3];
  __shared__ int s_bins[kTile / kBin][3];  // each bin's counts before it in the tile
  uint4* const imap4 = reinterpret_cast<uint4*>(imap);
  uint4* const win4 = reinterpret_cast<uint4*>(win);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t ts = tile * kTile;
  const int64_t te = ts + kTile < n ? ts + kTile : n;
  const int64_t a0 = off[tile], a1 = off[tile + 1];  // inserts before / through the tile

  // old's window [w0, w1): the sources of the tile's non-insert positions
  const int64_t w0 = ts - a0;
  const int64_t lo_src = w0 > 0 ? w0 : 0;  // clamps only on invalid input
  int64_t w1 = te - a1;
  w1 = w1 < lo_src ? lo_src : (w1 > n ? n : w1);
  const int64_t wa = lo_src & ~int64_t(15);
  const int n_chunks = (int)((w1 - wa + 15) >> 4);  // <= kTile / 16 + 1

  // the window's chunks and the first insert in flight together
  uint4 chunk[kSub];
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    const int c = tid + k * kThreads;
    chunk[k] = c < n_chunks ? load_chunk(old, wa + 16 * c, n) : make_uint4(0, 0, 0, 0);
  }
  const int32_t b_first = a0 + tid < a1 ? bucket[a0 + tid] : -1;
  if (tid == 0 && n_chunks > kTile / 16)
    win4[kTile / 16] = load_chunk(old, wa + kTile, n);
#pragma unroll
  for (int k = 0; k < kSub; ++k) imap4[tid + k * kThreads] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (b_first >= 0) imap[b_first >> 3] = (uint8_t)((b_first & 7) + 1);
  for (int64_t i = a0 + tid + kThreads; i < a1; i += kThreads) {
    const int32_t b = bucket[i];
    imap[b >> 3] = (uint8_t)((b & 7) + 1);
  }
#pragma unroll
  for (int k = 0; k < kSub; ++k)
    if (tid + k * kThreads < n_chunks) win4[tid + k * kThreads] = chunk[k];
  __syncthreads();

  // this thread's groups of 16 positions: group g is the tile's group
  // tid + kThreads * g, so each store instruction of the block writes
  // consecutive 16 B words. Insert masks, then the inserts before each group
  unsigned mask[kSub];
  int ins[kSub], ins_tot[kSub];
#pragma unroll
  for (int g = 0; g < kSub; ++g) {
    const uint4 im = imap4[tid + kThreads * g];
    mask[g] = gather4(__vcmpne4(im.x, 0)) | gather4(__vcmpne4(im.y, 0)) << 4 |
              gather4(__vcmpne4(im.z, 0)) << 8 | gather4(__vcmpne4(im.w, 0)) << 12;
    ins[g] = __popc(mask[g]);
  }
  block_exclusive_scan<kThreads, kSub>(ins, ins_tot);

  // group g's sources are one contiguous span of the window,
  // old[w0 + 16*(tid + kThreads*g) - (inserts before the group) ...]: read
  // it as 16 bytes, then splice in the group's inserts, lowest first
  int ins_before = 0;        // inserts in the slices g' < g
  int agg[3] = {0, 0, 0};    // the tile's counts in the slices g' < g
  const int r = tid & 7;
  const int lead = lane & ~7;
#pragma unroll
  for (int g = 0; g < kSub; ++g) {
    const int group = tid + kThreads * g;
    int span = (int)(w0 - wa) + kPer * group - ins_before - ins[g];
    ins_before += ins_tot[g];
    span = span < 0 ? 0 : (span > kWin - 20 ? kWin - 20 : span);
    const uint32_t* ww = reinterpret_cast<const uint32_t*>(win) + (span >> 2);
    const int sh = 8 * (span & 3);
    const uint32_t r0 = ww[0], r1 = ww[1], r2 = ww[2], r3 = ww[3], r4 = ww[4];
    uint64_t lo = (uint64_t)__funnelshift_r(r0, r1, sh) |
                  ((uint64_t)__funnelshift_r(r1, r2, sh) << 32);
    uint64_t hi = (uint64_t)__funnelshift_r(r2, r3, sh) |
                  ((uint64_t)__funnelshift_r(r3, r4, sh) << 32);
    if (mask[g]) {
      const uint4 im = imap4[group];
      const uint64_t im_lo = im.x | (uint64_t)im.y << 32, im_hi = im.z | (uint64_t)im.w << 32;
      for (unsigned mm = mask[g]; mm; mm &= mm - 1) {
        const int j = __ffs(mm) - 1;
        const uint64_t v1 = ((j < 8 ? im_lo : im_hi) >> (8 * (j & 7))) & 0xff;
        insert_byte(lo, hi, j, v1 - 1);
      }
    }
    const int64_t p0 = ts + kPer * group;
    if (p0 + kPer > n) {  // the ragged end: PAD (7) from n on
      const int nv = n > p0 ? (int)(n - p0) : 0;  // < 16
      const uint64_t lo_pad = nv >= 8 ? 0 : ~0ull << (8 * nv);
      const uint64_t hi_pad = nv >= 8 ? ~0ull << (8 * (nv - 8)) : ~0ull;
      constexpr uint64_t kPad8 = 0x0707070707070707ull;
      lo = (lo & ~lo_pad) | (kPad8 & lo_pad);
      hi = (hi & ~hi_pad) | (kPad8 & hi_pad);
    }
    const uint32_t o[4] = {(uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
                           (uint32_t)(hi >> 32)};
    if (p0 + kPer <= n) {
      *reinterpret_cast<uint4*>(out + p0) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      for (int j = 0; j < kPer; ++j)
        if (p0 + j < n) out[p0 + j] = (uint8_t)(o[j >> 2] >> (8 * (j & 3)));
    }
    const unsigned pl0 = byte_bits(o, 0), pl1 = byte_bits(o, 1), pl2 = byte_bits(o, 2);

    // the slice's rows: thread tid writes 16 B group r = tid % 8 of the row
    // of bin kThreads/8 * g + tid/8 (consecutive threads, consecutive
    // words); even threads hold a 32-bit plane word with their neighbour
    const int64_t bin = tile * (kTile / kBin) + (kThreads / 8) * g + (tid >> 3);
    const unsigned pl[3] = {pl0, pl1, pl2};
    int rv[4] = {0, 0, 0, 0};
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const unsigned word = pl[p] | (__shfl_xor_sync(kFull, pl[p], 1) << 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned w = __shfl_sync(kFull, word, lead + 2 * j);
        if (r == 2 + p) rv[j] = (int)w;
      }
    }
    if (r >= 2 && bin < nb)
      reinterpret_cast<int4*>(table + bin * kRow)[r] = make_int4(rv[0], rv[1], rv[2], rv[3]);

    // the group's counts, two symbols to an int, scanned across the slice;
    // the bin's first thread parks the bin's prefix within the tile
    int cnt[3], slice_tot[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      int pair = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = 2 * k + h;
        const unsigned eq = ((s & 1) ? pl0 : ~pl0) & ((s & 2) ? pl1 : ~pl1) &
                            ((s & 4) ? pl2 : ~pl2) & 0xffffu;
        pair += __popc(eq) << (16 * h);
      }
      cnt[k] = pair;
    }
    block_exclusive_scan<kThreads, 3>(cnt, slice_tot, slice_sums[g]);
    if (r == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) s_bins[(kThreads / 8) * g + (tid >> 3)][k] = cnt[k] + agg[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) agg[k] += slice_tot[k];  // sums <= kTile: no overflow
  }

  // decoupled look-back by warp 0
  if (tid < 32) {
    int mine = 0;  // lane s < 6: the tile's count of symbol s
#pragma unroll
    for (int s = 0; s < 6; ++s)
      if (lane == s) mine = (agg[s >> 1] >> (16 * (s & 1))) & 0xffff;
    if (lane < 6)
      store_state(state + tile * kStateStride + lane,
                  tile == 0 ? kInclusive : kAggregate, mine);
    int pre = 0;
    // lane i reads tile (end - i)'s six words; symbol s sums the lanes up to
    // its nearest inclusive word, and the window is read again while a tile
    // in that range has not published
    int prefix[6] = {0, 0, 0, 0, 0, 0};
    unsigned todo = tile == 0 ? 0u : 0x3fu;
    int64_t end = tile - 1;
    while (todo) {
      const int64_t j = end - lane;
      unsigned long long w[6];
#pragma unroll
      for (int s = 0; s < 6; ++s)
        w[s] = j >= 0 ? load_state(state + j * kStateStride + s) : kInclusive;
      bool stalled = false;
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        const unsigned incl = __ballot_sync(kFull, (w[s] >> 32) == 2);
        const unsigned zero = __ballot_sync(kFull, (w[s] >> 32) == 0);
        const unsigned upto = incl ? (incl ^ (incl - 1)) : kFull;  // lanes <= first inclusive
        stalled |= (todo >> s & 1) && (zero & upto);
      }
      if (stalled) continue;  // warp-uniform: read the same window again
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        const unsigned incl = __ballot_sync(kFull, (w[s] >> 32) == 2);
        const unsigned upto = incl ? (incl ^ (incl - 1)) : kFull;
        int x = (todo >> s & 1) && (upto >> lane & 1) ? (int)(uint32_t)w[s] : 0;
#pragma unroll
        for (int o2 = 16; o2 > 0; o2 >>= 1) x += __shfl_xor_sync(kFull, x, o2);
        prefix[s] += x;
        if (incl) todo &= ~(1u << s);
      }
      end -= 32;
    }
#pragma unroll
    for (int s = 0; s < 6; ++s)
      if (lane == s) pre = prefix[s];
    if (lane < 6) {
      if (tile > 0)
        store_state(state + tile * kStateStride + lane, kInclusive, pre + mine);
      s_prefix[lane] = pre;
    }
  }
  __syncthreads();

  // the rows' count groups (lanes 0..3, 4..7), two threads a row
  for (int i = tid; i < 2 * (kTile / kBin); i += kThreads) {
    const int b = i >> 1;
    const int64_t bin = tile * (kTile / kBin) + b;
    if (bin >= nb) continue;
    int c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int sym = 4 * (i & 1) + k;
      if (sym < 6) c[k] = ((s_bins[b][sym >> 1] >> (16 * (sym & 1))) & 0xffff) + s_prefix[sym];
    }
    reinterpret_cast<int4*>(table + bin * kRow)[i & 1] = make_int4(c[0], c[1], c[2], c[3]);
  }
  if (tile == n_tiles - 1 && tid < 8) {  // terminal row: the totals
    int tv[4] = {0, 0, 0, 0};
    if (tid < 2) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = 4 * tid + k;
        if (s < 6) tv[k] = s_prefix[s] + ((agg[s >> 1] >> (16 * (s & 1))) & 0xffff);
      }
    }
    reinterpret_cast<int4*>(table + nb * kRow)[tid] = make_int4(tv[0], tv[1], tv[2], tv[3]);
  }
}

}  // namespace

extern "C" {

// Positions per tile (the tests' tile edge cases read it).
int msbwt_merge_tile() { return kTile; }

// Int32 scratch the caller must provide for n positions and n_ins inserts.
int64_t msbwt_merge_insert_scratch_len(int64_t n, int64_t n_ins) {
  return Layout(tiles_of(n), superbuckets_of(n), n_ins).total;
}

// old u8 [n], q i32 [n_ins], v u8 [n_ins], active bool [n_ins]
//   -> out u8 [n], table i32 [nb+1, 32] with nb = ceil(n / 128), and the
//      number of active inserts in scratch[0].
// old, out, table and scratch 16 B-aligned; scratch i32
// [msbwt_merge_insert_scratch_len]. Launches on `stream`; returns
// cudaGetLastError().
int msbwt_merge_insert(const void* old, const void* q, const void* v, const void* active,
                       void* out, void* table, void* scratch, int64_t n, int64_t n_ins,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nb = (n + kBin - 1) / kBin;
  const int64_t n_tiles = tiles_of(n);
  const int n_sb = (int)superbuckets_of(n);
  const Layout L(n_tiles, n_sb, n_ins);
  int32_t* s = (int32_t*)scratch;
  cudaMemsetAsync(s, 0, L.stage * sizeof(int32_t), st);
  if (n_ins > 0 && n_sb > 0) {
    const unsigned chunks = (unsigned)((n_ins + kChunkIns - 1) / kChunkIns);
    count_superbuckets<<<chunks, kFlatThreads, 0, st>>>(
        (const int32_t*)q, (const uint8_t*)active, n_ins, n, n_sb, s + L.sb);
    scan_superbuckets<<<1, kScanThreads, 0, st>>>(s + L.sb, s + L.sb_cur, s + L.m, n_sb);
    place_superbuckets<<<chunks, kFlatThreads, 0, st>>>(
        (const int32_t*)q, (const uint8_t*)v, (const uint8_t*)active, n_ins, n, n_sb,
        s + L.sb_cur, s + L.stage);
    sort_tiles<<<(unsigned)n_sb, kSortThreads, 0, st>>>(s + L.sb, s + L.stage, s + L.bucket,
                                                        s + L.off, n_tiles, n_sb);
  }
  if (n_tiles > 0) {
    // shared memory over L1 (blocks per SM are bound by it), once a device:
    // the attribute is the current device's, which the caller has made the
    // tensors' (a race between two host threads only sets it twice)
    static bool carveout[kMaxDevices] = {};
    int d = 0;
    cudaGetDevice(&d);
    if (d < 0 || d >= kMaxDevices || !carveout[d]) {
      cudaFuncSetAttribute(merge_tiles, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
      if (d >= 0 && d < kMaxDevices) carveout[d] = true;
    }
    merge_tiles<<<(unsigned)n_tiles, kThreads, 0, st>>>(
        (const uint8_t*)old, s + L.off, s + L.bucket, (uint8_t*)out, (int32_t*)table,
        (unsigned long long*)(s + L.state), s + L.ticket, n, nb, n_tiles);
  } else {
    cudaMemsetAsync(table, 0, kRow * sizeof(int32_t), st);  // terminal row only
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
