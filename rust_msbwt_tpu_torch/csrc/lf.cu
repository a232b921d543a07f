// LF steps over the packed rank table, for Hopper (sm_90a): the BCR stage
// step (lf_stage), its radix-2 column pair (lf_pair), the column group
// (lf_group) and the batched LF walks (lf_walk).
//
// The JAX package has no Pallas kernel for these: it runs them as XLA
// fusions inside one compiled program. What they replace there:
//   lf_stage  rust_msbwt_tpu/ops/bcr.py::_pallas_stage_step (:444): the
//             rank _pallas_rank_table (:396), the C array _cvec (:471),
//             the slot, the carry updates and _bump_counts (:434) of one
//             BCR column;
//   lf_pair   bcr.py::_pallas_stage_step2 (:483): two columns for one merge
//             pass, column j + 1's slots from the table before column j's
//             inserts (its argsort, one-hot scan, second rank, sort and
//             searchsorted; the design is at pair_first_kernel below);
//   lf_group  nothing: k > 2 columns for one merge pass, where ragged reads
//             leave few active (ops/bcr.group_schedule; its design is in
//             the lf_group section below);
//   lf_walk   bcr.py::_terminator_positions_impl (:1048, the cyclic
//             backward search of an extend), read_lengths_from_bwt (:1090),
//             ops/extract.py::_extract_impl (:24) and _locate_walk_impl
//             (:93): batched LF walks, each run to its end in one call.
//
// The table layout and the two ways to read a row (rank_at, one thread; a
// quad of lanes and quad_rank) are in rank.cuh, shared with query.cu.
//
// What bounds them: dependent random row reads. A walk step reads the row
// of a position that the step before computed; the tables (379 MB at 505M
// symbols) are many times the 50 MB L2, so nearly every read goes to device
// memory in whole 32 B sectors (three of a row: its occurrence lanes and
// its three bit planes). Each walk's form is the fastest of the forms
// timed at the paths' shapes on an H100 (PERF.md §6, forms tried):
//
// * The cyclic and extract walks: a quad (four lanes of a warp) a walker,
//   each lane loading whole 16 B pieces of the walker's row, so one
//   warp-wide load reads eight rows (query.cu's design). The cyclic walk
//   knows its symbol ahead (the stage view, read by every lane of the quad),
//   so lane 0 loads only that symbol's occurrence piece and lanes 1..3 the
//   planes. The extract walk takes each step's symbol from the row's three
//   planes (bit r of lanes 1..3, one warp ballot), not from a second random
//   read of the BWT; lane 0 loads both occurrence pieces, since the symbol
//   is not known before the row arrives. Walks are ragged: every lane stays
//   in the loop to its warp's longest walk (a warp vote ends it), and a lane
//   whose walker has ended loads nothing.
// * The locate walk: one thread a walker, its symbol read from the BWT as
//   before. It has few walkers (one a hit) whose rows stay close and mostly
//   in cache, so a step's latency, not its bytes, sets its time: quads hold
//   a quarter of the walkers at once, and a symbol decoded from the planes
//   lengthens each step's dependent chain (both slower on an H100).
// * The read-length walk visits every position once (the LF cycles of the
//   strings cover [0, n)), so it first writes LF(p) for every p in one
//   streaming pass over the table (a warp a row, four positions a lane,
//   their ranks from a shuffle scan of the lanes' symbol histograms, int4
//   stores), then chases pointers with two walkers a thread: one 4 B read a
//   step, one sector where a row costs three. A walker ends when LF(pos) <
//   C[1] (the count of '$'), which holds exactly when the symbol at pos is
//   '$'. The LF array is a transient of 4 B a position (ceil(n / 128) * 512
//   B: 2.02 GB at 505M symbols, 6.06 GB at 1.515G), passed in by the caller.
// * lf_stage: one thread a read (the rank is rank_at), in a grid-stride
//   loop of at most kMaxStageBlocks blocks. Each warp counts its active
//   reads by symbol with six ballots, each block adds its warp totals in
//   shared memory and then into six accumulators of the caller's scratch
//   (int32 [kStageScratch]: the six counts, a ticket and a pad word, zeroed
//   before the first launch); the last block done (the ticket) writes
//   counts_out = counts + the accumulators and clears them and the ticket
//   for the next launch. So a column is one device event: no memset of
//   counts_out or of the scratch, and no block reads counts that another is
//   adding into. Launches that share a scratch must run one at a time (the
//   stage loop's, on its stream); concurrent callers each pass their own,
//   and the file keeps no state of its own across launches. lf_pair sums
//   each of its two columns' counts the same way, in the same scratch.
// * lf_pair: bounded like lf_stage by its two ranks' random row reads (the
//   distinct rows of both, 96 B each) beside ~40 B of per-read arrays; its
//   slot ranks use no sort and no pass over the buffer (below).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <mutex>

#include "rank.cuh"
#include "scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStageBlocks = 4096;  // lf_stage grid cap (grid-stride loop)
constexpr int kQuad = 4;               // lanes a walker
constexpr int kLfPerLane = 4;          // LF pass: positions a lane (one int4 store)

constexpr int kStageScratch = 8;       // lf_stage scratch: six counts, the ticket, a pad
static_assert(kSyms + 1 <= kStageScratch, "lf_stage's scratch holds the counts and the ticket");

enum WalkMode { kCyclic, kExtract };
constexpr int kChase = 2;              // read-length walk: walkers a thread

// The C array of counts into s_c (C[0] = 0, C[f >= 1] = nst +
// counts[1..f-1]), by threads 0..5; no barrier.
__device__ __forceinline__ void load_c(int* s_c, const int32_t* __restrict__ counts, int nst) {
  if (threadIdx.x < kSyms) {
    int c = 0;
    if (threadIdx.x > 0) {
      c = nst;
      for (int s = 1; s < (int)threadIdx.x; ++s) c += counts[s];
    }
    s_c[threadIdx.x] = c;
  }
}

// The column's C array into s_c and s_bump zeroed. Every thread of the
// block calls it.
__device__ __forceinline__ void stage_setup(int* s_c, int* s_bump,
                                            const int32_t* __restrict__ counts, int nst) {
  load_c(s_c, counts, nst);
  if (threadIdx.x < kSyms) s_bump[threadIdx.x] = 0;
  __syncthreads();
}

// The block's warp totals acc (lane 0 of each warp holds its warp's) into
// the launch's accumulators scratch[0..5], through s_bump (zeroed shared
// memory), and a ticket scratch[6]; the last block done writes counts_out =
// counts + the accumulators and clears them and the ticket. Every thread of
// the block calls it.
__device__ __forceinline__ void add_stage_counts(const int (&acc)[kSyms], int* s_bump,
                                                 const int32_t* __restrict__ counts,
                                                 int32_t* __restrict__ counts_out,
                                                 int32_t* __restrict__ scratch) {
  unsigned* done = (unsigned*)(scratch + kSyms);
  __shared__ bool s_last;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int s = 0; s < kSyms; ++s)
      if (acc[s]) atomicAdd(&s_bump[s], acc[s]);
  }
  __syncthreads();
  if (threadIdx.x < kSyms) {
    if (s_bump[threadIdx.x]) atomicAdd(&scratch[threadIdx.x], s_bump[threadIdx.x]);
    __threadfence();  // this block's adds before its ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last && threadIdx.x < kSyms) {
    __threadfence();
    counts_out[threadIdx.x] = counts[threadIdx.x] + atomicExch(&scratch[threadIdx.x], 0);
    if (threadIdx.x == 0) atomicExch(done, 0u);
  }
}

// One BCR column j for N reads: f = prev_v, q = C[f] + rank(f, P), active =
// j <= len + 1; P and prev_v move to (q, v) where active; counts_out =
// counts + the active v's (summed in scratch, add_stage_counts).
__global__ void __launch_bounds__(kThreads)
lf_stage_kernel(const int32_t* __restrict__ table, const uint8_t* __restrict__ v,
                const int32_t* __restrict__ lengths, const int32_t* __restrict__ P,
                const uint8_t* __restrict__ prev_v, const int32_t* __restrict__ counts,
                int32_t* __restrict__ q, uint8_t* __restrict__ active,
                int32_t* __restrict__ P_out, uint8_t* __restrict__ prev_out,
                int32_t* __restrict__ counts_out, int32_t* __restrict__ scratch, int64_t N,
                int j, int nst) {
  __shared__ int s_c[kSyms];
  __shared__ int s_bump[kSyms];
  stage_setup(s_c, s_bump, counts, nst);
  int acc[kSyms] = {0, 0, 0, 0, 0, 0};  // this warp's active reads by symbol
  // every thread of a block runs the same iterations: the ballots are whole
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < N;
       base += (int64_t)gridDim.x * kThreads) {
    const int64_t i = base + threadIdx.x;
    int sym = -1;
    if (i < N) {
      const int f = prev_v[i];
      const int p = P[i];
      const int vv = v[i];
      const bool act = j <= lengths[i] + 1;
      const int qq = s_c[f] + rank_at(table, f, p);
      q[i] = qq;
      active[i] = act;
      P_out[i] = act ? qq : p;
      prev_out[i] = (uint8_t)(act ? vv : f);
      if (act) sym = vv;
    }
#pragma unroll
    for (int s = 0; s < kSyms; ++s) acc[s] += __popc(__ballot_sync(kFull, sym == s));
  }
  add_stage_counts(acc, s_bump, counts, counts_out, scratch);
}

// ---------------------------------------------------------------------------
// lf_pair: two BCR columns j, j + 1 through one merge pass (radix 2)
// ---------------------------------------------------------------------------
//
// Column j's slots q1 are lf_stage's. Column j + 1's slots over the buffer
// after column j's inserts come from the table before them (the JAX step's
// identity): q2 = C1[v1] + rank(v1, old_pos) + inb, where C1 is the C
// array after column j, inv1 the number of active q1 below read i's,
// old_pos = clamp(q1 - inv1, 0, cap) and inb the number of those with read
// i's symbol v1. Then column j's slots move past column j + 1's: f1 = q1 +
// #{k < m2: bk[k] <= q1}, bk[inv2] = q2 - inv2 over the m2 active q2, inv2
// the number of active q2 below read i's.
//
// inv1, inb and inv2 are one primitive: the rank of a distinct slot below
// 2^31 among a set of distinct slots, by symbol. It takes no sort and no
// pass over an n-sized array: the slots are bucketed by slot tile, and each
// tile ranks its own: a warp a tile of at most kWarpSlots slots, every slot
// against every other, or a block a larger tile, with a bitmap of the tile a
// symbol in shared memory, word prefixes and popcounts. The tile is the
// largest power of two from 128 to 32K positions that holds at most
// kPairDensity slots on average (pair_shift: 32K at 500k reads over 500M,
// 128-1K in a build's first columns, where slots are dense), so a tile
// outgrows the warp only where slots cluster. The work is O(N + cap / tile).
//
// Bucketing without a placement pass: each slot's tile counter is bumped by
// one returning atomic, and its old value is the slot's place in the
// tile's bucket. The first kBucket places are the tile's own fixed bucket;
// places past it go to chunks of a shared pool, [K 2^c, K 2^(c+1)) in chunk
// c, listed in a directory of the tile that the slot at place K allocates
// and the slot at place K 2^c extends (the others wait for its word: both
// are running). The kernel that reads the tile counts scans them at its
// start: its first blocks to start each scan a chunk of 512 tile rows (the
// chunk publishes its sums and adds every earlier chunk's) and end, and the
// others rank the tiles, each waiting for its group's chunks only after its
// warps' compare loops (one thread a block polls, backing off).
//
// Launches, all on the caller's stream (5 device events a pair):
//   memset      the tile rows, the scans' chunk sums, flags and counters
//   pair_first  column j as lf_stage (its counts through the caller's
//               scratch into counts1), active2; each active q1 into its
//               tile's bucket, counted by tile and symbol
//   pair_rank1  the q1 tile counts to prefixes by symbol; the q1 tiles,
//               eight a block at a time: inv1, inb, the second rank at
//               old_pos, q2; each active q2 into its tile's bucket
//   pair_rank2  the q2 tile counts to prefixes (m2 the total); the q2
//               tiles: inv2, and bk[inv2] = q2 - inv2
//   pair_final  f1: the tile of column j's slot among the final buffer's
//               (the q2 tile starts, a few L2 reads), then a binary search of
//               that tile's bk entries; the carry, column j + 1's counts
//               through the scratch into counts_out
// A slot outside [0, cap] (a caller's error) is left out of every rank.
// The forms this one was chosen from (PERF.md §6, forms tried): loading
// both rows an old position can lie in before the compare loop (80
// registers, a row loaded that is not used), a quad a slot, the scans at
// the counting kernels' end or as kernels of their own (the rank kernels
// scan at their start), launch bounds; each was slower.

constexpr int kPairMaxShift = 15;                 // largest slot tile: 32K positions
constexpr int kPairMinShift = 7;                  // smallest: 128
constexpr int kPairDensity = 64;                  // slots a tile at most, on average
constexpr int kPairWords = (1 << kPairMaxShift) / 32;  // bitmap words a tile and symbol
constexpr int kBucketShift = 7;
constexpr int kBucket = 1 << kBucketShift;        // a tile's own bucket: places 0..127
constexpr int kDirLen = kPairMaxShift - kBucketShift;  // chunks c = 0..7 cover places below 32K
constexpr int kRow1 = 8;                          // q1 tile row: count, 6 symbol counts, chunk directory
constexpr int kRow2 = 4;                          // q2 tile row: count, prefix, pad, chunk directory
constexpr int kTileGroup = kThreads / 32;         // tiles a rank block takes at once, a warp each
constexpr int kWarpSlots = 128;                   // a warp ranks a tile of up to this many alone
constexpr int kMaxRankBlocks = 2048;              // rank grid cap (grid-stride loop)
enum { kTicket1, kTicket2, kDirs1, kDirs2, kPool1, kPool2, kCounters = 8 };
static_assert(kPairWords % kThreads == 0, "whole bitmap words a thread");
static_assert(kWarpSlots <= kBucket, "a warp's tile is all in its own bucket");

// A 32-bit word read with acquire, written with release, at GPU scope.
__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The slots of one column bucketed by tile: tile t's count at rows[t *
// stride], the index + 1 of its chunk directory (0: none yet) at rows[t *
// stride + stride - 1]; its own bucket prim[t * kBucket, +kBucket); chunk c
// of a directory d at pool[dir[d * kDirLen + c] - 1, +kBucket << c).
template <class E>
struct Buckets {
  int32_t* rows;
  int stride;
  E* prim;
  E* pool;
  int32_t* dir;
  int32_t* n_dirs;  // directories handed out
  int32_t* used;    // pool entries handed out
};

// Entry e at place loc >= kBucket of the tile whose row is `row`: in its
// chunk, out of line (rare: a tile past kBucket slots).
template <class E>
__device__ __noinline__ void chunk_put(const Buckets<E> b, int32_t* row, int loc, E e) {
  const int c = 31 - __clz(loc >> kBucketShift);
  const int base = kBucket << c;  // chunk c: places [base, 2 base)
  int32_t* dirp = row + b.stride - 1;
  int d;
  if (loc == kBucket) {  // the tile's first place past its bucket: its directory and chunk 0
    d = atomicAdd(b.n_dirs, 1);
    int32_t* dw = b.dir + (int64_t)d * kDirLen;
    dw[0] = atomicAdd(b.used, kBucket) + 1;
    for (int k = 1; k < kDirLen; ++k) dw[k] = 0;
    st_release(dirp, d + 1);
  } else {
    while ((d = ld_acquire(dirp)) == 0) __nanosleep(32);
    --d;
  }
  int32_t* cw = b.dir + (int64_t)d * kDirLen + c;
  int off;
  if (c > 0 && loc == base) {  // chunk c's first place: the chunk
    off = atomicAdd(b.used, base);
    st_release(cw, off + 1);
  } else {
    while ((off = ld_acquire(cw)) == 0) __nanosleep(32);
    --off;
  }
  b.pool[off + (loc - base)] = e;
}

// Entry e into tile t's bucket, at the place its count's old value gives.
template <class E>
__device__ __forceinline__ void bucket_put(const Buckets<E>& b, int64_t t, E e) {
  int32_t* row = b.rows + t * b.stride;
  const int loc = atomicAdd(row, 1);
  if (loc < kBucket) b.prim[t * kBucket + loc] = e;
  else chunk_put(b, row, loc, e);
}

// Entry idx of tile t (after the kernel that bucketed them).
template <class E>
__device__ __forceinline__ E bucket_get(const Buckets<E>& b, int64_t t, int idx) {
  if (idx < kBucket) return b.prim[t * kBucket + idx];
  const int c = 31 - __clz(idx >> kBucketShift);
  const int d = b.rows[t * b.stride + b.stride - 1] - 1;
  return b.pool[b.dir[(int64_t)d * kDirLen + c] - 1 + (idx - (kBucket << c))];
}

struct PairArgs {
  const int32_t* table;
  const uint8_t* v1;       // stage-view rows j and j + 1
  const uint8_t* v2;
  const int32_t* lengths;
  const int32_t* P;
  const uint8_t* prev_v;
  const int32_t* counts;   // [6] before column j
  int32_t* q;              // [2N]: q1, then f1 | q2
  uint8_t* active;         // [2N]
  int32_t* P_out;
  uint8_t* prev_out;
  int32_t* counts1;        // [6] after column j (work)
  int32_t* counts_out;     // [6] after column j + 1
  int32_t* scratch;        // lf_stage's accumulators and ticket
  int32_t* rows1;          // [(T + 1) * kRow1] q1 tiles: count, by symbol (prefixes after the scan)
  int32_t* rows2;          // [(T + 1) * kRow2] q2 tiles: count, prefix (after the scan)
  unsigned long long* agg1;  // [chunks * kSyms] the q1 scan's chunk sums
  unsigned long long* agg2;  // [chunks] the q2 scan's
  int32_t* ctr;            // [kCounters] tickets and hand-out counters
  int32_t* flags1;         // [chunks] a scan chunk's prefixes are written (1)
  int32_t* flags2;
  int2* prim1;             // q1 entries (read, slot in tile << 4 | active2 << 3 | symbol)
  int2* pool1;
  int32_t* dir1;
  int32_t* prim2;          // q2 entries (the slot)
  int32_t* pool2;
  int32_t* dir2;
  int32_t* bk;             // [N] sort(q2) - k
  int64_t N;
  int64_t n_tiles;         // T: tiles of [0, cap]
  int cap;
  int j;
  int nst;
  int shift;               // log2 of the tile
  int chunks;              // chunks of each scan
};

__device__ __forceinline__ Buckets<int2> buckets1(const PairArgs& a) {
  return {a.rows1, kRow1, a.prim1, a.pool1, a.dir1, a.ctr + kDirs1, a.ctr + kPool1};
}

__device__ __forceinline__ Buckets<int32_t> buckets2(const PairArgs& a) {
  return {a.rows2, kRow2, a.prim2, a.pool2, a.dir2, a.ctr + kDirs2, a.ctr + kPool2};
}

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) { return x < y ? x : y; }

// The tile of slot s, or -1 when s is outside the tiles.
__device__ __forceinline__ int64_t pair_tile(int s, int shift, int64_t n_tiles) {
  const int64_t t = s >> shift;
  return s >= 0 && t < n_tiles ? t : -1;
}

// Chunk b of `chunks` of rows 0..rows-1 (K counts at ints kIn.. of a row
// of S ints, loaded and stored whole as 16 B pieces; the last row holds
// zeros) to exclusive prefixes over all the rows, written at ints kOut..
// (kOut == kIn: in place): a thread sums its rows' counts, one block scan a
// count, the chunk publishes its sums (agg, a flagged 64-bit word a count,
// zeroed before the launch) and adds every earlier chunk's. Every thread of
// the block calls it.
template <int K, int S, int kIn, int kOut>
__device__ __forceinline__ void scan_chunk(int32_t* __restrict__ rows_arr, int64_t rows,
                                           unsigned long long* __restrict__ agg, int b,
                                           int chunks) {
  static_assert(S % 4 == 0, "rows of whole 16 B pieces");
  __shared__ int s_base[K];
  if (threadIdx.x < K) s_base[threadIdx.x] = 0;
  const int64_t chunk = (rows + chunks - 1) / chunks;
  const int64_t per = (chunk + kThreads - 1) / kThreads;
  const int64_t r0 = min64(b * chunk + threadIdx.x * per, rows);
  const int64_t r1 = min64(r0 + per, min64((b + 1) * chunk, rows));
  int4* row4 = reinterpret_cast<int4*>(rows_arr);
  int x[K], total[K];
#pragma unroll
  for (int s = 0; s < K; ++s) x[s] = 0;
  for (int64_t r = r0; r < r1; ++r) {
    int v[S];
#pragma unroll
    for (int p = 0; p < S / 4; ++p) *reinterpret_cast<int4*>(v + 4 * p) = __ldcg(row4 + r * (S / 4) + p);
#pragma unroll
    for (int s = 0; s < K; ++s) x[s] += v[kIn + s];
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    block_exclusive_scan<kThreads, 1>(x + s, total + s);
    __syncthreads();  // the scan's warp sums free again
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) store_state(agg + (int64_t)b * K + s, 1ull << 32, total[s]);
  }
  for (int k = threadIdx.x; k < b * K; k += kThreads) {
    unsigned long long v;
    for (int ns = 32; !((v = load_state(agg + k)) >> 32); ns = min(2 * ns, 1024)) __nanosleep(ns);
    atomicAdd(&s_base[k % K], (int)(uint32_t)v);
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < K; ++s) x[s] += s_base[s];
  for (int64_t r = r0; r < r1; ++r) {
    int v[S];
#pragma unroll
    for (int p = 0; p < S / 4; ++p) *reinterpret_cast<int4*>(v + 4 * p) = __ldcg(row4 + r * (S / 4) + p);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int c = v[kIn + s];
      v[kOut + s] = x[s];
      x[s] += c;
    }
#pragma unroll
    for (int p = 0; p < S / 4; ++p) row4[r * (S / 4) + p] = *reinterpret_cast<int4*>(v + 4 * p);
  }
}

// The chunks a scan of `rows` rows is cut into: two rows a thread, at most
// `grid` (the blocks that take one).
__host__ __device__ __forceinline__ int scan_chunks(int64_t rows, int64_t grid) {
  const int64_t c = (rows + 2 * kThreads - 1) / (2 * kThreads);
  return (int)(c < grid ? c : grid);
}

// At the start of a rank kernel, the scan of the tile rows its slots were
// counted into (by the kernel before: every count is final). The grid has
// `chunks` blocks more than its tile groups need; each block takes a
// ticket, the first `chunks` to start scan a chunk each (scan_chunk), raise
// its flag and end, and the others rank tiles as block ticket - chunks. So
// a scanner waits only on scanners that started before it, and a block that
// waits for a flag (wait_chunks) started after every scanner. Returns the
// block's index among the ranking blocks, or -1 for a scanner. Every thread
// of the block calls it.
template <int K, int S, int kIn, int kOut>
__device__ __forceinline__ int head_scan(int32_t* __restrict__ rows_arr, int64_t rows,
                                         unsigned long long* __restrict__ agg, int32_t* flags,
                                         int32_t* ticket, int chunks) {
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int b = s_ticket;
  if (b >= chunks) return b - chunks;
  scan_chunk<K, S, kIn, kOut>(rows_arr, rows, agg, b, chunks);
  __syncthreads();
  if (threadIdx.x == 0) {  // the chunk's prefixes before its flag
    __threadfence();
    st_release(flags + b, 1);
  }
  return -1;
}

// Wait until the chunks holding rows r0..r1 of a scan of `rows` rows in
// `chunks` chunks are written (their rows are then read with __ldcg, past
// L1). One thread a block waits, backing off from 64 ns to 2 us a poll:
// the flags share a few L2 lines, and every resident block polls them.
__device__ __forceinline__ void wait_chunks(const int32_t* flags, int64_t r0, int64_t r1,
                                            int64_t rows, int chunks) {
  const int64_t per = (rows + chunks - 1) / chunks;
  for (int64_t c = r0 / per; c <= r1 / per; ++c)
    for (int ns = 64; !ld_acquire(flags + c); ns = min(2 * ns, 2048)) __nanosleep(ns);
}

// Column j for every read, as lf_stage_kernel: q1 into q[0, N), active1
// and active2, counts1 = counts + column j's active symbols (through the
// scratch); q[N + i] = 0 where active2 is not (pair_rank1 writes the
// others); each active q1 into its tile's bucket, counted by symbol too.
__device__ __forceinline__ void pair_first_body(const PairArgs& a) {
  __shared__ int s_c[kSyms];
  __shared__ int s_bump[kSyms];
  stage_setup(s_c, s_bump, a.counts, a.nst);
  const Buckets<int2> b1 = buckets1(a);
  const int mask = (1 << a.shift) - 1;
  int acc[kSyms] = {0, 0, 0, 0, 0, 0};
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < a.N;
       base += (int64_t)gridDim.x * kThreads) {
    const int64_t i = base + threadIdx.x;
    int sym = -1;
    if (i < a.N) {
      const int f = a.prev_v[i];
      const int vv = a.v1[i];
      const int len = a.lengths[i];
      const bool act1 = a.j <= len + 1, act2 = a.j + 1 <= len + 1;
      const int q1 = s_c[f] + rank_at(a.table, f, a.P[i]);
      a.q[i] = q1;
      a.active[i] = act1;
      a.active[a.N + i] = act2;
      if (!act2) a.q[a.N + i] = 0;
      if (act1) {
        sym = vv;
        const int64_t t = pair_tile(q1, a.shift, a.n_tiles);
        if (t >= 0 && vv < kSyms) {
          atomicAdd(&a.rows1[t * kRow1 + 1 + vv], 1);
          bucket_put(b1, t, make_int2((int)i, ((q1 & mask) << 4) | (act2 << 3) | vv));
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSyms; ++s) acc[s] += __popc(__ballot_sync(kFull, sym == s));
  }
  add_stage_counts(acc, s_bump, a.counts, a.counts1, a.scratch);
}

__global__ void __launch_bounds__(kThreads) pair_first_kernel(const PairArgs a) {
  pair_first_body(a);
}

// The ranks of one tile tb of cb > kWarpSlots slots among its own, by the
// whole block (Pol as rank_tiles'): a bitmap of the tile a symbol in shared
// memory, its word prefixes (one block scan) and popcounts; then
// Pol::finish for each slot. Every thread of the block calls it; it leaves
// its shared memory free.
template <int kS, class Pol>
__device__ __forceinline__ void rank_big_tile(const Pol& pol, int64_t tb, int cb) {
  __shared__ unsigned bits[kS][kPairWords];
  __shared__ uint16_t pre[kS][kPairWords];  // a tile holds fewer than 2^16 slots
  constexpr int kPs = Pol::kPosShift;
  constexpr int kPer = kPairWords / kThreads;  // words a thread
  for (int i = threadIdx.x; i < kS * kPairWords; i += kThreads) (&bits[0][0])[i] = 0u;
  __syncthreads();
  for (int k = threadIdx.x; k < cb; k += kThreads) {
    const int y = pol.key(pol.entry(tb, k));
    const int slot = y >> kPs;
    atomicOr(&bits[kS == 1 ? 0 : y & 7][slot >> 5], 1u << (slot & 31));
  }
  __syncthreads();
  int x[kS], total[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    x[s] = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) x[s] += __popc(bits[s][kPer * threadIdx.x + i]);
  }
  block_exclusive_scan<kThreads, kS>(x, total);
#pragma unroll
  for (int s = 0; s < kS; ++s) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      pre[s][kPer * threadIdx.x + i] = (uint16_t)x[s];
      x[s] += __popc(bits[s][kPer * threadIdx.x + i]);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cb; k += kThreads) {
    const typename Pol::Entry e = pol.entry(tb, k);
    const int y = pol.key(e);
    const int slot = y >> kPs, sym = kS == 1 ? 0 : y & 7, wd = slot >> 5;
    const unsigned below = (1u << (slot & 31)) - 1u;
    int all = 0, same = 0;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int r = pre[s][wd] + __popc(bits[s][wd] & below);
      all += r;
      if (s == sym) same = r;
    }
    pol.finish(tb, e, all, same);
  }
  __syncthreads();  // bits, pre and the scan's warp sums free again
}

// The ranks of every tile's slots among the tile's own, for a policy Pol
// over tiles 0..n_tiles-1: Pol::count(t) and Pol::entry(t, idx) give tile
// t's slots; Pol::key(e) is an entry's compare key, its position key >>
// Pol::kPosShift and (kS > 1) its symbol key & 7; Pol::wait(t0, t1) (one
// thread) waits for tiles t0..t1's places (their scan chunks), and
// Pol::finish(t, e, all, same) uses an entry's ranks: `all` the tile's
// slots below the entry's and `same` those of them with its symbol (kS ==
// 1: all). Block `block` of `blocks` takes kTileGroup tiles at a time, a
// warp each, in a grid-stride loop; a warp ranks a tile of at most kWarpSlots slots alone,
// every slot against every other, before the block waits for the group's
// places; the block then ranks each larger tile of the group together
// (rank_big_tile). Every thread of the block calls it.
template <int kS, class Pol>
__device__ __forceinline__ void rank_tiles(const Pol& pol, int64_t n_tiles, int block,
                                           int blocks) {
  constexpr int kE = kWarpSlots / 32;  // entries a lane
  __shared__ int s_key[kTileGroup][kWarpSlots];
  __shared__ int s_big[kTileGroup];
  constexpr int kPs = Pol::kPosShift;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t t0 = (int64_t)block * kTileGroup; t0 < n_tiles;
       t0 += (int64_t)blocks * kTileGroup) {
    const int64_t t = t0 + warp;
    const int c = t < n_tiles ? pol.count(t) : 0;
    typename Pol::Entry e[kE];
    int all[kE], same[kE];
    if (c <= kWarpSlots) {
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int idx = lane + 32 * k;
        if (idx < c) {
          e[k] = pol.entry(t, idx);
          s_key[warp][idx] = pol.key(e[k]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        all[k] = same[k] = 0;
        if (lane + 32 * k >= c) continue;
        const int key = pol.key(e[k]);
        for (int m = 0; m < c; ++m) {
          const int o = s_key[warp][m];
          const bool below = (o >> kPs) < (key >> kPs);
          all[k] += below;
          if (kS > 1) same[k] += below && (o & 7) == (key & 7);
        }
      }
    }
    if (lane == 0) s_big[warp] = c > kWarpSlots;
    if (threadIdx.x == 0) pol.wait(t0, min64(t0 + kTileGroup, n_tiles) - 1);
    __syncthreads();
    if (c <= kWarpSlots) {
#pragma unroll
      for (int k = 0; k < kE; ++k)
        if (lane + 32 * k < c) pol.finish(t, e[k], all[k], kS == 1 ? all[k] : same[k]);
    }
    for (int w = 0; w < kTileGroup; ++w)
      if (s_big[w]) rank_big_tile<kS>(pol, t0 + w, pol.count(t0 + w));  // the same for every thread
    __syncthreads();  // s_key and s_big free again
  }
}

// pair_rank1's tiles, the q1 tiles: a tile's six symbol prefixes are the
// active slots of each symbol below it, their sum its start, and a slot's
// old position q1 - start - all; its second rank reads that row after the
// tile's ranks (rank_at). The prefixes are scanned in the same launch
// (head_scan), so wait for them.
struct Rank1 {
  using Entry = int2;
  static constexpr int kPosShift = 4;
  const PairArgs& a;
  const Buckets<int2> b1;
  const Buckets<int32_t> b2;
  const int* s_c;  // the C array after column j, in shared memory

  __device__ int count(int64_t t) const { return __ldcg(a.rows1 + t * kRow1); }
  __device__ int2 entry(int64_t t, int idx) const { return bucket_get(b1, t, idx); }
  __device__ int key(const int2& e) const { return e.y; }
  __device__ void wait(int64_t t0, int64_t t1) const {
    wait_chunks(a.flags1, t0, t1, a.n_tiles + 1, a.chunks);
  }

  // the tile's place: the active slots below it
  __device__ int start(int64_t t) const {
    const int4* row = reinterpret_cast<const int4*>(a.rows1 + t * kRow1);
    const int4 r0 = __ldcg(row), r1 = __ldcg(row + 1);
    return r0.y + r0.z + r0.w + r1.x + r1.y + r1.z;
  }

  // q2 = C1[v1] + rank(v1, old_pos) + inb into q[N + i] where active2, and
  // q2 into its tile's bucket
  __device__ void finish(int64_t t, int2 e, int all, int same) const {
    const int vv = e.y & 7;
    const int old_pos = min(max((int)(t << a.shift) + (e.y >> kPosShift) - start(t) - all, 0),
                            a.cap);
    const int q2 = s_c[vv] + rank_at(a.table, vv, old_pos) +
                   __ldcg(a.rows1 + t * kRow1 + 1 + vv) + same;
    if (e.y & 8) {  // active2
      a.q[a.N + e.x] = q2;
      const int64_t t2 = pair_tile(q2, a.shift, a.n_tiles);
      if (t2 >= 0) bucket_put(b2, t2, q2);
    }
  }
};

// Each q1 tile: each active read's inv1 and inb, its second rank at
// old_pos, q2 into q[N + i] where active2 and into its tile's bucket; the
// q1 tile counts to prefixes by symbol first (head_scan). At most 64
// registers (four blocks an SM): faster than no bound and than 42 (PERF.md
// §6, forms tried).
__global__ void __launch_bounds__(kThreads, 4) pair_rank1_kernel(const PairArgs a) {
  __shared__ int s_c[kSyms];  // the C array after column j
  load_c(s_c, a.counts1, a.nst);
  const int block = head_scan<kSyms, kRow1, 1, 1>(a.rows1, a.n_tiles + 1, a.agg1, a.flags1,
                                                  a.ctr + kTicket1, a.chunks);
  if (block < 0) return;
  __syncthreads();
  const Rank1 pol{a, buckets1(a), buckets2(a), s_c};
  rank_tiles<kSyms>(pol, a.n_tiles, block, gridDim.x - a.chunks);
}

// pair_rank2's tiles, the q2 tiles: a tile's start is its row's prefix.
struct Rank2 {
  using Entry = int32_t;
  static constexpr int kPosShift = 0;
  const PairArgs& a;
  const Buckets<int32_t> b2;
  const int mask;

  __device__ int count(int64_t t) const { return __ldcg(a.rows2 + t * kRow2); }
  __device__ void wait(int64_t t0, int64_t t1) const {
    wait_chunks(a.flags2, t0, t1, a.n_tiles + 1, a.chunks);
  }
  __device__ int32_t entry(int64_t t, int idx) const { return bucket_get(b2, t, idx); }
  __device__ int key(int32_t e) const { return e & mask; }
  // inv2 = start + all, and bk[inv2] = q2 - inv2
  __device__ void finish(int64_t t, int32_t q2, int all, int) const {
    const int inv2 = __ldcg(a.rows2 + t * kRow2 + 1) + all;
    a.bk[inv2] = q2 - inv2;
  }
};

// Each q2 tile: each active2 read's inv2, and bk[inv2] = q2 - inv2; the q2
// tile counts to prefixes first (head_scan; the last row's, m2, the total).
__global__ void __launch_bounds__(kThreads) pair_rank2_kernel(const PairArgs a) {
  const int block = head_scan<1, kRow2, 0, 1>(a.rows2, a.n_tiles + 1, a.agg2, a.flags2,
                                              a.ctr + kTicket2, a.chunks);
  if (block < 0) return;
  const Rank2 pol{a, buckets2(a), (1 << a.shift) - 1};
  rank_tiles<1>(pol, a.n_tiles, block, gridDim.x - a.chunks);
}

// Every read: f1 = q1 + #{k < m2: bk[k] <= q1} into q[i] (0 where active1
// is not); P and prev_v moved to column j + 1's slot and symbol where
// active2, else column j's where active1; counts_out = counts1 + column
// j + 1's active symbols (through the scratch). f1 is the q1-th position of
// the final buffer that no q2 takes: with S2[t] the q2 below tile t, the
// free positions below tile t are F(t) = t T - S2[t], non-decreasing, so
// f1 lies in the last tile t with F(t) <= q1, where every bk[k] of the
// tiles before is <= q1 and none after; the search finds t from q1's own
// tile by steps t -> (q1 + S2[t]) / T (each keeps F(t) <= q1) and single
// steps, then searches bk over that tile's entries only.
__global__ void __launch_bounds__(kThreads) pair_final_kernel(const PairArgs a) {
  __shared__ int s_bump[kSyms];
  if (threadIdx.x < kSyms) s_bump[threadIdx.x] = 0;
  __syncthreads();
  const int32_t* s2 = a.rows2 + 1;  // S2[t] at s2[t * kRow2]
  const int64_t nt = a.n_tiles;
  int acc[kSyms] = {0, 0, 0, 0, 0, 0};
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < a.N;
       base += (int64_t)gridDim.x * kThreads) {
    const int64_t i = base + threadIdx.x;
    int sym = -1;
    if (i < a.N) {
      const bool act1 = a.active[i], act2 = a.active[a.N + i];
      int f1 = 0;
      if (act1) {
        const int q1 = a.q[i];
        int64_t t = q1 < 0 ? 0 : min64(q1 >> a.shift, nt - 1);
        for (;;) {
          const int64_t tn = min64(((int64_t)q1 + __ldg(s2 + t * kRow2)) >> a.shift, nt - 1);
          if (tn > t) {
            t = tn;
          } else if (t + 1 < nt && ((t + 1) << a.shift) - __ldg(s2 + (t + 1) * kRow2) <= q1) {
            ++t;
          } else {
            break;
          }
        }
        int lo = __ldg(s2 + t * kRow2), hi = __ldg(s2 + (t + 1) * kRow2);
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (__ldg(a.bk + mid) <= q1) lo = mid + 1;
          else hi = mid;
        }
        f1 = q1 + lo;
      }
      a.q[i] = f1;
      a.P_out[i] = act2 ? a.q[a.N + i] : act1 ? f1 : a.P[i];
      const int v2 = a.v2[i];
      a.prev_out[i] = (uint8_t)(act2 ? v2 : act1 ? a.v1[i] : a.prev_v[i]);
      if (act2) sym = v2;
    }
#pragma unroll
    for (int s = 0; s < kSyms; ++s) acc[s] += __popc(__ballot_sync(kFull, sym == s));
  }
  add_stage_counts(acc, s_bump, a.counts1, a.counts_out, a.scratch);
}

// log2 of lf_pair's slot tile for N reads and a capacity cap: the largest
// power of two from 2^kPairMinShift to 2^kPairMaxShift with N T <=
// kPairDensity (cap + 1).
int pair_shift(int64_t N, int64_t cap) {
  int s = kPairMaxShift;
  while (s > kPairMinShift && (N << s) > (int64_t)kPairDensity * (cap + 1)) --s;
  return s;
}

// The work array of lf_pair, in int32 words: counts1; the two tile row
// arrays, the two scans' chunk sums, the counters and the scans' chunk
// flags (zeroed by the launcher); then each column's buckets (the tiles' own, the pool of
// chunks: fewer than 2N entries, since a tile's chunks hold fewer than
// twice its places past kBucket; the directories: at most N / (kBucket +
// 1), one a tile of more than kBucket slots), and bk. Every part starts on
// an 8 B boundary.
struct PairLayout {
  int64_t counts1 = 0, rows1 = 8, rows2, agg1, agg2, ctr, flags1, flags2, prim1, pool1, dir1,
          prim2, pool2, dir2, bk, total;
  PairLayout(int64_t N, int64_t n_tiles) {
    const int64_t dirs = ((N / (kBucket + 1) + 1) * kDirLen + 1) & ~int64_t(1);
    const int64_t pool = 2 * N;
    rows2 = rows1 + (n_tiles + 1) * kRow1;
    agg1 = rows2 + (n_tiles + 1) * kRow2;
    const int64_t chunks = scan_chunks(n_tiles + 1, INT64_MAX);  // the most either scan takes
    agg2 = agg1 + 2 * chunks * kSyms;  // u64 a chunk and count
    ctr = agg2 + 2 * chunks;
    flags1 = ctr + kCounters;
    flags2 = flags1 + ((chunks + 1) & ~int64_t(1));
    prim1 = flags2 + ((chunks + 1) & ~int64_t(1));
    pool1 = prim1 + 2 * n_tiles * kBucket;  // int2 entries
    dir1 = pool1 + 2 * pool;
    prim2 = dir1 + dirs;
    pool2 = prim2 + ((n_tiles * kBucket + 1) & ~int64_t(1));
    dir2 = pool2 + pool;
    bk = dir2 + dirs;
    total = bk + N;
  }
};

int64_t pair_tiles_of(int64_t cap, int shift) { return (cap >> shift) + 1; }

// The grids of lf_pair's kernels: per read (pair_first, pair_final) and per
// group of kTileGroup tiles (the rank kernels, which add a block a scan
// chunk); the scans' chunks.
struct PairGrid {
  unsigned reads, tiles;
  PairGrid(PairArgs& a) {
    int64_t blocks = (a.N + kThreads - 1) / kThreads;
    if (blocks > kMaxStageBlocks) blocks = kMaxStageBlocks;
    int64_t rank_blocks = (a.n_tiles + kTileGroup - 1) / kTileGroup;
    if (rank_blocks > kMaxRankBlocks) rank_blocks = kMaxRankBlocks;
    reads = (unsigned)blocks;
    tiles = (unsigned)rank_blocks;
    a.chunks = scan_chunks(a.n_tiles + 1, kMaxRankBlocks);
  }
};

// lf_pair's five device events on st: the memset of the zeroed part of the
// work (layout l) and the four kernels.
void launch_pair(PairArgs& a, const PairLayout& l, cudaStream_t st) {
  const PairGrid g(a);
  cudaMemsetAsync(a.rows1, 0, (l.prim1 - l.rows1) * sizeof(int32_t), st);
  pair_first_kernel<<<g.reads, kThreads, 0, st>>>(a);
  pair_rank1_kernel<<<g.tiles + a.chunks, kThreads, 0, st>>>(a);
  pair_rank2_kernel<<<g.tiles + a.chunks, kThreads, 0, st>>>(a);
  pair_final_kernel<<<g.reads, kThreads, 0, st>>>(a);
}

// The PairArgs of one lf_pair call (the arguments of msbwt_lf_pair) over
// its work array, laid out by l.
PairArgs pair_args(const void* table, const void* v1, const void* v2, const void* lengths,
                   const void* P, const void* prev_v, const void* counts, void* q, void* active,
                   void* P_out, void* prev_out, void* counts_out, void* scratch, void* work,
                   int64_t N, int64_t cap, int j, int nst, int shift, const PairLayout& l) {
  int32_t* w = (int32_t*)work;
  PairArgs a = {};
  a.table = (const int32_t*)table;
  a.v1 = (const uint8_t*)v1;
  a.v2 = (const uint8_t*)v2;
  a.lengths = (const int32_t*)lengths;
  a.P = (const int32_t*)P;
  a.prev_v = (const uint8_t*)prev_v;
  a.counts = (const int32_t*)counts;
  a.q = (int32_t*)q;
  a.active = (uint8_t*)active;
  a.P_out = (int32_t*)P_out;
  a.prev_out = (uint8_t*)prev_out;
  a.counts1 = w + l.counts1;
  a.counts_out = (int32_t*)counts_out;
  a.scratch = (int32_t*)scratch;
  a.rows1 = w + l.rows1;
  a.rows2 = w + l.rows2;
  a.agg1 = reinterpret_cast<unsigned long long*>(w + l.agg1);
  a.agg2 = reinterpret_cast<unsigned long long*>(w + l.agg2);
  a.ctr = w + l.ctr;
  a.flags1 = w + l.flags1;
  a.flags2 = w + l.flags2;
  a.prim1 = reinterpret_cast<int2*>(w + l.prim1);
  a.pool1 = reinterpret_cast<int2*>(w + l.pool1);
  a.dir1 = w + l.dir1;
  a.prim2 = w + l.prim2;
  a.pool2 = w + l.pool2;
  a.dir2 = w + l.dir2;
  a.bk = w + l.bk;
  a.N = N;
  a.n_tiles = pair_tiles_of(cap, shift);
  a.cap = (int)cap;
  a.j = j;
  a.nst = nst;
  a.shift = shift;
  return a;
}

// ---------------------------------------------------------------------------
// lf_group: a run of k > 2 BCR columns through one merge pass (column groups)
// ---------------------------------------------------------------------------
//
// It replaces no JAX kernel: the JAX package has no column groups (it runs
// one or two columns a pass). It was added for ragged reads, where few are
// active in a column and a pass a pair would stream the whole buffer for a
// few inserts (ops/bcr.group_schedule). Column t of the group (column j + t,
// reads r < A_t in the build's length order, by_len) ranks over B_t, the
// buffer B0 before the group plus the group's inserts so far, I_t, off the
// table of B0 alone: at a read's slot x in B_t,
//   q = C_t[f] + rank_B0(f, x - #{I_t below x}) + #{I_t below x with symbol f}
// (lf_pair's identity, carried by induction), and then every insert of I_t
// moves past the column's slots: y + #{l : sort(q)_l - l <= y}.
//
// No sort: I_t is kept sorted by slot (spos, with each insert's id << 3 |
// symbol in skey), and a column's slots come out sorted by construction. A
// slot's order is its symbol f first (slots of f lie in [C_t[f], C_t[f + 1]])
// and then the order of x (rank_Bt(f, x) grows with x, strictly, since x
// holds f). The reads of column t + 1 are those of column t whose slots are
// column t's inserts, so one scan of I_t in slot order, by symbol, gives
// each of them #{I_t below} (its index), #{I_t below with its symbol} and
// the rank of its coming slot among column t + 1's (the active heads of a
// smaller symbol, then those of its own before it). The group's first
// column takes the order of its reads' P from the caller (the last group's
// last column, or one argsort after a pair).
//
// Two forms, both exact and both a single launch a group; msbwt_lf_group
// picks one by N alone (cluster_max_n) and tells its caller which it
// launched:
//
// * The cluster form (cluster_group_kernel), while 2N slots fit on chip:
//   one thread-block cluster of kCluster CTAs carries the whole group, and
//   the group's sorted insert set lives in the cluster's distributed shared
//   memory, so a column's dependent steps are shared-memory reads and one or
//   two hardware cluster barriers. I_t is split by index over the CTAs, each
//   CTA a run of it in its own slice (double-buffered), and a column runs:
//     scan   each CTA a block scan of its slice, by symbol and by active
//            head, packed two counts a word; the heads' table rows
//            prefetched; the CTA's totals pushed into every CTA's shared
//            memory. In a column of at most kSparse reads each head also
//            reads its row (rank_at) and pushes a record into every CTA:
//            its rank plus the counts below it in its CTA, its place among
//            its CTA's heads; barrier;
//     rank   the totals of the CTAs before each added up locally. A column
//            of at most kSparse reads: every CTA builds the column's sorted
//            slots (q, key) from the records itself. A wider one: each head
//            computes its slot q and its place l and writes (q, key) at l
//            into every CTA's copy of the column; barrier;
//     merge  each CTA merges its slice with the column's slots that fall
//            after its first entry and up to the next CTA's first (two
//            binary searches of its copy), along merge-path diagonals, into
//            its own next slice: the slices grow apart and no barrier
//            follows. A column that could overflow a slice merges into even
//            slices in every CTA instead, behind a barrier.
//   A column's symbols by read are read a column ahead and written into
//   every CTA. The one global load on a column's chain is the table row.
//   No look-back words, no memset, no polling. A cluster barrier costs
//   ~0.7 us on an H100 (PERF.md), so a column of few reads takes one.
// * The cooperative form (group_kernel), for larger N: a persistent grid,
//   all of it resident, runs the group's columns in phases parted by
//   grid-wide barriers, the insert set in global memory (L2):
//     active       the columns' active reads (a binary search of the lengths
//                  in by_len order), once a group
//     scan         the scan of I_t (of the caller's order at t = 0), 1,024
//                  entries a tile, the tiles chained by a decoupled look-back
//                  (scan.cuh's flagged words, zeroed by a memset): each
//                  active read's old position x - #{I_t below x}, its
//                  same-symbol count and its slot's rank among the heads of
//                  its symbol; the column's counts row
//     rank         a thread a read: q off one table row (rank_at), into the
//                  column's sorted slots at its rank (after the heads of a
//                  smaller symbol: the scan's last tile's totals); the
//                  symbols counted
//     merge        a thread an entry of I_t or of the column: its place in
//                  I_{t+1} by a binary search of the other side (both sorted)
//     final, carry q / v / active over the 2N ids; P, prev_v and counts after
//                  the group.
//   A column there is a chain of L2 round trips (the look-back, the binary
//   searches through __ldcg): ~16.7 us a column at ecoli-ont50x's shape.
// Both forms compute the same integers in the same order of entries, so
// their outputs are bit-equal (and equal lf_group_plain's). What bounds a
// column of few reads is latency (barriers, dependent loads); in a wide one,
// the rank's random table rows (96 B each, one a read a column, as
// lf_pair's). The work is O(N): no copy of the view. Forms timed at the
// benchmark's shape (ecoli-ont50x's lengths, whole builds in turns in one
// call on an H100; PERF.md): of the cooperative one, three kernel launches
// a column, 6.22-6.59 s a build; one launch, 5.86-6.19 s; the scan and the
// rank fused, 5.86-6.15 s; a warp-wide look-back, 6.26-6.62 s. Of the
// cluster form (the group kernel's device time a build, against the
// cooperative form's 1.99 s): 8 CTAs, even slices and three barriers a
// column, 1.31 s; 16 CTAs, 1.15 s (256 threads a CTA: 1.21 s); slices that
// grow apart and one barrier in a column of few reads, 1.15 s; the
// cluster's totals summed once a CTA, 0.99 s.

constexpr int kScanPer = 4;                    // scan: entries a thread
constexpr int kScanTile = kThreads * kScanPer; // scan: entries a tile
constexpr int kScanK = 2 * kSyms;              // all entries by symbol, active heads by symbol
constexpr int kKeyShift = 3;                   // skey / qkey: insert id << 3 | symbol

// Tiles of a scan over n entries (at least one).
__host__ __device__ __forceinline__ int scan_tiles(int64_t n) {
  return n > kScanTile ? (int)((n + kScanTile - 1) / kScanTile) : 1;
}

struct GroupArgs {
  const int32_t* table;    // B0's
  const uint8_t* cols;     // the stage view [L + 2, N]
  const int32_t* lengths;  // [N]
  const int32_t* by_len;   // [N] the reads longest first
  const int32_t* P;
  const uint8_t* prev_v;
  const int32_t* counts;   // [6] before the group
  const int32_t* order;    // [n_order] places in by_len, in slot order (column j's reads among them)
  int32_t* q;              // [2N] by insert id
  uint8_t* v;              // [2N]
  uint8_t* active;         // [2N]
  int32_t* P_out;
  uint8_t* prev_out;
  int32_t* counts_out;
  int32_t* order_out;      // [N] the last column's reads in slot order
  unsigned long long* scan_state;  // [2][state_len]: the scan's look-back words, column t's at t & 1
  int64_t state_len;       // kScanK words a tile of the longest scan
  int32_t* acts;           // [k] the reads active in each column
  int32_t* cnt;            // [2][8] counts rows: before column t at row t & 1, after at the other
  int32_t* h_old;          // [N] by place in by_len: the old position of the read's slot
  int32_t* h_same;         // [N] the inserts below it with its symbol
  int32_t* h_rank;         // [N] its coming slot's rank among the heads of its symbol
  int32_t* last_id;        // [N] the read's last insert
  int32_t* qpos;           // [N] the column's slots, sorted
  int32_t* qkey;           // [N] and their keys
  int32_t* spos[2];        // [2N] I_t sorted by slot (I_t in buffer t & 1)
  int32_t* skey[2];
  int64_t N;
  int k;
  int n_order;
  int j;
  int nst;
  int ccap;                // cluster form: entries a CTA's slice of I_t holds
};

// Reads active in column c: #{r : lengths[by_len[r]] + 1 >= c}.
__device__ __forceinline__ int group_active(const GroupArgs& a, int c) {
  int lo = 0, hi = (int)a.N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a.lengths[a.by_len[mid]] + 1 >= c) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Tile b of the scan of column t's heads (the entries of I_t whose ids lie
// in [head0, head0 + A), column t - 1's inserts of the reads still active;
// at t = 0 the caller's order, reads r < A) by symbol, and of all of I_t by
// symbol: kScanPer entries a thread, a block scan, then the exclusive prefix
// of the tiles before (decoupled look-back over scan.cuh's flagged words: 1
// the tile's own totals, 2 its inclusive prefix; a block takes its tiles in
// order, so the lowest tile unfinished waits on none). Each active read r
// gets h_old, h_same and h_rank. Every thread of the block calls it.
__device__ __forceinline__ void group_scan_tile(const GroupArgs& a, int t, int n, int head0,
                                                int A, int b) {
  __shared__ int warp_sums[kThreads / 32][kScanK];
  __shared__ int s_excl[kScanK];
  unsigned long long* st = a.scan_state + (t & 1) * a.state_len;
  const int32_t* sk = a.skey[t & 1];
  const int32_t* sp = a.spos[t & 1];
  const int k0 = b * kScanTile + threadIdx.x * kScanPer;
  int r[kScanPer], sym[kScanPer];  // sym -1: past the entries
#pragma unroll
  for (int e = 0; e < kScanPer; ++e) {
    const int k = k0 + e;
    r[e] = -1;
    sym[e] = -1;
    if (k < n) {
      if (t == 0) {
        r[e] = a.order[k];
        if ((unsigned)r[e] < (unsigned)A) sym[e] = a.prev_v[a.by_len[r[e]]];
      } else {
        const int key = __ldcg(sk + k);
        r[e] = (key >> kKeyShift) - head0;
        sym[e] = key & 7;
      }
    }
  }
  int x[kScanK], tot[kScanK];
#pragma unroll
  for (int c = 0; c < kSyms; ++c) {
    x[c] = x[kSyms + c] = 0;
#pragma unroll
    for (int e = 0; e < kScanPer; ++e) {
      x[c] += sym[e] == c;
      x[kSyms + c] += sym[e] == c && (unsigned)r[e] < (unsigned)A;
    }
  }
  block_exclusive_scan<kThreads, kScanK>(x, tot, warp_sums);
  if (threadIdx.x < kScanK) {
    const int c = threadIdx.x;
    int own = 0;
#pragma unroll
    for (int d = 0; d < kScanK; ++d) own = d == c ? tot[d] : own;
    unsigned long long* mine = st + (int64_t)b * kScanK + c;
    int excl = 0;
    if (b == 0) {
      store_state(mine, 2ull << 32, own);
    } else {
      store_state(mine, 1ull << 32, own);
      for (int p = b - 1; p >= 0; --p) {
        unsigned long long v;
        for (int ns = 32; !((v = load_state(st + (int64_t)p * kScanK + c)) >> 32);
             ns = min(2 * ns, 1024))
          __nanosleep(ns);
        excl += (int)(uint32_t)v;
        if ((v >> 32) == 2) break;
      }
      store_state(mine, 2ull << 32, excl + own);
    }
    s_excl[c] = excl;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kScanK; ++c) x[c] += s_excl[c];
#pragma unroll
  for (int e = 0; e < kScanPer; ++e) {
    if (sym[e] < 0) continue;
    int same = 0, rank = 0;
#pragma unroll
    for (int c = 0; c < kSyms; ++c) {
      if (sym[e] != c) continue;
      same = x[c]++;
      if ((unsigned)r[e] < (unsigned)A) rank = x[kSyms + c]++;
    }
    if ((unsigned)r[e] >= (unsigned)A) continue;
    const int k = k0 + e;
    a.h_old[r[e]] = t == 0 ? a.P[a.by_len[r[e]]] : __ldcg(sp + k) - k;
    a.h_same[r[e]] = t == 0 ? 0 : same;
    a.h_rank[r[e]] = rank;
  }
  __syncthreads();  // warp_sums and s_excl free for the block's next tile
}

// Column t's reads r < A: q = C_t[f] + rank_B0(f, h_old) + h_same into the
// column's sorted slots at its rank (the heads of a smaller symbol, from
// the scan's last tile, then h_rank), its key (id off + r); the read's
// symbol into v and the counts row after the column; at the last column,
// the read into order_out at its slot's rank. Every thread of the block
// calls it.
__device__ __forceinline__ void group_rank(const GroupArgs& a, int t, int off, int A,
                                           int scan_nt) {
  __shared__ int s_c[kSyms];
  __shared__ int s_bump[kSyms];
  __shared__ int s_hb[kSyms];
  const int32_t* row_in = a.cnt + (t & 1) * 8;
  if (threadIdx.x == 0) {  // the last tile's inclusive prefix: the scan's totals
    const unsigned long long* tot =
        a.scan_state + (t & 1) * a.state_len + (int64_t)(scan_nt - 1) * kScanK + kSyms;
    int h = 0;
    for (int s = 0; s < kSyms; ++s) {
      s_hb[s] = h;
      h += (int)(uint32_t)load_state(tot + s);
    }
  }
  if (threadIdx.x < kSyms) {
    int c = 0;
    if (threadIdx.x > 0) {
      c = a.nst;
      for (int s = 1; s < (int)threadIdx.x; ++s) c += __ldcg(row_in + s);
    }
    s_c[threadIdx.x] = c;
    s_bump[threadIdx.x] = 0;
  }
  __syncthreads();
  const bool last = t == a.k - 1;
  for (int base = blockIdx.x * kThreads; base < A; base += gridDim.x * kThreads) {
    const int r = base + threadIdx.x;
    int sym = -1;
    if (r < A) {
      const int64_t i = a.by_len[r];
      const int64_t c = a.j + t;
      const int f = t == 0 ? a.prev_v[i] : a.cols[(c - 1) * a.N + i];
      const int vv = a.cols[c * a.N + i];
      const int l = s_hb[f] + __ldcg(a.h_rank + r);
      a.qpos[l] = s_c[f] + rank_at(a.table, f, __ldcg(a.h_old + r)) + __ldcg(a.h_same + r);
      a.qkey[l] = ((off + r) << kKeyShift) | vv;
      a.v[off + r] = (uint8_t)vv;
      a.last_id[r] = off + r;
      if (last) a.order_out[l] = r;
      sym = vv;
    }
#pragma unroll
    for (int s = 0; s < kSyms; ++s) {
      const int c = __popc(__ballot_sync(kFull, sym == s));
      if ((threadIdx.x & 31) == 0 && c) atomicAdd(&s_bump[s], c);
    }
  }
  __syncthreads();
  if (threadIdx.x < kSyms && s_bump[threadIdx.x])
    atomicAdd(a.cnt + ((t + 1) & 1) * 8 + threadIdx.x, s_bump[threadIdx.x]);
}

// I_{t+1} from I_t (m entries, buffer t & 1) and column t's A sorted slots:
// an entry at slot y of I_t moves to y + #{l : qpos[l] - l <= y}, at index
// k + that; the column's slot l goes to index l + #{I_t below qpos[l] - l}.
__device__ __forceinline__ void group_merge(const GroupArgs& a, int t, int m, int A) {
  const int32_t* sp = a.spos[t & 1];
  const int32_t* sk = a.skey[t & 1];
  int32_t* dp = a.spos[(t + 1) & 1];
  int32_t* dk = a.skey[(t + 1) & 1];
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < m + A;
       idx += gridDim.x * kThreads) {
    if (idx < m) {
      const int y = __ldcg(sp + idx);
      int lo = 0, hi = A;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldcg(a.qpos + mid) - mid <= y) lo = mid + 1;
        else hi = mid;
      }
      dp[idx + lo] = y + lo;
      dk[idx + lo] = __ldcg(sk + idx);
    } else {
      const int l = idx - m;
      const int q = __ldcg(a.qpos + l), d = q - l;
      int lo = 0, hi = m;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldcg(sp + mid) < d) lo = mid + 1;
        else hi = mid;
      }
      dp[l + lo] = q;
      dk[l + lo] = __ldcg(a.qkey + l);
    }
  }
}

// The group: its columns' active counts, then a column at a time the scan,
// the rank and the merge, each phase ended by a grid-wide barrier (the grid
// is all resident: a cooperative launch); then the outputs by id and the
// carry. Column t's look-back words are cleared in its merge phase (the
// rank has read them) for column t + 2. Every thread of the grid runs every
// phase.
__global__ void __launch_bounds__(kThreads) group_kernel(const GroupArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int gt = blockIdx.x * kThreads + threadIdx.x, gs = gridDim.x * kThreads;
  for (int t = gt; t < a.k; t += gs) a.acts[t] = group_active(a, a.j + t);
  if (gt < kSyms) a.cnt[gt] = a.counts[gt];
  grid.sync();
  int off = 0, head0 = 0;
  for (int t = 0; t < a.k; ++t) {
    const int A = __ldcg(a.acts + t);
    const int n = t == 0 ? a.n_order : off;
    const int nt = scan_tiles(n);
    if (gt < kSyms) a.cnt[((t + 1) & 1) * 8 + gt] = __ldcg(a.cnt + (t & 1) * 8 + gt);
    for (int b = blockIdx.x; b < nt; b += gridDim.x) group_scan_tile(a, t, n, head0, A, b);
    grid.sync();
    group_rank(a, t, off, A, nt);
    grid.sync();
    unsigned long long* st = a.scan_state + (t & 1) * a.state_len;
    for (int i = gt; i < nt * kScanK; i += gs) st[i] = 0;
    group_merge(a, t, off, A);
    grid.sync();
    head0 = off;
    off += A;
  }
  const int M = off, kb = a.k & 1;
  for (int64_t idx = gt; idx < 2 * a.N; idx += gs) {
    if (idx < M) {
      a.q[__ldcg(a.skey[kb] + idx) >> kKeyShift] = __ldcg(a.spos[kb] + idx);
      a.active[idx] = 1;
    } else {
      a.q[idx] = 0;
      a.v[idx] = 0;
      a.active[idx] = 0;
    }
  }
  grid.sync();
  const int A0 = __ldcg(a.acts);
  if (gt < kSyms) a.counts_out[gt] = __ldcg(a.cnt + kb * 8 + gt);
  for (int64_t r = gt; r < a.N; r += gs) {
    const int64_t i = a.by_len[r];
    if (r < A0) {
      const int e = __ldcg(a.last_id + r);
      a.P_out[i] = __ldcg(a.q + e);
      a.prev_out[i] = __ldcg(a.v + e);
    } else {
      a.P_out[i] = a.P[i];
      a.prev_out[i] = a.prev_v[i];
    }
  }
}

// lf_group's work array in int32 words, for N reads and k columns: the
// scan's look-back words (zeroed by the launcher), the active counts, the
// counts rows, then the per-read arrays and the two sorted insert sets.
struct GroupLayout {
  int64_t state = 0, state_len, acts, cnt, h_old, h_same, h_rank, last_id, qpos, qkey, spos0,
          skey0, spos1, skey1, total;
  GroupLayout(int64_t N, int64_t k) {
    state_len = (int64_t)scan_tiles(2 * N) * kScanK;  // u64 words a column
    acts = state + 4 * state_len;
    cnt = acts + ((k + 1) & ~int64_t(1));
    h_old = cnt + 16;
    h_same = h_old + N;
    h_rank = h_same + N;
    last_id = h_rank + N;
    qpos = last_id + N;
    qkey = qpos + N;
    spos0 = qkey + N;
    skey0 = spos0 + 2 * N;
    spos1 = skey0 + 2 * N;
    skey1 = spos1 + 2 * N;
    total = skey1 + 2 * N;
  }
};

// The blocks of group_kernel's grid on the current device: as many as the
// group's widest phase takes (2N threads), at most as many as are resident
// at once (a cooperative launch needs the whole grid resident).
int group_grid(int64_t N) {
  static int resident[64];  // a device's resident blocks, once found (0: not yet)
  int dev = 0;
  cudaGetDevice(&dev);
  int cap = dev < 64 ? resident[dev] : 0;
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, group_kernel, kThreads, 0);
    cap = sms * per_sm;
    if (dev < 64) resident[dev] = cap;
  }
  const int64_t want = (2 * N + kThreads - 1) / kThreads;
  return (int)(want < cap ? want : cap);
}

// The cluster form (the design is above group_kernel's). A CTA's dynamic
// shared memory for N reads: two slices of I_t (int2: slot, key) of `cap`
// entries, the column's sorted slots (int2: q, key; at most N), two
// columns' head records (int2, kSparse each) and two columns' symbols by
// read (u8, N each).
constexpr int kCluster = 16;                 // CTAs a cluster (above the portable 8)
constexpr int kCThreads = 512;               // threads a CTA
constexpr int kCPer = 8;                     // entries of a slice a thread at most
constexpr int kCSlice = kCThreads * kCPer;   // entries a slice at most
constexpr int kCPf = 4;                      // reads a thread reads the next symbol of
constexpr int kSparse = 512;                 // a column of at most this many reads: one barrier
constexpr int kPackShift = 16;               // scan words: entries | active heads << 16
constexpr int kLow = (1 << kPackShift) - 1;

__host__ __forceinline__ int64_t cluster_even(int64_t N) {  // a slice of even slices
  return (2 * N + kCluster - 1) / kCluster;
}

__host__ __forceinline__ int64_t cluster_fixed(int64_t N) {  // bytes beside the slices
  return (N + 2 * kSparse) * (int64_t)sizeof(int2) + ((2 * N + 7) & ~int64_t(7));
}

__host__ __forceinline__ size_t cluster_smem(int64_t N, int64_t cap) {
  return (size_t)(2 * cap * (int64_t)sizeof(int2) + cluster_fixed(N));
}

// #{l < n : s[l].x - l <= y}: the column's slots (sorted, distinct) whose
// old position is at most y.
__device__ __forceinline__ int slots_at_most(const int2* s, int n, int y) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid].x - mid <= y) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The table row of position pos into this SM's L1, ahead of its rank.
__device__ __forceinline__ void prefetch_row(const int32_t* table, int pos) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(table + (int64_t)(pos >> kBinShift) * kRow));
}

// One cluster a group. CTA `me` holds entries [bef, bef + sz) of I_t, in
// order, in its slice; a thread takes E = ceil(sz / kCThreads) of them in a
// row. A column's slots that fall after the CTA's first entry and up to its
// successor's (the next CTA that holds entries) merge into its own slice,
// so the slices grow apart and a column needs no barrier after its merge;
// a column that could overflow a slice (cap), or whose fullest slice holds
// a row of entries a thread more than an even share (it paces every
// phase), merges into even slices instead, behind a barrier. At t = 0 the CTAs scan shares of the caller's
// order (n_order places in by_len) and write its heads into the empty I_0
// buffer as (P, read << 3 | prev_v), the rest as -1; the column's slots
// split evenly. A column of at most kSparse reads: each head pushes a
// record (its rank plus its CTA's counts below it, its place among its
// CTA's heads) into every CTA, and after one barrier every CTA builds the
// column's sorted slots from the records itself. A wider column: after the
// barrier each head computes its slot and writes it into every CTA, behind
// a second barrier. A column's symbols by read are in every CTA before it:
// each thread reads those of its kCPf reads a column ahead and writes them
// into every CTA. Every thread of the cluster runs every phase.
__global__ void __launch_bounds__(kCThreads, 1) cluster_group_kernel(const GroupArgs a) {
  extern __shared__ int2 s_dyn[];
  __shared__ int s_tot[2][kCluster][kSyms];  // each CTA's scan totals, packed, by column
  __shared__ int s_ex[kCluster][kSyms];      // the totals of the CTAs before each
  __shared__ int s_hb[kSyms];                // the column's heads of a smaller symbol
  __shared__ int s_cb[kSyms];                // C_t
  __shared__ int s_hist[kSyms];              // the column's new symbols
  __shared__ int s_cnt[kSyms];               // the counts row before the column
  __shared__ int s_next;                     // the successor's first slot, when read
  __shared__ int s_max;                      // the fullest slice
  __shared__ int warp_sums[kCThreads / 32][kSyms];
  __shared__ int warp_pre[kCThreads / 32 + 1][kSyms];  // the warps' exclusive prefix; the CTA's total
  cg::cluster_group cl = cg::this_cluster();
  const int me = (int)cl.block_rank(), tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cap = a.ccap;
  int2* ent[2] = {s_dyn, s_dyn + cap};
  int2* col = s_dyn + 2 * cap;
  int2* recs[2] = {col + a.N, col + a.N + kSparse};
  uint8_t* vvs[2] = {reinterpret_cast<uint8_t*>(col + a.N + 2 * kSparse),
                     reinterpret_cast<uint8_t*>(col + a.N + 2 * kSparse) + a.N};
  auto rf = [&](int p) {  // this thread's reads: 32 in a row a warp, the CTAs in turn
    return ((((p * kCThreads + tid) >> 5) * kCluster + me) << 5) + lane;
  };
  int ir[kCPf];  // their places in the view: by_len
#pragma unroll
  for (int p = 0; p < kCPf; ++p) ir[p] = rf(p) < a.N ? a.by_len[rf(p)] : 0;
  // acts[t] = #{r : len_r >= j + t - 1}, the lengths falling in by_len
  // order: read r writes r + 1 to the columns after read r + 1's last and
  // up to its own (one past the longest's: 0)
  for (int64_t r = me * kCThreads + tid - 1; r < a.N; r += kCluster * kCThreads) {
    const int hi = r < 0 ? a.k - 1 : min(a.lengths[a.by_len[r]] + 1 - a.j, a.k - 1);
    const int lo = r + 1 < a.N ? max(a.lengths[a.by_len[r + 1]] + 2 - a.j, 0) : 0;
    for (int t = lo; t <= hi; ++t) a.acts[t] = (int)(r + 1);
  }
  if (tid < kSyms) {
    s_cnt[tid] = a.counts[tid];
    s_hist[tid] = 0;
  }
  cl.sync();
  int A = __ldcg(a.acts), A1 = a.k > 1 ? __ldcg(a.acts + 1) : 0, off = 0, head0 = 0;
  // this thread's symbols of a column into every CTA
  auto spread = [&](uint8_t* dst, const int (&v)[kCPf], int n) {
#pragma unroll
    for (int p = 0; p < kCPf; ++p)
      if (rf(p) < n)
        for (int d = 0; d < kCluster; ++d) cl.map_shared_rank(dst, d)[rf(p)] = (uint8_t)v[p];
  };
  {
    int v0[kCPf];
#pragma unroll
    for (int p = 0; p < kCPf; ++p) v0[p] = rf(p) < A ? a.cols[(int64_t)a.j * a.N + ir[p]] : 0;
    spread(vvs[0], v0, A);
  }
  int sz = 0, bef = 0, succ_y = 0;  // this CTA's slice, the entries before it, its successor's first
  bool succ = false, fresh = false;  // a successor; its first slot to be read from it
  for (int t = 0; t < a.k; ++t) {
    const int A2 = t + 2 < a.k ? __ldcg(a.acts + t + 2) : 0;
    const int m = off, par = t & 1;
    const bool sparse = A <= kSparse, last = t == a.k - 1;
    int nscan = sz, sbase = bef;  // the entries this CTA scans, the index of the first
    if (t == 0) {
      const int S0 = (a.n_order + kCluster - 1) / kCluster;
      sbase = me * S0;
      nscan = max(0, min(S0, a.n_order - sbase));
    }
    const int E = (nscan + kCThreads - 1) / kCThreads, b = tid * E, bend = min(b + E, nscan);
    int2* cur = ent[par];
    const uint8_t* vcur = vvs[par];
    const int64_t c = a.j + t;
    int pv[kCPf];  // the next column's symbols, spread at the merge
#pragma unroll
    for (int p = 0; p < kCPf; ++p) pv[p] = rf(p) < A1 ? a.cols[(c + 1) * a.N + ir[p]] : 0;
    if (fresh && tid == kCluster) s_next = cl.map_shared_rank(cur, me + 1)[0].x;
    // scan: this thread's entries by symbol and head; the heads' rows
    int px[kSyms] = {0, 0, 0, 0, 0, 0};
    bool mine = false;  // a head among this thread's entries
#pragma unroll 1
    for (int li = b; li < bend; ++li) {
      int f, old;
      if (t == 0) {
        const int r = a.order[sbase + li];
        if ((unsigned)r >= (unsigned)A) {
          cur[li] = make_int2(-1, -1);
          continue;
        }
        const int64_t i = a.by_len[r];
        f = a.prev_v[i];
        old = a.P[i];
        cur[li] = make_int2(old, (r << kKeyShift) | f);
      } else {
        const int2 en = cur[li];
        f = en.y & 7;
        old = en.x - (sbase + li);
        if ((unsigned)((en.y >> kKeyShift) - head0) >= (unsigned)A) {
#pragma unroll
          for (int s = 0; s < kSyms; ++s) px[s] += f == s;
          continue;
        }
      }
      prefetch_row(a.table, old);
      mine = true;
#pragma unroll
      for (int s = 0; s < kSyms; ++s) px[s] += f == s ? 1 + (1 << kPackShift) : 0;
    }
    // the block's scan, its prefixes only in the warps that hold a head
    const bool wheads = __any_sync(kFull, mine);
#pragma unroll
    for (int s = 0; s < kSyms; ++s) {
      int x = px[s];
      if (wheads) {
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, x, o);
          if (lane >= o) x += y;
        }
        px[s] = x - px[s];
        x = __shfl_sync(kFull, x, 31);
      } else {
        x = __reduce_add_sync(kFull, x);
      }
      if (lane == 0) warp_sums[warp][s] = x;
    }
    __syncthreads();
    if (tid < kSyms) {
      int x = 0;
      for (int w = 0; w < kCThreads / 32; ++w) {
        warp_pre[w][tid] = x;
        x += warp_sums[w][tid];
      }
      warp_pre[kCThreads / 32][tid] = x;
    }
    __syncthreads();
    if (wheads) {
#pragma unroll
      for (int s = 0; s < kSyms; ++s) px[s] += warp_pre[warp][s];
    }
    if (tid < kCluster) {
      int* dst = cl.map_shared_rank(&s_tot[par][me][0], tid);
#pragma unroll
      for (int s = 0; s < kSyms; ++s) dst[s] = warp_pre[kCThreads / 32][s];
    }
    // a thread's heads in order: their packed counts below them in this CTA
    auto heads = [&](auto&& fn) {
#pragma unroll 1
      for (int li = b; li < bend; ++li) {
        const int2 en = cur[li];
        if (en.y < 0) continue;
        const int f = en.y & 7, r = (en.y >> kKeyShift) - head0;
        const bool head = (unsigned)r < (unsigned)A;
        int pre = 0;
#pragma unroll
        for (int s = 0; s < kSyms; ++s) {
          if (f != s) continue;
          pre = px[s];
          px[s] += 1 + ((int)head << kPackShift);
        }
        if (head) fn(en, li, f, r, pre);
      }
    };
    if (sparse && mine) {  // the records: the rank and the counts below, into every CTA
      heads([&](int2 en, int li, int f, int r, int pre) {
        const int old = t == 0 ? en.x : en.x - (sbase + li);
        const int2 rec = make_int2(rank_at(a.table, f, old) + (t == 0 ? 0 : pre & kLow),
                                   (pre >> kPackShift << 8) | (f << 4) | me);
        for (int d = 0; d < kCluster; ++d) cl.map_shared_rank(recs[par], d)[r] = rec;
      });
    }
    cl.sync();
    if (fresh) succ_y = s_next;
    // the totals of the CTAs before each, the heads of a smaller symbol, C_t
    if (tid < kCluster * kSyms) {
      const int d = tid / kSyms, s = tid % kSyms;
      int ex = 0;
      for (int e = 0; e < d; ++e) ex += s_tot[par][e][s];
      s_ex[d][s] = ex;
    } else if (tid >= kCThreads - kSyms) {
      const int s = tid - (kCThreads - kSyms);
      int h = 0, cb = s == 0 ? 0 : a.nst;
      for (int e = 0; e < s; ++e) {
        for (int d = 0; d < kCluster; ++d) h += s_tot[par][d][e] >> kPackShift;
        if (e > 0) cb += s_cnt[e];
      }
      s_hb[s] = h;
      s_cb[s] = cb;
    }
    {
      // the column's new symbols: a thread's counts (ceil(A / kCThreads),
      // at most 64 reads for N < 2^15) three 10-bit fields a word; the
      // warp's (at most 2,048 reads) two 16-bit fields a word, a pair of
      // symbols at a time
      int hv0 = 0, hv1 = 0;
      for (int r = tid; r < A; r += kCThreads) {
        const int v = vcur[r];
        if (v < 3) hv0 += 1 << (10 * v);
        else hv1 += 1 << (10 * (v - 3));
      }
#pragma unroll
      for (int s = 0; s < kSyms; s += 2) {
        const int lo = ((s < 3 ? hv0 : hv1) >> (10 * (s % 3))) & 1023;
        const int hi = ((s + 1 < 3 ? hv0 : hv1) >> (10 * ((s + 1) % 3))) & 1023;
        const int n = __reduce_add_sync(kFull, lo | hi << 16);
        if (lane == 0 && n) {
          if (n & 0xFFFF) atomicAdd(&s_hist[s], n & 0xFFFF);
          if (n >> 16) atomicAdd(&s_hist[s + 1], n >> 16);
        }
      }
    }
    if (warp == 0) {  // the fullest slice, for the merge's choice
      int n = 0;
      if (lane < kCluster)
#pragma unroll
        for (int s = 0; s < kSyms; ++s) n += s_tot[par][lane][s] & kLow;
      n = __reduce_max_sync(kFull, n);
      if (lane == 0) s_max = n;
    }
    __syncthreads();
    if (sparse) {  // every CTA builds the column's sorted slots from the records
      const int2* rc = recs[par];
      for (int r = tid; r < A; r += kCThreads) {
        const int2 rec = rc[r];
        const int f = (rec.y >> 4) & 7, ex = s_ex[rec.y & 15][f];
        const int q = s_cb[f] + rec.x + (t == 0 ? 0 : ex & kLow);
        const int l = s_hb[f] + (ex >> kPackShift) + (rec.y >> 8);
        col[l] = make_int2(q, ((off + r) << kKeyShift) | vcur[r]);
        if (last && me == 0) a.order_out[l] = r;
      }
      __syncthreads();
    } else {  // each head's slot into every CTA's copy of the column
      if (mine) {  // the rows again, all in flight before the first rank
#pragma unroll 1
        for (int li = b; li < bend; ++li) {
          const int2 en = cur[li];
          if (en.y >= 0 && (unsigned)((en.y >> kKeyShift) - head0) < (unsigned)A)
            prefetch_row(a.table, t == 0 ? en.x : en.x - (sbase + li));
        }
        heads([&](int2 en, int li, int f, int r, int pre) {
          pre += s_ex[me][f];
          const int old = t == 0 ? en.x : en.x - (sbase + li);
          const int q = s_cb[f] + rank_at(a.table, f, old) + (t == 0 ? 0 : pre & kLow);
          const int l = s_hb[f] + (pre >> kPackShift);
          const int2 slot = make_int2(q, ((off + r) << kKeyShift) | vcur[r]);
          for (int d = 0; d < kCluster; ++d) cl.map_shared_rank(col, d)[l] = slot;
          if (last) a.order_out[l] = r;
        });
      }
      cl.sync();
    }
    // merge: this CTA's entries with the column's slots from its first
    // entry up to its successor's, along merge-path diagonals
    if (tid < kSyms) {
      s_cnt[tid] += s_hist[tid];
      s_hist[tid] = 0;
    }
    spread(vvs[par ^ 1], pv, A1);
#pragma unroll
    for (int p = 0; p < kCPf; ++p) {  // this column's symbols by id, the reads that end here
      const int r = rf(p);
      if (r < A) {
        a.v[off + r] = vcur[r];
        if (r >= A1) a.last_id[r] = off + r;
      }
    }
    const int m1 = m + A, S1 = max(1, (m1 + kCluster - 1) / kCluster);
    // even slices where one could overflow, or the fullest holds a row of
    // entries a thread more than an even share (it paces every phase)
    const bool even = m > 0 && (s_max + A > cap || s_max > S1 + kCThreads);
    int2* nxt = ent[par ^ 1];
    int l0, l1, nown;
    if (m == 0) {  // the column alone, split evenly
      const int S1 = (A + kCluster - 1) / kCluster;
      l0 = min(me * S1, A);
      l1 = min(l0 + S1, A);
      nown = 0;
    } else if (sz == 0) {
      l0 = l1 = nown = 0;
    } else {
      l0 = bef > 0 ? slots_at_most(col, A, cur[0].x) : 0;
      l1 = succ ? slots_at_most(col, A, succ_y) : A;
      nown = sz;
    }
    const int nnew = l1 - l0, total = nown + nnew;
    const int per = (total + kCThreads - 1) / kCThreads;
    const int o0 = min(tid * per, total), o1 = min(o0 + per, total);
    if (o0 < o1) {
      const int2* nw = col + l0;  // this CTA's slots; d = q - (l0 + j)
      int lo = max(0, o0 - nnew), hi = min(o0, nown);
      while (lo < hi) {  // own entries among the first o0 outputs
        const int mid = (lo + hi) >> 1;
        const int jj = o0 - 1 - mid;
        if (cur[mid].x < nw[jj].x - (l0 + jj)) lo = mid + 1;
        else hi = mid;
      }
      int i = lo, jn = o0 - lo;
      const int pos = bef + l0 + o0;  // in I_{t+1}
      int d = even ? pos / S1 : me, at = even ? pos - d * S1 : o0;
#pragma unroll 1
      for (int o = o0; o < o1; ++o) {
        int2 v;
        if (i < nown && (jn >= nnew || cur[i].x < nw[jn].x - (l0 + jn))) {
          v = cur[i++];
          v.x += l0 + jn;
        } else {
          v = nw[jn++];
        }
        if (even && at == S1) {
          ++d;
          at = 0;
        }
        if (d == me) nxt[at] = v;
        else cl.map_shared_rank(nxt, d)[at] = v;
        ++at;
      }
    }
    if (m == 0) {
      sz = nnew;
      bef = l0;
      succ = l1 < A;
      succ_y = succ ? col[l1].x : 0;
      fresh = false;
    } else if (even) {
      sz = max(0, min(S1, m1 - me * S1));
      bef = min(me * S1, m1);
      succ = me + 1 < kCluster && (me + 1) * S1 < m1;
      fresh = succ;
    } else {
      sz += nnew;
      bef += l0;
      succ_y += l1;
      fresh = false;
    }
    if (even) cl.sync();
    else __syncthreads();
    head0 = off;
    off += A;
    A = A1;
    A1 = A2;
  }
  // outputs by id, then the carry
  const int M = off;
  const int2* fin = ent[a.k & 1];
  for (int li = tid; li < sz; li += kCThreads) {
    const int2 en = fin[li];
    a.q[en.y >> kKeyShift] = en.x;
    a.active[bef + li] = 1;
  }
  for (int64_t idx = M + me * kCThreads + tid; idx < 2 * a.N; idx += kCluster * kCThreads) {
    a.q[idx] = 0;
    a.v[idx] = 0;
    a.active[idx] = 0;
  }
  if (me == 0 && tid < kSyms) a.counts_out[tid] = s_cnt[tid];
  cl.sync();
  const int A0 = __ldcg(a.acts);
#pragma unroll 4
  for (int64_t r = me * kCThreads + tid; r < a.N; r += kCluster * kCThreads) {
    const int64_t i = a.by_len[r];
    if (r < A0) {
      const int e = __ldcg(a.last_id + r);
      a.P_out[i] = __ldcg(a.q + e);
      a.prev_out[i] = __ldcg(a.v + e);
    } else {
      a.P_out[i] = a.P[i];
      a.prev_out[i] = a.prev_v[i];
    }
  }
}

// The cluster form's limits on the current device, found once a device:
// the room for dynamic shared memory a CTA, and the largest N it takes, 0
// for none (even slices fit, a slice fits kCThreads threads of kCPer
// entries, the read-ahead covers N, and a cluster of kCluster CTAs with that
// much shared memory each can be placed: cudaOccupancyMaxActiveClusters; 16
// CTAs is above the portable size, so the kernel allows it first). The
// kernel's dynamic shared-memory limit is raised to the room.
struct ClusterLimits {
  int64_t room = 0, max_n = 0;
};

ClusterLimits cluster_limits() {
  static std::mutex mu;
  static ClusterLimits found[64];
  static bool done[64];
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 64 && done[dev]) return found[dev];
  ClusterLimits lim;
  int optin = 0;
  cudaFuncAttributes fa = {};
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncGetAttributes(&fa, cluster_group_kernel);
  lim.room = (int64_t)optin - (int64_t)fa.sharedSizeBytes;
  int64_t n = (int64_t)kCluster * kCSlice / 2;  // the slices' limit
  const int64_t by_reads = (int64_t)kCPf * kCluster * kCThreads;  // the read-ahead's
  n = n < by_reads ? n : by_reads;
  n = n < 32767 ? n : 32767;  // the scan's packed counts: 2N below 2^16
  while (n > 0 && (int64_t)cluster_smem(n, cluster_even(n)) > lim.room) --n;
  if (n > 0) {
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCluster;
    attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kCThreads);
    cfg.dynamicSmemBytes = (size_t)lim.room;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaFuncSetAttribute(cluster_group_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess ||
        cudaFuncSetAttribute(cluster_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)lim.room) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&clusters, cluster_group_kernel, &cfg) != cudaSuccess ||
        clusters < 1)
      n = 0;
  }
  cudaGetLastError();  // a refused query is an answer here, not the caller's error
  lim.max_n = n;
  if (dev < 64) {
    found[dev] = lim;
    done[dev] = true;
  }
  return lim;
}

int64_t cluster_max_n() { return cluster_limits().max_n; }

// One cluster_group_kernel launch for the group (cluster_max_n() >= N):
// its slices as large as the room allows, up to kCSlice entries.
cudaError_t launch_cluster_group(GroupArgs a, cudaStream_t st) {
  const ClusterLimits lim = cluster_limits();
  const int64_t fit = (lim.room - cluster_fixed(a.N)) / (2 * (int64_t)sizeof(int2));
  a.ccap = (int)(fit < kCSlice ? fit : kCSlice);
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = cluster_smem(a.N, a.ccap);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, cluster_group_kernel, a);
}

struct WalkArgs {
  const int32_t* table;
  const int32_t* starts;   // [7]: C array of the index
  const uint8_t* bwt;      // locate: the symbols
  const uint8_t* cols;     // kCyclic: the stage view [L + 2, n_walkers]
  const int32_t* lengths;  // kCyclic: read lengths
  const int32_t* steps;    // kCyclic: steps of each walker
  const int32_t* pos_in;   // kExtract: row ids; locate: start rows
  int32_t* pos_out;        // kCyclic: end rows; locate: read ids
  int32_t* aux_out;        // locate: offsets
  uint8_t* sym_out;        // kExtract: [n_walkers, l_max], zero-filled by the caller
  uint8_t* done_out;       // kExtract: the walk met its '$'
  int64_t n_walkers;
  int64_t n;               // kCyclic: start row (the base's n)
  int64_t n_strings;       // locate: rows below it are '$' rotations
  int limit;               // kCyclic: the loop bound n_steps; kExtract, locate: l_max
};

// This lane's place: quad lane j (0..3), the quad's first lane in its warp
// and the quad's walker.
struct QuadLane {
  int j;
  int first;
  int64_t walker;
};

__device__ __forceinline__ QuadLane quad_lane() {
  const int lane = threadIdx.x & 31;
  return {lane & (kQuad - 1), lane & ~(kQuad - 1),
          ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kQuad};
}

// The row pieces of a quad's step at pos: lane 0 the occurrence piece of
// the symbol `known` (kKnown) or both occurrence pieces (v and o1), lanes
// 1..3 the planes 0..2. A quad that is not live loads nothing.
struct QuadRow {
  int4 v, o1;
};

template <bool kKnown>
__device__ __forceinline__ QuadRow quad_load(const int32_t* __restrict__ table, int pos,
                                             int known, bool live, const QuadLane& l) {
  const int4* row = reinterpret_cast<const int4*>(table + (int64_t)(pos >> kBinShift) * kRow);
  QuadRow q = {make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
  if (live) {
    q.v = __ldg(row + (l.j > 0 ? kPackedPlane + l.j - 1 : kKnown ? known >> 2 : 0));
    if (!kKnown && l.j == 0) q.o1 = __ldg(row + 1);
  }
  return q;
}

// The step off the loaded pieces: {the symbol at pos, LF(pos)}; the symbol
// is `known` (kKnown) or decoded from the planes with one ballot (bit r of
// lanes 1..3). A quad that is not live gets junk. Every lane of the warp
// calls it.
template <bool kKnown>
__device__ __forceinline__ int2 quad_finish(const QuadRow& q, const int* s_starts, int pos,
                                            int known, const QuadLane& l) {
  const int r = pos & kBinMask;
  int sym = known;
  if (!kKnown) {
    const bool bit = l.j > 0 && (((unsigned)lane_of4(q.v, r >> 5) >> (r & 31)) & 1u);
    sym = (__ballot_sync(kFull, bit) >> (l.first + 1)) & 7;
  }
  const unsigned plane = max(l.j - 1, 0);
  const uint4 x = l.j == 0 ? ones4() : plane_match(q.v, 0u - ((sym >> plane) & 1u));
  int occ = 0;
  if (l.j == 0) occ = kKnown || sym < 4 ? lane_of4(q.v, sym & 3) : lane_of4(q.o1, sym & 3);
  return make_int2(sym, s_starts[sym] + quad_rank(x, occ, r, l.j));
}

// One LF step of the quad's walker at pos (quad_load, then quad_finish).
template <bool kKnown>
__device__ __forceinline__ int2 quad_step(const int32_t* __restrict__ table,
                                          const int* s_starts, int pos, int known, bool live,
                                          const QuadLane& l) {
  return quad_finish<kKnown>(quad_load<kKnown>(table, pos, known, live, l), s_starts, pos,
                             known, l);
}

// A quad a walker, its position in registers from start to end; lane 0
// writes the walker's outputs.
template <int kMode>
__global__ void __launch_bounds__(kThreads) lf_walk_kernel(const WalkArgs a) {
  __shared__ int s_starts[8];  // C, and 0 for PAD (the junk of a dead quad)
  if (threadIdx.x < 8) s_starts[threadIdx.x] = threadIdx.x < kStarts ? a.starts[threadIdx.x] : 0;
  __syncthreads();
  const QuadLane l = quad_lane();
  const int64_t i = l.walker;
  const bool valid = i < a.n_walkers;
  if (kMode == kCyclic) {
    // step t reads cycle index t mod (len + 1) of '$' + S right to left:
    // stage-view row (t mod (len + 1)) + 1
    const int m = valid ? a.lengths[i] + 1 : 1;
    const int lim = valid ? min(a.steps[i], a.limit) : 0;
    int pos = (int)a.n;
    int k = 0;
    for (int t = 0; __any_sync(kFull, t < lim); ++t) {
      const bool live = t < lim;
      const int sym = live ? a.cols[(int64_t)(k + 1) * a.n_walkers + i] : 0;
      const int next = quad_step<true>(a.table, s_starts, pos, sym, live, l).y;
      if (live) {
        pos = next;
        if (++k == m) k = 0;
      }
    }
    if (valid && l.j == 0) a.pos_out[i] = pos;
  } else {  // kExtract
    // the read right-aligned: the symbol of step t at column l_max - 1 - t
    // (clamped at 0: the last of l_max + 1 steps only looks for the '$')
    const int l_max = a.limit;
    uint8_t* out = a.sym_out + i * l_max;
    int pos = valid ? a.pos_in[i] : 0;
    bool live = valid, done = false;
    for (int t = 0; __any_sync(kFull, live); ++t) {
      const int2 s = quad_step<false>(a.table, s_starts, pos, 0, live, l);
      if (live) {
        if (s.x == 0) {
          done = true;
          live = false;
        } else {
          if (l.j == 0) out[max(l_max - 1 - t, 0)] = (uint8_t)s.x;
          pos = s.y;
          live = t < l_max;
        }
      }
    }
    if (valid && l.j == 0) a.done_out[i] = done;
  }
}

// LF(p) for every position of `rows` table rows: a warp a row, positions
// 4k..4k+3 at lane k, one int4 store. Lane k decodes its four symbols off
// the planes and the warp adds their histograms (a byte a symbol, packed in
// 64 bits) with a shuffle scan, so each rank is the row's count before the
// bin + the lanes' before + the lane's own before (positions past n get
// junk; no walk reads them). Block 0 also clears the walk's flag.
__global__ void __launch_bounds__(kThreads)
lf_array_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ starts,
                int32_t* __restrict__ lf, int32_t* __restrict__ flag, int64_t rows) {
  __shared__ int s_starts[8];
  if (threadIdx.x < 8) s_starts[threadIdx.x] = threadIdx.x < kStarts ? starts[threadIdx.x] : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *flag = 0;
  __syncthreads();
  const int64_t p0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kLfPerLane;
  if (p0 >= rows << kBinShift) return;  // whole warps: a row is 32 lanes
  const int lane = threadIdx.x & 31;
  const int4* row = reinterpret_cast<const int4*>(table + (p0 >> kBinShift) * kRow);
  const int4 o0 = __ldg(row), o1 = __ldg(row + 1);
  const int w = lane >> 3, b0 = (lane & 7) * kLfPerLane;
  const unsigned w0 = lane_of4(__ldg(row + 2), w), w1 = lane_of4(__ldg(row + 3), w),
                 w2 = lane_of4(__ldg(row + 4), w);
  int sym[kLfPerLane];
  unsigned long long own = 0;
#pragma unroll
  for (int k = 0; k < kLfPerLane; ++k) {
    const int b = b0 + k;
    sym[k] = ((w0 >> b) & 1) | (((w1 >> b) & 1) << 1) | (((w2 >> b) & 1) << 2);
    own += 1ull << (8 * sym[k]);
  }
  unsigned long long scan = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long up = __shfl_up_sync(kFull, scan, d);
    if (lane >= d) scan += up;
  }
  unsigned long long before = scan - own;  // each symbol's count in the lanes before
  int out[kLfPerLane];
#pragma unroll
  for (int k = 0; k < kLfPerLane; ++k) {
    const int f = sym[k];
    const int occ = f < 4 ? lane_of4(o0, f) : f == 4 ? o1.x : o1.y;
    out[k] = s_starts[f] + occ + (int)((before >> (8 * f)) & 0xff);
    before += 1ull << (8 * f);
  }
  *reinterpret_cast<int4*>(lf + p0) = make_int4(out[0], out[1], out[2], out[3]);
}

// The read-length walk on the LF array, kChase walkers a thread (walkers
// thread + b * threads for b < kChase: kChase loads in flight a thread, and
// every walker of a long-read set resident at once): walker i from '$'
// rotation i until LF(pos) < C[1] (the symbol at pos is '$'), at most n
// steps; its steps are the string's length. A walk that does not close sets
// the flag.
__global__ void __launch_bounds__(kThreads)
lf_chase_lengths_kernel(const int32_t* __restrict__ lf, const int32_t* __restrict__ starts,
                        int32_t* __restrict__ lengths_out, int32_t* __restrict__ flag,
                        int64_t n_strings, int64_t n) {
  const int64_t t0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int dollars = __ldg(starts + 1);
  int pos[kChase];
  int64_t len[kChase];
  bool live[kChase], closed[kChase];
#pragma unroll
  for (int b = 0; b < kChase; ++b) {
    const int64_t i = t0 + b * stride;
    pos[b] = (int)i;
    len[b] = 0;
    closed[b] = false;
    live[b] = i < n_strings && n > 0;
  }
  for (bool any = true; any;) {
    int next[kChase];
#pragma unroll
    for (int b = 0; b < kChase; ++b) next[b] = live[b] ? __ldg(lf + pos[b]) : 0;
    any = false;
#pragma unroll
    for (int b = 0; b < kChase; ++b) {
      if (!live[b]) continue;
      if (next[b] < dollars) {
        closed[b] = true;
        live[b] = false;
      } else {
        pos[b] = next[b];
        live[b] = ++len[b] < n;
      }
      any |= live[b];
    }
  }
#pragma unroll
  for (int b = 0; b < kChase; ++b) {
    const int64_t i = t0 + b * stride;
    if (i >= n_strings) continue;
    lengths_out[i] = (int32_t)len[b];
    if (!closed[b]) *flag = 1;
  }
}

// The locate walk, one thread a walker, each step's symbol read from the
// BWT beside rank_at's five row loads (all six addresses depend on the
// position alone). It has few walkers (one a hit) whose rows stay close
// (the hits of a k-mer walk through neighbouring rows, mostly in cache), so
// a step's latency, not its bytes, sets its time: quads would hold a
// quarter of the walkers at once, and a symbol decoded from the planes
// would lengthen each step's dependent chain. From rows pos_in until a row
// below n_strings, at most limit + 1 steps.
__global__ void __launch_bounds__(kThreads) lf_locate_kernel(const WalkArgs a) {
  __shared__ int s_starts[kStarts];
  if (threadIdx.x < kStarts) s_starts[threadIdx.x] = a.starts[threadIdx.x];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_walkers) return;
  int pos = a.pos_in[i];
  int steps = 0;
  for (int t = 0; t <= a.limit && pos >= a.n_strings; ++t, ++steps) {
    const int sym = a.bwt[pos];
    pos = s_starts[sym] + rank_at(a.table, sym, pos);
  }
  a.pos_out[i] = pos;
  a.aux_out[i] = steps - 1;
}

template <int kMode>
int launch_walk(const WalkArgs& a, cudaStream_t st) {
  if (a.n_walkers > 0) {
    const unsigned blocks = (unsigned)((a.n_walkers * kQuad + kThreads - 1) / kThreads);
    lf_walk_kernel<kMode><<<blocks, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One BCR column: table i32 [rows, 32] (16 B-aligned), v = stage-view row j
// u8 [N], lengths i32 [N], P i32 [N], prev_v u8 [N], counts i32 [6] ->
// q i32 [N], active bool [N], P_out i32 [N], prev_out u8 [N], counts_out
// i32 [6] (apart from counts). scratch i32 [8] is the caller's, zeroed
// before its first launch and left zeroed by each (one scratch a stream of
// launches: two launches that may overlap need two). Launches on `stream`;
// returns cudaGetLastError().
int msbwt_lf_stage(const void* table, const void* v, const void* lengths, const void* P,
                   const void* prev_v, const void* counts, void* q, void* active, void* P_out,
                   void* prev_out, void* counts_out, void* scratch, int64_t N, int j, int nst,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 0) {
    cudaMemcpyAsync(counts_out, counts, kSyms * sizeof(int32_t), cudaMemcpyDeviceToDevice, st);
    return (int)cudaGetLastError();
  }
  int64_t blocks = (N + kThreads - 1) / kThreads;
  if (blocks > kMaxStageBlocks) blocks = kMaxStageBlocks;
  lf_stage_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const int32_t*)table, (const uint8_t*)v, (const int32_t*)lengths, (const int32_t*)P,
      (const uint8_t*)prev_v, (const int32_t*)counts, (int32_t*)q, (uint8_t*)active,
      (int32_t*)P_out, (uint8_t*)prev_out, (int32_t*)counts_out, (int32_t*)scratch, N, j, nst);
  return (int)cudaGetLastError();
}

// lf_pair's slot tile for N reads and a capacity cap, in positions (the
// tests place their slots against it).
int msbwt_lf_pair_tile(int64_t N, int64_t cap) { return 1 << pair_shift(N, cap); }

// Places a tile's own bucket holds; the slots past them go to its chunks.
int msbwt_lf_pair_bucket() { return kBucket; }

// lf_pair's work array for N reads and a buffer of cap positions, in int32
// words (the caller allocates it, 16 B-aligned).
int64_t msbwt_lf_pair_work_len(int64_t N, int64_t cap) {
  return PairLayout(N, pair_tiles_of(cap, pair_shift(N, cap))).total;
}

// Two BCR columns j, j + 1 for one merge pass: table i32 [rows, 32] with
// rows > cap / 128 (16 B-aligned), v1 / v2 = stage-view rows j and j + 1
// u8 [N], lengths i32 [N], P i32 [N], prev_v u8 [N], counts i32 [6] ->
// q i32 [2N] (column j's final slots, then column j + 1's; 0 where
// inactive), active bool [2N], P_out i32 [N], prev_out u8 [N], counts_out
// i32 [6] (after both columns). scratch i32 [8] is lf_stage's (zeroed,
// left zeroed); work i32 [msbwt_lf_pair_work_len(N, cap)] is the call's
// own. Five device events on `stream`; returns cudaGetLastError().
int msbwt_lf_pair(const void* table, const void* v1, const void* v2, const void* lengths,
                  const void* P, const void* prev_v, const void* counts, void* q,
                  void* active, void* P_out, void* prev_out, void* counts_out,
                  void* scratch, void* work, int64_t N, int64_t cap, int j, int nst,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 0) {
    cudaMemcpyAsync(counts_out, counts, kSyms * sizeof(int32_t), cudaMemcpyDeviceToDevice, st);
    return (int)cudaGetLastError();
  }
  if (cap < 0 || cap >= (int64_t(1) << 31) || N >= (int64_t(1) << 30))
    return (int)cudaErrorInvalidValue;
  const int shift = pair_shift(N, cap);
  const PairLayout l(N, pair_tiles_of(cap, shift));
  PairArgs a = pair_args(table, v1, v2, lengths, P, prev_v, counts, q, active, P_out, prev_out,
                         counts_out, scratch, work, N, cap, j, nst, shift, l);
  launch_pair(a, l, st);
  return (int)cudaGetLastError();
}

// lf_group's work array for N reads and k columns, in int32 words (the
// caller allocates it).
int64_t msbwt_lf_group_work_len(int64_t N, int64_t k) { return GroupLayout(N, k).total; }

// Columns j..j+k-1 for one merge pass: acts (host int32 [k], falling, at
// most N, summing to at most 2N) the reads active in each, which are the
// first of by_len i32 [N] (the reads longest first; lengths i32 [N], whose
// counts acts must be); table i32 [rows, 32] of the buffer before the group
// (16 B-aligned), cols u8 [L + 2, N], P i32 [N], prev_v u8 [N], counts i32
// [6], order i32 [n_order] (places in by_len in slot order, every read of
// column j among them) -> q i32 [2N], v u8 [2N], active bool [2N] (the
// inserts by id, column t's reads at ids off_t + r, the sum(acts) active ids
// first), P_out i32 [N], prev_out u8 [N], counts_out i32 [6], order_out i32
// [N] (its first acts[k - 1]: the last column's reads in slot order). work
// i32 [msbwt_lf_group_work_len(N, k)] is the call's own. One cluster launch
// while N <= cluster_max_n(), else a memset and one cooperative launch, on
// `stream`; form_host (host int32) gets 1 for the cluster form, 0 for the
// cooperative one, once it is launched. Returns the first error.
int msbwt_lf_group(const void* table, const void* cols, const void* lengths, const void* by_len,
                   const void* P, const void* prev_v, const void* counts, const void* order,
                   void* q, void* v, void* active, void* P_out, void* prev_out,
                   void* counts_out, void* order_out, void* work, const void* acts_host,
                   void* form_host, int64_t N, int k, int n_order, int j, int nst,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* acts = (const int32_t*)acts_host;
  if (N <= 0 || N >= (int64_t(1) << 26) || k < 1 || n_order < acts[0] || n_order > N)
    return (int)cudaErrorInvalidValue;
  int64_t sum = 0;
  for (int t = 0; t < k; ++t) {
    if (acts[t] < 0 || acts[t] > (t ? acts[t - 1] : N)) return (int)cudaErrorInvalidValue;
    sum += acts[t];
  }
  if (sum > 2 * N) return (int)cudaErrorInvalidValue;
  const GroupLayout l(N, k);
  int32_t* w = (int32_t*)work;
  GroupArgs a = {};
  a.table = (const int32_t*)table;
  a.cols = (const uint8_t*)cols;
  a.lengths = (const int32_t*)lengths;
  a.by_len = (const int32_t*)by_len;
  a.P = (const int32_t*)P;
  a.prev_v = (const uint8_t*)prev_v;
  a.counts = (const int32_t*)counts;
  a.order = (const int32_t*)order;
  a.q = (int32_t*)q;
  a.v = (uint8_t*)v;
  a.active = (uint8_t*)active;
  a.P_out = (int32_t*)P_out;
  a.prev_out = (uint8_t*)prev_out;
  a.counts_out = (int32_t*)counts_out;
  a.order_out = (int32_t*)order_out;
  a.scan_state = reinterpret_cast<unsigned long long*>(w + l.state);
  a.state_len = l.state_len;
  a.acts = w + l.acts;
  a.cnt = w + l.cnt;
  a.h_old = w + l.h_old;
  a.h_same = w + l.h_same;
  a.h_rank = w + l.h_rank;
  a.last_id = w + l.last_id;
  a.qpos = w + l.qpos;
  a.qkey = w + l.qkey;
  a.spos[0] = w + l.spos0;
  a.skey[0] = w + l.skey0;
  a.spos[1] = w + l.spos1;
  a.skey[1] = w + l.skey1;
  a.N = N;
  a.k = k;
  a.n_order = n_order;
  a.j = j;
  a.nst = nst;
  const bool cluster = N <= cluster_max_n();
  cudaError_t err;
  if (cluster) {
    err = launch_cluster_group(a, st);
  } else {
    err = cudaMemsetAsync(w, 0, l.acts * sizeof(int32_t), st);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)group_kernel, dim3(group_grid(N)),
                                      dim3(kThreads), args, 0, st);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) *(int32_t*)form_host = cluster;
  return (int)err;
}

// The largest N for which msbwt_lf_group takes the cluster form on the
// current device (0: it never does there); for the tests, which build at it.
int64_t msbwt_lf_group_cluster_max_n(void) { return cluster_max_n(); }

// The cyclic terminator search: N walkers from row n, walker i taking
// min(steps[i], n_steps) LF steps on the symbols of the stage view cols
// u8 [L + 2, N] -> pos_out i32 [N].
int msbwt_lf_walk_cyclic(const void* table, const void* starts, const void* cols,
                         const void* lengths, const void* steps, void* pos_out, int64_t N,
                         int64_t n, int n_steps, void* stream) {
  WalkArgs a = {};
  a.table = (const int32_t*)table;
  a.starts = (const int32_t*)starts;
  a.cols = (const uint8_t*)cols;
  a.lengths = (const int32_t*)lengths;
  a.steps = (const int32_t*)steps;
  a.pos_out = (int32_t*)pos_out;
  a.n_walkers = N;
  a.n = n;
  a.limit = n_steps;
  return launch_walk<kCyclic>(a, (cudaStream_t)stream);
}

// String lengths: one walker from each '$' rotation 0..n_strings-1 of a
// BWT of n symbols -> lengths_out i32 [n_strings]; flag i32 [1] set to 1
// when a walk did not meet '$' within n steps. lf i32 [ceil(n / 128) * 128]
// (16 B-aligned) is the caller's scratch for the LF array.
int msbwt_lf_walk_lengths(const void* table, const void* starts, void* lf, void* lengths_out,
                          void* flag, int64_t n_strings, int64_t n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t rows = (n + kBinMask) >> kBinShift;
  const int64_t lanes = (rows << kBinShift) / kLfPerLane;
  if (rows > 0)
    lf_array_kernel<<<(unsigned)((lanes + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        (const int32_t*)table, (const int32_t*)starts, (int32_t*)lf, (int32_t*)flag, rows);
  if (n_strings > 0)
    lf_chase_lengths_kernel
        <<<(unsigned)((n_strings + kChase * kThreads - 1) / (kChase * kThreads)), kThreads, 0,
           st>>>((const int32_t*)lf, (const int32_t*)starts, (int32_t*)lengths_out,
                 (int32_t*)flag, n_strings, n);
  return (int)cudaGetLastError();
}

// Read recovery: B walkers from rows ids i32 [B] -> out u8 [B, l_max]
// (zero-filled by the caller; the read right-aligned), done bool [B].
int msbwt_lf_walk_extract(const void* table, const void* starts, const void* ids, void* out,
                          void* done, int64_t B, int l_max, void* stream) {
  WalkArgs a = {};
  a.table = (const int32_t*)table;
  a.starts = (const int32_t*)starts;
  a.pos_in = (const int32_t*)ids;
  a.sym_out = (uint8_t*)out;
  a.done_out = (uint8_t*)done;
  a.n_walkers = B;
  a.limit = l_max;
  return launch_walk<kExtract>(a, (cudaStream_t)stream);
}

// Locate: H walkers from rows pos i32 [H] of a BWT bwt u8 [n] until a row
// below n_strings, at most l_max + 1 steps -> rid i32 [H] (the row
// reached), off i32 [H] (steps taken - 1).
int msbwt_lf_walk_locate(const void* table, const void* starts, const void* bwt, const void* pos,
                         void* rid, void* off, int64_t H, int64_t n_strings, int l_max,
                         void* stream) {
  WalkArgs a = {};
  a.table = (const int32_t*)table;
  a.starts = (const int32_t*)starts;
  a.bwt = (const uint8_t*)bwt;
  a.pos_in = (const int32_t*)pos;
  a.pos_out = (int32_t*)rid;
  a.aux_out = (int32_t*)off;
  a.n_walkers = H;
  a.n_strings = n_strings;
  a.limit = l_max;
  if (H > 0)
    lf_locate_kernel<<<(unsigned)((H + kThreads - 1) / kThreads), kThreads, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
