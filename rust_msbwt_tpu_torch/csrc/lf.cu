// LF steps over the packed rank table, for Hopper (sm_90a): the BCR stage
// step (lf_stage) and the batched LF walks (lf_walk).
//
// The JAX package has no Pallas kernel for these: it runs them as XLA
// fusions inside one compiled program. What they replace there:
//   lf_stage  rust_msbwt_tpu/ops/bcr.py::_pallas_stage_step (:444): the
//             rank _pallas_rank_table (:396), the C array _cvec (:471),
//             the slot, the carry updates and _bump_counts (:434) of one
//             BCR column;
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
// its three bit planes). Each walk's form is the fastest of those that
// tools/walk_forms.py times at the paths' shapes on an H100 (PERF.md):
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
//   and the file keeps no state of its own across launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rank.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStageBlocks = 4096;  // lf_stage grid cap (grid-stride loop)
constexpr int kQuad = 4;               // lanes a walker
constexpr int kLfPerLane = 4;          // LF pass: positions a lane (one int4 store)

constexpr int kStageScratch = 8;       // lf_stage scratch: six counts, the ticket, a pad
static_assert(kSyms + 1 <= kStageScratch, "lf_stage's scratch holds the counts and the ticket");

enum WalkMode { kCyclic, kExtract };
constexpr int kChase = 2;              // read-length walk: walkers a thread

// The column's C array into s_c (C[0] = 0, C[f >= 1] = nst +
// counts[1..f-1]) and s_bump zeroed. Every thread of the block calls it.
__device__ __forceinline__ void stage_setup(int* s_c, int* s_bump,
                                            const int32_t* __restrict__ counts, int nst) {
  if (threadIdx.x < kSyms) {
    int c = 0;
    if (threadIdx.x > 0) {
      c = nst;
      for (int s = 1; s < (int)threadIdx.x; ++s) c += counts[s];
    }
    s_c[threadIdx.x] = c;
    s_bump[threadIdx.x] = 0;
  }
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

// The read-length walk on the LF array, W walkers a thread (walkers
// thread + b * threads for b < W: W loads in flight a thread, and every
// walker of a long-read set resident at once): walker i from '$' rotation i
// until LF(pos) < C[1] (the symbol at pos is '$'), at most n steps; its
// steps are the string's length. A walk that does not close sets the flag.
template <int W>
__global__ void __launch_bounds__(kThreads)
lf_chase_lengths_kernel(const int32_t* __restrict__ lf, const int32_t* __restrict__ starts,
                        int32_t* __restrict__ lengths_out, int32_t* __restrict__ flag,
                        int64_t n_strings, int64_t n) {
  const int64_t t0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int dollars = __ldg(starts + 1);
  int pos[W];
  int64_t len[W];
  bool live[W], closed[W];
#pragma unroll
  for (int b = 0; b < W; ++b) {
    const int64_t i = t0 + b * stride;
    pos[b] = (int)i;
    len[b] = 0;
    closed[b] = false;
    live[b] = i < n_strings && n > 0;
  }
  for (bool any = true; any;) {
    int next[W];
#pragma unroll
    for (int b = 0; b < W; ++b) next[b] = live[b] ? __ldg(lf + pos[b]) : 0;
    any = false;
#pragma unroll
    for (int b = 0; b < W; ++b) {
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
  for (int b = 0; b < W; ++b) {
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
    lf_chase_lengths_kernel<kChase>
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
