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
//             (:93): batched LF walks, each run to its end in one launch.
// Before these kernels the port ran the same math as eager torch ops, tens
// of kernels and host launches a column or a walk step ([N, 32] row
// gathers, int64 SWAR popcounts, masks and wheres).
//
// The table layout and the rank (rank_at, shared by both kernels and by
// query.cu) are in rank.cuh. rank_at's five 16 B loads depend on the
// position alone, so a walk step issues them together with its symbol load.
//
// What bounds them: memory. lf_stage moves ~116 B a read (96 B of row, the
// carry in and out) for ~40 integer operations. A walk step reads a random
// row (and, for the bwt-sourced walks, a random symbol): each walker is a
// chain of dependent DRAM round trips, hidden only by keeping many walkers
// in flight, one thread a walker with its position in a register.
// This is the first form: no shared-memory staging, TMA or wgmma.
//
// lf_stage's symbol counts: each warp counts its active reads by symbol
// with six ballots, each block adds its warp totals in shared memory and
// then into counts_out with six atomics. counts_out is a buffer apart from
// counts (zeroed by the launcher; block 0 adds the input counts), so no
// block reads counts that another is adding into; a grid-stride loop keeps
// the grid, and the atomics, to at most kMaxStageBlocks blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rank.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStageBlocks = 4096;  // lf_stage grid cap (grid-stride loop)

enum WalkMode { kCyclic = 0, kLengths = 1, kExtract = 2, kLocate = 3 };

// One BCR column j for N reads: f = prev_v, q = C[f] + rank(f, P), active =
// j <= len + 1; P and prev_v move to (q, v) where active; counts_out =
// counts + the active v's. C[0] = 0, C[f >= 1] = nst + counts[1..f-1].
__global__ void __launch_bounds__(kThreads)
lf_stage_kernel(const int32_t* __restrict__ table, const uint8_t* __restrict__ v,
                const int32_t* __restrict__ lengths, const int32_t* __restrict__ P,
                const uint8_t* __restrict__ prev_v, const int32_t* __restrict__ counts,
                int32_t* __restrict__ q, uint8_t* __restrict__ active,
                int32_t* __restrict__ P_out, uint8_t* __restrict__ prev_out,
                int32_t* __restrict__ counts_out, int64_t N, int j, int nst) {
  __shared__ int s_c[kSyms];
  __shared__ int s_bump[kSyms];
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
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int s = 0; s < kSyms; ++s)
      if (acc[s]) atomicAdd(&s_bump[s], acc[s]);
  }
  __syncthreads();
  if (threadIdx.x < kSyms) {
    const int add = s_bump[threadIdx.x] + (blockIdx.x == 0 ? counts[threadIdx.x] : 0);
    if (add) atomicAdd(counts_out + threadIdx.x, add);
  }
}

struct WalkArgs {
  const int32_t* table;
  const int32_t* starts;   // [7]: C array of the index
  const uint8_t* bwt;      // kLengths, kExtract, kLocate: the symbols
  const uint8_t* cols;     // kCyclic: the stage view [L + 2, n_walkers]
  const int32_t* lengths;  // kCyclic: read lengths
  const int32_t* steps;    // kCyclic: steps of each walker
  const int32_t* pos_in;   // kExtract: row ids; kLocate: start rows
  int32_t* pos_out;        // kCyclic: end rows; kLengths: lengths; kLocate: read ids
  int32_t* aux_out;        // kLengths: flag (1: a walk did not close); kLocate: offsets
  uint8_t* sym_out;        // kExtract: [n_walkers, l_max], zero-filled by the caller
  uint8_t* done_out;       // kExtract: the walk met its '$'
  int64_t n_walkers;
  int64_t n;               // kCyclic: start row (the base's n); kLengths: step bound
  int64_t n_strings;       // kLocate: rows below it are '$' rotations
  int limit;               // kCyclic: the loop bound n_steps; kExtract, kLocate: l_max
};

// One thread a walker, its position in a register from start to end.
template <int kMode>
__global__ void __launch_bounds__(kThreads) lf_walk_kernel(const WalkArgs a) {
  __shared__ int s_starts[kStarts];
  if (threadIdx.x < kStarts) s_starts[threadIdx.x] = a.starts[threadIdx.x];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_walkers) return;
  if (kMode == kCyclic) {
    // step t reads cycle index t mod (len + 1) of '$' + S right to left:
    // stage-view row (t mod (len + 1)) + 1
    const int m = a.lengths[i] + 1;
    const int lim = min(a.steps[i], a.limit);
    int pos = (int)a.n;
    int k = 0;
    for (int t = 0; t < lim; ++t) {
      const int sym = a.cols[(int64_t)(k + 1) * a.n_walkers + i];
      pos = s_starts[sym] + rank_at(a.table, sym, pos);
      if (++k == m) k = 0;
    }
    a.pos_out[i] = pos;
  } else if (kMode == kLengths) {
    // from '$' rotation i until the walk meets '$': the string's length
    int pos = (int)i;
    int64_t len = 0;
    bool closed = false;
    for (; len < a.n; ++len) {
      const int sym = a.bwt[pos];
      if (sym == 0) {
        closed = true;
        break;
      }
      pos = s_starts[sym] + rank_at(a.table, sym, pos);
    }
    a.pos_out[i] = (int32_t)len;
    if (!closed) a.aux_out[0] = 1;
  } else if (kMode == kExtract) {
    // the read right-aligned: the symbol of step t at column l_max - 1 - t
    // (clamped at 0: the last of l_max + 1 steps only looks for the '$')
    const int l_max = a.limit;
    uint8_t* out = a.sym_out + i * l_max;
    int pos = a.pos_in[i];
    bool done = false;
    for (int t = 0; t <= l_max; ++t) {
      const int sym = a.bwt[pos];
      if (sym == 0) {
        done = true;
        break;
      }
      out[max(l_max - 1 - t, 0)] = (uint8_t)sym;
      pos = s_starts[sym] + rank_at(a.table, sym, pos);
    }
    a.done_out[i] = done;
  } else {  // kLocate: walk until the terminator block, at most l_max + 1 steps
    int pos = a.pos_in[i];
    int steps = 0;
    for (int t = 0; t <= a.limit && pos >= a.n_strings; ++t, ++steps) {
      const int sym = a.bwt[pos];
      pos = s_starts[sym] + rank_at(a.table, sym, pos);
    }
    a.pos_out[i] = pos;
    a.aux_out[i] = steps - 1;
  }
}

template <int kMode>
int launch_walk(const WalkArgs& a, cudaStream_t st) {
  if (a.n_walkers > 0) {
    const unsigned blocks = (unsigned)((a.n_walkers + kThreads - 1) / kThreads);
    lf_walk_kernel<kMode><<<blocks, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One BCR column: table i32 [rows, 32] (16 B-aligned), v = stage-view row j
// u8 [N], lengths i32 [N], P i32 [N], prev_v u8 [N], counts i32 [6] ->
// q i32 [N], active bool [N], P_out i32 [N], prev_out u8 [N], counts_out
// i32 [6] (apart from counts). Launches on `stream`; returns
// cudaGetLastError().
int msbwt_lf_stage(const void* table, const void* v, const void* lengths, const void* P,
                   const void* prev_v, const void* counts, void* q, void* active, void* P_out,
                   void* prev_out, void* counts_out, int64_t N, int j, int nst, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 0) {
    cudaMemcpyAsync(counts_out, counts, kSyms * sizeof(int32_t), cudaMemcpyDeviceToDevice, st);
    return (int)cudaGetLastError();
  }
  cudaMemsetAsync(counts_out, 0, kSyms * sizeof(int32_t), st);
  int64_t blocks = (N + kThreads - 1) / kThreads;
  if (blocks > kMaxStageBlocks) blocks = kMaxStageBlocks;
  lf_stage_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const int32_t*)table, (const uint8_t*)v, (const int32_t*)lengths, (const int32_t*)P,
      (const uint8_t*)prev_v, (const int32_t*)counts, (int32_t*)q, (uint8_t*)active,
      (int32_t*)P_out, (uint8_t*)prev_out, (int32_t*)counts_out, N, j, nst);
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
// when a walk did not meet '$' within n steps.
int msbwt_lf_walk_lengths(const void* table, const void* starts, const void* bwt,
                          void* lengths_out, void* flag, int64_t n_strings, int64_t n,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(flag, 0, sizeof(int32_t), st);
  WalkArgs a = {};
  a.table = (const int32_t*)table;
  a.starts = (const int32_t*)starts;
  a.bwt = (const uint8_t*)bwt;
  a.pos_out = (int32_t*)lengths_out;
  a.aux_out = (int32_t*)flag;
  a.n_walkers = n_strings;
  a.n = n;
  return launch_walk<kLengths>(a, st);
}

// Read recovery: B walkers from rows ids i32 [B] -> out u8 [B, l_max]
// (zero-filled by the caller; the read right-aligned), done bool [B].
int msbwt_lf_walk_extract(const void* table, const void* starts, const void* bwt,
                          const void* ids, void* out, void* done, int64_t B, int l_max,
                          void* stream) {
  WalkArgs a = {};
  a.table = (const int32_t*)table;
  a.starts = (const int32_t*)starts;
  a.bwt = (const uint8_t*)bwt;
  a.pos_in = (const int32_t*)ids;
  a.sym_out = (uint8_t*)out;
  a.done_out = (uint8_t*)done;
  a.n_walkers = B;
  a.limit = l_max;
  return launch_walk<kExtract>(a, (cudaStream_t)stream);
}

// Locate: H walkers from rows pos i32 [H] until a row below n_strings, at
// most l_max + 1 steps -> rid i32 [H] (the row reached), off i32 [H] (steps
// taken - 1).
int msbwt_lf_walk_locate(const void* table, const void* starts, const void* bwt,
                         const void* pos, void* rid, void* off, int64_t H, int64_t n_strings,
                         int l_max, void* stream) {
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
  return launch_walk<kLocate>(a, (cudaStream_t)stream);
}

}  // extern "C"
