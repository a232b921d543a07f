// The candidate forms of the LF-step kernels, for tools/walk_forms.py: the
// package's kernels (csrc/lf.cu, included whole) and the forms tried beside
// them:
//   thread  one thread a walker (the parent's form), each step's five row
//           loads issued together and the symbol taken from the row's planes
//           (no BWT read); the cyclic walk, whose symbol comes from the stage
//           view, loads that symbol's occurrence piece and the planes (four
//           loads). Every walk.
//   quad    the read-length walk on the row (no LF array): a quad a walker,
//           the symbol from the planes, as the package's extract walk.
//   quad2   two walkers a quad, both rows' loads issued before either is
//           used (the cyclic, extract and locate walks).
//   passW   the read-length walk's first LF pass (each lane ranks its four
//           positions off the row, no scan), then W walkers a thread.
//   scanW   the package's LF pass (the warp scan), then W walkers a thread
//           (the package chases with 2).
//   locate  a quad a walker (the first form), two walkers a quad, and one
//           thread a walker through row_step (the symbol from the planes,
//           the match words from the planes' own bits at r, C + the row's
//           count in one select over registers); the package reads the
//           symbol from the BWT.
//   stage   lf_stage with a quad a read (lane 0 the occurrence piece of
//           prev_v, lanes 1..3 the planes), or R reads a thread (R = 2, 4:
//           every read's loads issued before any is used); the package's
//           counts epilogue.

#include "../rust_msbwt_tpu_torch/csrc/lf.cu"

namespace {

enum FormMode { kFormCyclic, kFormLengths, kFormExtract, kFormLocate };

// The symbol at in-bin position r (0..127): bit r % 32 of word r / 32 of
// the three planes (7, PAD, past n).
__device__ __forceinline__ int row_symbol(const int4& p0, const int4& p1, const int4& p2,
                                          int r) {
  const int w = r >> 5, b = r & 31;
  return (((unsigned)lane_of4(p0, w) >> b) & 1) | ((((unsigned)lane_of4(p1, w) >> b) & 1) << 1)
         | ((((unsigned)lane_of4(p2, w) >> b) & 1) << 2);
}

// One thread's LF step: {the symbol at pos (from the planes), LF(pos)}.
__device__ __forceinline__ int2 thread_step(const int32_t* __restrict__ table,
                                            const int* s_starts, int pos) {
  const int4* row = reinterpret_cast<const int4*>(table + (int64_t)(pos >> kBinShift) * kRow);
  const int4 o0 = __ldg(row), o1 = __ldg(row + 1);
  const int4 p0 = __ldg(row + 2), p1 = __ldg(row + 3), p2 = __ldg(row + 4);
  const int r = pos & kBinMask;
  const int sym = row_symbol(p0, p1, p2, r);
  return make_int2(sym, s_starts[sym] + row_rank(o0, o1, p0, p1, p2, sym, r));
}

// One thread's LF step on a known symbol: its occurrence piece and the
// planes (row_rank reads the piece as both halves).
__device__ __forceinline__ int known_step(const int32_t* __restrict__ table,
                                          const int* s_starts, int pos, int sym) {
  const int4* row = reinterpret_cast<const int4*>(table + (int64_t)(pos >> kBinShift) * kRow);
  const int4 o = __ldg(row + (sym >> 2));
  const int4 p0 = __ldg(row + 2), p1 = __ldg(row + 3), p2 = __ldg(row + 4);
  return s_starts[sym] + row_rank(o, o, p0, p1, p2, sym, pos & kBinMask);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) thread_walk_kernel(const WalkArgs a) {
  __shared__ int s_starts[8];
  if (threadIdx.x < 8) s_starts[threadIdx.x] = threadIdx.x < kStarts ? a.starts[threadIdx.x] : 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_walkers) return;
  if (kMode == kFormCyclic) {
    const int m = a.lengths[i] + 1;
    const int lim = min(a.steps[i], a.limit);
    int pos = (int)a.n;
    int k = 0;
    for (int t = 0; t < lim; ++t) {
      pos = known_step(a.table, s_starts, pos, a.cols[(int64_t)(k + 1) * a.n_walkers + i]);
      if (++k == m) k = 0;
    }
    a.pos_out[i] = pos;
  } else if (kMode == kFormLengths) {
    int pos = (int)i;
    int64_t len = 0;
    bool closed = false;
    for (; len < a.n; ++len) {
      const int2 s = thread_step(a.table, s_starts, pos);
      if (s.x == 0) {
        closed = true;
        break;
      }
      pos = s.y;
    }
    a.pos_out[i] = (int32_t)len;
    if (!closed) a.aux_out[0] = 1;
  } else if (kMode == kFormExtract) {
    const int l_max = a.limit;
    uint8_t* out = a.sym_out + i * l_max;
    int pos = a.pos_in[i];
    bool done = false;
    for (int t = 0; t <= l_max; ++t) {
      const int2 s = thread_step(a.table, s_starts, pos);
      if (s.x == 0) {
        done = true;
        break;
      }
      out[max(l_max - 1 - t, 0)] = (uint8_t)s.x;
      pos = s.y;
    }
    a.done_out[i] = done;
  } else {
    int pos = a.pos_in[i];
    int steps = 0;
    for (int t = 0; t <= a.limit && pos >= a.n_strings; ++t, ++steps)
      pos = thread_step(a.table, s_starts, pos).y;
    a.pos_out[i] = pos;
    a.aux_out[i] = steps - 1;
  }
}

// The read-length walk on the row, a quad a walker.
__global__ void __launch_bounds__(kThreads) quad_lengths_kernel(const WalkArgs a) {
  __shared__ int s_starts[8];
  if (threadIdx.x < 8) s_starts[threadIdx.x] = threadIdx.x < kStarts ? a.starts[threadIdx.x] : 0;
  __syncthreads();
  const QuadLane l = quad_lane();
  const int64_t i = l.walker;
  const bool valid = i < a.n_walkers;
  int pos = (int)i;
  int64_t len = 0;
  bool live = valid && a.n > 0, closed = false;
  while (__any_sync(kFull, live)) {
    const int2 s = quad_step<false>(a.table, s_starts, pos, 0, live, l);
    if (live) {
      if (s.x == 0) {
        closed = true;
        live = false;
      } else {
        pos = s.y;
        live = ++len < a.n;
      }
    }
  }
  if (valid && l.j == 0) {
    a.pos_out[i] = (int32_t)len;
    if (!closed) a.aux_out[0] = 1;
  }
}

// lf_stage with a quad a read, in a grid-stride loop.
__global__ void __launch_bounds__(kThreads)
stage_quad_kernel(const int32_t* __restrict__ table, const uint8_t* __restrict__ v,
                  const int32_t* __restrict__ lengths, const int32_t* __restrict__ P,
                  const uint8_t* __restrict__ prev_v, const int32_t* __restrict__ counts,
                  int32_t* __restrict__ q, uint8_t* __restrict__ active,
                  int32_t* __restrict__ P_out, uint8_t* __restrict__ prev_out,
                  int32_t* __restrict__ counts_out, int32_t* __restrict__ scratch,
                  int64_t N, int j, int nst) {
  __shared__ int s_c[kSyms];
  __shared__ int s_bump[kSyms];
  stage_setup(s_c, s_bump, counts, nst);
  const QuadLane l = quad_lane();
  constexpr int kReads = kThreads / kQuad;
  int acc[kSyms] = {0, 0, 0, 0, 0, 0};
  for (int64_t base = (int64_t)blockIdx.x * kReads; base < N; base += (int64_t)gridDim.x * kReads) {
    const int64_t i = base + threadIdx.x / kQuad;
    const bool in = i < N;
    int f = 0, p = 0, vv = 0;
    bool act = false;
    if (in) {
      f = prev_v[i];
      p = P[i];
      vv = v[i];
      act = j <= lengths[i] + 1;
    }
    const int qq = quad_step<true>(table, s_c, p, f, in, l).y;
    int sym = -1;
    if (in && l.j == 0) {
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

// Two walkers a quad: walkers 2w and 2w + 1 of quad w, both rows' loads
// issued before either is used.
template <int kMode>
__global__ void __launch_bounds__(kThreads) quad2_walk_kernel(const WalkArgs a) {
  constexpr bool kKnown = kMode == kFormCyclic;
  __shared__ int s_starts[8];
  if (threadIdx.x < 8) s_starts[threadIdx.x] = threadIdx.x < kStarts ? a.starts[threadIdx.x] : 0;
  __syncthreads();
  const QuadLane l = quad_lane();
  int64_t w[2];
  bool valid[2], live[2], done[2];
  int pos[2], k[2], m[2], lim[2], steps[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    w[c] = 2 * l.walker + c;
    valid[c] = w[c] < a.n_walkers;
    done[c] = false;
    k[c] = steps[c] = 0;
    m[c] = 1;
    lim[c] = 0;
    if (kMode == kFormCyclic) {
      pos[c] = (int)a.n;
      if (valid[c]) {
        m[c] = a.lengths[w[c]] + 1;
        lim[c] = min(a.steps[w[c]], a.limit);
      }
      live[c] = lim[c] > 0;
    } else {
      pos[c] = valid[c] ? a.pos_in[w[c]] : 0;
      live[c] = valid[c] && (kMode == kFormExtract || pos[c] >= a.n_strings);
    }
  }
  for (int t = 0; __any_sync(kFull, live[0] || live[1]); ++t) {
    QuadRow q[2];
    int sym[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      sym[c] = kKnown && live[c] ? a.cols[(int64_t)(k[c] + 1) * a.n_walkers + w[c]] : 0;
      q[c] = quad_load<kKnown>(a.table, pos[c], sym[c], live[c], l);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int2 s = quad_finish<kKnown>(q[c], s_starts, pos[c], sym[c], l);
      if (!live[c]) continue;
      if (kMode == kFormCyclic) {
        pos[c] = s.y;
        if (++k[c] == m[c]) k[c] = 0;
        live[c] = t + 1 < lim[c];
      } else if (kMode == kFormExtract) {
        if (s.x == 0) {
          done[c] = true;
          live[c] = false;
        } else {
          if (l.j == 0) a.sym_out[w[c] * a.limit + max(a.limit - 1 - t, 0)] = (uint8_t)s.x;
          pos[c] = s.y;
          live[c] = t < a.limit;
        }
      } else {
        pos[c] = s.y;
        ++steps[c];
        live[c] = t < a.limit && pos[c] >= a.n_strings;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (!valid[c] || l.j != 0) continue;
    if (kMode == kFormCyclic) {
      a.pos_out[w[c]] = pos[c];
    } else if (kMode == kFormExtract) {
      a.done_out[w[c]] = done[c];
    } else {
      a.pos_out[w[c]] = pos[c];
      a.aux_out[w[c]] = steps[c] - 1;
    }
  }
}

// The read-length walk's first LF pass: each lane ranks its four
// positions with row_symbol and row_rank, no scan.
__global__ void __launch_bounds__(kThreads)
lf_array_rank_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ starts,
                     int32_t* __restrict__ lf, int32_t* __restrict__ flag, int64_t rows) {
  __shared__ int s_starts[8];
  if (threadIdx.x < 8) s_starts[threadIdx.x] = threadIdx.x < kStarts ? starts[threadIdx.x] : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *flag = 0;
  __syncthreads();
  const int64_t p0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kLfPerLane;
  if (p0 >= rows << kBinShift) return;
  const int4* row = reinterpret_cast<const int4*>(table + (p0 >> kBinShift) * kRow);
  const int4 o0 = __ldg(row), o1 = __ldg(row + 1);
  const int4 p0w = __ldg(row + 2), p1w = __ldg(row + 3), p2w = __ldg(row + 4);
  int out[kLfPerLane];
#pragma unroll
  for (int k = 0; k < kLfPerLane; ++k) {
    const int r = (int)(p0 & kBinMask) + k;
    const int f = row_symbol(p0w, p1w, p2w, r);
    out[k] = s_starts[f] + row_rank(o0, o1, p0w, p1w, p2w, f, r);
  }
  *reinterpret_cast<int4*>(lf + p0) = make_int4(out[0], out[1], out[2], out[3]);
}

// The locate walk's first form, a quad a walker, the symbol
// decoded from the planes with a ballot.
__global__ void __launch_bounds__(kThreads) quad_locate_kernel(const WalkArgs a) {
  __shared__ int s_starts[8];
  if (threadIdx.x < 8) s_starts[threadIdx.x] = threadIdx.x < kStarts ? a.starts[threadIdx.x] : 0;
  __syncthreads();
  const QuadLane l = quad_lane();
  const int64_t i = l.walker;
  const bool valid = i < a.n_walkers;
  int pos = valid ? a.pos_in[i] : 0;
  int steps = 0;
  bool live = valid && a.limit >= 0 && pos >= a.n_strings;
  for (int t = 0; __any_sync(kFull, live); ++t) {
    const int next = quad_step<false>(a.table, s_starts, pos, 0, live, l).y;
    if (live) {
      pos = next;
      ++steps;
      live = t < a.limit && pos >= a.n_strings;
    }
  }
  if (valid && l.j == 0) {
    a.pos_out[i] = pos;
    a.aux_out[i] = steps - 1;
  }
}

// lf_stage with R reads a thread (reads base + threadIdx.x + r * kThreads).
template <int R>
__global__ void __launch_bounds__(kThreads)
stage_multi_kernel(const int32_t* __restrict__ table, const uint8_t* __restrict__ v,
                   const int32_t* __restrict__ lengths, const int32_t* __restrict__ P,
                   const uint8_t* __restrict__ prev_v, const int32_t* __restrict__ counts,
                   int32_t* __restrict__ q, uint8_t* __restrict__ active,
                   int32_t* __restrict__ P_out, uint8_t* __restrict__ prev_out,
                   int32_t* __restrict__ counts_out, int32_t* __restrict__ scratch,
                   int64_t N, int j, int nst) {
  __shared__ int s_c[kSyms];
  __shared__ int s_bump[kSyms];
  stage_setup(s_c, s_bump, counts, nst);
  int acc[kSyms] = {0, 0, 0, 0, 0, 0};
  for (int64_t base = (int64_t)blockIdx.x * kThreads * R; base < N;
       base += (int64_t)gridDim.x * kThreads * R) {
    int f[R], p[R], vv[R], qq[R];
    bool in[R], act[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t i = base + threadIdx.x + r * kThreads;
      in[r] = i < N;
      f[r] = in[r] ? prev_v[i] : 0;
      p[r] = in[r] ? P[i] : 0;
      vv[r] = in[r] ? v[i] : 0;
      act[r] = in[r] && j <= lengths[i] + 1;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) qq[r] = s_c[f[r]] + rank_at(table, f[r], p[r]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t i = base + threadIdx.x + r * kThreads;
      int sym = -1;
      if (in[r]) {
        q[i] = qq[r];
        active[i] = act[r];
        P_out[i] = act[r] ? qq[r] : p[r];
        prev_out[i] = (uint8_t)(act[r] ? vv[r] : f[r]);
        if (act[r]) sym = vv[r];
      }
#pragma unroll
      for (int s = 0; s < kSyms; ++s) acc[s] += __popc(__ballot_sync(kFull, sym == s));
    }
  }
  add_stage_counts(acc, s_bump, counts, counts_out, scratch);
}

// One thread's LF step off the row pieces of pos, the symbol from the
// planes: the in-bin match words are taken against the planes' own bits at
// r (no symbol needed), and C[sym] + the row's count of sym is one select
// over registers, so only that select waits on the symbol. c: the C array.
__device__ __forceinline__ int2 row_step(const int4& o0, const int4& o1, const int4& p0,
                                         const int4& p1, const int4& p2, const int (&c)[kSyms],
                                         int r) {
  const int w = r >> 5, b = r & 31;
  const unsigned b0 = ((unsigned)lane_of4(p0, w) >> b) & 1u;
  const unsigned b1 = ((unsigned)lane_of4(p1, w) >> b) & 1u;
  const unsigned b2 = ((unsigned)lane_of4(p2, w) >> b) & 1u;
  const unsigned s0 = 0u - b0, s1 = 0u - b1, s2 = 0u - b2;
#define MATCH(x) (~((unsigned)p0.x ^ s0) & ~((unsigned)p1.x ^ s1) & ~((unsigned)p2.x ^ s2))
  const int in_bin = below(MATCH(x), r, 0) + below(MATCH(y), r, 1) + below(MATCH(z), r, 2)
                     + below(MATCH(w), r, 3);
#undef MATCH
  const int sym = (int)(b0 | (b1 << 1) | (b2 << 2));
  const int base = sym == 0 ? c[0] + o0.x : sym == 1 ? c[1] + o0.y : sym == 2 ? c[2] + o0.z
                 : sym == 3 ? c[3] + o0.w : sym == 4 ? c[4] + o1.x : c[5] + o1.y;
  return make_int2(sym, base + in_bin);
}

// The locate walk, one thread a walker, the symbol from the planes through
// row_step (the C array in registers).
__global__ void __launch_bounds__(kThreads) row_locate_kernel(const WalkArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_walkers) return;
  int c[kSyms];
#pragma unroll
  for (int s = 0; s < kSyms; ++s) c[s] = __ldg(a.starts + s);
  int pos = a.pos_in[i];
  int steps = 0;
  for (int t = 0; t <= a.limit && pos >= a.n_strings; ++t, ++steps) {
    const int4* row = reinterpret_cast<const int4*>(a.table + (int64_t)(pos >> kBinShift) * kRow);
    pos = row_step(__ldg(row), __ldg(row + 1), __ldg(row + 2), __ldg(row + 3), __ldg(row + 4),
                   c, pos & kBinMask).y;
  }
  a.pos_out[i] = pos;
  a.aux_out[i] = steps - 1;
}

int walk_form(int mode, int form, const WalkArgs& a, cudaStream_t st) {
  if (a.n_walkers > 0) {
    // form 1: a quad a walker; 2: two walkers a quad (four lanes a pair)
    const int64_t lanes = form == 1 ? a.n_walkers * kQuad
                          : form == 2 ? (a.n_walkers + 1) / 2 * kQuad : a.n_walkers;
    const unsigned blocks = (unsigned)((lanes + kThreads - 1) / kThreads);
    if (form == 1 && mode == kFormLocate) {
      quad_locate_kernel<<<blocks, kThreads, 0, st>>>(a);
    } else if (form == 1) {
      quad_lengths_kernel<<<blocks, kThreads, 0, st>>>(a);
    } else if (form == 2) {
      if (mode == kFormCyclic) quad2_walk_kernel<kFormCyclic><<<blocks, kThreads, 0, st>>>(a);
      if (mode == kFormExtract) quad2_walk_kernel<kFormExtract><<<blocks, kThreads, 0, st>>>(a);
      if (mode == kFormLocate) quad2_walk_kernel<kFormLocate><<<blocks, kThreads, 0, st>>>(a);
    } else if (mode == kFormCyclic) {
      thread_walk_kernel<kFormCyclic><<<blocks, kThreads, 0, st>>>(a);
    } else if (mode == kFormLengths) {
      thread_walk_kernel<kFormLengths><<<blocks, kThreads, 0, st>>>(a);
    } else if (mode == kFormExtract) {
      thread_walk_kernel<kFormExtract><<<blocks, kThreads, 0, st>>>(a);
    } else {
      thread_walk_kernel<kFormLocate><<<blocks, kThreads, 0, st>>>(a);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// form 0: one thread a walker (the symbol from the row); 1 (locate): a
// quad a walker; 2: two walkers a quad; 3 (locate): one thread a walker
// through row_step. The arguments are the package's C entry points'.
int forms_walk_cyclic(int form, const void* table, const void* starts, const void* cols,
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
  return walk_form(kFormCyclic, form, a, (cudaStream_t)stream);
}

// form 0: one thread a walker, 1: a quad a walker, both on the row; 10 + W:
// the first LF pass (lf_array_rank_kernel), then W walkers a thread; 20 + W:
// the package's LF pass (the scan), then W walkers a thread (W = 1, 2, 4).
// lf: the LF array, as the package's.
int forms_walk_lengths(int form, const void* table, const void* starts, void* lf,
                       void* lengths_out, void* flag, int64_t n_strings, int64_t n,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (form >= 10) {
    const int64_t rows = (n + kBinMask) >> kBinShift;
    const unsigned pass = (unsigned)(((rows << kBinShift) / kLfPerLane + kThreads - 1) / kThreads);
    if (form >= 20)
      lf_array_kernel<<<pass, kThreads, 0, st>>>((const int32_t*)table, (const int32_t*)starts,
                                                 (int32_t*)lf, (int32_t*)flag, rows);
    else
      lf_array_rank_kernel<<<pass, kThreads, 0, st>>>((const int32_t*)table,
                                                      (const int32_t*)starts, (int32_t*)lf,
                                                      (int32_t*)flag, rows);
    const int W = form % 10;
    const unsigned blocks = (unsigned)((n_strings + (int64_t)W * kThreads - 1) / (W * kThreads));
    const int32_t* lfc = (const int32_t*)lf;
    if (W == 1)
      lf_chase_lengths_kernel<1><<<blocks, kThreads, 0, st>>>(
          lfc, (const int32_t*)starts, (int32_t*)lengths_out, (int32_t*)flag, n_strings, n);
    else if (W == 2)
      lf_chase_lengths_kernel<2><<<blocks, kThreads, 0, st>>>(
          lfc, (const int32_t*)starts, (int32_t*)lengths_out, (int32_t*)flag, n_strings, n);
    else
      lf_chase_lengths_kernel<4><<<blocks, kThreads, 0, st>>>(
          lfc, (const int32_t*)starts, (int32_t*)lengths_out, (int32_t*)flag, n_strings, n);
    return (int)cudaGetLastError();
  }
  cudaMemsetAsync(flag, 0, sizeof(int32_t), st);
  WalkArgs a = {};
  a.table = (const int32_t*)table;
  a.starts = (const int32_t*)starts;
  a.pos_out = (int32_t*)lengths_out;
  a.aux_out = (int32_t*)flag;
  a.n_walkers = n_strings;
  a.n = n;
  return walk_form(kFormLengths, form, a, st);
}

int forms_walk_extract(int form, const void* table, const void* starts, const void* ids,
                       void* out, void* done, int64_t B, int l_max, void* stream) {
  WalkArgs a = {};
  a.table = (const int32_t*)table;
  a.starts = (const int32_t*)starts;
  a.pos_in = (const int32_t*)ids;
  a.sym_out = (uint8_t*)out;
  a.done_out = (uint8_t*)done;
  a.n_walkers = B;
  a.limit = l_max;
  return walk_form(kFormExtract, form, a, (cudaStream_t)stream);
}

int forms_walk_locate(int form, const void* table, const void* starts, const void* bwt,
                      const void* pos, void* rid, void* off, int64_t H, int64_t n_strings,
                      int l_max, void* stream) {
  WalkArgs a = {};
  a.table = (const int32_t*)table;
  a.starts = (const int32_t*)starts;
  a.pos_in = (const int32_t*)pos;
  a.pos_out = (int32_t*)rid;
  a.aux_out = (int32_t*)off;
  a.n_walkers = H;
  a.n_strings = n_strings;
  a.limit = l_max;
  a.bwt = (const uint8_t*)bwt;
  if (form == 3) {
    if (H > 0)
      row_locate_kernel<<<(unsigned)((H + kThreads - 1) / kThreads), kThreads, 0,
                          (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  return walk_form(kFormLocate, form, a, (cudaStream_t)stream);
}

// lf_stage, form 1: a quad a read; 2, 4: that many reads a thread. The
// other arguments are msbwt_lf_stage's.
int forms_lf_stage(int form, const void* table, const void* v, const void* lengths,
                   const void* P, const void* prev_v, const void* counts, void* q, void* active,
                   void* P_out, void* prev_out, void* counts_out, void* scratch, int64_t N,
                   int j, int nst, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 0) {
    cudaMemcpyAsync(counts_out, counts, kSyms * sizeof(int32_t), cudaMemcpyDeviceToDevice, st);
    return (int)cudaGetLastError();
  }
  const int64_t per_block = form == 1 ? kThreads / kQuad : (int64_t)kThreads * form;
  int64_t blocks = (N + per_block - 1) / per_block;
  const int64_t cap = form == 1 ? kQuad * kMaxStageBlocks : kMaxStageBlocks;
  if (blocks > cap) blocks = cap;
#define STAGE_ARGS                                                                         \
  (const int32_t*)table, (const uint8_t*)v, (const int32_t*)lengths, (const int32_t*)P,   \
      (const uint8_t*)prev_v, (const int32_t*)counts, (int32_t*)q, (uint8_t*)active,     \
      (int32_t*)P_out, (uint8_t*)prev_out, (int32_t*)counts_out, (int32_t*)scratch, N, j, nst
  if (form == 1)
    stage_quad_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(STAGE_ARGS);
  else if (form == 2)
    stage_multi_kernel<2><<<(unsigned)blocks, kThreads, 0, st>>>(STAGE_ARGS);
  else
    stage_multi_kernel<4><<<(unsigned)blocks, kThreads, 0, st>>>(STAGE_ARGS);
#undef STAGE_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
