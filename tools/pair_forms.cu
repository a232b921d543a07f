// The candidate forms of lf_pair's kernels, for tools/pair_forms.py: the
// package's kernels (csrc/lf.cu, included whole) and the forms tried beside
// them, each a whole lf_pair call:
//   form 0     the package's lf_pair (launch_pair): a memset and four
//              kernels, each tile scan at the start of the rank kernel that
//              reads it, pair_first with no launch bound, pair_rank1 with
//              four blocks an SM (at most 64 registers);
//   form 2-5   the same at other launch bounds: pair_first at four and
//              eight blocks an SM (at most 64, 32 registers), pair_rank1 at
//              one and six (no bound, at most 42);
//   form 1     pair_rank1 with the rows first: once a tile's start is known,
//              each slot loads the pieces of both table rows its old
//              position can lie in (q1 - start and q1 - start - c + 1, c <=
//              128), then runs its compare loop and ranks in the row old_pos
//              falls in;
//   form 6     the tile scans at the end of the counting kernels instead
//              (pair_first and pair_rank1): their last blocks to finish wait
//              for every block and scan (tail_scan), five device events;
//   form 7     the tile scans as two kernels of their own (seven events);
//   form 10+m  pair_rank1 with a quad (four lanes) a slot in its warp path:
//              lane j loads piece j of both candidate rows (the symbol's
//              occurrence piece, then the three planes), the quad splits the
//              compare loop four ways and adds its counts with two
//              shuffles, and quad_rank (rank.cuh) ranks in the row old_pos
//              falls in; m blocks an SM for pair_rank1 (1, 4 or 8).

#include "../rust_msbwt_tpu_torch/csrc/lf.cu"

namespace {

__global__ void __launch_bounds__(kThreads, 4) forms_first4_kernel(const PairArgs a) {
  pair_first_body(a);
}

__global__ void __launch_bounds__(kThreads, 8) forms_first8_kernel(const PairArgs a) {
  pair_first_body(a);
}

// pair_rank1 at kMinBlocks blocks an SM; kHead: the q1 scan at its start.
template <int kMinBlocks, bool kHead>
__global__ void __launch_bounds__(kThreads, kMinBlocks) forms_rank1_kernel(const PairArgs a) {
  pair_rank1_body<kHead>(a);
}

// pair_rank2 with its tiles' prefixes scanned before the launch.
__global__ void __launch_bounds__(kThreads) forms_rank2_scanned_kernel(const PairArgs a) {
  pair_rank2_body<false>(a);
}

// At the end of a counting kernel: the block takes a ticket in the order
// the grid's blocks finish, and the last `tail` blocks wait for every block
// and scan the rows, a chunk each (scan_chunk). Every thread of the block
// calls it.
template <int K, int S, int kIn, int kOut>
__device__ __forceinline__ void tail_scan(int32_t* rows_arr, int64_t rows,
                                          unsigned long long* agg, int32_t* done, int tail) {
  __shared__ int s_ticket;
  __syncthreads();
  if (threadIdx.x == 0) {  // the block's counts before its ticket
    __threadfence();
    s_ticket = atomicAdd(done, 1);
  }
  __syncthreads();
  const int b = s_ticket - ((int)gridDim.x - tail);
  if (b < 0) return;
  if (threadIdx.x == 0)
    while (ld_acquire(done) < (int)gridDim.x) __nanosleep(64);
  __syncthreads();
  scan_chunk<K, S, kIn, kOut>(rows_arr, rows, agg, b, tail);
}

__global__ void __launch_bounds__(kThreads) forms_first_tail_kernel(const PairArgs a) {
  pair_first_body(a);
  tail_scan<kSyms, kRow1, 1, 1>(a.rows1, a.n_tiles + 1, a.agg1, a.ctr + kTicket1, a.chunks);
}

__global__ void __launch_bounds__(kThreads, 4) forms_rank1_tail_kernel(const PairArgs a) {
  __shared__ int s_c[kSyms];
  load_c(s_c, a.counts1, a.nst);
  __syncthreads();
  const Rank1<false> pol{a, buckets1(a), buckets2(a), s_c};
  rank_tiles<kSyms>(pol, a.n_tiles, blockIdx.x, gridDim.x);
  tail_scan<1, kRow2, 0, 1>(a.rows2, a.n_tiles + 1, a.agg2, a.ctr + kTicket2, a.chunks);
}

// The pieces of a table row that a rank of one symbol reads: its
// occurrence piece and the three planes (64 B of the row's 96 B).
struct RowPieces {
  int4 occ, p0, p1, p2;
};

__device__ __forceinline__ RowPieces load_pieces(const int32_t* __restrict__ table, int f,
                                                 int pos) {
  const int4* row = reinterpret_cast<const int4*>(table + (int64_t)(pos >> kBinShift) * kRow);
  return {__ldg(row + (f >> 2)), __ldg(row + kPackedPlane), __ldg(row + kPackedPlane + 1),
          __ldg(row + kPackedPlane + 2)};
}

// rank(f, pos) off the pieces of pos's row, as row_rank.
__device__ __forceinline__ int pieces_rank(const RowPieces& p, int f, int pos) {
  const int occ = lane_of4(p.occ, f & 3);
  const unsigned s0 = 0u - (unsigned)(f & 1);
  const unsigned s1 = 0u - (unsigned)((f >> 1) & 1);
  const unsigned s2 = 0u - (unsigned)((f >> 2) & 1);
  const int r = pos & kBinMask;
#define MATCH(c) (~((unsigned)p.p0.c ^ s0) & ~((unsigned)p.p1.c ^ s1) & ~((unsigned)p.p2.c ^ s2))
  return occ + below(MATCH(x), r, 0) + below(MATCH(y), r, 1) + below(MATCH(z), r, 2) +
         below(MATCH(w), r, 3);
#undef MATCH
}

// q2 of one q1 entry as Rank1::finish, its rank given.
__device__ __forceinline__ void rank1_emit(const Rank1<true>& pol, int64_t t, int2 e, int r,
                                           int same) {
  const PairArgs& a = pol.a;
  const int vv = e.y & 7;
  const int q2 = pol.s_c[vv] + r + __ldcg(a.rows1 + t * kRow1 + 1 + vv) + same;
  if (e.y & 8) {
    a.q[a.N + e.x] = q2;
    const int64_t t2 = pair_tile(q2, a.shift, a.n_tiles);
    if (t2 >= 0) bucket_put(pol.b2, t2, q2);
  }
}

// pair_rank1 with the rows first (form 1): the group's places awaited
// first, then per slot both candidate rows' pieces, the compare loop, the
// rank in the row old_pos falls in.
__global__ void __launch_bounds__(kThreads) forms_rank1_rows_kernel(const PairArgs a) {
  __shared__ int s_c[kSyms];
  __shared__ int s_key[kTileGroup][kWarpSlots];
  __shared__ int s_big[kTileGroup];
  load_c(s_c, a.counts1, a.nst);
  const int block = head_scan<kSyms, kRow1, 1, 1>(a.rows1, a.n_tiles + 1, a.agg1, a.flags1,
                                                  a.ctr + kTicket1, a.chunks);
  if (block < 0) return;
  __syncthreads();
  const Rank1<true> pol{a, buckets1(a), buckets2(a), s_c};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t t0 = (int64_t)block * kTileGroup; t0 < a.n_tiles;
       t0 += (int64_t)(gridDim.x - a.chunks) * kTileGroup) {
    const int64_t t = t0 + warp;
    const int c = t < a.n_tiles ? pol.count(t) : 0;
    if (lane == 0) s_big[warp] = c > kWarpSlots;
    if (threadIdx.x == 0) pol.wait(t0, min64(t0 + kTileGroup, a.n_tiles) - 1);
    __syncthreads();
    if (c <= kWarpSlots) {
      int2 e[kWarpSlots / 32];
      for (int k = 0; k < kWarpSlots / 32; ++k) {
        const int idx = lane + 32 * k;
        if (idx < c) {
          e[k] = pol.entry(t, idx);
          s_key[warp][idx] = e[k].y;
        }
      }
      __syncwarp();
      const int st = c ? pol.start(t) : 0;
      for (int k = 0; k < kWarpSlots / 32; ++k) {
        if (lane + 32 * k >= c) break;
        const int vv = e[k].y & 7;
        const int at = (int)(t << a.shift) + (e[k].y >> 4) - st;
        const int hi = min(max(at, 0), a.cap), lo = min(max(at - c + 1, 0), a.cap);
        const RowPieces ph = load_pieces(a.table, vv, hi);
        const RowPieces pl = (lo >> kBinShift) != (hi >> kBinShift) ? load_pieces(a.table, vv, lo)
                                                                    : ph;
        int all = 0, same = 0;
        for (int m = 0; m < c; ++m) {
          const int o = s_key[warp][m];
          const bool below = (o >> 4) < (e[k].y >> 4);
          all += below;
          same += below && (o & 7) == vv;
        }
        const int old_pos = min(max(at - all, 0), a.cap);
        const bool h = (old_pos >> kBinShift) == (hi >> kBinShift);
        const RowPieces x = {h ? ph.occ : pl.occ, h ? ph.p0 : pl.p0, h ? ph.p1 : pl.p1,
                             h ? ph.p2 : pl.p2};
        rank1_emit(pol, t, e[k], pieces_rank(x, vv, old_pos), same);
      }
    }
    for (int w = 0; w < kTileGroup; ++w)
      if (s_big[w]) rank_big_tile<kSyms>(pol, t0 + w, pol.count(t0 + w));
    __syncthreads();
  }
}

// A tile scan as a kernel of its own, a chunk a block.
template <int K, int S, int kIn, int kOut>
__global__ void __launch_bounds__(kThreads) forms_scan_kernel(int32_t* rows_arr, int64_t rows,
                                                              unsigned long long* agg) {
  scan_chunk<K, S, kIn, kOut>(rows_arr, rows, agg, blockIdx.x, gridDim.x);
}

// pair_rank1's tiles with a quad a slot (the warp path), the head scan and
// the block path as the package's.
template <int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks) forms_rank1_quad_kernel(const PairArgs a) {
  __shared__ int s_c[kSyms];
  __shared__ int2 s_ent[kTileGroup][kWarpSlots];
  __shared__ int s_big[kTileGroup];
  load_c(s_c, a.counts1, a.nst);
  const int block = head_scan<kSyms, kRow1, 1, 1>(a.rows1, a.n_tiles + 1, a.agg1, a.flags1,
                                                  a.ctr + kTicket1, a.chunks);
  if (block < 0) return;
  __syncthreads();
  const Rank1<true> pol{a, buckets1(a), buckets2(a), s_c};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = lane & 3, qd = lane >> 2;
  for (int64_t t0 = (int64_t)block * kTileGroup; t0 < a.n_tiles;
       t0 += (int64_t)(gridDim.x - a.chunks) * kTileGroup) {
    const int64_t t = t0 + warp;
    const int c = t < a.n_tiles ? pol.count(t) : 0;
    if (lane == 0) s_big[warp] = c > kWarpSlots;
    if (threadIdx.x == 0) pol.wait(t0, min64(t0 + kTileGroup, a.n_tiles) - 1);
    __syncthreads();
    if (c <= kWarpSlots) {
      for (int idx = lane; idx < c; idx += 32) s_ent[warp][idx] = pol.entry(t, idx);
      __syncwarp();
      const int st = c ? pol.start(t) : 0;
      for (int base = 0; base < c; base += 8) {  // the same bound for every lane
        const int idx = base + qd;
        const bool live = idx < c;
        const int2 e = live ? s_ent[warp][idx] : make_int2(0, 0);
        const int vv = e.y & 7, key = e.y >> 4;
        const int at = (int)(t << a.shift) + key - st;
        const int hi = min(max(at, 0), a.cap), lo = min(max(at - c + 1, 0), a.cap);
        const int piece = j == 0 ? vv >> 2 : kPackedPlane + j - 1;
        int4 ph = make_int4(0, 0, 0, 0), pl = ph;
        if (live) {
          ph = __ldg(reinterpret_cast<const int4*>(a.table + (int64_t)(hi >> kBinShift) * kRow) +
                     piece);
          pl = (lo >> kBinShift) != (hi >> kBinShift)
                   ? __ldg(reinterpret_cast<const int4*>(a.table +
                                                        (int64_t)(lo >> kBinShift) * kRow) +
                           piece)
                   : ph;
        }
        int all = 0, same = 0;
        for (int m = j; m < c; m += 4) {
          const int o = s_ent[warp][m].y;
          const bool below = (o >> 4) < key;
          all += below;
          same += below && (o & 7) == vv;
        }
        all += __shfl_xor_sync(kFull, all, 1);
        all += __shfl_xor_sync(kFull, all, 2);
        same += __shfl_xor_sync(kFull, same, 1);
        same += __shfl_xor_sync(kFull, same, 2);
        const int old_pos = min(max(at - all, 0), a.cap);
        const int4 v = (old_pos >> kBinShift) == (hi >> kBinShift) ? ph : pl;
        const uint4 x = j == 0 ? ones4() : plane_match(v, 0u - ((vv >> (j - 1)) & 1u));
        const int occ = j == 0 ? lane_of4(v, vv & 3) : 0;
        const int r = quad_rank(x, occ, old_pos & kBinMask, j);
        if (live && j == 0) rank1_emit(pol, t, e, r, same);
      }
    }
    for (int w = 0; w < kTileGroup; ++w)
      if (s_big[w]) rank_big_tile<kSyms>(pol, t0 + w, pol.count(t0 + w));
    __syncthreads();
  }
}

using PairKernel = void (*)(const PairArgs);

// The package's launches with other pair_first and pair_rank1 kernels (each
// rank kernel scanning at its start: a block more a chunk).
void launch_with(PairArgs& a, const PairLayout& l, cudaStream_t st, PairKernel first,
                 PairKernel rank1) {
  const PairGrid g(a);
  cudaMemsetAsync(a.rows1, 0, (l.prim1 - l.rows1) * sizeof(int32_t), st);
  first<<<g.reads, kThreads, 0, st>>>(a);
  rank1<<<g.tiles + a.chunks, kThreads, 0, st>>>(a);
  pair_rank2_kernel<<<g.tiles + a.chunks, kThreads, 0, st>>>(a);
  pair_final_kernel<<<g.reads, kThreads, 0, st>>>(a);
}

void launch_tail(PairArgs& a, const PairLayout& l, cudaStream_t st) {
  const PairGrid g(a);
  a.chunks = scan_chunks(a.n_tiles + 1, g.reads < g.tiles ? g.reads : g.tiles);  // tail blocks
  cudaMemsetAsync(a.rows1, 0, (l.prim1 - l.rows1) * sizeof(int32_t), st);
  forms_first_tail_kernel<<<g.reads, kThreads, 0, st>>>(a);
  forms_rank1_tail_kernel<<<g.tiles, kThreads, 0, st>>>(a);
  forms_rank2_scanned_kernel<<<g.tiles, kThreads, 0, st>>>(a);
  pair_final_kernel<<<g.reads, kThreads, 0, st>>>(a);
}

void launch_scans(PairArgs& a, const PairLayout& l, cudaStream_t st) {
  const PairGrid g(a);
  cudaMemsetAsync(a.rows1, 0, (l.prim1 - l.rows1) * sizeof(int32_t), st);
  pair_first_kernel<<<g.reads, kThreads, 0, st>>>(a);
  forms_scan_kernel<kSyms, kRow1, 1, 1><<<(unsigned)a.chunks, kThreads, 0, st>>>(
      a.rows1, a.n_tiles + 1, a.agg1);
  forms_rank1_kernel<4, false><<<g.tiles, kThreads, 0, st>>>(a);
  forms_scan_kernel<1, kRow2, 0, 1><<<(unsigned)a.chunks, kThreads, 0, st>>>(
      a.rows2, a.n_tiles + 1, a.agg2);
  forms_rank2_scanned_kernel<<<g.tiles, kThreads, 0, st>>>(a);
  pair_final_kernel<<<g.reads, kThreads, 0, st>>>(a);
}


}  // namespace

extern "C" {

// lf_pair through form `form` (the codes above); msbwt_lf_pair's arguments
// and work array.
int forms_lf_pair(int form, const void* table, const void* v1, const void* v2,
                  const void* lengths, const void* P, const void* prev_v, const void* counts,
                  void* q, void* active, void* P_out, void* prev_out, void* counts_out,
                  void* scratch, void* work, int64_t N, int64_t cap, int j, int nst,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 0 || cap < 0 || cap >= (int64_t(1) << 31) || N >= (int64_t(1) << 30))
    return (int)cudaErrorInvalidValue;
  const int shift = pair_shift(N, cap);
  const PairLayout l(N, pair_tiles_of(cap, shift));
  PairArgs a = pair_args(table, v1, v2, lengths, P, prev_v, counts, q, active, P_out, prev_out,
                         counts_out, scratch, work, N, cap, j, nst, shift, l);
  switch (form) {
    case 0: launch_pair(a, l, st); break;
    case 1: launch_with(a, l, st, pair_first_kernel, forms_rank1_rows_kernel); break;
    case 2: launch_with(a, l, st, forms_first4_kernel, pair_rank1_kernel); break;
    case 3: launch_with(a, l, st, forms_first8_kernel, pair_rank1_kernel); break;
    case 4: launch_with(a, l, st, pair_first_kernel, forms_rank1_kernel<1, true>); break;
    case 5: launch_with(a, l, st, pair_first_kernel, forms_rank1_kernel<6, true>); break;
    case 6: launch_tail(a, l, st); break;
    case 7: launch_scans(a, l, st); break;
    case 11: launch_with(a, l, st, pair_first_kernel, forms_rank1_quad_kernel<1>); break;
    case 14: launch_with(a, l, st, pair_first_kernel, forms_rank1_quad_kernel<4>); break;
    case 18: launch_with(a, l, st, pair_first_kernel, forms_rank1_quad_kernel<8>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
