// BCR merge-insert pass with the fused packed rank table, for Hopper (sm_90a).
//
// Replaces the TPU kernel rust_msbwt_tpu/ops/pallas_merge.py::_merge_kernel.
// One pass over a logical buffer of n symbols computes
//
//   new[p] = ins[p] - 1            where ins[p] != 0 (an insert slot)
//          = old[p - tmap[p]]      elsewhere
//
// (ins: int8, v+1 at insert slots; tmap: int32 inclusive count of insert
// slots at or before p) and writes the rank table of the merged buffer in
// the PackedOccIndex layout, one 32-lane int32 row per 128-symbol bin:
//
//   lanes 0..5     occurrences of each symbol strictly before the bin
//   lanes 8+4q+j   bit plane q word j: bit k = plane-q bit of position 32j+k
//   other lanes    0;  row NB (terminal) = totals, planes 0.
//
// Positions p >= n read as PAD (7): they count for no symbol and set every
// plane bit, exactly as the padded tail of a PackedOccIndex does.
//
// What bounds it: memory traffic. Per position one stage reads 1 B of old
// (a near-monotone gather, so coalesced), 1 B of ins and 4 B of tmap, and
// writes 1 B of new plus 1 B of table (128 B per 128-symbol bin) -- about
// 8 B per position, no arithmetic to speak of. The design keeps it to that
// single streaming pass: the bit planes are warp ballots of the merged
// symbols (no second read of the merged buffer), and the global occurrence
// prefix -- carried in VMEM across the TPU's sequential grid -- becomes a
// scan over per-tile sums that touches 24 B per bin plus 32 B per tile.
//
// Kernels (all on the caller's stream, no allocation here):
//   A  merge_bins    one warp per bin at a time, 4 x 32 positions; writes
//                    new, the plane words and the bin's own counts (in
//                    lanes 0..5, as scratch) and per-tile count sums.
//   B  scan_tiles    one block: exclusive scan of the tile sums in place,
//                    and the terminal row.
//   C  apply_prefix  one block per tile: exclusive scan of the bins' counts
//                    plus the tile's offset, into lanes 0..5.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBin = 128;          // symbols per bin (one table row)
constexpr int kRow = 32;           // int32 lanes per table row
constexpr int kTileBins = 256;     // bins per tile (kernels A and C)
constexpr int kThreadsA = 256;     // 8 warps, 32 bins each
constexpr int kBinsPerWarp = kTileBins / (kThreadsA / 32);
constexpr int kThreadsB = 1024;
constexpr int kTileStride = 8;     // int32 per tile-sum record (6 used)
constexpr unsigned kFull = 0xffffffffu;

// Exclusive scan of six counters across a block of NT threads. v[] is
// replaced by the exclusive prefix; total[] receives the block sums.
template <int NT>
__device__ __forceinline__ void block_exclusive_scan6(int v[6], int total[6]) {
  constexpr int kWarps = NT / 32;
  __shared__ int warp_sums[kWarps][6];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl[6];
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    int x = v[s];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    incl[s] = x;
    if (lane == 31) warp_sums[warp][s] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      int x = lane < kWarps ? warp_sums[lane][s] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      if (lane < kWarps) warp_sums[lane][s] = x;  // inclusive over warps
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    int before = warp > 0 ? warp_sums[warp - 1][s] : 0;
    v[s] = before + incl[s] - v[s];
    total[s] = warp_sums[kWarps - 1][s];
  }
  __syncthreads();  // warp_sums may be reused by the caller's next scan
}

__global__ void __launch_bounds__(kThreadsA)
merge_bins(const uint8_t* __restrict__ old, const int8_t* __restrict__ ins,
           const int32_t* __restrict__ tmap, uint8_t* __restrict__ out,
           int32_t* __restrict__ table, int32_t* __restrict__ tile_sums,
           int64_t n, int64_t nb) {
  __shared__ int part[kThreadsA / 32][6];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t bin0 = (int64_t)blockIdx.x * kTileBins + warp * kBinsPerWarp;
  int tile_count = 0;  // lane s < 6: this warp's count of symbol s
  for (int k = 0; k < kBinsPerWarp; ++k) {
    const int64_t bin = bin0 + k;
    if (bin >= nb) break;  // warp-uniform
    int val = 0;           // this lane's table word
    int count = 0;         // lane s < 6: the bin's count of symbol s
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t p = bin * kBin + 32 * j + lane;
      int sym = 7;
      if (p < n) {
        const int iv = ins[p];
        sym = iv ? iv - 1 : old[p - tmap[p]];
        out[p] = (uint8_t)sym;
      }
      const unsigned b0 = __ballot_sync(kFull, sym & 1);
      const unsigned b1 = __ballot_sync(kFull, sym & 2);
      const unsigned b2 = __ballot_sync(kFull, sym & 4);
      if (lane == 8 + j) val = (int)b0;
      if (lane == 12 + j) val = (int)b1;
      if (lane == 16 + j) val = (int)b2;
      // lane s: positions whose three plane bits spell s
      const unsigned eq = ((lane & 1) ? b0 : ~b0) & ((lane & 2) ? b1 : ~b1) &
                          ((lane & 4) ? b2 : ~b2);
      count += __popc(eq);
    }
    if (lane < 6) {
      val = count;  // the bin's own count; kernel C turns it into a prefix
      tile_count += count;
    }
    table[bin * kRow + lane] = val;
  }
  if (lane < 6) part[warp][lane] = tile_count;
  __syncthreads();
  if (threadIdx.x < 6) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kThreadsA / 32; ++w) sum += part[w][threadIdx.x];
    tile_sums[(int64_t)blockIdx.x * kTileStride + threadIdx.x] = sum;
  }
}

__global__ void __launch_bounds__(kThreadsB)
scan_tiles(int32_t* __restrict__ tile_sums, int64_t n_tiles,
           int32_t* __restrict__ table, int64_t nb) {
  // thread t owns the contiguous tile segment [t*seg, (t+1)*seg)
  const int64_t seg = (n_tiles + kThreadsB - 1) / kThreadsB;
  const int64_t t0 = threadIdx.x * seg;
  const int64_t t1 = t0 + seg < n_tiles ? t0 + seg : n_tiles;
  int v[6] = {0, 0, 0, 0, 0, 0};
  for (int64_t t = t0; t < t1; ++t) {
#pragma unroll
    for (int s = 0; s < 6; ++s) v[s] += tile_sums[t * kTileStride + s];
  }
  int total[6];
  block_exclusive_scan6<kThreadsB>(v, total);
  for (int64_t t = t0; t < t1; ++t) {
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const int x = tile_sums[t * kTileStride + s];
      tile_sums[t * kTileStride + s] = v[s];
      v[s] += x;
    }
  }
  if (threadIdx.x < kRow) {
    int word = 0;
#pragma unroll
    for (int s = 0; s < 6; ++s)
      if (threadIdx.x == s) word = total[s];
    table[nb * kRow + threadIdx.x] = word;  // terminal row
  }
}

__global__ void __launch_bounds__(kTileBins)
apply_prefix(int32_t* __restrict__ table,
             const int32_t* __restrict__ tile_offsets, int64_t nb) {
  const int64_t bin = (int64_t)blockIdx.x * kTileBins + threadIdx.x;
  int v[6];
#pragma unroll
  for (int s = 0; s < 6; ++s) v[s] = bin < nb ? table[bin * kRow + s] : 0;
  int total[6];
  block_exclusive_scan6<kTileBins>(v, total);
  if (bin < nb) {
    const int32_t* off = tile_offsets + (int64_t)blockIdx.x * kTileStride;
#pragma unroll
    for (int s = 0; s < 6; ++s) table[bin * kRow + s] = v[s] + off[s];
  }
}

}  // namespace

extern "C" {

// Int32 scratch the caller must provide for a buffer of n symbols.
int64_t msbwt_merge_insert_scratch_len(int64_t n) {
  const int64_t nb = (n + kBin - 1) / kBin;
  const int64_t n_tiles = (nb + kTileBins - 1) / kTileBins;
  return (n_tiles > 0 ? n_tiles : 1) * kTileStride;
}

// old u8 [n], ins i8 [n], tmap i32 [n] -> out u8 [n], table i32 [nb+1, 32],
// with nb = ceil(n / 128); scratch i32 [msbwt_merge_insert_scratch_len(n)].
// Launches on `stream`; returns cudaGetLastError().
int msbwt_merge_insert(const void* old, const void* ins, const void* tmap,
                       void* out, void* table, void* scratch, int64_t n,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nb = (n + kBin - 1) / kBin;
  const int64_t n_tiles = (nb + kTileBins - 1) / kTileBins;
  int32_t* tile_sums = (int32_t*)scratch;
  if (n_tiles > 0) {
    merge_bins<<<(unsigned)n_tiles, kThreadsA, 0, st>>>(
        (const uint8_t*)old, (const int8_t*)ins, (const int32_t*)tmap,
        (uint8_t*)out, (int32_t*)table, tile_sums, n, nb);
  }
  scan_tiles<<<1, kThreadsB, 0, st>>>(tile_sums, n_tiles, (int32_t*)table, nb);
  if (n_tiles > 0) {
    apply_prefix<<<(unsigned)n_tiles, kTileBins, 0, st>>>((int32_t*)table,
                                                         tile_sums, nb);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
