// Tile-list multi-quantile query through an asynchronous-copy ring.
//
// Replaces sketches_tpu/kernels.py:_overlap_kernel (the Pallas body behind
// fused_quantile_tiles_overlap), with its contract rather than the tile
// kernel's: each stream block of `bn` rows walks its sorted needed-tile
// lists (lists_pos[b, :k_tiles], then lists_neg[b, :k_tiles] when the
// negative store takes part), copies each step's [rows, 128] slab of the
// listed tile, and folds it only into the (stream, q) whose unified tile id
// `utile` equals the entry (+T on the negative steps).  A (stream, q) that
// no entry serves reads a zero tile, as the TPU's zeroed accumulator did.
// The caller (kernels._tile_query_operands) packs per stream:
//   thr_adj[Q] | utile[Q] | zflag[Q] | nanflag[Q] | key_offset | pos_lo |
//   pos_hi | neg_lo | neg_hi
// and the decode is the tile kernel's (tile_decode.cuh).
//
// Design:
//   * Work split: a persistent CTA of 8 warps takes sub-blocks of R = 32
//     rows (4 per warp) of a plan block, one after another; every
//     sub-block of a plan block reads that block's lists.
//   * Ring: `depth` slots of R x 512 B in shared memory (depth divides the
//     step count, kernels._overlap_depth), filled with 16-byte cp.async.cg
//     copies, one commit group per step; a step waits with
//     cp.async.wait_group(depth - 1), so `depth - 1` later steps stay in
//     flight while it folds.
//   * Prefetch across blocks: after folding step j the CTA refills the
//     freed slot with step j + depth, which past the end of the sub-block
//     is a step of the CTA's NEXT sub-block -- so the decode of one
//     sub-block runs under the first `depth` reads of the next.  Because
//     depth divides the step count, every sub-block starts at slot 0.
//   * Pads: a list entry that repeats its predecessor folds nothing (the
//     TPU's fresh gate); here it is also not copied: its commit group is
//     empty, so the wait accounting stays uniform.
//   * Bounds: the wrapper checks every entry < T, and an entry outside
//     [0, T) is skipped here as well -- CUDA reads out of bounds where the
//     TPU's DMA would have faulted.
//
// What bounds it on an H100: bytes -- one 512-byte tile row per stream per
// fresh list entry, plus the packed rows.  The fold is a ballot over the
// Q tile ids and, on a match, one warp scan of the slab row.
#include <cuda_runtime.h>

#include "mapping.cuh"
#include "tile_decode.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;      // R: rows of a sub-block
constexpr int kThreads = kWarps * sk::kLanes;
constexpr int kSlotFloats = kRows * sk::kTile;    // one ring slot
constexpr int kSmemLimit = 232448;                // usable by one block

struct Args {
  const float* bins_pos;
  const float* bins_neg;
  const int* lists_pos;
  const int* lists_neg;
  const float* packed;
  float* out;
  const float* consts;
  int n_bins, q_total, pk_width, bn, k_tiles, depth;
  int subs_per_block;  // ceil(bn / kRows)
  int n_subs;          // sub-blocks in all
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most depth - 1 commit groups of this thread are pending.
__device__ __forceinline__ void cp_async_wait_ring(int depth) {
  switch (depth) {
    case 1: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// One step of a sub-block: which list entry, and whether it is copied and
// folded (fresh and in range).
struct Step {
  bool neg;
  bool live;
  int pid;       // tile id within its store
  int row0;      // first stream row of the sub-block
  int rows;      // rows of the sub-block (< kRows only for a ragged bn)
};

template <bool WITH_NEG>
__device__ __forceinline__ Step step_of(const Args& a, int s, int j,
                                        int n_tiles) {
  Step st;
  const int b = s / a.subs_per_block;
  const int sub = s - b * a.subs_per_block;
  st.row0 = b * a.bn + sub * kRows;
  st.rows = min(kRows, a.bn - sub * kRows);
  st.neg = WITH_NEG && j >= a.k_tiles;
  const int jj = st.neg ? j - a.k_tiles : j;
  const int* list = (st.neg ? a.lists_neg : a.lists_pos) + (long)b * a.k_tiles;
  st.pid = list[jj];
  const bool fresh = jj == 0 || st.pid != list[jj - 1];
  st.live = fresh && st.pid >= 0 && st.pid < n_tiles;
  return st;
}

// Copy step j of sub-block s into ring slot `slot` (nothing for a pad, an
// out-of-range entry or a sub-block past the end); always one commit group.
template <bool WITH_NEG>
__device__ __forceinline__ void issue(const Args& a, float* ring, int s,
                                      int j, int slot, int n_tiles) {
  if (s < a.n_subs) {
    const Step st = step_of<WITH_NEG>(a, s, j, n_tiles);
    if (st.live) {
      const float* store = st.neg ? a.bins_neg : a.bins_pos;
      const float* src = store + (long)st.row0 * a.n_bins + st.pid * sk::kTile;
      float* dst = ring + slot * kSlotFloats;
      for (int c = threadIdx.x; c < st.rows * (sk::kTile / 4); c += kThreads) {
        const int r = c / (sk::kTile / 4);
        const int q4 = c - r * (sk::kTile / 4);
        cp_async16(dst + r * sk::kTile + q4 * 4,
                   src + (long)r * a.n_bins + q4 * 4);
      }
    }
  }
  cp_async_commit();
}

// Fold one arrived slot: for each of this warp's rows, the quantiles whose
// tile id equals the step's entry get the count of the slab row's running
// sums <= thr_adj (positive store) or < thr_adj (negative store).
template <bool WITH_NEG>
__device__ __forceinline__ void fold(const Args& a, const float* slot_base,
                                     int* counts, const Step& st,
                                     int n_tiles) {
  const int warp = threadIdx.x / sk::kLanes;
  const int lane = threadIdx.x % sk::kLanes;
  const float pid_u = (float)(st.pid + (st.neg ? n_tiles : 0));
  const int q_total = a.q_total;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (r >= st.rows) break;  // warp-uniform
    const float* pk = a.packed + (long)(st.row0 + r) * a.pk_width;
    bool scanned = false;
    float cum[4];
    for (int g = 0; g < q_total; g += sk::kLanes) {
      const int q = g + lane;
      const bool has_q = q < q_total;
      const float ut = has_q ? pk[q_total + q] : -1.0f;
      unsigned m = __ballot_sync(sk::kFull, has_q && ut == pid_u);
      if (m == 0u) continue;
      if (!scanned) {
        const float4 x =
            reinterpret_cast<const float4*>(slot_base + r * sk::kTile)[lane];
        float total;
        sk::tile_scan(x, 0.0f, cum, total);
        scanned = true;
      }
      const float thr = has_q ? pk[q] : 0.0f;
      while (m != 0u) {
        const int j = __ffs(m) - 1;
        m &= m - 1u;
        const float thr_j = __shfl_sync(sk::kFull, thr, j);
        const int c = sk::count_le(cum, thr_j, st.neg);
        if (lane == j) counts[r * q_total + q] = c;
      }
    }
  }
}

// Final values of this warp's rows of a sub-block.  A (stream, q) that no
// step served folded a zero tile: every running sum is 0, so its count is
// 128 where 0 passes the threshold and 0 elsewhere.
template <int MAP, bool WITH_NEG>
__device__ __forceinline__ void decode(const Args& a, const int* counts,
                                       int row0, int rows, int n_tiles,
                                       const sk::Consts& k) {
  const int warp = threadIdx.x / sk::kLanes;
  const int lane = threadIdx.x % sk::kLanes;
  const int q_total = a.q_total;
  const int base = 4 * q_total;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (r >= rows) break;
    const long row = row0 + r;
    const float* pk = a.packed + row * a.pk_width;
    const float koff = pk[base];
    const float first_pos = pk[base + 1];
    const float last_pos = fmaxf(pk[base + 2], first_pos);
    const float first_neg = pk[base + 3];
    const float last_neg = fmaxf(pk[base + 4], first_neg);
    for (int q = lane; q < q_total; q += sk::kLanes) {
      const float thr = pk[q];
      const float ut = pk[q_total + q];
      int c = counts[r * q_total + q];
      if (c < 0) {
        const bool strict = ut >= (float)n_tiles;
        c = (strict ? thr > 0.0f : thr >= 0.0f) ? sk::kTile : 0;
      }
      a.out[row * q_total + q] = sk::tile_finish<MAP, WITH_NEG>(
          ut, c, pk[2 * q_total + q], pk[3 * q_total + q], koff, first_pos,
          last_pos, first_neg, last_neg, n_tiles, k);
    }
  }
}

template <int MAP, bool WITH_NEG>
__global__ void __launch_bounds__(kThreads)
    overlap_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  int* counts = reinterpret_cast<int*>(ring + a.depth * kSlotFloats);
  const sk::Consts k = sk::load_consts(a.consts);
  const int n_tiles = a.n_bins / sk::kTile;
  const int n_steps = (WITH_NEG ? 2 : 1) * a.k_tiles;
  const int depth = a.depth;
  int s = blockIdx.x;
  if (s >= a.n_subs) return;  // uniform: the grid never exceeds n_subs

  for (int g = 0; g < depth; ++g) issue<WITH_NEG>(a, ring, s, g, g, n_tiles);
  int slot = 0;
  for (; s < a.n_subs; s += gridDim.x) {
    for (int i = threadIdx.x; i < kRows * a.q_total; i += kThreads) counts[i] = -1;
    for (int j = 0; j < n_steps; ++j) {
      cp_async_wait_ring(depth);
      __syncthreads();  // the slot's copies, by every thread, have landed
      const Step st = step_of<WITH_NEG>(a, s, j, n_tiles);
      if (st.live) fold<WITH_NEG>(a, ring + slot * kSlotFloats, counts, st, n_tiles);
      __syncthreads();  // every warp is done with the slot
      const int g = j + depth;
      if (g < n_steps) {
        issue<WITH_NEG>(a, ring, s, g, slot, n_tiles);
      } else {
        issue<WITH_NEG>(a, ring, s + gridDim.x, g - n_steps, slot, n_tiles);
      }
      slot = slot + 1 == depth ? 0 : slot + 1;
    }
    const int b = s / a.subs_per_block;
    const int sub = s - b * a.subs_per_block;
    decode<MAP, WITH_NEG>(a, counts, b * a.bn + sub * kRows,
                          min(kRows, a.bn - sub * kRows), n_tiles, k);
    __syncthreads();  // counts are reset for the next sub-block
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int MAP, bool WITH_NEG>
int launch(const Args& a, int smem, cudaStream_t stream) {
  auto kern = overlap_kernel<MAP, WITH_NEG>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess) {
    return (int)err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                           smem)) != cudaSuccess) {
    return (int)err;
  }
  const long resident = (long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(a.n_subs < resident ? a.n_subs : resident);
  overlap_kernel<MAP, WITH_NEG><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Shared memory the kernel needs: the ring plus the [R, Q] count block
// (kernels._overlap_smem_bytes repeats this for the wrapper's check).
long smem_bytes(int depth, int q_total) {
  return (long)depth * kSlotFloats * 4 + (long)kRows * q_total * 4;
}

}  // namespace

// C entry point, bound with ctypes (sketches_tpu_torch/kernels.py).
// bins_neg == lists_neg == nullptr: the positive steps only (with_neg
// False); the negative store is certified empty and never read.
extern "C" int sk_overlap(const float* bins_pos, const float* bins_neg,
                          const int* lists_pos, const int* lists_neg,
                          const float* packed, float* out, const float* consts,
                          int mapping, int n, int n_bins, int q_total,
                          int pk_width, int bn, int k_tiles, int depth,
                          void* stream) {
  if (n <= 0 || q_total <= 0) return 0;
  const bool with_neg = bins_neg != nullptr;
  const long smem = smem_bytes(depth, q_total);
  if (n_bins % sk::kTile != 0 || bn <= 0 || n % bn != 0 || k_tiles < 1 ||
      k_tiles > n_bins / sk::kTile ||
      !(depth == 1 || depth == 2 || depth == 4 || depth == 8) ||
      ((with_neg ? 2 : 1) * k_tiles) % depth != 0 ||
      pk_width < 4 * q_total + 5 || (with_neg && lists_neg == nullptr) ||
      smem > kSmemLimit) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.bins_pos = bins_pos;
  a.bins_neg = bins_neg;
  a.lists_pos = lists_pos;
  a.lists_neg = lists_neg;
  a.packed = packed;
  a.out = out;
  a.consts = consts;
  a.n_bins = n_bins;
  a.q_total = q_total;
  a.pk_width = pk_width;
  a.bn = bn;
  a.k_tiles = k_tiles;
  a.depth = depth;
  a.subs_per_block = (bn + kRows - 1) / kRows;
  a.n_subs = (n / bn) * a.subs_per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!with_neg) {
    SK_DISPATCH_MAPPING(mapping, return launch<MAP, false>(a, (int)smem, st));
  }
  SK_DISPATCH_MAPPING(mapping, return launch<MAP, true>(a, (int)smem, st));
  return 0;
}
