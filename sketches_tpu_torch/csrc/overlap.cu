// Tile-list multi-quantile query through an mbarrier ring of bulk copies.
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
// and the scan, count and decode are the tile kernel's (mapping.cuh,
// tile_decode.cuh), so the answers equal fused_quantile_tiles bit for bit.
//
// What bounds it on an H100: bytes -- one 512-byte tile row per stream per
// fresh list entry, plus the packed rows.  The fold is a ballot over the
// Q tile ids and, on a match, one warp scan of the slab row.
//
// Design (warp-specialized, persistent):
//   * Work split: a CTA of one producer warp and four consumer warps takes
//     sub-blocks of R = 16 rows of a plan block, one after another
//     (blockIdx.x, + gridDim.x, ...); every sub-block of a plan block reads
//     that block's lists.  Each consumer warp owns 4 rows of a sub-block.
//   * Ring: `slots` slots of R x 512 B.  The producer warp waits for a
//     slot's *empty* mbarrier, writes the step's unified tile id into the
//     slot's header, and for a fresh, in-range entry arms the slot's *full*
//     mbarrier with the slab's bytes (arrive.expect_tx) while each of R
//     lanes issues one 512-byte cp.async.bulk copy completing on it; a pad
//     or out-of-range entry copies nothing and arrives with 0 bytes, so
//     every step completes its barrier.  Consumers wait on *full*, fold,
//     and each warp arrives once on *empty*.  Slot and phase come from a
//     running step counter (slot = k % slots, phase = (k / slots) & 1),
//     so the ring runs across sub-blocks and plan blocks without a
//     block-wide barrier and a sub-block need not start at slot 0: the
//     producer runs `slots` steps ahead, into the next sub-block while the
//     consumers decode this one.
//   * Staged operand: with the first slab of each sub-block the producer
//     bulk-copies the sub-block's packed rows (contiguous) into one of two
//     staging buffers, on their own full/empty mbarrier pair.  The fold's
//     tile-id match and threshold and the decode read shared memory only.
//   * Ring size: for bytes in flight an SM, not for the step count.
//     kernels._overlap_depth still picks the depth from `lookahead` (the
//     wrapper's plan and its JAX parity); here it is the prefetch distance,
//     capped at kMaxSlots = 4.  R = 16 keeps a slot at 8 KB, so a CTA holds
//     at most 32 KB of ring and six CTAs (24 consumer warps, 24 slots in
//     flight) share an SM.  A full 8-slot ring would halve that to three
//     CTAs, and the walk is limited by its consumer warps as much as by
//     bytes in flight: 1.41 ms against 1.05 ms on the 1M x 512 mixed state
//     (H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md).
//   * Decode: one lane per (row, q) pair of a warp's rows, and the answers
//     leave as contiguous runs.
//   * Bounds: the wrapper checks every entry < T, and an entry outside
//     [0, T) is skipped here as well -- CUDA reads out of bounds where the
//     TPU's DMA would have faulted.
//   * Exit: every copy a producer issues completes a full barrier that a
//     consumer waits on, so no bulk copy is in flight when the CTA exits.
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "mapping.cuh"
#include "tile_decode.cuh"

namespace {

using sk::bulk_copy;
using sk::mbar_arrive;
using sk::mbar_arrive_tx;
using sk::mbar_init;
using sk::mbar_wait;
using sk::smem_addr;

constexpr int kConsumers = 4;                      // consumer warps
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kConsumers * kRowsPerWarp;   // R: rows of a sub-block
constexpr int kThreads = (kConsumers + 1) * sk::kLanes;
constexpr int kSlotFloats = kRows * sk::kTile;     // one ring slot
constexpr int kSlabRowBytes = sk::kTile * 4;
constexpr int kSmemLimit = 232448;                 // usable by one block
constexpr int kMaxSlots = 4;                       // ring slots at most

struct Args {
  const float* bins_pos;
  const float* bins_neg;
  const int* lists_pos;
  const int* lists_neg;
  const float* packed;
  float* out;
  const float* consts;
  int n_bins, q_total, pk_width, bn, k_tiles;
  int slots;           // ring slots: min(depth, kMaxSlots), a power of two
  int subs_per_block;  // ceil(bn / kRows)
  int n_subs;          // sub-blocks in all
};

// --- the walk ---------------------------------------------------------------

struct Sub {
  int block;  // plan block
  int row0;   // first stream row
  int rows;   // rows (< kRows only for a ragged bn)
};

__device__ __forceinline__ Sub sub_of(const Args& a, int s) {
  Sub u;
  u.block = s / a.subs_per_block;
  const int sub = s - u.block * a.subs_per_block;
  u.row0 = u.block * a.bn + sub * kRows;
  u.rows = min(kRows, a.bn - sub * kRows);
  return u;
}

// Producer warp: packed rows, then every step's slab, for each sub-block.
template <bool WITH_NEG>
__device__ __forceinline__ void produce(const Args& a, float* ring, float* stage, int* header,
                                        unsigned full0, unsigned empty0, unsigned pk_full0,
                                        unsigned pk_empty0, int n_steps, int n_tiles,
                                        int slots_log2) {
  const int lane = threadIdx.x % sk::kLanes;
  const int slot_mask = a.slots - 1;
  int k = 0;  // running step counter
  int i = 0;  // running sub-block counter
  for (int s = blockIdx.x; s < a.n_subs; s += gridDim.x, ++i) {
    const Sub u = sub_of(a, s);
    const int buf = i & 1;
    mbar_wait(pk_empty0 + 8 * buf, ((i >> 1) & 1) ^ 1);
    if (lane == 0) {
      const unsigned bytes = (unsigned)(u.rows * a.pk_width * 4);
      mbar_arrive_tx(pk_full0 + 8 * buf, bytes);
      bulk_copy(smem_addr(stage + buf * kRows * a.pk_width),
                a.packed + (long)u.row0 * a.pk_width, bytes, pk_full0 + 8 * buf);
    }
    for (int j = 0; j < n_steps; ++j, ++k) {
      const int slot = k & slot_mask;
      const unsigned full = full0 + 8 * slot;
      mbar_wait(empty0 + 8 * slot, ((k >> slots_log2) & 1) ^ 1);
      const bool neg = WITH_NEG && j >= a.k_tiles;
      const int jj = neg ? j - a.k_tiles : j;
      const int* list = (neg ? a.lists_neg : a.lists_pos) + (long)u.block * a.k_tiles;
      const int pid = __ldg(list + jj);
      // The fresh gate: an entry that repeats its predecessor folds nothing.
      const bool fresh = jj == 0 || pid != __ldg(list + jj - 1);
      const bool live = fresh && pid >= 0 && pid < n_tiles;
      if (live) {
        if (lane == 0) {
          header[slot] = pid + (neg ? n_tiles : 0);
          mbar_arrive_tx(full, (unsigned)(u.rows * kSlabRowBytes));
        }
        __syncwarp();
        if (lane < u.rows) {
          const float* store = neg ? a.bins_neg : a.bins_pos;
          bulk_copy(smem_addr(ring + slot * kSlotFloats + lane * sk::kTile),
                    store + (long)(u.row0 + lane) * a.n_bins + pid * sk::kTile,
                    kSlabRowBytes, full);
        }
      } else if (lane == 0) {
        header[slot] = -1;
        mbar_arrive(full);
      }
    }
  }
}

// Fold one arrived slab into this warp's rows: the quantiles whose tile id
// equals the step's get the count of the slab row's running sums <= thr_adj
// (positive store) or < thr_adj (negative store).
__device__ __forceinline__ void fold(const Args& a, const float* slab, const float* pk,
                                     int* counts, int pid_u, bool neg, int rows) {
  const int warp = threadIdx.x / sk::kLanes;
  const int lane = threadIdx.x % sk::kLanes;
  const int q_total = a.q_total;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (r >= rows) break;  // warp-uniform
    const float* pr = pk + r * a.pk_width;
    bool scanned = false;
    float cum[4];
    for (int g = 0; g < q_total; g += sk::kLanes) {
      const int q = g + lane;
      const bool has_q = q < q_total;
      const float ut = has_q ? pr[q_total + q] : -1.0f;
      unsigned m = __ballot_sync(sk::kFull, has_q && ut == (float)pid_u);
      if (m == 0u) continue;
      if (!scanned) {
        const float4 x = reinterpret_cast<const float4*>(slab + r * sk::kTile)[lane];
        float total;
        sk::tile_scan(x, 0.0f, cum, total);
        scanned = true;
      }
      const float thr = has_q ? pr[q] : 0.0f;
      while (m != 0u) {
        const int j = __ffs(m) - 1;
        m &= m - 1u;
        const float thr_j = __shfl_sync(sk::kFull, thr, j);
        const int c = sk::count_le(cum, thr_j, neg);
        if (lane == j) counts[rr * q_total + q] = c;
      }
    }
  }
}

// Final values of this warp's rows, one lane per (row, q).  A (stream, q)
// that no step served folded a zero tile: every running sum is 0, so its
// count is 128 where 0 passes the threshold and 0 elsewhere.
template <int MAP, bool WITH_NEG>
__device__ __forceinline__ void decode(const Args& a, const float* pk, const int* counts,
                                       const Sub& u, int n_tiles, const sk::Consts& k) {
  const int warp = threadIdx.x / sk::kLanes;
  const int lane = threadIdx.x % sk::kLanes;
  const int q_total = a.q_total;
  const int base = 4 * q_total;
  for (int p = lane; p < kRowsPerWarp * q_total; p += sk::kLanes) {
    const int rr = p / q_total;
    const int q = p - rr * q_total;
    const int r = warp * kRowsPerWarp + rr;
    if (r >= u.rows) break;
    const float* pr = pk + r * a.pk_width;
    const float thr = pr[q];
    const float ut = pr[q_total + q];
    int c = counts[p];
    if (c < 0) {
      const bool strict = ut >= (float)n_tiles;
      c = (strict ? thr > 0.0f : thr >= 0.0f) ? sk::kTile : 0;
    }
    const float first_pos = pr[base + 1];
    const float first_neg = pr[base + 3];
    a.out[(long)(u.row0 + r) * q_total + q] = sk::tile_finish<MAP, WITH_NEG>(
        ut, c, pr[2 * q_total + q], pr[3 * q_total + q], pr[base], first_pos,
        fmaxf(pr[base + 2], first_pos), first_neg, fmaxf(pr[base + 4], first_neg), n_tiles, k);
  }
}

template <int MAP, bool WITH_NEG>
__device__ __forceinline__ void consume(const Args& a, const float* ring, const float* stage,
                                        const int* header, int* counts, unsigned full0,
                                        unsigned empty0, unsigned pk_full0, unsigned pk_empty0,
                                        int n_steps, int n_tiles, int slots_log2) {
  const int warp = threadIdx.x / sk::kLanes;
  const int lane = threadIdx.x % sk::kLanes;
  const sk::Consts k = sk::load_consts(a.consts);
  const int slot_mask = a.slots - 1;
  int* my_counts = counts + warp * kRowsPerWarp * a.q_total;
  int step = 0;  // running step counter, as the producer's
  int i = 0;
  for (int s = blockIdx.x; s < a.n_subs; s += gridDim.x, ++i) {
    const Sub u = sub_of(a, s);
    const int buf = i & 1;
    for (int p = lane; p < kRowsPerWarp * a.q_total; p += sk::kLanes) my_counts[p] = -1;
    mbar_wait(pk_full0 + 8 * buf, (i >> 1) & 1);
    const float* pk = stage + buf * kRows * a.pk_width;
    __syncwarp();
    for (int j = 0; j < n_steps; ++j, ++step) {
      const int slot = step & slot_mask;
      mbar_wait(full0 + 8 * slot, (step >> slots_log2) & 1);
      const int pid_u = header[slot];
      if (pid_u >= 0) {
        fold(a, ring + slot * kSlotFloats, pk, my_counts, pid_u, WITH_NEG && pid_u >= n_tiles,
             u.rows);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    }
    decode<MAP, WITH_NEG>(a, pk, my_counts, u, n_tiles, k);
    __syncwarp();
    if (lane == 0) mbar_arrive(pk_empty0 + 8 * buf);
  }
}

// Shared memory layout: ring | 2 staging buffers | mbarriers | headers |
// counts (kernels._overlap_smem_bytes repeats the size for the wrapper).
long smem_bytes(int slots, int q_total, int pk_width) {
  return (long)slots * kSlotFloats * 4 + 2L * kRows * pk_width * 4 + (2L * slots + 4) * 8 +
         (long)slots * 4 + (long)kRows * q_total * 4;
}

template <int MAP, bool WITH_NEG>
__global__ void __launch_bounds__(kThreads) overlap_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* stage = ring + a.slots * kSlotFloats;
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(stage + 2 * kRows * a.pk_width);
  int* header = reinterpret_cast<int*>(bars + 2 * a.slots + 4);
  int* counts = header + a.slots;
  const unsigned full0 = smem_addr(bars);
  const unsigned empty0 = full0 + 8 * a.slots;
  const unsigned pk_full0 = empty0 + 8 * a.slots;
  const unsigned pk_empty0 = pk_full0 + 16;
  if (threadIdx.x == 0) {
    for (int d = 0; d < a.slots; ++d) {
      mbar_init(full0 + 8 * d, 1);                // the producer's arrive
      mbar_init(empty0 + 8 * d, kConsumers);      // one arrive per consumer warp
    }
    for (int d = 0; d < 2; ++d) {
      mbar_init(pk_full0 + 8 * d, 1);
      mbar_init(pk_empty0 + 8 * d, kConsumers);
    }
    sk::mbar_init_fence();
  }
  __syncthreads();  // the only block-wide barrier: the mbarriers exist
  const int n_tiles = a.n_bins / sk::kTile;
  const int n_steps = (WITH_NEG ? 2 : 1) * a.k_tiles;
  const int slots_log2 = __ffs(a.slots) - 1;
  if (threadIdx.x / sk::kLanes == kConsumers) {
    produce<WITH_NEG>(a, ring, stage, header, full0, empty0, pk_full0, pk_empty0, n_steps,
                      n_tiles, slots_log2);
  } else {
    consume<MAP, WITH_NEG>(a, ring, stage, header, counts, full0, empty0, pk_full0, pk_empty0,
                           n_steps, n_tiles, slots_log2);
  }
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

}  // namespace

// C entry point, bound with ctypes (sketches_tpu_torch/kernels.py).
// bins_neg == lists_neg == nullptr: the positive steps only (with_neg
// False); the negative store is certified empty and never read.  Every
// pointer must be 16-byte aligned (the bulk copies' rule) and pk_width a
// multiple of 4.
extern "C" int sk_overlap(const float* bins_pos, const float* bins_neg,
                          const int* lists_pos, const int* lists_neg,
                          const float* packed, float* out, const float* consts,
                          int mapping, int n, int n_bins, int q_total,
                          int pk_width, int bn, int k_tiles, int depth,
                          void* stream) {
  if (n <= 0 || q_total <= 0) return 0;
  const bool with_neg = bins_neg != nullptr;
  const int slots = depth < kMaxSlots ? depth : kMaxSlots;
  const long smem = smem_bytes(slots, q_total, pk_width);
  if (n_bins % sk::kTile != 0 || bn <= 0 || n % bn != 0 || k_tiles < 1 ||
      k_tiles > n_bins / sk::kTile ||
      !(depth == 1 || depth == 2 || depth == 4 || depth == 8) ||
      pk_width < 4 * q_total + 5 || pk_width % 4 != 0 ||
      (with_neg && lists_neg == nullptr) || smem > kSmemLimit) {
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
  a.slots = slots;
  a.subs_per_block = (bn + kRows - 1) / kRows;
  a.n_subs = (n / bn) * a.subs_per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!with_neg) {
    SK_DISPATCH_MAPPING(mapping, return launch<MAP, false>(a, (int)smem, st));
  }
  SK_DISPATCH_MAPPING(mapping, return launch<MAP, true>(a, (int)smem, st));
  return 0;
}
