// Fused ingest: one batch of values -> per-stream histograms + bookkeeping.
//
// Replaces sketches_tpu/kernels.py:_ingest_kernel (the Pallas body behind
// ingest_histogram).  Same outputs as there, per call:
//   hist_pos, hist_neg [n, n_bins] f32 -- this batch's mass per bin;
//   cols [n, ncols] f32 -- zero, count, sum, min, max, collapsed low/high,
//     pos/neg occupied lo/hi, neg_total at columns 0..11 (kernels._COL),
//     zeros at 12..15, then the 2T per-tile masses (pos tiles, neg tiles)
//     from column 16 (kernels._TILE0), zero-padded to ncols.
// The TPU built each histogram as one-hot matmuls on the MXU, in four
// bit-identical constructions; none of that carries over.  Here one warp
// owns one stream row at a time and keeps the row's two histograms in
// shared memory.
//
// What bounds it on an H100: bytes.  Per row it reads S values (and S
// weights when weighted) and writes 2 * n_bins histogram floats; at
// n_bins = 512, S = 256 the writes are 4x the reads.  Every histogram row
// is written exactly once, as float4 stores from shared memory, and never
// read back from device memory.
//
// Design:
//   * Persistent warps.  A warp walks rows row, row + W, ... (W warps in
//     the grid), each as chunks of up to 256 values (8 steps of 32).  The
//     next chunk's loads are issued before the current one is keyed, so a
//     warp keeps 8 coalesced 128-byte loads in flight under the key math
//     and under the previous row's epilogue.
//   * Unit weights: the shared histogram holds u32 counts and each value
//     adds 1 with a shared-memory atomic (red.shared.add.u32).  Integer
//     adds are exact and independent of order, so the counts -- and the
//     f32 histogram written from them -- equal the plain version's bit for
//     bit.  A step whose 32 values all hit one bin (heavy skew: a constant
//     batch) adds 32 once instead of serializing 32 atomics on one address.
//   * Weighted calls keep a fixed summation order: lanes that hit the same
//     (store, bin) in one step are grouped with __match_any_sync and the
//     group's lowest lane (its leader) adds the group's mass to the bin.
//     The mass is the leader's weight, then each other member's in lane
//     order; a bin takes its groups' masses step by step, in value order.
//     Only the lanes that join another lane's group are shuffled to the
//     leaders (one ballot names them), so a step costs one shuffle per
//     collision rather than a sweep of all 32 lanes, and the steps unroll
//     with the chunk in registers as the unit path's do.  A step of padding
//     only (no live signed value) skips the grouping.  No atomics, so a
//     weighted call is bit-identical from run to run.  The match itself is
//     the step's largest cost left (PERF.md §6, K1).
//   * Epilogue: each lane reads one 16-byte vector of every 128-bin tile,
//     writes it to the output row, zeroes it for the warp's next row, and
//     the tile's mass is one warp reduction (__reduce_add_sync for counts,
//     a fixed xor-shuffle tree for weighted masses).  The 16 scalars and the
//     2T tile masses are gathered into lanes and written as coalesced runs
//     of 32 columns: no single-lane stores.  Scalar columns are per-lane
//     sums over the lane's values in order, then a fixed reduction; min and
//     max reduce as order-preserving integers.
// No block-wide barrier: a warp shares nothing with the other warps.
#include <cuda_runtime.h>

#include <type_traits>

#include "mapping.cuh"

namespace {

constexpr int kCols = 16;                     // scalar columns before the tile masses
constexpr int kMaxWarps = 8;                  // stream rows (warps) per block
constexpr int kUnroll = 8;                    // 32-value steps per chunk
constexpr int kChunk = kUnroll * sk::kLanes;  // values a warp keeps in flight
constexpr int kSmemLimit = 232448;            // bytes of shared memory a block may use

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(sk::kFull, x, o);
  return x;
}

// f32 <-> int with the same order (an involution), so min and max reduce
// with the integer warp reductions.
__device__ __forceinline__ int ordered(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

struct Args {
  const float* values;
  const float* weights;
  const int* key_offset;
  float* hist_pos;
  float* hist_neg;
  float* cols;
  const float* consts;
  int n, s, n_bins, ncols;
};

// One lane's running bookkeeping over its values of the current row.
// Unit weights count in integers; weighted calls sum f32 masses.
template <bool WEIGHTED>
struct Acc {
  using M = typename std::conditional<WEIGHTED, float, unsigned>::type;
  M zero, clow, chigh, neg_total;
  float count, sum;  // count: weighted calls only (unit: S)
  int vmin, vmax;    // ordered()
  int pos_lo, pos_hi, neg_lo, neg_hi;

  __device__ __forceinline__ void reset(int n_bins) {
    zero = clow = chigh = neg_total = M(0);
    count = sum = 0.0f;
    vmin = ordered(INFINITY);
    vmax = ordered(-INFINITY);
    pos_lo = neg_lo = n_bins;
    pos_hi = neg_hi = -1;
  }
};

__device__ __forceinline__ void load_chunk(const float* __restrict__ row, int base,
                                           int s, float (&buf)[kUnroll]) {
  const int lane = threadIdx.x % sk::kLanes;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = base + u * sk::kLanes + lane;
    buf[u] = j < s ? __ldg(row + j) : 0.0f;
  }
}

// One value of one lane (one step of the warp's 32): split, key, clamp,
// bookkeeping, and the histogram add.
template <int MAP, bool WEIGHTED>
__device__ __forceinline__ void ingest_one(float v, float w, bool in, int lo, int n_bins,
                                           const sk::Consts& k, Acc<WEIGHTED>& a,
                                           typename Acc<WEIGHTED>::M* h) {
  const int lane = threadIdx.x % sk::kLanes;
  const int hi = lo + n_bins - 1;
  const bool live = WEIGHTED ? (in && w > 0.0f) : in;
  // Three-way split with the explicit subnormals-are-zero predicate; NaN
  // fails both compares and lands in the zero path.
  const bool is_pos = live && v >= FLT_MIN;
  const bool is_neg = live && v <= -FLT_MIN;
  const bool is_zero = live && !(v >= FLT_MIN || v <= -FLT_MIN);
  const bool is_signed = is_pos || is_neg;
  const int key = sk::key_of<MAP>(is_signed ? fabsf(v) : 1.0f, k);
  const int idx = min(max(key, lo), hi) - lo;
  if (live && !isnan(v)) {
    a.vmin = min(a.vmin, ordered(v));
    a.vmax = max(a.vmax, ordered(v));
  }
  if (is_pos) {
    a.pos_lo = min(a.pos_lo, idx);
    a.pos_hi = max(a.pos_hi, idx);
  }
  if (is_neg) {
    a.neg_lo = min(a.neg_lo, idx);
    a.neg_hi = max(a.neg_hi, idx);
  }
  const int code = is_signed ? (is_neg ? n_bins + idx : idx) : -1;
  if constexpr (WEIGHTED) {
    const float wl = live ? w : 0.0f;
    const float signed_w = is_signed ? wl : 0.0f;
    a.zero += is_zero ? wl : 0.0f;
    a.count += wl;
    a.sum += (live ? v : 0.0f) * wl;
    a.clow += key < lo ? signed_w : 0.0f;
    a.chigh += key > hi ? signed_w : 0.0f;
    a.neg_total += is_neg ? wl : 0.0f;
    // A step with no signed live value (padding) adds nothing.
    if (__ballot_sync(sk::kFull, code >= 0) == 0u) return;  // warp-uniform
    // Group the lanes that hit the same (store, bin).  A leader's mass
    // starts at its own weight (> 0, so equal to 0 + w) and takes the other
    // members' in lane order: the lanes of `rest` in ascending order, each
    // kept by the leader whose group holds it.
    const unsigned peers = __match_any_sync(sk::kFull, code);
    const bool leads = lane == __ffs(peers) - 1;
    unsigned rest = __ballot_sync(sk::kFull, code >= 0 && !leads);  // warp-uniform
    float mass = signed_w;
    while (rest != 0u) {
      const int l = __ffs(rest) - 1;
      rest &= rest - 1u;
      const float ml = __shfl_sync(sk::kFull, signed_w, l);
      if ((peers >> l) & 1u) mass += ml;
    }
    if (code >= 0 && leads) h[code] += mass;
    __syncwarp();  // this step's adds before the next step's leaders read
  } else {
    a.zero += is_zero;
    if (in) a.sum += v;
    a.clow += is_signed && key < lo;
    a.chigh += is_signed && key > hi;
    a.neg_total += is_neg;
    const int c0 = __shfl_sync(sk::kFull, code, 0);
    if (__all_sync(sk::kFull, code == c0)) {
      if (lane == 0 && c0 >= 0) atomicAdd(h + c0, (unsigned)sk::kLanes);
    } else if (code >= 0) {
      atomicAdd(h + code, 1u);
    }
  }
}

// Write the finished row: both histograms, the scalar columns and the tile
// masses; leave the shared histogram zeroed for the warp's next row.
template <bool WEIGHTED>
__device__ __forceinline__ void finish_row(const Args& a, long row, const Acc<WEIGHTED>& acc,
                                           typename Acc<WEIGHTED>::M* h) {
  const int lane = threadIdx.x % sk::kLanes;
  float zero, count, clow, chigh, neg_total;
  if constexpr (WEIGHTED) {
    zero = warp_sum(acc.zero);
    count = warp_sum(acc.count);
    clow = warp_sum(acc.clow);
    chigh = warp_sum(acc.chigh);
    neg_total = warp_sum(acc.neg_total);
  } else {
    zero = (float)__reduce_add_sync(sk::kFull, (unsigned)acc.zero);
    count = (float)a.s;  // every value of a unit-weight row is live
    clow = (float)__reduce_add_sync(sk::kFull, (unsigned)acc.clow);
    chigh = (float)__reduce_add_sync(sk::kFull, (unsigned)acc.chigh);
    neg_total = (float)__reduce_add_sync(sk::kFull, (unsigned)acc.neg_total);
  }
  const float sum = warp_sum(acc.sum);
  const float vmin = unordered(__reduce_min_sync(sk::kFull, acc.vmin));
  const float vmax = unordered(__reduce_max_sync(sk::kFull, acc.vmax));
  const int pos_lo = __reduce_min_sync(sk::kFull, acc.pos_lo);
  const int pos_hi = __reduce_max_sync(sk::kFull, acc.pos_hi);
  const int neg_lo = __reduce_min_sync(sk::kFull, acc.neg_lo);
  const int neg_hi = __reduce_max_sync(sk::kFull, acc.neg_hi);

  float mine = 0.0f;  // the column this lane writes in the current run of 32
  switch (lane) {
    case 0: mine = zero; break;
    case 1: mine = count; break;
    case 2: mine = sum; break;
    case 3: mine = vmin; break;
    case 4: mine = vmax; break;
    case 5: mine = clow; break;
    case 6: mine = chigh; break;
    case 7: mine = (float)pos_lo; break;
    case 8: mine = (float)pos_hi; break;
    case 9: mine = (float)neg_lo; break;
    case 10: mine = (float)neg_hi; break;
    case 11: mine = neg_total; break;
    default: break;
  }

  const int n_bins = a.n_bins;
  const int n_tiles2 = 2 * n_bins / sk::kTile;
  uint4* h4 = reinterpret_cast<uint4*>(h);
  float* crow = a.cols + row * (long)a.ncols;
  float* pos_row = a.hist_pos + row * (long)n_bins;
  float* neg_row = a.hist_neg + row * (long)n_bins;
  int t = 0;
  for (int c0 = 0; c0 < a.ncols; c0 += sk::kLanes) {
    // Tiles whose mass column kCols + t falls in [c0, c0 + 32).
    const int t_end = min(n_tiles2, c0 + sk::kLanes - kCols);
    for (; t < t_end; ++t) {
      const uint4 x = h4[t * sk::kLanes + lane];
      h4[t * sk::kLanes + lane] = make_uint4(0u, 0u, 0u, 0u);
      float4 f;
      float tile;
      if constexpr (WEIGHTED) {
        f = make_float4(__uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z),
                        __uint_as_float(x.w));
        tile = warp_sum(((f.x + f.y) + f.z) + f.w);
      } else {
        f = make_float4((float)x.x, (float)x.y, (float)x.z, (float)x.w);
        tile = (float)__reduce_add_sync(sk::kFull, x.x + x.y + x.z + x.w);
      }
      float* dst = t * sk::kTile < n_bins ? pos_row + t * sk::kTile
                                          : neg_row + t * sk::kTile - n_bins;
      reinterpret_cast<float4*>(dst)[lane] = f;
      if (lane == ((kCols + t) & (sk::kLanes - 1))) mine = tile;
    }
    const int c = c0 + lane;
    if (c < a.ncols) crow[c] = mine;
    mine = 0.0f;
  }
  __syncwarp();  // the zeroed histogram is the next row's
}

template <int MAP, bool WEIGHTED>
__global__ void __launch_bounds__(kMaxWarps * sk::kLanes) ingest_kernel(const Args a) {
  using M = typename Acc<WEIGHTED>::M;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / sk::kLanes;
  const int lane = threadIdx.x % sk::kLanes;
  const int warps = blockDim.x / sk::kLanes;
  float4* h4 = smem4 + (long)warp * (2 * a.n_bins / 4);  // [pos bins | neg bins]
  M* h = reinterpret_cast<M*>(h4);
  for (int i = lane; i < a.n_bins / 2; i += sk::kLanes) h4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();

  const long stride = (long)gridDim.x * warps;
  long row = (long)blockIdx.x * warps + warp;
  if (row >= a.n) return;  // whole warp leaves; no block-wide barrier follows
  const sk::Consts k = sk::load_consts(a.consts);
  const int s = a.s;
  float v[kUnroll], w[kUnroll], nv[kUnroll], nw[kUnroll];
  load_chunk(a.values + row * s, 0, s, v);
  if (WEIGHTED) load_chunk(a.weights + row * s, 0, s, w);
  int lo = a.key_offset[row];
  int base = 0;
  Acc<WEIGHTED> acc;
  acc.reset(a.n_bins);
  for (;;) {
    long nrow = row;
    int nbase = base + kChunk;
    if (nbase >= s) {
      nrow += stride;
      nbase = 0;
    }
    const bool more = nrow < a.n;
    int nlo = lo;
    if (more) {
      load_chunk(a.values + nrow * s, nbase, s, nv);
      if (WEIGHTED) load_chunk(a.weights + nrow * s, nbase, s, nw);
      if (nbase == 0) nlo = a.key_offset[nrow];
    }
    // Unrolled, so v[u] and w[u] stay in registers.
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j0 = base + u * sk::kLanes;
      if (j0 >= s) break;  // warp-uniform
      ingest_one<MAP, WEIGHTED>(v[u], WEIGHTED ? w[u] : 1.0f, j0 + lane < s, lo, a.n_bins, k,
                                acc, h);
    }
    if (nbase == 0) {
      finish_row<WEIGHTED>(a, row, acc, h);
      acc.reset(a.n_bins);
    }
    if (!more) break;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = nv[u];
      if (WEIGHTED) w[u] = nw[u];
    }
    row = nrow;
    base = nbase;
    lo = nlo;
  }
}

template <int MAP, bool WEIGHTED>
int launch(const Args& a, cudaStream_t stream) {
  const int row_bytes = 2 * a.n_bins * (int)sizeof(float);
  int warps = kSmemLimit / row_bytes;
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int smem = warps * row_bytes;
  const int threads = warps * sk::kLanes;
  auto kernel = ingest_kernel<MAP, WEIGHTED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return (int)err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess) {
    return (int)err;
  }
  const long needed = ((long)a.n + warps - 1) / warps;
  const long resident = (long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(needed < resident ? needed : resident);
  kernel<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (sketches_tpu_torch/kernels.py).
// weights == nullptr means unit weights.  Returns a cudaError_t code.
extern "C" int sk_ingest(const float* values, const float* weights,
                         const int* key_offset, float* hist_pos,
                         float* hist_neg, float* cols, const float* consts,
                         int mapping, int n, int s, int n_bins, int ncols,
                         void* stream) {
  if (n <= 0) return 0;
  if (n_bins % sk::kTile != 0 || s <= 0 ||
      ncols < kCols + 2 * n_bins / sk::kTile) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{values, weights, key_offset, hist_pos, hist_neg, cols, consts, n, s, n_bins, ncols};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (weights == nullptr) {
    SK_DISPATCH_MAPPING(mapping, return launch<MAP, false>(a, st));
  }
  SK_DISPATCH_MAPPING(mapping, return launch<MAP, true>(a, st));
  return 0;
}
