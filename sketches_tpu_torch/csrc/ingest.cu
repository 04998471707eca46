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
// owns one stream row and keeps the row's two histograms in shared memory.
//
// What bounds it on an H100: bytes.  Per row it reads S values (and S
// weights when weighted) and writes 2 * n_bins histogram floats; at
// n_bins = 512, S = 256 the writes are 4x the reads.  The design therefore
// writes every histogram row exactly once, as float4 stores from shared
// memory, and never reads a histogram back from device memory.
//
// Determinism: lanes that hit the same (store, bin) in one step of 32
// values are grouped with __match_any_sync; the group's lowest lane adds the
// group's mass, summed in lane order, into the shared row.  No atomics, so
// a weighted call is bit-identical from run to run.  Scalar columns are
// per-lane sums over the lane's values in order, then a fixed xor-shuffle
// tree.  Unit-weight calls pass weights == nullptr (no ones array is read).
#include <cuda_runtime.h>

#include "mapping.cuh"

namespace {

constexpr int kCols = 16;        // scalar columns before the tile masses
constexpr int kMaxRows = 8;      // stream rows (warps) per block
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(sk::kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(sk::kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(sk::kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_imin(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(sk::kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_imax(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(sk::kFull, x, o));
  return x;
}

template <int MAP, bool WEIGHTED>
__global__ void ingest_kernel(const float* __restrict__ values,
                              const float* __restrict__ weights,
                              const int* __restrict__ key_offset,
                              float* __restrict__ hist_pos,
                              float* __restrict__ hist_neg,
                              float* __restrict__ cols,
                              const float* __restrict__ consts, int n, int s,
                              int n_bins, int ncols, int rows_per_block) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / sk::kLanes;
  const int lane = threadIdx.x % sk::kLanes;
  const long row = (long)blockIdx.x * rows_per_block + warp;
  if (row >= n) return;  // whole warp leaves; no block-wide barrier follows

  const sk::Consts k = sk::load_consts(consts);
  float* h = smem + (long)warp * 2 * n_bins;  // [pos bins | neg bins]
  for (int i = lane; i < 2 * n_bins; i += sk::kLanes) h[i] = 0.0f;
  __syncwarp();

  const int lo = key_offset[row];
  const int hi = lo + n_bins - 1;
  float zero = 0.0f, count = 0.0f, sum = 0.0f, clow = 0.0f, chigh = 0.0f;
  float neg_total = 0.0f;
  float vmin = INFINITY, vmax = -INFINITY;
  int pos_lo = n_bins, pos_hi = -1, neg_lo = n_bins, neg_hi = -1;

  const float* vrow = values + row * (long)s;
  const float* wrow = WEIGHTED ? weights + row * (long)s : nullptr;
  for (int base = 0; base < s; base += sk::kLanes) {
    const int j = base + lane;
    const bool in = j < s;
    const float v = in ? vrow[j] : 0.0f;
    const float w = in ? (WEIGHTED ? wrow[j] : 1.0f) : 0.0f;
    // Three-way split with the explicit subnormals-are-zero predicate;
    // NaN fails both compares and lands in the zero path.
    const bool is_pos = v >= FLT_MIN;
    const bool is_neg = v <= -FLT_MIN;
    const bool is_zero = !(is_pos || is_neg);
    const int key = sk::key_of<MAP>(is_zero ? 1.0f : fabsf(v), k);
    const bool c_low = key < lo;
    const bool c_high = key > hi;
    const int idx = min(max(key, lo), hi) - lo;
    const bool live = w > 0.0f;
    const float w_pos = (is_pos && live) ? w : 0.0f;
    const float w_neg = (is_neg && live) ? w : 0.0f;
    const float w_zero = (is_zero && live) ? w : 0.0f;
    const float w_live = w_pos + w_neg + w_zero;
    const float signed_w = w_pos + w_neg;

    zero += w_zero;
    count += w_live;
    sum += (live ? v : 0.0f) * w_live;
    if (live && !isnan(v)) {
      vmin = fminf(vmin, v);
      vmax = fmaxf(vmax, v);
    }
    clow += c_low ? signed_w : 0.0f;
    chigh += c_high ? signed_w : 0.0f;
    neg_total += w_neg;
    if (live && is_pos) {
      pos_lo = min(pos_lo, idx);
      pos_hi = max(pos_hi, idx);
    }
    if (live && is_neg) {
      neg_lo = min(neg_lo, idx);
      neg_hi = max(neg_hi, idx);
    }

    // Histogram: group the lanes that hit the same (store, bin).
    const int code = (live && !is_zero) ? (is_neg ? n_bins + idx : idx) : -1;
    const unsigned peers = __match_any_sync(sk::kFull, code);
    float mass;
    if (WEIGHTED) {
      mass = 0.0f;
#pragma unroll
      for (int l = 0; l < sk::kLanes; ++l) {
        const float wl = __shfl_sync(sk::kFull, signed_w, l);
        if ((peers >> l) & 1u) mass += wl;
      }
    } else {
      mass = (float)__popc(peers);
    }
    if (code >= 0 && lane == __ffs(peers) - 1) h[code] += mass;
    __syncwarp();
  }

  zero = warp_sum(zero);
  count = warp_sum(count);
  sum = warp_sum(sum);
  clow = warp_sum(clow);
  chigh = warp_sum(chigh);
  neg_total = warp_sum(neg_total);
  vmin = warp_min(vmin);
  vmax = warp_max(vmax);
  pos_lo = warp_imin(pos_lo);
  pos_hi = warp_imax(pos_hi);
  neg_lo = warp_imin(neg_lo);
  neg_hi = warp_imax(neg_hi);

  float* crow = cols + row * (long)ncols;
  if (lane < kCols) {
    float c = 0.0f;
    switch (lane) {
      case 0: c = zero; break;
      case 1: c = count; break;
      case 2: c = sum; break;
      case 3: c = vmin; break;
      case 4: c = vmax; break;
      case 5: c = clow; break;
      case 6: c = chigh; break;
      case 7: c = (float)pos_lo; break;
      case 8: c = (float)pos_hi; break;
      case 9: c = (float)neg_lo; break;
      case 10: c = (float)neg_hi; break;
      case 11: c = neg_total; break;
      default: break;
    }
    crow[lane] = c;
  }

  // Per-tile masses from the shared histogram (pos tiles, then neg tiles),
  // and the histogram rows themselves, written once as float4.
  const int n_tiles2 = 2 * n_bins / sk::kTile;
  for (int t = 0; t < n_tiles2; ++t) {
    const float4 x = reinterpret_cast<const float4*>(h + t * sk::kTile)[lane];
    const float tile = warp_sum(((x.x + x.y) + x.z) + x.w);
    if (lane == 0) crow[kCols + t] = tile;
    float* dst = t * sk::kTile < n_bins ? hist_pos + row * (long)n_bins + t * sk::kTile
                                        : hist_neg + row * (long)n_bins + t * sk::kTile - n_bins;
    reinterpret_cast<float4*>(dst)[lane] = x;
  }
  for (int c = kCols + n_tiles2 + lane; c < ncols; c += sk::kLanes) crow[c] = 0.0f;
}

template <int MAP, bool WEIGHTED>
int launch(const float* values, const float* weights, const int* key_offset,
           float* hist_pos, float* hist_neg, float* cols, const float* consts,
           int n, int s, int n_bins, int ncols, cudaStream_t stream) {
  const int row_bytes = 2 * n_bins * (int)sizeof(float);
  int rows = kSmemLimit / row_bytes;
  if (rows > kMaxRows) rows = kMaxRows;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const int smem = rows * row_bytes;
  auto kernel = ingest_kernel<MAP, WEIGHTED>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + rows - 1) / rows;
  kernel<<<blocks, rows * sk::kLanes, smem, stream>>>(
      values, weights, key_offset, hist_pos, hist_neg, cols, consts, n, s,
      n_bins, ncols, rows);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (weights == nullptr) {
    SK_DISPATCH_MAPPING(mapping, return launch<MAP, false>(
        values, weights, key_offset, hist_pos, hist_neg, cols, consts, n, s,
        n_bins, ncols, st));
  }
  SK_DISPATCH_MAPPING(mapping, return launch<MAP, true>(
      values, weights, key_offset, hist_pos, hist_neg, cols, consts, n, s,
      n_bins, ncols, st));
  return 0;
}
