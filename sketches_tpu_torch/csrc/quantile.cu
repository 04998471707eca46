// Full-window multi-quantile query.
//
// Replaces sketches_tpu/kernels.py:_quantile_kernel and _select_quantiles
// (the Pallas body behind fused_quantile): for every stream, the prefix sum
// of each whole store, the first and last occupied bin of each store taken
// from the bins themselves (not from the state's pos_lo/pos_hi; an empty
// store gives (n_bins, -1)), the negative store's total as its last
// running sum, then per quantile
//   rank     = q * (count - 1)
//   idx_neg  = #(cum_neg <  (neg_count - 1 - rank) + 1)
//   idx_pos  = #(cum_pos <= rank - zero_count - neg_count)
// clipped into the occupied bounds, decoded (an empty store's clip
// saturates in value_of and is discarded by the select), and the three-way
// select negative / zero / positive, NaN for count <= 0 or q outside [0, 1].
// Each expression keeps the reference's operation order.
//
// One warp owns one stream row and walks it tile by tile: one float4 per
// lane per 128-bin tile (a guarded scalar load on a ragged last tile), a
// register-plus-shuffle scan with a running carry, ballots for the
// occupied bounds and the counts.  Lane q keeps quantile q's thresholds and
// counts; more than 32 quantiles take extra passes.  For integer-valued
// bins below 2**24 the f32 running sums are exact, so unit-weight answers
// match the TPU's exact three-term scan bucket for bucket.
//
// What bounds it on an H100: bytes -- both stores read whole.  The
// negative store is walked twice (its total sets the thresholds of the
// second walk); the second walk finds the warp's 2 KB-per-tile rows in L1
// or L2, so device memory sees each store about once.
#include <cuda_runtime.h>

#include "mapping.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

// This lane's four bins of tile `t` (zeros past n_bins).
__device__ __forceinline__ float4 load_tile(const float* __restrict__ row,
                                            int t, int n_bins) {
  const int b0 = t * sk::kTile + 4 * (threadIdx.x % sk::kLanes);
  if ((n_bins & 3) == 0 && b0 < n_bins) {
    return reinterpret_cast<const float4*>(row + b0)[0];
  }
  float4 x;
  x.x = b0 < n_bins ? row[b0] : 0.0f;
  x.y = b0 + 1 < n_bins ? row[b0 + 1] : 0.0f;
  x.z = b0 + 2 < n_bins ? row[b0 + 2] : 0.0f;
  x.w = b0 + 3 < n_bins ? row[b0 + 3] : 0.0f;
  return x;
}

// Fold tile t's occupied bins (bins > 0) into the running (first, last).
__device__ __forceinline__ void occupied(float4 x, int t, int& first,
                                         int& last) {
  const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned m = __ballot_sync(sk::kFull, v[j] > 0.0f);
    if (m != 0u) {
      first = min(first, t * sk::kTile + 4 * (__ffs(m) - 1) + j);
      last = max(last, t * sk::kTile + 4 * (31 - __clz(m)) + j);
    }
  }
}

// Number of bins of tile t (below n_bins) whose running sum is <= thr
// (strict: < thr).
__device__ __forceinline__ int count_tile(const float cum[4], float thr,
                                          bool strict, int t, int n_bins) {
  const int b0 = t * sk::kTile + 4 * (threadIdx.x % sk::kLanes);
  int n = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool hit =
        b0 + j < n_bins && (strict ? (cum[j] < thr) : (cum[j] <= thr));
    n += __popc(__ballot_sync(sk::kFull, hit));
  }
  return n;
}

// Per-lane count of one store against the thresholds of quantiles g..g+nq-1
// (quantile g + k's threshold lives on lane k).
__device__ __forceinline__ int store_count(const float* __restrict__ row,
                                           int n_bins, float my_thr, int nq,
                                           bool strict) {
  const int lane = threadIdx.x % sk::kLanes;
  const int n_tiles = (n_bins + sk::kTile - 1) / sk::kTile;
  float carry = 0.0f;
  int my_cnt = 0;
  for (int t = 0; t < n_tiles; ++t) {
    float cum[4];
    float total;
    sk::tile_scan(load_tile(row, t, n_bins), carry, cum, total);
    carry += total;
    for (int q = 0; q < nq; ++q) {
      const float thr = __shfl_sync(sk::kFull, my_thr, q);
      const int c = count_tile(cum, thr, strict, t, n_bins);
      if (lane == q) my_cnt += c;
    }
  }
  return my_cnt;
}

template <int MAP>
__global__ void quantile_kernel(const float* __restrict__ bins_pos,
                                const float* __restrict__ bins_neg,
                                const float* __restrict__ zero_count,
                                const float* __restrict__ count,
                                const int* __restrict__ key_offset,
                                const float* __restrict__ qs,
                                float* __restrict__ out,
                                const float* __restrict__ consts, int n,
                                int n_bins, int q_total) {
  const int lane = threadIdx.x % sk::kLanes;
  const long row = (long)blockIdx.x * kRowsPerBlock + threadIdx.x / sk::kLanes;
  if (row >= n) return;
  const sk::Consts k = sk::load_consts(consts);
  const int n_tiles = (n_bins + sk::kTile - 1) / sk::kTile;
  const float* rp = bins_pos + row * (long)n_bins;
  const float* rn = bins_neg + row * (long)n_bins;

  // Walk 1: the negative store's total (its last running sum) and both
  // stores' occupied bounds.
  int first_neg = n_bins, last_neg = -1, first_pos = n_bins, last_pos = -1;
  float carry = 0.0f, neg_count = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const float4 x = load_tile(rn, t, n_bins);
    float cum[4];
    float total;
    sk::tile_scan(x, carry, cum, total);
    carry += total;
    neg_count = __shfl_sync(sk::kFull, cum[3], sk::kLanes - 1);
    occupied(x, t, first_neg, last_neg);
    occupied(load_tile(rp, t, n_bins), t, first_pos, last_pos);
  }
  const float zero = zero_count[row];
  const float cnt_f = count[row];
  const int key_lo = key_offset[row];

  for (int g = 0; g < q_total; g += sk::kLanes) {
    const int q = g + lane;
    const bool has_q = q < q_total;
    const int nq = min(sk::kLanes, q_total - g);
    const float qv = has_q ? qs[q] : 0.0f;
    const float rank = qv * (cnt_f - 1.0f);
    const float rev_p1 = ((neg_count - 1.0f) - rank) + 1.0f;
    const float pos_rank = (rank - zero) - neg_count;
    const int cnt_neg = store_count(rn, n_bins, rev_p1, nq, true);
    const int cnt_pos = store_count(rp, n_bins, pos_rank, nq, false);
    const int idx_neg = min(max(cnt_neg, first_neg), last_neg);
    const int idx_pos = min(max(cnt_pos, first_pos), last_pos);
    const float val_neg = -sk::value_of<MAP>(idx_neg + key_lo, k);
    const float val_pos = sk::value_of<MAP>(idx_pos + key_lo, k);
    float val = rank < neg_count ? val_neg
                                 : (rank < neg_count + zero ? 0.0f : val_pos);
    const bool valid = qv >= 0.0f && qv <= 1.0f && cnt_f > 0.0f;
    if (!valid) val = __int_as_float(0x7fc00000);
    if (has_q) out[row * (long)q_total + q] = val;
  }
}

template <int MAP>
int launch(const float* bins_pos, const float* bins_neg, const float* zero_count,
           const float* count, const int* key_offset, const float* qs, float* out,
           const float* consts, int n, int n_bins, int q_total,
           cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  quantile_kernel<MAP><<<blocks, kRowsPerBlock * sk::kLanes, 0, stream>>>(
      bins_pos, bins_neg, zero_count, count, key_offset, qs, out, consts, n,
      n_bins, q_total);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (sketches_tpu_torch/kernels.py).
extern "C" int sk_quantile(const float* bins_pos, const float* bins_neg,
                           const float* zero_count, const float* count,
                           const int* key_offset, const float* qs, float* out,
                           const float* consts, int mapping, int n, int n_bins,
                           int q_total, void* stream) {
  if (n <= 0 || q_total <= 0) return 0;
  if (n_bins < 1 || bins_neg == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SK_DISPATCH_MAPPING(mapping, return launch<MAP>(
      bins_pos, bins_neg, zero_count, count, key_offset, qs, out, consts, n,
      n_bins, q_total, st));
  return 0;
}
