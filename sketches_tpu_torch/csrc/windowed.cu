// Occupied-window multi-quantile query.
//
// Replaces sketches_tpu/kernels.py:_windowed_kernel (the Pallas body behind
// fused_quantile_windowed).  Same contract: read only the n_tiles_win
// 128-bin tiles starting at bin lo_bin of each store (every occupied bin of
// every stream lies inside, by the state's occupied-bounds invariant), run
// the prefix sum across the window, count #(cum <= pos_rank) on the
// positive store and #(cum < rev_rank + 1) on the negative one, clip into
// the exact occupied bounds and decode.  Validity (q outside [0, 1], empty
// stream) is applied by the caller, as on the TPU.  The caller clamps
// lo_bin and checks the plan: unlike Pallas, CUDA does not clamp an
// out-of-range block, it reads out of bounds.
//
// packed [n, pk_width] f32, per stream: pos_rank[Q] | rev_rank+1[Q] |
// key_offset | pos_lo | pos_hi | neg_lo | neg_hi.
//
// What bounds it on an H100: bytes -- the window of each store read once.
// One warp owns one stream row; per tile each lane loads one float4 (a
// 512-byte coalesced row segment per warp), scans it in registers and
// across the warp with shuffles, and counts every quantile's threshold
// with ballots.  Lane q keeps quantile q's count, so no per-quantile state
// leaves registers; more than 32 quantiles take extra passes.
#include <cuda_runtime.h>

#include "mapping.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

// Count, for this lane's quantile, the bins of the window whose running
// sum passes the threshold; thresholds of quantile k live on lane k.
__device__ __forceinline__ int window_count(const float* __restrict__ p,
                                            int n_tiles, float my_thr,
                                            int nq, bool strict) {
  const int lane = threadIdx.x % sk::kLanes;
  float carry = 0.0f;
  int my_cnt = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const float4 x = reinterpret_cast<const float4*>(p + t * sk::kTile)[lane];
    float cum[4];
    float total;
    sk::tile_scan(x, carry, cum, total);
    carry += total;
    for (int q = 0; q < nq; ++q) {
      const float thr = __shfl_sync(sk::kFull, my_thr, q);
      const int c = sk::count_le(cum, thr, strict);
      if (lane == q) my_cnt += c;
    }
  }
  return my_cnt;
}

template <int MAP, bool WITH_NEG>
__global__ void windowed_kernel(const float* __restrict__ bins_pos,
                                const float* __restrict__ bins_neg,
                                const float* __restrict__ packed,
                                float* __restrict__ out,
                                const float* __restrict__ consts, int n,
                                int n_bins, int q_total, int pk_width,
                                int lo_bin, int n_tiles_win) {
  const int lane = threadIdx.x % sk::kLanes;
  const long row = (long)blockIdx.x * kRowsPerBlock + threadIdx.x / sk::kLanes;
  if (row >= n) return;
  const sk::Consts k = sk::load_consts(consts);
  const float* pk = packed + row * (long)pk_width;
  const float* wp = bins_pos + row * (long)n_bins + lo_bin;
  const float* wn = WITH_NEG ? bins_neg + row * (long)n_bins + lo_bin : nullptr;
  const int key_lo = __float2int_rz(pk[2 * q_total]);
  const int first_pos = __float2int_rz(pk[2 * q_total + 1]);
  const int last_pos = max(__float2int_rz(pk[2 * q_total + 2]), first_pos);

  for (int g = 0; g < q_total; g += sk::kLanes) {
    const int q = g + lane;
    const bool has_q = q < q_total;
    const int nq = min(sk::kLanes, q_total - g);
    const float pos_rank = has_q ? pk[q] : 0.0f;
    const float rev_p1 = has_q ? pk[q_total + q] : 0.0f;
    const int cnt_pos = window_count(wp, n_tiles_win, pos_rank, nq, false);
    // Bins below the window hold no mass: each counts toward any
    // threshold >= 0, hence the lo_bin offset; the exact-bounds clip
    // absorbs the degenerate cases (negative thresholds, empty stores).
    const int idx_pos = min(max(lo_bin + cnt_pos, first_pos), last_pos);
    float val;
    if (WITH_NEG) {
      const int cnt_neg = window_count(wn, n_tiles_win, rev_p1, nq, true);
      const int first_neg = __float2int_rz(pk[2 * q_total + 3]);
      const int last_neg = max(__float2int_rz(pk[2 * q_total + 4]), first_neg);
      const int idx_neg = min(max(lo_bin + cnt_neg, first_neg), last_neg);
      const bool in_neg = rev_p1 > 0.0f;
      const int idx = in_neg ? idx_neg : idx_pos;
      const float sign = in_neg ? -1.0f : 1.0f;
      const float dec = sign * sk::value_of<MAP>(idx + key_lo, k);
      val = (!in_neg && pos_rank < 0.0f) ? 0.0f : dec;
    } else {
      val = pos_rank < 0.0f ? 0.0f : sk::value_of<MAP>(idx_pos + key_lo, k);
    }
    if (has_q) out[row * (long)q_total + q] = val;
  }
}

template <int MAP, bool WITH_NEG>
int launch(const float* bins_pos, const float* bins_neg, const float* packed,
           float* out, const float* consts, int n, int n_bins, int q_total,
           int pk_width, int lo_bin, int n_tiles_win, cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  windowed_kernel<MAP, WITH_NEG><<<blocks, kRowsPerBlock * sk::kLanes, 0, stream>>>(
      bins_pos, bins_neg, packed, out, consts, n, n_bins, q_total, pk_width,
      lo_bin, n_tiles_win);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (sketches_tpu_torch/kernels.py).
// bins_neg == nullptr skips the negative store (certified empty).
extern "C" int sk_windowed(const float* bins_pos, const float* bins_neg,
                           const float* packed, float* out,
                           const float* consts, int mapping, int n,
                           int n_bins, int q_total, int pk_width, int lo_bin,
                           int n_tiles_win, void* stream) {
  if (n <= 0 || q_total <= 0) return 0;
  if (n_bins % sk::kTile != 0 || lo_bin < 0 || lo_bin % sk::kTile != 0 ||
      n_tiles_win < 1 || lo_bin + n_tiles_win * sk::kTile > n_bins ||
      pk_width < 2 * q_total + 5) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bins_neg == nullptr) {
    SK_DISPATCH_MAPPING(mapping, return launch<MAP, false>(
        bins_pos, bins_neg, packed, out, consts, n, n_bins, q_total, pk_width,
        lo_bin, n_tiles_win, st));
  }
  SK_DISPATCH_MAPPING(mapping, return launch<MAP, true>(
      bins_pos, bins_neg, packed, out, consts, n, n_bins, q_total, pk_width,
      lo_bin, n_tiles_win, st));
  return 0;
}
